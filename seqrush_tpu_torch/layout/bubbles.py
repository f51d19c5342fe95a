"""Bubble-chain final ordering from path-anchor decomposition.

The reference documents (but never built) a hybrid sort steered by povu
(the povu sorting note in the reference docs): decompose the graph into a
linear chain of bubbles, order locally inside each bubble, and keep the
chain itself for the global order — eliminating SGD's catastrophic-edge
mode where a displaced block lands kilobases from every path context
(the reference's A-3105 analysis: one edge jumping 43.9% of the graph).

This implementation derives the chain from PATH evidence instead of an
external bubble tool, which is both simpler and exactly aligned with the
layout metric (measure_layout_quality scores consecutive path steps):

  1. Anchors = nodes that occur exactly once in EVERY path; a greedy
     dominance chain (strictly increasing step rank in every path) keeps
     a maximal consistent subsequence, so along every path the kept
     anchors appear precisely in chain order.
  2. Every non-anchor occurrence votes for the segment between the chain
     anchors that surround it in its path, carrying the genomic offset
     from the segment's left anchor (well-defined even for reversed
     traversals: anchors bound the excursion on both sides).
  3. A node's segment is the majority vote; its intra-segment position
     the mean offset of the winning-segment votes.  Final order is
     segment-by-segment along the chain — displaced blocks cannot leave
     their bubble.

Pure ordering function: no graph mutation, no RNG.  Used as a candidate
in layout/ygs.py's metric-scored final-order selection (topo_mode="best")
and directly via topo_mode="bubble".
"""

from __future__ import annotations

import numpy as np

from ..graph.bigraph import BidirectedGraph


def bubble_chain_order(graph: BidirectedGraph) -> list[int] | None:
    """Forward-handle ordering from the path-anchor bubble chain, or None
    when no usable chain exists (fewer than 2 consistent anchors)."""
    if not graph.paths or not graph.nodes:
        return None
    # id -> length gather table (vectorized: a per-step dict-lookup loop
    # cost seconds at 1k-seq scale)
    ids_tbl = np.fromiter(graph.nodes.keys(), dtype=np.int64, count=len(graph.nodes))
    lens_tbl = np.fromiter(
        (len(s) for s in graph.nodes.values()), dtype=np.int64, count=ids_tbl.size
    )
    tbl_order = np.argsort(ids_tbl, kind="stable")
    ids_sorted = ids_tbl[tbl_order]
    lens_sorted = lens_tbl[tbl_order]

    paths_nodes: list[np.ndarray] = []
    paths_off: list[np.ndarray] = []
    for path in graph.paths:
        ns = (np.asarray(path.steps) >> 1).astype(np.int64)
        if ns.size == 0:
            continue
        lens = lens_sorted[np.searchsorted(ids_sorted, ns)]
        off = np.concatenate([[0], np.cumsum(lens)[:-1]])
        paths_nodes.append(ns)
        paths_off.append(off)
    P = len(paths_nodes)
    if P == 0:
        return None

    # anchor candidates occur exactly once in EVERY path (vectorized
    # per-path unique + presence/count tallies)
    ids_all = np.concatenate([np.unique(ns) for ns in paths_nodes])
    ones_all = np.concatenate(
        [np.unique(ns, return_counts=True)[1] == 1 for ns in paths_nodes]
    )
    u, inv = np.unique(ids_all, return_inverse=True)
    present = np.bincount(inv, minlength=u.size)
    once = np.bincount(inv, weights=ones_all.astype(np.float64), minlength=u.size)
    cand_arr = u[(present == P) & (once == P)]  # sorted ascending
    cand = cand_arr.tolist()
    if len(cand) < 2:
        return None

    # step rank of each candidate in each path (each occurs exactly once)
    rank = np.empty((len(cand), P), dtype=np.int64)
    for p, ns in enumerate(paths_nodes):
        pos = np.flatnonzero(np.isin(ns, cand_arr))
        rank[np.searchsorted(cand_arr, ns[pos]), p] = pos

    # greedy dominance chain: sorted by mean rank, keep a candidate iff its
    # rank exceeds the last kept anchor's rank in EVERY path — the kept
    # anchors then appear in chain order along every path
    order = sorted(range(len(cand)), key=lambda i: (float(rank[i].mean()), cand[i]))
    chain: list[int] = []
    last = np.full(P, -1, dtype=np.int64)
    for i in order:
        if bool(np.all(rank[i] > last)):
            chain.append(cand[i])
            last = rank[i]
    if len(chain) < 2:
        return None
    chain_pos = {n: c for c, n in enumerate(chain)}

    # segment votes: (segment index, offset from the segment's left anchor);
    # segment -1 = before the first anchor, c = between anchors c and c+1,
    # len(chain)-1 = after the last anchor.  Vectorized per path: every
    # path contains every chain anchor exactly once IN CHAIN ORDER (the
    # dominance property), so a step's segment is simply the count of
    # anchors at-or-before it minus one, and its left anchor is that
    # anchor's offset (steps before the first anchor vote for segment -1
    # with a negative offset from the first anchor, matching the
    # sequential walk's pending-list handling).
    chain_arr = np.array(chain, dtype=np.int64)
    v_nid: list[np.ndarray] = []
    v_seg: list[np.ndarray] = []
    v_rel: list[np.ndarray] = []
    for ns, off in zip(paths_nodes, paths_off):
        is_anchor = np.isin(ns, chain_arr)
        ka = np.flatnonzero(is_anchor)
        segidx = (
            np.searchsorted(ka, np.arange(ns.size), side="right") - 1
        ).astype(np.int64)
        left = off[ka[np.clip(segidx, 0, ka.size - 1)]]
        left = np.where(segidx >= 0, left, off[ka[0]])
        keep = ~is_anchor
        v_nid.append(ns[keep])
        v_seg.append(segidx[keep])
        v_rel.append((off - left).astype(np.float64)[keep])

    # resolve: majority segment, mean offset inside it (ties: smaller seg)
    segments: dict[int, list[tuple[float, int]]] = {}
    placed = set(chain)
    if v_nid and sum(a.size for a in v_nid):
        nid_all = np.concatenate(v_nid)
        seg_all = np.concatenate(v_seg)
        rel_all = np.concatenate(v_rel)
        order = np.lexsort((seg_all, nid_all))
        nid_s, seg_s, rel_s = nid_all[order], seg_all[order], rel_all[order]
        grp = np.concatenate(
            [[True], (nid_s[1:] != nid_s[:-1]) | (seg_s[1:] != seg_s[:-1])]
        )
        gidx = np.cumsum(grp) - 1
        n_groups = int(gidx[-1]) + 1
        g_cnt = np.bincount(gidx, minlength=n_groups)
        g_sum = np.bincount(gidx, weights=rel_s, minlength=n_groups)
        starts = np.flatnonzero(grp)
        g_nid = nid_s[starts]
        g_seg = seg_s[starts]
        g_mean = g_sum / g_cnt
        # winner per node: largest count, tie -> smaller segment
        win = np.lexsort((g_seg, -g_cnt, g_nid))
        first_of_nid = np.concatenate(
            [[True], g_nid[win][1:] != g_nid[win][:-1]]
        )
        for i in win[first_of_nid]:
            nid = int(g_nid[i])
            if nid in placed:
                continue
            segments.setdefault(int(g_seg[i]), []).append((float(g_mean[i]), nid))
            placed.add(nid)

    out: list[int] = []
    for mean_off, nid in sorted(segments.get(-1, [])):
        out.append(nid)
    for c, anchor in enumerate(chain):
        out.append(anchor)
        for mean_off, nid in sorted(segments.get(c, [])):
            out.append(nid)
    for nid in sorted(graph.nodes):
        if nid not in placed:
            out.append(nid)
    return [n << 1 for n in out]
