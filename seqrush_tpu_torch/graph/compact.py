"""Linear-chain compaction (node merging / "unchop").

Equivalent semantics to the reference's production compaction
(reference src/bidirected_ops.rs:91-490 ``compact`` /
``find_simple_components`` / ``merge_component_v2`` and
docs/compaction_algorithm.md): two oriented handles (a, b) are *perfect
neighbors* iff every traversal of a is immediately followed by b and every
traversal of b is immediately preceded by a — in both strands — and maximal
perfect chains merge into single nodes whose sequence is the oriented
concatenation, with paths rewritten and boundary edges re-homed.

Array re-design: instead of per-pair path scans (the reference re-walks every
path per candidate pair), we materialize each path's step array twice (as-is
and flipped-reversed, which encodes the reverse-strand consistency condition)
and derive successor/predecessor uniqueness for *all* handles with one
group-by pass.  The perfect-pair relation is functional, so maximal chains
fall out by walking next-pointers; each chain's mirror (its own reverse
complement) shares node ids and is skipped automatically.
"""

from __future__ import annotations

import numpy as np

from .bigraph import BidirectedGraph


def _doubled_traversals(graph: BidirectedGraph) -> list[np.ndarray]:
    """Each path as-is plus flipped-reversed (complement traversal)."""
    out = []
    for path in graph.paths:
        s = path.steps
        if s.size:
            out.append(s)
            out.append((s ^ 1)[::-1])
    return out


def _perfect_next(graph: BidirectedGraph) -> dict[int, int]:
    """handle -> unique perfect successor, for all perfect pairs."""
    travs = _doubled_traversals(graph)
    if not travs:
        return {}
    froms = np.concatenate([t[:-1] for t in travs if t.size >= 2] or [np.zeros(0, np.int64)])
    tos = np.concatenate([t[1:] for t in travs if t.size >= 2] or [np.zeros(0, np.int64)])
    if froms.size == 0:
        return {}
    ends = np.array([t[-1] for t in travs], dtype=np.int64)
    starts = np.array([t[0] for t in travs], dtype=np.int64)

    # successor uniqueness: handle h has exactly one distinct successor
    # and must never terminate a traversal.  Vectorized: lexsort groups by
    # (from, to), so a group's successors are all equal iff its first and
    # last sorted entries agree (the per-group Python loop cost ~10 s at
    # 1k-seq scale)
    order = np.lexsort((tos, froms))
    f_sorted, t_sorted = froms[order], tos[order]
    uniq_f, first = np.unique(f_sorted, return_index=True)
    last = np.append(first[1:], f_sorted.size) - 1
    ok_s = (t_sorted[first] == t_sorted[last]) & ~np.isin(uniq_f, ends)
    succ_a = uniq_f[ok_s]
    succ_b = t_sorted[first[ok_s]]

    # predecessor uniqueness
    order = np.lexsort((froms, tos))
    t2, f2 = tos[order], froms[order]
    uniq_t, first = np.unique(t2, return_index=True)
    last = np.append(first[1:], t2.size) - 1
    ok_p = (f2[first] == f2[last]) & ~np.isin(uniq_t, starts)
    pred_t = uniq_t[ok_p]
    pred_f = f2[first[ok_p]]

    # perfect pair: succ(a)=b and pred(b)=a
    pos = np.searchsorted(pred_t, succ_b)
    pos = np.clip(pos, 0, max(pred_t.size - 1, 0))
    if pred_t.size:
        perfect = (pred_t[pos] == succ_b) & (pred_f[pos] == succ_a)
    else:
        perfect = np.zeros(succ_a.size, dtype=bool)
    return dict(
        zip(succ_a[perfect].tolist(), succ_b[perfect].tolist())
    )


def find_chains(graph: BidirectedGraph) -> list[list[int]]:
    """Maximal perfect chains (>= 2 handles), node-disjoint, deterministic."""
    nxt = _perfect_next(graph)
    if not nxt:
        return []
    has_pred = set(nxt.values())
    chains: list[list[int]] = []
    used_nodes: set[int] = set()

    def take(start: int):
        chain = [start]
        seen = {start}
        h = start
        while h in nxt:
            h = nxt[h]
            if h in seen:  # cycle closed
                break
            chain.append(h)
            seen.add(h)
        return chain

    # chain starts in ascending handle order (deterministic like the
    # reference's node-id iteration, bidirected_ops.rs:203-210)
    for h in sorted(nxt):
        if h in has_pred:
            continue
        chain = take(h)
        _claim(chain, chains, used_nodes)
    # cycles (no start handle): break at the minimum remaining handle
    remaining = sorted(h for h in nxt if (h >> 1) not in used_nodes)
    seen_cycle: set[int] = set()
    for h in remaining:
        if h in seen_cycle or (h >> 1) in used_nodes:
            continue
        chain = take(h)
        seen_cycle.update(chain)
        _claim(chain, chains, used_nodes)
    return chains


def _claim(chain, chains, used_nodes):
    if len(chain) < 2:
        return
    ids = [h >> 1 for h in chain]
    if len(set(ids)) != len(ids):  # node twice in one chain (palindrome) — skip
        return
    if any(i in used_nodes for i in ids):  # mirror or overlap — skip
        return
    used_nodes.update(ids)
    chains.append(chain)


def merge_chains(graph: BidirectedGraph, chains: list[list[int]]) -> int:
    """Merge every chain into a single node.  Returns #chains merged."""
    if not chains:
        return 0
    next_id = max(graph.nodes, default=0) + 1
    # handle -> (chain_idx, role) where role: 'first','last','internal'
    chain_of_node: dict[int, int] = {}
    new_ids: list[int] = []
    for ci, chain in enumerate(chains):
        new_ids.append(next_id + ci)
        for h in chain:
            chain_of_node[h >> 1] = ci

    # build new node sequences
    for ci, chain in enumerate(chains):
        parts = [graph.get_sequence(h) for h in chain]
        graph.add_node(new_ids[ci], np.concatenate(parts))

    # rewrite paths: replace complete chain traversals by the new handle
    first = {ci: chain[0] for ci, chain in enumerate(chains)}
    last = {ci: chain[-1] for ci, chain in enumerate(chains)}
    chain_pos: dict[int, tuple[int, int, bool]] = {}
    for ci, chain in enumerate(chains):
        m = len(chain)
        for i, h in enumerate(chain):
            chain_pos[h] = (ci, i, False)
            chain_pos[h ^ 1] = (ci, m - 1 - i, True)

    for path in graph.paths:
        steps = path.steps
        out = []
        i = 0
        L = steps.size
        while i < L:
            h = int(steps[i])
            info = chain_pos.get(h)
            if info is None:
                out.append(h)
                i += 1
                continue
            ci, pos, mirrored = info
            chain = chains[ci]
            m = len(chain)
            if not mirrored and pos == 0 and i + m <= L and all(
                int(steps[i + j]) == chain[j] for j in range(m)
            ):
                out.append(new_ids[ci] << 1)
                i += m
            elif mirrored and pos == 0 and i + m <= L and all(
                int(steps[i + j]) == (chain[m - 1 - j] ^ 1) for j in range(m)
            ):
                out.append((new_ids[ci] << 1) | 1)
                i += m
            else:
                # incomplete traversal: should not happen for perfect chains
                out.append(h)
                i += 1
        path.steps = np.array(out, dtype=np.int64)

    # rewrite edges
    def map_endpoint(h: int, as_from: bool) -> int | None:
        ci = chain_of_node.get(h >> 1)
        if ci is None:
            return h
        if as_from:
            if h == last[ci]:
                return new_ids[ci] << 1
            if h == (first[ci] ^ 1):
                return (new_ids[ci] << 1) | 1
        else:
            if h == first[ci]:
                return new_ids[ci] << 1
            if h == (last[ci] ^ 1):
                return (new_ids[ci] << 1) | 1
        return None

    new_edges: dict[tuple[int, int], None] = {}
    for (f, t) in graph.edges:
        nf = map_endpoint(f, as_from=True)
        nt = map_endpoint(t, as_from=False)
        if nf is None or nt is None:
            continue  # internal to a chain
        comp = (nt ^ 1, nf ^ 1)
        if (nf, nt) not in new_edges and comp not in new_edges:
            new_edges[(nf, nt)] = None
    graph.edges = new_edges

    # drop merged nodes
    for ci, chain in enumerate(chains):
        for h in chain:
            graph.nodes.pop(h >> 1, None)
    return len(chains)


def compact(graph: BidirectedGraph) -> None:
    """Repeat chain-merge until fixpoint (reference compact loop)."""
    while True:
        chains = find_chains(graph)
        if not merge_chains(graph, chains):
            break
