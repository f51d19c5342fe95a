"""Graph induction: converged union-find -> bidirected graph.

Semantics match the reference builder (reference src/
bidirected_builder.rs:17-289) but fully vectorized:

* The reference walks sequences in input order, positions 0..len, assigning
  node ids at first encounter of each union component.  Because sequences are
  concatenated in input order, that traversal IS ascending global-offset
  order — so node ids fall out of a stable first-occurrence unique over the
  per-offset root array.
* Node base = the base at the representative's offset, read on the forward
  strand (the reference reads ``source_seq.data[offset(rep)]``, ignoring the
  rep's orientation bit; builder.rs:174-186).  Our representatives are
  canonical component minima, so node bases are deterministic.
* Step orientation = complement test between the sequence base and the node
  base (A<->T, C<->G; same or ambiguous -> forward; builder.rs:189-203).
* Edges come from consecutive path steps, first-seen representation kept,
  complement pairs deduplicated (builder.rs:216-228).

The reference's O(n*m) fallback scan (builder.rs:96-127) is structurally
unnecessary here: the parent array is fully path-compressed, so representative
lookup is one gather.
"""

from __future__ import annotations

import numpy as np

from ..pos import complement_bytes
from ..sequences import SequenceSet
from .bigraph import BidirectedGraph


def build_bidirected_graph(
    seqs: SequenceSet,
    roots: np.ndarray,
    verbose: bool = False,
    node_order: str = "traversal",
) -> BidirectedGraph:
    """Build the 1bp-node bidirected graph from a compressed parent array.

    ``roots``: int array over the Pos space (size >= 2*total_length) where
    roots[p] is the representative of Pos p (fully compressed).

    ``node_order``: "traversal" assigns ids in first-encounter order walking
    sequences (the SeqRush default); "position" assigns ids by each
    component's minimum offset — the seqwish "graph sequence" ordering used
    by the reference's hidden --seqwish-style mode (src/seqwish_style.rs:
    347-389: components sorted by min position, 1bp nodes in that order).
    """
    n = seqs.total_length
    concat = seqs.concat  # uint8 ASCII

    # Representative of each offset (use the forward Pos; F/R are pre-united).
    rep = np.asarray(roots)[0 : 2 * n : 2]

    # Stable first-occurrence unique -> node ids in traversal order.
    uniq_roots, first_idx, inverse = np.unique(rep, return_index=True, return_inverse=True)
    if node_order == "position":
        # roots are component minima -> sorting by root == sorting by min
        # offset; uniq_roots is already sorted ascending
        order = np.arange(uniq_roots.size)
    else:
        order = np.argsort(first_idx, kind="stable")
    # rank_of_uniq[k] = node rank (0-based) of uniq_roots[k]
    rank_of_uniq = np.empty_like(order)
    rank_of_uniq[order] = np.arange(order.size)
    node_of_offset = rank_of_uniq[inverse] + 1  # 1-based node ids, shape [n]

    # Node base: forward-strand base at the representative's offset.
    rep_offsets = uniq_roots[order] >> 1
    node_bases = concat[rep_offsets]  # node id i+1 -> node_bases[i]

    # Step orientation: complement test seq base vs node base.
    node_base_per_offset = node_bases[node_of_offset - 1]
    up = _upper(concat)
    node_up = _upper(node_base_per_offset)
    is_complement = _upper(complement_bytes(node_base_per_offset)) == up
    need_reverse = (node_up != up) & is_complement
    handles = (node_of_offset.astype(np.int64) << 1) | need_reverse

    graph = BidirectedGraph()
    for i in range(node_bases.size):
        graph.add_node(i + 1, node_bases[i : i + 1])

    # Paths: slice the handle array at sequence boundaries.
    for k, seq in enumerate(seqs.sequences):
        lo, hi = int(seqs.offsets[k]), int(seqs.offsets[k + 1])
        graph.add_path(seq.id, handles[lo:hi])

    # Edges from consecutive steps within each path, in traversal order.
    froms, tos = [], []
    for k in range(len(seqs.sequences)):
        lo, hi = int(seqs.offsets[k]), int(seqs.offsets[k + 1])
        if hi - lo >= 2:
            froms.append(handles[lo : hi - 1])
            tos.append(handles[lo + 1 : hi])
    if froms:
        graph.add_edges_bulk(np.concatenate(froms), np.concatenate(tos))

    if verbose:
        print(
            f"Built bidirected graph: {graph.node_count()} nodes, "
            f"{len(graph.edges)} edges, {len(graph.paths)} paths"
        )
    return graph


def _upper(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, dtype=np.uint8)
    lower = (b >= ord("a")) & (b <= ord("z"))
    return np.where(lower, b - 32, b).astype(np.uint8)
