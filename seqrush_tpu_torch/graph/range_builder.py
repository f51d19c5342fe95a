"""Range-based graph induction (the seqwish graph-sequence approach).

Vectorized analog of the reference's ``RangeBasedGraphBuilder``
(reference src/range_builder.rs:39-200): instead of one node per
union-find component, nodes are the segments of the concatenated "graph
sequence" between *boundaries*, where a boundary is marked at the start and
end of every alignment range (plus an implicit full-length self-alignment
per sequence, plus 0 and total length).  Paths walk each sequence's
positions through the segment table, deduplicating consecutive same-node
steps; edges come from consecutive path steps.

The reference prototype is forward-only (seq2/rc fields of its
AlignmentRange never influence node construction, range_builder.rs:84-94);
this port keeps that behavior and the same node numbering (segments in
ascending graph-sequence order, ids from 1).

Everything is numpy: boundaries via unique, position->node via searchsorted,
per-path step dedup via a shift-compare — no per-position Python loops.
Copied from seqrush_tpu/graph/range_builder.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bigraph import BidirectedGraph


@dataclass(frozen=True)
class AlignmentRange:
    """Half-open range pair in concatenated graph-sequence coordinates
    (range_builder.rs:7-13)."""

    seq1_start: int
    seq1_end: int
    seq2_start: int = 0
    seq2_end: int = 0
    seq2_is_rc: bool = False


class RangeBasedGraphBuilder:
    def __init__(self):
        self.ranges: list[AlignmentRange] = []
        self.sequences: list[tuple[str, bytes]] = []

    def add_sequence(self, name: str, data: bytes) -> None:
        self.sequences.append((name, bytes(data)))

    def add_alignment_range(self, r: AlignmentRange) -> None:
        self.ranges.append(r)

    def build_graph(self, verbose: bool = False) -> BidirectedGraph:
        offsets = np.cumsum([0] + [len(d) for _, d in self.sequences])
        total = int(offsets[-1])
        graph_seq = np.frombuffer(
            b"".join(d for _, d in self.sequences), dtype=np.uint8
        )

        # boundaries: 0, total, every range start/end, every sequence
        # start/end (the implicit self-alignments, range_builder.rs:64-76)
        bounds = [0, total]
        bounds.extend(int(o) for o in offsets)
        for r in self.ranges:
            bounds.append(int(r.seq1_start))
            bounds.append(int(r.seq1_end))
        boundaries = np.unique(np.asarray(bounds, dtype=np.int64))
        boundaries = boundaries[(boundaries >= 0) & (boundaries <= total)]
        if verbose:
            print(f"[range_builder] {boundaries.size} node boundaries")

        starts = boundaries[:-1]
        ends = boundaries[1:]
        keep = ends > starts
        starts, ends = starts[keep], ends[keep]

        graph = BidirectedGraph()
        for k, (s, e) in enumerate(zip(starts, ends)):
            graph.add_node(k + 1, graph_seq[s:e])

        # paths: positions -> segment ids via searchsorted; consecutive
        # duplicate segments collapse (range_builder.rs:152-173)
        for si, (name, data) in enumerate(self.sequences):
            lo, hi = int(offsets[si]), int(offsets[si + 1])
            if hi == lo:
                graph.add_path(name, np.zeros(0, np.int64))
                continue
            pos = np.arange(lo, hi, dtype=np.int64)
            seg = np.searchsorted(starts, pos, side="right") - 1
            first = np.ones(seg.size, dtype=bool)
            first[1:] = seg[1:] != seg[:-1]
            node_ids = seg[first] + 1
            handles = node_ids.astype(np.int64) << 1  # all forward
            graph.add_path(name, handles)

        for path in graph.paths:
            if path.steps.size > 1:
                graph.add_edges_bulk(path.steps[:-1], path.steps[1:])
        if verbose:
            print(f"[range_builder] {graph.node_count()} nodes")
        return graph


def ranges_from_alignments(results, seqs) -> list[AlignmentRange]:
    """Convert runner AlignmentResults into concatenated-coordinate ranges.

    One range per match run (the reference feeds PAF ranges; match runs are
    the exact-match subranges, giving boundaries at every run endpoint)."""
    offsets = np.cumsum([0] + [len(s.data) for s in seqs.sequences])
    out = []
    for r in results:
        qoff = int(offsets[r.query_idx])
        toff = int(offsets[r.target_idx])
        q = t = 0
        for n, op in r.cigar:
            if op in "=X":
                if op == "=":
                    out.append(
                        AlignmentRange(
                            qoff + q, qoff + q + n,
                            toff + t, toff + t + n,
                            r.is_reverse,
                        )
                    )
                q += n
                t += n
            elif op == "I":
                q += n
            elif op == "D":
                t += n
    return out
