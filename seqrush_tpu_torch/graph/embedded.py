"""Embedded graph: path steps as first-class objects.

Equivalent of the reference's experimental embedded representation
(reference src/embedded_graph.rs + embedded_builder.rs): every path
step is an addressable ``(path_id, index)`` record with explicit next/prev
links, which makes perfect-neighbor queries local (no path rescans) and
supports step-level compaction.  Array re-design: steps live in dense
per-path handle arrays; next/prev are implicit (index +/- 1), and
occurrence indices per node are maintained as a posting map.

Copied from seqrush_tpu/graph/embedded.py (host numpy).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bigraph import BidirectedGraph


@dataclass(frozen=True)
class StepId:
    path_id: int
    index: int


@dataclass
class EmbeddedGraph:
    node_seqs: dict[int, np.ndarray] = field(default_factory=dict)
    path_names: list[str] = field(default_factory=list)
    path_steps: list[np.ndarray] = field(default_factory=list)  # int64 handles

    # -- construction --------------------------------------------------------

    def add_node(self, node_id: int, sequence) -> None:
        if isinstance(sequence, (bytes, bytearray)):
            sequence = np.frombuffer(bytes(sequence), dtype=np.uint8)
        self.node_seqs[int(node_id)] = np.asarray(sequence, dtype=np.uint8)

    def add_path(self, name: str) -> int:
        self.path_names.append(name)
        self.path_steps.append(np.zeros(0, dtype=np.int64))
        return len(self.path_names) - 1

    def extend_path(self, path_id: int, node_id: int, is_reverse: bool = False) -> StepId:
        h = (node_id << 1) | int(is_reverse)
        self.path_steps[path_id] = np.append(self.path_steps[path_id], np.int64(h))
        return StepId(path_id, self.path_steps[path_id].size - 1)

    # -- step navigation -----------------------------------------------------

    def get_next_steps(self, handle: int) -> list[int]:
        """Distinct successors of an oriented handle across all paths
        (both strands, like embedded_graph.rs get_next_steps)."""
        out = set()
        for steps in self.path_steps:
            for x, y in zip(steps[:-1], steps[1:]):
                if int(x) == handle:
                    out.add(int(y))
                if (int(y) ^ 1) == handle:
                    out.add(int(x) ^ 1)
        return sorted(out)

    def get_prev_steps(self, handle: int) -> list[int]:
        out = set()
        for steps in self.path_steps:
            for x, y in zip(steps[:-1], steps[1:]):
                if int(y) == handle:
                    out.add(int(x))
                if (int(x) ^ 1) == handle:
                    out.add(int(y) ^ 1)
        return sorted(out)

    def are_perfect_neighbors(self, a: int, b: int) -> bool:
        """Every traversal of a continues to b and every traversal of b is
        preceded by a (both strands)."""
        for steps in self.path_steps:
            doubled = [steps, (steps ^ 1)[::-1]]
            for s in doubled:
                for i, h in enumerate(s):
                    if int(h) == a:
                        if i + 1 >= s.size or int(s[i + 1]) != b:
                            return False
                    if int(h) == b:
                        if i == 0 or int(s[i - 1]) != a:
                            return False
        return True

    def find_perfect_pairs(self) -> list[tuple[int, int]]:
        pairs = []
        for nid in sorted(self.node_seqs):
            for h in (nid << 1, (nid << 1) | 1):
                nxt = self.get_next_steps(h)
                if len(nxt) == 1 and self.are_perfect_neighbors(h, nxt[0]):
                    pairs.append((h, nxt[0]))
        return pairs

    # -- compaction ----------------------------------------------------------

    def merge_perfect_neighbors(self) -> int:
        """One round of pairwise perfect merges; returns merges performed."""
        g = self.to_bidirected()
        from .compact import find_chains, merge_chains

        merged = merge_chains(g, find_chains(g))
        if merged:
            new = from_bidirected(g)
            self.node_seqs = new.node_seqs
            self.path_names = new.path_names
            self.path_steps = new.path_steps
        return merged

    def compact(self) -> None:
        while self.merge_perfect_neighbors():
            pass

    # -- sequences / io ------------------------------------------------------

    def get_path_sequence(self, path_id: int) -> bytes:
        from ..pos import reverse_complement

        parts = []
        for h in self.path_steps[path_id]:
            seq = self.node_seqs[int(h) >> 1]
            parts.append(reverse_complement(seq) if int(h) & 1 else seq)
        return (np.concatenate(parts) if parts else np.zeros(0, np.uint8)).tobytes()

    def to_bidirected(self) -> BidirectedGraph:
        g = BidirectedGraph()
        for nid, seq in self.node_seqs.items():
            g.add_node(nid, seq)
        for name, steps in zip(self.path_names, self.path_steps):
            g.add_path(name, steps.copy())
        g.verify_path_edges()
        return g

    def write_gfa(self, fh) -> None:
        self.to_bidirected().write_gfa(fh)


def from_bidirected(graph: BidirectedGraph) -> EmbeddedGraph:
    e = EmbeddedGraph()
    for nid, seq in graph.nodes.items():
        e.add_node(nid, seq)
    for p in graph.paths:
        e.path_names.append(p.name)
        e.path_steps.append(p.steps.copy())
    return e
