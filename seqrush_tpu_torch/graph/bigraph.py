"""Bidirected sequence graph container.

Array-first analog of the reference's ``BidirectedGraph`` (reference 
src/bidirected_ops.rs:9-13): nodes are id -> sequence, edges are oriented
handle pairs deduplicated against their complements, paths are dense int64
handle arrays (node_id<<1|rev) so path-wide operations (orientation tests,
renumbering, edge extraction, sequence reconstruction) are vectorized numpy
instead of per-step loops.

Edge iteration order: the reference stores edges in a HashSet (arbitrary
order) and sorts wherever determinism matters; we keep insertion order, which
is deterministic by construction and compatible with every sorted consumer.
Copied from seqrush_tpu/graph/bigraph.py, trimmed to what graph induction,
compaction and the GFA writer use.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..pos import handle_str, reverse_complement


@dataclass
class BiPath:
    name: str
    steps: np.ndarray  # int64 handle codes

    def __post_init__(self):
        self.steps = np.asarray(self.steps, dtype=np.int64)


class BidirectedGraph:
    def __init__(self):
        self.nodes: dict[int, np.ndarray] = {}  # id -> uint8 ASCII sequence
        self.edges: dict[tuple[int, int], None] = {}  # (from_handle, to_handle), ordered
        self.paths: list[BiPath] = []

    # -- construction --------------------------------------------------------

    def add_node(self, node_id: int, sequence) -> None:
        if isinstance(sequence, (bytes, bytearray)):
            sequence = np.frombuffer(bytes(sequence), dtype=np.uint8)
        self.nodes[int(node_id)] = np.asarray(sequence, dtype=np.uint8)

    def add_edge(self, from_handle: int, to_handle: int) -> None:
        """Insert unless the edge or its complement exists (bidirected_ops.rs:813-825)."""
        e = (int(from_handle), int(to_handle))
        comp = (int(to_handle) ^ 1, int(from_handle) ^ 1)
        if e not in self.edges and comp not in self.edges:
            self.edges[e] = None

    def add_edges_bulk(self, from_handles: np.ndarray, to_handles: np.ndarray) -> None:
        """Vectorized first-seen-representation complement dedup.

        Keeps, for each {edge, complement} class, the representation of its
        first occurrence in order — same result as calling add_edge in a loop.
        """
        f = np.asarray(from_handles, dtype=np.int64)
        t = np.asarray(to_handles, dtype=np.int64)
        if f.size == 0:
            return
        key = (f << 32) | t
        comp_key = ((t ^ 1) << 32) | (f ^ 1)
        canon = np.minimum(key, comp_key)
        # stable first-occurrence unique
        _, first_idx = np.unique(canon, return_index=True)
        first_idx.sort()
        for i in first_idx:
            self.add_edge(int(f[i]), int(t[i]))

    def add_path(self, name: str, steps) -> None:
        self.paths.append(BiPath(name, np.asarray(steps, dtype=np.int64)))

    # -- queries -------------------------------------------------------------

    def node_count(self) -> int:
        return len(self.nodes)

    def get_sequence(self, handle: int) -> np.ndarray:
        seq = self.nodes[int(handle) >> 1]
        return reverse_complement(seq) if (int(handle) & 1) else seq

    def path_sequence(self, path: BiPath) -> np.ndarray:
        """Concatenate oriented node sequences along a path (vectorized for 1bp-heavy graphs)."""
        if path.steps.size == 0:
            return np.zeros(0, dtype=np.uint8)
        parts = []
        for h in path.steps:
            h = int(h)
            seq = self.nodes[h >> 1]
            parts.append(reverse_complement(seq) if h & 1 else seq)
        return np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)

    # -- renumbering ---------------------------------------------------------

    def _remap(self, old_to_new: dict[int, int]) -> None:
        """Apply a node-id mapping to nodes, edges and paths
        (bidirected_ops.rs:23-71)."""
        max_old = max(max(self.nodes, default=0), max(old_to_new, default=0))
        lut = np.arange(max_old + 1, dtype=np.int64)
        for old, new in old_to_new.items():
            lut[old] = new

        self.nodes = {int(lut[i]): seq for i, seq in self.nodes.items()}

        new_edges: dict[tuple[int, int], None] = {}
        for (f, t) in self.edges:
            nf = (int(lut[f >> 1]) << 1) | (f & 1)
            nt = (int(lut[t >> 1]) << 1) | (t & 1)
            new_edges[(nf, nt)] = None
        self.edges = new_edges

        for path in self.paths:
            ids = path.steps >> 1
            path.steps = (lut[ids] << 1) | (path.steps & 1)

    def renumber_nodes_sequentially(self) -> None:
        """Renumber to 1..N in ascending old-id order (bidirected_ops.rs:75-89)."""
        mapping = {old: i + 1 for i, old in enumerate(sorted(self.nodes))}
        self._remap(mapping)

    # -- path-derived structure ----------------------------------------------

    def verify_path_edges(self) -> int:
        """Add any missing consecutive-step edges (bidirected_ops.rs:1049-1080).
        Returns the number of edges added.

        Vectorized (one canonical-key isin instead of ~2 per-step dict
        probes); insertion order matches the sequential walk — missing
        edges append after the existing ones in first-occurrence path
        order, exactly as the per-step loop produced."""
        fs, ts = [], []
        for path in self.paths:
            s = np.asarray(path.steps, dtype=np.int64)
            if s.size >= 2:
                fs.append(s[:-1])
                ts.append(s[1:])
        if not fs:
            return 0
        f = np.concatenate(fs)
        t = np.concatenate(ts)
        canon = np.minimum((f << 32) | t, ((t ^ 1) << 32) | (f ^ 1))
        if self.edges:
            ef = np.fromiter((e[0] for e in self.edges), np.int64, len(self.edges))
            et = np.fromiter((e[1] for e in self.edges), np.int64, len(self.edges))
            ekey = np.minimum((ef << 32) | et, ((et ^ 1) << 32) | (ef ^ 1))
            missing = ~np.isin(canon, ekey)
        else:
            missing = np.ones(canon.size, dtype=bool)
        if not missing.any():
            return 0
        mc = canon[missing]
        mf = f[missing]
        mt = t[missing]
        _, first = np.unique(mc, return_index=True)
        first.sort()
        for i in first:
            self.edges[(int(mf[i]), int(mt[i]))] = None
        return int(first.size)

    # -- GFA -----------------------------------------------------------------

    def write_gfa(self, fh) -> None:
        """GFA 1.0: S lines in id order, L lines as stored (no
        canonicalization, bidirected_ops.rs:893-907), P lines."""
        w = fh.write
        w("H\tVN:Z:1.0\n")
        for nid in sorted(self.nodes):
            w(f"S\t{nid}\t{self.nodes[nid].tobytes().decode()}\n")
        for (f, t) in self.edges:
            w(
                f"L\t{f >> 1}\t{'-' if f & 1 else '+'}\t{t >> 1}\t{'-' if t & 1 else '+'}\t0M\n"
            )
        for path in self.paths:
            steps = ",".join(handle_str(h) for h in path.steps)
            w(f"P\t{path.name}\t{steps}\t*\n")
