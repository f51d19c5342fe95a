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
Copied from seqrush_tpu/graph/bigraph.py.
"""

from __future__ import annotations

import hashlib
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

    def has_edge(self, from_handle: int, to_handle: int) -> bool:
        e = (int(from_handle), int(to_handle))
        comp = (int(to_handle) ^ 1, int(from_handle) ^ 1)
        return e in self.edges or comp in self.edges

    def add_path(self, name: str, steps) -> None:
        self.paths.append(BiPath(name, np.asarray(steps, dtype=np.int64)))

    def build_path(self, name: str, steps: list[tuple[int, bool]]) -> None:
        handles = np.array([(nid << 1) | int(rev) for nid, rev in steps], dtype=np.int64)
        self.paths.append(BiPath(name, handles))

    # -- queries -------------------------------------------------------------

    def node_count(self) -> int:
        return len(self.nodes)

    def node_ids(self) -> list[int]:
        return sorted(self.nodes)

    def edge_array(self) -> np.ndarray:
        """Edges as an int64 [E, 2] array in insertion order."""
        if not self.edges:
            return np.zeros((0, 2), dtype=np.int64)
        return np.array(list(self.edges), dtype=np.int64)

    def edges_from(self, handle: int) -> list[int]:
        """Successors of an oriented handle incl. implied complements
        (bidirected_ops.rs:843-855)."""
        h = int(handle)
        out = []
        for (f, t) in self.edges:
            if f == h:
                out.append(t)
            elif (t ^ 1) == h:
                out.append(f ^ 1)
        return out

    def edges_to(self, handle: int) -> list[int]:
        h = int(handle)
        out = []
        for (f, t) in self.edges:
            if t == h:
                out.append(f)
            elif (f ^ 1) == h:
                out.append(t ^ 1)
        return out

    def get_sequence(self, handle: int) -> np.ndarray:
        seq = self.nodes[int(handle) >> 1]
        return reverse_complement(seq) if (int(handle) & 1) else seq

    def node_lengths(self) -> dict[int, int]:
        return {i: len(s) for i, s in self.nodes.items()}

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

    def path_hash(self, path: BiPath) -> str:
        return hashlib.sha256(self.path_sequence(path).tobytes()).hexdigest()

    def all_path_hashes(self) -> dict[str, str]:
        return {p.name: self.path_hash(p) for p in self.paths}

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

    def apply_ordering(self, ordering: list[int] | np.ndarray) -> None:
        """Renumber nodes 1..N by an ordered list of handles
        (bidirected_ops.rs:1609-1697).  Orientation bits in the ordering are
        ignored for numbering (reference emits forward handles)."""
        ordering = np.asarray(ordering, dtype=np.int64)
        if ordering.size == 0:
            return
        mapping = {int(h) >> 1: i + 1 for i, h in enumerate(ordering)}
        self._remap(mapping)

    def flip_nodes(self, node_ids: set[int]) -> None:
        """Reverse-complement the given nodes; XOR orientations in edges and
        paths (groom apply, reference src/groom.rs:613-685)."""
        if not node_ids:
            return
        for nid in node_ids:
            self.nodes[nid] = reverse_complement(self.nodes[nid])
        max_id = max(self.nodes, default=0)
        flip_lut = np.zeros(max_id + 1, dtype=np.int64)
        for nid in node_ids:
            if nid <= max_id:
                flip_lut[nid] = 1
        new_edges: dict[tuple[int, int], None] = {}
        for (f, t) in self.edges:
            nf = f ^ int(flip_lut[f >> 1])
            nt = t ^ int(flip_lut[t >> 1])
            new_edges[(nf, nt)] = None
        self.edges = new_edges
        for path in self.paths:
            path.steps = path.steps ^ flip_lut[path.steps >> 1]

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

    def find_head_nodes(self) -> list[int]:
        """Forward handles of nodes with no incoming edges to either
        orientation, sorted by earliest path position then node id
        (bidirected_ops.rs:1316-1356)."""
        has_incoming: set[int] = set()
        for (_, t) in self.edges:
            has_incoming.add(t >> 1)
        heads = [nid for nid in self.nodes if nid not in has_incoming]
        pos_map = self.build_path_position_map()
        heads.sort(key=lambda nid: (pos_map.get(nid, np.inf), nid))
        return [nid << 1 for nid in heads]

    def find_tail_nodes(self) -> list[int]:
        # reference checks only edges FROM the forward handle
        has_outgoing = {f >> 1 for (f, _) in self.edges if not (f & 1)}
        tails = sorted(nid for nid in self.nodes if nid not in has_outgoing)
        return [nid << 1 for nid in tails]

    def build_path_position_map(self) -> dict[int, int]:
        """node id -> earliest step rank across all paths
        (bidirected_ops.rs:1296-1311)."""
        pos_map: dict[int, int] = {}
        for path in self.paths:
            ids = path.steps >> 1
            for rank, nid in enumerate(ids):
                nid = int(nid)
                if nid not in pos_map or rank < pos_map[nid]:
                    pos_map[nid] = rank
        return pos_map

    # -- validation ----------------------------------------------------------

    def validate_consistency(self) -> list[str]:
        errors = []
        for (f, t) in self.edges:
            if (f >> 1) not in self.nodes:
                errors.append(f"Edge references non-existent node: {f >> 1} (from)")
            if (t >> 1) not in self.nodes:
                errors.append(f"Edge references non-existent node: {t >> 1} (to)")
        for path in self.paths:
            for h in np.unique(path.steps >> 1):
                if int(h) not in self.nodes:
                    errors.append(f"Path {path.name} references non-existent node: {int(h)}")
        return errors

    def comprehensive_verify(self, originals: dict[str, bytes] | None = None) -> list[str]:
        """Full structural verification (reference graph_ops.rs
        comprehensive_verify, :689-1141): consistency, path-edge support,
        connected components vs path coverage, optional sequence equality."""
        errors = self.validate_consistency()
        # every consecutive path step must have a supporting edge
        for path in self.paths:
            for a, b in zip(path.steps[:-1], path.steps[1:]):
                if not self.has_edge(int(a), int(b)):
                    errors.append(
                        f"Path {path.name}: missing edge {handle_str(a)} -> {handle_str(b)}"
                    )
        # nodes unreachable from any path are orphans
        covered = set()
        for path in self.paths:
            covered.update(int(h) >> 1 for h in path.steps)
        orphans = set(self.nodes) - covered
        if orphans:
            errors.append(f"{len(orphans)} nodes not covered by any path")
        # every stored edge must be traversed by some path, in either
        # direction (the reference's edge-traversal battery asserts that no
        # L line exists that no path walks and that self-loops stay minimal,
        # reference tests/test_edge_traversal.rs:17-176).  Edges come
        # only from observed path adjacencies here, so an untraversed edge
        # means that induction or compaction corrupted the graph.
        traversed: set[tuple[int, int]] = set()
        for path in self.paths:
            for a, b in zip(path.steps[:-1], path.steps[1:]):
                a, b = int(a), int(b)
                traversed.add((a, b))
                traversed.add((b ^ 1, a ^ 1))  # bidirected complement
        untraversed = [e for e in self.edges if e not in traversed]
        if untraversed:
            errors.append(
                f"{len(untraversed)} edges not traversed by any path "
                f"(first: {untraversed[0][0] >> 1}"
                f"{'-' if untraversed[0][0] & 1 else '+'} -> "
                f"{untraversed[0][1] >> 1}"
                f"{'-' if untraversed[0][1] & 1 else '+'})"
            )
        # self-loop legality: a node-level self-loop (f>>1 == t>>1) is only
        # legal when a path actually walks it (tandem repeat); spurious
        # self-loops are a classic unite-corruption symptom
        for f, t in self.edges:
            if f >> 1 == t >> 1 and (f, t) not in traversed:
                errors.append(
                    f"spurious self-loop on node {f >> 1} "
                    "(no path traverses it)"
                )
        if originals is not None:
            for path in self.paths:
                want = originals.get(path.name)
                if want is not None and self.path_sequence(path).tobytes() != want:
                    errors.append(f"Path {path.name} does not reconstruct its sequence")
        return errors

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

    def to_gfa_string(self) -> str:
        import io

        buf = io.StringIO()
        self.write_gfa(buf)
        return buf.getvalue()


def parse_gfa(text_or_fh) -> BidirectedGraph:
    """Read GFA 1.0 (S/L/P) into a BidirectedGraph — interop + tools."""
    if hasattr(text_or_fh, "read"):
        text = text_or_fh.read()
    else:
        text = text_or_fh
    g = BidirectedGraph()
    links: list[tuple[int, int]] = []
    for line in text.splitlines():
        if not line:
            continue
        fields = line.split("\t")
        tag = fields[0]
        if tag == "S":
            g.add_node(int(fields[1]), fields[2].encode())
        elif tag == "L":
            f = (int(fields[1]) << 1) | (fields[2] == "-")
            t = (int(fields[3]) << 1) | (fields[4] == "-")
            links.append((f, t))
        elif tag == "P":
            steps = []
            for step in fields[2].split(","):
                rev = step.endswith("-")
                steps.append((int(step[:-1]) << 1) | rev)
            g.add_path(fields[1], np.array(steps, dtype=np.int64))
    for f, t in links:
        g.add_edge(f, t)
    return g
