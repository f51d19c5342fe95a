"""Union-find over orientation-encoded positions, as torch tensors on a device.

The state is a dense ``parent: int32[capacity]`` tensor with two bulk,
deterministic operations (the counterparts of ``seqrush_tpu/ops/unionfind.py``):

* ``unite_edges(parent, u, v)`` -- hook every edge's larger root onto the
  smaller root with an unordered scatter-min (``scatter_reduce_(..., "amin")``),
  alternated with pointer jumping until nothing changes.  The converged
  representative of every component is its minimum Pos, so the result does
  not depend on edge order or device.
* ``compress(parent)`` -- ``parent = parent[parent]`` until a fixpoint;
  afterwards ``parent[i]`` is the representative of i.

``find``, ``count_components``, ``BidirectedUnionFind`` (the reference's
stateful API over those bulk operations) and ``match_region_pairs`` are the
rest of the JAX module's surface.

Capacity is ``2 * total_length + 2`` so raw Pos values (offset << 1 | orient)
index directly.  Each loop reads one flag back to the host per round.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device


def create(capacity: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """Fresh parent array: every Pos is its own representative."""
    if capacity >= 2**31:
        raise ValueError("union-find capacity must fit int32")
    return torch.arange(capacity, dtype=torch.int32, device=resolve_device(device))


def compress(parent: torch.Tensor) -> torch.Tensor:
    """Full path compression: parent[i] becomes the root of i, for all i."""
    p = parent
    while True:
        p2 = p[p.long()]
        if torch.equal(p2, p):
            return p2
        p = p2


def _as_index(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(device)


def unite_edges(parent: torch.Tensor, u, v) -> torch.Tensor:
    """Bulk unite: afterwards every (u[i], v[i]) pair is connected.

    Returns a fully compressed parent array (parent[i] == root of i) whose
    roots are component minima, whatever the edge order."""
    u = _as_index(u, parent.device)
    v = _as_index(v, parent.device)
    p = parent
    if u.numel():
        while True:
            p = compress(p)
            ru = p[u]
            rv = p[v]
            hi = torch.maximum(ru, rv).long()
            lo = torch.minimum(ru, rv)
            p2 = p.scatter_reduce(0, hi, lo, reduce="amin")
            if torch.equal(p2, p):
                break
            p = p2
    return compress(p)


def count_components_fast(parent, n_valid: int) -> int:
    """Component count as the number of self-parented slots in [0, n_valid).

    Equals the number of components over forward positions when every
    component holds a forward position (the pipeline pre-unites F/R of every
    offset) and no component spans slots >= n_valid."""
    if isinstance(parent, np.ndarray):
        return int((parent[:n_valid] == np.arange(n_valid, dtype=parent.dtype)).sum())
    p = parent[:n_valid]
    return int((p == torch.arange(n_valid, dtype=p.dtype, device=p.device)).sum())


def find(parent: torch.Tensor, pos) -> torch.Tensor:
    """Representatives of pos for any (possibly uncompressed) parent array."""
    r = _as_index(pos, parent.device)
    while True:
        r2 = parent[r].long()
        if torch.equal(r2, r):
            return r2.to(torch.int32)
        r = r2


def count_components(parent: torch.Tensor, total_length: int | None = None) -> int:
    """Number of distinct components over forward positions (the even slots,
    the first total_length of them when given)."""
    roots = compress(parent)[::2]
    if total_length is not None:
        roots = roots[:total_length]
    return int(torch.unique(roots).numel())


class BidirectedUnionFind:
    """The reference's stateful union-find API over the bulk operations: a
    parent array of 2 * max_offset + 2 slots on `device`, always compressed
    after a unite."""

    def __init__(self, max_offset: int, device: str | torch.device = "cuda"):
        self.capacity = (max_offset << 1) + 2
        self.parent = create(self.capacity, device)

    def unite_batch(self, u, v) -> None:
        self.parent = unite_edges(self.parent, u, v)

    def roots(self) -> np.ndarray:
        return self.parent.cpu().numpy()

    def unite(self, pos1: int, pos2: int) -> None:
        if pos1 != pos2:
            self.unite_batch(np.array([pos1]), np.array([pos2]))

    def find(self, pos: int) -> int:
        return int(self.parent[pos])

    def same(self, pos1: int, pos2: int) -> bool:
        return pos1 == pos2 or int(self.parent[pos1]) == int(self.parent[pos2])

    def pre_unite_orientations(self, total_length: int) -> None:
        """Unite (i, F) with (i, R) for every offset."""
        i = np.arange(total_length, dtype=np.int64)
        self.unite_batch(i << 1, (i << 1) | 1)

    def unite_matching_region(self, seq1_offset: int, seq2_offset: int, seq1_local_start: int,
                              seq2_local_start: int, match_length: int, seq1_is_rc: bool,
                              seq1_len: int) -> None:
        """Unite one match run, the query possibly reverse-complemented."""
        self.unite_batch(*match_region_pairs(seq1_offset, seq2_offset, seq1_local_start, seq2_local_start,
                                             match_length, seq1_is_rc, seq1_len))

    def unite_matching_region_seq2_rc(self, seq1_offset: int, seq2_offset: int, seq1_local_start: int,
                                      seq2_local_start: int, match_length: int, seq2_is_rc: bool,
                                      seq2_len: int) -> None:
        """Unite one match run, the target possibly reverse-complemented."""
        i = np.arange(match_length, dtype=np.int64)
        pos1 = (np.int64(seq1_offset + seq1_local_start) + i) << 1
        if seq2_is_rc:
            rc_pos = np.int64(seq2_len - 1) - (np.int64(seq2_local_start) + i)
            pos2 = ((np.int64(seq2_offset) + rc_pos) << 1) | 1
        else:
            pos2 = (np.int64(seq2_offset + seq2_local_start) + i) << 1
        self.unite_batch(pos1, pos2)


def match_region_pairs(seq1_offset: int, seq2_offset: int, seq1_local_start: int, seq2_local_start: int,
                       match_length: int, seq1_is_rc: bool, seq1_len: int) -> tuple[np.ndarray, np.ndarray]:
    """One match run as per-base Pos pairs: forward (q_off + qs + i, F) with
    (t_off + ts + i, F); with the query reverse-complemented, its RC-local
    base maps back to fwd = len - 1 - rc: (q_off + len - 1 - (qs + i), R)."""
    i = np.arange(match_length, dtype=np.int64)
    pos2 = (np.int64(seq2_offset + seq2_local_start) + i) << 1
    if seq1_is_rc:
        fwd_local = np.int64(seq1_len - 1) - (np.int64(seq1_local_start) + i)
        pos1 = ((np.int64(seq1_offset) + fwd_local) << 1) | 1
    else:
        pos1 = (np.int64(seq1_offset + seq1_local_start) + i) << 1
    return pos1, pos2
