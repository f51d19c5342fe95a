"""Union-find over orientation-encoded positions, as torch tensors on a device.

The state is a dense ``parent: int32[capacity]`` tensor with two bulk,
deterministic operations (the counterparts of ``seqrush_tpu/ops/unionfind.py``):

* ``unite_edges(parent, u, v)`` -- afterwards every edge's ends share a root,
  and the parent array is fully compressed.  Every component's
  representative is its smallest input root (from an identity start, its
  minimum Pos), so the result does not depend on edge order or device.
* ``compress(parent)`` -- afterwards ``parent[i]`` is the representative of i.

On a GPU both, and ``find``, run the hand-written kernels of
``csrc/unionfind.cu`` (a unite is one cooperative launch: a lock-free CAS
hook over the edges, a grid barrier, then a chase of every slot to its
root; no read back to the host); on the CPU they run their plain versions,
``unite_edges_reference``
(scatter-min hooks, ``scatter_reduce_(..., "amin")``, alternated with
pointer jumping until nothing changes), ``compress_reference``
(``parent = parent[parent]`` until a fixpoint) and ``find_reference``, each
of whose loops reads one flag back to the host a round.  There is no
fallback between the two: a failed build or launch raises.  The kernels'
wrappers return new tensors, as the plain versions do; the input parent is
never written.

``count_components``, ``BidirectedUnionFind`` (the reference's stateful API
over those bulk operations) and ``match_region_pairs`` are the rest of the
JAX module's surface.

Capacity is ``2 * total_length + 2`` so raw Pos values (offset << 1 | orient)
index directly.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import resolve_device
from . import nw_cuda


# the counts of the hook's own timer (csrc/unionfind.cu, UF_COUNT_*, built
# only into tools/uf_timing.py's library), in the kernel's order
UF_COUNTS = ("edges", "first_hop_equal", "no_cas", "finds", "hops", "find_cycles", "halving_stores", "cas",
             "cas_failed", "max_hops", "compress_hops")


def create(capacity: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """Fresh parent array: every Pos is its own representative."""
    if capacity >= 2**31:
        raise ValueError("union-find capacity must fit int32")
    return torch.arange(capacity, dtype=torch.int32, device=resolve_device(device))


def compress(parent: torch.Tensor) -> torch.Tensor:
    """Full path compression: parent[i] becomes the root of i, for all i.
    On a GPU one launch of uf_compress_kernel on a copy of parent."""
    if parent.device.type == "cpu":
        return compress_reference(parent)
    _check_parent(parent)
    out = parent.clone()
    _compress_cuda(out)
    return out


def compress_reference(parent: torch.Tensor) -> torch.Tensor:
    """Plain version of compress: parent = parent[parent] until a fixpoint."""
    p = parent
    while True:
        p2 = p[p.long()]
        if torch.equal(p2, p):
            return p2
        p = p2


def _host_array(x, dtype) -> torch.Tensor:
    a = np.ascontiguousarray(x, dtype=dtype)
    if any(st < 0 for st in a.strides):  # numpy calls a reversed 1-entry view contiguous
        a = a.copy()
    return torch.from_numpy(a)


def _as_index(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return _host_array(x, np.int64).to(device)


def edges_on(x, device: torch.device) -> torch.Tensor:
    """Indices as a contiguous int32 tensor on the card (the JAX program
    casts them to int32): numpy arrays and CPU tensors are cast on the host
    before the copy, which halves the bytes of int64 edges over PCIe;
    tensors already on the card are cast there."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cpu":
            x = x.to(torch.int32)
        return x.to(device=device, dtype=torch.int32).contiguous()
    return _host_array(x, np.int32).to(device)


def _check_parent(parent: torch.Tensor) -> None:
    nw_cuda._require_cuda(parent.device)
    nw_cuda._check("parent", parent, torch.int32, 1, parent.device)


def _launch(kernel: str, device: torch.device, *args) -> None:
    """One launch of csrc/unionfind.cu's `kernel` on the current stream of
    `device`, counted in nw_cuda.LAUNCHES; raises if it was refused."""
    lib = nw_cuda._library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{kernel}_launch")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")
    nw_cuda.LAUNCHES[kernel] += 1


# threads a block of csrc/unionfind.cu's kernels (UF_THREADS there)
UF_THREADS = 256
_OCCUPANCY: dict = {}


def unite_grid(n_edges: int, n_slots: int, blocks_per_sm: int, sms: int) -> int:
    """Blocks of a unite's cooperative launch: one thread an edge or a slot,
    whichever are more, up to the blocks the card holds at once (the grid
    strides over the rest)."""
    if blocks_per_sm < 1 or sms < 1:
        raise ValueError(f"the card holds {blocks_per_sm} blocks of the unite on each of {sms} SMs")
    need = -(-max(n_edges, n_slots, 1) // UF_THREADS)
    return min(need, blocks_per_sm * sms)


def _occupancy(device: torch.device) -> tuple[int, int]:
    """(blocks an SM, SMs) of uf_unite_kernel on device, asked once."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _OCCUPANCY:
        bps, sms = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            err = nw_cuda._library().uf_unite_occupancy(ctypes.byref(bps), ctypes.byref(sms))
        if err != 0:
            raise RuntimeError(f"uf_unite occupancy query failed with CUDA error {err}")
        _OCCUPANCY[key] = (bps.value, sms.value)
    return _OCCUPANCY[key]


def _unite_cuda(parent: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> None:
    """uf_unite_kernel on parent in place, one cooperative launch: afterwards
    every (u[e], v[e]) shares a root and parent[i] is the root of i.  u and
    v are int32 on parent's card (none: only the compress)."""
    grid = unite_grid(u.numel(), parent.numel(), *_occupancy(parent.device))
    _launch("uf_unite", parent.device, parent.data_ptr(), u.data_ptr(), v.data_ptr(), u.numel(), parent.numel(),
            grid)


def _compress_cuda(parent: torch.Tensor) -> None:
    """uf_compress_kernel on parent in place: afterwards parent[i] is the
    root of i."""
    if parent.numel():
        _launch("uf_compress", parent.device, parent.data_ptr(), parent.numel())


def unite_edges(parent: torch.Tensor, u, v) -> torch.Tensor:
    """Bulk unite: afterwards every (u[i], v[i]) pair is connected.

    Returns a fully compressed parent array (parent[i] == root of i) whose
    roots are each component's smallest input root, whatever the edge order.
    On a GPU: the edges as int32 on the card (numpy or CPU edges are cast on
    the host before the copy, edges on the card are cast there), then one
    cooperative launch of uf_unite_kernel on a copy of parent (the hook, a
    grid barrier, the compress); an empty edge list only compresses, as in
    the JAX package."""
    if parent.device.type == "cpu":
        return unite_edges_reference(parent, u, v)
    _check_parent(parent)
    out = parent.clone()
    u32 = edges_on(u, out.device)
    v32 = edges_on(v, out.device)
    if u32.shape != v32.shape:
        raise ValueError(f"u has {u32.numel()} entries and v {v32.numel()}")
    if out.numel():
        _unite_cuda(out, u32, v32)
    return out


def unite_edges_reference(parent: torch.Tensor, u, v) -> torch.Tensor:
    """Plain version of unite_edges: scatter-min hooks of every edge's larger
    root onto its smaller root, alternated with compress_reference until
    nothing changes; roots are each component's smallest input root."""
    u = _as_index(u, parent.device)
    v = _as_index(v, parent.device)
    p = parent
    if u.numel():
        while True:
            p = compress_reference(p)
            ru = p[u]
            rv = p[v]
            hi = torch.maximum(ru, rv).long()
            lo = torch.minimum(ru, rv)
            p2 = p.scatter_reduce(0, hi, lo, reduce="amin")
            if torch.equal(p2, p):
                break
            p = p2
    return compress_reference(p)


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
    """Representatives of pos (int32, pos's shape) for any (possibly
    uncompressed) parent array.  On a GPU one launch of uf_find_kernel, which
    only reads parent."""
    if parent.device.type == "cpu":
        return find_reference(parent, pos)
    _check_parent(parent)
    p32 = edges_on(pos, parent.device)
    out = torch.empty_like(p32)
    if p32.numel():
        _launch("uf_find", parent.device, parent.data_ptr(), p32.data_ptr(), out.data_ptr(), p32.numel(),
                parent.numel())
    return out


def find_reference(parent: torch.Tensor, pos) -> torch.Tensor:
    """Plain version of find: r = parent[r] until a fixpoint."""
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
