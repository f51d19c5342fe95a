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
