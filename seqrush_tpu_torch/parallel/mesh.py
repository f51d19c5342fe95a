"""A one-axis mesh of torch devices, and the sharded align + unite step.

The port of ``seqrush_tpu/parallel/mesh.py``.  Alignment batches are
sharded on the batch axis over the mesh's ``data`` axis: every kernel of
the alignment path is independent per pair, so each device runs its row
slice with no communication.  The union is the deterministic scatter-min
unite (``ops/unionfind.py``), whose result does not depend on the order of
its edges, so gathering every shard's edge list and uniting once gives the
single-device parent array.

A mesh may repeat a device: ``Mesh([cuda:0] * 4)`` runs four shards on one
card (each its own launches), as the CPU tests run ``[cpu] * 8``.
``make_mesh(n)`` takes ``cuda:0 .. cuda:n-1`` and raises with fewer cards.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import unionfind as uf
from ..ops import wfa
from ..utils import resolve_device


@dataclass(frozen=True, init=False)
class Mesh:
    """Devices along one ``data`` axis, in shard order."""

    devices: tuple[torch.device, ...]

    def __init__(self, devices):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int, device: str | torch.device = "cuda") -> Mesh:
    """n_devices shards: cuda:0 .. cuda:n-1 on 'cuda' (raises with fewer
    cards), n times the CPU device on 'cpu'."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh([dev] * n)
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"a mesh of {n} devices needs {n} CUDA devices, found {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def shard_batch(mesh: Mesh, *arrays) -> list[tuple[torch.Tensor, ...]]:
    """Batch-leading arrays split into mesh.size equal row slices, slice i
    on device i: one tuple of the arrays' slices per shard.  A batch that
    does not divide is padded with zero rows first."""
    n = mesh.size
    out = []
    tensors = [_as_tensor(a) for a in arrays]
    B = tensors[0].shape[0]
    pad = -B % n
    if pad:
        tensors = [torch.cat([t, t.new_zeros((pad, *t.shape[1:]))]) for t in tensors]
    per = (B + pad) // n
    for i, dev in enumerate(mesh.devices):
        out.append(tuple(t[i * per : (i + 1) * per].to(dev) for t in tensors))
    return out


def replicate(mesh: Mesh, *arrays) -> list[tuple[torch.Tensor, ...]]:
    """A copy of each array on every device of the mesh, one tuple a shard."""
    tensors = [_as_tensor(a) for a in arrays]
    return [tuple(t.to(dev) for t in tensors) for dev in mesh.devices]


def _lcp_edges(Q, T, qoffs, toffs, lcp_len: int):
    """Unite edges of each pair's exact-match prefix: (q_off + i) << 1 with
    (t_off + i) << 1 for i below the prefix's length, 0 with 0 elsewhere."""
    L = lcp_len
    eq = (Q[:, :L] == T[:, :L]).to(torch.int32)
    lcp = torch.cumprod(eq, dim=1).sum(dim=1)
    i = torch.arange(L, dtype=torch.int64, device=Q.device)[None, :]
    mask = i < lcp[:, None]
    u = torch.where(mask, (qoffs.to(torch.int64)[:, None] + i) << 1, 0).reshape(-1)
    v = torch.where(mask, (toffs.to(torch.int64)[:, None] + i) << 1, 0).reshape(-1)
    return u.to(torch.int32), v.to(torch.int32)


def distributed_align_unite(mesh: Mesh, parent, Q, T, qlens, tlens, caps, qoffs, toffs,
                            pen: wfa.Penalties, smax: int, band: int):
    """The sharded align + unite step; returns (scores, parent).

    Each shard runs the wavefront kernel's score-only mode
    (``wfa_align_device(keep_history=False)``) on its row slice and the
    unite edges of its pairs' exact-match prefixes; the edge lists are
    gathered and united into the parent array.  In one process every
    replica of the parent would be the same tensor, so it is united once,
    on the mesh's first device; the scores come back there too, in row
    order.  B must divide by the mesh size."""
    B = Q.shape[0]
    n = mesh.size
    assert B % n == 0, f"batch {B} must divide mesh size {n}"
    lcp_len = max(int(min(Q.shape[1], T.shape[1]) - wfa.EXTEND_CHUNK), 1)
    kw = dict(pen.kernel_kwargs(), smax=smax, band=band)
    first = mesh.devices[0]
    scores, us, vs = [], [], []
    for Qs, Ts, qs, ts, cs, qo, to in shard_batch(mesh, Q, T, qlens, tlens, caps, qoffs, toffs):
        s, _ = wfa.wfa_align_device(Qs, Ts, qs, ts, cs, keep_history=False, **kw)
        u, v = _lcp_edges(Qs, Ts, qo, to, lcp_len)
        scores.append(s.to(first))
        us.append(u.to(first))
        vs.append(v.to(first))
    parent = uf.unite_edges(_as_tensor(parent).to(first), torch.cat(us), torch.cat(vs))
    return torch.cat(scores), parent
