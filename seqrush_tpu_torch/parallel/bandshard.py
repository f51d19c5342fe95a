"""Band-sharded alignment: one pair's band split by lanes over a mesh.

The port of ``seqrush_tpu/parallel/bandshard.py``.  The anti-diagonal
sweep's state is [6, B, W] and its traceback [T + 1, B, W]; every
dependency is a lane shift of at most one, so the band splits into D
strips of W / D lanes, and each anti-diagonal needs one column of the
neighbour strip (kernel A's sharded mode, ``ops/nw_cuda.py::
nw_align_sharded``).  A device's traceback memory drops from O(T W) to
O(T W / D): a pair whose traceback alone exceeds one dispatch's budget
aligns exactly by adding shards.

The traceback is walked on the host over the gathered strips
(``ops/nw.py::traceback_pair``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import nw_cuda
from ..ops.nw import resolve_matches, traceback_pair
from ..pos import encode_bases
from .mesh import Mesh


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _on(x, device) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def nw_align_band_sharded(mesh: Mesh, Q, T, qlens, tlens, *, mismatch: int, o1: int, e1: int,
                          o2: int, e2: int, band: int, tmax: int):
    """Lane-sharded banded Gotoh over ``mesh``.

    Q [B, Lq], T [B, Lt] uint8 (QPAD / TPAD padded), qlens, tlens [B] int32,
    numpy or torch.  Returns (scores [B] int32 on the mesh's first device,
    -1 for an unfinished pair; strips: per shard its [B, T_total + 1, W / D]
    uint8 slice of the traceback, on its device), T_total =
    ``nw_cuda.sharded_rows(band, tmax)``.  band + 1 must divide by the mesh
    size (quantize with band_for_mesh)."""
    first = mesh.devices[0]
    Q, T = _on(Q, first).to(torch.uint8), _on(T, first).to(torch.uint8)
    qlens, tlens = _on(qlens, first).to(torch.int32), _on(tlens, first).to(torch.int32)
    return nw_cuda.nw_align_sharded(mesh.devices, Q.contiguous(), T.contiguous(), qlens, tlens,
                                    mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2, band=band, tmax=tmax)


def band_for_mesh(k: int, n_devices: int, quantum: int = 128) -> int:
    """Half-width k quantized so W = k + 1 splits into n_devices equal
    strips of a multiple of `quantum` lanes each."""
    return _round_up(k + 1, quantum * n_devices) - 1


def gather_strips(strips) -> np.ndarray:
    """The shards' strips of one pair-major traceback, gathered on the host
    and joined on the lane axis: [B, T_total + 1, W] uint8."""
    return np.concatenate([s.cpu().numpy() for s in strips], axis=2)


def align_pair_sharded(mesh: Mesh, query: bytes | np.ndarray, target: bytes | np.ndarray, *,
                       mismatch: int = 5, o1: int = 8, e1: int = 2, o2: int = 24, e2: int = 1,
                       band: int | None = None) -> tuple[int, list[tuple[int, str]]]:
    """Align ONE pair (ASCII bases) with its band sharded over every device
    of ``mesh``.

    Returns (score, CIGAR items with '=' / 'X' resolved).  The default band
    is the full half-width max(qlen, tlen), so every DP cell lies in the
    band and the result is optimal at any divergence; a narrower ``band``
    gives the usual banded contract (certify with the runner's bound and
    escalate).  The band is quantized with band_for_mesh."""
    return align_codes_sharded(mesh, encode_bases(query), encode_bases(target), mismatch=mismatch,
                               o1=o1, e1=e1, o2=o2, e2=e2, band=band)


def align_codes_sharded(mesh: Mesh, q: np.ndarray, t: np.ndarray, *, mismatch: int, o1: int, e1: int,
                        o2: int, e2: int, band: int | None = None) -> tuple[int, list[tuple[int, str]]]:
    """align_pair_sharded on base codes (pos.encode_bases)."""
    qlen, tlen = q.size, t.size
    if band is None:
        band = max(qlen, tlen)
    band = band_for_mesh(band, mesh.size)
    tmax = _round_up(qlen + tlen, 512)
    scores, strips = nw_align_band_sharded(
        mesh, q[None, :].astype(np.uint8), t[None, :].astype(np.uint8), np.array([qlen], np.int32),
        np.array([tlen], np.int32), mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2, band=band, tmax=tmax,
    )
    score = int(scores[0].item())
    if score < 0:  # a runtime guard, kept under python -O
        raise RuntimeError("pair did not finish inside tmax (impossible for a global alignment)")
    items = traceback_pair(gather_strips(strips)[0], qlen, tlen, band)
    return score, resolve_matches(items, q, t)
