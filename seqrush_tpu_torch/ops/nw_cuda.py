"""Kernels A to D of the alignment path, for Hopper, with their plain versions.

* ``nw_align`` -- kernel A, the banded two-piece Gotoh sweep
  (``csrc/nw_sweep.cu``, device code in ``csrc/nw_sweep.cuh``; replaces
  ``seqrush_tpu/ops/nw_pallas.py::_kernel``).
  Returns scores [B] int32 and the packed traceback [B, tmax_pad, W] uint8,
  or, with ``with_traceback=False`` (the score-only mode of the anchored
  route's verify sweep), the scores alone and None: no traceback tensor is
  allocated and the kernel stores none.  ``int16=True`` runs the saturating
  int16 DP of ``seqrush_tpu/ops/nw.py::_sweep_v3(dtype=int16)``, on the
  register route as the packed s16x2 sweep (``csrc/nw_sweep_i16.cu``, two
  pairs a register, ``plan_sweep_i16``); ``t_snap`` the fold's snapshot mode
  (``_sweep_v3(t_snap=...)``).
* ``nw_walk`` -- kernel B, the reverse traceback walk (``csrc/nw_walk.cu``;
  replaces ``nw_pallas.py::_walk_kernel``).  Returns opcodes [B, tmax + 1]
  uint8 (0 none, 1 M, 2 I, 3 D at column td).
* ``nw_walk_runs`` -- kernel B's runs mode (the counterpart of the XLA
  program ``seqrush_tpu/ops/nw.py::_tb_scan_tbw(emit="runs")``): the same
  walk, emitting run tokens [B, run_max] int32 (op | len << 2, in walk
  order) and the run counts [B] int32 instead of opcodes.
* ``nw_align_segment`` / ``nw_walk_segment`` -- the segment modes of kernels
  A and B (``csrc/nw_sweep_seg.cu``, ``csrc/nw_walk.cu``; the counterparts of
  ``seqrush_tpu/ops/nw.py::_nw_segment`` and ``_tb_scan_segment``): one
  segment of anti-diagonals [t0 + 1, t0 + seg] from a carried state, the DP
  rows [6, B, W] forwards and the walk's cursor [4, B] backwards.
* ``nw_align_segment_run`` / ``nw_align_segment_group`` /
  ``nw_walk_segment_group`` -- the long route's launch shapes of those
  modes: a run of segments in one score-only launch that stores each
  segment's checkpoint as it passes; a group of G segments recomputed from
  their checkpoints in one launch (a grid of pair x segment blocks) into
  one traceback [B, G * seg, W]; and one walk over a group's rows.
* ``nw_align_long`` -- the long-pair route (``seqrush_tpu/ops/nw.py::
  nw_align_long``): the forward pass checkpoints the DP rows at each
  segment start; the reverse pass recomputes the traceback a group of G
  segments at a time, G the most whose traceback fits the memory budget,
  and walks each group in one launch.  Where the whole traceback fits, the
  recompute of the segments already checkpointed runs on a second stream
  while the forward pass goes on.
* ``nw_walk_start`` -- kernel B's start mode (``_tb_scan_tbw(start=...)``):
  the segment mode's walk over a whole traceback from given cursors.
* ``nw_align_fold`` -- the bidirectional fold (``nw.nw_align_fold``):
  kernel A's snapshot mode on the forward and the reversed rows, the join
  of the halves (``fold_combine``, ``csrc/fold_combine.cu``; the counterpart
  of ``nw.nw_align_fold``'s combine, nw.py:1720-1806), kernel B's start mode
  on both halves.
* ``nw_align_rows`` / ``nw_walk_rows`` -- kernels C and D, the row-major
  sweep and walk (``csrc/nw_rows.cu``; the counterparts of ``nw._sweep_rows``
  and ``nw._tb_rows_scan``).
* ``nw_align_sharded`` -- kernel A's sharded mode (``csrc/nw_sweep_shard.cu``;
  the counterpart of the XLA program ``seqrush_tpu/parallel/bandshard.py::
  _build_sharded_sweep``): one pair's band split by lanes over D shards,
  each anti-diagonal's shifted-in column handed over from the neighbour
  shard, a pair's band on a thread-block cluster (``pick_shard_plan``;
  ``nw_align_sharded_at`` at a given cluster size); returns the scores and
  one traceback strip per shard.

Each wrapper runs its plain PyTorch version (``nw_align_reference``,
``nw_walk_reference``, ``nw_walk_runs_reference``, ``nw_walk_start_reference``,
``nw_align_rows_reference``, ``nw_walk_rows_reference``,
``nw_align_sharded_reference``, ``fold_combine_reference``) when the tensors lie
on the CPU, and launches its CUDA
kernel when they lie on a GPU; there is no fallback between the two.  The
plain versions repeat the reference arithmetic step by step, including the
bytes written at cells outside the pair's matrix, so the traceback tensor
can be compared whole.

Kernel A has two routes, which ``plan_sweep`` (pure Python) picks from the
band: the register route (each pair's lanes in the registers of one to
eight warps) up to W = REG_MAX_W, and the wide route (``wide_plan``; one
pair a thread-block cluster, or a chain of clusters, its lanes in
registers; ``csrc/nw_sweep_wide.cuh``) above it, for penalties outside
[0, 2^16), int16 adds that can wrap, and sequences too long for the
register route's shared memory.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` from the
sources under ``csrc/`` into ``build/seqrush_tpu_torch/`` at the repository
root, one ``nvcc`` per source in parallel, and loaded with ctypes.  The file
name carries a hash of the sources and flags, so an edit rebuilds.

``LAUNCHES`` counts kernel launches (not plain-version calls) per kernel,
kernel A's score-only mode apart as ``nw_sweep_score_only``, its int16 and
snapshot modes as ``nw_sweep_int16`` and ``nw_sweep_snapshot``, kernel B's
runs and start modes as ``nw_walk_runs`` and ``nw_walk_start``, each segment
mode apart (``nw_sweep_segment``, ``nw_sweep_segment_score_only`` (a
forward run's launch too), ``nw_walk_segment``, and the group launches
``nw_sweep_segment_group``, ``nw_walk_segment_group``, which the long route
makes at every G, 1 included), the wide route apart as ``nw_sweep_wide``
(single-shot, every mode) and ``nw_sweep_wide_segment`` (every segment
launch), one a launch of a chain's slices (``wide_slices``), the sharded mode as ``nw_sweep_sharded`` (one a
device's launch), and kernels C and D as ``nw_rows_sweep`` and
``nw_rows_walk``, the fold's combine as ``fold_combine``; the wavefront
kernel of ``ops/wfa.py`` (``wfa``, ``wfa_score_only``), the SGD tick of
``layout/sgd.py`` (``sgd_tick``, one a block of ticks) and the union-find of
``ops/unionfind.py`` (``uf_unite``, the hook and the compress in one
cooperative launch; ``uf_compress``, ``uf_find``; ``csrc/unionfind.cu``) count their launches here too, since one build makes
one library of every source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from . import nw
from .nw import H_D1, H_D2, H_I1, H_I2, INF, OP_D, OP_I, OP_M, OP_NONE, QPAD, TPAD
from .nw import _i0_of, tmax_pad_of

LAUNCHES = {"nw_sweep": 0, "nw_sweep_score_only": 0, "nw_walk": 0, "nw_walk_runs": 0,
            "nw_sweep_segment": 0, "nw_sweep_segment_score_only": 0, "nw_walk_segment": 0,
            "nw_sweep_segment_group": 0, "nw_walk_segment_group": 0,
            "wfa": 0, "wfa_score_only": 0, "nw_sweep_int16": 0, "nw_sweep_snapshot": 0,
            "nw_walk_start": 0, "nw_rows_sweep": 0, "nw_rows_walk": 0, "nw_sweep_tiled": 0,
            "nw_walk_runs_tiled": 0, "nw_sweep_sharded": 0, "fold_combine": 0, "sgd_tick": 0,
            "uf_unite": 0, "uf_compress": 0, "uf_find": 0, "nw_sweep_wide": 0, "nw_sweep_wide_segment": 0}

_SOURCES = ("nw_sweep.cu", "nw_sweep_seg.cu", "nw_sweep_snap.cu", "nw_sweep_tiled.cu", "nw_sweep_i16.cu",
            "nw_walk.cu", "wfa.cu", "nw_rows.cu", "nw_sweep_shard.cu", "fold_combine.cu", "sgd_tick.cu",
            "unionfind.cu", "nw_sweep_wide.cu", "nw_sweep_wide_plain.cu", "nw_sweep_wide_i16.cu",
            "nw_sweep_wide_seg.cu")
_HEADERS = ("nw_sweep.cuh", "nw_cluster.cuh", "nw_sweep_wide.cuh")
# anti-diagonals per segment of the long-pair route (the JAX package's default)
LONG_SEG = 2048
# the long route's traceback budget (RunnerConfig.memory_budget_bytes' default)
LONG_BUDGET = int(2.6e9)
# segments a forward launch sweeps while the recompute of the ones before
# it overlaps it on a second stream
LONG_RUN = 8
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# lanes per thread the register route is built for, and the launch bound
# (threads per block) of each instantiation, as __launch_bounds__ in
# csrc/nw_sweep.cu states it (a larger block fails to launch)
_MAX_THREADS = {4: 128, 8: 384, 12: 256, 16: 256}
SWEEP_LANES = tuple(_MAX_THREADS)
# the same for the packed int16 sweep (csrc/nw_sweep_i16.cu::I16Bounds):
# lanes a thread -> (most threads, blocks an SM its launch bound promises)
_I16_BOUNDS = {4: (128, 3), 8: (384, 1), 16: (256, 1)}
I16_LANES = tuple(_I16_BOUNDS)
# a twin's lane-step of the packed sweep against one pair's of the int32
# body, in issue time (on the card at [576, W 512]: PERF.md)
I16_TWIN_CELL_COST = 1.25
# widest band the register route covers; wider bands take the wide route
REG_MAX_W = max(s * t for s, t in _MAX_THREADS.items())
_SWEEP_ROWS = 11  # DP rows per pair on the tiled mode's wide route
# dynamic shared memory a block may opt into on H100 (sm_90)
_SMEM_OPTIN_BYTES = 232448
_MAX_PAIR_BARRIERS = 2  # named barriers 1 and 2, one per multi-warp pair
_REG_PENALTY_LIMIT = 1 << 16  # the register route takes penalties in [0, 2^16)
# per-step work of a thread (edge exchange, stores, window slide) in lanes
STEP_OVERHEAD_LANES = 1
_SMSPS_PER_SM = 4
_H100_SMS = 132

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()
# the long route's recompute stream of each calling stream
_long_streams: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- build -------------------------------------------------------------------


def _build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "seqrush_tpu_torch"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build() -> tuple[Path, str]:
    """Compile the kernels' library if it is not built yet.

    Returns (library path, compiler log).  The log is empty when the
    library was already there."""
    csrc = Path(__file__).resolve().parent / "csrc"
    sources = [csrc / s for s in _SOURCES]
    digest = hashlib.sha256()
    for src in sources + [csrc / h for h in _HEADERS]:
        digest.update(src.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    out_dir = _build_dir()
    lib_path = out_dir / f"libnw_kernels-{tag}.so"
    if lib_path.exists():
        return lib_path, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    uniq = f"{os.getpid()}-{threading.get_ident()}"
    objs = [out_dir / f"{src.stem}-{tag}-{uniq}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    log = []
    failed = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out_dir / f"libnw_kernels-{tag}-{uniq}.so"
    link = subprocess.run(
        [nvcc, *_NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path, "\n".join(log)


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _log = build()
            lib = ctypes.CDLL(str(path))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.nw_sweep_launch.argtypes = [ptr] * 10 + [i32] * 16 + [ptr]
            lib.nw_sweep_launch.restype = i32
            lib.nw_sweep_occupancy.argtypes = [i32] * 7 + [ptr] * 3
            lib.nw_sweep_occupancy.restype = i32
            lib.nw_sweep_wide_launch.argtypes = [ptr] * 11 + [i32] * 23 + [ptr]
            lib.nw_sweep_wide_launch.restype = i32
            lib.nw_sweep_wide_seg_launch.argtypes = [ptr] * 9 + [i32] * 29 + [ptr]
            lib.nw_sweep_wide_seg_launch.restype = i32
            lib.nw_sweep_wide_floor_launch.argtypes = [ptr] * 2 + [i32] * 11 + [ptr]
            lib.nw_sweep_wide_floor_launch.restype = i32
            lib.nw_sweep_wide_query.argtypes = [i32] * 9 + [ptr] * 4
            lib.nw_sweep_wide_query.restype = i32
            lib.nw_sweep_i16_launch.argtypes = [ptr] * 6 + [i32] * 15 + [ptr]
            lib.nw_sweep_i16_launch.restype = i32
            lib.nw_sweep_i16_occupancy.argtypes = [i32] * 6 + [ptr] * 4
            lib.nw_sweep_i16_occupancy.restype = i32
            lib.nw_sweep_segment_launch.argtypes = [ptr] * 9 + [i32] * 19 + [ptr]
            lib.nw_sweep_segment_launch.restype = i32
            lib.nw_walk_launch.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
            lib.nw_walk_launch.restype = i32
            lib.nw_walk_runs_launch.argtypes = [ptr] * 5 + [i32] * 6 + [ptr, ptr]
            lib.nw_walk_runs_launch.restype = i32
            lib.nw_walk_segment_launch.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
            lib.nw_walk_segment_launch.restype = i32
            lib.nw_rows_sweep_launch.argtypes = [ptr] * 6 + [i32] * 16 + [ptr]
            lib.nw_rows_sweep_launch.restype = i32
            lib.nw_rows_occupancy.argtypes = [i32] * 6 + [ptr] * 2
            lib.nw_rows_occupancy.restype = i32
            lib.nw_rows_walk_launch.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
            lib.nw_rows_walk_launch.restype = i32
            lib.nw_rows_walk_occupancy.argtypes = [i32] + [ptr] * 3
            lib.nw_rows_walk_occupancy.restype = i32
            lib.nw_walk_occupancy.argtypes = [ptr] * 3
            lib.nw_walk_occupancy.restype = i32
            lib.nw_walk_timer_slots.argtypes = []
            lib.nw_walk_timer_slots.restype = i32
            lib.nw_sweep_tiled_launch.argtypes = [ptr] * 8 + [i32] * 19 + [ptr, ptr]
            lib.nw_sweep_tiled_launch.restype = i32
            lib.nw_sweep_tiled_occupancy.argtypes = [i32] * 5 + [ptr] * 3
            lib.nw_sweep_tiled_occupancy.restype = i32
            lib.nw_walk_runs_tiled_launch.argtypes = [ptr] * 6 + [i32] * 8 + [ptr, ptr]
            lib.nw_walk_runs_tiled_launch.restype = i32
            lib.wfa_launch.argtypes = [ptr] * 11 + [i32] * 15 + [ptr]
            lib.wfa_launch.restype = i32
            lib.wfa_occupancy.argtypes = [i32] * 5 + [ptr] * 3
            lib.wfa_occupancy.restype = i32
            lib.nw_sweep_shard_launch.argtypes = [ptr] * 7 + [i32] * 24 + [ptr]
            lib.nw_sweep_shard_launch.restype = i32
            lib.nw_sweep_shard_capacity.argtypes = [i32] * 6 + [ptr]
            lib.nw_sweep_shard_capacity.restype = i32
            lib.nw_sweep_shard_peer.argtypes = [i32] * 2
            lib.nw_sweep_shard_peer.restype = i32
            lib.fold_combine_launch.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
            lib.fold_combine_launch.restype = i32
            lib.sgd_ticks_occupancy.argtypes = [i32, ptr, ptr]
            lib.sgd_ticks_occupancy.restype = i32
            lib.sgd_ticks_launch.argtypes = [ptr, i32, i32, ptr]
            lib.sgd_ticks_launch.restype = i32
            i64 = ctypes.c_longlong
            lib.uf_unite_launch.argtypes = [ptr] * 3 + [i64, i32, i32, ptr]
            lib.uf_unite_launch.restype = i32
            lib.uf_unite_occupancy.argtypes = [ptr, ptr]
            lib.uf_unite_occupancy.restype = i32
            lib.uf_compress_launch.argtypes = [ptr, i32, ptr]
            lib.uf_compress_launch.restype = i32
            lib.uf_find_launch.argtypes = [ptr] * 3 + [i64, i32, ptr]
            lib.uf_find_launch.restype = i32
            _lib = lib
        return _lib


# -- argument checks -----------------------------------------------------------


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, ndim: int, device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.dtype != dtype or x.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-D {dtype} tensor, got {x.dim()}-D {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_lengths(qlens, tlens, B: int, device) -> None:
    _check("qlens", qlens, torch.int32, 1, device)
    _check("tlens", tlens, torch.int32, 1, device)
    if qlens.shape[0] != B or tlens.shape[0] != B:
        raise ValueError(f"qlens/tlens must have {B} entries")


def _require_cuda(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}: tensors must be on cuda or cpu")


# -- launch planning (pure Python) ---------------------------------------------


@dataclass(frozen=True)
class SweepPlan:
    """How kernel A's register route covers a dispatch.  Pair b runs in block
    b // pairs_per_block as warps [p * warps_per_pair, (p + 1) * warps_per_pair)
    with p = b % pairs_per_block; its thread r owns lanes [r * lanes,
    r * lanes + lanes) (lanes >= W are ghosts).  The wide route's plan is a
    WidePlan."""

    route: str  # "regs" ("twins": the packed int16 sweep)
    lanes: int  # lanes per thread
    warps_per_pair: int
    pairs_per_block: int
    threads: int  # per block
    pair_bytes: int  # shared memory of one pair
    smem_bytes: int  # dynamic shared memory per block
    blocks: int
    groups: int = 1  # grid rows (segment mode: the segments of a group)


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def pair_smem_bytes(Lq: int, Lt: int, W: int, lanes: int, wpp: int, seg: int | None = None) -> int:
    """Shared memory of one pair on the register route: the padded query, the
    padded reversed target and the warp-edge slots (csrc/nw_sweep.cuh).  In
    segment mode (seg anti-diagonals) only the segment's windows of the two
    operands, whatever the pair's length."""
    L = lanes * 32 * wpp
    if seg is not None:
        return _round16(seg // 2 + 1 + L) + _round16(seg + L) + 2 * wpp * 6 * 4
    return _round16(Lq + 1 + L) + _round16(Lt + W + L) + 2 * wpp * 6 * 4


def register_route_penalties(mismatch: int, o1: int, e1: int, o2: int, e2: int,
                             int16: bool = False) -> bool:
    """Whether the register route's arithmetic holds for these penalties:
    every penalty it uses in [0, 2^16), so every DP value stays in
    [0, INF + 2^17] (csrc/nw_sweep.cuh); in the int16 mode every value it
    adds to a state at most 32,767 - INF16, so no add wraps and every value
    stays in [0, 32,767].  Others take the wide route."""
    used = (mismatch, o1, e1) + ((o2, e2) if o2 >= 0 else ())
    if not all(0 <= int(v) < _REG_PENALTY_LIMIT for v in used):
        return False
    adds = (mismatch, o1 + e1, e1) + ((o2 + e2, e2) if o2 >= 0 else ())
    return not int16 or max(adds) <= 32767 - nw.INF16


# the wide route (csrc/nw_sweep_wide.cuh): lanes a thread it is built for,
# threads a CTA at most (kWideMaxThreads) and CTAs a cluster at most
# (non-portable above 8)
WIDE_LANES = (1, 2, 4)
WIDE_MAX_THREADS = 384
WIDE_MAX_CLUSTER = 16
# clusters of each size, one CTA an SM, resident at once on the H100
# (cudaOccupancyMaxActiveClusters through wide_query, NVIDIA H100 80GB
# HBM3): a cluster sits in one GPC, so 16-CTA clusters fit 7 times.  The
# pure planner's hint of the card's shape only: a launch is sliced by the
# count wide_query measures (wide_slices)
WIDE_RESIDENT = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}


# the wide route's cell arithmetic (csrc/nw_sweep_wide.cuh's AR)
WIDE_PLAIN, WIDE_KEYED, WIDE_KEYED16 = 0, 1, 2


def wide_arith(mismatch: int, o1: int, e1: int, o2: int, e2: int, int16: bool = False) -> int:
    """The wide route's cell arithmetic for these penalties (pure): the
    int16 mode's signed keys; unsigned keys value * 8 + tag where every
    penalty is in [0, 2^16) (register_route_penalties in int32); plain
    compares for other int32 penalties."""
    if int16:
        return WIDE_KEYED16
    return WIDE_KEYED if register_route_penalties(mismatch, o1, e1, o2, e2) else WIDE_PLAIN


@dataclass(frozen=True)
class WidePlan:
    """How kernel A's wide route covers a dispatch: each pair (and grid row)
    on `ctas` CTAs, CTA c owning units [c * U // ctas, (c + 1) * U // ctas)
    of the pair's U = ceil(W / lanes) units of `lanes` lanes (thread r the
    r-th unit; threads past the CTA's units are ghosts, lanes >= W ghost
    lanes), in clusters of `cluster` CTAs, `clusters` of them a pair (a
    chain joined through global memory where > 1).  qring and tring are the
    bytes of the staged-base rings; smem_bytes a CTA's dynamic shared
    memory, padded to hold an SM alone where the launch's CTAs fit the card
    at once or the pair is a chain."""

    lanes: int
    ctas: int
    cluster: int
    clusters: int
    threads: int
    qring: int
    tring: int
    smem_bytes: int
    blocks: int  # B * ctas, a grid row's CTAs
    groups: int = 1  # grid rows (segment mode: the segments of a group)
    route: str = "wide"

    @property
    def warps_per_pair(self) -> int:
        return self.ctas * self.threads // 32

    @property
    def solo(self) -> bool:
        """One CTA a pair at a lane a thread: the solo kernels, whose step
        has no neighbour CTA or cluster to test for (csrc/nw_sweep_wide.cuh)."""
        return self.ctas == 1 and self.lanes == 1


def wide_plan(B: int, W: int, groups: int = 1, lanes: int | None = None, ctas: int | None = None,
              cluster: int | None = None) -> WidePlan:
    """The wide route's plan for B pairs (and `groups` grid rows) at W lanes
    (pure): the fewest lanes a thread (1, 2, 4; or `lanes`) whose CTAs of at
    most WIDE_MAX_THREADS threads, a power of two of them a pair, are
    clusters that the card holds all at once with a CTA an SM
    (WIDE_RESIDENT); more lanes a thread cost a warp more than more warps do
    (PERF.md §6).  Where even 4 lanes a thread do not fit, the fewest
    CTAs that do, a power of two up to WIDE_MAX_CLUSTER, or a chain of
    clusters of 16 for a band wider than 16 CTAs hold.  `ctas` and
    `cluster` force the CTAs a pair and a cluster (a chain where cluster <
    ctas), to hold every shape the kernel takes to its plain version."""
    if B < 0 or W < 1 or groups < 1:
        raise ValueError(f"bad dispatch B={B}, W={W}, groups={groups}")
    if lanes is not None and lanes not in WIDE_LANES:
        raise ValueError(f"the wide route takes {WIDE_LANES} lanes a thread, got {lanes}")
    if ctas is not None:
        S = lanes or 4
        U = -(-W // S)
        cluster = cluster or min(ctas, WIDE_MAX_CLUSTER)
        if not (1 <= cluster <= WIDE_MAX_CLUSTER and ctas % cluster == 0 and ctas <= U
                and -(-U // ctas) <= WIDE_MAX_THREADS):
            raise ValueError(f"{ctas} CTAs in clusters of {cluster} cannot cover {U} units of {S} lanes")
        return _wide_plan_at(B, groups, S, U, ctas, cluster)
    pairs = max(B, 1) * groups
    cap = next((c for c in sorted(WIDE_RESIDENT, reverse=True) if pairs <= WIDE_RESIDENT[c]), 1)
    for S in (lanes,) if lanes is not None else WIDE_LANES:
        U = -(-W // S)
        need = -(-U // WIDE_MAX_THREADS)
        ctas = _pow2_at_least(need) if need <= WIDE_MAX_CLUSTER else WIDE_MAX_CLUSTER * -(-need // WIDE_MAX_CLUSTER)
        if ctas <= cap:
            break
    return _wide_plan_at(B, groups, S, U, ctas, min(ctas, WIDE_MAX_CLUSTER))


def _wide_plan_at(B: int, groups: int, S: int, U: int, ctas: int, cluster: int) -> WidePlan:
    threads = -(-(-(-U // ctas)) // 32) * 32  # the most units a CTA owns, in warps
    span = threads * S
    qring = _pow2_at_least(span + SHARD_TILE + 2)
    tring = _pow2_at_least(span + 2 * SHARD_TILE + 1)
    need_bytes = 96 + 48 * (threads // 32) + qring + tring  # mbarriers, CTA slots, warp slots, rings
    spread = max(B, 1) * groups * ctas <= _H100_SMS or ctas > cluster
    return WidePlan(lanes=S, ctas=ctas, cluster=cluster, clusters=ctas // cluster, threads=threads, qring=qring,
                    tring=tring, smem_bytes=max(need_bytes, SHARD_SPREAD_SMEM) if spread else need_bytes,
                    blocks=B * ctas, groups=groups)


def _regs_plan(B: int, W: int, Lq: int, Lt: int, lanes: int, wpp: int, seg: int | None,
               groups: int = 1) -> SweepPlan:
    pair_bytes = pair_smem_bytes(Lq, Lt, W, lanes, wpp, seg)
    ppb = max(1, _SMSPS_PER_SM // wpp)
    ppb = min(ppb, _MAX_THREADS[lanes] // (32 * wpp), _SMEM_OPTIN_BYTES // pair_bytes, max(B, 1))
    if wpp > 1:
        ppb = min(ppb, _MAX_PAIR_BARRIERS)
    return SweepPlan("regs", lanes, wpp, ppb, 32 * wpp * ppb, pair_bytes, pair_bytes * ppb,
                     -(-B // ppb), groups)


def _sweep_cost(plan: SweepPlan) -> int:
    """Relative time of a register-route launch: the warps on the busiest SM
    sub-partition, each costing its lanes per thread plus a per-step
    overhead worth STEP_OVERHEAD_LANES lanes.  It counts the work a
    sub-partition is given, whether its warps are resident at once or run
    in waves.  On the card its pick was the fastest strip at 10 of 12 bands
    of the runner's ladder and within 6.5% at the other two (PERF.md)."""
    warps_per_sm = (-(-plan.blocks * plan.groups // _H100_SMS) * plan.pairs_per_block
                    * plan.warps_per_pair)
    return -(-warps_per_sm // _SMSPS_PER_SM) * (plan.lanes + STEP_OVERHEAD_LANES)


def plan_sweep(B: int, W: int, Lq: int, Lt: int, *, warps_per_pair: int | None = None,
               seg: int | None = None, groups: int = 1) -> SweepPlan | WidePlan:
    """Route, lanes per thread, warps per pair, pairs per block and shared
    memory of one sweep launch (of segments of seg anti-diagonals when seg
    is given: its shared memory does not depend on Lq and Lt; `groups` grid
    rows of them, a group's segments, whose blocks the cost counts).

    By default the cheapest strip by _sweep_cost, each strip at as many
    warps as W needs (ties keep more lanes per thread); `warps_per_pair`
    forces another count, with the fewest lanes that cover W (its last warp
    must hold a real lane).  Blocks hold four warps where they can, one per
    SM sub-partition.  Bands wider than REG_MAX_W, or pairs whose sequences
    do not fit in shared memory, take the wide route."""
    if B < 0 or W < 1:
        raise ValueError(f"bad dispatch B={B}, W={W}")
    if W > REG_MAX_W:
        return wide_plan(B, W, groups)
    if warps_per_pair is not None:
        wpp = int(warps_per_pair)
        lanes = next((s for s in SWEEP_LANES
                      if s * 32 * wpp >= W and 32 * wpp <= _MAX_THREADS[s]), None)
        if wpp < 1 or lanes is None or lanes * 32 * (wpp - 1) >= W:
            raise ValueError(f"{warps_per_pair} warps per pair cannot cover W={W}")
        if pair_smem_bytes(Lq, Lt, W, lanes, wpp, seg) > _SMEM_OPTIN_BYTES:
            return wide_plan(B, W, groups)
        return _regs_plan(B, W, Lq, Lt, lanes, wpp, seg, groups)
    best = None
    for s in sorted(SWEEP_LANES, reverse=True):
        wpp = -(-W // (32 * s))
        if 32 * wpp > _MAX_THREADS[s] or pair_smem_bytes(Lq, Lt, W, s, wpp, seg) > _SMEM_OPTIN_BYTES:
            continue
        plan = _regs_plan(B, W, Lq, Lt, s, wpp, seg, groups)
        cost = _sweep_cost(plan)
        if best is None or cost < best[0]:
            best = (cost, plan)
    return best[1] if best is not None else wide_plan(B, W, groups)


def snap_rounds(B: int, resident_pairs: int, sms: int = _H100_SMS) -> int:
    """Rounds of pairs the busiest SM runs: B pairs spread over sms SMs, each
    holding resident_pairs at once (the snapshot mode's reckoning of its
    last wave)."""
    return -(-(-(-B // sms)) // max(resident_pairs, 1))


def twin_smem_bytes(Lq: int, Lt: int, W: int, lanes: int, wpp: int) -> int:
    """Shared memory of one twin of the packed int16 sweep: the two pairs'
    padded queries and padded reversed targets interleaved, a 16-bit word a
    position, and the warp-edge slots (csrc/nw_sweep_i16.cu)."""
    L = lanes * 32 * wpp
    return _round16(2 * (Lq + 1 + L)) + _round16(2 * (Lt + W + L)) + 2 * wpp * 6 * 4


def _twins_plan(B: int, W: int, Lq: int, Lt: int, lanes: int, wpp: int) -> SweepPlan:
    twin_bytes = twin_smem_bytes(Lq, Lt, W, lanes, wpp)
    n_twins = -(-B // 2)
    ppb = max(1, _SMSPS_PER_SM // wpp)
    ppb = min(ppb, _I16_BOUNDS[lanes][0] // (32 * wpp), _SMEM_OPTIN_BYTES // twin_bytes, max(n_twins, 1))
    if wpp > 1:
        ppb = min(ppb, _MAX_PAIR_BARRIERS)
    return SweepPlan("twins", lanes, wpp, ppb, 32 * wpp * ppb, twin_bytes, twin_bytes * ppb,
                     -(-n_twins // ppb))


def plan_sweep_i16(B: int, W: int, Lq: int, Lt: int, *, warps_per_twin: int | None = None) -> SweepPlan | WidePlan:
    """Kernel A's int16 mode on the register route (its penalties must be
    register_route_penalties(..., int16=True)'s): the packed sweep's plan.
    Twin i is pairs 2i and 2i + 1; block x holds twins [x * pairs_per_block,
    ...), warps_per_pair warps each (route "twins"; pair_bytes is a twin's
    shared memory).  By default the fewest lanes a thread (4, 8, 16) whose
    warps cover W, at as many warps as W needs: 4 lanes were the fastest
    strip wherever they cover W, 8 where they do not (PERF.md).  That
    plan where its _sweep_cost, times I16_TWIN_CELL_COST, is below the int32
    body's plan's (plan_sweep), and that plan (route "regs", the int32
    body's int16 mode) where it is not: a dispatch of few pairs leaves the
    twins' SMs a warp or two, whose chains no other warp hides.
    `warps_per_twin` forces the packed sweep at that count, with the fewest
    lanes that cover W.  Bands wider than REG_MAX_W take the wide route,
    twins whose sequences do not fit in shared memory plan_sweep's plan."""
    if B < 0 or W < 1:
        raise ValueError(f"bad dispatch B={B}, W={W}")
    if W > REG_MAX_W:
        return wide_plan(B, W)
    if warps_per_twin is not None:
        wpp = int(warps_per_twin)
        lanes = next((s for s in I16_LANES if s * 32 * wpp >= W and 32 * wpp <= _I16_BOUNDS[s][0]), None)
        if wpp < 1 or lanes is None or lanes * 32 * (wpp - 1) >= W:
            raise ValueError(f"{warps_per_twin} warps per twin cannot cover W={W}")
        if twin_smem_bytes(Lq, Lt, W, lanes, wpp) > _SMEM_OPTIN_BYTES:
            return wide_plan(B, W)
        return _twins_plan(B, W, Lq, Lt, lanes, wpp)
    twins = None
    for s in I16_LANES:
        wpp = -(-W // (32 * s))
        if 32 * wpp <= _I16_BOUNDS[s][0]:
            if twin_smem_bytes(Lq, Lt, W, s, wpp) <= _SMEM_OPTIN_BYTES:
                twins = _twins_plan(B, W, Lq, Lt, s, wpp)
            break
    body = plan_sweep(B, W, Lq, Lt)
    if twins is None or (body.route == "regs" and _sweep_cost(twins) * I16_TWIN_CELL_COST >= _sweep_cost(body)):
        return body
    return twins


def twins_resident_blocks(plan: SweepPlan) -> int:
    """Blocks of a "twins" plan resident on an SM, reckoned from the launch
    bound's promise of registers (rounded down to 8 a thread), the threads
    and the shared memory (each block reserving 1 KB)."""
    most, blocks = _I16_BOUNDS[plan.lanes]
    regs = min(_SM_REGS // (blocks * most) // 8 * 8, 255)
    return max(0, min(_SM_REGS // (regs * plan.threads), _SM_THREADS // plan.threads, 32,
                      _SM_SMEM // (plan.smem_bytes + 1024)))


def twins_reckoning(plan: SweepPlan, B: int, resident_blocks: int | None = None) -> dict:
    """Twins, warps an SM and waves of a "twins" plan on the H100's SMs:
    warps_per_sm counts the blocks each SM is given (all waves), waves the
    rounds of resident blocks (resident_blocks an SM, reckoned by
    twins_resident_blocks unless given, e.g. from sweep_occupancy)."""
    resident = twins_resident_blocks(plan) if resident_blocks is None else resident_blocks
    per_sm = -(-plan.blocks // _H100_SMS)
    return {"twins": -(-B // 2), "warps_per_sm": per_sm * plan.pairs_per_block * plan.warps_per_pair,
            "resident_blocks_per_sm": resident, "waves": -(-plan.blocks // (_H100_SMS * max(resident, 1)))}


WALK_PAIRS_PER_BLOCK = 2  # one warp per pair (csrc/nw_walk.cu)
WALK_ROWS = 64  # anti-diagonals a tile of the walk's ring in shared memory
WALK_DEPTH = 2  # tiles loading below the one walked


def gap_lane_shift(td: int, K: int, k: int, delete: bool) -> int:
    """The lane moved by k gap steps from anti-diagonal td (the twin of
    csrc/nw_walk.cu's gap_lane_shift): the lane is i - i0(t), and a D step
    keeps i while an I step lowers it by one, so i0(td) - i0(td - k), less k
    in an I gap."""
    return _i0_of(td, K) - _i0_of(td - k, K) - (0 if delete else k)


def walk_path_lane(lane: int, td: int, m: int, t: int, K: int) -> int:
    """The lane the walk's tiles expect at anti-diagonal t <= td on the path
    from the cursor at (lane, td) in state m (csrc/nw_walk.cu's WalkPath): 0
    the diagonal, which loses a lane a step at or below K; else the gap state
    m (odd D, even I), the gap taken to go on."""
    if m == 0:
        above = (td - K + 1) >> 1 if td > K else 0
        return lane - max((td - t) // 2 - above, 0)
    return lane + gap_lane_shift(td, K, td - t, bool(m & 1))


def walk_row_window(lane: int, addr: int, lo_lane: int, hi_lane: int) -> tuple[int, int, int]:
    """The lanes a tile row of the walk holds (the twin of csrc/nw_walk.cu's
    walk_row_window) for the path's lane `lane`, its byte at address addr,
    in a row of lanes [lo_lane, hi_lane) laid out contiguously: the 32-byte
    sector that holds the lane.  Returns (c0, s, e): lane c0 + k at the tile
    row's byte k, for k in [s, e)."""
    c0 = lane - (addr & 31)
    return c0, max(0, lo_lane - c0), min(32, hi_lane - c0)


# -- kernel A: the sweep -------------------------------------------------------


def nw_align(Q, T, qlens, tlens, *, mismatch, o1, e1, o2, e2, band, tmax, with_traceback=True,
             int16=False, t_snap=None):
    """Banded Gotoh sweep over a batch of pairs.

    Q [B, Lq] / T [B, Lt] uint8 base codes padded with QPAD/TPAD; qlens,
    tlens [B] int32; o2 < 0 selects one-piece penalties.  Returns (scores
    [B] int32, -1 where the final cell was not reached; tb [B, tmax_pad, W]
    uint8 with rows 0 and > tmax zero, or None when with_traceback is
    False).

    int16: the saturating int16 DP of nw._sweep_v3(dtype=int16) (see
    _sweep_reference); a score at or above nw.INT16_CUTOFF is unreliable.
    t_snap [B] int32 (the fold's snapshot mode, with a traceback): also
    returns (SNAP [6, B, W], DIAGA [B, W], DIAGB [B, W]) int32, the carry
    (H(t), H(t - 1), I1, D1, I2, D2) at t == t_snap[b] and the clamped
    diagonal candidate at t_snap and t_snap + 1 (INF, or INF16, where a
    capture falls past tmax); the traceback is then promised only in each
    row's rows 0 .. t_snap + 1 (snapshot_rows), which is all the fold reads,
    and the card's register route sweeps no further than they and the score
    need."""
    device = Q.device
    _check("Q", Q, torch.uint8, 2, device)
    _check("T", T, torch.uint8, 2, device)
    B = Q.shape[0]
    if T.shape[0] != B:
        raise ValueError("Q and T must have the same batch size")
    _check_lengths(qlens, tlens, B, device)
    if band < 0 or tmax < 0:
        raise ValueError("band and tmax must be >= 0")
    if t_snap is not None:
        _check("t_snap", t_snap, torch.int32, 1, device)
        if t_snap.shape[0] != B or not with_traceback:
            raise ValueError("t_snap needs [B] entries and a traceback")
    kw = dict(mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2, band=band, tmax=tmax,
              with_traceback=with_traceback, int16=int16, t_snap=t_snap)
    if device.type == "cpu":
        return nw_align_reference(Q, T, qlens, tlens, **kw)
    _require_cuda(device)
    plan = align_plan(B, band + 1, Q.shape[1], T.shape[1], mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2,
                      int16=int16, snapshot=t_snap is not None)
    return sweep_launch(Q, T, qlens, tlens, plan, **kw)


def align_plan(B: int, W: int, Lq: int, Lt: int, *, mismatch, o1, e1, o2, e2, int16=False,
               snapshot=False) -> SweepPlan | WidePlan:
    """The plan nw_align launches on the card (pure): the wide route for
    penalties the register route does not take, else the packed int16
    sweep's planner in the int16 mode without snapshots, else plan_sweep's
    (which takes the wide route above REG_MAX_W and where the sequences do
    not fit the register route's shared memory)."""
    if not register_route_penalties(mismatch, o1, e1, o2, e2, int16):
        return wide_plan(B, W)
    if int16 and not snapshot:
        return plan_sweep_i16(B, W, Lq, Lt)
    return plan_sweep(B, W, Lq, Lt)


def sweep_launch(Q, T, qlens, tlens, plan: SweepPlan | WidePlan, *, mismatch, o1, e1, o2, e2, band, tmax,
                 with_traceback=True, int16=False, t_snap=None):
    """Launch kernel A on checked CUDA tensors with a given plan (nw_align's
    plan, or another one to compare launch shapes)."""
    if plan.route != "wide" and not register_route_penalties(mismatch, o1, e1, o2, e2, int16):
        raise ValueError("the register route takes penalties in [0, 2^16) only "
                         "(in int16, those whose adds cannot wrap)")
    if plan.route == "twins" and (not int16 or t_snap is not None):
        raise ValueError("the packed sweep (route 'twins') runs the int16 mode without snapshots only")
    device = Q.device
    B, Lq = Q.shape
    W = band + 1
    tmax_pad = tmax_pad_of(tmax)
    neg = nw.INF16 if int16 else INF
    if plan.route == "wide":
        scores = torch.full((B,), -1, dtype=torch.int32, device=device)
    else:
        scores = torch.empty(B, dtype=torch.int32, device=device)
    tb = torch.empty((B, tmax_pad, W), dtype=torch.uint8, device=device) if with_traceback else None
    snaps = None
    if t_snap is not None:
        snaps = (torch.full((6, B, W), neg, dtype=torch.int32, device=device),
                 torch.full((B, W), neg, dtype=torch.int32, device=device),
                 torch.full((B, W), neg, dtype=torch.int32, device=device))
    if B == 0:
        return (scores, tb) if snaps is None else (scores, tb, snaps)
    lib = _library()
    if plan.route == "wide":
        ar = wide_arith(mismatch, o1, e1, o2, e2, int16)
        recs, slices = _wide_launches(device, plan, B, o2 >= 0, with_traceback, ar, False)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for b0, nb, _y0, _ny in slices:
                err = lib.nw_sweep_wide_launch(
                    Q.data_ptr(), T.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), scores.data_ptr(),
                    tb.data_ptr() if tb is not None else None, recs.data_ptr() if recs is not None else None,
                    t_snap.data_ptr() if snaps else None, snaps[0].data_ptr() if snaps else None,
                    snaps[1].data_ptr() if snaps else None, snaps[2].data_ptr() if snaps else None,
                    B, Lq, T.shape[1], W, tmax, tmax_pad, mismatch, o1, e1, o2, e2, ar, plan.lanes,
                    plan.ctas, plan.cluster, plan.clusters, plan.threads, plan.smem_bytes, plan.qring, plan.tring,
                    b0, nb, int(plan.solo), stream)
                if err != 0:
                    raise RuntimeError(f"nw_sweep_wide launch failed with CUDA error {err}")
                LAUNCHES["nw_sweep_wide"] += 1
        return (scores, tb) if snaps is None else (scores, tb, snaps)
    if plan.route == "twins":
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.nw_sweep_i16_launch(
                Q.data_ptr(), T.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), scores.data_ptr(),
                tb.data_ptr() if tb is not None else None, B, Lq, T.shape[1], W, tmax, tmax_pad,
                mismatch, o1, e1, o2, e2, plan.lanes, plan.warps_per_pair, plan.pairs_per_block,
                plan.pair_bytes, stream)
        if err != 0:
            raise RuntimeError(f"nw_sweep_i16 launch failed with CUDA error {err}")
        LAUNCHES["nw_sweep_int16" if with_traceback else "nw_sweep_score_only"] += 1
        return scores, tb
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nw_sweep_launch(
            Q.data_ptr(), T.data_ptr(), qlens.data_ptr(), tlens.data_ptr(),
            scores.data_ptr(), tb.data_ptr() if tb is not None else None,
            t_snap.data_ptr() if snaps else None, snaps[0].data_ptr() if snaps else None,
            snaps[1].data_ptr() if snaps else None, snaps[2].data_ptr() if snaps else None,
            B, Lq, T.shape[1], W, tmax, tmax_pad, mismatch, o1, e1, o2, e2, int(int16),
            plan.lanes, plan.warps_per_pair, plan.pairs_per_block, plan.pair_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"nw_sweep launch failed with CUDA error {err}")
    key = ("nw_sweep_score_only" if not with_traceback else "nw_sweep_snapshot" if snaps
           else "nw_sweep_int16" if int16 else "nw_sweep")
    LAUNCHES[key] += 1
    return (scores, tb) if snaps is None else (scores, tb, snaps)


# the wide route's kernel facts already read from the card, by (device,
# kernel, cluster, threads, shared memory)
_wide_queries: dict = {}


def wide_query(device, plan: WidePlan, two_piece: bool, with_traceback: bool = True, ar: int = WIDE_KEYED,
               segment: bool = False) -> dict:
    """The wide route's kernel at `plan` with the cell arithmetic `ar`
    (wide_arith) on `device` (needs the card): its registers and local
    (spilled) bytes a thread, its CTAs resident an SM, and the clusters of
    plan.cluster CTAs resident on the card at once
    (cudaOccupancyMaxActiveClusters)."""
    device = torch.device(device)
    key = (device, segment, plan.lanes, two_piece, with_traceback, ar, plan.solo, plan.cluster, plan.threads,
           plan.smem_bytes)
    if key not in _wide_queries:
        regs, local, ctas, clusters = (ctypes.c_int() for _ in range(4))
        with torch.cuda.device(device):
            err = _library().nw_sweep_wide_query(int(segment), plan.lanes, int(two_piece), int(with_traceback),
                                                 int(ar), int(plan.solo), plan.cluster, plan.threads,
                                                 plan.smem_bytes,
                                                 ctypes.byref(regs), ctypes.byref(local), ctypes.byref(ctas),
                                                 ctypes.byref(clusters))
        if err != 0:
            raise RuntimeError(f"nw_sweep_wide query failed with CUDA error {err}")
        _wide_queries[key] = {"regs_per_thread": regs.value, "local_bytes_per_thread": local.value,
                              "resident_ctas_per_sm": ctas.value, "resident_clusters": clusters.value}
    return dict(_wide_queries[key])


def wide_slices(plan: WidePlan, B: int, held: int) -> list[tuple[int, int, int, int]]:
    """The launches of a wide-route dispatch of B pairs x plan.groups grid
    rows (pure): (b0, nb, y0, ny), pairs [b0, b0 + nb) of rows [y0, y0 + ny),
    each (pair, row) in one launch.  Pairs on one cluster each take one
    launch (clusters the card cannot hold yet wait for a free SM).  A
    chain's clusters spin on each other, so each launch holds at most
    `held` clusters, the card's resident clusters at the plan (wide_query):
    whole rows of B pairs where they fit, else runs of a row's pairs.
    Raises RuntimeError where one pair's chain alone exceeds `held`."""
    G = plan.groups
    if B <= 0:
        return []
    if plan.clusters == 1 or B * G * plan.clusters <= held:
        return [(0, B, 0, G)]
    per = held // plan.clusters  # pairs (of one row) a launch holds
    if per < 1:
        raise RuntimeError(f"a pair's chain of {plan.clusters} clusters of {plan.cluster} CTAs is not resident "
                           f"at once: the card holds {held}")
    if per >= B:
        rows = per // B
        return [(0, B, y, min(rows, G - y)) for y in range(0, G, rows)]
    return [(b, min(per, B - b), y, 1) for y in range(G) for b in range(0, B, per)]


def _wide_launches(device, plan: WidePlan, B: int, two_piece: bool, with_traceback: bool, ar: int,
                   segment: bool):
    """The ring records of a chain of clusters ([groups, B, clusters, 2, 8]
    int32, zeroed; None where a pair is one cluster) and the launches
    (wide_slices) at the card's resident clusters for the plan, measured by
    wide_query."""
    if plan.clusters == 1:
        return None, wide_slices(plan, B, 0)
    held = wide_query(device, plan, two_piece, with_traceback, ar, segment)["resident_clusters"]
    slices = wide_slices(plan, B, held)
    return (torch.zeros((plan.groups, B, plan.clusters, 2, SHARD_REC_INTS), dtype=torch.int32, device=device),
            slices)


def wide_floor(plan: WidePlan, W: int, steps: int, device) -> torch.Tensor:
    """The chain floor's probe (needs the card; csrc/nw_sweep_wide.cuh::
    wide_floor_body): one pair's `steps` anti-diagonals at W lanes on
    plan's lanes, CTAs a pair, cluster and threads, with the step's column
    exchange and barrier alone (two-piece columns; no cell, bases or
    stores; a solo plan's on the solo kernels' step).  Its time over `steps` is the step latency the cluster's
    machinery allows at the plan, the floor of the wide route's chain.  A
    measurement, not a kernel of the main path: LAUNCHES does not count it.
    Returns the probe's output word (its value means nothing)."""
    one = wide_plan(1, W, lanes=plan.lanes, ctas=plan.ctas, cluster=plan.cluster)
    device = torch.device(device)
    _require_cuda(device)
    out = torch.zeros(1, dtype=torch.int32, device=device)
    recs = (torch.zeros((1, 1, one.clusters, 2, SHARD_REC_INTS), dtype=torch.int32, device=device)
            if one.clusters > 1 else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().nw_sweep_wide_floor_launch(
            recs.data_ptr() if recs is not None else None, out.data_ptr(), W, steps, one.lanes, one.ctas,
            one.cluster, one.clusters, one.threads, one.smem_bytes, one.qring, one.tring, int(one.solo), stream)
    if err != 0:
        raise RuntimeError(f"nw_sweep_wide floor probe failed with CUDA error {err}")
    return out


def sweep_occupancy(plan: SweepPlan | WidePlan, W: int, two_piece: bool, with_traceback: bool = True, *,
                    snapshot: bool = False) -> dict:
    """Registers per thread, shared memory per block and resident pairs per
    SM of a plan's launch shape in the full or the score-only mode, or with
    snapshot the snapshot mode's own kernel on the register route, from the
    CUDA runtime and the launch code (needs the card); on the wide route
    wide_query's figures."""
    regs, blocks, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if plan.route == "wide":
        return {**wide_query(torch.device("cuda", torch.cuda.current_device()), plan, two_piece, with_traceback),
                "smem_per_block": plan.smem_bytes, "warps_per_pair": plan.warps_per_pair}
    if snapshot and plan.route != "regs":
        raise ValueError("the snapshot mode's own kernel is the register route's")
    if plan.route == "twins":
        spill = ctypes.c_int()
        err = _library().nw_sweep_i16_occupancy(plan.lanes, int(two_piece), int(with_traceback),
                                                plan.pairs_per_block, plan.pair_bytes, plan.threads,
                                                ctypes.byref(regs), ctypes.byref(spill), ctypes.byref(blocks),
                                                ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"nw_sweep_i16 occupancy query failed with CUDA error {err}")
        return {"regs_per_thread": regs.value, "local_bytes_per_thread": spill.value,
                "smem_per_block": smem.value, "resident_blocks_per_sm": blocks.value,
                "resident_twins_per_sm": blocks.value * plan.pairs_per_block,
                "resident_pairs_per_sm": 2 * blocks.value * plan.pairs_per_block,
                "warps_per_pair": plan.warps_per_pair}
    err = _library().nw_sweep_occupancy(plan.lanes, int(two_piece), int(with_traceback), int(snapshot),
                                        plan.pairs_per_block, plan.pair_bytes, plan.threads,
                                        ctypes.byref(regs), ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"nw_sweep occupancy query failed with CUDA error {err}")
    return {"regs_per_thread": regs.value, "smem_per_block": smem.value,
            "resident_pairs_per_sm": blocks.value * plan.pairs_per_block,
            "warps_per_pair": plan.warps_per_pair}


def walk_occupancy() -> dict:
    """Registers per thread, shared memory per block and resident pairs per
    SM of the walk's launch shape (needs the card)."""
    regs, blocks, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _library().nw_walk_occupancy(ctypes.byref(regs), ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"nw_walk occupancy query failed with CUDA error {err}")
    return {"regs_per_thread": regs.value, "smem_per_block": smem.value,
            "resident_pairs_per_sm": blocks.value * WALK_PAIRS_PER_BLOCK, "warps_per_pair": 1}


# the phases of the walk's own timer (csrc/nw_walk.cu, WalkTimer), in its order
WALK_PHASES = ("switch", "miss", "ballot", "gap", "tokens", "refetch")


def walk_split(v: list[int], slots: int) -> dict:
    """The split of a timed walk launch from its timer's values v
    (csrc/nw_walk.cu's WalkTimer: `slots` values, then each row's cycles):
    per walked pair the mean SM cycles and the mean number of each phase of
    WALK_PHASES the timer has (a switch onto a tile loaded ahead; a load
    around a cursor the tiles in flight missed; diagonal ballots; gap
    ballots and the other single steps; token writes; refetches of the
    tiles in flight), the rest ("other"), the mean and the longest pair's
    cycles, the pairs walked, the nanoseconds a cycle (the pairs'
    %globaltimer time over their cycles), and each row's cycles (0 where no
    pair starts or nothing was walked)."""
    n = (slots - 4) // 2
    names = WALK_PHASES[:n]
    pairs = max(v[2 * n + 3], 1)
    cycles = {k: v[i] / pairs for i, k in enumerate(names)}
    total = v[2 * n] / pairs
    return {"cycles": {**cycles, "other": total - sum(cycles.values())},
            "counts": {k: v[n + i] / pairs for i, k in enumerate(names)},
            "pair_cycles": total, "longest_pair_cycles": v[2 * n + 2], "pairs": v[2 * n + 3],
            "ns_per_cycle": v[2 * n + 1] / max(v[2 * n], 1), "row_cycles": v[slots:]}


def walk_runs_split(tb, qlens, tlens, *, band, tmax, run_max, run_len_max=None, tiled=None):
    """One launch of kernel B's runs mode (with tiled=(tile, wide, n_tiles),
    its tiled runs mode, band the tile rows') on the card with the walk's
    own timer, for a timing tool; the pipeline never launches it.  Returns
    (tokens, counts, walk_split of the timer)."""
    _require_cuda(tb.device)
    run_len_max = nw._RUN_LEN_MAX if run_len_max is None else int(run_len_max)
    slots = _library().nw_walk_timer_slots()
    phase = torch.zeros(slots + tb.shape[0], dtype=torch.int64, device=tb.device)
    if tiled is None:
        tokens, counts = _walk_runs_launch(tb, qlens, tlens, band + 1, tmax, run_max, run_len_max, phase)
    else:
        tile, wide, n_tiles = tiled
        tokens, counts = _walk_runs_tiled_launch(tb, qlens, tlens, tile, wide, band, n_tiles, tmax, run_max,
                                                 run_len_max, phase)
    return tokens, counts, walk_split(phase.cpu().tolist(), slots)


def _frame(x: torch.Tensor, delta: int, inf_col: torch.Tensor) -> torch.Tensor:
    """Lane l reads lane l + delta (delta in {-1, 0, 1}); INF off the band."""
    if delta == -1:
        return torch.cat([inf_col, x[:, :-1]], dim=1)
    if delta == 0:
        return x
    return torch.cat([x[:, 1:], inf_col], dim=1)


def initial_carry(B: int, W: int, device, neg: int = INF) -> torch.Tensor:
    """The DP rows before anti-diagonal 1 as a carry [6, B, W] int32: H at
    t = 0 (0 at lane 0), H at t = -1 and the gap states at t = 0, all neg
    (INF, or INF16 in the int16 mode)."""
    carry = torch.full((6, B, W), neg, dtype=torch.int32, device=device)
    carry[0, :, 0] = 0
    return carry


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """x as the int16 add of the JAX package's int16 sweep gives it: the low
    16 bits, sign-extended."""
    return ((x + 32768) & 0xFFFF) - 32768


def _sweep_reference(Q, T, qlens, tlens, rows, scores, t_lo, t_hi, tb, tb_row0, *,
                     mismatch, o1, e1, o2, e2, band, int16=False, snap=None):
    """Anti-diagonals t_lo..t_hi of the recurrence, one [B, W] step each, the
    arithmetic of nw_pallas._kernel and nw._nw_segment.  rows = (H at
    t_lo - 1, H at t_lo - 2, I1, D1, I2, D2 at t_lo - 1); a pair's score is
    taken at its final cell where it has none yet (-1); row t goes to
    tb[:, t - tb_row0] when tb is given.  Returns (rows at t_hi, scores).

    int16: the arithmetic of nw._sweep_v3(dtype=int16): every add wraps to
    16 bits, every state and the diagonal candidate saturate at INF16
    (INF16 off the matrix), and a score is taken wherever the final lane
    lies in the band.  snap = (t_snap [B], SNAP [6, B, W], DIAGA, DIAGB
    [B, W] int32): the carry at t == t_snap[b] and the clamped diagonal
    candidate h_diag + sub at t_snap and t_snap + 1 are stored into them
    (nw._sweep_v3(t_snap=...)'s captures)."""
    B, Lq = Q.shape
    Lt = T.shape[1]
    K = band
    W = K + 1
    dev = Q.device
    two = o2 >= 0
    i32 = torch.int32
    neg = nw.INF16 if int16 else INF

    def add(a, b):
        return _wrap16(a + b) if int16 else a + b

    Qi = F.pad(Q.to(i32), (1, W), value=QPAD)  # [B, Lq + 1 + W]
    Trev = F.pad(T.flip(1).to(i32), (W, W), value=TPAD)  # [B, Lt + 2W]
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    ql = qlens.to(i32)[:, None]
    tl = tlens.to(i32)[:, None]
    t_final = (qlens + tlens).to(i32)
    h1, h2, i1r, d1r, i2r, d2r = rows
    inf_row = torch.full((B, W), neg, dtype=i32, device=dev)
    false_row = torch.zeros((B, W), dtype=torch.bool, device=dev)
    inf_col = torch.full((B, 1), neg, dtype=i32, device=dev)
    # the anti-diagonals where some pair's final cell lies
    finals = set(t_final.tolist())
    if snap is not None:
        t_snap, SNAP, DIAGA, DIAGB = snap
        snap_ts = set(t_snap.tolist()) | set((t_snap + 1).tolist())
    mis = int(np.int16(mismatch)) if int16 else mismatch

    for t in range(t_lo, t_hi + 1):
        i0 = _i0_of(t, K)
        dp = i0 - _i0_of(t - 1, K)
        dpp = i0 - _i0_of(t - 2, K)
        h_up = _frame(h1, dp - 1, inf_col)
        h_left = _frame(h1, dp, inf_col)
        h_diag = _frame(h2, dpp - 1, inf_col)
        i1_up = _frame(i1r, dp - 1, inf_col)
        d1_left = _frame(d1r, dp, inf_col)

        qs = min(i0, Lq + 1)
        ts = min(max(Lt - t + i0 + W, 0), Lt + W)
        sub = (Qi[:, qs : qs + W] != Trev[:, ts : ts + W]).to(i32) * mis

        # a gap state is min(open, extend); its opened bit is open <= extend
        up_open, left_open = add(h_up, o1 + e1), add(h_left, o1 + e1)
        ext = add(i1_up, e1)
        I1n, i1_opened = torch.minimum(up_open, ext), up_open <= ext
        ext = add(d1_left, e1)
        D1n, d1_opened = torch.minimum(left_open, ext), left_open <= ext
        if two:
            up_open, left_open = add(h_up, o2 + e2), add(h_left, o2 + e2)
            ext = add(_frame(i2r, dp - 1, inf_col), e2)
            I2n, i2_opened = torch.minimum(up_open, ext), up_open <= ext
            ext = add(_frame(d2r, dp, inf_col), e2)
            D2n, d2_opened = torch.minimum(left_open, ext), left_open <= ext
        else:
            I2n, D2n = inf_row, inf_row
            i2_opened, d2_opened = false_row, false_row

        # strict '<' in the order D1, I1, D2, I2: a tie keeps the earlier choice
        Hdiag = add(h_diag, sub)
        Hn = Hdiag
        choice = torch.zeros((B, W), dtype=torch.uint8, device=dev)
        for cand, tag in ((D1n, H_D1), (I1n, H_I1), (D2n, H_D2), (I2n, H_I2)):
            choice.masked_fill_(cand < Hn, tag)
            Hn = torch.minimum(Hn, cand)

        i = i0 + lanes
        j = t - i
        invalid = ~((i >= 0) & (i <= ql) & (j >= 0) & (j <= tl))
        Hn = Hn.clamp(max=neg).masked_fill_(invalid, neg)
        I1n = I1n.clamp(max=neg).masked_fill_(invalid, neg)
        D1n = D1n.clamp(max=neg).masked_fill_(invalid, neg)
        if two:
            I2n = I2n.clamp(max=neg).masked_fill_(invalid, neg)
            D2n = D2n.clamp(max=neg).masked_fill_(invalid, neg)

        if t in finals:
            at_final = (t_final[:, None] == t) & (lanes == (ql - i0))
            fin_val = torch.where(at_final, Hn, INF).amin(dim=1)
            scores = torch.where((t_final == t) & (scores < 0) & (fin_val < INF), fin_val, scores)

        if snap is not None and t in snap_ts:
            hd = Hdiag.clamp(max=neg).masked_fill_(invalid, neg)
            hit = (t_snap == t)[:, None]
            for k, x in enumerate((Hn, h1, I1n, D1n, I2n, D2n)):
                SNAP[k] = torch.where(hit, x, SNAP[k])
            DIAGA.copy_(torch.where(hit, hd, DIAGA))
            DIAGB.copy_(torch.where((t_snap + 1 == t)[:, None], hd, DIAGB))

        if tb is not None:
            tb[:, t - tb_row0, :] = (
                choice
                | (i1_opened.to(torch.uint8) << 3)
                | (i2_opened.to(torch.uint8) << 4)
                | (d1_opened.to(torch.uint8) << 5)
                | (d2_opened.to(torch.uint8) << 6)
            )
        h2, h1 = h1, Hn
        i1r, d1r = I1n, D1n
        if two:
            i2r, d2r = I2n, D2n
    if not two and t_hi >= t_lo:
        i2r, d2r = inf_row, inf_row  # one-piece: the second gap states are INF rows
    return (h1, h2, i1r, d1r, i2r, d2r), scores


def nw_align_reference(Q, T, qlens, tlens, *, mismatch, o1, e1, o2, e2, band, tmax,
                       with_traceback=True, int16=False, t_snap=None):
    """Plain PyTorch version of kernel A: one [B, W] step per anti-diagonal,
    the same arithmetic as nw_pallas._kernel (the traceback None when
    with_traceback is False).  int16 and t_snap: nw_align's modes."""
    B = Q.shape[0]
    W = band + 1
    dev = Q.device
    neg = nw.INF16 if int16 else INF
    scores = torch.full((B,), -1, dtype=torch.int32, device=dev)
    if int16:
        # the int16 sweep reads its scores from a row that starts at the origin
        scores = torch.where(qlens + tlens == 0, 0, scores).to(torch.int32)
    tb = torch.zeros((B, tmax_pad_of(tmax), W), dtype=torch.uint8, device=dev) if with_traceback else None
    # without a traceback nothing past the last pair's final anti-diagonal is needed
    t_last = tmax if with_traceback else min(tmax, int((qlens + tlens).max()) if B else 0)
    carry = initial_carry(B, W, dev, neg)
    snap = None
    if t_snap is not None:
        t_snap = t_snap.to(torch.int32)
        SNAP = torch.where((t_snap == 0)[None, :, None], carry, neg)
        snap = (t_snap, SNAP, torch.full((B, W), neg, dtype=torch.int32, device=dev),
                torch.full((B, W), neg, dtype=torch.int32, device=dev))
        t_last = tmax
    _rows, scores = _sweep_reference(
        Q, T, qlens, tlens, tuple(carry), scores, 1, t_last, tb, 0,
        mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2, band=band, int16=int16, snap=snap)
    if snap is not None:
        return scores, tb, snap[1:]
    return scores, tb


# -- kernel A, segment mode ------------------------------------------------------


def snapshot_rows(t_snap: torch.Tensor, tmax: int, tmax_pad: int) -> torch.Tensor:
    """The traceback rows [B, tmax_pad] bool that kernel A's snapshot mode
    promises equal to nw_align_reference's: each row's rows 0 ..
    min(t_snap + 1, tmax), those the fold's start walk reads (it walks back
    from the crossing at t_snap or t_snap + 1).  On the register route the
    kernel leaves the rows past them unwritten, or runs them only as far as
    a score within tmax needs."""
    last = torch.clamp(t_snap.to(torch.int64) + 1, max=tmax)
    return torch.arange(tmax_pad, device=t_snap.device)[None, :] <= last[:, None]


def _check_segment(Q, T, qlens, tlens, carry, scores, band, t0, seg):
    device = Q.device
    _check("Q", Q, torch.uint8, 2, device)
    _check("T", T, torch.uint8, 2, device)
    B = Q.shape[0]
    if T.shape[0] != B:
        raise ValueError("Q and T must have the same batch size")
    _check_lengths(qlens, tlens, B, device)
    _check("carry", carry, torch.int32, 3, device)
    if scores is not None:  # None: a group's, which start at -1
        _check("scores", scores, torch.int32, 1, device)
    if band < 0 or t0 < 0 or seg < 1:
        raise ValueError("band and t0 must be >= 0 and seg >= 1")
    if tuple(carry.shape) != (6, B, band + 1) or (scores is not None and scores.shape[0] != B):
        raise ValueError(f"carry must be [6, {B}, {band + 1}] and scores [{B}], got "
                         f"{tuple(carry.shape)} and {None if scores is None else tuple(scores.shape)}")


def nw_align_segment(Q, T, qlens, tlens, carry, scores, *, t0, seg, mismatch, o1, e1, o2, e2,
                     band, with_traceback=True, out=None):
    """Kernel A over one segment, anti-diagonals [t0 + 1, t0 + seg].

    carry [6, B, W] int32 holds the DP rows before it (H at t0 and t0 - 1,
    I1, D1, I2, D2 at t0; ``initial_carry`` for t0 = 0); scores [B] int32
    the scores so far (-1 where a pair has not ended).  Returns (the carry
    after the segment, in ``out`` when given (not carry itself); the scores
    with those of the pairs that end in it; tb [B, seg, W] uint8 of rows
    t0 + 1 .. t0 + seg, every row computed, or None when with_traceback is
    False)."""
    _check_segment(Q, T, qlens, tlens, carry, scores, band, t0, seg)
    device = Q.device
    if out is not None:
        _check("out", out, torch.int32, 3, device)
        if out.shape != carry.shape or out.data_ptr() == carry.data_ptr():
            raise ValueError("out must be a carry of the same shape, not carry itself")
    pen = dict(mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2, band=band)
    if device.type == "cpu":
        carry_out, scores_out, tb = nw_align_segment_reference(
            Q, T, qlens, tlens, carry, scores, t0=t0, seg=seg, with_traceback=with_traceback, **pen)
        if out is not None:
            carry_out = out.copy_(carry_out)
        return carry_out, scores_out, tb
    _require_cuda(device)
    B, W = Q.shape[0], band + 1
    plan = plan_sweep(B, W, Q.shape[1], T.shape[1], seg=seg)
    if not register_route_penalties(mismatch, o1, e1, o2, e2):
        plan = wide_plan(B, W)
    return segment_launch(Q, T, qlens, tlens, carry, scores, plan, t0=t0, seg=seg,
                          with_traceback=with_traceback, out=out, **pen)


def segment_launch(Q, T, qlens, tlens, carry, scores, plan: SweepPlan | WidePlan, *, t0, seg, mismatch, o1,
                   e1, o2, e2, band, with_traceback=True, out=None):
    """Launch kernel A's segment mode on checked CUDA tensors with a given
    plan (plan_sweep(..., seg=seg), or another one to compare shapes)."""
    B = Q.shape[0]
    carry_out = out if out is not None else torch.empty_like(carry)
    scores_out = torch.empty_like(scores)
    tb = (torch.empty((B, seg, band + 1), dtype=torch.uint8, device=Q.device)
          if with_traceback else None)
    n = _seg_launch(Q, T, qlens, tlens, carry, carry_out, scores, scores_out, tb, 0, plan, t_lo=t0 + 1,
                    seg=seg, n_run=1, n_out=1, mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2,
                    band=band)
    LAUNCHES["nw_sweep_wide_segment" if plan.route == "wide" else
             "nw_sweep_segment" if with_traceback else "nw_sweep_segment_score_only"] += n
    return carry_out, scores_out, tb


def _seg_launch(Q, T, qlens, tlens, ckpt_in, ckpt_out, scores_in, scores, tb, row0, plan: SweepPlan | WidePlan,
                *, t_lo, seg, n_run, n_out, mismatch, o1, e1, o2, e2, band):
    """One launch of kernel A's segment mode (csrc/nw_sweep_seg.cu's
    nw_sweep_segment_launch, or on the wide route csrc/nw_sweep_wide_seg.cu's
    nw_sweep_wide_seg_launch): plan.groups grid rows, each a run of n_run
    segments from t_lo + y * n_run * seg on; ckpt_in and ckpt_out are
    carries [6, B, W] (views into a checkpoint tensor, the carries after
    them following), tb [B, rows, W] or None, written from row row0 on;
    scores from scores_in, or as the caller filled them where it is None.
    Returns the launches made (a chain's dispatch on the wide route is
    sliced: wide_slices); raises if a launch fails."""
    if plan.route == "regs" and not register_route_penalties(mismatch, o1, e1, o2, e2):
        raise ValueError("the register route takes penalties in [0, 2^16) only")
    B, Lq = Q.shape
    W = band + 1
    if B == 0:
        return 0
    lib = _library()
    if plan.route == "wide":
        # the wide route reads the scores before the run from its output
        if scores_in is not None:
            scores.copy_(scores_in)
        ar = wide_arith(mismatch, o1, e1, o2, e2)
        recs, slices = _wide_launches(Q.device, plan, B, o2 >= 0, tb is not None, ar, True)
        with torch.cuda.device(Q.device):
            stream = torch.cuda.current_stream(Q.device).cuda_stream
            for b0, nb, y0, ny in slices:
                err = lib.nw_sweep_wide_seg_launch(
                    Q.data_ptr(), T.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), ckpt_in.data_ptr(),
                    ckpt_out.data_ptr() if ckpt_out is not None else None, scores.data_ptr(),
                    tb.data_ptr() + row0 * W if tb is not None else None,
                    recs.data_ptr() if recs is not None else None, B, Lq, T.shape[1], W, t_lo, seg, n_run, n_out,
                    plan.groups, tb.shape[1] if tb is not None else 0, mismatch, o1, e1, o2, e2, ar, plan.lanes,
                    plan.ctas, plan.cluster, plan.clusters, plan.threads, plan.smem_bytes, plan.qring, plan.tring,
                    b0, nb, y0, ny, int(plan.solo), stream)
                if err != 0:
                    raise RuntimeError(f"nw_sweep_wide segment launch failed with CUDA error {err}")
        return len(slices)
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream(Q.device).cuda_stream
        err = lib.nw_sweep_segment_launch(
            Q.data_ptr(), T.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), ckpt_in.data_ptr(),
            ckpt_out.data_ptr() if ckpt_out is not None else None,
            scores_in.data_ptr() if scores_in is not None else None, scores.data_ptr(),
            tb.data_ptr() + row0 * W if tb is not None else None,
            B, Lq, T.shape[1], W, t_lo, seg, n_run, n_out, plan.groups,
            tb.shape[1] if tb is not None else 0, mismatch, o1, e1, o2, e2,
            plan.lanes, plan.warps_per_pair, plan.pairs_per_block, plan.pair_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"nw_sweep segment launch failed with CUDA error {err}")
    return 1


def nw_align_segment_reference(Q, T, qlens, tlens, carry, scores, *, t0, seg, mismatch, o1, e1,
                               o2, e2, band, with_traceback=True):
    """Plain PyTorch version of kernel A's segment mode: the arithmetic of
    nw._nw_segment, whose framing and clamps are nw_align_reference's.
    Every row of tb is computed, rows past a pair's end and past the chunk's
    last anti-diagonal included."""
    B = Q.shape[0]
    W = band + 1
    tb = torch.zeros((B, seg, W), dtype=torch.uint8, device=Q.device) if with_traceback else None
    rows, scores = _sweep_reference(
        Q, T, qlens, tlens, tuple(carry.unbind(0)), scores, t0 + 1, t0 + seg, tb, t0 + 1,
        mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2, band=band)
    return torch.stack(rows), scores, tb


def _check_ckpt(Q, ckpt, s0: int, n: int, band: int) -> None:
    _check("ckpt", ckpt, torch.int32, 4, Q.device)
    if tuple(ckpt.shape[1:]) != (6, Q.shape[0], band + 1) or s0 < 0 or n < 1 or s0 + n > ckpt.shape[0]:
        raise ValueError(f"ckpt {tuple(ckpt.shape)} does not hold segments {s0}..{s0 + n - 1} "
                         f"of [6, {Q.shape[0]}, {band + 1}] carries")


def _segment_plan(B, W, Lq, Lt, seg, groups, pen):
    plan = plan_sweep(B, W, Lq, Lt, seg=seg, groups=groups)
    if not register_route_penalties(**pen):
        plan = wide_plan(B, W, groups)
    return plan


def nw_align_segment_run(Q, T, qlens, tlens, ckpt, scores, *, s0, n_run, seg, mismatch, o1, e1, o2,
                         e2, band):
    """Kernel A, score-only, over segments s0 .. s0 + n_run - 1 in one launch
    (the long route's forward pass): from the carry ckpt[s0] (ckpt [n_seg,
    6, B, W] int32), storing the carry after segment s into ckpt[s + 1] for
    every s + 1 < n_seg as the sweep passes it.  scores [B] int32 are the
    scores before the run; returns the scores after it."""
    _check_ckpt(Q, ckpt, s0, n_run, band)
    _check_segment(Q, T, qlens, tlens, ckpt[s0], scores, band, s0 * seg, seg)
    pen = dict(mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2)
    n_out = min(n_run, ckpt.shape[0] - 1 - s0)
    if Q.device.type == "cpu":
        return nw_align_segment_run_reference(Q, T, qlens, tlens, ckpt, scores, s0=s0, n_run=n_run,
                                              seg=seg, band=band, **pen)
    _require_cuda(Q.device)
    B, W = Q.shape[0], band + 1
    plan = _segment_plan(B, W, Q.shape[1], T.shape[1], seg, 1, pen)
    out = torch.empty_like(scores)
    n = _seg_launch(Q, T, qlens, tlens, ckpt[s0], ckpt[s0 + 1] if n_out else None, scores, out, None,
                    0, plan, t_lo=s0 * seg + 1, seg=seg, n_run=n_run, n_out=n_out, band=band, **pen)
    LAUNCHES["nw_sweep_wide_segment" if plan.route == "wide" else "nw_sweep_segment_score_only"] += n
    return out


def nw_align_segment_run_reference(Q, T, qlens, tlens, ckpt, scores, *, s0, n_run, seg, mismatch,
                                   o1, e1, o2, e2, band):
    """Plain PyTorch version of a forward run: nw_align_segment_reference,
    score-only, segment after segment, each carry stored into ckpt."""
    carry = ckpt[s0]
    for s in range(s0, s0 + n_run):
        carry, scores, _ = nw_align_segment_reference(
            Q, T, qlens, tlens, carry, scores, t0=s * seg, seg=seg, mismatch=mismatch, o1=o1,
            e1=e1, o2=o2, e2=e2, band=band, with_traceback=False)
        if s + 1 < ckpt.shape[0]:
            ckpt[s + 1] = carry
    return scores


def nw_align_segment_group(Q, T, qlens, tlens, ckpt, *, s0, G, seg, mismatch, o1, e1, o2, e2, band,
                           tb=None, row0=0):
    """Kernel A over a group of G segments s0 .. s0 + G - 1 in one launch,
    each from its checkpoint ckpt[s] ([n_seg, 6, B, W] int32, the forward
    pass's): a grid of pair x segment blocks, since each segment's recompute
    depends on its checkpoint alone.  Returns (scores [B] int32, set where
    a pair's final cell lies in the group, -1 elsewhere; the traceback
    [B, G * seg, W] uint8 of rows s0 * seg + 1 .. (s0 + G) * seg, in tb
    from row row0 on when tb [B, rows, W] is given).  Its bytes and scores
    are those of G nw_align_segment launches chained from scores -1."""
    _check_ckpt(Q, ckpt, s0, G, band)
    _check_segment(Q, T, qlens, tlens, ckpt[s0], None, band, s0 * seg, seg)
    B, W = Q.shape[0], band + 1
    if tb is None:
        tb = torch.empty((B, G * seg, W), dtype=torch.uint8, device=Q.device)
        row0 = 0
    else:
        _check("tb", tb, torch.uint8, 3, Q.device)
        if tb.shape[0] != B or tb.shape[2] != W or row0 < 0 or row0 + G * seg > tb.shape[1]:
            raise ValueError(f"tb {tuple(tb.shape)} cannot hold rows {row0}..{row0 + G * seg - 1}")
    pen = dict(mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2)
    if Q.device.type == "cpu":
        scores = nw_align_segment_group_reference(Q, T, qlens, tlens, ckpt, s0=s0, G=G, seg=seg,
                                                  band=band, tb=tb, row0=row0, **pen)
        return scores, tb
    _require_cuda(Q.device)
    plan = _segment_plan(B, W, Q.shape[1], T.shape[1], seg, G, pen)
    scores = torch.full((B,), -1, dtype=torch.int32, device=Q.device)
    n = _seg_launch(Q, T, qlens, tlens, ckpt[s0], None, None, scores, tb, row0, plan, t_lo=s0 * seg + 1,
                    seg=seg, n_run=1, n_out=0, band=band, **pen)
    LAUNCHES["nw_sweep_wide_segment" if plan.route == "wide" else "nw_sweep_segment_group"] += n
    return scores, tb


def nw_align_segment_group_reference(Q, T, qlens, tlens, ckpt, *, s0, G, seg, mismatch, o1, e1, o2,
                                     e2, band, tb, row0=0):
    """Plain PyTorch version of the grouped recompute:
    nw_align_segment_reference over the group's segments, each from its
    checkpoint, the scores chained from -1; the rows into tb from row0 on.
    Returns the scores."""
    scores = torch.full((Q.shape[0],), -1, dtype=torch.int32, device=Q.device)
    for k in range(G):
        s = s0 + k
        _, scores, tb_s = nw_align_segment_reference(
            Q, T, qlens, tlens, ckpt[s], scores, t0=s * seg, seg=seg, mismatch=mismatch, o1=o1,
            e1=e1, o2=o2, e2=e2, band=band)
        tb[:, row0 + k * seg : row0 + (k + 1) * seg] = tb_s
    return scores


# -- kernel B: the walk --------------------------------------------------------


def nw_walk(tb, qlens, tlens, *, band, tmax):
    """Reverse traceback walk: tb [B, tmax_pad, W] uint8 (nw_align's output)
    -> opcodes [B, tmax + 1] uint8 in ascending anti-diagonal order.
    Requires qlens + tlens <= tmax on every row."""
    device = tb.device
    _check("tb", tb, torch.uint8, 3, device)
    B = tb.shape[0]
    _check_lengths(qlens, tlens, B, device)
    W = band + 1
    if tb.shape[2] != W or tb.shape[1] < tmax + 1:
        raise ValueError(f"tb shape {tuple(tb.shape)} does not fit band {band}, tmax {tmax}")
    if device.type == "cpu":
        return nw_walk_reference(tb, qlens, tlens, band=band, tmax=tmax)
    _require_cuda(device)
    ops = torch.zeros((B, tmax + 1), dtype=torch.uint8, device=device)
    if B == 0:
        return ops
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nw_walk_launch(
            tb.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), ops.data_ptr(),
            B, W, tmax, tb.shape[1], stream,
        )
    if err != 0:
        raise RuntimeError(f"nw_walk launch failed with CUDA error {err}")
    LAUNCHES["nw_walk"] += 1
    return ops


def nw_walk_runs(tb, qlens, tlens, *, band, tmax, run_max, run_len_max=None):
    """Kernel B's runs mode: the walk of nw_walk, emitted as run tokens.

    Returns (tokens [B, run_max] int32, op | len << 2 in walk order, which
    is the alignment's reverse, zero past each pair's runs; counts [B] int32,
    every run of the pair, those past run_max too).  A run is at most
    run_len_max steps (nw._RUN_LEN_MAX when None); a longer one splits, the
    first token taking the first run_len_max steps of the walk.  Requires
    tmax + 4 < 2^15, as the JAX package's run tokens do."""
    device = tb.device
    _check("tb", tb, torch.uint8, 3, device)
    B = tb.shape[0]
    _check_lengths(qlens, tlens, B, device)
    W = band + 1
    if tb.shape[2] != W or tb.shape[1] < tmax + 1:
        raise ValueError(f"tb shape {tuple(tb.shape)} does not fit band {band}, tmax {tmax}")
    run_len_max = nw._RUN_LEN_MAX if run_len_max is None else int(run_len_max)
    if not nw.runs_fit(tmax):
        raise ValueError(f"run tokens need tmax + 4 < 2^15, got tmax {tmax}")
    if run_max < 1 or not 1 <= run_len_max <= nw._RUN_LEN_MAX:
        raise ValueError(f"run_max must be >= 1 and run_len_max in [1, {nw._RUN_LEN_MAX}]")
    if device.type == "cpu":
        return nw_walk_runs_reference(tb, qlens, tlens, band=band, tmax=tmax, run_max=run_max,
                                      run_len_max=run_len_max)
    _require_cuda(device)
    return _walk_runs_launch(tb, qlens, tlens, W, tmax, run_max, run_len_max, None)


def _walk_runs_launch(tb, qlens, tlens, W, tmax, run_max, run_len_max, phase):
    """The runs mode's launch; phase: None, or the timer's values
    (nw_walk_timer_slots() + B int64, zero-filled), which take the timed
    kernel."""
    device = tb.device
    B = tb.shape[0]
    tokens = torch.zeros((B, run_max), dtype=torch.int32, device=device)
    counts = torch.zeros(B, dtype=torch.int32, device=device)
    if B == 0:
        return tokens, counts
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nw_walk_runs_launch(
            tb.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), tokens.data_ptr(), counts.data_ptr(),
            B, W, tmax, tb.shape[1], run_max, run_len_max, None if phase is None else phase.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"nw_walk runs launch failed with CUDA error {err}")
    LAUNCHES["nw_walk_runs"] += 1
    return tokens, counts


def nw_walk_runs_reference(tb, qlens, tlens, *, band, tmax, run_max, run_len_max=None):
    """Plain PyTorch version of kernel B's runs mode: nw_walk_reference's
    opcodes, run-length encoded in walk order with runs capped at
    run_len_max steps."""
    run_len_max = nw._RUN_LEN_MAX if run_len_max is None else int(run_len_max)
    ops = nw_walk_reference(tb, qlens, tlens, band=band, tmax=tmax)
    return runs_of_opcodes(ops, run_max, run_len_max)


def runs_of_opcodes(ops: torch.Tensor, run_max: int, run_len_max: int):
    """Run tokens [B, run_max] int32 and run counts [B] int32 of opcode rows
    [B, L] (ascending anti-diagonal order): the nonzero opcodes from the
    last column down, cut where the op changes and every run_len_max steps
    of one op."""
    B, L = ops.shape
    dev = ops.device
    i64 = torch.int64
    tokens = torch.zeros((B, run_max), dtype=torch.int32, device=dev)
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    flat = ops.flip(1).reshape(-1).to(i64)
    keep = flat != 0
    sym = flat[keep]
    if not sym.numel():
        return tokens, counts
    row = torch.arange(B, device=dev).repeat_interleave(L)[keep]
    start = torch.ones_like(sym, dtype=torch.bool)
    start[1:] = (sym[1:] != sym[:-1]) | (row[1:] != row[:-1])
    first = start.nonzero().squeeze(1)
    lens = torch.diff(first, append=torch.tensor([sym.numel()], device=dev))
    n_tok = (lens + run_len_max - 1) // run_len_max
    run_of = torch.arange(first.numel(), device=dev).repeat_interleave(n_tok)
    k = torch.arange(run_of.numel(), device=dev) - (torch.cumsum(n_tok, 0) - n_tok)[run_of]
    last = k == n_tok[run_of] - 1
    tlen = torch.where(last, lens[run_of] - run_len_max * (n_tok[run_of] - 1),
                       torch.full_like(k, run_len_max))
    trow = row[first][run_of]
    tval = sym[first][run_of] | (tlen << 2)
    per_row = torch.bincount(trow, minlength=B)
    pos = torch.arange(trow.numel(), device=dev) - (torch.cumsum(per_row, 0) - per_row)[trow]
    sel = pos < run_max
    tokens[trow[sel], pos[sel]] = tval[sel].to(torch.int32)
    return tokens, per_row.to(torch.int32)


def _i0_tensor(t: torch.Tensor, K: int) -> torch.Tensor:
    return torch.clamp(torch.div(t - K + 1, 2, rounding_mode="floor"), min=0)


def nw_walk_reference(tb, qlens, tlens, *, band, tmax):
    """Plain PyTorch version of kernel B: a reverse scan over every
    anti-diagonal, acting on the pairs whose cursor sits there (the
    arithmetic of nw.traceback_scan_device and nw_pallas._walk_kernel, its
    per-state cases read from small tables indexed by the state the step
    leaves: the H choice in an H cell, else the gap state)."""
    B = tb.shape[0]
    ops = torch.zeros((B, tmax + 1), dtype=torch.uint8, device=tb.device)
    state = walk_state(qlens, tlens, band=band).to(torch.int64)
    # no cursor starts above the longest pair's final anti-diagonal
    top = min(tmax, int(state[0].max()) if B else 0)
    _walk_rows(tb, 0, state, ops, top, 1, band)
    return ops


def _walk_rows(tb, tb_row0, state, ops, td_hi, td_lo, band):
    """Anti-diagonals td_hi down to td_lo of the walk: the cursor state [4, B]
    int64 (cur_t, lane, mat, done) steps where it sits, in place; row td is
    tb[:, td - tb_row0]; ops[:, td] gets each step's opcode."""
    B = tb.shape[0]
    K = band
    W = K + 1
    dev = tb.device
    i64 = torch.int64

    def table(*vals):
        return torch.tensor(vals, dtype=i64, device=dev)

    # by state L = 0 diagonal, 1 D1, 2 I1, 3 D2, 4 I2 (5-7: no such choice):
    # the opcode, the bit of the gap's opened flag, the moves in i and j,
    # and the state the next step is in unless the gap opened here
    op_of = table(OP_M, OP_D, OP_I, OP_D, OP_I, OP_NONE, OP_NONE, OP_NONE)
    opened_bit = table(4, 5, 3, 6, 4, 4, 4, 4)
    di = table(1, 0, 1, 0, 1, 0, 0, 0)
    dj = table(1, 1, 0, 1, 0, 0, 0, 0)
    next_gap = table(0, H_D1, H_I1, H_D2, H_I2, H_I2, H_I2, H_I2)
    rows = torch.arange(B, device=dev)
    cur_t, lane, mat, done = state[0], state[1], state[2], state[3] != 0

    for td in range(td_hi, td_lo - 1, -1):
        active = ~done & (cur_t == td)
        in_band = (lane >= 0) & (lane < W)
        byte = tb[rows, td - tb_row0, lane.clamp(0, W - 1)].to(i64)
        b = torch.where(in_band, byte, 0)
        st = torch.where(mat == 0, b & 7, mat)
        opened = ((b >> opened_bit[st]) & 1) != 0
        i = _i0_of(td, K) + lane
        ni = i - di[st]
        nj = (td - i) - dj[st]
        nmat = torch.where((st == 0) | opened, 0, next_gap[st])
        nt = ni + nj
        nl = ni - _i0_tensor(nt, K)
        ndone = (ni == 0) & (nj == 0)

        cur_t = torch.where(active, nt, cur_t)
        lane = torch.where(active, nl, lane)
        mat = torch.where(active, nmat, mat)
        done = done | (active & ndone)
        ops[:, td] = torch.where(active, op_of[st], OP_NONE).to(torch.uint8)
    state[0], state[1], state[2], state[3] = cur_t, lane, mat, done.to(i64)


# -- kernel B, segment mode ------------------------------------------------------


def walk_state(qlens, tlens, *, band) -> torch.Tensor:
    """The walk's starting cursor as a carry [4, B] int32: the anti-diagonal
    qlen + tlen, the lane qlen - i0 of it, the H state, done where the pair
    is empty."""
    cur_t = qlens.to(torch.int32) + tlens.to(torch.int32)
    lane = qlens.to(torch.int32) - _i0_tensor(cur_t, band)
    return torch.stack([cur_t, lane, torch.zeros_like(cur_t), (cur_t == 0).to(torch.int32)])


def nw_walk_segment(tb_seg, state, ops, *, t0, seg, band):
    """Kernel B over one segment: the rows t0 + 1 .. t0 + seg of the
    traceback, tb_seg [B, seg, W] uint8 (nw_align_segment's), from the
    cursor state [4, B] int32 (walk_state's, or the last segment's).  Writes
    the opcodes of the steps taken into columns t0 + 1 .. t0 + seg of ops
    [B, L] uint8 (zero-filled by the caller, L > t0 + seg) and returns the
    cursor where it leaves the segment; a walk that ended stays ended."""
    device = tb_seg.device
    _check("tb_seg", tb_seg, torch.uint8, 3, device)
    B = tb_seg.shape[0]
    _check("state", state, torch.int32, 2, device)
    _check("ops", ops, torch.uint8, 2, device)
    if t0 < 0 or seg < 1 or tuple(tb_seg.shape) != (B, seg, band + 1):
        raise ValueError(f"tb_seg shape {tuple(tb_seg.shape)} does not fit band {band}, seg {seg}")
    if tuple(state.shape) != (4, B) or ops.shape[0] != B or ops.shape[1] <= t0 + seg:
        raise ValueError(f"state must be [4, {B}] and ops [{B}, > {t0 + seg}], got "
                         f"{tuple(state.shape)} and {tuple(ops.shape)}")
    if device.type == "cpu":
        return nw_walk_segment_reference(tb_seg, state, ops, t0=t0, seg=seg, band=band)
    _require_cuda(device)
    out = state.clone()
    if B == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nw_walk_segment_launch(tb_seg.data_ptr(), out.data_ptr(), ops.data_ptr(),
                                         B, band + 1, t0 + 1, t0 + seg, ops.shape[1], seg, stream)
    if err != 0:
        raise RuntimeError(f"nw_walk segment launch failed with CUDA error {err}")
    LAUNCHES["nw_walk_segment"] += 1
    return out


def nw_walk_segment_reference(tb_seg, state, ops, *, t0, seg, band):
    """Plain PyTorch version of kernel B's segment mode: nw_walk_reference's
    scan over the segment's rows, the cursor carried as nw._tb_scan_segment
    carries it."""
    st = state.to(torch.int64)
    live = st[0][st[3] == 0]
    # no cursor acts above the highest live one
    top = min(t0 + seg, int(live.max()) if live.numel() else 0)
    _walk_rows(tb_seg, t0 + 1, st, ops, top, t0 + 1, band)
    return st.to(torch.int32)


def nw_walk_segment_group(tb_grp, state, ops, *, s0, G, seg, band):
    """Kernel B over a group's rows in one launch: rows s0 * seg + 1 ..
    (s0 + G) * seg of the traceback, tb_grp [B, G * seg, W] uint8
    (nw_align_segment_group's), from the cursor state [4, B] int32, the
    cursor carried inside the kernel across the group's segments.  Writes
    the opcodes into those columns of ops [B, L] uint8 (zero-filled, L >
    (s0 + G) * seg) and returns the cursor where it leaves the group: what
    G nw_walk_segment launches from the last segment down give."""
    device = tb_grp.device
    _check("tb_grp", tb_grp, torch.uint8, 3, device)
    B = tb_grp.shape[0]
    _check("state", state, torch.int32, 2, device)
    _check("ops", ops, torch.uint8, 2, device)
    t0, rows = s0 * seg, G * seg
    if s0 < 0 or G < 1 or seg < 1 or tuple(tb_grp.shape) != (B, rows, band + 1):
        raise ValueError(f"tb_grp shape {tuple(tb_grp.shape)} does not fit band {band}, {G} "
                         f"segments of {seg}")
    if tuple(state.shape) != (4, B) or ops.shape[0] != B or ops.shape[1] <= t0 + rows:
        raise ValueError(f"state must be [4, {B}] and ops [{B}, > {t0 + rows}], got "
                         f"{tuple(state.shape)} and {tuple(ops.shape)}")
    if device.type == "cpu":
        return nw_walk_segment_group_reference(tb_grp, state, ops, s0=s0, G=G, seg=seg, band=band)
    _require_cuda(device)
    out = state.clone()
    if B == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nw_walk_segment_launch(tb_grp.data_ptr(), out.data_ptr(), ops.data_ptr(),
                                         B, band + 1, t0 + 1, t0 + rows, ops.shape[1], rows, stream)
    if err != 0:
        raise RuntimeError(f"nw_walk group launch failed with CUDA error {err}")
    LAUNCHES["nw_walk_segment_group"] += 1
    return out


def nw_walk_segment_group_reference(tb_grp, state, ops, *, s0, G, seg, band):
    """Plain PyTorch version of the group walk: nw_walk_segment_reference
    over the group's segments from the last down, the cursor carried."""
    for k in reversed(range(G)):
        state = nw_walk_segment_reference(tb_grp[:, k * seg : (k + 1) * seg], state, ops,
                                          t0=(s0 + k) * seg, seg=seg, band=band)
    return state


# -- the long-pair route -----------------------------------------------------------


def long_group_size(B: int, W: int, seg: int, n_seg: int, budget: int) -> int:
    """G: the most segments whose traceback B * G * seg * W bytes fits the
    budget, at least 1 and at most n_seg."""
    per = B * seg * W
    return max(1, min(n_seg, int(budget) // per if per else n_seg))


def nw_align_long(Q, T, qlens, tlens, *, mismatch, o1, e1, o2, e2, band, seg=LONG_SEG,
                  t_need=None, memory_budget=LONG_BUDGET):
    """Banded alignment of pairs of any length through segments of seg
    anti-diagonals (nw.nw_align_long's contract).

    Returns (scores [B] int32, opcodes [B, n_seg * seg + 1] uint8 in
    ascending anti-diagonal order, as nw_walk's), on the tensors' device with
    no host synchronisation.  n_seg = ceil(t_need / seg), t_need the largest
    qlen + tlen (computed from the lengths when not given, which reads them
    back).  The forward pass sweeps the segments score-only and keeps only
    the DP rows at each segment start, [n_seg, 6, B, W] int32.  The reverse
    pass recomputes the traceback a group of G segments at a time from their
    checkpoints, G = long_group_size(B, W, seg, n_seg, memory_budget), from
    the last group down, and walks each group in one launch.

    * G = n_seg on the card: the forward pass runs LONG_RUN segments a
      launch on the current stream, and after each launch the recompute of
      its segments runs on a second stream (an event orders it), into one
      traceback [B, n_seg * seg, W]; the walk follows there, and the
      current stream waits for it.
    * G < n_seg (and on the CPU): the forward pass in one launch, then the
      groups in turn; G = 1 (a budget below two segments' traceback)
      recomputes and walks one segment a launch."""
    B = Q.shape[0]
    W = band + 1
    device = Q.device
    pen = dict(mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2, band=band)
    if t_need is None:
        t_need = int((qlens + tlens).max()) if B else 0
    n_seg = -(-int(t_need) // seg)
    G = long_group_size(B, W, seg, n_seg, memory_budget)
    ckpt = torch.empty((n_seg, 6, B, W), dtype=torch.int32, device=device)
    scores = torch.full((B,), -1, dtype=torch.int32, device=device)
    ops = torch.zeros((B, n_seg * seg + 1), dtype=torch.uint8, device=device)
    state = walk_state(qlens, tlens, band=band)
    if not n_seg:
        return scores, ops
    ckpt[0] = initial_carry(B, W, device)
    if G == n_seg and device.type == "cuda":
        # the recompute's stream is kept per calling stream, so the
        # allocator's blocks recorded on it come back to the caller's pool
        main = torch.cuda.current_stream(device)
        key = (device, main.cuda_stream)
        if key not in _long_streams:
            _long_streams[key] = torch.cuda.Stream(device)
        side = _long_streams[key]
        side.wait_stream(main)  # the first checkpoint, ops and the cursors
        tb = torch.empty((B, n_seg * seg, W), dtype=torch.uint8, device=device)
        for x in (Q, T, qlens, tlens, ckpt, ops, state, tb):
            x.record_stream(side)
        for s0 in range(0, n_seg, LONG_RUN):
            n_run = min(LONG_RUN, n_seg - s0)
            scores = nw_align_segment_run(Q, T, qlens, tlens, ckpt, scores, s0=s0, n_run=n_run,
                                          seg=seg, **pen)
            done = torch.cuda.Event()
            done.record(main)
            side.wait_event(done)
            with torch.cuda.stream(side):
                nw_align_segment_group(Q, T, qlens, tlens, ckpt, s0=s0, G=n_run, seg=seg, tb=tb,
                                       row0=s0 * seg, **pen)
        with torch.cuda.stream(side):
            state = nw_walk_segment_group(tb, state, ops, s0=0, G=n_seg, seg=seg, band=band)
        main.wait_stream(side)
        return scores, ops
    scores = nw_align_segment_run(Q, T, qlens, tlens, ckpt, scores, s0=0, n_run=n_seg, seg=seg,
                                  **pen)
    for s0 in reversed(range(0, n_seg, G)):
        g = min(G, n_seg - s0)
        _, tb = nw_align_segment_group(Q, T, qlens, tlens, ckpt, s0=s0, G=g, seg=seg, **pen)
        state = nw_walk_segment_group(tb, state, ops, s0=s0, G=g, seg=seg, band=band)
        del tb  # stream-ordered: the next group's traceback may reuse it
    return scores, ops


# -- kernel B, start mode ----------------------------------------------------------


def nw_walk_start(tb, state, *, band, tmax):
    """Kernel B from given cursors: the walk of nw_walk over tb [B, tmax_pad,
    W] (nw_align's), each row starting at state [4, B] int32 (anti-diagonal,
    lane, material 0 H / 1 D1 / 2 I1 / 3 D2 / 4 I2, done) instead of its
    final cell; a row whose anti-diagonal is 0 or above tmax takes no step.
    Returns opcodes [B, tmax + 1] uint8 (the counterpart of
    nw._tb_scan_tbw(start=...), the fold's half-walks).  It runs the segment
    mode's kernel over the traceback's rows 1..tmax as one segment."""
    device = tb.device
    _check("tb", tb, torch.uint8, 3, device)
    B = tb.shape[0]
    _check("state", state, torch.int32, 2, device)
    W = band + 1
    if tb.shape[2] != W or tb.shape[1] < tmax + 1 or tuple(state.shape) != (4, B):
        raise ValueError(f"tb {tuple(tb.shape)} / state {tuple(state.shape)} do not fit band "
                         f"{band}, tmax {tmax}")
    if device.type == "cpu":
        return nw_walk_start_reference(tb, state, band=band, tmax=tmax)
    _require_cuda(device)
    ops = torch.zeros((B, tmax + 1), dtype=torch.uint8, device=device)
    if B == 0 or tmax < 1:
        return ops
    cursor = state.clone()
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # row 1 of pair 0 is the segment's first row; pairs tmax_pad rows apart
        err = lib.nw_walk_segment_launch(tb.data_ptr() + W, cursor.data_ptr(), ops.data_ptr(),
                                         B, W, 1, tmax, tmax + 1, tb.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"nw_walk start launch failed with CUDA error {err}")
    LAUNCHES["nw_walk_start"] += 1
    return ops


def nw_walk_start_reference(tb, state, *, band, tmax):
    """Plain PyTorch version of kernel B's start mode: nw_walk_reference's
    scan from the given cursors (those above tmax never act)."""
    B = tb.shape[0]
    ops = torch.zeros((B, tmax + 1), dtype=torch.uint8, device=tb.device)
    st = state.to(torch.int64).clone()
    st[3] = (st[3] != 0) | (st[0] <= 0)
    live = st[0][(st[3] == 0) & (st[0] <= tmax)]
    top = int(live.max()) if live.numel() else 0
    _walk_rows(tb, 0, st, ops, top, 1, band)
    return ops


# -- the bidirectional fold ----------------------------------------------------------


def fold_combine(SNAP, DIAGA, DIAGB, qlens, tlens, *, o1, o2, band):
    """The fold's join of its half sweeps (nw.nw_align_fold's combine):
    fold_combine_reference's function, on a GPU in one launch of
    csrc/fold_combine.cu (a block a pair).  qlens and tlens are int32 there.
    Returns (scores [B] int32, state [4, 2B] int32, cross_m [B] bool)."""
    device = SNAP.device
    if device.type == "cpu":
        return fold_combine_reference(SNAP, DIAGA, DIAGB, qlens, tlens, o1=o1, o2=o2, band=band)
    _require_cuda(device)
    B, W = qlens.shape[0], band + 1
    _check("SNAP", SNAP, torch.int32, 3, device)
    _check("DIAGA", DIAGA, torch.int32, 2, device)
    _check("DIAGB", DIAGB, torch.int32, 2, device)
    _check_lengths(qlens, tlens, B, device)
    if tuple(SNAP.shape) != (6, 2 * B, W) or tuple(DIAGA.shape) != (2 * B, W) or DIAGB.shape != DIAGA.shape:
        raise ValueError(f"SNAP {tuple(SNAP.shape)} / DIAGA {tuple(DIAGA.shape)} / DIAGB "
                         f"{tuple(DIAGB.shape)} do not fit {B} pairs at band {band}")
    scores = torch.empty(B, dtype=torch.int32, device=device)
    state = torch.empty((4, 2 * B), dtype=torch.int32, device=device)
    cross_m = torch.empty(B, dtype=torch.bool, device=device)
    if B == 0:
        return scores, state, cross_m
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fold_combine_launch(SNAP.data_ptr(), DIAGA.data_ptr(), DIAGB.data_ptr(), qlens.data_ptr(),
                                      tlens.data_ptr(), scores.data_ptr(), state.data_ptr(), cross_m.data_ptr(),
                                      B, W, int(o1), int(o2), stream)
    if err != 0:
        raise RuntimeError(f"fold_combine launch failed with CUDA error {err}")
    LAUNCHES["fold_combine"] += 1
    return scores, state, cross_m


def fold_combine_reference(SNAP, DIAGA, DIAGB, qlens, tlens, *, o1, o2, band):
    """The fold's join of its half sweeps (nw.nw_align_fold's combine, in
    plain PyTorch on the tensors' device): every edge that crosses the seam
    between the forward rows' anti-diagonal tm = ceil(fin / 2) and the
    backward rows' tmb = fin - tm, priced from the snapshots, the best lane
    and term in the JAX package's tie order (the first minimum), and where
    each half-walk starts.

    SNAP [6, 2B, W], DIAGA, DIAGB [2B, W] int32 (nw_align's snapshot mode
    on the forward rows and then the reversed rows); qlens, tlens [B].
    Returns (scores [B] int32, state [4, 2B] int32 for nw_walk_start,
    cross_m [B] bool: an M joins the two halves)."""
    B = qlens.shape[0]
    K = band
    W = K + 1
    dev = SNAP.device
    i32 = torch.int32
    ql = qlens.to(i32)
    fin = ql + tlens.to(i32)
    tm = torch.div(fin + 1, 2, rounding_mode="floor")
    tmb = fin - tm
    Sf = SNAP[:, :B]
    Gb = SNAP[2:, B:]
    DA = DIAGA[B:]
    DB = DIAGB[B:]
    i0_tm, i0_tm1 = _i0_tensor(tm, K), _i0_tensor(tm - 1, K)
    i0_b, i0_b1 = _i0_tensor(tmb, K), _i0_tensor(tmb + 1, K)
    # the backward lane of forward lane l is sh - l
    sh1 = ql - i0_tm - i0_b
    sh2 = ql - i0_tm1 - i0_b1
    lf = torch.arange(W, dtype=i32, device=dev)

    def align_bwd(Y, sh):
        lb = sh[:, None] - lf[None, :]
        in_range = (lb >= 0) & (lb < W)
        idx = lb.clamp(0, W - 1).to(torch.int64)
        out = torch.gather(Y, 2, idx[None].expand(Y.shape[0], -1, -1))
        return torch.where(in_range[None], out, INF)

    A1 = align_bwd(torch.cat([Gb, DA[None]]), sh1)  # I1b, D1b, I2b, D2b, DA
    A2 = align_bwd(DB[None], sh2)[0]
    big = torch.full((B, W), 2 * INF, dtype=i32, device=dev)
    two = o2 >= 0
    tv = torch.stack([
        Sf[1] + A2,
        Sf[0] + A1[4],
        torch.minimum(Sf[0], Sf[3] - o1) + A1[1],
        torch.minimum(Sf[0], Sf[2] - o1) + A1[0],
        torch.minimum(Sf[0], Sf[5] - o2) + A1[3] if two else big,
        torch.minimum(Sf[0], Sf[4] - o2) + A1[2] if two else big,
    ])  # [6, B, W]
    val_best = tv.amin(dim=2)
    lane_best = torch.where(tv == val_best[:, :, None], lf, W).amin(dim=2)
    total = val_best.amin(dim=0)
    terms = torch.arange(6, dtype=i32, device=dev)[:, None]
    term = torch.where(val_best == total[None], terms, 6).amin(dim=0)
    lane = lane_best.gather(0, term[None].to(torch.int64))[0]
    finished = total < INF
    scores = torch.where(fin == 0, 0, torch.where(finished, total, -1)).to(i32)

    def at_lane(X):
        return X.gather(1, lane[:, None].to(torch.int64))[:, 0]

    h_u = at_lane(Sf[0])
    gap_vals = torch.stack([at_lane(Sf[3]) - o1, at_lane(Sf[2]) - o1,
                            at_lane(Sf[5]) - o2, at_lane(Sf[4]) - o2])  # D1, I1, D2, I2
    is_e1 = term >= nw._FOLD_D1
    g_idx = (term - 2).clamp(0, 3)
    g_val = gap_vals.gather(0, g_idx[None].to(torch.int64))[0]
    g_code = g_idx + 1  # walk materials: 1 D1, 2 I1, 3 D2, 4 I2
    e2 = term == nw._FOLD_E2
    fwd_mat = torch.where(is_e1 & (g_val < h_u), g_code, 0)
    fwd_t0 = torch.where(e2, tm - 1, tm)
    i_u = torch.where(e2, i0_tm1, i0_tm) + lane
    ip_u = ql - i_u
    bwd_t0 = torch.where(is_e1, tmb, torch.where(e2, tmb - 1, tmb - 2))
    bwd_l0 = torch.where(is_e1, ip_u - i0_b, (ip_u - 1) - _i0_tensor(bwd_t0.clamp(min=0), K))
    bwd_mat = torch.where(is_e1, g_code, 0)
    cross_m = ~is_e1 & finished & (fin > 0)
    # inert starts for unfinished and empty rows (their ops are not read)
    live = finished & (fin > 0)
    fwd_t0 = torch.where(live, fwd_t0, 0)
    bwd_t0 = torch.where(live, bwd_t0.clamp(min=0), 0)
    cur_t0 = torch.cat([fwd_t0, bwd_t0])
    state = torch.stack([cur_t0.to(i32), torch.cat([lane, bwd_l0]).clamp(0, W - 1).to(i32),
                         torch.cat([fwd_mat, bwd_mat]).to(i32), (cur_t0 <= 0).to(i32)])
    return scores, state.contiguous(), cross_m


def nw_align_fold(Qf, Tf, Qr, Tr, qlens, tlens, *, mismatch, o1, e1, o2, e2, band, tmax_half,
                  int16=False):
    """Bidirectional fold (nw.nw_align_fold's contract): each pair runs as a
    forward row (q, t) and a backward row (the same sequences reversed, not
    complemented) of one sweep of tmax_half anti-diagonals in its snapshot
    mode, the halves join in fold_combine, and the walk's start mode walks
    both halves back from the crossing.

    Qf/Tf [B, L] uint8 padded with QPAD/TPAD, Qr/Tr the rows with their first
    qlen/tlen bases reversed; band must already include the chunk's largest
    |qlen - tlen|; tmax_half >= max(qlen + tlen) // 2 + 2.  Returns (scores
    [B] int32, opcodes [2B, tmax_half + 1] uint8, rows b and B + b the
    forward and backward half-walks of pair b, cross_m [B] bool); merge
    with nw.merge_fold_ops."""
    ql2 = torch.cat([qlens, qlens])
    tl2 = torch.cat([tlens, tlens])
    fin = qlens + tlens
    tm = torch.div(fin + 1, 2, rounding_mode="floor")
    t_snap = torch.cat([tm, fin - tm]).to(torch.int32)
    pen = dict(mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2)
    _s, tb, (SNAP, DIAGA, DIAGB) = nw_align(torch.cat([Qf, Qr]), torch.cat([Tf, Tr]), ql2, tl2,
                                            band=band, tmax=tmax_half, int16=int16, t_snap=t_snap,
                                            **pen)
    scores, state, cross_m = fold_combine(SNAP, DIAGA, DIAGB, qlens, tlens, o1=o1, o2=o2, band=band)
    ops = nw_walk_start(tb, state, band=band, tmax=tmax_half)
    return scores, ops, cross_m


# -- kernels C and D: the row-major sweep and walk ---------------------------------------


def rows_width(band: int) -> int:
    """Lanes of the row-major sweep: Wr = 2 * band + 1 (row i covers the
    columns j in [i - band, i + band])."""
    return 2 * band + 1


# kernel C's instantiations, (lanes a thread, most threads) -> the blocks an
# SM its __launch_bounds__ promise (csrc/nw_rows.cu::rows_fn_t; each with the
# rows staged whole and a window at a time)
ROWS_BOUNDS = {(8, 128): 5, (8, 512): 1, (16, 512): 1, (16, 1024): 1}
ROWS_MAX_LANES = 16 * 1024
_SM_REGS = 65536
_SM_THREADS = 2048
_SM_SMEM = 233472  # shared memory of an SM; a block reserves 1 KB of it
_ROWS_STATIC_SMEM = 6 * 2 * 32 * 4  # csrc/nw_rows.cu::RowShared
# slots of kernel D's gap ring in shared memory, per pair; the gap list
# (min(gap_max, R + 1) entries) must fit it
ROWS_WALK_RING = 256
ROWS_WALK_PAIRS = 4  # kernel D: one warp a pair (csrc/nw_rows.cu::RW_WALK_PAIRS)
# kernel D's shared-memory tiles: rows, bytes a row (the three 16-byte blocks
# that cover 32 lanes at any alignment), tiles a warp (csrc/nw_rows.cu)
ROWS_WALK_TILE = (64, 48, 3)


def rows_walk_smem(G: int) -> int:
    """Shared memory of a block of kernel D: each warp's tiles (the one it
    walks and those loading below it) and its gap ring of G (row, length)
    int32 slots."""
    if not 1 <= G <= ROWS_WALK_RING:
        raise ValueError(f"kernel D keeps 1 to {ROWS_WALK_RING} gaps a pair, got {G}")
    rows, row_bytes, tiles = ROWS_WALK_TILE
    return ROWS_WALK_PAIRS * (tiles * rows * row_bytes + 2 * G * 4)


def rows_walk_pairs_per_sm(G: int) -> int:
    """Pairs of kernel D an SM's shared memory and threads leave resident
    (each block reserving 1 KB)."""
    return ROWS_WALK_PAIRS * min(_SM_SMEM // (rows_walk_smem(G) + 1024), _SM_THREADS // (32 * ROWS_WALK_PAIRS), 32)


def rows_plan(Wr: int) -> tuple[int, int]:
    """(lanes per thread, threads per block) of kernel C for Wr lanes: one
    block a pair, thread r owning lanes [r * S, r * S + S).  8 lanes a
    thread up to 4,096 lanes (4 warps and five pairs an SM up to 1,024), 16
    past that, on as many warps as cover Wr."""
    if not 1 <= Wr <= ROWS_MAX_LANES:
        raise ValueError(f"the row-major sweep takes 1 to {ROWS_MAX_LANES} lanes, got {Wr}")
    S = 8 if Wr <= 8 * 512 else 16
    return S, -(-(-(-Wr // S)) // 32) * 32


def rows_bounds(S: int, threads: int) -> tuple[int, int]:
    """(most threads, blocks an SM) of the instantiation kernel C runs S
    lanes on `threads` threads with (the first in ROWS_BOUNDS that takes
    it)."""
    for (lanes, most), blocks in ROWS_BOUNDS.items():
        if lanes == S and threads <= most:
            return most, blocks
    raise ValueError(f"kernel C has no instantiation of {S} lanes on {threads} threads")


def rows_smem(R: int, band: int, S: int, threads: int) -> tuple[int, int, int, int]:
    """(window rows, query bytes, target offset, target bytes) of kernel
    C's shared memory: a window's query rows and the byte past it (read a
    row ahead), and its target row at a 16-aligned offset past the band's
    leading pad, long enough for every lane's base at every row of the
    window.  The window is all R rows where they fit the share of an SM's
    shared memory that leaves the launch bound's pairs resident, else the
    most rows, a multiple of 16, that fit it."""
    t_off = _round16(band + 1)
    fixed = t_off - band + threads * S
    _most, blocks = rows_bounds(S, threads)
    share = min(_SM_SMEM // blocks - 1024, _SMEM_OPTIN_BYTES) - _ROWS_STATIC_SMEM
    win = R
    if _round16(R + 1) + _round16(fixed + R) > share:
        win = (share - fixed - 32) // 32 * 16
    return win, _round16(win + 1), t_off, _round16(fixed + win)


def rows_pairs_per_sm(S: int, threads: int, R: int, band: int) -> int:
    """Pairs resident on an SM, reckoned from kernel C's launch bounds (the
    registers they leave a thread, rounded down to 8), its threads and its
    shared memory."""
    most, blocks = rows_bounds(S, threads)
    regs = _SM_REGS // (blocks * most) // 8 * 8
    _win, nq, _t_off, nt = rows_smem(R, band, S, threads)
    return min(_SM_REGS // (min(regs, 255) * threads), _SM_THREADS // threads, 32,
               _SM_SMEM // (nq + nt + _ROWS_STATIC_SMEM + 1024))


def nw_align_rows(Q, T, qlens, tlens, *, mismatch, o1, e1, o2, e2, band, int16=False):
    """Kernel C, the row-major sweep (``csrc/nw_rows.cu``; the counterpart of
    the XLA program ``seqrush_tpu/ops/nw.py::_sweep_rows``): one step per
    query row over Wr = 2 * band + 1 lanes, the within-row gaps in closed
    form (an exclusive min-scan over the lanes).

    Q [B, R] / T [B, Lt] uint8 padded with QPAD/TPAD (R query rows).
    Returns (scores [B] int32, -1 where the final lane is off the band;
    tb [B, R + 1, Wr] uint8 in the row-major byte layout: bits 0-1 the
    gap-free choice (0 diagonal, 1 I1, 2 I2), bits 2-3 the D override (0,
    1 D1, 2 D2), bits 4-7 I1, I2, D1, D2 opened)."""
    device = Q.device
    _check("Q", Q, torch.uint8, 2, device)
    _check("T", T, torch.uint8, 2, device)
    B = Q.shape[0]
    if T.shape[0] != B:
        raise ValueError("Q and T must have the same batch size")
    _check_lengths(qlens, tlens, B, device)
    if band < 0:
        raise ValueError("band must be >= 0")
    kw = dict(mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2, band=band, int16=int16)
    if device.type == "cpu":
        return nw_align_rows_reference(Q, T, qlens, tlens, **kw)
    _require_cuda(device)
    R = Q.shape[1]
    Wr = rows_width(band)
    S, threads = rows_plan(Wr)
    win, nq, t_off, nt = rows_smem(R, band, S, threads)
    scores = torch.empty(B, dtype=torch.int32, device=device)
    tb = torch.empty((B, R + 1, Wr), dtype=torch.uint8, device=device)
    if B == 0:
        return scores, tb
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nw_rows_sweep_launch(
            Q.data_ptr(), T.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), scores.data_ptr(),
            tb.data_ptr(), B, R, T.shape[1], band, mismatch, o1, e1, o2, e2, int(int16), S,
            threads, win, nq, t_off, nt, stream)
    if err != 0:
        raise RuntimeError(f"nw_rows sweep launch failed with CUDA error {err}")
    LAUNCHES["nw_rows_sweep"] += 1
    return scores, tb


def nw_rows_occupancy(R: int, band: int, two_piece: bool, int16: bool = False) -> dict:
    """Registers per thread and resident pairs per SM of kernel C at a
    launch shape, from the CUDA runtime (needs the card), beside
    rows_pairs_per_sm's reckoning."""
    S, threads = rows_plan(rows_width(band))
    win, nq, _t_off, nt = rows_smem(R, band, S, threads)
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    err = _library().nw_rows_occupancy(S, threads, int(two_piece), int(int16), int(win < R), nq + nt,
                                       ctypes.byref(regs), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"nw_rows occupancy query failed with CUDA error {err}")
    return {"lanes_per_thread": S, "threads": threads, "window_rows": win, "regs_per_thread": regs.value,
            "smem_per_block": nq + nt + _ROWS_STATIC_SMEM, "resident_pairs_per_sm": blocks.value,
            "reckoned_pairs_per_sm": rows_pairs_per_sm(S, threads, R, band)}


def rows_walk_occupancy(G: int) -> dict:
    """Registers and spilled bytes per thread and resident pairs per SM of
    kernel D with a gap list of G slots, from the CUDA runtime (needs the
    card), beside rows_walk_pairs_per_sm's reckoning."""
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _library().nw_rows_walk_occupancy(G, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"nw_rows walk occupancy query failed with CUDA error {err}")
    return {"regs_per_thread": regs.value, "local_bytes_per_thread": local.value,
            "smem_per_block": rows_walk_smem(G), "resident_pairs_per_sm": blocks.value * ROWS_WALK_PAIRS,
            "reckoned_pairs_per_sm": rows_walk_pairs_per_sm(G)}


def nw_align_rows_reference(Q, T, qlens, tlens, *, mismatch, o1, e1, o2, e2, band, int16=False):
    """Plain PyTorch version of kernel C: nw._sweep_rows step by step (in
    int16, its adds wrapped to 16 bits and its clamps at INF16)."""
    B, R = Q.shape
    K = band
    Wr = rows_width(K)
    dev = Q.device
    two = o2 >= 0
    i32 = torch.int32
    neg = nw.INF16 if int16 else INF
    BIG = 1 << 30

    def add(a, b):
        return _wrap16(a + b) if int16 else a + b

    Tp = F.pad(T.to(i32), (K + 1, K + R + 2), value=TPAD)
    Qp = F.pad(Q.to(i32), (1, 1), value=QPAD)
    lanes = torch.arange(Wr, dtype=i32, device=dev)[None, :]
    ramp1 = lanes * e1
    ramp2 = lanes * e2 if two else None
    big_col = torch.full((B, 1), BIG, dtype=i32, device=dev)
    neg_col = torch.full((B, 1), neg, dtype=i32, device=dev)
    neg_row = torch.full((B, Wr), neg, dtype=i32, device=dev)
    false_row = torch.zeros((B, Wr), dtype=torch.bool, device=dev)
    mis = int(np.int16(mismatch)) if int16 else mismatch

    def shift_right(x, col):
        return torch.cat([col, x[:, :-1]], dim=1)

    def d_pass(Ht, ramp, o):
        A = Ht - ramp
        P = shift_right(torch.cummin(A, dim=1).values, big_col)  # exclusive prefix minimum
        opened = shift_right(A, big_col) <= shift_right(P, big_col)
        return torch.minimum(P + (ramp + o), torch.full_like(P, neg)), opened

    def d_choice(Ht):
        D1, d1o = d_pass(Ht, ramp1, o1)
        D2, d2o = d_pass(Ht, ramp2, o2) if two else (neg_row, false_row)
        Hn = Ht
        dtag = torch.zeros((B, Wr), dtype=i32, device=dev)
        for cand, tag in ((D1, 1), (D2, 2)):
            better = cand < Hn
            Hn = torch.where(better, cand, Hn)
            dtag = torch.where(better, tag, dtag)
        return Hn, (dtag << 2) | (d1o.to(i32) << 6) | (d2o.to(i32) << 7)

    tb = torch.zeros((B, R + 1, Wr), dtype=torch.uint8, device=dev)
    Ht0 = neg_row.clone()
    Ht0[:, K] = 0
    H, byte0 = d_choice(Ht0)
    tb[:, 0] = byte0.to(torch.uint8)
    I1, I2 = neg_row, neg_row
    FIN = torch.where((qlens == 0)[:, None], H, neg_row)
    for r in range(1, R + 1):
        H_up, I1_up, I2_up = (torch.cat([x[:, 1:], neg_col], dim=1) for x in (H, I1, I2))
        up_open, ext = add(H_up, o1 + e1), add(I1_up, e1)
        I1n, i1o = torch.minimum(up_open, ext), up_open <= ext
        if two:
            up_open, ext = add(H_up, o2 + e2), add(I2_up, e2)
            I2n, i2o = torch.minimum(up_open, ext), up_open <= ext
        else:
            I2n, i2o = neg_row, false_row
        sub = (Qp[:, r : r + 1] != Tp[:, r : r + Wr]).to(i32) * mis
        Ht = add(H, sub)
        if int16:
            Ht, I1n, I2n = (x.clamp(max=neg) for x in (Ht, I1n, I2n))
        httag = torch.zeros((B, Wr), dtype=i32, device=dev)
        for cand, tag in ((I1n, 1), (I2n, 2)):
            better = cand < Ht
            Ht = torch.where(better, cand, Ht)
            httag = torch.where(better, tag, httag)
        H, dbyte = d_choice(Ht)
        tb[:, r] = (httag | dbyte | (i1o.to(i32) << 4) | (i2o.to(i32) << 5)).to(torch.uint8)
        I1, I2 = I1n, I2n
        FIN = torch.where((qlens == r)[:, None], H, FIN)
    fin_lane = (tlens - qlens + K).to(torch.int64)
    ok = (fin_lane >= 0) & (fin_lane < Wr)
    fin_val = FIN.gather(1, fin_lane.clamp(0, Wr - 1)[:, None])[:, 0]
    scores = torch.where(ok & (fin_val < INF), fin_val, -1).to(i32)
    return scores, tb


def nw_walk_rows(tb, qlens, tlens, *, band, gap_max=None):
    """Kernel D, the row-major walk (``csrc/nw_rows.cu``; the counterpart of
    the XLA program ``seqrush_tpu/ops/nw.py::_tb_rows_scan``): one query row
    a step from row qlen down, a whole D-run resolved in the row it ends in.

    tb [B, R + 1, Wr] uint8 (nw_align_rows').  Returns (steps [B, R + 1]
    uint8, OP_M / OP_I at each row the walk steps from; grows, gvals
    [B, G] int16 with G = min(gap_max, R + 1), the rows and lengths of the
    pair's D-runs at its G lowest rows, ascending, padded with -1 and 0;
    gcount [B] int32, every D-run of the pair, those past G too).
    gap_max defaults to nw.GAP_MAX."""
    device = tb.device
    _check("tb", tb, torch.uint8, 3, device)
    B = tb.shape[0]
    _check_lengths(qlens, tlens, B, device)
    gap_max = nw.GAP_MAX if gap_max is None else int(gap_max)
    if tb.shape[2] != rows_width(band) or gap_max < 1:
        raise ValueError(f"tb shape {tuple(tb.shape)} does not fit band {band} (or gap_max < 1)")
    if device.type == "cpu":
        return nw_walk_rows_reference(tb, qlens, tlens, band=band, gap_max=gap_max)
    _require_cuda(device)
    R = tb.shape[1] - 1
    G = min(gap_max, R + 1)
    steps = torch.zeros((B, R + 1), dtype=torch.uint8, device=device)
    grows = torch.empty((B, G), dtype=torch.int16, device=device)
    gvals = torch.empty((B, G), dtype=torch.int16, device=device)
    gcount = torch.empty(B, dtype=torch.int32, device=device)
    if B == 0:
        return steps, grows, gvals, gcount
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nw_rows_walk_launch(tb.data_ptr(), qlens.data_ptr(), tlens.data_ptr(),
                                      steps.data_ptr(), grows.data_ptr(), gvals.data_ptr(),
                                      gcount.data_ptr(), B, R, band, G, ROWS_WALK_RING, stream)
    if err != 0:
        raise RuntimeError(f"nw_rows walk launch failed with CUDA error {err}")
    LAUNCHES["nw_rows_walk"] += 1
    return steps, grows, gvals, gcount



def nw_walk_rows_reference(tb, qlens, tlens, *, band, gap_max=None):
    """Plain PyTorch version of kernel D: nw._tb_rows_scan's scan over every
    row, acting on the pairs whose cursor is in it, and its top_k
    compaction of the gap list (the gaps of the lowest rows, ascending)."""
    gap_max = nw.GAP_MAX if gap_max is None else int(gap_max)
    B, R1, Wr = tb.shape
    R = R1 - 1
    K = band
    dev = tb.device
    i64 = torch.int64
    lanes = torch.arange(Wr, dtype=i64, device=dev)[None, :]
    rows = torch.arange(B, device=dev)
    ql, tl = qlens.to(i64), tlens.to(i64)
    cur_i = ql.clone()
    cur_l = (tl - ql + K).clamp(0, Wr - 1)
    st = torch.zeros(B, dtype=i64, device=dev)
    done = (ql == 0) & (tl == 0)
    steps = torch.zeros((B, R + 1), dtype=torch.uint8, device=dev)
    gaps = torch.zeros((B, R + 1), dtype=i64, device=dev)

    def pick(row, l):
        ok = (l >= 0) & (l < Wr)
        return torch.where(ok, row[rows, l.clamp(0, Wr - 1)], 0)

    top = int(ql.max()) if B else -1
    for r in range(min(top, R), -1, -1):
        active = ~done & (cur_i == r)
        if not bool(active.any()):
            continue
        row = tb[:, r].to(i64)
        b1 = pick(row, cur_l)
        in_h = st == 0
        dtag = torch.where(in_h, (b1 >> 2) & 3, 0)
        has_run = dtag > 0
        openbit = (row >> (5 + dtag)[:, None]) & 1
        mask = (openbit > 0) & (lanes <= cur_l[:, None]) & has_run[:, None]
        l0 = torch.where(mask, lanes, -1).amax(dim=1)
        glen = torch.where(has_run & (l0 >= 0), cur_l - l0 + 1, 0)
        step_lane = torch.where(has_run, l0 - 1, cur_l)
        b2 = pick(row, step_lane)
        ht = torch.where(in_h, b2 & 3, st)
        is_i = ht > 0
        iopen = (torch.where(in_h, b2, b1) >> (3 + ht)) & 1
        terminal = active & (r == 0)
        op = torch.where(is_i, OP_I, OP_M)
        steps[:, r] = torch.where(active & ~terminal, op, OP_NONE).to(torch.uint8)
        gaps[:, r] = torch.where(active, glen, 0)
        ni = cur_i - 1
        nl = step_lane + is_i.to(i64)
        nst = torch.where(is_i & (iopen == 0), ht, 0)
        ndone = terminal | ((ni == 0) & (nl == K))
        cur_i = torch.where(active, ni, cur_i)
        cur_l = torch.where(active, nl, cur_l)
        st = torch.where(active, nst, st)
        done = done | (active & ndone)
    G = min(gap_max, R + 1)
    has_gap = gaps > 0
    key = torch.where(has_gap, (R + 1) - torch.arange(R + 1, device=dev)[None, :], 0)
    _vals, gpos = torch.topk(key, G, dim=1)
    valid = has_gap.gather(1, gpos)
    grows = torch.where(valid, gpos, -1).to(torch.int16)
    gvals = torch.where(valid, gaps.gather(1, gpos), 0).to(torch.int16)
    return steps, grows, gvals, has_gap.sum(dim=1).to(torch.int32)


# -- band tiling: kernels A and B over tile rows ------------------------------------


@dataclass(frozen=True)
class TiledPlan:
    """How kernel A's tiled mode covers a dispatch of n_wide wide and n_narrow
    narrow pairs.  Register route: blocks of n_tiles * warps_per_pair warps,
    the first n_wide blocks one wide pair each (all its warps), the others
    n_tiles narrow pairs each (warps_per_pair warps a pair); pair_bytes is a
    narrow pair's shared memory, smem_bytes the block's.  Wide route (lanes
    0): one block of `threads` threads a pair, its DP rows in smem_bytes of
    shared memory, or in a global scratch where smem_bytes is 0."""

    route: str  # "regs" or "wide"
    lanes: int
    warps_per_pair: int
    threads: int
    pair_bytes: int
    smem_bytes: int
    blocks: int


def plan_sweep_tiled(n_narrow: int, n_wide: int, W: int, n_tiles: int, Lq: int, Lt: int) -> TiledPlan:
    """Kernel A's tiled launch: on the register route, the strip whose blocks
    fit (n_tiles narrow pairs or one wide pair of n_tiles * W lanes, within
    the strip's launch bound and the shared memory) at the least _sweep_cost
    of the busiest SM sub-partition; the wide route where none fits or
    n_tiles * W exceeds REG_MAX_W."""
    R = n_tiles
    Ww = R * W
    best = None
    if Ww <= REG_MAX_W:
        for s in sorted(SWEEP_LANES, reverse=True):
            wpp = -(-W // (32 * s))
            threads = 32 * wpp * R
            pair_bytes = pair_smem_bytes(Lq, Lt, W, s, wpp)
            smem = max(R * pair_bytes, pair_smem_bytes(Lq, Lt, Ww, s, wpp * R))
            if threads > _MAX_THREADS[s] or smem > _SMEM_OPTIN_BYTES:
                continue
            plan = TiledPlan("regs", s, wpp, threads, pair_bytes, smem, n_wide + -(-n_narrow // R))
            warps_per_sm = -(-plan.blocks // _H100_SMS) * R * wpp
            cost = -(-warps_per_sm // _SMSPS_PER_SM) * (s + STEP_OVERHEAD_LANES)
            if best is None or cost < best[0]:
                best = (cost, plan)
    return best[1] if best is not None else wide_plan_tiled(n_narrow + n_wide, Ww)


def wide_plan_tiled(n_pairs: int, Ww: int) -> TiledPlan:
    """Kernel A's tiled mode on the wide route: one block a pair, threads for
    the wide pairs' Ww lanes, the 11 DP rows of Ww int32 in shared memory
    while they fit, else in a global scratch."""
    rows = _SWEEP_ROWS * Ww * 4
    return TiledPlan("wide", 0, 0, min(1024, -(-Ww // 32) * 32), 0,
                     rows if rows <= _SMEM_OPTIN_BYTES else 0, n_pairs)


def tiled_rows(tile, wide, n_tiles: int, band: int, B: int) -> tuple[np.ndarray, np.ndarray]:
    """Check a tiled dispatch's row layout and return (wide_first,
    narrow_first), the first rows of its wide and its narrow pairs, int32.

    tile [B] int32 and wide [B] bool are host arrays: a narrow row is a pair
    at `band` (tile 0); a wide pair at n_tiles * (band + 1) - 1 takes
    n_tiles consecutive rows with tiles 0 .. n_tiles - 1, its lane l in row
    first + l // W at lane l % W.  As the JAX package's tiled kernel, this
    needs W = band + 1 even and n_tiles >= 2."""
    W = band + 1
    if W % 2 or n_tiles < 2:
        raise ValueError(f"band tiling needs W even and n_tiles > 1, got W={W}, n_tiles={n_tiles}")
    tile = np.asarray(tile, dtype=np.int64)
    wide = np.asarray(wide, dtype=bool)
    if tile.shape != (B,) or wide.shape != (B,):
        raise ValueError(f"tile and wide must have {B} entries")
    if (tile[~wide] != 0).any() or (tile < 0).any() or (tile >= n_tiles).any():
        raise ValueError("narrow rows must be tile 0 and wide rows tiles 0 .. n_tiles - 1")
    wide_first = np.flatnonzero(wide & (tile == 0))
    rows = wide_first[:, None] + np.arange(n_tiles)[None, :]  # each wide pair's rows
    if ((rows >= B).any() or wide.sum() != rows.size
            or (tile[rows] != np.arange(n_tiles)).any()):  # rows < B here (the first test)
        raise ValueError("each wide pair must take n_tiles consecutive rows, tiles 0 .. n_tiles - 1")
    return wide_first.astype(np.int32), np.flatnonzero(~wide).astype(np.int32)


def _tiled_order(tile, wide, n_tiles, band, B, device) -> tuple[torch.Tensor, int]:
    """The kernels' pair list on `device`: the wide pairs' first rows, then
    the narrow ones; and the number of wide pairs."""
    wide_first, narrow_first = tiled_rows(tile, wide, n_tiles, band, B)
    order = torch.from_numpy(np.concatenate([wide_first, narrow_first])).to(device)
    return order, int(wide_first.size)


def nw_align_tiled(Q, T, qlens, tlens, tile, wide, *, mismatch, o1, e1, o2, e2, band, n_tiles, tmax,
                   int16=False):
    """Kernel A's tiled mode (``csrc/nw_sweep_tiled.cu``; the counterpart of the
    XLA program ``seqrush_tpu/ops/nw.py::_sweep_tiled``): one launch over a
    chunk whose narrow pairs run at `band` and whose wide pairs run at
    n_tiles * (band + 1) - 1, each as the untiled sweep at its own band.

    Q [B, Lq] / T [B, Lt] uint8, qlens, tlens [B] int32 per row (a wide
    pair's sequences are read from its first row); tile, wide: the row
    layout (host arrays, tiled_rows).  Returns (scores [B] int32 on each
    pair's first row, -1 on the other tile rows; tb [B, tmax_pad, W] uint8
    in the tile-row layout: a wide pair's lane l of anti-diagonal t at
    [first + l // W, t, l % W])."""
    device = Q.device
    _check("Q", Q, torch.uint8, 2, device)
    _check("T", T, torch.uint8, 2, device)
    B = Q.shape[0]
    if T.shape[0] != B:
        raise ValueError("Q and T must have the same batch size")
    _check_lengths(qlens, tlens, B, device)
    kw = dict(mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2, band=band, n_tiles=n_tiles, tmax=tmax,
              int16=int16)
    if device.type == "cpu":
        return nw_align_tiled_reference(Q, T, qlens, tlens, tile, wide, **kw)
    _require_cuda(device)
    order, n_wide = _tiled_order(tile, wide, n_tiles, band, B, device)
    W = band + 1
    plan = plan_sweep_tiled(order.numel() - n_wide, n_wide, W, n_tiles, Q.shape[1], T.shape[1])
    if not register_route_penalties(mismatch, o1, e1, o2, e2, int16):
        plan = wide_plan_tiled(order.numel(), n_tiles * W)
    return sweep_tiled_launch(Q, T, qlens, tlens, order, n_wide, plan, **kw)


def sweep_tiled_launch(Q, T, qlens, tlens, order, n_wide: int, plan: TiledPlan, *, mismatch, o1, e1, o2,
                       e2, band, n_tiles, tmax, int16=False, timer=None):
    """Launch kernel A's tiled mode on checked CUDA tensors: order [n_pairs]
    int32 holds the wide pairs' first rows, then the narrow pairs'
    (_tiled_order); plan is plan_sweep_tiled's, or another to compare.
    timer: None, or a zero-filled int64 tensor of TILED_TIMER_SLOTS a warp
    of the launch, which takes the register route's timed instantiation
    (sweep_tiled_split)."""
    if plan.route != "wide" and not register_route_penalties(mismatch, o1, e1, o2, e2, int16):
        raise ValueError("the register route takes penalties in [0, 2^16) only "
                         "(in int16, those whose adds cannot wrap)")
    device = Q.device
    B, Lq = Q.shape
    W = band + 1
    tmax_pad = tmax_pad_of(tmax)
    scores = torch.empty(B, dtype=torch.int32, device=device)
    tb = torch.empty((B, tmax_pad, W), dtype=torch.uint8, device=device)
    n_pairs = order.numel()
    if n_pairs == 0:
        return scores, tb
    scratch = None
    if plan.route == "wide" and not plan.smem_bytes:
        scratch = torch.empty(n_pairs * _SWEEP_ROWS * n_tiles * W, dtype=torch.int32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nw_sweep_tiled_launch(
            Q.data_ptr(), T.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), scores.data_ptr(),
            tb.data_ptr(), order.data_ptr(), scratch.data_ptr() if scratch is not None else None,
            n_pairs, n_wide, n_tiles, Lq, T.shape[1], W, tmax, tmax_pad, mismatch, o1, e1, o2, e2,
            int(int16), plan.lanes, plan.warps_per_pair, plan.pair_bytes, plan.threads, plan.smem_bytes,
            None if timer is None else timer.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"nw_sweep tiled launch failed with CUDA error {err}")
    LAUNCHES["nw_sweep_tiled"] += 1
    return scores, tb


def tiled_promised_rows(qlens, tlens, tile, wide, n_tiles: int, tmax: int, tmax_pad: int) -> torch.Tensor:
    """[B, tmax_pad] bool on qlens' device: the traceback rows kernel A's
    tiled mode writes, each pair's rows 0 .. min(tmax, t_final + 2) on each
    of its tile rows (a wide pair's t_final from its first row); the tiled
    walk reads no other row (it starts at t_final)."""
    fin = (qlens.to(torch.int64) + tlens.to(torch.int64)).clone()
    B = fin.numel()
    tile = np.asarray(tile, dtype=np.int64)
    wide = np.asarray(wide, dtype=bool)
    owner = np.arange(B) - np.where(wide, tile, 0)  # each row's pair's first row
    end = torch.clamp(fin[torch.from_numpy(owner).to(fin.device)] + 2, max=tmax)
    return torch.arange(tmax_pad, device=fin.device)[None, :] <= end[:, None]


def tiled_occupancy(plan: TiledPlan, two_piece: bool, W: int) -> dict:
    """Registers and local (spill) bytes a thread and resident blocks an SM
    of the tiled register route's kernel at a plan's lanes and block, for
    tile rows of W lanes, from the CUDA runtime (needs the card)."""
    if plan.route != "regs":
        raise ValueError("the occupancy query is the register route's")
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _library().nw_sweep_tiled_occupancy(plan.lanes, int(two_piece), W, plan.threads, plan.smem_bytes,
                                              ctypes.byref(regs), ctypes.byref(local), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"nw_sweep tiled occupancy query failed with CUDA error {err}")
    return {"regs_per_thread": regs.value, "local_bytes_per_thread": local.value,
            "resident_blocks_per_sm": blocks.value, "warps_per_block": plan.threads // 32}


# values a warp of the tiled register route's timer (csrc/nw_sweep_tiled.cu)
TILED_TIMER_SLOTS = 7


def tiled_split(v: np.ndarray, warps_per_block: int, n_wide: int) -> dict:
    """The split of a timed tiled launch from its timer v [warps, 7] int64
    (csrc/nw_sweep_tiled.cu: each warp's %globaltimer at entry, after
    staging and at its end; its recurrence's SM cycles; %smid; its pair's
    first row, -1 for an empty slot; its anti-diagonals).  Blocks below
    n_wide are wide.  Returns the launch's span, the wide blocks' and the
    narrow blocks' times, each SM's warps and blocks, the busiest SM's
    warps, time and cycles against the mean, the nanoseconds a cycle, the
    recurrence's cycles an anti-diagonal a warp by the warps on its SM and
    by kind, and the blocks that ran alone on an SM."""
    v = np.asarray(v, dtype=np.int64).reshape(-1, TILED_TIMER_SLOTS)
    live = v[:, 5] >= 0
    block = np.arange(v.shape[0]) // warps_per_block
    t0 = int(v[:, 0].min())
    start, end = v[:, 0] - t0, np.where(live, v[:, 2], v[:, 1]) - t0
    n_blocks = int(block.max()) + 1 if v.size else 0
    b_start = np.full(n_blocks, np.iinfo(np.int64).max)
    b_end = np.zeros(n_blocks, np.int64)
    np.minimum.at(b_start, block, start)
    np.maximum.at(b_end, block, end)
    b_ms = (b_end - b_start) / 1e6
    wide_b = np.arange(n_blocks) < n_wide
    sm = v[:, 4]
    sms = np.unique(sm)
    sm_warps = np.array([int((live & (sm == k)).sum()) for k in sms])
    sm_blocks = np.array([np.unique(block[sm == k]).size for k in sms])
    sm_end = np.array([int(end[sm == k].max()) for k in sms]) / 1e6
    sm_cycles = np.array([int(v[live & (sm == k), 3].sum()) for k in sms])
    dp_ns = (v[live, 2] - v[live, 1]).sum()
    per_step = np.where(live, v[:, 3] / np.maximum(v[:, 6], 1), 0.0)
    by_load = {}
    for k in sorted(set(sm_warps.tolist())):
        on = live & np.isin(sm, sms[sm_warps == k])
        for kind, sel in (("wide", on & wide_b[block]), ("narrow", on & ~wide_b[block])):
            if sel.any():
                by_load[f"{k} warps, {kind}"] = round(float(per_step[sel].mean()), 1)
    busiest = int(np.argmax(sm_end)) if sms.size else 0
    lone = sorted({int(x) for x in block[np.isin(sm, sms[sm_blocks == 1])]})

    def stats(x):
        return {"mean": round(float(x.mean()), 4), "max": round(float(x.max()), 4)} if x.size else None

    return {"kernel_ms": round(float(end.max()) / 1e6, 4),
            "wide_block_ms": stats(b_ms[wide_b]), "narrow_block_ms": stats(b_ms[~wide_b]),
            "sms": int(sms.size), "sm_warps": {str(k): int((sm_warps == k).sum()) for k in np.unique(sm_warps)},
            "sm_blocks": {str(k): int((sm_blocks == k).sum()) for k in np.unique(sm_blocks)},
            "busiest_sm": {"warps": int(sm_warps[busiest]), "ms": round(float(sm_end[busiest]), 4),
                           "cycles": int(sm_cycles[busiest])} if sms.size else None,
            "mean_sm": {"warps": round(float(sm_warps.mean()), 3), "ms": round(float(sm_end.mean()), 4),
                        "cycles": round(float(sm_cycles.mean()), 1)} if sms.size else None,
            "ns_per_cycle": round(float(dp_ns / max(int(v[live, 3].sum()), 1)), 4),
            "cycles_per_anti_diagonal": by_load,
            "recurrence_ms_mean": round(float((v[live, 2] - v[live, 1]).mean()) / 1e6, 4) if live.any() else 0.0,
            "lone_blocks": lone}


def sweep_tiled_split(Q, T, qlens, tlens, order, n_wide: int, plan: TiledPlan, **kw):
    """One launch of kernel A's tiled register route on the card with its
    own timer, for a timing tool; the pipeline never launches it.  Returns
    (scores, tb, tiled_split of the timer)."""
    _require_cuda(Q.device)
    if plan.route != "regs":
        raise ValueError("the timer is the register route's")
    timer = torch.zeros(plan.blocks * (plan.threads // 32) * TILED_TIMER_SLOTS, dtype=torch.int64,
                        device=Q.device)
    scores, tb = sweep_tiled_launch(Q, T, qlens, tlens, order, n_wide, plan, timer=timer, **kw)
    split = tiled_split(timer.view(-1, TILED_TIMER_SLOTS).cpu().numpy(), plan.threads // 32, n_wide)
    return scores, tb, split


def _tile_index(first: np.ndarray, n_tiles: int, device) -> torch.Tensor:
    """Rows [n, n_tiles] of the wide pairs whose first rows are `first`."""
    return torch.from_numpy(first.astype(np.int64)[:, None] + np.arange(n_tiles)).to(device)


def nw_align_tiled_reference(Q, T, qlens, tlens, tile, wide, *, mismatch, o1, e1, o2, e2, band,
                             n_tiles, tmax, int16=False):
    """Plain PyTorch version of kernel A's tiled mode: nw_align_reference on
    the narrow rows at `band` and on the wide pairs' first rows at
    n_tiles * (band + 1) - 1, the wide tracebacks laid into their tile
    rows (the same function: the tiled sweep is each pair's untiled one)."""
    B = Q.shape[0]
    W = band + 1
    dev = Q.device
    wide_first, narrow_first = tiled_rows(tile, wide, n_tiles, band, B)
    tp = tmax_pad_of(tmax)
    scores = torch.full((B,), -1, dtype=torch.int32, device=dev)
    tb = torch.zeros((B, tp, W), dtype=torch.uint8, device=dev)
    pen = dict(mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2, tmax=tmax, int16=int16)
    for rows, k in ((narrow_first, band), (wide_first, n_tiles * W - 1)):
        if not rows.size:
            continue
        idx = torch.from_numpy(rows.astype(np.int64)).to(dev)
        s, t = nw_align_reference(Q[idx], T[idx], qlens[idx], tlens[idx], band=k, **pen)
        scores[idx] = s
        if k == band:
            tb[idx] = t
        else:  # [n, tp, R * W] -> the tile rows [n, R, tp, W]
            tb[_tile_index(rows, n_tiles, dev)] = t.view(-1, tp, n_tiles, W).permute(0, 2, 1, 3)
    return scores, tb


def nw_walk_runs_tiled(tb, qlens, tlens, tile, wide, *, band, n_tiles, tmax, run_max, run_len_max=None):
    """Kernel B's tiled runs mode (``csrc/nw_walk.cu``; the counterpart of the
    XLA program ``seqrush_tpu/ops/nw.py::_tb_scan_tiled``): nw_walk_runs over
    nw_align_tiled's traceback, each pair walked once at its own band from
    its tile rows.  Returns (tokens [B, run_max], counts [B]) int32 on each
    pair's first row, zero on the other tile rows."""
    device = tb.device
    _check("tb", tb, torch.uint8, 3, device)
    B = tb.shape[0]
    _check_lengths(qlens, tlens, B, device)
    W = band + 1
    if tb.shape[2] != W or tb.shape[1] < tmax + 1:
        raise ValueError(f"tb shape {tuple(tb.shape)} does not fit band {band}, tmax {tmax}")
    run_len_max = nw._RUN_LEN_MAX if run_len_max is None else int(run_len_max)
    if not nw.runs_fit(tmax):
        raise ValueError(f"run tokens need tmax + 4 < 2^15, got tmax {tmax}")
    if run_max < 1 or not 1 <= run_len_max <= nw._RUN_LEN_MAX:
        raise ValueError(f"run_max must be >= 1 and run_len_max in [1, {nw._RUN_LEN_MAX}]")
    kw = dict(band=band, n_tiles=n_tiles, tmax=tmax, run_max=run_max, run_len_max=run_len_max)
    if device.type == "cpu":
        return nw_walk_runs_tiled_reference(tb, qlens, tlens, tile, wide, **kw)
    _require_cuda(device)
    return _walk_runs_tiled_launch(tb, qlens, tlens, tile, wide, band, n_tiles, tmax, run_max, run_len_max,
                                   None)


def _walk_runs_tiled_launch(tb, qlens, tlens, tile, wide, band, n_tiles, tmax, run_max, run_len_max, phase):
    """The tiled runs mode's launch; phase as in _walk_runs_launch."""
    device = tb.device
    B = tb.shape[0]
    W = band + 1
    order, n_wide = _tiled_order(tile, wide, n_tiles, band, B, device)
    tokens = torch.zeros((B, run_max), dtype=torch.int32, device=device)
    counts = torch.zeros(B, dtype=torch.int32, device=device)
    if order.numel() == 0:
        return tokens, counts
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nw_walk_runs_tiled_launch(
            tb.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), order.data_ptr(), tokens.data_ptr(),
            counts.data_ptr(), order.numel(), n_wide, n_tiles, W, tmax, tb.shape[1], run_max, run_len_max,
            None if phase is None else phase.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"nw_walk tiled runs launch failed with CUDA error {err}")
    LAUNCHES["nw_walk_runs_tiled"] += 1
    return tokens, counts


def nw_walk_runs_tiled_reference(tb, qlens, tlens, tile, wide, *, band, n_tiles, tmax, run_max,
                                 run_len_max=None):
    """Plain PyTorch version of kernel B's tiled runs mode:
    nw_walk_runs_reference on the narrow rows at `band` and on each wide
    pair's tile rows put back side by side, at n_tiles * (band + 1) - 1."""
    B, tp, W = tb.shape
    dev = tb.device
    wide_first, narrow_first = tiled_rows(tile, wide, n_tiles, band, B)
    tokens = torch.zeros((B, run_max), dtype=torch.int32, device=dev)
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    kw = dict(tmax=tmax, run_max=run_max, run_len_max=run_len_max)
    for rows, k in ((narrow_first, band), (wide_first, n_tiles * W - 1)):
        if not rows.size:
            continue
        idx = torch.from_numpy(rows.astype(np.int64)).to(dev)
        if k == band:
            tbk = tb[idx]
        else:  # the tile rows [n, R, tp, W] -> [n, tp, R * W]
            tbk = tb[_tile_index(rows, n_tiles, dev)].permute(0, 2, 1, 3).reshape(-1, tp, n_tiles * W)
        tokens[idx], counts[idx] = nw_walk_runs_reference(tbk, qlens[idx], tlens[idx], band=k, **kw)
    return tokens, counts


# -- kernel A, sharded mode: one pair's band split by lanes over shards --------------


def sharded_rows(band: int, tmax: int) -> int:
    """Anti-diagonals the sharded sweep computes: TA = min(K, tmax) of the
    first phase, then macro-steps of two up to tmax, so tmax + 1 when
    tmax - TA is odd (seqrush_tpu/parallel/bandshard.py's T_total)."""
    ta = min(band, tmax)
    return ta + 2 * max(0, -(-(tmax - ta) // 2))


def _check_sharded(Q, T, qlens, tlens, n_shards: int, band: int, tmax: int) -> None:
    device = Q.device
    _check("Q", Q, torch.uint8, 2, device)
    _check("T", T, torch.uint8, 2, device)
    B = Q.shape[0]
    if T.shape[0] != B:
        raise ValueError("Q and T must have the same batch size")
    _check_lengths(qlens, tlens, B, device)
    if band < 0 or tmax < 0:
        raise ValueError("band and tmax must be >= 0")
    if n_shards < 1 or (band + 1) % n_shards:
        raise ValueError(f"{n_shards} shards must divide the band width {band + 1}")


def nw_align_sharded(devices, Q, T, qlens, tlens, *, mismatch, o1, e1, o2, e2, band, tmax):
    """The int32 sweep of one band split by lanes over len(devices) shards.

    Shard d holds lanes [d * Wl, (d + 1) * Wl) of W = band + 1 (Wl = W / D)
    on devices[d]; per anti-diagonal a shard takes one column of the DP rows
    from its left or right neighbour (INF at the band's edges).  The
    arithmetic is the JAX package's lane-sharded sweep
    (seqrush_tpu/parallel/bandshard.py::_build_sharded_sweep): the int32
    recurrence without clamps or validity masks, so off-matrix cells hold
    whatever it computes there.  Q [B, Lq], T [B, Lt] uint8 (QPAD / TPAD
    padded), qlens, tlens [B] int32, replicated: given on the first device.

    Returns (scores [B] int32 on devices[0], -1 for a pair not finished
    within sharded_rows(band, tmax) anti-diagonals; strips, one [B,
    sharded_rows + 1, Wl] uint8 tensor per shard on its device, row 0
    zero).  On CPU tensors (every device 'cpu') the plain version; on CUDA
    tensors kernel A's sharded mode (csrc/nw_sweep_shard.cu): a pair's
    lanes in the registers of thread-block clusters (pick_shard_plan), the
    columns handed over through distributed shared memory inside a cluster
    and through global memory with flags between clusters.  The shards of
    one device must be consecutive; distinct devices need peer access."""
    return nw_align_sharded_at(devices, Q, T, qlens, tlens, cluster=None, mismatch=mismatch, o1=o1, e1=e1,
                               o2=o2, e2=e2, band=band, tmax=tmax)


def nw_align_sharded_at(devices, Q, T, qlens, tlens, *, cluster, mismatch, o1, e1, o2, e2, band, tmax):
    """nw_align_sharded with `cluster` CTAs a cluster on every device (None:
    the planner's pick, pick_shard_plan), so that every cluster size the
    planner can pick is held to the plain version.  On CPU tensors the
    plain version, whatever `cluster`."""
    devices = [torch.device(d) for d in devices]
    D = len(devices)
    _check_sharded(Q, T, qlens, tlens, D, band, tmax)
    if cluster is not None and cluster not in SHARD_CLUSTERS:
        raise ValueError(f"cluster must be one of {SHARD_CLUSTERS}, got {cluster}")
    kw = dict(mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2, band=band, tmax=tmax)
    if Q.device.type == "cpu":
        if any(d.type != "cpu" for d in devices):
            raise ValueError("CPU tensors need a mesh of CPU devices")
        return nw_align_sharded_reference(Q, T, qlens, tlens, n_shards=D, **kw)
    _require_cuda(Q.device)
    if any(d.type != "cuda" for d in devices):
        raise ValueError("CUDA tensors need a mesh of CUDA devices")
    devices = [d if d.index is not None else torch.device("cuda", torch.cuda.current_device()) for d in devices]
    return _sharded_launch(devices, Q, T, qlens, tlens, cluster=cluster, **kw)


# threads a CTA of the sharded mode at most (kMaxThreads in csrc/nw_sweep_shard.cu)
_SHARD_MAX_THREADS = 512
SHARD_CLUSTERS = (1, 2, 4, 8, 16)  # CTAs a cluster (above 8: non-portable)
SHARD_TILE = 128  # anti-diagonals a tile of staged bases (kTile)
_SHARD_STAGE = 7  # a thread's share of a tile's new bases, at most (kStage)
SHARD_REC_INTS = 8  # a cluster end's record: two slots of three values, the flag, a pad
# dynamic shared memory a CTA asks for at least: over half an SM's 228 KB,
# so one CTA holds an SM and a cluster's CTAs spread over as many SMs
SHARD_SPREAD_SMEM = 120 * 1024


@dataclass(frozen=True)
class ShardPlan:
    """How kernel A's sharded mode covers one device's n_local shards of a
    pair: ctas_per_shard CTAs a shard, CTA c owning units [c * U // C,
    (c + 1) * U // C) of the shard's U = Wl / lanes units of `lanes` lanes
    (thread r of the CTA the r-th unit; threads past the CTA's units are
    ghosts); `cluster` consecutive CTAs of the device's n_local *
    ctas_per_shard form a cluster, `clusters` of them a pair.  qring and
    tring are the bytes of the staged-base rings."""

    lanes: int
    ctas_per_shard: int
    cluster: int
    clusters: int
    threads: int
    qring: int
    tring: int
    smem_bytes: int


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def shard_lanes(Wl: int) -> int:
    """Lanes a thread: the widest of 4, 2, 1 that divides the shard's Wl, so
    no thread's lanes straddle two shards and its row store is aligned.  A
    step's chain is a thread's lanes one after the other: 4 lanes on more
    warps ran faster than 8 on fewer (PERF.md, PR 13)."""
    return next(s for s in (4, 2, 1) if Wl % s == 0)


def shard_plan(band: int, n_shards: int, n_local: int, cluster: int) -> ShardPlan:
    """The sharded mode's launch for n_local of n_shards shards on one device
    at `cluster` CTAs a cluster (pure; raises ValueError where that size
    leaves a CTA without a lane).  The cluster takes G consecutive shards,
    G the largest power of two that divides n_local and is at most
    `cluster`, each in cluster / G CTAs; a shard too wide for that many CTAs
    of _SHARD_MAX_THREADS threads takes twice as many, in more clusters."""
    if cluster not in SHARD_CLUSTERS:
        raise ValueError(f"cluster must be one of {SHARD_CLUSTERS}, got {cluster}")
    if n_local < 1 or n_shards < n_local or (band + 1) % n_shards:
        raise ValueError(f"{n_local} of {n_shards} shards of a band of {band + 1} lanes")
    Wl = (band + 1) // n_shards
    S = shard_lanes(Wl)
    U = Wl // S
    G = 1
    while G * 2 <= cluster and n_local % (G * 2) == 0:
        G *= 2
    C = cluster // G
    while C * _SHARD_MAX_THREADS < U:
        C *= 2
    if C > U:
        raise ValueError(f"{cluster} CTAs a cluster leave a CTA of a {Wl}-lane shard without a lane")
    threads = -(-(-(-U // C)) // 32) * 32  # the most units a CTA owns, in warps
    span = threads * S
    qring = _pow2_at_least(span + SHARD_TILE + 2)
    tring = _pow2_at_least(span + 2 * SHARD_TILE + 1)
    need = 96 + 48 * (threads // 32) + qring + tring  # mbarriers, CTA slots, warp slots, rings
    return ShardPlan(lanes=S, ctas_per_shard=C, cluster=cluster, clusters=n_local * C // cluster,
                     threads=threads, qring=qring, tring=tring, smem_bytes=max(need, SHARD_SPREAD_SMEM))


def shard_cluster_sizes(band: int, n_shards: int, n_local: int) -> tuple[int, ...]:
    """The cluster sizes shard_plan takes at this shape, smallest first."""
    out = []
    for cs in SHARD_CLUSTERS:
        try:
            shard_plan(band, n_shards, n_local, cs)
        except ValueError:
            continue
        out.append(cs)
    return tuple(out)


def shard_capacity(device, plan: ShardPlan, two_piece: bool) -> int:
    """Clusters of the sharded mode at `plan` that can be resident at once on
    one device (cudaOccupancyMaxActiveClusters; needs the card).  Every
    cluster of a pair spins on its neighbours, so a launch may not exceed it."""
    clusters = ctypes.c_int()
    device = torch.device(device)
    # the library sets the thread's current device; torch restores its own on exit
    with torch.cuda.device(device):
        err = _library().nw_sweep_shard_capacity(torch.cuda.current_device(), int(two_piece), plan.lanes,
                                                 plan.cluster, plan.threads, plan.smem_bytes,
                                                 ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"nw_sweep_shard occupancy query failed with CUDA error {err}")
    return clusters.value


def pick_shard_plan(device, band: int, n_shards: int, n_local: int, B: int, two_piece: bool,
                    cluster: int | None = None) -> ShardPlan:
    """The plan of the largest cluster size (or of `cluster`) whose B x
    clusters clusters are all resident at once on `device`; raises
    RuntimeError where none is (needs the card)."""
    sizes = (cluster,) if cluster is not None else shard_cluster_sizes(band, n_shards, n_local)[::-1]
    held = {}
    for cs in sizes:
        plan = shard_plan(band, n_shards, n_local, cs)
        held[cs] = shard_capacity(device, plan, two_piece)
        if B * plan.clusters <= held[cs]:
            return plan
    raise RuntimeError(f"the sharded sweep of {B} pairs finds no cluster size whose clusters are all resident "
                       f"on {device}: resident clusters by size {held} ({n_local} of {n_shards} shards, band "
                       f"{band + 1})")


def _sharded_launch(devices, Q, T, qlens, tlens, *, cluster, mismatch, o1, e1, o2, e2, band, tmax):
    D = len(devices)
    B, Lq = Q.shape
    Lt = T.shape[1]
    W = band + 1
    Wl = W // D
    t_total = sharded_rows(band, tmax)
    two = o2 >= 0
    # the shards of each device, which must be consecutive (one launch a device)
    groups: dict[torch.device, list[int]] = {}
    for d, dev in enumerate(devices):
        groups.setdefault(dev, []).append(d)
    for dev, ds in groups.items():
        if ds != list(range(ds[0], ds[-1] + 1)):
            raise ValueError(f"the shards of {dev} must be consecutive, got {ds}")
    if len(groups) > 1:
        for a in groups:
            for b in groups:
                if a != b and not torch.cuda.can_device_access_peer(a, b):
                    raise RuntimeError(f"{a} cannot access {b}'s memory: the sharded sweep needs peer access")
    plans = {dev: pick_shard_plan(dev, band, D, len(ds), B, two, cluster) for dev, ds in groups.items()}
    lib = _library()
    # the band's clusters in lane order; each cluster's two end records
    # [B, SHARD_REC_INTS] live on its device, zeroed before any launch starts
    gc_base, recs, ptrs = {}, {}, []
    for dev in groups:
        gc_base[dev] = len(ptrs) // 2
        recs[dev] = torch.zeros((plans[dev].clusters, 2, B, SHARD_REC_INTS), dtype=torch.int32, device=dev)
        for m in range(plans[dev].clusters):
            ptrs += [recs[dev][m, 0].data_ptr(), recs[dev][m, 1].data_ptr()]
    state = {}
    for dev, ds in groups.items():
        inputs = [x if x.device == dev else x.to(dev) for x in (Q, T, qlens, tlens)]
        table = torch.tensor(ptrs, dtype=torch.int64, device=dev)
        strips = torch.empty((len(ds), B, t_total + 1, Wl), dtype=torch.uint8, device=dev)
        scores = torch.full((B,), -1, dtype=torch.int32, device=dev)
        state[dev] = (inputs, table, strips, scores)
    if len(groups) > 1:
        for dev in groups:
            for other in groups:
                with torch.cuda.device(dev):
                    err = lib.nw_sweep_shard_peer(dev.index, other.index) if other != dev else 0
                if err != 0:
                    raise RuntimeError(f"enabling {dev}'s access to {other} failed with CUDA error {err}")
        for dev in groups:
            torch.cuda.synchronize(dev)  # every flag is zero before any block runs
    for dev, ds in groups.items():
        (Qd, Td, qd, td), table, strips, scores = state[dev]
        p = plans[dev]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.nw_sweep_shard_launch(
                Qd.data_ptr(), Td.data_ptr(), qd.data_ptr(), td.data_ptr(), scores.data_ptr(), strips.data_ptr(),
                table.data_ptr(), dev.index, int(len(groups) > 1), B, Lq, Lt, W, D, ds[0], t_total,
                mismatch, o1, e1, o2, e2, p.lanes, p.ctas_per_shard, p.cluster, p.clusters, gc_base[dev],
                len(ptrs) // 2, p.threads, p.smem_bytes, p.qring, p.tring, stream)
        if err != 0:
            raise RuntimeError(f"nw_sweep_shard launch failed with CUDA error {err}")
        LAUNCHES["nw_sweep_sharded"] += 1
    first = devices[0]
    scores = state[first][3]
    for dev in groups:
        if dev != first:
            other = state[dev][3].to(first)
            scores = torch.where(other >= 0, other, scores)
    out = []
    for d, dev in enumerate(devices):
        out.append(state[dev][2][d - groups[dev][0]])
    return scores, out


def nw_align_sharded_reference(Q, T, qlens, tlens, *, n_shards, mismatch, o1, e1, o2, e2, band, tmax):
    """Plain PyTorch version of the sharded mode, a lockstep port of the JAX
    program's per-shard function: every anti-diagonal, one step of every
    shard (the shards stacked on a leading axis), with the shifted-in
    column taken from the neighbour shard's edge lane (INF at the band's
    edges).  Same contract as nw_align_sharded, every strip on Q's device."""
    D = n_shards
    _check_sharded(Q, T, qlens, tlens, D, band, tmax)
    K = band
    W = K + 1
    Wl = W // D
    B, Lq = Q.shape
    Lt = T.shape[1]
    dev = Q.device
    i32 = torch.int32
    two = o2 >= 0
    t_total = sharded_rows(band, tmax)
    ql = qlens.to(i32)
    fin_t = ql + tlens.to(i32)

    Qp = F.pad(Q.to(i32), (1, W), value=QPAD)  # [B, Lq + 1 + W]
    Trev = F.pad(T.flip(1).to(i32), (W, W), value=TPAD)  # [B, Lt + 2W]
    lanes_g = torch.arange(W, dtype=i32, device=dev).view(D, 1, Wl)  # global lane ids
    inf = torch.full((D, B, Wl), INF, dtype=i32, device=dev)
    H0 = torch.where(lanes_g == 0, 0, inf)
    S = torch.stack([H0, inf, inf, inf, inf, inf])  # [6, D, B, Wl]
    FIN = torch.where((fin_t == 0)[None, :, None], H0, inf)
    edge = torch.full((6, 1, B, 1), INF, dtype=i32, device=dev)

    def sr6(S):
        # lane l reads lane l - 1: shard d's first lane from shard d - 1's last
        col = torch.cat([edge, S[:, :-1, :, -1:]], dim=1)
        return torch.cat([col, S[..., :-1]], dim=3)

    def sl6(S):
        # lane l reads lane l + 1: shard d's last lane from shard d + 1's first
        col = torch.cat([S[:, 1:, :, :1], edge], dim=1)
        return torch.cat([S[..., 1:], col], dim=3)

    def shards(x):  # [B, W] -> [D, B, Wl]
        return x.view(B, D, Wl).transpose(0, 1)

    def qwin_at(i0):
        start = min(max(i0, 0), Lq + 1)
        return shards(Qp[:, start : start + W])

    def twin_at(t, i0):
        start = min(max(Lt - t + i0 + W, 0), Lt + W)
        return shards(Trev[:, start : start + W])

    false = torch.zeros((D, B, Wl), dtype=torch.bool, device=dev)

    def compute_row(deps, sub):
        h_up, h_left, h_diag, i1_up, d1_left, i2_up, d2_left = deps
        a, c = h_up + (o1 + e1), i1_up + e1
        I1n, i1_opened = torch.minimum(a, c), a <= c
        a, c = h_left + (o1 + e1), d1_left + e1
        D1n, d1_opened = torch.minimum(a, c), a <= c
        if two:
            a, c = h_up + (o2 + e2), i2_up + e2
            I2n, i2_opened = torch.minimum(a, c), a <= c
            a, c = h_left + (o2 + e2), d2_left + e2
            D2n, d2_opened = torch.minimum(a, c), a <= c
        else:
            I2n, D2n, i2_opened, d2_opened = inf, inf, false, false
        # strict '<' in the order D1, I1, D2, I2: a tie keeps the earlier choice
        Hn = h_diag + sub
        choice = torch.zeros((D, B, Wl), dtype=torch.uint8, device=dev)
        for cand, tag in ((D1n, H_D1), (I1n, H_I1), (D2n, H_D2), (I2n, H_I2)):
            choice.masked_fill_(cand < Hn, tag)
            Hn = torch.minimum(Hn, cand)
        packed = (choice | (i1_opened.to(torch.uint8) << 3) | (i2_opened.to(torch.uint8) << 4)
                  | (d1_opened.to(torch.uint8) << 5) | (d2_opened.to(torch.uint8) << 6))
        return Hn, I1n, D1n, I2n, D2n, packed

    tb = torch.zeros((D, B, t_total + 1, Wl), dtype=torch.uint8, device=dev)

    def step(S, FIN, t, deps, qwin, i0):
        sub = (qwin != twin_at(t, i0)).to(i32) * mismatch
        Hn, I1n, D1n, I2n, D2n, packed = compute_row(deps, sub)
        tb[:, :, t, :] = packed
        FIN = torch.where((fin_t == t)[None, :, None], Hn, FIN)
        return torch.stack([Hn, S[0], I1n, D1n, I2n, D2n]), FIN

    # phase A: t in [1, TA], i0 = 0
    ta = min(K, tmax)
    qwin_a = qwin_at(0)
    for t in range(1, ta + 1):
        R = sr6(S)
        S, FIN = step(S, FIN, t, (R[0], S[0], R[1], R[2], S[3], R[4], S[5]), qwin_a, 0)
    # phase B: macro-steps of a dp = 1 row (from the right) and a dp = 0 row
    for m in range(max(0, -(-(tmax - ta) // 2))):
        t1 = ta + 1 + 2 * m
        i0 = (t1 - K + 1) // 2
        qwin = qwin_at(i0)
        L = sl6(S)
        S, FIN = step(S, FIN, t1, (S[0], L[0], S[1], S[2], L[3], S[4], L[5]), qwin, i0)
        R = sr6(S)
        S, FIN = step(S, FIN, t1 + 1, (R[0], S[0], S[1], R[2], S[3], R[4], S[5]), qwin, i0)

    # each pair's score sits at its final lane, in exactly one shard
    i0_fin = torch.clamp(torch.div(fin_t - K + 1, 2, rounding_mode="floor"), min=0)
    fin_lane = ql - i0_fin
    fin_val = torch.where(lanes_g == fin_lane[None, :, None], FIN, INF).amin(dim=(0, 2))
    finished = (fin_t <= t_total) & (fin_val < INF)
    scores = torch.where(finished, fin_val, -1).to(i32)
    return scores, list(tb.unbind(0))
