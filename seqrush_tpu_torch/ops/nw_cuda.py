"""Kernels A and B of the alignment path, for Hopper, with their plain versions.

* ``nw_align`` -- kernel A, the banded two-piece Gotoh sweep
  (``csrc/nw_sweep.cu``; replaces ``seqrush_tpu/ops/nw_pallas.py::_kernel``).
  Returns scores [B] int32 and the packed traceback [B, tmax_pad, W] uint8.
* ``nw_walk`` -- kernel B, the reverse traceback walk (``csrc/nw_walk.cu``;
  replaces ``nw_pallas.py::_walk_kernel``).  Returns opcodes [B, tmax + 1]
  uint8 (0 none, 1 M, 2 I, 3 D at column td).

Each wrapper runs its plain PyTorch version (``nw_align_reference``,
``nw_walk_reference``) when the tensors lie on the CPU, and launches its CUDA
kernel when they lie on a GPU; there is no fallback between the two.  The
plain versions repeat the reference arithmetic step by step, including the
bytes written at cells outside the pair's matrix, so the traceback tensor
can be compared whole.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` from the
sources under ``csrc/`` into ``build/seqrush_tpu_torch/`` at the repository
root, one ``nvcc`` per source in parallel, and loaded with ctypes.  The file
name carries a hash of the sources and flags, so an edit rebuilds.

``LAUNCHES`` counts kernel launches (not plain-version calls) per kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from .nw import H_D1, H_D2, H_DIAG, H_I1, H_I2, INF, OP_D, OP_I, OP_M, OP_NONE, QPAD, TPAD
from .nw import _i0_of, tmax_pad_of

LAUNCHES = {"nw_sweep": 0, "nw_walk": 0}

_SOURCES = ("nw_sweep.cu", "nw_walk.cu")
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_SWEEP_ROWS = 11  # DP rows the sweep keeps per pair (see nw_sweep.cu)
# dynamic shared memory a block may opt into on H100 (sm_90); wider bands
# keep the sweep's rows in a global scratch instead
_SMEM_OPTIN_BYTES = 232448
_WALK_THREADS = 128

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


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
    for src in sources:
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
            lib.nw_sweep_launch.argtypes = [ptr] * 7 + [i32] * 12 + [ptr]
            lib.nw_sweep_launch.restype = i32
            lib.nw_walk_launch.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
            lib.nw_walk_launch.restype = i32
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


# -- kernel A: the sweep -------------------------------------------------------


def nw_align(Q, T, qlens, tlens, *, mismatch, o1, e1, o2, e2, band, tmax):
    """Banded Gotoh sweep over a batch of pairs.

    Q [B, Lq] / T [B, Lt] uint8 base codes padded with QPAD/TPAD; qlens,
    tlens [B] int32; o2 < 0 selects one-piece penalties.  Returns (scores
    [B] int32, -1 where the final cell was not reached; tb [B, tmax_pad, W]
    uint8 with rows 0 and > tmax zero)."""
    device = Q.device
    _check("Q", Q, torch.uint8, 2, device)
    _check("T", T, torch.uint8, 2, device)
    B = Q.shape[0]
    if T.shape[0] != B:
        raise ValueError("Q and T must have the same batch size")
    _check_lengths(qlens, tlens, B, device)
    if band < 0 or tmax < 0:
        raise ValueError("band and tmax must be >= 0")
    kw = dict(mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2, band=band, tmax=tmax)
    if device.type == "cpu":
        return nw_align_reference(Q, T, qlens, tlens, **kw)
    _require_cuda(device)
    W = band + 1
    tmax_pad = tmax_pad_of(tmax)
    scores = torch.empty(B, dtype=torch.int32, device=device)
    tb = torch.empty((B, tmax_pad, W), dtype=torch.uint8, device=device)
    scratch = None
    if _SWEEP_ROWS * W * 4 > _SMEM_OPTIN_BYTES:
        scratch = torch.empty(B * _SWEEP_ROWS * W, dtype=torch.int32, device=device)
    threads = min(1024, ((W + 31) // 32) * 32)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nw_sweep_launch(
            Q.data_ptr(), T.data_ptr(), qlens.data_ptr(), tlens.data_ptr(),
            scores.data_ptr(), tb.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B, Q.shape[1], T.shape[1], W, tmax, tmax_pad,
            mismatch, o1, e1, o2, e2, threads, stream,
        )
    if err != 0:
        raise RuntimeError(f"nw_sweep launch failed with CUDA error {err}")
    LAUNCHES["nw_sweep"] += 1
    return scores, tb


def _frame(x: torch.Tensor, delta: int, inf_col: torch.Tensor) -> torch.Tensor:
    """Lane l reads lane l + delta (delta in {-1, 0, 1}); INF off the band."""
    if delta == -1:
        return torch.cat([inf_col, x[:, :-1]], dim=1)
    if delta == 0:
        return x
    return torch.cat([x[:, 1:], inf_col], dim=1)


def nw_align_reference(Q, T, qlens, tlens, *, mismatch, o1, e1, o2, e2, band, tmax):
    """Plain PyTorch version of kernel A: one [B, W] step per anti-diagonal,
    the same arithmetic as nw_pallas._kernel."""
    B, Lq = Q.shape
    Lt = T.shape[1]
    K = band
    W = K + 1
    dev = Q.device
    two = o2 >= 0
    i32 = torch.int32

    Qi = F.pad(Q.to(i32), (1, W), value=QPAD)  # [B, Lq + 1 + W]
    Trev = F.pad(T.flip(1).to(i32), (W, W), value=TPAD)  # [B, Lt + 2W]
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    ql = qlens.to(i32)[:, None]
    tl = tlens.to(i32)[:, None]
    t_final = (qlens + tlens).to(i32)

    def full(val):
        return torch.full((B, W), val, dtype=i32, device=dev)

    h1 = full(INF)
    h1[:, 0] = 0
    h2 = full(INF)
    i1r, d1r, i2r, d2r = full(INF), full(INF), full(INF), full(INF)
    inf_row = full(INF)
    false_row = torch.zeros((B, W), dtype=torch.bool, device=dev)
    inf_col = torch.full((B, 1), INF, dtype=i32, device=dev)
    scores = torch.full((B,), -1, dtype=i32, device=dev)
    tb = torch.zeros((B, tmax_pad_of(tmax), W), dtype=torch.uint8, device=dev)

    for t in range(1, tmax + 1):
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
        sub = torch.where(Qi[:, qs : qs + W] == Trev[:, ts : ts + W], 0, mismatch).to(i32)

        I1n = torch.minimum(h_up + (o1 + e1), i1_up + e1)
        i1_opened = (h_up + (o1 + e1)) <= (i1_up + e1)
        D1n = torch.minimum(h_left + (o1 + e1), d1_left + e1)
        d1_opened = (h_left + (o1 + e1)) <= (d1_left + e1)
        if two:
            i2_up = _frame(i2r, dp - 1, inf_col)
            d2_left = _frame(d2r, dp, inf_col)
            I2n = torch.minimum(h_up + (o2 + e2), i2_up + e2)
            i2_opened = (h_up + (o2 + e2)) <= (i2_up + e2)
            D2n = torch.minimum(h_left + (o2 + e2), d2_left + e2)
            d2_opened = (h_left + (o2 + e2)) <= (d2_left + e2)
        else:
            I2n, D2n = inf_row, inf_row
            i2_opened, d2_opened = false_row, false_row

        Hn = h_diag + sub
        choice = torch.zeros((B, W), dtype=torch.uint8, device=dev)
        for cand, tag in ((D1n, H_D1), (I1n, H_I1), (D2n, H_D2), (I2n, H_I2)):
            better = cand < Hn
            Hn = torch.where(better, cand, Hn)
            choice = torch.where(better, tag, choice).to(torch.uint8)

        i = i0 + lanes
        j = t - i
        valid = (i >= 0) & (i <= ql) & (j >= 0) & (j <= tl)
        Hn = torch.where(valid, Hn.clamp(max=INF), INF)
        I1n = torch.where(valid, I1n.clamp(max=INF), INF)
        D1n = torch.where(valid, D1n.clamp(max=INF), INF)
        I2n = torch.where(valid, I2n.clamp(max=INF), INF)
        D2n = torch.where(valid, D2n.clamp(max=INF), INF)

        at_final = (t_final[:, None] == t) & (lanes == (ql - i0))
        fin_val = torch.where(at_final, Hn, INF).amin(dim=1)
        scores = torch.where((t_final == t) & (scores < 0) & (fin_val < INF), fin_val, scores)

        tb[:, t, :] = (
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
    return scores, tb


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
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nw_walk_launch(
            tb.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), ops.data_ptr(),
            B, W, tmax, tb.shape[1], _WALK_THREADS, stream,
        )
    if err != 0:
        raise RuntimeError(f"nw_walk launch failed with CUDA error {err}")
    LAUNCHES["nw_walk"] += 1
    return ops


def _i0_tensor(t: torch.Tensor, K: int) -> torch.Tensor:
    return torch.clamp(torch.div(t - K + 1, 2, rounding_mode="floor"), min=0)


def nw_walk_reference(tb, qlens, tlens, *, band, tmax):
    """Plain PyTorch version of kernel B: a reverse scan over every
    anti-diagonal, acting on the pairs whose cursor sits there (the
    arithmetic of nw.traceback_scan_device and nw_pallas._walk_kernel)."""
    B = tb.shape[0]
    K = band
    W = K + 1
    dev = tb.device
    i64 = torch.int64
    rows = torch.arange(B, device=dev)
    cur_t = qlens.to(i64) + tlens.to(i64)
    lane = qlens.to(i64) - _i0_tensor(cur_t, K)
    mat = torch.zeros(B, dtype=i64, device=dev)
    done = cur_t == 0
    ops = torch.zeros((B, tmax + 1), dtype=torch.uint8, device=dev)

    for td in range(tmax, 0, -1):
        active = ~done & (cur_t == td)
        in_band = (lane >= 0) & (lane < W)
        byte = tb[rows, td, lane.clamp(0, W - 1)].to(i64)
        b = torch.where(in_band, byte, 0)
        i = _i0_of(td, K) + lane
        j = td - i

        choice = b & 7
        is_h = mat == 0
        go_d1 = (is_h & (choice == H_D1)) | (mat == 1)
        go_i1 = (is_h & (choice == H_I1)) | (mat == 2)
        go_d2 = (is_h & (choice == H_D2)) | (mat == 3)
        go_i2 = (is_h & (choice == H_I2)) | (mat == 4)
        diag = is_h & (choice == H_DIAG)
        opened = torch.where(
            go_d1, (b >> 5) & 1,
            torch.where(go_i1, (b >> 3) & 1, torch.where(go_d2, (b >> 6) & 1, (b >> 4) & 1)),
        ) != 0

        gap_d = go_d1 | go_d2
        gap_i = go_i1 | go_i2
        op = torch.where(
            diag, OP_M, torch.where(gap_i, OP_I, torch.where(gap_d, OP_D, OP_NONE))
        )
        ni = torch.where(diag | gap_i, i - 1, i)
        nj = torch.where(diag | gap_d, j - 1, j)
        nmat = torch.where(
            diag | opened,
            0,
            torch.where(go_d1, 1, torch.where(go_i1, 2, torch.where(go_d2, 3, 4))),
        )
        nt = ni + nj
        nl = ni - _i0_tensor(nt, K)
        ndone = (ni == 0) & (nj == 0)

        cur_t = torch.where(active, nt, cur_t)
        lane = torch.where(active, nl, lane)
        mat = torch.where(active, nmat, mat)
        done = done | (active & ndone)
        ops[:, td] = torch.where(active, op, OP_NONE).to(torch.uint8)
    return ops
