"""ctypes loader for the port's host library (``csrc/seqrush_native.cpp``):
the FASTA parser (``parse_fasta_native``, which ``sequences.load_fasta``
takes first), the pipeline's bulk unite (``uf_unite_bulk_native``), the
wavefront route's backtrace (``backtrace_native``), the host walk of a
packed banded traceback (``nw_traceback_native``), the anchor chaining
(``chain_anchors_native``; ``chain_pairs_native`` over many pairs), the
exact host window DP (``window_dp_native``) of the anchored wide route and
the sweepga backend, and the sweepga backend's record stitch
(``stitch_records_native``).  Each has the JAX package's signature and
return contract.

Penalties come in one form, the dict of ``ops/wfa.py::Penalties.
kernel_kwargs`` (mismatch, o1, e1, o2, e2; o2 < 0: one-piece), which the
kernels take too.

The library is compiled with ``g++`` at first use into
``build/seqrush_tpu_torch/`` at the repository root, under a file name that
carries a hash of the source and the flags, so an edit rebuilds.  Each
process compiles into a file of its own and renames it into place, so
concurrent first uses (test workers) do not race.  A failed build or load
raises, and no caller falls back to Python: the anchored route's host DP
and the device walk may break equal-score ties differently, and the Python
FASTA loop reads some files differently from the C++ parser (blanks after
'>', a vertical tab or form feed on a sequence line, a header line past
65,535 bytes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "seqrush_native.cpp"
# -ffp-contract=off: chain scores are sums of doubles; a fused multiply-add
# on one host and not on another could change an argmax
_CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")
_CXX = "g++"

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def _build_dir() -> Path:
    return Path(__file__).resolve().parents[1] / "build" / "seqrush_tpu_torch"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join((_CXX, *_CXX_FLAGS)).encode())
    out_dir = _build_dir()
    lib_path = out_dir / f"libseqrush_native-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{lib_path.stem}-{os.getpid()}-{threading.get_ident()}.so"
    try:
        proc = subprocess.run(
            [_CXX, *_CXX_FLAGS, str(_SRC), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300,
        )
    except OSError as exc:
        raise RuntimeError(f"cannot run {_CXX} to build {_SRC.name}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{_CXX} failed to build {_SRC.name}:\n{proc.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use (raises if it cannot be)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, i32 = ctypes.c_int64, ctypes.c_int32
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i16p = ctypes.POINTER(ctypes.c_int16)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.fasta_stat.argtypes = [ctypes.c_char_p, i64p, i64p, i64p]
            lib.fasta_stat.restype = i64
            lib.fasta_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p, i64p, u8p, i64p]
            lib.fasta_parse.restype = i64
            lib.uf_unite_bulk.argtypes = [i32p, i64, i32p, i32p, i64]
            lib.uf_unite_bulk.restype = None
            lib.uf_compress.argtypes = [i32p, i64]
            lib.uf_compress.restype = None
            lib.wfa_backtrace.argtypes = [i16p] * 5 + [i64, i64] + [i32] * 9 + [u8p]
            lib.wfa_backtrace.restype = i64
            lib.nw_traceback.argtypes = [u8p, i64, i64, i32, i32, i32, u8p]
            lib.nw_traceback.restype = i64
            lib.chain_anchors.argtypes = [i64p, i64p, i64, i64, i64, i64, i64p]
            lib.chain_anchors.restype = i64
            lib.chain_pairs.argtypes = [i64p] * 3 + [i64] * 6 + [i64p] * 5
            lib.chain_pairs.restype = i64
            lib.window_dp.argtypes = [
                u8p, i64p, u8p, i64p, i64, i32, i32, i32, i32, i32, i64,
                i32p, i64p, u8p, i32p, i64p,
            ]
            lib.window_dp.restype = i64
            lib.stitch_records.argtypes = [
                i64p, i64p, i64p, i64p, i64, u8p, i32p, i64p, i64p, i64,
                i32, i32, i32, i32, i32, u8p, i32p, i64p, i64p,
            ]
            lib.stitch_records.restype = i64
            _lib = lib
        return _lib


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i16p(a: np.ndarray | None):
    if a is None:
        return ctypes.cast(None, ctypes.POINTER(ctypes.c_int16))
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _run_length(ops: np.ndarray) -> list[tuple[int, str]]:
    """One op character a step (uint8) -> run-length (count, op) items."""
    if not ops.size:
        return []
    starts = np.flatnonzero(np.concatenate(([True], ops[1:] != ops[:-1])))
    counts = np.diff(np.append(starts, ops.size))
    return list(zip(counts.tolist(), ops[starts].tobytes().decode()))


def parse_fasta_native(path: str) -> list[tuple[str, bytes]]:
    """(name, bases) of every record of a FASTA file, read by the C++
    parser.  Raises OSError if the file cannot be read, UnicodeDecodeError
    for a name that is not UTF-8."""
    lib = get_lib()
    n, total, nlen = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    if lib.fasta_stat(path.encode(), ctypes.byref(n), ctypes.byref(total), ctypes.byref(nlen)) != 0:
        raise OSError(f"cannot read {path}")
    n_seqs = n.value
    names = ctypes.create_string_buffer(max(nlen.value, 1))
    name_offs = np.zeros(max(n_seqs, 1), dtype=np.int64)
    data = np.zeros(max(total.value, 1), dtype=np.uint8)
    seq_offs = np.zeros(max(n_seqs, 1), dtype=np.int64)
    got = lib.fasta_parse(path.encode(), names, _i64p(name_offs), _u8p(data), _i64p(seq_offs))
    if got != n_seqs:
        raise RuntimeError("fasta parse inconsistency")
    out = []
    nprev = dprev = 0
    raw_names = names.raw
    for k in range(n_seqs):
        out.append((raw_names[nprev : name_offs[k]].decode(), data[dprev : seq_offs[k]].tobytes()))
        nprev, dprev = int(name_offs[k]), int(seq_offs[k])
    return out


def uf_unite_bulk_native(parent: np.ndarray, u: np.ndarray, v: np.ndarray) -> None:
    """Unite every (u[i], v[i]) in order, then compress fully: afterwards
    parent[i] is the minimum element of i's component.  In place when
    ``parent`` is a contiguous int32 array (the caller's array is otherwise
    left unchanged); u and v are cast to int32."""
    if parent.size >= 2**31:
        raise ValueError("union-find capacity must fit int32")
    lib = get_lib()
    parent = np.ascontiguousarray(parent, dtype=np.int32)
    u = np.ascontiguousarray(u, dtype=np.int32)
    v = np.ascontiguousarray(v, dtype=np.int32)
    lib.uf_unite_bulk(_i32p(parent), parent.size, _i32p(u), _i32p(v), u.size)
    lib.uf_compress(_i32p(parent), parent.size)


def backtrace_native(
    hist: dict[str, np.ndarray],
    score: int,
    qlen: int,
    tlen: int,
    band: int,
    mismatch: int,
    o1: int,
    e1: int,
    o2: int,
    e2: int,
) -> list[tuple[int, str]] | None:
    """The wavefront route's backtrace in C++ (ops/wfa.py::backtrace_pair's
    tie order) from one pair's int16 history ([rows, NDIAG] by name; I2 and
    D2 only when two-piece): run-length CIGAR items, or None when the
    history is inconsistent."""
    lib = get_lib()
    HM = np.ascontiguousarray(hist["M"], dtype=np.int16)
    HI1 = np.ascontiguousarray(hist["I1"], dtype=np.int16)
    HD1 = np.ascontiguousarray(hist["D1"], dtype=np.int16)
    HI2 = np.ascontiguousarray(hist["I2"], dtype=np.int16) if "I2" in hist else None
    HD2 = np.ascontiguousarray(hist["D2"], dtype=np.int16) if "D2" in hist else None
    if any(h is not None and h.shape != HM.shape for h in (HI1, HD1, HI2, HD2)):
        raise ValueError("the history arrays must share one [rows, NDIAG] shape")
    srows, ndiag = HM.shape
    out = np.zeros(qlen + tlen + 2, dtype=np.uint8)
    n = lib.wfa_backtrace(
        _i16p(HM), _i16p(HI1), _i16p(HD1), _i16p(HI2), _i16p(HD2), srows, ndiag,
        score, qlen, tlen, band, mismatch, o1, e1,
        o2 if HI2 is not None else -1, e2 if HI2 is not None else -1, _u8p(out),
    )
    if n < 0:
        return None
    return _run_length(out[:n])


def nw_traceback_native(tb: np.ndarray, qlen: int, tlen: int, band: int) -> list[tuple[int, str]] | None:
    """The host walk of one pair's packed traceback [T + 1, W] in C++
    (ops/nw.py::traceback_pair): run-length items with 'M' for a diagonal
    step (resolve_matches splits it), or None when the walk leaves the band
    or meets an invalid cell."""
    lib = get_lib()
    tb = np.ascontiguousarray(tb, dtype=np.uint8)
    rows, W = tb.shape
    out = np.zeros(qlen + tlen + 2, dtype=np.uint8)
    n = lib.nw_traceback(_u8p(tb), rows, W, qlen, tlen, band, _u8p(out))
    if n < 0:
        return None
    return _run_length(out[:n])


def chain_anchors_native(a_sorted: np.ndarray, k: int, max_gap: int, max_skew: int) -> np.ndarray | None:
    """The colinear-chaining DP in C++ (ops/anchors.py::chain_anchors' 64-
    anchor lookback, the same arithmetic and first-max ties) over (q, t)-
    sorted anchors [n, 2]: the best chain's row indices, ascending."""
    lib = get_lib()
    n = a_sorted.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    qs = np.ascontiguousarray(a_sorted[:, 0], dtype=np.int64)
    ts = np.ascontiguousarray(a_sorted[:, 1], dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    m = lib.chain_anchors(_i64p(qs), _i64p(ts), n, k, max_gap, max_skew, _i64p(out))
    if m < 0:
        return None
    return out[:m]


def chain_pairs_native(
    qs: np.ndarray,
    ts: np.ndarray,
    offs: np.ndarray,
    k: int,
    max_gap: int,
    max_skew: int,
    max_chains: int,
    min_matched: int,
):
    """Batched chain extraction and run merging for all pairs in one C++
    call (bit-identical to ops/anchors.py chain_anchors + chain_to_runs per
    pair when max_chains is 1).  qs/ts are all pairs' anchors concatenated,
    each pair's block sorted by (q, t); offs [P+1] delimits pairs.
    Returns (chain_pair [C], chain_off [C+1], runs_q, runs_t, runs_len)."""
    lib = get_lib()
    n = int(qs.size)
    n_pairs = int(offs.size) - 1
    qs = np.ascontiguousarray(qs, dtype=np.int64)
    ts = np.ascontiguousarray(ts, dtype=np.int64)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    runs_q = np.zeros(max(n, 1), dtype=np.int64)
    runs_t = np.zeros(max(n, 1), dtype=np.int64)
    runs_len = np.zeros(max(n, 1), dtype=np.int64)
    cap_chains = max(n_pairs * max_chains, 1)
    chain_pair = np.zeros(cap_chains, dtype=np.int64)
    chain_off = np.zeros(cap_chains + 1, dtype=np.int64)
    c = lib.chain_pairs(
        _i64p(qs), _i64p(ts), _i64p(offs), n_pairs, k, max_gap, max_skew,
        max_chains, min_matched,
        _i64p(runs_q), _i64p(runs_t), _i64p(runs_len), _i64p(chain_pair), _i64p(chain_off),
    )
    nr = int(chain_off[c])
    return chain_pair[:c], chain_off[: c + 1], runs_q[:nr], runs_t[:nr], runs_len[:nr]


_OP_CHARS = ("=", "X", "I", "D")


def window_dp_native(qs: list[np.ndarray], ts: list[np.ndarray], pen: dict, threads: int = 8,
                     flat: bool = False):
    """Batched exact two-piece-affine window DP on the host (C++, threaded).

    ``pen`` holds mismatch, o1, e1, o2, e2 (o2 < 0: one-piece).  Scores are
    the exact global optima; CIGARs follow the kernels' walk-order tie
    preference (diag, D1, I1, D2, I2).  Returns (scores [n] int64, items:
    one run-length list of (length, op) per window).  With ``flat=True`` the
    items stay flat arrays, (scores, ops [uint8], lens [int32], counts [n],
    item_offs [n+1]): window w's items are ops/lens[item_offs[w] ..
    item_offs[w] + counts[w]), for stitch_records_native."""
    lib = get_lib()
    n = len(qs)
    if n == 0:
        if flat:
            return (np.zeros(0, np.int64), np.zeros(0, np.uint8), np.zeros(0, np.int32),
                    np.zeros(0, np.int64), np.zeros(1, np.int64))
        return np.zeros(0, np.int64), []
    qoffs = np.zeros(n + 1, np.int64)
    toffs = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter((q.size for q in qs), np.int64, n), out=qoffs[1:])
    np.cumsum(np.fromiter((t.size for t in ts), np.int64, n), out=toffs[1:])
    qbuf = np.ascontiguousarray(
        (np.concatenate(qs) if qoffs[-1] else np.zeros(1, np.uint8)).astype(np.uint8, copy=False)
    )
    tbuf = np.ascontiguousarray(
        (np.concatenate(ts) if toffs[-1] else np.zeros(1, np.uint8)).astype(np.uint8, copy=False)
    )
    caps = (qoffs[1:] - qoffs[:-1]) + (toffs[1:] - toffs[:-1]) + 1
    item_offs = np.zeros(n + 1, np.int64)
    item_offs[1:] = np.cumsum(caps)
    scores = np.zeros(n, np.int32)
    ops = np.zeros(max(int(item_offs[-1]), 1), np.uint8)
    lens = np.zeros(max(int(item_offs[-1]), 1), np.int32)
    counts = np.zeros(n, np.int64)
    lib.window_dp(
        _u8p(qbuf), _i64p(qoffs), _u8p(tbuf), _i64p(toffs), n,
        pen["mismatch"], pen["o1"], pen["e1"], pen["o2"], pen["e2"], threads,
        _i32p(scores), _i64p(item_offs), _u8p(ops), _i32p(lens), _i64p(counts),
    )
    if flat:
        return scores.astype(np.int64), ops, lens, counts, item_offs
    # gather the used (op, len) entries flat, decode the ops in one take,
    # then slice per window
    total = int(counts.sum())
    if total:
        flat = (
            np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(counts) - counts, counts)
            + np.repeat(item_offs[:-1], counts)
        )
        pairs_flat = list(zip(lens[flat].tolist(), np.take(np.array(_OP_CHARS), ops[flat]).tolist()))
    else:
        pairs_flat = []
    bounds = np.cumsum(counts).tolist()
    items = [pairs_flat[a:b] for a, b in zip([0] + bounds[:-1], bounds)]
    return scores.astype(np.int64), items


def stitch_records_native(
    runs_q: np.ndarray,
    runs_t: np.ndarray,
    runs_len: np.ndarray,
    rec_off: np.ndarray,
    gap_ops: np.ndarray,
    gap_lens: np.ndarray,
    gap_off: np.ndarray,
    gap_ids: np.ndarray,
    pen: dict,
):
    """Assemble per-record run-length CIGARs from chain runs and gap fills
    in one C++ call (the sweepga backend's stage 3; bit-identical to
    SweepAligner._stitch_python).  Record r owns the flat runs
    [rec_off[r], rec_off[r+1]); gap g is the gap after flat run gap_ids[g]
    (ascending), with items gap_ops/gap_lens[gap_off[g] .. gap_off[g+1]);
    ops are 0 '=', 1 'X', 2 'I', 3 'D'.  ``pen`` as for window_dp_native.

    Returns (ops [uint8], lens [int32], out_off [R+1], scores [R] int64)."""
    lib = get_lib()
    R = int(rec_off.size) - 1
    nr = int(rec_off[-1])
    G = int(gap_ids.size)
    cap = 3 * max(nr, 1) + int(gap_off[-1]) + 8
    runs_q = np.ascontiguousarray(runs_q, dtype=np.int64)
    runs_t = np.ascontiguousarray(runs_t, dtype=np.int64)
    runs_len = np.ascontiguousarray(runs_len, dtype=np.int64)
    rec_off = np.ascontiguousarray(rec_off, dtype=np.int64)
    gap_ops = np.ascontiguousarray(gap_ops, dtype=np.uint8)
    gap_lens = np.ascontiguousarray(gap_lens, dtype=np.int32)
    gap_off = np.ascontiguousarray(gap_off, dtype=np.int64)
    gap_ids = np.ascontiguousarray(gap_ids, dtype=np.int64)
    out_ops = np.zeros(cap, np.uint8)
    out_lens = np.zeros(cap, np.int32)
    out_off = np.zeros(R + 1, np.int64)
    out_scores = np.zeros(max(R, 1), np.int64)
    total = lib.stitch_records(
        _i64p(runs_q), _i64p(runs_t), _i64p(runs_len), _i64p(rec_off), R,
        _u8p(gap_ops), _i32p(gap_lens), _i64p(gap_off), _i64p(gap_ids), G,
        pen["mismatch"], pen["o1"], pen["e1"], pen["o2"], pen["e2"],
        _u8p(out_ops), _i32p(out_lens), _i64p(out_off), _i64p(out_scores),
    )
    total = int(total)
    return out_ops[:total], out_lens[:total], out_off, out_scores[:R]
