"""Banded anti-diagonal Gotoh alignment: constants and host decode.

The port's counterpart of the host half of ``seqrush_tpu/ops/nw.py``.  The
device half (the forward sweep and the reverse traceback walk) lives in
``ops/nw_cuda.py`` as two hand-written CUDA kernels, each with its plain
PyTorch version beside it.

Geometry shared by both halves: cell (i, j) lives on anti-diagonal t = i + j
at lane l = i - i0(t), where i0(t) = max((t - K + 1) // 2, 0) anchors a band
of W = K + 1 lanes around the main diagonal.

DP (penalties, match = 0):
  H[i,j]  = min(H[i-1,j-1] + sub(i,j), I1, I2, D1, D2 at [i,j])
  I1[i,j] = min(H[i-1,j] + o1 + e1, I1[i-1,j] + e1)      (consume query)
  D1[i,j] = min(H[i,j-1] + o1 + e1, D1[i,j-1] + e1)      (consume target)
  (I2/D2 with o2/e2; o2 < 0 means one-piece penalties)

The walk emits one opcode per anti-diagonal (0 none, 1 M, 2 I, 3 D) at
column td; ``decode_batch`` turns a batch of opcode rows into run-length
CIGAR items with 'M' split into '=' / 'X' against the sequences.  In its
runs mode the walk emits run tokens instead (op | len << 2, int32, in walk
order, which is reverse alignment order; at most run_max a pair, each run
at most _RUN_LEN_MAX long) and a count of runs per pair;
``decode_runs_batch`` turns them into the same items.  The row-major walk's
steps and gap list decode with ``decode_rowtokens``, and the fold's two
half-walks merge into one opcode row with ``merge_fold_ops``.
``traceback_pair`` walks one pair's whole traceback [T + 1, W] on the host
(the band-sharded route's strips, gathered).
"""

from __future__ import annotations

import numpy as np

from .. import native

INF = 2**28  # +infinity of the int32 DP; INF + o2 + e2 stays below 2^31
QPAD = 6  # query pad code (codes 0..5 are real bases)
TPAD = 7  # target pad code, distinct so pads never match

# traceback byte layout: bits 0-2 H choice (0=match/mismatch diag, 1=D1,
# 2=I1, 3=D2, 4=I2); bit 3 I1 opened; bit 4 I2 opened; bit 5 D1 opened;
# bit 6 D2 opened
H_DIAG, H_D1, H_I1, H_D2, H_I2 = 0, 1, 2, 3, 4

OP_NONE, OP_M, OP_I, OP_D = 0, 1, 2, 3

TB_CHUNK = 128  # traceback rows are padded to a multiple of this

# run tokens a pair may emit in the walk's runs mode.  M runs break only at
# indels (mismatches stay inside M), so an accepted alignment has about
# 2 * indel events + 1 runs; a pair with more is retried through opcodes
# (the runner's _runs_off_set)
RUN_MAX = 128
# run lengths are capped at 14 bits a token (longer runs split into several
# tokens; decode_runs_batch merges adjacent runs of one op)
_RUN_LEN_MAX = (1 << 14) - 1


# the int16 DP: every state saturates at INF16 (+infinity of that mode), so a
# score at or above INT16_CUTOFF is unreliable and the runner re-runs the
# pair in int32
INF16 = 30000
INT16_CUTOFF = 28000

# the row-major walk's compacted gap list: D-runs a pair may report; a pair
# with more retries on the anti-diagonal kernels (the runner's _v3_set)
GAP_MAX = 160

# the bidirectional fold's crossing terms, in tie order: M from tm - 1 (E2),
# M from tm (E3), then D1, I1, D2, I2
_FOLD_E2, _FOLD_E3, _FOLD_D1, _FOLD_I1, _FOLD_D2, _FOLD_I2 = range(6)


def runs_fit(tmax: int) -> bool:
    """Whether a dispatch of tmax anti-diagonals can emit run tokens (the
    JAX package's token position field holds tmax + 4 < 2^15)."""
    return tmax + 4 < 1 << 15


def _i0_of(t: int, K: int) -> int:
    """Band anchor: first query index on anti-diagonal t."""
    return max((t - K + 1) // 2, 0)


def tmax_pad_of(tmax: int) -> int:
    """Rows of the traceback tensor: tmax + 1 rounded up to TB_CHUNK."""
    return ((tmax + 1 + TB_CHUNK - 1) // TB_CHUNK) * TB_CHUNK


def traceback_pair(tb: np.ndarray, qlen: int, tlen: int, band: int) -> list[tuple[int, str]]:
    """Decode one pair's packed traceback [T + 1, W] (anti-diagonal major)
    into run-length CIGAR items, 'M' for a diagonal step (resolve_matches
    splits it into '=' / 'X').  The host library's C++ walk runs first, as
    in the JAX package; the Python body below is the specification, run
    when the C++ walk leaves the band or meets an invalid cell (it then
    raises)."""
    items = native.nw_traceback_native(tb, qlen, tlen, band)
    if items is not None:
        return items
    K = band
    W = K + 1
    ops: list[str] = []
    i, j = qlen, tlen
    state = "H"
    while i > 0 or j > 0:
        t = i + j
        lane = i - _i0_of(t, K)
        if not 0 <= lane < W:
            # an out-of-band walk means a corrupted traceback
            raise AssertionError(f"traceback escaped the band at t={t} (lane {lane}, W={W})")
        b = int(tb[t, lane])
        if state == "H":
            choice = b & 7
            if choice == H_DIAG:
                ops.append("M")
                i -= 1
                j -= 1
            elif choice == H_D1:
                state = "D1"
            elif choice == H_I1:
                state = "I1"
            elif choice == H_D2:
                state = "D2"
            elif choice == H_I2:
                state = "I2"
            else:
                raise AssertionError("invalid traceback cell")
        elif state in ("I1", "I2"):
            opened = bool(b & (8 if state == "I1" else 16))
            ops.append("I")
            i -= 1
            if opened:
                state = "H"
        else:  # D1 / D2
            opened = bool(b & (32 if state == "D1" else 64))
            ops.append("D")
            j -= 1
            if opened:
                state = "H"
    ops.reverse()
    out: list[tuple[int, str]] = []
    for op in ops:
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + 1, op)
        else:
            out.append((1, op))
    return out


def resolve_matches(
    items: list[tuple[int, str]], q: np.ndarray, t: np.ndarray
) -> list[tuple[int, str]]:
    """Split 'M' runs into '='/'X' by comparing bases (vectorized: the inner
    loop runs over equal/unequal segments, not bases)."""
    out: list[tuple[int, str]] = []
    qi = ti = 0
    q = np.asarray(q)
    t = np.asarray(t)

    def push(n, op):
        if n <= 0:
            return
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + n, op)
        else:
            out.append((n, op))

    for n, op in items:
        if op == "M":
            eq = q[qi : qi + n] == t[ti : ti + n]
            idx = np.flatnonzero(np.diff(eq)) + 1
            bounds = np.concatenate([[0], idx, [n]])
            for s_b, e_b in zip(bounds[:-1], bounds[1:]):
                push(int(e_b - s_b), "=" if eq[s_b] else "X")
            qi += n
            ti += n
        else:
            push(n, op)
            if op == "I":
                qi += n
            elif op == "D":
                ti += n
    return out


def unpack_opcodes(packed: np.ndarray, length: int) -> np.ndarray:
    """2-bit-packed opcodes [B, ceil(L/4)] -> [B, length] uint8."""
    packed = np.asarray(packed)
    B = packed.shape[0]
    out = np.empty((B, packed.shape[1], 4), np.uint8)
    for k in range(4):
        out[:, :, k] = (packed >> (2 * k)) & 3
    return out.reshape(B, -1)[:, :length]


def merge_fold_ops(ops2: np.ndarray, cross_m: np.ndarray) -> np.ndarray:
    """Host merge of the fold's half-walk opcode rows: [2B, L] -> [B, 2L + 1].

    Row b's merged stream is forward ops ++ [OP_M if cross_m[b]] ++
    reverse(backward ops).  Positions carry no meaning downstream
    (decode_batch drops OP_NONE), only order does."""
    ops2 = np.asarray(ops2)
    B2, L = ops2.shape
    B = B2 // 2
    out = np.zeros((B, 2 * L + 1), np.uint8)
    out[:, :L] = ops2[:B]
    out[:, L] = np.where(np.asarray(cross_m), OP_M, OP_NONE).astype(np.uint8)
    out[:, L + 1 :] = ops2[B:, ::-1]
    return out


def decode_rowtokens(
    steps_row: np.ndarray, grows: np.ndarray, gvals: np.ndarray, gcount: int, qlen: int,
) -> list[tuple[int, str]]:
    """The row-major walk's output as run-length items with 'M' placeholders
    (resolve with resolve_matches, as decode_opcodes' items).  steps_row[r]
    (r in 1..qlen) is the M/I op of row r; gap g at row r inserts g 'D's
    after row r's step (before everything for r = 0)."""
    items: list[tuple[int, str]] = []
    steps = np.asarray(steps_row)
    syms = np.array([0, ord("M"), ord("I"), 0], dtype=np.uint8)

    def emit_steps(lo, hi):
        if hi < lo:
            return
        seg = syms[steps[lo : hi + 1]]
        if seg.size == 0:
            return
        change = np.empty(seg.size, dtype=bool)
        change[0] = True
        change[1:] = seg[1:] != seg[:-1]
        starts = np.nonzero(change)[0]
        ends = np.append(starts[1:], seg.size)
        for s, e in zip(starts, ends):
            if seg[s]:
                items.append((int(e - s), chr(seg[s])))

    pos = 1
    for k in range(int(gcount)):
        r = int(grows[k])
        g = int(gvals[k])
        if r < 0:
            break
        if r >= pos:
            emit_steps(pos, min(r, qlen))
            pos = r + 1
        if items and items[-1][1] == "D":
            items[-1] = (items[-1][0] + g, "D")
        else:
            items.append((g, "D"))
    emit_steps(pos, qlen)
    return items


def decode_opcodes(op_row: np.ndarray) -> list[tuple[int, str]]:
    """[tmax+1] opcodes -> run-length items with 'M' placeholders (ascending
    t = forward sequence order); resolve with resolve_matches()."""
    codes = np.asarray(op_row)
    nz = codes[codes != OP_NONE]
    if nz.size == 0:
        return []
    syms = np.array([0, ord("M"), ord("I"), ord("D")], dtype=np.uint8)[nz]
    change = np.empty(nz.size, dtype=bool)
    change[0] = True
    change[1:] = syms[1:] != syms[:-1]
    starts = np.nonzero(change)[0]
    ends = np.append(starts[1:], nz.size)
    return [(int(e - s), chr(syms[s])) for s, e in zip(starts, ends)]


_SYM_CHARS = ("", "=", "X", "I", "D")


def decode_batch(
    ops: np.ndarray,
    qs: list[np.ndarray],
    ts: list[np.ndarray],
) -> list[list[tuple[int, str]]]:
    """Whole-batch equivalent of per-pair decode_opcodes + resolve_matches.

    ops [B, L] uint8 (0 none, 1 M, 2 I, 3 D) in ascending anti-diagonal
    order; qs/ts are the per-row base-code arrays.  Returns one run-length
    CIGAR item list per row with 'M' already split into '='/'X'.  Cursor
    positions come from two cumsums, the M-step base comparison is one
    gather, and run boundaries fall out of one RLE over the flattened symbol
    stream (rows separated by sentinel tokens).
    """
    ops = np.asarray(ops)
    B, L = ops.shape
    if B == 0:
        return []
    Lq = max(1, max(q.size for q in qs))
    Lt = max(1, max(t.size for t in ts))
    # distinct pads: an M step beyond either sequence (cannot happen for a
    # valid walk) decodes as 'X', never a fabricated '='
    Qh = np.full((B, Lq), 254, np.uint8)
    Th = np.full((B, Lt), 255, np.uint8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        Qh[b, : q.size] = q
        Th[b, : t.size] = t

    is_m = ops == OP_M
    qcons = is_m | (ops == OP_I)
    tcons = is_m | (ops == OP_D)
    # index of the query/target base consumed at each step (0-based)
    qpos = np.cumsum(qcons, axis=1, dtype=np.int32)
    np.subtract(qpos, qcons, out=qpos)
    tpos = np.cumsum(tcons, axis=1, dtype=np.int32)
    np.subtract(tpos, tcons, out=tpos)

    # symbol codes: 0 none, 1 '=', 2 'X', 3 'I', 4 'D'  (see _SYM_CHARS)
    sym = np.zeros((B, L), np.uint8)
    bm, lm = np.nonzero(is_m)
    if bm.size:
        eq = Qh[bm, np.minimum(qpos[bm, lm], Lq - 1)] == Th[
            bm, np.minimum(tpos[bm, lm], Lt - 1)
        ]
        sym[bm, lm] = np.where(eq, 1, 2).astype(np.uint8)
    sym[ops == OP_I] = 3
    sym[ops == OP_D] = 4

    # flatten with per-row sentinel breaks, drop inactive steps, RLE
    flat = np.concatenate([np.full((B, 1), 5, np.uint8), sym], axis=1).ravel()
    keep = flat != 0
    comp = flat[keep]
    rowid = np.repeat(np.arange(B, dtype=np.int32), L + 1)[keep]
    change = np.empty(comp.size, dtype=bool)
    change[0] = True
    change[1:] = comp[1:] != comp[:-1]
    starts = np.flatnonzero(change)
    lengths = np.diff(np.append(starts, comp.size))
    vals = comp[starts]
    rows = rowid[starts]

    out: list[list[tuple[int, str]]] = [[] for _ in range(B)]
    for r, v, n in zip(rows.tolist(), vals.tolist(), lengths.tolist()):
        if v == 5:
            continue
        out[r].append((int(n), _SYM_CHARS[v]))
    return out


def decode_runs_batch(
    tokens: np.ndarray,
    counts: np.ndarray,
    qs: list[np.ndarray],
    ts: list[np.ndarray],
) -> list[list[tuple[int, str]]]:
    """Decode run tokens (nw_cuda.nw_walk_runs) into per-pair run-length CIGAR
    item lists with 'M' split into '='/'X' — the decode_batch output
    contract, at run granularity instead of step granularity.

    Cursor positions are two [B, RUN_MAX] cumsums (walk order = from the
    alignment's end, so starts come from suffix arithmetic), the M-run base
    comparison is one flat gather over all M bases, and '='/'X' boundaries
    fall out of one RLE with forced breaks at M-run starts.  Rows with
    counts > RUN_MAX are truncated on device — callers must not pass them
    here (the runner retries them through the opcode walk)."""
    tokens = np.asarray(tokens)
    counts = np.asarray(counts)
    B, R = tokens.shape
    if B == 0:
        return []
    syms = (tokens & 3).astype(np.int8)
    lens = (tokens >> 2).astype(np.int64)
    r_idx = np.arange(R, dtype=np.int64)[None, :]
    valid = (r_idx < np.minimum(counts, R)[:, None]) & (lens > 0)
    lens = np.where(valid, lens, 0)
    is_m = valid & (syms == OP_M)
    qc = np.where(valid & ((syms == OP_M) | (syms == OP_I)), lens, 0)
    tc = np.where(valid & ((syms == OP_M) | (syms == OP_D)), lens, 0)
    q_after = np.cumsum(qc, axis=1) - qc  # query bases consumed AFTER a run
    t_after = np.cumsum(tc, axis=1) - tc
    qlens = np.array([q.size for q in qs], dtype=np.int64)
    tlens = np.array([t.size for t in ts], dtype=np.int64)
    q0 = qlens[:, None] - q_after - qc  # run start (consuming runs only)
    t0 = tlens[:, None] - t_after - tc

    # one flat base comparison over every M base in the batch
    bm, rm = np.nonzero(is_m)  # row-major: walk order within each row
    n_mruns = bm.size
    seg_bound = np.zeros(1, dtype=np.int64)
    seg_lens = seg_eq = None
    gmap = np.full((B, R), -1, dtype=np.int64)
    if n_mruns:
        gmap[bm, rm] = np.arange(n_mruns)
        mlen = lens[bm, rm]
        ends = np.cumsum(mlen)
        starts_flat = ends - mlen
        total = int(ends[-1])
        offs = np.arange(total, dtype=np.int64) - np.repeat(starts_flat, mlen)
        qi = np.repeat(q0[bm, rm], mlen) + offs
        ti = np.repeat(t0[bm, rm], mlen) + offs
        rowrep = np.repeat(bm, mlen)
        Lq = max(1, int(qlens.max()))
        Lt = max(1, int(tlens.max()))
        # distinct pads: an out-of-range M base decodes as 'X', never '='
        Qh = np.full((B, Lq), 254, np.uint8)
        Th = np.full((B, Lt), 255, np.uint8)
        for b, (q, t) in enumerate(zip(qs, ts)):
            Qh[b, : q.size] = q
            Th[b, : t.size] = t
        eq = Qh[rowrep, np.clip(qi, 0, Lq - 1)] == Th[rowrep, np.clip(ti, 0, Lt - 1)]
        change = np.empty(total, dtype=bool)
        change[0] = True
        change[1:] = eq[1:] != eq[:-1]
        change[starts_flat] = True  # segment breaks at every M-run start
        seg_starts = np.flatnonzero(change)
        seg_lens = np.diff(np.append(seg_starts, total))
        seg_eq = eq[seg_starts]
        seg_mrun = np.searchsorted(ends, seg_starts, side="right")
        seg_bound = np.searchsorted(seg_mrun, np.arange(n_mruns + 1))

    # final assembly: a plain Python loop over pre-extracted lists (tolist()
    # beats repeated numpy scalar indexing)
    syms_l = syms.tolist()
    lens_l = lens.tolist()
    gmap_l = gmap.tolist()
    cnt_l = np.minimum(counts, R).tolist()
    seg_bound_l = seg_bound.tolist()
    seg_lens_l = seg_lens.tolist() if seg_lens is not None else []
    seg_eq_l = seg_eq.tolist() if seg_eq is not None else []
    out: list[list[tuple[int, str]]] = []
    for b in range(B):
        items: list[tuple[int, str]] = []
        append = items.append
        sb = syms_l[b]
        lb = lens_l[b]
        gb = gmap_l[b]
        last_n = 0
        last_op = ""
        for r in range(cnt_l[b] - 1, -1, -1):  # reverse walk = fwd order
            n = lb[r]
            if n <= 0:
                continue
            s = sb[r]
            if s == OP_M:
                g = gb[r]
                for si in range(seg_bound_l[g], seg_bound_l[g + 1]):
                    op = "=" if seg_eq_l[si] else "X"
                    nn = seg_lens_l[si]
                    if op == last_op:
                        last_n += nn
                    else:
                        if last_n:
                            append((last_n, last_op))
                        last_n, last_op = nn, op
            else:
                op = "I" if s == OP_I else "D"
                if op == last_op:
                    last_n += n
                else:
                    if last_n:
                        append((last_n, last_op))
                    last_n, last_op = n, op
        if last_n:
            append((last_n, last_op))
        out.append(items)
    return out
