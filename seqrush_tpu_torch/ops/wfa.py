"""The batched wavefront aligner (WFA): gap penalties, the kernel, its
backtrace and the CIGAR helpers.

The port of ``seqrush_tpu/ops/wfa.py``.  ``wfa_align_device`` runs a batch
of pairs through the wavefront recurrences with two-piece (or one-piece)
gap-affine penalties, each pair up to its score cap: on a CUDA tensor it
launches the hand-written kernel of ``csrc/wfa.cu`` (built with the other
kernels by ``nw_cuda.build``), on a CPU tensor it runs the plain version
``wfa_align_reference``.  ``backtrace_pair`` reads one pair's CIGAR from the
wavefront history on the host.

Conventions (the reference's post-conversion CIGAR): query = pattern (v),
target = text (h); diagonal k = h - v; offset = h.  'I' consumes the query
only, 'D' the target only, '=' a match, 'X' a mismatch.

Recurrences (scores are penalties, match = 0):
  D1[s,k] = max(M[s-o1-e1, k-1], D1[s-e1, k-1]) + 1      (consume target)
  I1[s,k] = max(M[s-o1-e1, k+1], I1[s-e1, k+1])          (consume query)
  (D2/I2 with o2/e2)
  M[s,k] = max(M[s-x, k] + 1, I1, I2, D1, D2), then the greedy extension.
A pair ends the first time M[s, tlen - qlen] == tlen.  Diagonals are
restricted to |k| <= band; callers size the band from the length difference
and an indel allowance.

``Penalties.kernel_kwargs`` is the one conversion to the penalty dict the
kernels (``nw_cuda.nw_align``, ``wfa_align_device``) and the host library
(``native.window_dp_native``) take.  ``affine2p_score_dp`` is the exact
O(nm) two-piece affine score, the tests' oracle.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from . import nw_cuda

NULL = -(2**30)  # the null offset of a wavefront cell
NULL16 = -(2**15)  # the null of the int16 history
QPAD = 6  # base-code pad for query (codes 0..5 are real)
TPAD = 7  # distinct pad for target so pads never match

EXTEND_CHUNK = 64  # pad columns past the longest sequence (pack_batch)
# the plain version's extension compares this many bases a round
_EXTEND_ROUND = 64
# bytes of shared memory a block may opt into on H100 (sm_90), less room
# for the kernel's own shared variables
_SMEM_STAGE_BYTES = 232448 - 1024


@dataclass(frozen=True)
class Penalties:
    mismatch: int
    gap1_open: int
    gap1_extend: int
    gap2_open: int | None = None
    gap2_extend: int | None = None

    @property
    def two_piece(self) -> bool:
        return self.gap2_open is not None

    @staticmethod
    def from_scores(sc) -> "Penalties":
        """The penalties of an AlignmentScores (one-piece when it has no
        second gap piece)."""
        two = sc.has_two_piece
        return Penalties(
            sc.mismatch_penalty,
            sc.gap1_open,
            sc.gap1_extend,
            sc.gap2_open if two else None,
            sc.gap2_extend if two else None,
        )

    def kernel_kwargs(self) -> dict:
        """mismatch, o1, e1, o2, e2 (o2 = e2 = -1: one-piece)."""
        two = self.two_piece
        return dict(
            mismatch=self.mismatch,
            o1=self.gap1_open,
            e1=self.gap1_extend,
            o2=self.gap2_open if two else -1,
            e2=self.gap2_extend if two else -1,
        )


def _pad_to(x: np.ndarray, length: int, value: int) -> np.ndarray:
    out = np.full(length, value, dtype=np.uint8)
    out[: x.size] = x
    return out


def pack_batch(
    q_list: list[np.ndarray], t_list: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad base-code sequences to a common length (+extend chunk slack)."""
    lq = max((q.size for q in q_list), default=1)
    lt = max((t.size for t in t_list), default=1)
    Q = np.stack([_pad_to(q, lq + EXTEND_CHUNK, QPAD) for q in q_list])
    T = np.stack([_pad_to(t, lt + EXTEND_CHUNK, TPAD) for t in t_list])
    qlens = np.array([q.size for q in q_list], dtype=np.int32)
    tlens = np.array([t.size for t in t_list], dtype=np.int32)
    return Q, T, qlens, tlens


# -----------------------------------------------------------------------------
# The kernel and its plain version
# -----------------------------------------------------------------------------

_NAMES2 = ("M", "I1", "D1", "I2", "D2")


def history_rows(mismatch: int, o1: int, e1: int, o2: int, e2: int, smax: int,
                 keep_history: bool) -> int:
    """Rows of each history tensor: every score 0..smax, or a rolling window
    of the deepest lookback of the recurrences plus one."""
    if keep_history:
        return smax + 1
    return max(mismatch, o1 + e1, (o2 + e2) if o2 >= 0 else 0) + 1


def wfa_align_device(Q, T, qlens, tlens, score_caps, *, mismatch: int, o1: int, e1: int,
                     o2: int, e2: int, smax: int, band: int, keep_history: bool):
    """Run the batched WFA.  Returns (scores, histories).

    Q [B, Lq] / T [B, Lt] uint8 base codes padded with QPAD / TPAD; qlens,
    tlens, score_caps [B] int32; o2 < 0 selects one-piece penalties.
    scores[b] (int32) is the optimal score, or -1 if it is not reached
    within min(smax, score_caps[b]).  histories: int16 [B, smax + 1, NDIAG]
    tensors by name (M, I1, D1, and I2, D2 two-piece), NDIAG = 2 * band + 1;
    an empty dict when keep_history is False.  A pair's rows past the step
    it ended (finished or stopped) stay NULL16."""
    scores, hists = wfa_run(Q, T, qlens, tlens, score_caps, mismatch=mismatch, o1=o1, e1=e1,
                            o2=o2, e2=e2, smax=smax, band=band, keep_history=keep_history)
    if not keep_history:
        return scores, {}
    return scores, dict(zip(_NAMES2, hists))


def wfa_run(Q, T, qlens, tlens, score_caps, *, mismatch, o1, e1, o2, e2, smax, band,
            keep_history):
    """wfa_align_device's work: (scores [B] int32, the history tensors as a
    list M, I1, D1[, I2, D2]), the rolling rows too when keep_history is
    False.  Launches the kernel on a CUDA tensor, runs wfa_align_reference
    on a CPU one."""
    device = Q.device
    nw_cuda._check("Q", Q, torch.uint8, 2, device)
    nw_cuda._check("T", T, torch.uint8, 2, device)
    B = Q.shape[0]
    if T.shape[0] != B:
        raise ValueError("Q and T must have the same batch size")
    for name, x in (("qlens", qlens), ("tlens", tlens), ("score_caps", score_caps)):
        nw_cuda._check(name, x, torch.int32, 1, device)
        if x.shape[0] != B:
            raise ValueError(f"{name} must have {B} entries")
    if band < 0 or smax < 0:
        raise ValueError("band and smax must be >= 0")
    two = o2 >= 0
    # a step reads only rows of earlier steps when every lookback is >= 1
    if mismatch < 0 or o1 < 0 or e1 < 1 or (two and (o2 < 0 or e2 < 1)):
        raise ValueError("WFA needs mismatch >= 0, gap opens >= 0 and gap extends >= 1")
    kw = dict(mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2, smax=smax, band=band,
              keep_history=keep_history)
    if device.type == "cpu":
        return wfa_align_reference(Q, T, qlens, tlens, score_caps, **kw)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}: tensors must be on cuda or cpu")
    return _launch(Q, T, qlens, tlens, score_caps, **kw)


@dataclass(frozen=True)
class WfaPlan:
    """How the wavefront kernel runs a batch: one block of `threads` threads
    a pair.  route "rings": the rows the recurrences read back in shared
    memory (ring_rows M, I/D one-piece, I/D two-piece; ring_bytes); route
    "global": the history read back from device memory (ring_bytes 0).
    staged: the query and target in stage_bytes of shared memory beside the
    rings (else read from device memory)."""

    route: str
    staged: bool
    threads: int
    ring_rows: tuple[int, int, int]
    ring_bytes: int
    stage_bytes: int

    @property
    def smem_bytes(self) -> int:
        return self.ring_bytes + self.stage_bytes


def ring_rows(mismatch: int, o1: int, e1: int, o2: int, e2: int) -> tuple[int, int, int]:
    """Rows of the lookback rings: M keeps max(x, o1 + e1, o2 + e2) + 1, I1
    and D1 e1 + 1 each, I2 and D2 e2 + 1 each (0 one-piece)."""
    M = history_rows(mismatch, o1, e1, o2, e2, 0, keep_history=False)
    return M, e1 + 1, (e2 + 1) if o2 >= 0 else 0


def wfa_plan(Lq: int, Lt: int, band: int, *, mismatch: int, o1: int, e1: int, o2: int,
             e2: int) -> WfaPlan:
    """The wavefront kernel's launch: threads cover the 2 * band + 1
    diagonals (at most 1,024, striding past that).  The lookback rings (each
    row the diagonals and a NULL16 column either side, int16) go to shared
    memory when they fit, and the sequences beside them when both fit (each
    rounded up to 16 bytes plus 16 of slack for the 8-byte reads); rings
    alone next, then the history read back from device memory with the
    sequences staged where they fit alone.  The rings need mismatch >= 1:
    at 0 the M recurrence reads the row it writes, as only the history in
    device memory gives it."""
    nd = 2 * band + 1
    threads = min(1024, -(-nd // 32) * 32)
    rows = ring_rows(mismatch, o1, e1, o2, e2)
    ring = nw_cuda._round16((rows[0] + 2 * rows[1] + 2 * rows[2]) * (nd + 2) * 2)
    stage = nw_cuda._round16(Lq) + 16 + nw_cuda._round16(Lt) + 16
    if mismatch >= 1 and ring <= _SMEM_STAGE_BYTES:
        staged = ring + stage <= _SMEM_STAGE_BYTES
        return WfaPlan("rings", staged, threads, rows, ring, stage if staged else 0)
    staged = stage <= _SMEM_STAGE_BYTES
    return WfaPlan("global", staged, threads, rows, 0, stage if staged else 0)


def _launch(Q, T, qlens, tlens, score_caps, *, mismatch, o1, e1, o2, e2, smax, band,
            keep_history):
    device = Q.device
    B, Lq = Q.shape
    Lt = T.shape[1]
    two = o2 >= 0
    nd = 2 * band + 1
    rows = history_rows(mismatch, o1, e1, o2, e2, smax, keep_history)
    scores = torch.empty(B, dtype=torch.int32, device=device)
    hists = [torch.full((B, rows, nd), NULL16, dtype=torch.int16, device=device)
             for _ in range(5 if two else 3)]
    if B == 0:
        return scores, hists
    plan = wfa_plan(Lq, Lt, band, mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2)
    lib = nw_cuda._library()
    h = [x.data_ptr() for x in hists] + [None] * (5 - len(hists))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.wfa_launch(
            Q.data_ptr(), T.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), score_caps.data_ptr(),
            scores.data_ptr(), *h, B, Lq, Lt, band, rows, smax, mismatch, o1, e1, o2, e2,
            plan.threads, plan.ring_bytes, int(plan.staged), plan.smem_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"wfa launch failed with CUDA error {err}")
    nw_cuda.LAUNCHES["wfa" if keep_history else "wfa_score_only"] += 1
    return scores, hists


def wfa_occupancy(Lq: int, Lt: int, band: int, *, mismatch: int, o1: int, e1: int, o2: int,
                  e2: int) -> dict:
    """Registers per thread, shared memory per block and resident pairs per
    SM of a launch shape, with its plan (needs the card)."""
    plan = wfa_plan(Lq, Lt, band, mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2)
    regs, blocks, static = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = nw_cuda._library().wfa_occupancy(int(o2 >= 0), int(plan.route == "rings"), int(plan.staged),
                                           plan.threads, plan.smem_bytes, ctypes.byref(regs),
                                           ctypes.byref(blocks), ctypes.byref(static))
    if err != 0:
        raise RuntimeError(f"wfa occupancy query failed with CUDA error {err}")
    return {"regs_per_thread": regs.value, "smem_per_block": plan.smem_bytes + static.value,
            "resident_pairs_per_sm": blocks.value, "threads": plan.threads, "route": plan.route,
            "staged": plan.staged, "ring_rows": list(plan.ring_rows), "ring_bytes": plan.ring_bytes,
            "stage_bytes": plan.stage_bytes}


def _valid(off, ks, ql, tl):
    """A wavefront cell is real iff 0 <= h <= tlen and 0 <= v <= qlen."""
    v = off - ks
    ok = (off >= 0) & (off <= tl) & (v >= 0) & (v <= ql)
    return torch.where(ok, off, NULL)


def _extend(M, ks, Q, T, ql, tl):
    """Greedy extension of every real cell along its diagonal: _EXTEND_ROUND
    direct base comparisons a round, stopping at either sequence's end."""
    B, nd = M.shape
    Lq, Lt = Q.shape[1], T.shape[1]
    ar = torch.arange(_EXTEND_ROUND, device=M.device)
    Qi, Ti = Q.to(torch.int64), T.to(torch.int64)
    active = M > NULL
    while bool(active.any()):
        h = torch.where(active, M, 0)[..., None] + ar  # [B, nd, E]
        v = h - ks[..., None]
        ok = (h < tl[..., None]) & (v < ql[..., None]) & (v >= 0)
        tb = Ti.gather(1, h.clamp(0, Lt - 1).reshape(B, -1)).reshape(h.shape)
        qb = Qi.gather(1, v.clamp(0, Lq - 1).reshape(B, -1)).reshape(h.shape)
        adv = ((tb == qb) & ok).to(torch.int64).cumprod(-1).sum(-1)
        M = torch.where(active, M + adv, M)
        active = active & (adv == _EXTEND_ROUND)
    return M


def _store16(x):
    return x.clamp(NULL16, 2**15 - 1).to(torch.int16)


def wfa_align_reference(Q, T, qlens, tlens, score_caps, *, mismatch, o1, e1, o2, e2, smax, band,
                        keep_history):
    """Plain PyTorch version of the kernel: a Python loop over scores on
    [B, NDIAG] int64 tensors, written from the recurrences, the history
    int16 as the kernel stores it.  A pair steps while it has neither ended
    nor stopped (the kernel's early exit), so its later rows stay NULL16.
    Returns (scores [B] int32, the history tensors as a list)."""
    dev = Q.device
    B = Q.shape[0]
    two = o2 >= 0
    nd = 2 * band + 1
    i64 = torch.int64
    rows = history_rows(mismatch, o1, e1, o2, e2, smax, keep_history)
    hists = [torch.full((B, rows, nd), NULL16, dtype=torch.int16, device=dev)
             for _ in range(5 if two else 3)]
    if B == 0:
        return torch.empty(0, dtype=torch.int32, device=dev), hists
    ks = torch.arange(-band, band + 1, dtype=i64, device=dev)[None, :]
    ql = qlens.to(i64)[:, None]
    tl = tlens.to(i64)[:, None]
    caps = score_caps.to(i64)
    d_final = (tlens.to(i64) - qlens.to(i64)) + band
    in_band = (d_final >= 0) & (d_final < nd)
    d_idx = d_final.clamp(0, nd - 1)[:, None]
    null = torch.full((B, nd), NULL, dtype=i64, device=dev)
    null_col = null[:, :1]

    M = _extend(_valid(torch.where(ks == 0, 0, null), ks, ql, tl), ks, Q, T, ql, tl)
    hists[0][:, 0] = _store16(M)
    done = in_band & (M.gather(1, d_idx)[:, 0] == tlens.to(i64))
    scores = torch.where(done, 0, -1).to(i64)

    def row(H, sb):
        if sb < 0:
            return null
        r = H[:, sb % rows].to(i64)
        return torch.where(r <= NULL16, NULL, r)

    def from_above(x):  # diagonal d reads d + 1
        return torch.cat([x[:, 1:], null_col], dim=1)

    def from_below(x):  # diagonal d reads d - 1
        return torch.cat([null_col, x[:, :-1]], dim=1)

    s = 1
    while s <= smax and not bool(done.all()):
        live = ~done
        m_o1 = row(hists[0], s - o1 - e1)
        I1 = torch.maximum(from_above(m_o1), from_above(row(hists[1], s - e1)))
        D1 = torch.maximum(from_below(m_o1), from_below(row(hists[2], s - e1)))
        D1 = torch.where(D1 > NULL, D1 + 1, NULL)
        I1, D1 = _valid(I1, ks, ql, tl), _valid(D1, ks, ql, tl)
        if two:
            m_o2 = row(hists[0], s - o2 - e2)
            I2 = torch.maximum(from_above(m_o2), from_above(row(hists[3], s - e2)))
            D2 = torch.maximum(from_below(m_o2), from_below(row(hists[4], s - e2)))
            D2 = torch.where(D2 > NULL, D2 + 1, NULL)
            I2, D2 = _valid(I2, ks, ql, tl), _valid(D2, ks, ql, tl)
        else:
            I2 = D2 = null
        m_x = row(hists[0], s - mismatch)
        M = torch.where(m_x > NULL, m_x + 1, NULL)
        M = torch.maximum(torch.maximum(M, torch.maximum(I1, D1)), torch.maximum(I2, D2))
        M = _valid(M, ks, ql, tl)
        M = torch.where(live[:, None], M, NULL)  # ended pairs are not extended
        M = _extend(M, ks, Q, T, ql, tl)
        r = s % rows
        for H, x in zip(hists, (M, I1, D1, I2, D2)):
            H[:, r] = torch.where(live[:, None], _store16(x), H[:, r])
        newly = live & in_band & (M.gather(1, d_idx)[:, 0] == tlens.to(i64)) & (s <= caps)
        scores = torch.where(newly, s, scores)
        done = done | newly | (s >= caps)
        s += 1
    return scores.to(torch.int32), hists


# -----------------------------------------------------------------------------
# Host-side backtrace
# -----------------------------------------------------------------------------

# Tie-break precedence among co-optimal predecessors of an M cell:
# mismatch, then short-gap deletions/insertions, then long-gap.
_M_ORDER = ("X", "D1", "I1", "D2", "I2")


def backtrace_pair(
    hist: dict[str, np.ndarray],
    score: int,
    qlen: int,
    tlen: int,
    band: int,
    pen: Penalties,
) -> list[tuple[int, str]]:
    """Recover the optimal alignment as a list of (count, op) CIGAR items
    from one pair's history ([rows, NDIAG] int16 arrays by name, rows
    0..score at least).

    Ops: '=' match, 'X' mismatch, 'I' consume-query, 'D' consume-target.
    The host library's C++ backtrace runs first, as in the JAX package; the
    Python body below is the specification, run when the C++ reports an
    inconsistent history."""
    items = native.backtrace_native(
        hist, int(score), int(qlen), int(tlen), int(band), pen.mismatch, pen.gap1_open, pen.gap1_extend,
        pen.gap2_open if pen.two_piece else -1, pen.gap2_extend if pen.two_piece else -1,
    )
    if items is not None:
        return items
    HM = hist["M"].astype(np.int32)
    HI1 = hist["I1"].astype(np.int32)
    HD1 = hist["D1"].astype(np.int32)
    two = pen.two_piece and "I2" in hist
    HI2 = hist["I2"].astype(np.int32) if two else None
    HD2 = hist["D2"].astype(np.int32) if two else None
    N16 = NULL16

    def h(H, s, d):
        if H is None or s < 0 or d < 0 or d >= HM.shape[1]:
            return None
        v = int(H[s, d])
        return None if v <= N16 else v

    x, o1, e1 = pen.mismatch, pen.gap1_open, pen.gap1_extend
    o2, e2 = (pen.gap2_open, pen.gap2_extend) if two else (None, None)

    ops: list[str] = []  # reversed ops, one char per base step
    s = int(score)
    k = tlen - qlen
    d = k + band
    off = tlen
    matrix = "M"

    while True:
        if matrix == "M":
            if s == 0:
                # initial extension from the origin: all matches
                ops.extend("=" * off)
                break
            cands: dict[str, int | None] = {
                "X": (h(HM, s - x, d) + 1) if h(HM, s - x, d) is not None else None,
                "D1": h(HD1, s, d),
                "I1": h(HI1, s, d),
                "D2": h(HD2, s, d) if two else None,
                "I2": h(HI2, s, d) if two else None,
            }
            best = max(v for v in cands.values() if v is not None)
            n_match = off - best
            assert n_match >= 0, "backtrace: extend underflow"
            ops.extend("=" * n_match)
            off = best
            for name in _M_ORDER:
                if cands[name] == best:
                    choice = name
                    break
            if choice == "X":
                ops.append("X")
                s, off, matrix = s - x, off - 1, "M"
            else:
                matrix = choice
        elif matrix in ("D1", "D2"):
            o, e = (o1, e1) if matrix == "D1" else (o2, e2)
            HD = HD1 if matrix == "D1" else HD2
            ops.append("D")
            prev_off = off - 1
            m_pred = h(HM, s - o - e, d - 1)
            if m_pred is not None and m_pred == prev_off:
                s, d, off, matrix = s - o - e, d - 1, prev_off, "M"
            else:
                d_pred = h(HD, s - e, d - 1)
                assert d_pred is not None and d_pred == prev_off, "backtrace: broken D chain"
                s, d, off = s - e, d - 1, prev_off
        else:  # I1 / I2
            o, e = (o1, e1) if matrix == "I1" else (o2, e2)
            HI = HI1 if matrix == "I1" else HI2
            ops.append("I")
            m_pred = h(HM, s - o - e, d + 1)
            if m_pred is not None and m_pred == off:
                s, d, matrix = s - o - e, d + 1, "M"
            else:
                i_pred = h(HI, s - e, d + 1)
                assert i_pred is not None and i_pred == off, "backtrace: broken I chain"
                s, d = s - e, d + 1

    # ops collected end->start; reverse and run-length encode
    ops.reverse()
    out: list[tuple[int, str]] = []
    for op in ops:
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + 1, op)
        else:
            out.append((1, op))
    return out


def cigar_string(items: list[tuple[int, str]]) -> str:
    return "".join(f"{n}{op}" for n, op in items)


def cigar_match_runs(items: list[tuple[int, str]]) -> list[tuple[int, int, int]]:
    """(q_start, t_start, length) for every '='-run of a CIGAR."""
    runs = []
    q = t = 0
    for n, op in items:
        if op == "=":
            runs.append((q, t, n))
            q += n
            t += n
        elif op == "X":
            q += n
            t += n
        elif op == "I":
            q += n
        elif op == "D":
            t += n
    return runs


def affine2p_score_dp(q: np.ndarray, t: np.ndarray, pen: Penalties) -> int:
    """O(nm) Needleman-Wunsch with two-piece affine gaps; penalties positive."""
    INF = 10**9
    n, m = len(q), len(t)
    x, o1, e1 = pen.mismatch, pen.gap1_open, pen.gap1_extend
    two = pen.two_piece
    o2, e2 = (pen.gap2_open, pen.gap2_extend) if two else (INF, INF)
    M = np.full((n + 1, m + 1), INF, dtype=np.int64)
    I1 = np.full_like(M, INF)
    D1 = np.full_like(M, INF)
    I2 = np.full_like(M, INF)
    D2 = np.full_like(M, INF)
    M[0, 0] = 0
    for i in range(n + 1):
        for j in range(m + 1):
            best = M[i, j]
            if i > 0:
                I1[i, j] = min(M[i - 1, j] + o1 + e1, I1[i - 1, j] + e1)
                if two:
                    I2[i, j] = min(M[i - 1, j] + o2 + e2, I2[i - 1, j] + e2)
            if j > 0:
                D1[i, j] = min(M[i, j - 1] + o1 + e1, D1[i, j - 1] + e1)
                if two:
                    D2[i, j] = min(M[i, j - 1] + o2 + e2, D2[i, j - 1] + e2)
            best = min(best, I1[i, j], D1[i, j], I2[i, j], D2[i, j])
            if i > 0 and j > 0:
                sub = 0 if q[i - 1] == t[j - 1] else x
                best = min(best, M[i - 1, j - 1] + sub)
            M[i, j] = min(M[i, j], best)
    return int(M[n, m])
