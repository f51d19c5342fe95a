"""CIGAR gap analysis and inversion-aware re-alignment.

The port of ``seqrush_tpu/align/inversion.py``: after a forward alignment,
large divergent gaps (both sides unaligned, similar sizes) are candidate
inversion sites; each candidate window is re-aligned with the target window
reverse-complemented, and if the inverted alignment scores well (better than
half the forward alignment's score) its match runs are united with reverse
orientation.

All candidate windows run as one batch through kernel A with traceback and
kernel B (``nw_cuda.nw_align``, ``nw_cuda.nw_walk``), at the JAX package's
shapes (Q [B, lq + 1], T [B, lt + 1] unrounded, B a power of two of at least
8); the opcodes decode to the CIGARs the JAX package's host ``traceback_pair``
gives on the same traceback.

Ops follow the package standard ('I' consumes query, 'D' consumes target).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import nw, nw_cuda
from ..ops.wfa import Penalties, cigar_match_runs
from ..pos import reverse_complement_codes


@dataclass
class Gap:
    query_start: int
    query_end: int
    target_start: int
    target_end: int
    gap_type: str  # "divergent" | "query_only" | "target_only"


def find_potential_inversion_sites(
    cigar_items: list[tuple[int, str]], min_gap_size: int
) -> list[Gap]:
    """Find large unaligned regions between *anchor* match runs.

    Match runs shorter than min_gap_size do not end a gap region: an
    inverted segment often holds short spurious forward matches that split
    the divergent region into I/D halves, and absorbing them recovers the
    whole window.
    """
    gaps: list[Gap] = []
    q = t = 0
    # region accumulators (None = not in a gap region)
    rq_start = rt_start = None
    rq_end = rt_end = 0

    def close_region():
        nonlocal rq_start, rt_start
        if rq_start is None:
            return
        q_gap = rq_end - rq_start
        t_gap = rt_end - rt_start
        if q_gap >= min_gap_size and t_gap >= min_gap_size:
            gaps.append(Gap(rq_start, rq_end, rt_start, rt_end, "divergent"))
        elif q_gap >= min_gap_size:
            gaps.append(Gap(rq_start, rq_end, rt_start, rt_start, "query_only"))
        elif t_gap >= min_gap_size:
            gaps.append(Gap(rq_start, rq_start, rt_start, rt_end, "target_only"))
        rq_start = rt_start = None

    for count, op in cigar_items:
        is_anchor = op in ("M", "=") and count >= min_gap_size
        if is_anchor:
            close_region()
            q += count
            t += count
            continue
        if rq_start is None:
            rq_start, rt_start = q, t
        if op in ("M", "=", "X"):
            q += count
            t += count
        elif op == "I":
            q += count
        elif op == "D":
            t += count
        rq_end, rt_end = q, t
    close_region()
    return gaps


def is_potential_inversion(gap: Gap, min_inversion_size: int) -> bool:
    """Divergent, both sides >= min size, size ratio <= 1.5."""
    if gap.gap_type != "divergent":
        return False
    qs = gap.query_end - gap.query_start
    ts = gap.target_end - gap.target_start
    if min(qs, ts) == 0:
        return False
    ratio = max(qs, ts) / min(qs, ts)
    return qs >= min_inversion_size and ts >= min_inversion_size and ratio <= 1.5


def inversion_jobs(results, aligner, min_match_length: int):
    """(result, gap, query window, reverse-complemented target window) for
    every candidate inversion window of the forward results."""
    min_size = max(2 * min_match_length, 20)
    jobs = []
    for res in results:
        if res.is_reverse:
            continue  # only forward alignments are patched
        for gap in find_potential_inversion_sites(res.cigar, min_size):
            if not is_potential_inversion(gap, min_size):
                continue
            qw = aligner.codes[res.query_idx][gap.query_start : gap.query_end]
            tw = aligner.codes[res.target_idx][gap.target_start : gap.target_end]
            jobs.append((res, gap, qw, reverse_complement_codes(tw).copy()))
    return jobs


def pack_inversion_batch(jobs):
    """Kernel inputs of the window batch: (Q [B, lq + 1], T [B, lt + 1]
    uint8, qlens, tlens [B] int32, band, tmax) with lq, lt the longest
    windows, B = max(next_pow2, 8), band = min(max(lq, lt) + 1,
    max(64, max |qlen - tlen| + 64)) and tmax = max(qlen + tlen) + 1: the
    JAX package's shapes, none rounded."""
    B = max(1 << (len(jobs) - 1).bit_length(), 8)
    lq = max(j[2].size for j in jobs)
    lt = max(j[3].size for j in jobs)
    Q = np.full((B, lq + 1), nw.QPAD, np.uint8)
    T = np.full((B, lt + 1), nw.TPAD, np.uint8)
    qlens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    for b, (_, _, qw, rc_tw) in enumerate(jobs):
        Q[b, : qw.size] = qw
        T[b, : rc_tw.size] = rc_tw
        qlens[b] = qw.size
        tlens[b] = rc_tw.size
    band = min(max(lq, lt) + 1, max(64, int(np.abs(qlens - tlens).max()) + 64))
    tmax = int((qlens + tlens).max()) + 1
    return Q, T, qlens, tlens, band, tmax


def inversion_patch_alignments(results, aligner, min_match_length: int):
    """For each forward alignment, re-align candidate inversion windows with
    the target window reverse-complemented; returns the patch unite pairs
    (u, v) as Pos arrays.

    Acceptance rule: the inverted window alignment must complete and score
    strictly less than half the whole forward alignment's score
    (``inv_score < score // 2``), so a patch inside a nearly identical pair
    (small forward score) is held to a much stricter bar than one inside a
    divergent alignment.  Counts go to aligner.stats: ``inversion_windows``
    and ``inversion_patches`` (accepted windows), and the batch's dispatch
    (kind 'inversion')."""
    jobs = inversion_jobs(results, aligner, min_match_length)
    aligner.stats["inversion_windows"] = aligner.stats.get("inversion_windows", 0) + len(jobs)
    aligner.stats.setdefault("inversion_patches", 0)
    if not jobs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    Q, T, qlens, tlens, band, tmax = pack_inversion_batch(jobs)
    aligner.stats["dispatches"].append(
        {"kind": "inversion", "B": Q.shape[0], "band": band, "tmax": tmax, "emit": "ops",
         "Lq": Q.shape[1],
         "Lt": T.shape[1], "jobs": [[int(res.query_idx), int(res.target_idx), gap.query_start,
                                     gap.query_end, gap.target_start, gap.target_end]
                                    for res, gap, _q, _t in jobs]})
    pen = Penalties.from_scores(aligner.cfg.scores).kernel_kwargs()
    dev = aligner.device
    Qd, Td, qd, td = (torch.from_numpy(a).to(dev) for a in (Q, T, qlens, tlens))
    scores, tb = nw_cuda.nw_align(Qd, Td, qd, td, band=band, tmax=tmax, **pen)
    ops = nw_cuda.nw_walk(tb, qd, td, band=band, tmax=tmax)
    del tb
    scores = scores.cpu().numpy()

    # reference acceptance: completed AND inv_score < forward_score / 2
    accepted = [b for b, (res, *_rest) in enumerate(jobs)
                if 0 <= scores[b] and int(scores[b]) < res.score // 2]
    aligner.stats["inversion_patches"] += len(accepted)
    if not accepted:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    items_all = nw.decode_batch(ops[accepted].cpu().numpy(), [jobs[b][2] for b in accepted],
                                [jobs[b][3] for b in accepted])
    us, vs = [], []
    for b, items in zip(accepted, items_all):
        res, gap, _qw, _rc_tw = jobs[b]
        qseq = aligner.seqs[res.query_idx]
        tseq = aligner.seqs[res.target_idx]
        t_win_len = gap.target_end - gap.target_start
        for run_q, run_t, n in cigar_match_runs(items):
            if n < max(min_match_length, 1):
                continue
            i = np.arange(n, dtype=np.int64)
            # query forward positions within the window
            u = (np.int64(qseq.offset + gap.query_start + run_q) + i) << 1
            # rc-window position run_t+i maps to target local
            # gap.target_start + (t_win_len - 1 - (run_t+i)), reverse orient
            t_local = np.int64(gap.target_start + t_win_len - 1) - (np.int64(run_t) + i)
            v = ((np.int64(tseq.offset) + t_local) << 1) | 1
            us.append(u)
            vs.append(v)
    if not us:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(us), np.concatenate(vs)
