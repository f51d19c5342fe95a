"""Gap penalties and CIGAR helpers of the wavefront module: host code only.

A copy of the host helpers of ``seqrush_tpu/ops/wfa.py`` that the sweepga
backend and the inversion-aware mode use: ``Penalties``, ``cigar_string``,
``cigar_match_runs`` and ``affine2p_score_dp`` (the exact O(nm) two-piece
affine score, the tests' oracle).  ``Penalties.kernel_kwargs`` is the one
conversion to the penalty dict the kernels (``nw_cuda.nw_align``) and the
host library (``native.window_dp_native``) take.

The batched wavefront kernel itself (``wfa_align_device``) and its
backtrace (``backtrace_pair``) are not ported yet (ROADMAP item 13).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
