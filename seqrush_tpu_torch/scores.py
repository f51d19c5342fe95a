"""Alignment score configuration and the score-string mini-DSL.

Mirrors the reference's ``AlignmentScores`` (reference src/seqrush.rs:
154-270): "match,mismatch,gap1_open,gap1_extend[,gap2_open,gap2_extend]" for
the full aligner and a strict 4-tuple for the orientation pre-check, plus the
divergence -> maximum-score conversion used to cap wavefront exploration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class AlignmentScores:
    match_score: int = 0
    mismatch_penalty: int = 5
    gap1_open: int = 8
    gap1_extend: int = 2
    gap2_open: int | None = 24
    gap2_extend: int | None = 1

    @property
    def has_two_piece(self) -> bool:
        return self.gap2_open is not None and self.gap2_extend is not None

    @staticmethod
    def parse(scores_str: str) -> "AlignmentScores":
        parts = scores_str.split(",")
        if len(parts) < 4:
            raise ValueError(
                "Scores must have at least 4 values: match,mismatch,gap1_open,gap1_extend"
            )
        if len(parts) > 6:
            raise ValueError("Too many score values provided (max 6)")
        try:
            vals = [int(p) for p in parts]
        except ValueError as e:
            raise ValueError(f"Invalid score value in '{scores_str}'") from e
        g2o, g2e = (vals[4], vals[5]) if len(vals) >= 6 else (None, None)
        return AlignmentScores(vals[0], vals[1], vals[2], vals[3], g2o, g2e)

    @staticmethod
    def parse_orientation(scores_str: str) -> "AlignmentScores":
        parts = scores_str.split(",")
        if len(parts) != 4:
            raise ValueError(
                "Orientation scores must have exactly 4 values: match,mismatch,gap_open,gap_extend"
            )
        vals = [int(p) for p in parts]
        return AlignmentScores(vals[0], vals[1], vals[2], vals[3], None, None)

    def max_score_for_divergence(self, seq_len: int, max_divergence: float) -> int:
        """Reference formula (seqrush.rs:253-269): mismatch budget + one gap run."""
        max_mismatches = math.ceil(seq_len * max_divergence)
        max_gaps = math.ceil(seq_len * max_divergence * 0.5)
        mismatch_score = max_mismatches * self.mismatch_penalty
        gap_score = self.gap1_open + (max_gaps - 1) * self.gap1_extend if max_gaps > 0 else 0
        return max(mismatch_score + gap_score, self.mismatch_penalty * 2)


DEFAULT_SCORES = AlignmentScores()
DEFAULT_ORIENTATION_SCORES = AlignmentScores(0, 1, 1, 1, None, None)
