"""Backend-agnostic aligner abstraction.

The port of ``seqrush_tpu/align/base.py``: PAF-shaped records, a
backend-agnostic protocol, and a factory.  'allwave' is the batched
all-pairs runner (align/runner.py), 'sweepga' the seed-and-extend backend
(align/sweep.py).  The factory and the pipeline share one backend table
(``runner_class``), so the two never disagree about what a name means.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

import torch

from ..sequences import SequenceSet
from .pairs import all_ordered_pairs
from .runner import RunnerConfig, WfaAligner


@dataclass
class AlignmentRecord:
    """PAF-shaped record."""

    query_name: str
    query_len: int
    query_start: int
    query_end: int
    strand: str
    target_name: str
    target_len: int
    target_start: int
    target_end: int
    cigar: str


class Aligner(Protocol):
    def align_sequences(self, seqs: SequenceSet) -> list[AlignmentRecord]: ...


def runner_class(backend: str):
    """Backend name -> runner class (shared with pipeline.align_and_unite).
    Raises ValueError on unknown names."""
    if backend == "allwave":
        return WfaAligner
    if backend == "sweepga":
        from .sweep import SweepAligner

        return SweepAligner
    raise ValueError(f"Unknown aligner '{backend}'. Available: allwave, sweepga")


class AllwaveBackend:
    """All-pairs backend; the runner class is pluggable so the same record
    conversion serves both backends."""

    def __init__(self, config: RunnerConfig | None = None, runner_cls=WfaAligner,
                 device: str | torch.device = "cuda"):
        self.config = config or RunnerConfig()
        self.runner_cls = runner_cls
        self.device = device

    def align_sequences(self, seqs: SequenceSet) -> list[AlignmentRecord]:
        runner = self.runner_cls(seqs, self.config, device=self.device)
        out = []
        for r in runner.align_pairs(all_ordered_pairs(len(seqs))):
            q = seqs[r.query_idx]
            t = seqs[r.target_idx]
            out.append(
                AlignmentRecord(
                    query_name=q.id,
                    query_len=len(q.data),
                    query_start=0,
                    query_end=len(q.data),
                    strand="-" if r.is_reverse else "+",
                    target_name=t.id,
                    target_len=len(t.data),
                    target_start=0,
                    target_end=len(t.data),
                    cigar=r.cigar_string,
                )
            )
        return out


def create_aligner(backend: str, config: RunnerConfig | None = None,
                   device: str | torch.device = "cuda") -> Aligner:
    """Factory: the backend named ``backend`` on ``device``."""
    return AllwaveBackend(config, runner_cls=runner_class(backend), device=device)
