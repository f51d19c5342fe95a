"""Backend table: aligner name -> runner class (shared with the pipeline)."""

from __future__ import annotations

from .runner import WfaAligner


def runner_class(backend: str):
    """Backend name -> runner class.  'allwave' is the batched all-pairs
    runner; 'sweepga' raises NotImplementedError (ROADMAP item 11)."""
    if backend == "allwave":
        return WfaAligner
    if backend == "sweepga":
        raise NotImplementedError("the sweepga backend is not ported yet (ROADMAP item 11)")
    raise ValueError(f"Unknown aligner '{backend}'. Available: allwave, sweepga")
