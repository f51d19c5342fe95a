"""Tracing/observability and device selection.

``PhaseTimer`` (copied from seqrush_tpu/utils.py) records wall-clock and
counters for every pipeline phase into a structured report (``--profile``).
``resolve_device`` is the one place the port turns a ``device`` argument
into a ``torch.device``: the default is ``cuda``, and asking for a GPU that
is not there raises instead of falling back to the CPU.  ``to_host`` starts
a dispatch's outputs copying back from the card without blocking.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


@dataclass
class PhaseTimer:
    phases: dict[str, float] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.time() - t0

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def rate(self, counter: str, phase: str) -> float:
        dt = self.phases.get(phase, 0.0)
        return self.counters.get(counter, 0.0) / dt if dt > 0 else 0.0

    def report(self) -> dict:
        out = {"phases_s": dict(self.phases), "counters": dict(self.counters)}
        if "alignments" in self.counters and "align" in self.phases:
            out["alignments_per_s"] = self.rate("alignments", "align")
        return out


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' (CLI: --device cpu) to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev


def to_host(scores, arrays):
    """Start copying a dispatch's scores and outputs back from the card into
    pinned memory without blocking; returns (scores, arrays, ready event),
    the event None (and the tensors as given) on the CPU."""
    if scores.device.type != "cuda":
        return scores, tuple(arrays), None
    out = []
    for a in (scores, *arrays):
        h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        h.copy_(a, non_blocking=True)
        out.append(h)
    ready = torch.cuda.Event()
    ready.record()
    return out[0], tuple(out[1:]), ready
