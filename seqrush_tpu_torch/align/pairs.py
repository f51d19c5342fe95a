"""Pair scheduling.

The reference's pair-generation surface parses the sparsification mini-DSL
'none' / 'auto' / 'random:F' / 'connectivity:F' / 'tree:N[,S[,R[,K]]]'.
This package schedules all ordered pairs ('none'); every other kind parses
and then raises ``NotImplementedError`` until ROADMAP item 8 ports the
sparsified schedules.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Sparsification:
    kind: str  # none | auto | random | connectivity | tree
    factor: float = 1.0
    k_nearest: int = 0
    k_farthest: int = 0
    rand_frac: float = 0.0
    kmer_size: int = 16


def parse_sparsification(s: str) -> Sparsification:
    """Parse the sparsification DSL (same grammar and errors as the JAX package)."""
    if s in ("none", "1.0"):
        return Sparsification("none")
    if s == "auto":
        return Sparsification("auto")
    if s.startswith("random:"):
        f = float(s[7:])
        if not (0.0 < f <= 1.0):
            raise ValueError(f"Random factor must be in (0.0, 1.0], got {f}")
        return Sparsification("random", factor=f)
    if s.startswith("connectivity:"):
        p = float(s[13:])
        if not (0.0 < p <= 1.0):
            raise ValueError(f"Connectivity probability must be in (0.0, 1.0], got {p}")
        return Sparsification("connectivity", factor=p)
    if s.startswith("tree:"):
        parts = s[5:].split(",")
        if not parts or len(parts) > 4:
            raise ValueError(
                "Tree sampling requires 1-4 values: tree:neighbor[,stranger[,random[,k-mer]]]"
            )
        k_near = int(parts[0])
        k_far = int(parts[1]) if len(parts) >= 2 else 0
        rand_frac = float(parts[2]) if len(parts) >= 3 else 0.0
        if not (0.0 <= rand_frac <= 1.0):
            raise ValueError(f"Random fraction must be in [0.0, 1.0], got {rand_frac}")
        kmer = int(parts[3]) if len(parts) >= 4 else 16
        if kmer <= 0:
            raise ValueError("K-mer size must be > 0")
        return Sparsification(
            "tree", k_nearest=k_near, k_farthest=k_far, rand_frac=rand_frac, kmer_size=kmer
        )
    # backward compat: plain float == random factor
    try:
        f = float(s)
    except ValueError:
        raise ValueError(
            f"Invalid sparsification: '{s}'. Use 'none', 'auto', 'random:F', "
            "'connectivity:F', or 'tree:neighbor[,stranger[,random[,k-mer]]]'"
        )
    if 0.0 < f <= 1.0:
        return Sparsification("random", factor=f)
    raise ValueError(f"Invalid sparsification: '{s}'")


def all_ordered_pairs(n: int) -> np.ndarray:
    """All (i, j), i != j, in row-major order — [P, 2] int32.

    Self-alignments are union-find no-ops (every base unites with itself), so
    they are skipped.
    """
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    mask = i != j
    return np.stack([i[mask], j[mask]], axis=1).astype(np.int32)


def schedule_pairs(n: int, sparsification: Sparsification) -> np.ndarray:
    """The pair list [P, 2] for the sparsification strategy."""
    if sparsification.kind != "none":
        raise NotImplementedError(
            f"sparsification '{sparsification.kind}' is not ported yet "
            "(ROADMAP item 8); use -x none"
        )
    return all_ordered_pairs(n)
