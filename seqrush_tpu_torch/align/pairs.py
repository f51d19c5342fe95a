"""Pair scheduling.

The reference's pair-generation surface parses the sparsification mini-DSL
'none' / 'auto' / 'random:F' / 'connectivity:F' / 'tree:N[,S[,R[,K]]]'.
The port of ``seqrush_tpu/align/pairs.py``: the same grammar, and given the
same sketch distances the same pair lists.
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


def schedule_pairs(
    n: int,
    sparsification: Sparsification,
    seed: int = 42,
    kmer_distances: np.ndarray | None = None,
) -> np.ndarray:
    """Produce the pair list [P, 2] according to the sparsification strategy."""
    pairs = all_ordered_pairs(n)
    kind = sparsification.kind
    if kind == "none":
        return pairs
    if kind == "auto":
        # NOTE — documented divergence: the reference delegates 'auto' to
        # allwave's unpublished Auto strategy (submodule empty in the
        # snapshot, unverifiable).  Ours: keep all pairs for small inputs,
        # otherwise an O(n log n) random subset unioned with the k-mer-MST
        # connectivity backbone.
        if n <= 64:
            return pairs
        keep_prob = min(1.0, 4.0 * np.log(max(n, 2)) / n)
        rng = np.random.default_rng(seed)
        mask = rng.random(len(pairs)) < keep_prob
        return _ensure_connected(pairs[mask], n, kmer_distances)
    if kind in ("random", "connectivity"):
        rng = np.random.default_rng(seed)
        mask = rng.random(len(pairs)) < sparsification.factor
        kept = pairs[mask]
        return _ensure_connected(kept, n, kmer_distances) if kind == "connectivity" else kept
    if kind == "tree":
        from ..ops.kmer import tree_sampling_pairs

        tree_pairs, random_pairs = tree_sampling_pairs(
            kmer_distances,
            sparsification.k_nearest,
            sparsification.k_farthest,
            sparsification.rand_frac,
            seed=seed,
        )
        if tree_pairs.size == 0 and random_pairs.size == 0:
            return pairs
        return np.concatenate([tree_pairs, random_pairs], axis=0)
    raise ValueError(f"unknown sparsification kind {kind}")


def _ensure_connected(
    pairs: np.ndarray, n: int, kmer_distances: np.ndarray | None = None
) -> np.ndarray:
    """Union the kept pairs with a connectivity backbone.

    With k-mer distances available the backbone is the sketch-distance MST
    (closest sequences get aligned — maximal unite yield per alignment);
    the input-order chain i -> i+1 is only the distance-blind fallback."""
    if kmer_distances is not None and kmer_distances.shape[0] == n and n >= 2:
        from ..ops.kmer import mst_pairs

        backbone = mst_pairs(kmer_distances)
    else:
        backbone = np.stack(
            [np.arange(n - 1), np.arange(1, n)], axis=1
        ).astype(np.int32)
    if pairs.size == 0:
        return backbone
    key = pairs[:, 0].astype(np.int64) * n + pairs[:, 1]
    ckey = backbone[:, 0].astype(np.int64) * n + backbone[:, 1]
    missing = ~np.isin(ckey, key)
    return np.concatenate([pairs, backbone[missing]], axis=0)
