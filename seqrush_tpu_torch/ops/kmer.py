"""Bottom-k MinHash (mash) sketches and distances, for orientation calls and
band sizing.

Host numpy, copied from ``seqrush_tpu/ops/kmer.py`` (``_kmer_codes``,
``mash_sketches``, ``mash_distance_batch``).  The sketch-matrix distances
that tree sparsification uses are not part of this package yet (ROADMAP
item 8).
"""

from __future__ import annotations

import numpy as np


def _kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Rolling hash codes of all k-mers (skipping any containing non-ACGT)."""
    if codes.size < k:
        return np.zeros(0, dtype=np.uint64)
    valid = codes < 4
    c = codes.astype(np.uint64)
    # rolling polynomial hash in uint64 (wraparound is fine for sketching)
    h = np.zeros(codes.size - k + 1, dtype=np.uint64)
    ok = np.ones(codes.size - k + 1, dtype=bool)
    mult = np.uint64(0x9E3779B97F4A7C15)
    for i in range(k):
        h = h * np.uint64(4) + c[i : i + h.size]
        ok &= valid[i : i + h.size]
    h = (h * mult) >> np.uint64(32)
    return h[ok]


def mash_sketches(
    seq_codes: list[np.ndarray], k: int = 15, sketch_size: int = 512
) -> list[np.ndarray]:
    """Bottom-k MinHash sketches (sorted distinct hash values per sequence)."""
    out = []
    for codes in seq_codes:
        h = np.unique(_kmer_codes(codes, k))
        out.append(h[: min(sketch_size, h.size)])  # np.unique sorts
    return out


def mash_distance_batch(
    sketches: list[np.ndarray],
    ia: np.ndarray,
    ib: np.ndarray,
    k: int = 15,
    sketch_size: int = 512,
) -> np.ndarray:
    """Mash distance d = -ln(2j/(1+j))/k between sketches[ia[p]] and
    sketches[ib[p]] for every p.

    j is the bottom-k merge estimate |A cap B cap bottom-s(A cup B)| / s.
    The two sorted sketches of every pair are padded into one [P, 2s]
    matrix, merged with one axis-1 sort, and the shared count falls out of
    adjacent-duplicate marks plus a distinct-rank cumsum."""
    ia = np.asarray(ia, dtype=np.int64)
    ib = np.asarray(ib, dtype=np.int64)
    P = ia.size
    if P == 0:
        return np.zeros(0)
    smax = max(max((s.size for s in sketches), default=1), 1)
    PAD = np.uint64(0xFFFFFFFFFFFFFFFF)  # sketch hashes are < 2^32
    SK = np.full((len(sketches), smax), PAD, np.uint64)
    for s_i, s in enumerate(sketches):
        SK[s_i, : s.size] = s
    sizes = np.array([s.size for s in sketches], dtype=np.int64)

    out = np.empty(P)
    BLOCK = 8192
    for lo in range(0, P, BLOCK):
        a = ia[lo : lo + BLOCK]
        b = ib[lo : lo + BLOCK]
        merged = np.sort(np.concatenate([SK[a], SK[b]], axis=1), axis=1)
        valid = merged != PAD
        dup = (merged[:, 1:] == merged[:, :-1]) & valid[:, 1:]
        first = np.concatenate([valid[:, :1], ~dup & valid[:, 1:]], axis=1)
        rank = np.cumsum(first, axis=1)  # distinct union rank, 1-based
        shared = (dup & (rank[:, :-1] <= sketch_size)).sum(axis=1)
        usize = np.minimum(rank[:, -1], sketch_size)
        j = shared / np.maximum(usize, 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.clip(-np.log(2.0 * j / (1.0 + j)) / k, 0.0, 1.0)
        out[lo : lo + BLOCK] = np.where(j <= 0.0, 1.0, d)
    empty = (sizes[ia] == 0) | (sizes[ib] == 0)
    return np.where(empty, 1.0, out)
