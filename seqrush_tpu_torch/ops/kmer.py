"""K-mer sketches and distances.

The port of ``seqrush_tpu/ops/kmer.py``:

* bottom-k MinHash (mash) sketches and distances (one pair, or a batch),
  for orientation calls and band sizing (host numpy);
* bucketed k-mer count sketches and their cosine distance matrix, one
  float32 matrix product on the run's device, which the tree, auto and
  connectivity pair schedules and the iterative mode read;
* the minimum spanning tree and the tree-sampling pair selection over that
  matrix (host numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device

_DIM = 1024  # sketch dimensionality (buckets)


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


def kmer_sketches(seq_codes: list[np.ndarray], k: int) -> np.ndarray:
    """Per-sequence bucketed k-mer count sketches, L2-normalized [n, DIM]."""
    n = len(seq_codes)
    out = np.zeros((n, _DIM), dtype=np.float32)
    for i, codes in enumerate(seq_codes):
        h = _kmer_codes(codes, k) % _DIM
        np.add.at(out[i], h.astype(np.int64), 1.0)
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return out / norms


def mash_sketches(
    seq_codes: list[np.ndarray], k: int = 15, sketch_size: int = 512
) -> list[np.ndarray]:
    """Bottom-k MinHash sketches (sorted distinct hash values per sequence)."""
    out = []
    for codes in seq_codes:
        h = np.unique(_kmer_codes(codes, k))
        out.append(h[: min(sketch_size, h.size)])  # np.unique sorts
    return out


def mash_distance(a: np.ndarray, b: np.ndarray, k: int = 15, sketch_size: int = 512) -> float:
    """Mash distance d = -ln(2j / (1 + j)) / k of two bottom-k sketches, j
    the bottom-k merge estimate |A & B & bottom-s(A | B)| / s; 1.0 where a
    sketch is empty or nothing is shared."""
    if a.size == 0 or b.size == 0:
        return 1.0
    union = np.union1d(a, b)[:sketch_size]
    inter = np.intersect1d(a, b, assume_unique=True)
    shared = np.searchsorted(union, inter, side="right") - np.searchsorted(union, inter, side="left")
    j = float(shared.sum()) / max(union.size, 1)
    if j <= 0.0:
        return 1.0
    return min(max(-np.log(2.0 * j / (1.0 + j)) / k, 0.0), 1.0)


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


def kmer_distance_matrix(
    seq_codes: list[np.ndarray], k: int, device: str | torch.device = "cuda"
) -> np.ndarray:
    """[n, n] cosine distance over k-mer sketches: ``1 - S @ S.T`` as one
    float32 matrix product on ``device``."""
    sketches = torch.from_numpy(kmer_sketches(seq_codes, k)).to(resolve_device(device))
    return (1.0 - torch.matmul(sketches, sketches.T)).cpu().numpy()


def mst_pairs(dist: np.ndarray) -> np.ndarray:
    """Minimum spanning tree edges (Prim) over a dense distance matrix —
    the distance-aware connectivity guarantee for sparsified pair schedules
    ([n-1, 2] int32)."""
    n = dist.shape[0]
    if n < 2:
        return np.zeros((0, 2), dtype=np.int32)
    in_tree = np.zeros(n, dtype=bool)
    in_tree[0] = True
    best = dist[0].copy()
    best_from = np.zeros(n, dtype=np.int64)
    out = []
    for _ in range(n - 1):
        cand = np.where(in_tree, np.inf, best)
        j = int(np.argmin(cand))
        out.append((int(best_from[j]), j))
        in_tree[j] = True
        upd = dist[j] < best
        best = np.where(upd, dist[j], best)
        best_from = np.where(upd, j, best_from)
    return np.array(out, dtype=np.int32)


def tree_sampling_pairs(
    dist: np.ndarray,
    k_nearest: int,
    k_farthest: int,
    rand_frac: float,
    seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """(tree_pairs, random_pairs) — the two phases of TreeSampling.

    tree_pairs: for every sequence its k nearest and k farthest partners by
    sketch distance, unioned with a minimum spanning tree so the alignment
    graph is always connected (the reference's tree phase guarantee).
    random_pairs: rand_frac of the remaining ordered pairs, shuffled.
    """
    n = dist.shape[0]
    if n < 2:
        z = np.zeros((0, 2), dtype=np.int32)
        return z, z
    chosen: set[tuple[int, int]] = set()
    order = np.argsort(dist + np.eye(n) * 1e9, axis=1, kind="stable")
    for i in range(n):
        for j in order[i, : max(k_nearest, 0)]:
            chosen.add((i, int(j)))
        if k_farthest > 0:
            for j in order[i, ::-1][:k_farthest]:
                if int(j) != i:
                    chosen.add((i, int(j)))
    # MST for connectivity
    for a, b in mst_pairs(dist):
        chosen.add((int(a), int(b)))
    tree_pairs = np.array(sorted(chosen), dtype=np.int32) if chosen else np.zeros((0, 2), np.int32)

    rng = np.random.default_rng(seed)
    if rand_frac > 0:
        ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        mask = ii != jj
        allp = np.stack([ii[mask], jj[mask]], axis=1)
        tkey = tree_pairs[:, 0].astype(np.int64) * n + tree_pairs[:, 1]
        akey = allp[:, 0].astype(np.int64) * n + allp[:, 1]
        remaining = allp[~np.isin(akey, tkey)]
        m = int(round(rand_frac * len(remaining)))
        idx = rng.permutation(len(remaining))[:m]
        random_pairs = remaining[idx].astype(np.int32)
    else:
        random_pairs = np.zeros((0, 2), dtype=np.int32)
    return tree_pairs, random_pairs
