"""Edge corpora of the packed int16 sweep and of the tiled row walk (kernel
D), made from a numpy seed.  numpy only, so that the CPU tests (against the
JAX package) and the card tests (against the plain versions, in a file that
imports no JAX) share them."""

import numpy as np

# the traceback walk's gap corpus lives beside the headline corpus, so that
# chip_smoke.py and tools/walk_timing.py build it without the tests
from seqrush_tpu_torch.tools.headline import walk_gap_corpus, walk_gap_pairs  # noqa: F401

QPAD, TPAD = 6, 7

# penalties (mismatch, o1, e1, o2, e2): the headline's; one-piece; every add
# to a state at the register route's int16 limit (32,767 - 30,000), which
# saturates the states of gappy pairs; and ties in H's choice (a mismatch
# costs two gap openings, and D1 and I1 open as D2 and I2 do)
INT16_EDGE_PENALTIES = {"two_piece": (5, 8, 2, 24, 1), "one_piece": (5, 8, 2, -1, -1),
                        "limit": (2767, 2760, 7, 2700, 67), "ties": (6, 2, 1, 1, 2)}


def _mutate(rng, q, n_snp, n_indel, max_len=12):
    t = q.copy()
    if t.size:
        pos = rng.integers(0, t.size, n_snp)
        t[pos] = rng.integers(0, 4, pos.size)
    for _ in range(n_indel):
        p = int(rng.integers(0, max(t.size - max_len, 1)))
        n = int(rng.integers(1, max_len + 1))
        if rng.random() < 0.5:
            t = np.delete(t, np.arange(p, min(p + n, t.size)))
        else:
            t = np.insert(t, p, rng.integers(0, 4, n).astype(np.uint8))
    return t


def _pack(qs, ts, lq, lt):
    B = len(qs)
    Q = np.full((B, lq), QPAD, np.uint8)
    T = np.full((B, lt), TPAD, np.uint8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        Q[b, : q.size] = q
        T[b, : t.size] = t
    return Q, T, np.array([q.size for q in qs], np.int32), np.array([t.size for t in ts], np.int32)


def int16_edge_corpus(seed=15):
    """Nine rows (an odd B: the last twin's high half is empty) padded to
    768: adjacent twins of very different lengths (700 and 37 bases), an
    empty pair beside a full one, a one-base pair beside two unrelated
    sequences, a query-only and a target-only row, and a gappy pair last.
    Returns (Q, T, qlens, tlens, tmax)."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    empty = np.zeros(0, np.uint8)
    qs, ts = [], []
    for n, snp, indel in ((700, 14, 3), (37, 1, 1)):
        q = rand(n)
        qs.append(q)
        ts.append(_mutate(rng, q, snp, indel))
    q = rand(520)
    qs += [empty, q]
    ts += [empty, _mutate(rng, q, 10, 4)]
    qs += [np.array([1], np.uint8), rand(400)]
    ts += [np.array([2, 3], np.uint8), rand(380)]
    qs += [rand(50), empty]
    ts += [empty, rand(60)]
    q = rand(650)
    qs.append(q)
    ts.append(_mutate(rng, q, 20, 12, 30))
    Q, T, ql, tl = _pack(qs, ts, 768, 768)
    return Q, T, ql, tl, 1536


def rows_edge_corpus(seed=16, band=63):
    """Rows for kernel D at `band`, R = 700 query rows (not a multiple of
    the walk's 64-row tiles): three pairs of equal lengths with a deletion
    of `band` target bases near the end and an insertion of band - k near
    the start, whose walk drifts the cursor by an I-run of `band` rows to
    the band's last lane (k = 0) or near it and back by a D-run of band - k
    lanes (longer than a tile's 32), a pair with 13 D-runs (more than a
    lowered gap list holds), a target-only row, a one-base pair and an
    empty row.  Returns (Q, T, qlens, tlens)."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(3):
        q = rng.integers(0, 4, 690 - 40 * k).astype(np.uint8)
        t = _mutate(rng, q, 8, 0)
        # walking up from the end: first the I-run (a deletion of band
        # query bases near the end, the cursor from lane band to 2 * band),
        # then the D-run (an insertion of target bases near the start)
        p_del = q.size - 150 - 10 * k
        t = np.delete(t, np.arange(p_del, p_del + band))
        t = np.insert(t, 60 + 20 * k, rng.integers(0, 4, band - k).astype(np.uint8))
        qs.append(q)
        ts.append(t)
    # 13 one-base insertions, each 25 bases before a one-base deletion: 13
    # D-runs with the cursor within a lane of the centre (more than a
    # lowered gap list holds)
    q = rng.integers(0, 4, 680).astype(np.uint8)
    t = q.copy()
    for p in range(630, 20, -50):
        t = np.insert(np.delete(t, p + 25), p, rng.integers(0, 4, 1).astype(np.uint8))
    qs.append(q)
    ts.append(t)
    qs += [np.zeros(0, np.uint8), np.array([3], np.uint8), np.zeros(0, np.uint8)]
    ts += [rng.integers(0, 4, 40).astype(np.uint8), np.array([1], np.uint8), np.zeros(0, np.uint8)]
    lt = max(t.size for t in ts)
    return _pack(qs, ts, 700, -(-lt // 16) * 16)

