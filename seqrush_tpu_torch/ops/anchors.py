"""Minimizer anchors and colinear chaining: the anchored wide route and the
sweepga backend.

A copy of ``seqrush_tpu/ops/anchors.py``: exact-match minimizer anchors
between a pair (every k-mer is packed exactly into int64, 2 bits a base, so
an anchor is an exact match by construction), the colinear chaining DP over
them, the extraction of several disjoint chains a pair (the sweepga
backend's candidate mappings), and the merge of a chain into exact-match
runs.

``chain_anchors``, ``chain_anchors_multi`` and ``chain_to_runs`` here are the
plain Python version of the host library's ``chain_pairs``
(``native.chain_pairs_native``), which both users run; the tests hold the
two equal.  ``chain_anchors`` itself runs its DP in the host library's C++
``chain_anchors`` first, as the JAX package does; the Python lookback below
it is the specification.
"""

from __future__ import annotations

import numpy as np

from .. import native

# colinear-chaining defaults (minimap2-style), shared by chain_anchors and
# the route's chain_pairs call
DEFAULT_MAX_GAP = 5000
DEFAULT_MAX_SKEW = 2000


def packed_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(positions, packed int64 values) of all ACGT-only k-mers."""
    n = codes.size
    if n < k:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    c = codes.astype(np.int64)
    valid = codes < 4
    vals = np.zeros(n - k + 1, dtype=np.int64)
    ok = np.ones(n - k + 1, dtype=bool)
    for i in range(k):
        vals = (vals << 2) | c[i : i + n - k + 1]
        ok &= valid[i : i + n - k + 1]
    pos = np.nonzero(ok)[0]
    return pos.astype(np.int64), vals[ok]


def minimizers(codes: np.ndarray, k: int = 15, w: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """Window minimizers: positions/values of k-mers minimal (by a mixing
    hash) in any window of w consecutive k-mers."""
    pos, vals = packed_kmers(codes, k)
    if pos.size == 0:
        return pos, vals
    # mix so minima are spread uniformly (uint64 wraparound multiply)
    h = (vals.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(1)
    if pos.size <= w:
        sel = np.array([int(np.argmin(h))])
    else:
        m = pos.size - w + 1
        stack = np.lib.stride_tricks.sliding_window_view(h, w)
        arg = np.argmin(stack, axis=1) + np.arange(m)
        sel = np.unique(arg)
    return pos[sel], vals[sel]


def anchor_matches(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    k: int = 15,
    w: int = 10,
    max_freq: int | None = None,
) -> np.ndarray:
    """[A, 2] (qpos, tpos) exact k-mer anchors between minimizer sets.

    ``max_freq`` is the seed-frequency cutoff (the ``--frequency`` flag): a
    query minimizer whose value occurs more than max_freq times in the
    target's minimizer index is not used as a seed, so repeat k-mers do not
    explode the anchor list or seed repeat-to-repeat chains."""
    return anchor_matches_from_minimizers(
        minimizers(q_codes, k, w), minimizers(t_codes, k, w), max_freq=max_freq
    )


def sort_minimizers(
    t_mins: tuple[np.ndarray, np.ndarray],
) -> tuple[np.ndarray, np.ndarray]:
    """Value-sorted (values, positions) target index for
    anchor_matches_from_minimizers; cache it per sequence so an all-pairs
    run sorts each target index once, not once per pair."""
    tp, tv = t_mins
    order_t = np.argsort(tv, kind="stable")
    return tv[order_t], tp[order_t]


def anchor_matches_from_minimizers(
    q_mins: tuple[np.ndarray, np.ndarray],
    t_mins: tuple[np.ndarray, np.ndarray],
    max_freq: int | None = None,
    t_sorted: tuple[np.ndarray, np.ndarray] | None = None,
) -> np.ndarray:
    """[A, 2] (qpos, tpos) exact k-mer anchors between two precomputed
    (positions, values) minimizer sets.  ``max_freq`` drops a query
    minimizer whose value occurs more than max_freq times in the target's
    set (the seed-frequency cutoff).  ``t_sorted`` (from sort_minimizers)
    skips the per-call target sort."""
    qp, qv = q_mins
    tp, tv = t_mins
    if qp.size == 0 or tp.size == 0:
        return np.zeros((0, 2), np.int64)
    # join on value
    if t_sorted is None:
        t_sorted = sort_minimizers(t_mins)
    tv_s, tp_s = t_sorted
    lo = np.searchsorted(tv_s, qv, side="left")
    hi = np.searchsorted(tv_s, qv, side="right")
    counts = hi - lo
    if max_freq is not None:
        counts = np.where(counts > max_freq, 0, counts)
    total = int(counts.sum())
    if total == 0:
        return np.zeros((0, 2), np.int64)
    qidx = np.repeat(np.arange(qp.size), counts)
    # positions within each run: flat iota minus each run's start offset
    starts = np.cumsum(counts) - counts
    offs = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    tidx = np.repeat(lo, counts) + offs
    return np.stack([qp[qidx], tp_s[tidx]], axis=1)


def chain_anchors(
    anchors: np.ndarray, k: int = 15, max_gap: int = DEFAULT_MAX_GAP,
    max_skew: int = DEFAULT_MAX_SKEW,
) -> np.ndarray:
    """Best colinear chain via the classic anchor-chaining DP.

    Returns the [C, 2] chained subset ordered by position.  Weight = k per
    anchor minus gap-skew cost (like minimap2's simplified chaining), with a
    64-anchor lookback, the first maximum winning every argmax.
    """
    if anchors.shape[0] == 0:
        return anchors
    order = np.lexsort((anchors[:, 1], anchors[:, 0]))
    a = anchors[order]
    idx = native.chain_anchors_native(a, k, max_gap, max_skew)
    if idx is None:
        idx = _chain_indices_python(a, k, max_gap, max_skew)
    return _keep_increasing(a[idx])


def _chain_indices_python(a: np.ndarray, k: int, max_gap: int, max_skew: int) -> list[int]:
    """The chaining DP's specification over (q, t)-sorted anchors: the best
    chain's row indices, ascending."""
    n = a.shape[0]
    f = np.full(n, float(k))
    pred = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        qi, ti = a[i]
        j0 = max(0, i - 64)
        js = np.arange(j0, i)
        if js.size == 0:
            continue
        qj = a[js, 0]
        tj = a[js, 1]
        ok = (qj < qi) & (tj < ti) & (qi - qj <= max_gap) & (ti - tj <= max_gap)
        skew = np.abs((qi - qj) - (ti - tj))
        ok &= skew <= max_skew
        if not ok.any():
            continue
        gain = f[js] + k - 0.05 * skew - 0.01 * np.maximum(qi - qj, ti - tj)
        gain = np.where(ok, gain, -np.inf)
        best = int(np.argmax(gain))
        if gain[best] > f[i]:
            f[i] = gain[best]
            pred[i] = js[best]
    end = int(np.argmax(f))
    chain = []
    while end >= 0:
        chain.append(end)
        end = int(pred[end])
    chain.reverse()
    return chain


def _keep_increasing(out: np.ndarray) -> np.ndarray:
    """Drop anchors overlapping their predecessor inconsistently.  Chains
    from the DP are already strictly increasing on both axes (pred edges
    require qj < qi and tj < ti), so the common case is a vectorized no-op
    check; the sequential filter only runs when a violation exists."""
    if out.shape[0] <= 1 or (
        (np.diff(out[:, 0]) > 0).all() and (np.diff(out[:, 1]) > 0).all()
    ):
        return out
    keep = [0]
    for i in range(1, out.shape[0]):
        if out[i, 0] > out[keep[-1], 0] and out[i, 1] > out[keep[-1], 1]:
            keep.append(i)
    return out[keep]


def chain_anchors_multi(
    anchors: np.ndarray,
    k: int = 15,
    max_chains: int = 16,
    min_matched: int = 50,
    max_gap: int = DEFAULT_MAX_GAP,
    max_skew: int = DEFAULT_MAX_SKEW,
) -> list[np.ndarray]:
    """Extract up to ``max_chains`` disjoint colinear chains, best first.

    After each best chain is extracted, anchors inside its query-AND-target
    span are removed (same block), while anchors mapping the same query span
    to a different target span (repeat copies) or vice versa survive to seed
    secondary chains.  A chain whose exact-matched base count falls below
    ``min_matched`` stops the extraction (it is kept only as the first)."""
    chains: list[np.ndarray] = []
    remaining = anchors
    while remaining.shape[0] and len(chains) < max_chains:
        chain = chain_anchors(remaining, k, max_gap=max_gap, max_skew=max_skew)
        if chain.shape[0] == 0:
            break
        matched = sum(n for _q, _t, n in chain_to_runs(chain, k))
        if matched < min_matched and chains:
            break
        chains.append(chain)
        if matched < min_matched:
            break
        q0, q1 = int(chain[0, 0]), int(chain[-1, 0]) + k
        t0, t1 = int(chain[0, 1]), int(chain[-1, 1]) + k
        inside = (
            (remaining[:, 0] >= q0)
            & (remaining[:, 0] < q1)
            & (remaining[:, 1] >= t0)
            & (remaining[:, 1] < t1)
        )
        if not inside.any():
            break  # chain removed nothing: avoid an endless loop
        remaining = remaining[~inside]
    return chains


def chain_to_runs(chain: np.ndarray, k: int) -> list[tuple[int, int, int]]:
    """Merge chained anchors into maximal exact-match runs
    (q_start, t_start, len).  Colinear overlapping anchors coalesce;
    different-diagonal overlaps are trimmed so consecutive runs never overlap
    on either sequence.

    Vectorized for the strictly increasing chains chain_anchors emits; any
    other chain goes to the sequential spec, chain_to_runs_spec."""
    chain = np.asarray(chain)
    n = chain.shape[0]
    if n == 0:
        return []
    q = chain[:, 0].astype(np.int64)
    t = chain[:, 1].astype(np.int64)
    if n > 1 and not ((np.diff(q) > 0).all() and (np.diff(t) > 0).all()):
        return chain_to_runs_spec(chain, k)
    # coalescing groups: break at diagonal change or an on-diagonal gap.
    # Within a group, end = last anchor + k; starts may later be trimmed,
    # which never changes ends.  Strict increase bounds every trim at < k
    # (prev end = prev anchor + k and this anchor > prev anchor on both
    # axes), so no run is ever fully shadowed.
    diag = q - t
    brk = np.empty(n, dtype=bool)
    brk[0] = True
    brk[1:] = (diag[1:] != diag[:-1]) | (q[1:] > q[:-1] + k)
    gidx = np.flatnonzero(brk)
    q0 = q[gidx]
    t0 = t[gidx]
    last = np.append(gidx[1:], n) - 1
    end_q = q[last] + k
    end_t = t[last] + k
    delta = np.zeros(gidx.size, dtype=np.int64)
    if gidx.size > 1:
        delta[1:] = np.maximum(
            np.maximum(end_q[:-1] - q0[1:], end_t[:-1] - t0[1:]), 0
        )
    q0 = q0 + delta
    t0 = t0 + delta
    return list(zip(q0.tolist(), t0.tolist(), (end_q - q0).tolist()))


def chain_to_runs_spec(chain: np.ndarray, k: int) -> list[tuple[int, int, int]]:
    """Sequential reference semantics for chain_to_runs (any input)."""
    runs: list[list[int]] = []
    for qpos, tpos in chain:
        qpos, tpos = int(qpos), int(tpos)
        if runs:
            q0, t0, ln = runs[-1]
            # same diagonal and overlapping/adjacent -> extend
            if qpos - q0 == tpos - t0 and qpos <= q0 + ln:
                runs[-1][2] = max(ln, qpos + k - q0)
                continue
            # different diagonal: trim this run's start past the previous end
            delta = max(q0 + ln - qpos, t0 + ln - tpos, 0)
            if delta >= k:
                continue  # fully shadowed by the previous run
            if delta > 0:
                qpos += delta
                tpos += delta
                runs.append([qpos, tpos, k - delta])
                continue
        runs.append([qpos, tpos, k])
    return [tuple(r) for r in runs]
