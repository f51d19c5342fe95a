"""Anchored piecewise alignment for wide-band ("divergent") pairs.

The port of ``seqrush_tpu/align/anchored.py``.  Pairs whose certified band
would be very wide (inversion carriers, high-divergence pairs) take DP only
where the sequences diverge, instead of one wide-band sweep over the whole
pair:

1. **Chain**: exact-match minimizer anchors (ops/anchors.py) and the host
   library's chain DP (native.chain_pairs_native) give maximal exact-match
   runs.
2. **Windows**: exact flank extension shrinks each inter-run gap (plus head
   and tail) to its divergence core.  Cores of at most
   RunnerConfig.wide_host_window_cells cells run in one threaded host call
   (native.window_dp_native, full-matrix exact); larger cores (an inverted
   block) run at full band on the device through kernels A and B, which is
   exact in one pass.
3. **Stitch**: runs ('=' ops) and window CIGARs concatenate into the global
   alignment; gap runs never merge across boundaries because every window is
   flanked by exact-match bases.

Each window's alignment is exact within its window and anchors are exact
matches, so a stitch is globally optimal when the optimum passes through the
chained runs.  With ``RunnerConfig.wide_verify`` every stitched score is
checked against a score-only sweep of kernel A at the certified band; a
stitch that scores worse goes back to the full wide route.

The route sends every window to the host or to the device by the JAX
package's own budgets (SMALL_WINDOW, wide_host_window_cells, the full-band
memory check, _plan_chunks' cuts): the host DP and the device walk may break
equal-score ties differently, so another split would change CIGARs.  For
the same reason a failure of the host library raises rather than re-routing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import anchors as anchors_mod
from ..ops import nw, nw_cuda
from ..native import chain_pairs_native, window_dp_native
from ..utils import to_host

# windows larger than this run at full band in their own bucket; a pair
# with a full-band window whose traceback would bust the memory budget
# falls back to the full wide route
SMALL_WINDOW = 256
# minimum chained exact-match coverage (fraction of min(qlen, tlen));
# below it the chain is too sparse to trust as a global guide
MIN_COVERAGE = 0.05
# run-token budget of a window chunk's walk (windows have few runs); rows
# that overflow it are re-aligned through the opcode walk at the same band
WIN_RUN_MAX = 32


@dataclass
class WidePlan:
    p: int
    rc: bool
    q: np.ndarray
    t: np.ndarray
    # the job's force32 (set by the runner), which a verify retry keeps
    f32: bool = False
    # parts: ("items", [(n, op), ...]) resolved on host, or ("win", job_idx)
    parts: list = field(default_factory=list)


def chain_jobs(al, wide_jobs, pairs) -> list:
    """Best-chain runs for every wide job in one batched C++ call
    (chain_pairs, bit-identical to chain_anchors + chain_to_runs per job).
    Returns a per-job list of run-tuple lists (possibly empty)."""
    anchors = []
    for p, rc, *_ in wide_jobs:
        qi, tj = pairs[p]
        anchors.append(
            anchors_mod.anchor_matches_from_minimizers(
                al._minimizers(int(qi), rc),
                al._minimizers(int(tj), False),
                max_freq=al.cfg.frequency,
                t_sorted=al._minimizers_sorted(int(tj), False),
            )
        )
    offs = np.zeros(len(anchors) + 1, np.int64)
    for w, a in enumerate(anchors):
        offs[w + 1] = offs[w] + a.shape[0]
    if offs[-1]:
        flat = np.concatenate([a for a in anchors if a.shape[0]], axis=0)
        pid = np.repeat(np.arange(len(anchors), dtype=np.int64), np.diff(offs))
        order = np.lexsort((flat[:, 1], flat[:, 0], pid))
        flat = flat[order]
    else:
        flat = np.zeros((0, 2), np.int64)
    chain_pair, chain_off, rq, rt, rl = chain_pairs_native(
        flat[:, 0], flat[:, 1], offs, al.anchor_k,
        max_gap=anchors_mod.DEFAULT_MAX_GAP,
        max_skew=anchors_mod.DEFAULT_MAX_SKEW,
        max_chains=1, min_matched=0,
    )
    runs_per_job = [[] for _ in wide_jobs]
    co = chain_off.tolist()
    rq_l, rt_l, rl_l = rq.tolist(), rt.tolist(), rl.tolist()
    for c, w in enumerate(chain_pair.tolist()):
        runs_per_job[w] = list(
            zip(rq_l[co[c] : co[c + 1]], rt_l[co[c] : co[c + 1]], rl_l[co[c] : co[c + 1]])
        )
    return runs_per_job


def flank_trim_jobs(al, wide_jobs, pairs, runs_per_job):
    """Precompute every job's gap flanks in one flat byte comparison.

    For each job with usable runs, returns (pre, suf) int64 arrays over its
    gap list (gap 0 is the head before the first run, gap i+1 follows run
    i, the last gap is the tail), in the order build_plan's window loop
    visits them.  Values equal _flank_match per gap.  Jobs with empty runs
    map to None."""
    n_jobs = len(wide_jobs)
    qs, ts = [], []
    qoff = np.zeros(n_jobs + 1, np.int64)
    toff = np.zeros(n_jobs + 1, np.int64)
    gq0l, gq1l, gt0l, gt1l, jobl = [], [], [], [], []
    for w, ((p, rc, *_), runs) in enumerate(zip(wide_jobs, runs_per_job)):
        qi, tj = pairs[p]
        q = al.rc_codes[qi] if rc else al.codes[qi]
        t = al.codes[tj]
        qs.append(q)
        ts.append(t)
        qoff[w + 1] = qoff[w] + q.size
        toff[w + 1] = toff[w] + t.size
        if not runs:
            continue
        ra = np.asarray(runs, np.int64).reshape(-1, 3)
        gq0l.append(np.concatenate([[0], ra[:, 0] + ra[:, 2]]) + qoff[w])
        gt0l.append(np.concatenate([[0], ra[:, 1] + ra[:, 2]]) + toff[w])
        gq1l.append(np.concatenate([ra[:, 0], [q.size]]) + qoff[w])
        gt1l.append(np.concatenate([ra[:, 1], [t.size]]) + toff[w])
        jobl.append(np.full(ra.shape[0] + 1, w, np.int64))
    out: list = [None] * n_jobs
    if not jobl:
        return out
    qcat = np.concatenate(qs)
    tcat = np.concatenate(ts)
    gq0 = np.concatenate(gq0l)
    gq1 = np.concatenate(gq1l)
    gt0 = np.concatenate(gt0l)
    gt1 = np.concatenate(gt1l)
    jobs_of = np.concatenate(jobl)

    m = np.maximum(np.minimum(gq1 - gq0, gt1 - gt0), 0)
    # prefix: first mismatch within the m-wide head of the window
    starts = np.cumsum(m) - m
    total = int(m.sum())
    pre = m.copy()
    if total:
        within = np.arange(total, dtype=np.int64) - np.repeat(starts, m)
        neq = qcat[np.repeat(gq0, m) + within] != tcat[np.repeat(gt0, m) + within]
        hits = np.flatnonzero(neq)
        if hits.size:
            hidx = np.searchsorted(hits, starts)
            first_hit = hits[np.minimum(hidx, hits.size - 1)]
            has = (hidx < hits.size) & (first_hit < starts + m)
            pre = np.where(has, first_hit - starts, m)
    # suffix: trailing matches of the remaining m2-wide tail
    m2 = m - pre
    starts2 = np.cumsum(m2) - m2
    total2 = int(m2.sum())
    suf = m2.copy()
    if total2:
        within2 = np.arange(total2, dtype=np.int64) - np.repeat(starts2, m2)
        neq2 = (
            qcat[np.repeat(gq1 - m2, m2) + within2]
            != tcat[np.repeat(gt1 - m2, m2) + within2]
        )
        hits2 = np.flatnonzero(neq2)
        if hits2.size:
            lidx = np.searchsorted(hits2, starts2 + m2) - 1
            last_hit = hits2[np.maximum(lidx, 0)]
            has2 = (lidx >= 0) & (last_hit >= starts2)
            suf = np.where(has2, starts2 + m2 - 1 - last_hit, m2)

    grp_start = np.flatnonzero(
        np.concatenate([[True], jobs_of[1:] != jobs_of[:-1]])
    )
    grp_end = np.append(grp_start[1:], jobs_of.size)
    for s, e in zip(grp_start.tolist(), grp_end.tolist()):
        out[int(jobs_of[s])] = (
            pre[s:e].astype(np.int64),
            suf[s:e].astype(np.int64),
        )
    return out


def build_plan(al, job, pairs, window_jobs: list, runs, flanks) -> WidePlan | None:
    """Split one wide job into parts along its chain ``runs`` (from
    chain_jobs) and gap ``flanks`` (from flank_trim_jobs); window jobs are
    appended to the shared ``window_jobs`` list (batched across all plans)
    as (q window, t window, (p, rc, q0, t0)).  Returns None when no usable
    chain exists (the caller falls back to the full wide route)."""
    p, rc, *_ = job
    qi, tj = pairs[p]
    q = al.rc_codes[qi] if rc else al.codes[qi]
    t = al.codes[tj]
    if not runs:
        return None
    matched = sum(n for _q, _t, n in runs)
    if matched < MIN_COVERAGE * min(q.size, t.size):
        return None

    plan = WidePlan(p, rc, q, t)
    budget = al.cfg.memory_budget_bytes
    jobs_start = len(window_jobs)
    gap_cursor = [0]  # window-call ordinal == flank-table row

    def window(q0, q1, t0, t1):
        # greedy exact extension: minimizer sampling (w) leaves up to ~w
        # matching bases on each side of a divergence core, so most gaps
        # are a long exact flank around one SNP/indel; committing the
        # byte-verified flanks shrinks the core to host-resolvable size
        g = gap_cursor[0]
        pre, suf = int(flanks[0][g]), int(flanks[1][g])
        gap_cursor[0] += 1
        if pre:
            plan.parts.append(("items", [(pre, "=")]))
            q0 += pre
            t0 += pre
        dq, dt = q1 - q0 - suf, t1 - t0 - suf
        if dq == 0 and dt == 0:
            pass
        elif dq == 0:
            plan.parts.append(("items", [(dt, "D")]))
        elif dt == 0:
            plan.parts.append(("items", [(dq, "I")]))
        else:
            # divergence core -> window job: small cores go to the batched
            # host DP, larger ones to device window chunks.  No analytic
            # shortcut for anchor-free cores: short homology islands inside
            # an inverted block can beat a pure I/D skip, and only DP finds
            # them
            mx = max(dq, dt)
            if mx > SMALL_WINDOW:
                # full-band window: traceback must fit the budget
                tmax = _ru(dq + dt + 1, 256)
                if 8 * (tmax + 2) * (mx + 2) > budget:
                    return False  # too big to brute-force: full route
            plan.parts.append(("win", len(window_jobs)))
            window_jobs.append((q[q0 : q1 - suf], t[t0 : t1 - suf], (p, rc, q0, t0)))
        if suf:
            plan.parts.append(("items", [(suf, "=")]))
        return True

    ok = window(0, runs[0][0], 0, runs[0][1])
    for i, (q0, t0, n0) in enumerate(runs):
        if not ok:
            break
        plan.parts.append(("items", [(n0, "=")]))
        nxt = runs[i + 1][:2] if i + 1 < len(runs) else (q.size, t.size)
        ok = window(q0 + n0, nxt[0], t0 + n0, nxt[1])
    if not ok:
        del window_jobs[jobs_start:]  # this plan's windows were appended last
        return None
    return plan


def _flank_match(q, t, q0, q1, t0, t1) -> tuple[int, int]:
    """(prefix, suffix) exact-match lengths of the window q[q0:q1] vs
    t[t0:t1], with prefix + suffix <= min window side (prefix wins ties)."""
    m = min(q1 - q0, t1 - t0)
    if m <= 0:
        return 0, 0
    neq = q[q0 : q0 + m] != t[t0 : t0 + m]
    if not neq.any():
        return m, 0
    pre = int(np.argmax(neq))
    m2 = m - pre
    neq2 = q[q1 - m2 : q1] != t[t1 - m2 : t1]
    suf = m2 if not neq2.any() else int(np.argmax(neq2[::-1]))
    return pre, suf


def _ru(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _np2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _plan_chunks(al, jobs, pending):
    """Cut (job, band) entries into dispatch chunks: band-bucket
    boundaries, trip-count jumps (a chunk's serial steps are its max
    window's, so tiny windows must not pad to a big window's trip count),
    and the memory budget."""
    pending = sorted(
        pending, key=lambda e: (e[1], max(jobs[e[0]][0].size, jobs[e[0]][1].size))
    )
    chunks = []
    i = 0
    while i < len(pending):
        chunk = [pending[i]]
        band = pending[i][1]
        j0 = pending[i][0]
        tmax0 = max(_ru(jobs[j0][0].size + jobs[j0][1].size + 1, 256), 512)
        i += 1
        while i < len(pending):
            j, bj = pending[i]
            trial_band = max(band, bj)
            qw, tw = jobs[j][0], jobs[j][1]
            tmax = _ru(qw.size + tw.size + 1, 256)
            B = _np2(len(chunk) + 1)
            if (
                trial_band > 2 * band + 128
                or tmax > 2 * tmax0
                or B * (tmax + 2) * (trial_band + 1)
                > al.cfg.memory_budget_bytes
            ):
                break
            chunk.append((j, bj))
            band = trial_band
            i += 1
        chunks.append((chunk, band))
    return chunks


def _initial_window_band(qw, tw) -> int:
    mx = max(qw.size, tw.size)
    if mx > SMALL_WINDOW:
        return mx + 1  # full band: exact in one pass
    return min(_ru(abs(qw.size - tw.size) + 65, 128) - 1, mx + 1)


def dispatch_windows(al, jobs, pen) -> tuple[list, list, list]:
    """Align windows: the host C++ DP for everything under the cell budget
    (exact full-matrix, threaded; it runs while the narrow chunks compute
    on the device), device dispatches only for oversized windows.  Returns
    (in-flight device chunks, planned chunks, out), where ``out`` already
    holds the host-aligned items."""
    out = [None] * len(jobs)
    if not jobs:
        return [], [], out
    budget = al.cfg.wide_host_window_cells
    # bulk route: a workload whose total cells are under
    # wide_host_total_cells runs entirely on the host
    total_cells = sum((qw.size + 1) * (tw.size + 1) for qw, tw, _src in jobs)
    host_all = bool(budget) and 0 < total_cells <= al.cfg.wide_host_total_cells
    host_sel = []
    device_sel = []
    for j, (qw, tw, _src) in enumerate(jobs):
        if budget and (host_all or (qw.size + 1) * (tw.size + 1) <= budget):
            host_sel.append(j)
        else:
            device_sel.append(j)
    if host_sel:
        _scores, items_all = window_dp_native(
            [jobs[j][0] for j in host_sel],
            [jobs[j][1] for j in host_sel],
            pen,
            threads=al.cfg.threads,
        )
        for j, items in zip(host_sel, items_all):
            out[j] = items
        al.stats["host_windows"] += len(host_sel)
    if not device_sel:
        return [], [], out
    pending = [
        (j, _initial_window_band(jobs[j][0], jobs[j][1])) for j in device_sel
    ]
    planned = _plan_chunks(al, jobs, pending)
    # dispatch at most one chunk eagerly (device work starts now); the rest
    # stay planned: each in-flight chunk holds its [B, tmax, W] traceback on
    # the device, so depth is capped at 2 (collect_windows keeps one chunk
    # ahead), as in the runner's own chunk pipeline
    inflight = []
    if planned:
        chunk, band = planned.pop(0)
        inflight.append(_dispatch_window_chunk(al, jobs, chunk, band, pen))
    return inflight, planned, out


def collect_windows(al, jobs, state, pen) -> list:
    """Collect dispatched window chunks (dispatching the next planned chunk
    before each collect: a depth-2 pipeline, bounded device memory);
    escalation rounds (band certificate failures) re-dispatch.  Returns the
    per-job CIGAR item lists."""
    inflight, planned, out = state
    generations = 0
    while inflight or planned:
        nxt = []
        while inflight or planned:
            if planned and len(inflight) < 2:
                chunk, band = planned.pop(0)
                inflight.append(
                    _dispatch_window_chunk(al, jobs, chunk, band, pen)
                )
                continue
            _collect_window_chunk(al, jobs, inflight.pop(0), pen, out, nxt)
        if nxt:
            generations += 1
            if generations > 12:  # escalation terminates at full band
                raise RuntimeError("window escalation did not converge")
            planned = _plan_chunks(al, jobs, nxt)
    return out


def pack_windows(jobs, chunk, band):
    """Host-packed kernel inputs of a window chunk: (Q [B, lq], T [B, lt]
    uint8 padded with QPAD/TPAD, qlens [B], tlens [B] int32, band, tmax).
    B is a power of two, at least 8; lq and lt round up to 128 and tmax to
    256; rows past the chunk's windows have length 0."""
    B = max(_np2(len(chunk)), 8)
    lq = _ru(max(jobs[j][0].size for j, _b in chunk), 128)
    lt = _ru(max(jobs[j][1].size for j, _b in chunk), 128)
    band = min(band, max(lq, lt) + 1)
    Q = np.full((B, lq), nw.QPAD, np.uint8)
    T = np.full((B, lt), nw.TPAD, np.uint8)
    qlens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    for b, (j, _bj) in enumerate(chunk):
        qw, tw = jobs[j][0], jobs[j][1]
        Q[b, : qw.size] = qw
        T[b, : tw.size] = tw
        qlens[b] = qw.size
        tlens[b] = tw.size
    tmax = _ru(int((qlens + tlens).max()) + 1, 256)
    return Q, T, qlens, tlens, band, tmax


def _window_record(jobs, sel, B, band, tmax, emit):
    return {"kind": "window", "B": B, "band": band, "tmax": tmax, "emit": emit,
            # each window as [pair index, reverse, q start, t start, q length,
            # t length] in the oriented pair's coordinates
            "jobs": [[int(x) for x in jobs[j][2]] + [int(jobs[j][0].size), int(jobs[j][1].size)]
                     for j in sel]}


def _dispatch_window_chunk(al, jobs, chunk, band, pen):
    """Launch the sweep and the walk for one window chunk (run tokens of at
    most WIN_RUN_MAX runs a window where tmax + 4 < 2^15 and emit is not
    'ops', else opcodes); the scores and the walk's output start copying
    back to pinned memory without blocking."""
    Q, T, qlens, tlens, band, tmax = pack_windows(jobs, chunk, band)
    B = Q.shape[0]
    use_runs = nw.runs_fit(tmax) and al.cfg.emit != "ops"
    al.stats["cells_padded"] += B * (tmax + 2) * (band + 1)
    al.stats["dispatches"].append(_window_record(jobs, [j for j, _bj in chunk], B, band, tmax,
                                                 "runs" if use_runs else "ops"))
    dev = al.device
    Qd, Td, qd, td = (torch.from_numpy(a).to(dev) for a in (Q, T, qlens, tlens))
    scores, tb = nw_cuda.nw_align(Qd, Td, qd, td, band=band, tmax=tmax, **pen)
    if use_runs:
        out = nw_cuda.nw_walk_runs(tb, qd, td, band=band, tmax=tmax, run_max=WIN_RUN_MAX)
    else:
        out = (nw_cuda.nw_walk(tb, qd, td, band=band, tmax=tmax),)
    del tb  # stream-ordered: the allocator reuses it only after the walk
    scores, out, ready = to_host(scores, out)
    return chunk, band, tmax, use_runs, scores, out, ready, (Q, T, qlens, tlens)


def _collect_window_chunk(al, jobs, disp, pen, out, nxt):
    chunk, band, tmax, use_runs, scores, data, ready, packed = disp
    if ready is not None:
        ready.synchronize()
    scores = scores.numpy()
    data = [a.numpy() for a in data]

    ok_rows, ok_jobs, overflow = [], [], []
    for b, (j, _bj) in enumerate(chunk):
        qw, tw = jobs[j][0], jobs[j][1]
        s = int(scores[b])
        exact = band >= max(qw.size, tw.size) or (
            0 <= s < al._cert_bound(band, qw.size, tw.size)
        )
        if not exact:
            al.stats["band_escalations"] += 1
            k = al._escalated_band(max(s, 0), band, qw.size, tw.size)
            nxt.append((j, k))
            continue
        al.stats["cells_true"] += (qw.size + tw.size + 1) * (band + 1)
        if use_runs and data[1][b] > WIN_RUN_MAX:
            al.stats["run_overflows"] += 1
            overflow.append((b, j))
            continue
        ok_rows.append(b)
        ok_jobs.append(j)
    if ok_rows:
        qs, ts = [jobs[j][0] for j in ok_jobs], [jobs[j][1] for j in ok_jobs]
        if use_runs:
            items_all = nw.decode_runs_batch(data[0][ok_rows], data[1][ok_rows], qs, ts)
        else:
            items_all = nw.decode_batch(data[0][ok_rows], qs, ts)
        for j, items in zip(ok_jobs, items_all):
            out[j] = items
    if overflow:
        # a window whose walk has more than WIN_RUN_MAX runs: its rows alone,
        # re-aligned through the opcode walk at the (certified) band
        rows = [b for b, _j in overflow]
        Q, T, qlens, tlens = (a[rows] for a in packed)
        al.stats["dispatches"].append(_window_record(jobs, [j for _b, j in overflow], len(rows),
                                                     band, tmax, "ops"))
        Qd, Td, qd, td = (torch.from_numpy(a).to(al.device) for a in (Q, T, qlens, tlens))
        _s, tb = nw_cuda.nw_align(Qd, Td, qd, td, band=band, tmax=tmax, **pen)
        ops = nw_cuda.nw_walk(tb, qd, td, band=band, tmax=tmax)
        del tb
        items_all = nw.decode_batch(ops.cpu().numpy(), [jobs[j][0] for _b, j in overflow],
                                    [jobs[j][1] for _b, j in overflow])
        for (_b, j), items in zip(overflow, items_all):
            out[j] = items


def stitch(
    plan: WidePlan, witems: list
) -> tuple[list[tuple[int, str]], int, int]:
    """Returns (items, consumed_q, consumed_t).  Parts are internally
    coalesced run-length lists, so only the boundary items can merge."""
    items: list[tuple[int, str]] = []
    nq = nt = 0
    for kind, x in plan.parts:
        src = x if kind == "items" else witems[x]
        if not src:
            continue
        for n, op in src:
            if op != "D":
                nq += n
            if op != "I":
                nt += n
        if items and items[-1][1] == src[0][1]:
            items[-1] = (items[-1][0] + src[0][0], src[0][1])
            items.extend(src[1:])
        else:
            items.extend(src)
    return items, nq, nt


def cigar_cost(items, pen) -> int:
    """Score of a CIGAR under ``pen`` (mismatch, o1, e1, o2, e2; o2 < 0 is
    one-piece)."""
    s = 0
    for n, op in items:
        if op == "X":
            s += n * pen["mismatch"]
        elif op in "ID":
            g1 = pen["o1"] + n * pen["e1"]
            s += min(g1, pen["o2"] + n * pen["e2"]) if pen["o2"] >= 0 else g1
    return s


def max_excursion(items) -> int:
    """Maximum |i - j| along the alignment path ('I' consumes query)."""
    d = mx = 0
    for n, op in items:
        if op == "I":
            d -= n
        elif op == "D":
            d += n
        mx = max(mx, abs(d))
    return mx


def pack_verify(entries, sel):
    """Host-packed inputs of one verify chunk: entries[j] = (q, t, band_v,
    (pair index, reverse)) for j in sel.  B is a power of two, at least 8; lq and lt round up to
    256 and tmax to 512.  Returns (Q, T, qlens, tlens, band, tmax)."""
    band = max(int(entries[j][2]) for j in sel)
    B = max(_np2(len(sel)), 8)
    lq = _ru(max(entries[j][0].size for j in sel), 256)
    lt = _ru(max(entries[j][1].size for j in sel), 256)
    Q = np.full((B, lq), nw.QPAD, np.uint8)
    T = np.full((B, lt), nw.TPAD, np.uint8)
    qlens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    for b, j in enumerate(sel):
        qw, tw = entries[j][0], entries[j][1]
        Q[b, : qw.size] = qw
        T[b, : tw.size] = tw
        qlens[b] = qw.size
        tlens[b] = tw.size
    tmax = _ru(int((qlens + tlens).max()) + 1, 512)
    return Q, T, qlens, tlens, band, tmax


def verify_scores(al, entries, pen) -> np.ndarray:
    """Score-only banded sweep at each pair's certified band: entries are
    (q, t, band_v, (pair index, reverse)); returns the in-band optimal scores.  No traceback
    tensor, no walk: memory is the DP state only, so one chunk holds 256
    pairs."""
    out = np.zeros(len(entries), np.int64)
    order = np.argsort([e[2] for e in entries], kind="stable")
    i = 0
    dev = al.device
    while i < len(order):
        sel = order[i : i + 256]
        i += len(sel)
        Q, T, qlens, tlens, band, tmax = pack_verify(entries, sel)
        B = Q.shape[0]
        al.stats["cells_padded"] += B * (tmax + 2) * (band + 1)
        band = min(band, max(Q.shape[1], T.shape[1]) + 1)
        al.stats["dispatches"].append(
            {"kind": "verify", "B": B, "band": band, "tmax": tmax,
             "jobs": [[int(x) for x in entries[j][3]] for j in sel]}
        )
        Qd, Td, qd, td = (torch.from_numpy(a).to(dev) for a in (Q, T, qlens, tlens))
        scores, _ = nw_cuda.nw_align(
            Qd, Td, qd, td, band=band, tmax=tmax, with_traceback=False, **pen
        )
        out[sel] = scores.cpu().numpy()[: len(sel)]
    return out
