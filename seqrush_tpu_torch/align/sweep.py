"""Seed-and-extend aligner backend (the ``--aligner sweepga`` backend).

The port of ``seqrush_tpu/align/sweep.py``.  Three stages, as in the
reference's sweepga backend (FastGA seed-and-extend, then a 1:1 plane-sweep
filter of its PAF records):

1. **Seed and chain**: minimizer anchors with the ``--frequency`` seed cutoff
   (ops/anchors.py), then up to 16 disjoint colinear chains a pair, each a
   candidate mapping (repeats and rearranged blocks each get their own),
   all pairs in one C++ call (``native.chain_pairs_native``).
2. **1:1 plane-sweep filter**: mappings shorter than MIN_BLOCK_LENGTH are
   dropped; the rest are scored by log(block length) * identity and swept
   on the query axis, then the target axis, per (query, target) sequence
   pair: a mapping more than OVERLAP_THRESHOLD shadowed by a better one on
   an axis goes.
3. **Gap fill and stitch**: every inter-run gap of the surviving chains is
   aligned exactly, by the host C++ DP up to ``wide_host_window_cells``
   cells and above it by kernels A and B in chunks of up to 8,192 windows
   (sorted by size), the walk fetched as run tokens (at most GAP_RUN_MAX a
   window; the windows that overflow are repacked into a chunk of their own
   and re-aligned through the opcode walk); the host library's
   ``stitch_records`` then assembles the records' CIGARs and scores.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..native import chain_pairs_native, stitch_records_native, window_dp_native
from ..ops import anchors as anchors_mod
from ..ops import nw, nw_cuda
from ..ops.wfa import Penalties
from .runner import AlignmentResult, RunnerConfig, WfaAligner, _next_pow2, _round_up

MIN_BLOCK_LENGTH = 100  # sweepga FilterConfig.min_block_length
OVERLAP_THRESHOLD = 0.95  # sweepga FilterConfig.overlap_threshold
GAP_CHUNK = 8192  # device gap windows per dispatch
# run-token budget of a gap chunk's walk: windows are tens of bases with a
# handful of runs; rows that overflow it retry through the opcode walk
GAP_RUN_MAX = 24
_OP_CODE = {"=": 0, "X": 1, "I": 2, "D": 3}  # window_dp / stitch_records ops
_OP_CHARS = ("=", "X", "I", "D")


@dataclass
class _Mapping:
    """One candidate chain mapping (a FastGA PAF record analog)."""

    pair_idx: int
    qi: int
    tj: int
    is_rev: bool
    runs: np.ndarray  # [n, 3] (q0, t0, len) exact-match runs
    qlen: int  # full query length (for RC-space -> original-strand coords)
    q_start: int = field(init=False)
    q_end: int = field(init=False)
    t_start: int = field(init=False)
    t_end: int = field(init=False)
    matched: int = field(init=False)

    def __post_init__(self):
        self.runs = np.asarray(self.runs, dtype=np.int64).reshape(-1, 3)
        self.q_start = int(self.runs[0, 0])
        self.q_end = int(self.runs[-1, 0] + self.runs[-1, 2])
        self.t_start = int(self.runs[0, 1])
        self.t_end = int(self.runs[-1, 1] + self.runs[-1, 2])
        self.matched = int(self.runs[:, 2].sum())

    @property
    def block_len(self) -> int:
        return max(self.q_end - self.q_start, self.t_end - self.t_start)

    @property
    def identity(self) -> float:
        return self.matched / max(self.block_len, 1)

    @property
    def score(self) -> float:
        """LogLengthIdentity (sweepga ScoringFunction): longer AND more
        similar mappings dominate the sweep."""
        return float(np.log(max(self.block_len, 2)) * self.identity)

    def q_interval_fwd(self) -> tuple[int, int]:
        """Query interval on the original strand (reverse records' chain
        coordinates are in RC space; the sweep compares intervals on one
        strand)."""
        if self.is_rev:
            return self.qlen - self.q_end, self.qlen - self.q_start
        return self.q_start, self.q_end


def _plane_sweep_axis(mappings: list[_Mapping], axis: str) -> set[int]:
    """Indices of mappings surviving the 1:1 sweep on one axis.

    The sweep runs per (query, target) sequence pair (sequences without a
    PanSN '#' prefix each form their own group).  Within a pair, records are
    walked best score first; a record is discarded when a better-scoring
    kept record shadows more than OVERLAP_THRESHOLD of its axis interval."""
    by_group: dict[tuple[int, int], list[int]] = {}
    for idx, m in enumerate(mappings):
        by_group.setdefault((m.qi, m.tj), []).append(idx)
    keep: set[int] = set()
    for idxs in by_group.values():
        idxs.sort(key=lambda i: (-mappings[i].score, i))
        kept_iv: list[tuple[int, int, int]] = []  # (start, end, idx)
        for i in idxs:
            m = mappings[i]
            s, e = m.q_interval_fwd() if axis == "query" else (m.t_start, m.t_end)
            length = max(e - s, 1)
            shadowed = False
            for ks, ke, _ki in kept_iv:
                ov = min(e, ke) - max(s, ks)
                if ov > OVERLAP_THRESHOLD * length:
                    shadowed = True
                    break
            if not shadowed:
                keep.add(i)
                kept_iv.append((s, e, i))
    return keep


def filter_one_to_one(mappings: list[_Mapping]) -> list[_Mapping]:
    """min_block_length, then the query-axis plane sweep followed by the
    target-axis sweep over the query survivors (sequential, not an
    intersection of independent sweeps: the per-query best is kept, then
    target collisions among those are resolved)."""
    mappings = [m for m in mappings if m.block_len >= MIN_BLOCK_LENGTH]
    if not mappings:
        return []
    keep_q = _plane_sweep_axis(mappings, "query")
    survivors = [m for i, m in enumerate(mappings) if i in keep_q]
    keep_t = _plane_sweep_axis(survivors, "target")
    return [m for i, m in enumerate(survivors) if i in keep_t]


class SweepAligner(WfaAligner):
    """Minimizer-chain + 1:1 filter + gap-fill aligner; drop-in for
    WfaAligner (its forced-orientation calls, align_pairs_oriented, are
    WfaAligner's)."""

    def __init__(self, seqs, config: RunnerConfig | None = None, k: int = 15, w: int = 10,
                 device: str | torch.device = "cuda"):
        super().__init__(seqs, config, device=device)
        # WfaAligner's per-(sequence, orientation) minimizer cache, at this
        # backend's k and w
        self.anchor_k = k
        self.anchor_w = w
        self.stats.setdefault("chains", 0)
        self.stats.setdefault("filtered_1to1", 0)
        # the tests force the plain Python stitch to hold the C++ one to it
        self.force_python_stitch = False

    def align_pairs(self, pairs: np.ndarray) -> list[AlignmentResult]:
        t0 = time.time()
        if len(pairs) == 0:
            return []
        is_rev = self.choose_orientations(pairs)
        pen = Penalties.from_scores(self.cfg.scores)

        # stage 1: candidate chains of every pair in one C++ call
        anchors_per_pair = [
            anchors_mod.anchor_matches_from_minimizers(
                self._minimizers(int(qi), bool(is_rev[p])),
                self._minimizers(int(tj), False),
                max_freq=self.cfg.frequency,
                t_sorted=self._minimizers_sorted(int(tj), False),
            )
            for p, (qi, tj) in enumerate(pairs)
        ]
        offs = np.zeros(len(pairs) + 1, np.int64)
        for p, a in enumerate(anchors_per_pair):
            offs[p + 1] = offs[p] + a.shape[0]
        if offs[-1]:
            flat = np.concatenate([a for a in anchors_per_pair if a.shape[0]], axis=0)
            # per-pair (q, t) sort in one global lexsort
            pid = np.repeat(np.arange(len(pairs), dtype=np.int64), np.diff(offs))
            flat = flat[np.lexsort((flat[:, 1], flat[:, 0], pid))]
        else:
            flat = np.zeros((0, 2), np.int64)
        chain_pair, chain_off, runs_q, runs_t, runs_len = chain_pairs_native(
            flat[:, 0], flat[:, 1], offs, self.anchor_k,
            max_gap=anchors_mod.DEFAULT_MAX_GAP, max_skew=anchors_mod.DEFAULT_MAX_SKEW,
            max_chains=16, min_matched=50,
        )
        runs_all = np.stack([runs_q, runs_t, runs_len], axis=1)
        co = chain_off.tolist()
        mappings: list[_Mapping] = []
        for c, p in enumerate(chain_pair.tolist()):
            if co[c + 1] > co[c]:
                qi, tj = pairs[p]
                q = self.rc_codes[qi] if is_rev[p] else self.codes[qi]
                mappings.append(_Mapping(int(p), int(qi), int(tj), bool(is_rev[p]),
                                         runs_all[co[c] : co[c + 1]], q.size))
        self.stats["chains"] += len(mappings)

        # stage 2: the 1:1 plane-sweep filter
        survivors = filter_one_to_one(mappings)
        self.stats["filtered_1to1"] += len(mappings) - len(survivors)

        # stage 3: gap fill and stitch
        if self.force_python_stitch:
            items_per, scores = self._stitch_python(survivors, self._fill_gaps(survivors, pen), pen)
        else:
            items_per, scores = self._stitch_all_native(survivors, pen)
        results = []
        dropped_pairs = set(range(len(pairs)))
        for mi, m in enumerate(survivors):
            dropped_pairs.discard(m.pair_idx)
            results.append(AlignmentResult(m.qi, m.tj, m.is_rev, score=int(scores[mi]),
                                           cigar=items_per[mi], query_start=m.q_start,
                                           target_start=m.t_start))
        self.stats["dropped"] += len(dropped_pairs)
        self.stats["alignments"] += len(results)
        self.stats["wall_s"] += time.time() - t0
        return results

    def _stitch_python(self, survivors, gap_cigars, pen: Penalties):
        """Plain stitch: per-record Python assembly over the gap-CIGAR dict,
        the version stitch_records is held to."""
        items_per: list[list[tuple[int, str]]] = []
        scores: list[int] = []
        for mi, m in enumerate(survivors):
            items: list[tuple[int, str]] = []

            def extend(src):
                # sources are internally coalesced run-length lists, so only
                # the boundary item can merge
                if not src:
                    return
                if items and items[-1][1] == src[0][1]:
                    items[-1] = (items[-1][0] + src[0][0], src[0][1])
                    items.extend(src[1:])
                else:
                    items.extend(src)

            runs_l = m.runs.tolist()
            for g, (q0, t0_, n0) in enumerate(runs_l):
                extend([(n0, "=")])
                if g < len(runs_l) - 1:
                    q1, t1_, _ = runs_l[g + 1]
                    gq0, gt0 = q0 + n0, t0_ + n0
                    gi = gap_cigars.get((mi, g))
                    if gi is not None:
                        extend(gi)
                    else:
                        # touching next run (no gap on either axis)
                        tmp = []
                        if q1 - gq0 > 0:
                            tmp.append((q1 - gq0, "I"))
                        if t1_ - gt0 > 0:
                            tmp.append((t1_ - gt0, "D"))
                        extend(tmp)
            items_per.append(items)
            scores.append(_cigar_cost(items, pen))
        return items_per, scores

    def _split_gap_jobs(self, survivors):
        """The gap jobs, split into those the host DP takes (at most
        wide_host_window_cells cells) and those the device takes."""
        budget = self.cfg.wide_host_window_cells
        host, dev = [], []
        for j in self._gap_jobs(survivors):
            on_host = budget and (j[2].size + 1) * (j[3].size + 1) <= budget
            (host if on_host else dev).append(j)
        return host, dev

    def _stitch_all_native(self, survivors, pen: Penalties):
        """Gap fill with flat host-DP results and device chunks, then one
        stitch_records call; returns (items lists, scores)."""
        if not survivors:
            return [], []
        kpen = pen.kernel_kwargs()
        rec_off = np.zeros(len(survivors) + 1, np.int64)
        for i, m in enumerate(survivors):
            rec_off[i + 1] = rec_off[i] + m.runs.shape[0]
        host, dev = self._split_gap_jobs(survivors)
        # host windows: C++ DP, results stay flat
        _hs, ops_h, lens_h, counts_h, item_offs_h = window_dp_native(
            [j[2] for j in host], [j[3] for j in host], kpen, threads=self.cfg.threads, flat=True)
        self.stats["host_windows"] += len(host)
        ids_h = np.array([rec_off[j[0]] + j[1] for j in host], dtype=np.int64)
        # device windows: item lists from the chunked dispatches, flattened
        dev_cigars: dict[tuple[int, int], list[tuple[int, str]]] = {}
        self._fill_device_gaps(dev, pen, dev_cigars)
        idl, cnl, opl, lnl = [], [], [], []
        for (mi, g), items in dev_cigars.items():
            idl.append(int(rec_off[mi]) + g)
            cnl.append(len(items))
            for n, c in items:
                opl.append(_OP_CODE[c])
                lnl.append(n)
        ids_d = np.array(idl, dtype=np.int64)
        counts_d = np.array(cnl, dtype=np.int64)
        starts_d = np.zeros(ids_d.size, np.int64)
        if ids_d.size:
            starts_d[1:] = np.cumsum(counts_d)[:-1]
        ops_d = np.array(opl, dtype=np.uint8)
        lens_d = np.array(lnl, dtype=np.int32)

        # merge both sources into one id-sorted flat gap table
        all_ids = np.concatenate([ids_h, ids_d])
        all_counts = np.concatenate([counts_h, counts_d])
        all_starts = np.concatenate([item_offs_h[:-1][: ids_h.size], starts_d + ops_h.size])
        ops_all = np.concatenate([ops_h, ops_d])
        lens_all = np.concatenate([lens_h, lens_d])
        order = np.argsort(all_ids, kind="stable")
        sel_counts = all_counts[order]
        sel_starts = all_starts[order]
        total = int(sel_counts.sum())
        if total:
            flat_idx = (
                np.arange(total, dtype=np.int64)
                - np.repeat(np.cumsum(sel_counts) - sel_counts, sel_counts)
                + np.repeat(sel_starts, sel_counts)
            )
            gap_ops = ops_all[flat_idx]
            gap_lens = lens_all[flat_idx]
        else:
            gap_ops = np.zeros(0, np.uint8)
            gap_lens = np.zeros(0, np.int32)
        gap_off = np.zeros(order.size + 1, np.int64)
        gap_off[1:] = np.cumsum(sel_counts)

        runs_flat = np.concatenate([m.runs for m in survivors])
        o_ops, o_lens, o_off, o_scores = stitch_records_native(
            runs_flat[:, 0], runs_flat[:, 1], runs_flat[:, 2], rec_off,
            gap_ops, gap_lens, gap_off, all_ids[order], kpen,
        )
        chars = np.take(np.array(_OP_CHARS), o_ops)
        flat_pairs = list(zip(o_lens.tolist(), chars.tolist()))
        bounds = o_off.tolist()
        items_per = [flat_pairs[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        return items_per, o_scores.tolist()

    def _gap_jobs(self, survivors):
        """(mapping_idx, gap_idx, q_window, t_window, src) for every
        inter-run gap that needs alignment (dq > 0 or dt > 0); src is
        (pair index, reverse, q start, t start) in the oriented pair."""
        gap_jobs = []
        for mi, m in enumerate(survivors):
            q = self.rc_codes[m.qi] if m.is_rev else self.codes[m.qi]
            t = self.codes[m.tj]
            ra = m.runs
            gq0 = ra[:-1, 0] + ra[:-1, 2]
            gt0 = ra[:-1, 1] + ra[:-1, 2]
            dq = ra[1:, 0] - gq0
            dt = ra[1:, 1] - gt0
            for g in np.flatnonzero((dq > 0) | (dt > 0)).tolist():
                a, b = int(gq0[g]), int(gt0[g])
                gap_jobs.append((mi, g, q[a : a + int(dq[g])], t[b : b + int(dt[g])],
                                 (m.pair_idx, int(m.is_rev), a, b)))
        return gap_jobs

    def _fill_gaps(self, survivors: list[_Mapping], pen: Penalties):
        """Every inter-anchor gap window aligned exactly, as a dict
        (mapping_idx, gap_idx) -> items: the host C++ DP under the cell
        budget, device chunks above it."""
        gap_cigars: dict[tuple[int, int], list[tuple[int, str]]] = {}
        host, dev = self._split_gap_jobs(survivors)
        if host:
            _s, items_all = window_dp_native([j[2] for j in host], [j[3] for j in host],
                                             pen.kernel_kwargs(), threads=self.cfg.threads)
            for j, items in zip(host, items_all):
                gap_cigars[(j[0], j[1])] = items
            self.stats["host_windows"] += len(host)
        self._fill_device_gaps(dev, pen, gap_cigars)
        return gap_cigars

    def _fill_device_gaps(self, jobs, pen: Penalties, gap_cigars) -> None:
        """The device windows, sorted by size so each chunk's padding is
        tight, in chunks of GAP_CHUNK windows."""
        jobs = sorted(jobs, key=lambda j: (max(j[2].size, j[3].size), j[2].size))
        for lo in range(0, len(jobs), GAP_CHUNK):
            self._fill_gap_chunk(jobs[lo : lo + GAP_CHUNK], pen, gap_cigars)

    def _gap_dispatch(self, gap_jobs, pen: Penalties, emit: str):
        """Pack a gap chunk (pack_gap_chunk), record it and run kernel A:
        (packed inputs on the device, band, tmax, traceback)."""
        Q, T, qlens, tlens, band, tmax = pack_gap_chunk(gap_jobs)
        self.stats["dispatches"].append(
            {"kind": "gap", "B": Q.shape[0], "band": band, "tmax": tmax, "emit": emit,
             # each window as [pair index, reverse, q start, t start, q length,
             # t length] in the oriented pair's coordinates
             "jobs": [[*map(int, j[4]), int(j[2].size), int(j[3].size)] for j in gap_jobs]})
        self.stats["cells_padded"] += Q.shape[0] * (tmax + 2) * (band + 1)
        Qd, Td, qd, td = (torch.from_numpy(a).to(self.device) for a in (Q, T, qlens, tlens))
        _scores, tb = nw_cuda.nw_align(Qd, Td, qd, td, band=band, tmax=tmax, **pen.kernel_kwargs())
        return qd, td, band, tmax, tb

    def _fill_gap_chunk(self, gap_jobs, pen: Penalties, gap_cigars) -> None:
        """One device chunk of gap windows: kernel A with traceback, then
        kernel B's runs mode and the run decode; the windows whose walk has
        more than GAP_RUN_MAX runs go to _fill_gap_opcodes.  Past the tokens'
        reach (tmax + 4 >= 2^15) or under emit='ops' the chunk takes the
        opcode walk whole."""
        tmax = _round_up(max(j[2].size + j[3].size for j in gap_jobs) + 1, 256)  # pack_gap_chunk's
        if not nw.runs_fit(tmax) or self.cfg.emit == "ops":
            self._fill_gap_opcodes(gap_jobs, pen, gap_cigars)
            return
        qd, td, band, tmax, tb = self._gap_dispatch(gap_jobs, pen, "runs")
        tokens, counts = nw_cuda.nw_walk_runs(tb, qd, td, band=band, tmax=tmax, run_max=GAP_RUN_MAX)
        del tb
        n = len(gap_jobs)
        tokens, counts = tokens[:n].cpu().numpy(), counts[:n].cpu().numpy()
        ok = counts <= GAP_RUN_MAX
        ok_jobs = [j for j, k in zip(gap_jobs, ok) if k]
        if ok_jobs:
            items_all = nw.decode_runs_batch(tokens[ok], counts[ok], [j[2] for j in ok_jobs],
                                             [j[3] for j in ok_jobs])
            for j, items in zip(ok_jobs, items_all):
                gap_cigars[(j[0], j[1])] = items
        overflow = [j for j, k in zip(gap_jobs, ok) if not k]
        self.stats["run_overflows"] += len(overflow)
        if overflow:
            # repack only the overflowing windows: their own chunk's shape
            # (and band) rather than the padded whole
            self._fill_gap_opcodes(overflow, pen, gap_cigars)

    def _fill_gap_opcodes(self, gap_jobs, pen: Penalties, gap_cigars) -> None:
        """Gap windows through kernels A and B in their own chunk, the walk
        emitting opcodes, and the opcode decode."""
        qd, td, band, tmax, tb = self._gap_dispatch(gap_jobs, pen, "ops")
        ops = nw_cuda.nw_walk(tb, qd, td, band=band, tmax=tmax)
        del tb
        items_all = nw.decode_batch(ops[: len(gap_jobs)].cpu().numpy(), [j[2] for j in gap_jobs],
                                    [j[3] for j in gap_jobs])
        for j, items in zip(gap_jobs, items_all):
            gap_cigars[(j[0], j[1])] = items


def pack_gap_chunk(gap_jobs):
    """Kernel inputs of one gap chunk of (mapping_idx, gap_idx, q_window,
    t_window, ...) jobs: (Q [B, lq], T [B, lt] uint8, qlens,
    tlens [B] int32, band, tmax).  B = max(next_pow2, 8), lq and lt round up
    to 128, band = min(round_up(max |dq - dt| + 65, 128) - 1,
    max(lq, lt) + 1), tmax rounds up to 256: the JAX package's shapes (the
    band decides tie-broken CIGARs)."""
    B = max(_next_pow2(len(gap_jobs)), 8)
    lq = _round_up(max(max(j[2].size for j in gap_jobs), 1), 128)
    lt = _round_up(max(max(j[3].size for j in gap_jobs), 1), 128)
    Q = np.full((B, lq), nw.QPAD, np.uint8)
    T = np.full((B, lt), nw.TPAD, np.uint8)
    qlens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    for b, (_, _, qw, tw, *_src) in enumerate(gap_jobs):
        Q[b, : qw.size] = qw
        T[b, : tw.size] = tw
        qlens[b] = qw.size
        tlens[b] = tw.size
    band = min(_round_up(int(np.abs(qlens - tlens).max()) + 65, 128) - 1, max(lq, lt) + 1)
    tmax = _round_up(int((qlens + tlens).max()) + 1, 256)
    return Q, T, qlens, tlens, band, tmax


def _cigar_cost(items, pen: Penalties) -> int:
    s = 0
    for n, op in items:
        if op == "X":
            s += n * pen.mismatch
        elif op in "ID":
            g1 = pen.gap1_open + n * pen.gap1_extend
            s += min(g1, pen.gap2_open + n * pen.gap2_extend) if pen.two_piece else g1
    return s
