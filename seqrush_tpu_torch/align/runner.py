"""Batched alignment runner: orientation calls, band sizing, length-bucketed
chunks, the two alignment kernels, band certification and escalation.

The port of the banded route of ``seqrush_tpu/align/runner.py``, the route
that runs the sweep kernel and then the walk kernel per chunk:

* orientation: a mash-sketch fwd-vs-RC comparison decides clear pairs;
  undecided pairs enter the first round in BOTH orientations at a probe
  band and the better banded score wins (ties forward);
* each job's initial band comes from the sketch divergence estimate, and
  jobs sort by (band, length) into chunks cut at the traceback memory
  budget; every job of a chunk runs at the chunk's band;
* per chunk: Q/T are packed on the host (QPAD/TPAD), the sweep kernel and
  the walk kernel run on the device, and the walk's output comes back
  through a non-blocking copy into pinned memory: run tokens [B, RUN_MAX]
  and their counts (``emit`` 'auto' or 'runs', wherever tmax + 4 < 2^15),
  else opcodes [B, tmax + 1].  A pair whose walk has more than RUN_MAX runs
  joins ``_runs_off_set`` and is retried, in a later round, in a chunk of
  such pairs that takes the opcode walk.  Chunk k+1 is dispatched before
  chunk k is collected;
* a chunk of more than ``long_pair_threshold`` anti-diagonals (pairs of
  qlen + tlen above it) takes the long-pair route, ``nw_cuda.nw_align_long``:
  the same kernels in their segment modes, segments of 2,048 anti-diagonals
  with the DP rows and the walk's cursor carried across, the traceback
  recomputed a group of segments at a time under ``memory_budget_bytes``,
  so its device memory does not grow with the pairs' length.  Its launches
  go on a stream of the chunk's own, so two long chunks dispatched back to
  back run at once.  It returns opcodes like a chunk's and is collected the
  same way;
* collect: the band certificate (a banded score S with half-width K is
  optimal iff S < 2*o_min + e_min*(2K + 2 - |diff|)), escalation of the
  uncertified jobs to the band their score demands, the divergence cap,
  and one vectorized decode of the tokens or opcodes into CIGARs;
* four options change a chunk's kernels as in the JAX package:
  ``dp_dtype`` 'int16' or 'auto' runs the sweep's saturating int16 DP (a
  score at or above nw.INT16_CUTOFF re-runs in int32 and counts
  ``int16_retries``; jobs carry that force32 flag, and chunks never mix
  it); ``sweep='rows'`` runs the row-major sweep and walk
  (``nw_cuda.nw_align_rows`` / ``nw_walk_rows``; a pair whose gap list
  passes nw.GAP_MAX joins ``_v3_set``, retries on the anti-diagonal
  kernels at the same band and counts ``gap_overflows``; the anchored route
  is off); ``fold`` True, or 'auto' for chunks of at most fold_max_batch
  padded rows, runs the bidirectional fold (``nw_cuda.nw_align_fold``) at
  the band widened by the chunk's largest length difference.  Rows take
  precedence over the fold; long chunks take neither and stay int32;
  ``band_tiling='auto'`` merges a wide band's chunks into the narrow chunk
  before them (``_plan_band_tiling``): each wide pair takes n_tiles
  consecutive rows of the narrow width, and one launch of kernels A and B's
  tiled modes (``nw_cuda.nw_align_tiled`` / ``nw_walk_runs_tiled``) runs
  every pair at its own band, so the results are the untiled ones;
* ``mesh`` (a ``parallel.mesh.Mesh``): each chunk's rows, padded to a
  multiple of the mesh size, split into one slice a device, each through
  the chunk's kernels (no fold, no band tiling, and no long-pair route: a
  long chunk runs single-shot); a job whose traceback alone exceeds the
  memory budget aligns with its band split by lanes over the mesh
  (``parallel/bandshard.py``, counted in ``band_sharded``), and an
  undecided pair that large takes the sketch's orientation alone;
* wide jobs on long pairs (the default ``wide_route='anchored'``) are split
  off first and aligned piecewise by ``align/anchored.py``: chaining and the
  host window DP run while the narrow chunks compute, its device window
  chunks queue behind them, and a job without a usable chain (or, under
  ``wide_verify``, with a stitch that is not optimal) goes back to the
  banded chunks.

``kernel='wfa'`` takes another route: the sketch (and the score-only probe)
orients each pair, and the pairs, sorted by length, run in batches through
the wavefront kernel (``ops/wfa.py::wfa_align_device``) at a score budget
that grows four-fold (``initial_smax`` first) until every pair finishes or
passes its divergence cap; ``backtrace_pair`` reads each CIGAR from the
wavefront history on the host.

``choose_orientations`` is the orientation call of backends that align one
orientation a pair (the sweepga backend): the sketch decides clear pairs,
and the undecided ones are scored in both orientations by the score-only
sweep with the orientation scores (one-piece penalties), in chunks of 64.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import anchors, nw, nw_cuda, wfa
from ..ops.wfa import Penalties
from ..pos import encode_bases, reverse_complement_codes
from ..scores import DEFAULT_ORIENTATION_SCORES, AlignmentScores
from ..sequences import SequenceSet
from ..utils import resolve_device, to_host
from . import anchored


@dataclass
class AlignmentResult:
    query_idx: int
    target_idx: int
    is_reverse: bool
    score: int
    cigar: list[tuple[int, str]]  # standard ops =,X,I,D (query-consuming I)
    # local-alignment starts (0 for global backends; RC-space when is_reverse)
    query_start: int = 0
    target_start: int = 0

    @property
    def cigar_string(self) -> str:
        return "".join(f"{n}{op}" for n, op in self.cigar)


@dataclass
class RunnerConfig:
    scores: AlignmentScores = field(default_factory=AlignmentScores)
    # penalties of choose_orientations' probe (a strict 4-tuple, one-piece)
    orientation_scores: AlignmentScores = DEFAULT_ORIENTATION_SCORES
    max_divergence: float | None = None
    band_slack: int = 64  # minimum extra diagonals beyond the length difference
    # kernel='wfa': the first score budget of a batch (escalated x4)
    initial_smax: int = 256
    # traceback-tensor budget per dispatch ([B, tmax, W] uint8; a long
    # chunk's recompute group, [B, G * seg, W]).  Chunking fixes each job's
    # band, and the band can change tie-broken CIGARs, so this stays at the
    # JAX package's value until a measured change
    memory_budget_bytes: int = int(2.6e9)
    verbose: bool = False
    # cap pairs per chunk (0 = memory budget only)
    max_chunk_pairs: int = 0
    # alignment kernel: 'nw' the banded Gotoh sweep and walk, 'wfa' the
    # score-adaptive wavefront kernel
    kernel: str = "nw"
    # the walk's output: 'runs' fetches run tokens ([B, nw.RUN_MAX] int32)
    # and decodes at run granularity, 'ops' fetches one opcode a step, 'auto'
    # takes runs wherever tmax + 4 < 2^15 (pairs whose walk has more than
    # RUN_MAX runs retry through opcodes)
    emit: str = "auto"
    # the sweep's DP: 'int32' (exact), 'int16' or 'auto' (saturating int16;
    # a score at or above nw.INT16_CUTOFF re-runs in int32)
    dp_dtype: str = "int32"
    # 'antidiag' the anti-diagonal sweep and walk, 'rows' the row-major ones
    # (half the serial steps; pairs whose gap list overflows nw.GAP_MAX retry
    # on the anti-diagonal kernels)
    sweep: str = "antidiag"
    # the bidirectional fold (each pair as a forward and a backward row
    # meeting at the middle anti-diagonal): True for every chunk, 'auto' for
    # chunks of at most fold_max_batch padded rows
    fold: bool | str = False
    fold_max_batch: int = 128
    # 'auto' merges a wide band's chunks into the narrow chunk before them,
    # each wide pair as (band_wide + 1) / (band + 1) rows of the narrow
    # width, one tiled launch instead of two (same results); 'off'
    band_tiling: str = "off"
    # most tile rows a wide pair may take (wider jobs keep their own chunk)
    band_tiling_max_tiles: int = 4
    # host worker threads of the anchored route's window DP
    threads: int = 4
    # chunks of more anti-diagonals than this (pairs of qlen + tlen above it)
    # take the segmented long-pair route (nw_cuda.nw_align_long)
    long_pair_threshold: int = 65536
    # seed-frequency cutoff of the anchored route's minimizer anchors (a
    # query minimizer occurring more often in the target is not a seed);
    # None = no cutoff
    frequency: int | None = None
    # wide-pair route: 'anchored' aligns jobs whose band exceeds
    # wide_band_threshold on pairs of at least wide_min_len piecewise
    # (minimizer chain + exact DP on the inter-anchor windows,
    # align/anchored.py); 'full' runs them as wide-band sweeps.  Pairs with
    # no usable chain fall back to the full route
    wide_route: str = "anchored"
    wide_band_threshold: int = 767
    wide_min_len: int = 2048
    # above this many anchored jobs in one round, moderately wide jobs go
    # back to banded chunks (the route's host work grows per pair, a banded
    # chunk's serial steps are shared by its rows); very wide
    # (> 2 * wide_band_threshold + 1) or long pairs stay anchored.  0: no cap
    anchored_max_jobs: int = 256
    # check every stitched score against a score-only banded sweep at the
    # certified band; a stitch that is not optimal goes back to the full
    # wide route, so the results are certified exact
    wide_verify: bool = False
    # anchored windows of at most this many DP cells run on the host
    # (threaded C++ full-matrix DP, native.window_dp_native); larger ones
    # (inversion cores) run on the device.  0: every window on the device
    wide_host_window_cells: int = 1 << 18
    # when the whole anchored window workload has at most this many cells,
    # every window runs on the host.  0: off
    wide_host_total_cells: int = 0
    # a parallel.mesh.Mesh: each chunk's rows split over its devices (no
    # fold, no band tiling, no long-pair route), and a job whose traceback
    # alone exceeds memory_budget_bytes aligned with its band split over them
    mesh: object = None


@contextlib.contextmanager
def _own_stream(stream, *inputs):
    """Run the block on `stream` (None on the CPU: nothing changes), after
    the current stream's work so far; the inputs are recorded on it."""
    if stream is None:
        yield
        return
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    for x in inputs:
        x.record_stream(stream)
    with torch.cuda.stream(stream):
        yield


class _TiledChunk(list):
    """A chunk whose wide entries run band-tiled (RunnerConfig.band_tiling):
    entries as a plain chunk's (p, rc, band, f32, q, t), the narrow ones at
    base_band, the wide ones at wide_band = n_tiles * (base_band + 1) - 1;
    the dispatch gives each wide entry n_tiles consecutive rows."""

    def __init__(self, entries, base_band: int, wide_band: int, n_tiles: int):
        super().__init__(entries)
        self.base_band = base_band
        self.wide_band = wide_band
        self.n_tiles = n_tiles


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


PROBE_CHUNK = 64  # orientation-probe pairs per score-only sweep


def _quantized_pack(qs, ts):
    """wfa.pack_batch at quantized shapes: lengths rounded up to 256 (plus
    the EXTEND_CHUNK pad columns), the batch to a power of two with
    zero-length pairs (which end at score 0)."""
    B = _next_pow2(len(qs))
    empty = np.zeros(0, dtype=np.uint8)
    qs = list(qs) + [empty] * (B - len(qs))
    ts = list(ts) + [empty] * (B - len(ts))
    lq = _round_up(max((q.size for q in qs), default=1), 256)
    lt = _round_up(max((t.size for t in ts), default=1), 256)
    Q = np.stack([np.concatenate([q, np.full(lq + wfa.EXTEND_CHUNK - q.size, wfa.QPAD, np.uint8)])
                  for q in qs])
    T = np.stack([np.concatenate([t, np.full(lt + wfa.EXTEND_CHUNK - t.size, wfa.TPAD, np.uint8)])
                  for t in ts])
    qlens = np.array([q.size for q in qs], dtype=np.int32)
    tlens = np.array([t.size for t in ts], dtype=np.int32)
    return Q, T, qlens, tlens


def pack_probe(bq: list[np.ndarray], bt: list[np.ndarray]):
    """Kernel inputs of one orientation-probe chunk: (Q [B, lq], T [B, lt]
    uint8, qlens, tlens [B] int32, band, tmax) with B a power of two of at
    least 8, lq and lt rounded to 256, tmax to 512, and the band
    max(127, round_up(max |qlen - tlen| + 2, 128) - 1): both orientations of
    a pair are banded alike, and only their order matters."""
    B = max(_next_pow2(len(bq)), 8)
    lq = _round_up(max(q.size for q in bq), 256)
    lt = _round_up(max(t.size for t in bt), 256)
    Q = np.full((B, lq), nw.QPAD, np.uint8)
    T = np.full((B, lt), nw.TPAD, np.uint8)
    qlens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    for b, (q, t) in enumerate(zip(bq, bt)):
        Q[b, : q.size] = q
        T[b, : t.size] = t
        qlens[b] = q.size
        tlens[b] = t.size
    diff = max(abs(int(q.size) - int(t.size)) for q, t in zip(bq, bt))
    band = max(127, _round_up(diff + 2, 128) - 1)
    tmax = _round_up(int((qlens + tlens).max()) + 1, 512)
    return Q, T, qlens, tlens, band, tmax


def _check_config(cfg: RunnerConfig) -> None:
    if cfg.band_tiling not in ("off", "auto"):
        raise ValueError(f"band_tiling must be 'off' or 'auto', got {cfg.band_tiling!r}")
    if cfg.dp_dtype not in ("int32", "int16", "auto"):
        raise ValueError(f"dp_dtype must be 'int32', 'int16' or 'auto', got {cfg.dp_dtype!r}")
    if cfg.sweep not in ("antidiag", "rows"):
        raise ValueError(f"sweep must be 'antidiag' or 'rows', got {cfg.sweep!r}")
    if cfg.fold not in (False, True, "auto"):
        raise ValueError(f"fold must be False, True or 'auto', got {cfg.fold!r}")
    if cfg.wide_route not in ("anchored", "full"):
        raise ValueError(f"wide_route must be 'anchored' or 'full', got {cfg.wide_route!r}")
    if cfg.kernel not in ("nw", "wfa"):
        raise ValueError(f"kernel must be 'nw' or 'wfa', got {cfg.kernel!r}")
    if cfg.emit not in ("auto", "runs", "ops"):
        raise ValueError(f"emit must be 'auto', 'runs' or 'ops', got {cfg.emit!r}")


class WfaAligner:
    """Aligns batches of sequence pairs on a torch device ('cuda' runs the
    kernels, 'cpu' their plain versions)."""

    def __init__(
        self,
        seqs: SequenceSet,
        config: RunnerConfig | None = None,
        device: str | torch.device = "cuda",
    ):
        self.seqs = seqs
        self.cfg = config or RunnerConfig()
        _check_config(self.cfg)
        self.device = resolve_device(device)
        self.codes = [encode_bases(s.data) for s in seqs.sequences]
        self.rc_codes = [reverse_complement_codes(c).copy() for c in self.codes]
        self._mash: tuple[list, list] | None = None
        self._long_streams: list | None = None  # made at the first long chunk on the card
        self._long_turn = 0
        self.stats = {
            "alignments": 0,
            "dropped": 0,
            "wall_s": 0.0,
            "band_escalations": 0,
            # kernel='wfa': pairs re-run at a larger score budget
            "escalations": 0,
            # walks with more than RUN_MAX runs (nw.RUN_MAX, the window and
            # gap chunks' own budgets), re-run through opcodes
            "run_overflows": 0,
            # int16 scores at or above nw.INT16_CUTOFF, re-run in int32
            "int16_retries": 0,
            # row-major walks whose gap list overflowed nw.GAP_MAX, re-run on
            # the anti-diagonal kernels
            "gap_overflows": 0,
            "cells_padded": 0,  # B_padded * (tmax + 2) * W summed over dispatches
            "tiled_chunks": 0,  # band-tiled merged dispatches
            "tiled_rows": 0,  # extra rows spent on wide pairs' tiles
            "cells_true": 0,  # (qlen+tlen+1) * W summed over aligned jobs
            # host-side phase timers (collect includes the device wait)
            "orient_s": 0.0,
            "dispatch_s": 0.0,
            "collect_s": 0.0,
            # anchored route: wide jobs aligned piecewise, their divergence
            # cores, the cores aligned by the host DP, jobs sent back to the
            # banded route, stitches certified by the verify sweep, seconds
            "anchored_pairs": 0,
            "anchored_windows": 0,
            "host_windows": 0,
            "anchored_fallbacks": 0,
            "wide_verified": 0,
            "anchored_s": 0.0,
            # jobs aligned through the segmented long-pair route
            "long_pairs": 0,
            # jobs aligned with their band split over the mesh (over budget)
            "band_sharded": 0,
            # one entry per dispatch: its kind ('chunk', 'long' chunks with
            # their segment length seg and count n_seg, the anchored route's
            # 'window' chunks, 'verify' sweeps, band-tiled 'tiled' chunks with
            # band_wide, n_tiles and their n_wide wide jobs last), batch rows,
            # band, tmax and the jobs it carried ([pair index, reverse] for
            # chunk, tiled, long and verify; see anchored._dispatch_window_chunk
            # for windows, and choose_orientations' 'probe' sweeps, the
            # sweepga backend's 'gap' chunks, the inversion-aware mode's
            # 'inversion' batch and kernel='wfa''s 'wfa' batches); the walk's output of each
            # chunk, window and gap dispatch as emit: 'runs' or 'ops' ('rowtok'
            # for a row-major chunk); a chunk's fold, rows and int16 flags;
            # under a mesh each chunk's mesh size, and a 'band_shard' entry
            # per band-sharded sweep of an over-budget job
            "dispatches": [],
        }
        # per-(sequence, orientation) minimizer cache of the anchored route
        self.anchor_k = 15
        self.anchor_w = 10
        self._min_cache: dict[tuple, tuple] = {}
        # (pair_idx, rc) jobs already routed through the anchored route in
        # this call (a failed or suboptimal stitch must not loop back)
        self._anchored_tried: set[tuple[int, bool]] = set()
        # (pair_idx, rc) jobs whose walk produced more than nw.RUN_MAX runs:
        # they run in chunks of their own, through the opcode walk
        self._runs_off_set: set[tuple[int, bool]] = set()
        # (pair_idx, rc) jobs whose row-major gap list overflowed nw.GAP_MAX:
        # they run in chunks of their own, on the anti-diagonal kernels
        self._v3_set: set[tuple[int, bool]] = set()

    def _minimizers(self, idx: int, rc: bool):
        key = (idx, rc)
        if key not in self._min_cache:
            codes = self.rc_codes[idx] if rc else self.codes[idx]
            self._min_cache[key] = anchors.minimizers(codes, self.anchor_k, self.anchor_w)
        return self._min_cache[key]

    def _minimizers_sorted(self, idx: int, rc: bool):
        """Value-sorted minimizer index (cached): the all-pairs anchor join
        sorts each target index once, not once per pair."""
        key = (idx, rc, "sorted")
        if key not in self._min_cache:
            self._min_cache[key] = anchors.sort_minimizers(self._minimizers(idx, rc))
        return self._min_cache[key]

    # -- orientation ---------------------------------------------------------

    def _orient_and_estimate(
        self, pairs: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sketch-stage orientation calls plus per-pair divergence estimates.

        Returns (is_rev[P] bool, undecided[P] bool, d_est[P] float).  The
        sketch decides orientation where the fwd/RC margin is clear;
        undecided pairs are aligned in both orientations.  d_est converts
        the winning mash distance to a per-base divergence estimate, which
        sizes the initial band.
        """
        P = len(pairs)
        is_rev = np.zeros(P, dtype=bool)
        undecided = np.zeros(P, dtype=bool)
        d_est = np.zeros(P, dtype=np.float64)
        if P == 0:
            return is_rev, undecided, d_est
        identical = np.zeros(P, dtype=bool)
        for p, (i, j) in enumerate(pairs):
            qi, tj = self.codes[i], self.codes[j]
            if qi.size == tj.size and (qi == tj).all():
                identical[p] = True
        MARGIN = 0.02  # on the mash per-base-divergence scale
        K_SKETCH = 15
        d_fwd, d_rc = self._sketch_orientation_distances(pairs)
        is_rev = (~identical) & (d_rc < d_fwd - MARGIN)
        undecided = (~identical) & ~is_rev & ~(d_fwd < d_rc - MARGIN)
        d_est = np.where(identical, 0.0, np.minimum(d_fwd, d_rc))
        # mixed-orientation content (e.g. an inverted block): both
        # orientations share k-mer content and the chosen one pays
        # near-mismatch cost over the opposite-strand fraction f; fold an
        # empirical block cost into d_est so the first band certifies
        mixed = (~identical) & (d_fwd < 0.35) & (d_rc < 0.35)
        if mixed.any():
            s_f = np.exp(-K_SKETCH * d_fwd)
            s_r = np.exp(-K_SKETCH * d_rc)
            f_opp = np.where(is_rev, s_f, s_r) / np.maximum(s_f + s_r, 1e-9)
            d_block = 0.45 * 0.75 * f_opp + np.minimum(d_fwd, d_rc)
            d_est = np.where(mixed, np.maximum(d_est, d_block), d_est)
        return is_rev, undecided, d_est

    def choose_orientations(self, pairs: np.ndarray) -> np.ndarray:
        """bool[P]: True where the query should be reverse-complemented.

        Two-stage: the mash sketch comparison decides clear cases; the
        undecided pairs are scored in both orientations by the score-only
        sweep with the orientation scores (one-piece), and the lower score
        wins (ties and unfinished probes keep forward)."""
        osc = self.cfg.orientation_scores
        out, undecided_mask, _ = self._orient_and_estimate(pairs)
        out = out.copy()
        undecided = [p for p in range(len(pairs)) if undecided_mask[p]]
        if not undecided:
            return out
        qs, ts = [], []
        for p in undecided:
            i, j = pairs[p]
            qs.append(self.codes[i])
            ts.append(self.codes[j])
            qs.append(self.rc_codes[i])
            ts.append(self.codes[j])
        pen = Penalties(osc.mismatch_penalty, osc.gap1_open, osc.gap1_extend)
        scores = self._score_batches(qs, ts, pen)
        fwd = scores[0::2]
        rev = scores[1::2]
        # unfinished probes (-1) rank worst
        fwd = np.where(fwd < 0, np.iinfo(np.int32).max, fwd)
        rev = np.where(rev < 0, np.iinfo(np.int32).max, rev)
        for k, p in enumerate(undecided):
            out[p] = rev[k] < fwd[k]
        return out

    def _score_batches(self, qs, ts, pen: Penalties) -> np.ndarray:
        """Scores of the (qs[k], ts[k]) alignments from the score-only sweep,
        in chunks of PROBE_CHUNK sorted by length (pack_probe's shapes)."""
        out = np.full(len(qs), -1, dtype=np.int64)
        idx = np.argsort([max(q.size, t.size) for q, t in zip(qs, ts)], kind="stable")
        for lo in range(0, len(idx), PROBE_CHUNK):
            sel = idx[lo : lo + PROBE_CHUNK]
            Q, T, qlens, tlens, band, tmax = pack_probe([qs[k] for k in sel], [ts[k] for k in sel])
            self.stats["dispatches"].append(
                {"kind": "probe", "B": Q.shape[0], "band": band, "tmax": tmax,
                 "jobs": [[int(k)] for k in sel]})
            Qd, Td, qd, td = (torch.from_numpy(a).to(self.device) for a in (Q, T, qlens, tlens))
            scores, _ = nw_cuda.nw_align(Qd, Td, qd, td, band=band, tmax=tmax,
                                         with_traceback=False, **pen.kernel_kwargs())
            out[sel] = scores.cpu().numpy()[: len(sel)]
        return out

    def _sketch_orientation_distances(self, pairs: np.ndarray):
        """Mash distances (q fwd vs t, q RC vs t) for every pair."""
        from ..ops.kmer import mash_distance_batch, mash_sketches

        t0 = time.time()
        if self._mash is None:
            self._mash = (mash_sketches(self.codes), mash_sketches(self.rc_codes))
        n = len(self.codes)
        sketches = self._mash[0] + self._mash[1]  # rc sketch of seq i at n + i
        pa = np.asarray(pairs)
        d_fwd = mash_distance_batch(sketches, pa[:, 0], pa[:, 1])
        d_rc = mash_distance_batch(sketches, pa[:, 0] + n, pa[:, 1])
        self.stats["orient_s"] += time.time() - t0
        return d_fwd, d_rc

    # -- full alignment ------------------------------------------------------

    def align_pairs(self, pairs: np.ndarray) -> list[AlignmentResult]:
        """Align all (query_idx, target_idx) pairs; returns completed results."""
        return self._align(pairs, None)

    def align_pairs_oriented(self, pairs, is_rev) -> list[AlignmentResult]:
        """Align every pair in a FORCED orientation, skipping the sketch's
        orientation call (the banded kernel's sketch still sizes the
        initial band)."""
        return self._align(pairs, np.asarray(is_rev, dtype=bool))

    def _align(self, pairs, forced_rev) -> list[AlignmentResult]:
        t0 = time.time()
        pairs = np.asarray(pairs)
        if len(pairs) == 0:
            return []
        if self.cfg.kernel == "wfa":
            is_rev = self.choose_orientations(pairs) if forced_rev is None else forced_rev
            results = self._align_pairs_wfa(pairs, is_rev)
        else:
            results = self._align_pairs_nw(pairs, forced_rev)
        self.stats["alignments"] += len(results)
        self.stats["wall_s"] += time.time() - t0
        if self.cfg.verbose:
            print(
                f"[runner] aligned {len(results)}/{len(pairs)} pairs in "
                f"{self.stats['wall_s']:.2f}s ({self.stats['dropped']} dropped, "
                f"{self.stats['band_escalations']} band escalations)"
            )
        return results

    # -- wavefront path (kernel='wfa') ------------------------------------------

    def _align_pairs_wfa(self, pairs, is_rev) -> list[AlignmentResult]:
        """Pairs sorted by their longer sequence, in batches at one score
        budget; a pair that does not finish within the budget re-runs at
        four times it, up to its divergence cap."""
        maxlens = np.array([max(self.codes[i].size, self.codes[j].size) for i, j in pairs])
        order = np.argsort(maxlens, kind="stable")
        results = []
        pending = [(int(p), int(self.cfg.initial_smax)) for p in order]
        while pending:
            batch, pending = self._take_batch(pending, pairs)
            batch_results, retries = self._run_full_batch(batch, pairs, is_rev)
            results.extend(batch_results)
            self.stats["escalations"] += len(retries)
            pending.extend(retries)
        return results

    def _take_batch(self, pending, pairs):
        """Split off the (pair_idx, smax) jobs of the first job's smax that fit
        the memory budget together: their history tensors and the extension
        table the JAX package builds beside them, at the batch's widest band
        and longest target (the batch, and so its band, are the JAX
        package's, and the band can decide a tie-broken CIGAR)."""
        first_smax = pending[0][1]
        other = [job for job in pending if job[1] != first_smax]
        batch = []
        max_band = max_lt = 0
        for job in pending:
            if job[1] != first_smax:
                continue
            i, j = pairs[job[0]]
            qlen, tlen = self.codes[i].size, self.codes[j].size
            trial_band = max(max_band, self._band_for(qlen, tlen))
            trial_lt = max(max_lt, tlen)
            ndiag = 2 * trial_band + 1
            hist_bytes = (len(batch) + 1) * 5 * (first_smax + 1) * ndiag * 2
            ext_bytes = (len(batch) + 1) * ndiag * (trial_lt + 256) * 2 * 3
            if batch and hist_bytes + ext_bytes > self.cfg.memory_budget_bytes:
                other.append(job)
            else:
                batch.append(job)
                max_band, max_lt = trial_band, trial_lt
        return batch, other

    def _band_for(self, qlen: int, tlen: int) -> int:
        """Band half-width K of a pair: its length difference plus band_slack,
        W = K + 1 rounded to a multiple of 128."""
        diff = abs(tlen - qlen)
        k = _round_up(diff + self.cfg.band_slack + 1, 128) - 1
        return min(k, max(qlen, tlen) + 1)

    def _run_full_batch(self, batch, pairs, is_rev):
        """One wavefront launch over a batch at the batch's widest band, then
        the host backtrace of every finished pair.  Returns (results,
        retries): unfinished pairs under their cap re-run at smax * 4."""
        if not batch:
            return [], []
        smax = batch[0][1]
        qs, ts, caps, bands = [], [], [], []
        for p, _ in batch:
            i, j = pairs[p]
            q = self.rc_codes[i] if is_rev[p] else self.codes[i]
            t = self.codes[j]
            qs.append(q)
            ts.append(t)
            caps.append(self._pair_cap(q.size, t.size))
            bands.append(self._band_for(q.size, t.size))
        band = max(bands)
        Q, T, qlens, tlens = _quantized_pack(qs, ts)
        caps = caps + [0] * (len(qlens) - len(caps))
        smax_eff = min(smax, max(caps))
        caps_eff = np.minimum(np.array(caps, dtype=np.int32), smax_eff)
        entry = {"kind": "wfa", "B": Q.shape[0], "band": band, "smax": smax_eff,
                 "jobs": [[p, int(is_rev[p])] for p, _ in batch]}
        dev = self.device
        Qd, Td, qd, td, cd = (torch.from_numpy(a).to(dev) for a in (Q, T, qlens, tlens, caps_eff))
        pen = Penalties.from_scores(self.cfg.scores)
        scores, hists = wfa.wfa_align_device(Qd, Td, qd, td, cd, smax=smax_eff, band=band,
                                             keep_history=True, **pen.kernel_kwargs())
        scores = scores.cpu().numpy()[: len(batch)]
        # the backtrace reads no row past a pair's score
        top = int(scores.max(initial=-1)) + 1
        hists = {k: v[: len(batch), :top].cpu().numpy() for k, v in hists.items()}
        entry["steps"] = int(max(s if s >= 0 else c for s, c in zip(scores, caps_eff)))
        self.stats["dispatches"].append(entry)

        results, retries = [], []
        for b, (p, _) in enumerate(batch):
            i, j = pairs[p]
            if scores[b] < 0:
                if smax_eff < caps[b]:
                    retries.append((p, min(smax * 4, caps[b] + 1)))
                else:
                    self.stats["dropped"] += 1  # exceeded divergence cap
                continue
            items = wfa.backtrace_pair({k: v[b] for k, v in hists.items()}, int(scores[b]),
                                       int(qlens[b]), int(tlens[b]), band, pen)
            results.append(AlignmentResult(int(i), int(j), bool(is_rev[p]), int(scores[b]), items))
        return results, retries

    # -- banded anti-diagonal Gotoh path --------------------------------------

    def _gap_mins(self) -> tuple[int, int]:
        sc = self.cfg.scores
        if sc.has_two_piece:
            return min(sc.gap1_extend, sc.gap2_extend), min(sc.gap1_open, sc.gap2_open)
        return sc.gap1_extend, sc.gap1_open

    def _penalties(self) -> dict:
        return Penalties.from_scores(self.cfg.scores).kernel_kwargs()

    def _quantize_band(self, k: int, qlen: int, tlen: int) -> int:
        # lane width W = k+1 in multiples of 128; coarser 256 quanta above
        # 512 so near-identical wide bands share one chunk
        quantum = 128 if k < 512 else 256
        k = _round_up(k + 1, quantum) - 1
        return min(k, max(qlen, tlen) + 1)

    def _cert_bound(self, band: int, qlen: int, tlen: int) -> int:
        e_min, o_min = self._gap_mins()
        diff = abs(qlen - tlen)
        return 2 * o_min + e_min * max(2 * band + 2 - diff, 0)

    def _initial_band(self, qlen: int, tlen: int, d_est: float) -> int:
        sc = self.cfg.scores
        e_min, o_min = self._gap_mins()
        diff = abs(qlen - tlen)
        # estimated score: SNP cost + indel headroom; size K so the
        # certificate holds at that score with a little margin
        s_est = d_est * min(qlen, tlen) * max(sc.mismatch_penalty, 1) + 280
        k_cert = (s_est - 2 * o_min) / (2 * max(e_min, 1)) + diff / 2
        k = max(diff + self.cfg.band_slack, int(k_cert) + 1)
        return self._quantize_band(k, qlen, tlen)

    def _escalated_band(self, score: int, band: int, qlen: int, tlen: int) -> int:
        e_min, o_min = self._gap_mins()
        diff = abs(qlen - tlen)
        k = max(
            (score - 2 * o_min) // (2 * max(e_min, 1)) + diff // 2 + 2,
            band + 1,
        )
        return self._quantize_band(int(k), qlen, tlen)

    @staticmethod
    def _quantize_batch(n: int) -> int:
        """Smallest ladder value >= n: multiples of 8 up to 64, then 96, 144,
        216, 256, then multiples of 64."""
        if n <= 64:
            return max(((n + 7) // 8) * 8, 8)
        for b in (96, 144, 216, 256):
            if n <= b:
                return b
        return _round_up(n, 64)

    def _initial_jobs(self, pairs, forced_rev=None) -> list[tuple[int, bool, int, bool]]:
        """First-round jobs (pair_idx, rc, band, force32).  Sketch-undecided
        pairs enter in both orientations at a probe band: the orientation
        call is relative, and the winner escalates from its own score.
        force32 (the int32 DP whatever dp_dtype says) starts as
        dp_dtype == 'int32'; an int16 retry sets it."""
        if forced_rev is not None:
            d_fwd, d_rc = self._sketch_orientation_distances(pairs)
            is_rev = forced_rev
            undecided = np.zeros(len(pairs), dtype=bool)
            d_est = np.where(is_rev, d_rc, d_fwd)
        else:
            is_rev, undecided, d_est = self._orient_and_estimate(pairs)
        jobs = []
        for p, (qi, tj) in enumerate(pairs):
            qlen = self.codes[qi].size
            tlen = self.codes[tj].size
            band0 = self._initial_band(qlen, tlen, float(d_est[p]))
            if undecided[p]:
                diff = abs(qlen - tlen)
                band0 = min(band0, self._quantize_band(diff + 255, qlen, tlen))
                orients = (False, True)
                if self.cfg.mesh is not None and self._needs_band_shard((p, False, band0, True), pairs):
                    # a pair too big even for the probe band does not race
                    # both orientations through band-sharded escalation:
                    # it takes the sketch's better orientation
                    if forced_rev is None:
                        d_fwd, d_rc = self._sketch_orientation_distances(pairs[p : p + 1])
                        orients = (bool(d_rc[0] < d_fwd[0]),)
                    else:
                        orients = (bool(is_rev[p]),)
            else:
                orients = (bool(is_rev[p]),)
            for rc in orients:
                jobs.append((p, rc, band0, self.cfg.dp_dtype == "int32"))
        return jobs

    def _align_pairs_nw(self, pairs, forced_rev=None) -> list[AlignmentResult]:
        # a failed or suboptimal stitch must not re-enter the anchored route
        # within this call; a fresh call starts clean
        self._anchored_tried = set()
        pen = self._penalties()
        attempts: dict[tuple[int, bool], AlignmentResult | None] = {}
        queue = self._initial_jobs(pairs, forced_rev)
        while queue:
            # wide jobs divert to the anchored route first
            anchored_jobs: list = []
            if self.cfg.wide_route == "anchored":
                rest = []
                for job in queue:
                    (anchored_jobs if self._wants_anchored(job, pairs) else rest).append(job)
                queue = rest
                cap = self.cfg.anchored_max_jobs
                if cap and len(anchored_jobs) > cap:
                    # many wide jobs: banded chunks share their serial steps
                    # across rows while the route's host work grows per pair,
                    # so only very wide bands and long pairs stay anchored
                    keep, back = [], []
                    for job in anchored_jobs:
                        p, _rc, band, _f32 = job
                        qi, tj = pairs[p]
                        big = band > 2 * self.cfg.wide_band_threshold + 1 or (
                            self.codes[qi].size + self.codes[tj].size
                            > self.cfg.long_pair_threshold
                        )
                        (keep if big else back).append(job)
                    anchored_jobs = keep
                    queue.extend(back)
            if self.cfg.mesh is not None:
                # a job whose traceback alone exceeds the budget aligns with
                # its band split over the mesh
                local = []
                for job in queue:
                    if self._needs_band_shard(job, pairs):
                        key, res = self._align_job_bandsharded(job, pairs, pen)
                        attempts[key] = res
                    else:
                        local.append(job)
                queue = local
            chunks = self._plan_band_tiling(self._make_nw_chunks(queue, pairs))
            retries_scored = []  # (job, banded_score)
            a_fallbacks: list = []
            # pipeline: dispatch chunk k+1 (device work) before the host
            # collect of chunk k
            inflight = None
            for chunk in chunks:
                t0 = time.time()
                dispatched = self._dispatch_nw_chunk(chunk)
                self.stats["dispatch_s"] += time.time() - t0
                if inflight is not None:
                    self._collect_into(inflight, pairs, attempts, retries_scored)
                inflight = dispatched
            a_state = None
            if anchored_jobs:
                # chaining, flanks and the host window DP run while the
                # dispatched chunks compute; the window chunks queue behind
                t0 = time.time()
                a_state = self._align_anchored_start(anchored_jobs, pairs, pen)
                self.stats["anchored_s"] += time.time() - t0
            if inflight is not None:
                self._collect_into(inflight, pairs, attempts, retries_scored)
            if a_state is not None:
                t0 = time.time()
                a_done, a_fallbacks, a_retries = self._align_anchored_finish(a_state, pairs, pen)
                self.stats["anchored_s"] += time.time() - t0
                attempts.update(a_done)
                retries_scored.extend(a_retries)
            queue = self._prune_orientation_losers(attempts, retries_scored)
            # chainless wide jobs re-enter the full route unpruned (a missing
            # chain says nothing about which orientation wins)
            queue.extend(a_fallbacks)

        results: list[AlignmentResult] = []
        for p in range(len(pairs)):
            best = None
            for rc in (False, True):
                res = attempts.get((p, rc))
                if res is not None and (best is None or res.score < best.score):
                    best = res
            if best is None:
                if (p, False) in attempts or (p, True) in attempts:
                    self.stats["dropped"] += 1  # exceeded divergence cap
            else:
                results.append(best)
        return results

    def _collect_into(self, dispatched, pairs, attempts, retries_scored) -> None:
        t0 = time.time()
        done, retries = self._collect_nw_chunk(dispatched, pairs)
        self.stats["collect_s"] += time.time() - t0
        attempts.update(done)
        retries_scored.extend(retries)

    def _prune_orientation_losers(self, attempts, retries_scored):
        """Escalate only the better-scoring orientation of each pair.

        Banded scores are upper bounds of the true scores, so the smaller
        banded score is the orientation probe's answer.  Ties keep forward."""
        best_known: dict[int, tuple[int, bool]] = {}
        for (p, rc), res in attempts.items():
            if res is not None:
                s = res.score
                cur = best_known.get(p)
                if cur is None or (s, rc) < cur:
                    best_known[p] = (s, rc)
        for (p, rc, _band, _f32), s in retries_scored:
            cur = best_known.get(p)
            if cur is None or (s, rc) < cur:
                best_known[p] = (s, rc)
        out = []
        for (p, rc, band, f32), s in retries_scored:
            cur = best_known.get(p)
            if cur is not None and (cur[0], cur[1]) < (s, rc):
                continue  # the other orientation already scores better
            out.append((p, rc, band, f32))
        return out

    def _wants_anchored(self, job, pairs) -> bool:
        """Route this job through the anchored route?  A wide band on a long
        pair, not tried before in this call, and under wide_verify a pair
        the single-shot verify sweep can take; never under sweep='rows'."""
        p, rc, band, _f32 = job
        if (p, rc) in self._anchored_tried:
            return False
        qi, tj = pairs[p]
        qlen, tlen = self.codes[qi].size, self.codes[tj].size
        return (
            band > self.cfg.wide_band_threshold
            and max(qlen, tlen) >= self.cfg.wide_min_len
            and (not self.cfg.wide_verify or qlen + tlen <= self.cfg.long_pair_threshold)
            and self.cfg.sweep != "rows"
        )

    def _align_anchored_start(self, wide_jobs, pairs, pen):
        """Phase 1 of the anchored route: chain, trim flanks, build plans,
        run the host windows and dispatch the first device window chunk
        (queued behind the narrow chunks already dispatched)."""
        plans, fallbacks, window_jobs = [], [], []
        runs_per_job = anchored.chain_jobs(self, wide_jobs, pairs)
        flanks_per_job = anchored.flank_trim_jobs(self, wide_jobs, pairs, runs_per_job)
        for job, runs, flanks in zip(wide_jobs, runs_per_job, flanks_per_job):
            self._anchored_tried.add((job[0], job[1]))
            plan = anchored.build_plan(self, job, pairs, window_jobs, runs, flanks)
            if plan is None:
                self.stats["anchored_fallbacks"] += 1
                fallbacks.append(job)
            else:
                plan.f32 = job[3]
                plans.append(plan)
        dispatched = anchored.dispatch_windows(self, window_jobs, pen)
        self.stats["anchored_windows"] += len(window_jobs)
        return plans, fallbacks, window_jobs, dispatched

    def _align_anchored_finish(self, state, pairs, pen):
        """Phase 2: collect the windows, stitch, and (under wide_verify)
        verify.  Returns (done, fallback jobs, retries_scored): ``done``
        maps (pair_idx, rc) to results (None = divergence-cap drop),
        fallbacks are chainless jobs for the full wide route, retries are
        verify-failed jobs re-queued at their certified band."""
        plans, fallbacks, window_jobs, dispatched = state
        witems = anchored.collect_windows(self, window_jobs, dispatched, pen)

        done: dict[tuple[int, bool], AlignmentResult | None] = {}
        retries_scored = []
        verify_entries = []  # (plan, items, stitched score, band_v)
        e_min, o_min = self._gap_mins()
        for plan in plans:
            items, nq, nt = anchored.stitch(plan, witems)
            s = anchored.cigar_cost(items, pen)
            qlen, tlen = plan.q.size, plan.t.size
            if nq != qlen or nt != tlen:
                raise RuntimeError(
                    f"anchored stitch consumption mismatch: q {nq}/{qlen} "
                    f"t {nt}/{tlen} (pair {pairs[plan.p]}, rc={plan.rc})"
                )
            if self.cfg.wide_verify:
                diff = abs(qlen - tlen)
                k_v = max(
                    anchored.max_excursion(items),
                    (s - 2 * o_min) // (2 * max(e_min, 1)) + diff // 2 + 2,
                )
                band_v = self._quantize_band(int(k_v), qlen, tlen)
                verify_entries.append((plan, items, s, band_v))
                continue
            self._finish_anchored(plan, items, s, pairs, done)

        if verify_entries:
            scores_v = anchored.verify_scores(
                self,
                [(pl.q, pl.t, bv, (pl.p, pl.rc)) for pl, _i, _s, bv in verify_entries],
                pen,
            )
            for (plan, items, s, band_v), s_v in zip(verify_entries, scores_v):
                s_v = int(s_v)
                if s_v > s:
                    raise RuntimeError(
                        f"verify sweep beat its own band: {s_v} > {s} "
                        f"(pair {pairs[plan.p]}, band {band_v})"
                    )
                if s_v == s:
                    # the stitch reaches the certified-optimal score, so it
                    # is an optimal alignment
                    self.stats["wide_verified"] += 1
                    self._finish_anchored(plan, items, s, pairs, done)
                else:
                    # the optimum beats the stitch: re-run the full wide
                    # route at band_v (already certified for s_v)
                    retries_scored.append(((plan.p, plan.rc, band_v, plan.f32), s_v))
        return done, fallbacks, retries_scored

    def _finish_anchored(self, plan, items, score, pairs, done):
        self.stats["anchored_pairs"] += 1
        qi, tj = pairs[plan.p]
        if score > self._pair_cap(plan.q.size, plan.t.size):
            done[(plan.p, plan.rc)] = None  # exceeds the divergence cap
        else:
            done[(plan.p, plan.rc)] = AlignmentResult(int(qi), int(tj), plan.rc, score, items)

    def _needs_band_shard(self, job, pairs) -> bool:
        """Whether this job alone busts the per-dispatch traceback budget
        (the cap _make_nw_chunks cuts chunks at; without a mesh a lone
        over-budget job dispatches anyway)."""
        p, _rc, band, _f32 = job
        qi, tj = pairs[p]
        qlen, tlen = self.codes[qi].size, self.codes[tj].size
        tmax = _round_up(qlen + tlen, 512)
        return self._quantize_batch(1) * (tmax + 2) * (band + 1) > self.cfg.memory_budget_bytes

    def _align_job_bandsharded(self, job, pairs, pen):
        """Align one over-budget job with its band split by lanes over the
        mesh (parallel/bandshard.py), certified and escalated as a chunk's
        jobs are.  Returns ((pair_idx, rc), result or None)."""
        from ..parallel import bandshard

        p, rc, band, _f32 = job
        qi, tj = pairs[p]
        q = self.rc_codes[qi] if rc else self.codes[qi]
        t = self.codes[tj]
        qlen, tlen = q.size, t.size
        full = max(qlen, tlen)
        while True:
            b = bandshard.band_for_mesh(min(band, full), self.cfg.mesh.size)
            self.stats["dispatches"].append(
                {"kind": "band_shard", "B": 1, "band": b, "tmax": _round_up(qlen + tlen, 512),
                 "jobs": [[int(p), int(rc)]], "mesh": self.cfg.mesh.size})
            score, items = bandshard.align_codes_sharded(self.cfg.mesh, q, t, band=b, **pen)
            if b >= full or score < self._cert_bound(b, qlen, tlen):
                break
            self.stats["band_escalations"] += 1
            band = self._escalated_band(score, b, qlen, tlen)
        self.stats["band_sharded"] += 1
        self.stats["cells_true"] += (qlen + tlen + 1) * (b + 1)
        if score > self._pair_cap(qlen, tlen):
            return (p, rc), None  # certified-exact score exceeds the cap
        return (p, rc), AlignmentResult(int(qi), int(tj), rc, score, items)

    def _make_nw_chunks(self, queue, pairs):
        """Pack jobs into as few dispatches as possible: jobs sort by
        (force32, row-major overflow, run overflow, band, length) and chunks
        cut only at a change of the first three, the traceback memory budget
        and max_chunk_pairs; every job in a chunk runs at the chunk-max band.
        The DP's type, the kernels (_v3_set: pairs whose row-major gap list
        overflowed) and the walk's output (_runs_off_set: walks that
        overflowed RUN_MAX, which take the opcode walk) are one per chunk.

        Entries are (pair_idx, rc, band, force32, q, t)."""
        entries = []
        for p, rc, band, force32 in queue:
            qi, tj = pairs[p]
            q = self.rc_codes[qi] if rc else self.codes[qi]
            t = self.codes[tj]
            v3 = (p, rc) in self._v3_set
            roff = (p, rc) in self._runs_off_set
            entries.append((force32, v3, roff, band, q.size + t.size, p, rc, q, t))
        entries.sort(key=lambda e: (e[0], e[1], e[2], e[3], e[4]))

        chunks = []
        i = 0
        while i < len(entries):
            chunk = []
            band = 0
            while i < len(entries):
                f32, v3, roff, bandj, _ln, p, rc, q, t = entries[i]
                first = (chunk[0][0], chunk[0][1]) if chunk else None
                if chunk and (f32 != chunk[0][2] or v3 != (first in self._v3_set)
                              or roff != (first in self._runs_off_set)):
                    break  # dtype, kernels and the walk's output: one per chunk
                trial_band = max(band, bandj)
                trial_tmax = _round_up(q.size + t.size, 512)
                B_pad = self._quantize_batch(len(chunk) + 1)
                bytes_needed = B_pad * (trial_tmax + 2) * (trial_band + 1)
                if chunk and bytes_needed > self.cfg.memory_budget_bytes:
                    break
                if self.cfg.max_chunk_pairs and len(chunk) >= self.cfg.max_chunk_pairs:
                    break
                chunk.append((p, rc, f32, q, t))
                band = trial_band
                i += 1
            chunks.append([(p, rc, band, f32, q, t) for (p, rc, f32, q, t) in chunk])
        return chunks

    def _plan_band_tiling(self, chunks):
        """Merge wide-band chunks into the narrow chunk before them as band
        tiles (RunnerConfig.band_tiling; the JAX package's planner).

        _make_nw_chunks sorts entries by (dtype, kernels, walk output, band),
        so a band's chunks follow each other.  The wide pairs of the chunks
        after a narrow one of the same class ride it as n_tiles consecutive
        rows each, one launch instead of two, at the cost of n_tiles - 1
        extra rows a wide pair.  Merge conditions: no fold, no row-major
        sweep, run tokens; W even; n_tiles in [2, band_tiling_max_tiles]; the
        merged chunk not long, its tokens in range and its traceback under
        the memory budget; the tile rows not outnumbering the pairs; no mesh."""
        cfg = self.cfg
        if (cfg.band_tiling == "off" or len(chunks) < 2 or cfg.mesh is not None or cfg.fold is not False
                or cfg.sweep == "rows" or cfg.emit == "ops"):
            return chunks

        def klass(chunk):
            p, rc, _band, f32, _q, _t = chunk[0]
            return f32, (p, rc) in self._v3_set, (p, rc) in self._runs_off_set

        out = []
        i = 0
        while i < len(chunks):
            base = chunks[i]
            W = base[0][2] + 1 if base else 0
            if isinstance(base, _TiledChunk) or not base or W % 2 or klass(base)[1] or klass(base)[2]:
                out.append(base)
                i += 1
                continue
            narrow = list(base)
            wides: list = []
            n_tiles = 1
            j = i + 1
            while j < len(chunks):
                cand = chunks[j]
                if (not cand or isinstance(cand, _TiledChunk) or klass(cand) != klass(base)
                        or cand[0][2] <= base[0][2]):
                    break
                R = max(n_tiles, -(-(cand[0][2] + 1) // W))
                if R < 2 or R > cfg.band_tiling_max_tiles:
                    break
                trial_wides = wides + list(cand)
                n_narrow, n_wide = len(narrow), len(trial_wides)
                tmax = _round_up(max(q.size + t.size for *_, q, t in narrow + trial_wides), 512)
                if (tmax > cfg.long_pair_threshold or tmax + 4 >= (1 << 15)
                        or self._quantize_batch(n_narrow + R * n_wide) * (tmax + 2) * W
                        > cfg.memory_budget_bytes
                        or (R - 1) * n_wide > n_narrow + n_wide):
                    break  # tile rows would bust memory or dominate the batch
                wides = trial_wides
                n_tiles = R
                j += 1
            if n_tiles > 1:
                bandw = n_tiles * W - 1
                entries = narrow + [(p, rc, bandw, f32, q, t) for (p, rc, _b, f32, q, t) in wides]
                out.append(_TiledChunk(entries, W - 1, bandw, n_tiles))
                i = j
            else:
                out.append(base)
                i += 1
        return out

    def pack_tiled_chunk(self, chunk: _TiledChunk):
        """Host-packed inputs of a band-tiled chunk: (Q, T, qlens, tlens as
        pack_chunk's, one row per narrow entry and n_tiles per wide one, each
        row holding its pair; tile [B] int32 and wide [B] bool, the row
        layout of nw_cuda.tiled_rows; rowmap [len(chunk)], each entry's first
        row; tmax).  Rows past the entries' are zero-length narrow padding."""
        rowmap = np.zeros(len(chunk), np.int64)
        rows, tiles = [], []
        for e, entry in enumerate(chunk):
            n = chunk.n_tiles if entry[2] > chunk.base_band else 1
            rowmap[e] = len(rows)
            rows += [entry] * n
            tiles += range(n)
        Q, T, qlens, tlens, tmax = self.pack_chunk(rows)
        tile = np.zeros(Q.shape[0], np.int32)
        tile[: len(tiles)] = tiles
        wide = np.zeros(Q.shape[0], bool)
        wide[: len(rows)] = [entry[2] > chunk.base_band for entry in rows]
        return Q, T, qlens, tlens, tile, wide, rowmap, tmax

    def _dispatch_nw_chunk_tiled(self, chunk: _TiledChunk):
        """Launch the tiled sweep and walk for a band-tiled chunk: one row per
        narrow entry, n_tiles per wide one.  Returns _dispatch_nw_chunk's
        tuple for a 'runs' chunk, each entry's outputs taken from its first
        row, so collect proceeds as for any runs chunk (its run overflows
        join _runs_off_set, its band certificate is each entry's own)."""
        band = chunk.base_band
        force32 = chunk[0][3]
        use_int16 = self.cfg.dp_dtype in ("int16", "auto") and not force32
        Q, T, qlens, tlens, tile, wide, rowmap, tmax = self.pack_tiled_chunk(chunk)
        B = Q.shape[0]
        n_wide = int(wide.sum()) // chunk.n_tiles
        self.stats["tiled_chunks"] += 1
        self.stats["tiled_rows"] += (chunk.n_tiles - 1) * n_wide
        self.stats["cells_padded"] += B * (tmax + 2) * (band + 1)
        self.stats["dispatches"].append(
            {"kind": "tiled", "B": B, "band": band, "band_wide": chunk.wide_band, "n_tiles": chunk.n_tiles,
             "n_wide": n_wide, "tmax": tmax,
             "jobs": [[int(p), int(rc)] for p, rc, *_ in chunk], "fold": False, "rows": False,
             "int16": use_int16, "emit": "runs"})
        dev = self.device
        Qd, Td, qd, td = (torch.from_numpy(a).to(dev) for a in (Q, T, qlens, tlens))
        lay = dict(band=band, n_tiles=chunk.n_tiles, tmax=tmax)
        scores, tb = nw_cuda.nw_align_tiled(Qd, Td, qd, td, tile, wide, int16=use_int16, **lay,
                                            **self._penalties())
        tokens, counts = nw_cuda.nw_walk_runs_tiled(tb, qd, td, tile, wide, run_max=nw.RUN_MAX, **lay)
        del tb  # stream-ordered: the allocator reuses it only after the walk
        first = torch.from_numpy(rowmap).to(dev)
        scores, out, ready = to_host(scores[first], (tokens[first], counts[first]))
        return chunk, scores, ("runs", out), ready, qlens[rowmap], tlens[rowmap], use_int16

    def pack_chunk(self, chunk):
        """Host-packed kernel inputs of a chunk: (Q [B, lq], T [B, lt] uint8
        padded with QPAD/TPAD, qlens [B], tlens [B] int32, tmax).  Rows past
        the chunk's jobs are zero-length padding."""
        tmax = _round_up(max(q.size + t.size for *_, q, t in chunk), 512)
        B = self._quantize_batch(len(chunk))
        lq = _round_up(max(q.size for *_, q, _t in chunk), 256)
        lt = _round_up(max(t.size for *_, t in chunk), 256)
        Q = np.full((B, lq), nw.QPAD, dtype=np.uint8)
        T = np.full((B, lt), nw.TPAD, dtype=np.uint8)
        qlens = np.zeros(B, np.int32)
        tlens = np.zeros(B, np.int32)
        for b, (*_, q, t) in enumerate(chunk):
            Q[b, : q.size] = q
            T[b, : t.size] = t
            qlens[b] = q.size
            tlens[b] = t.size
        return Q, T, qlens, tlens, tmax

    def pack_fold_rows(self, chunk, Q, T):
        """The fold's backward rows of a packed chunk: each row of Q and T
        with its first qlen / tlen bases reversed (not complemented)."""
        Qr, Tr = Q.copy(), T.copy()
        for b, (*_, q, t) in enumerate(chunk):
            Qr[b, : q.size] = q[::-1]
            Tr[b, : t.size] = t[::-1]
        return Qr, Tr

    def _use_rows(self, chunk) -> bool:
        """Row-major kernels for this chunk?  Chunks are homogeneous in
        _v3_set membership (_make_nw_chunks keeps them apart)."""
        return self.cfg.sweep == "rows" and (chunk[0][0], chunk[0][1]) not in self._v3_set

    def _use_runs(self, chunk, tmax: int) -> bool:
        """Run tokens for this chunk?  Chunks are homogeneous in run-overflow
        membership (_make_nw_chunks keeps them apart)."""
        if self.cfg.emit == "ops":
            return False
        if not nw.runs_fit(tmax):
            if self.cfg.emit == "runs":
                raise ValueError("emit='runs' requires tmax < 32k; use 'auto'")
            return False
        p, rc = chunk[0][0], chunk[0][1]
        return (p, rc) not in self._runs_off_set

    def _dispatch_nw_chunk(self, chunk):
        """Launch the sweep and the walk for one chunk (through the long-pair
        route above long_pair_threshold anti-diagonals, the row-major
        kernels under sweep='rows', the fold where it applies); the walk's
        output and the scores start copying back without blocking the host.
        Returns (chunk, scores, payload, ready event, qlens, tlens,
        used_int16), payload ('runs', (tokens, counts)), ('ops', (opcodes,)),
        ('fold', (half-walk opcodes, cross_m)) or ('rowtok', (steps, grows,
        gvals, gcount)).  A band-tiled chunk takes _dispatch_nw_chunk_tiled,
        a chunk under a mesh _dispatch_nw_chunk_mesh."""
        if isinstance(chunk, _TiledChunk):
            return self._dispatch_nw_chunk_tiled(chunk)
        if self.cfg.mesh is not None:
            return self._dispatch_nw_chunk_mesh(chunk)
        band = chunk[0][2]
        force32 = chunk[0][3]
        Q, T, qlens, tlens, tmax = self.pack_chunk(chunk)
        B = Q.shape[0]
        long = tmax > self.cfg.long_pair_threshold
        use_int16 = self.cfg.dp_dtype in ("int16", "auto") and not force32 and not long
        rows = not long and self._use_rows(chunk)
        fold = (not long and not rows
                and (self.cfg.fold is True
                     or (self.cfg.fold == "auto" and B <= self.cfg.fold_max_batch)))
        entry = {"kind": "chunk", "B": B, "band": band, "tmax": tmax,
                 "jobs": [[int(p), int(rc)] for p, rc, *_ in chunk],
                 "fold": fold, "rows": rows, "int16": use_int16}
        dev = self.device
        Qd, Td, qd, td = (torch.from_numpy(a).to(dev) for a in (Q, T, qlens, tlens))
        pen = self._penalties()
        if not fold:
            self.stats["cells_padded"] += B * (tmax + 2) * (band + 1)
        if long:
            seg = nw_cuda.LONG_SEG
            t_need = int((qlens + tlens).max())
            n_seg = -(-t_need // seg)
            budget = self.cfg.memory_budget_bytes
            group = nw_cuda.long_group_size(B, band + 1, seg, n_seg, budget)
            entry.update(kind="long", seg=seg, n_seg=n_seg, emit="ops", group=group,
                         sweep=nw_cuda._segment_plan(B, band + 1, Q.shape[1], T.shape[1], seg, group,
                                                     pen).route)
            self.stats["long_pairs"] += len(chunk)
            self.stats["dispatches"].append(entry)
            # a stream of the chunk's own, so that a long chunk dispatched
            # next runs beside it; the collect waits on its event
            with _own_stream(self._long_stream(), Qd, Td, qd, td):
                scores, ops = nw_cuda.nw_align_long(Qd, Td, qd, td, band=band, seg=seg,
                                                    t_need=t_need, memory_budget=budget, **pen)
                # the segment walk emits opcodes
                scores, out, ready = to_host(scores, (ops,))
            return chunk, scores, ("ops", out), ready, qlens, tlens, use_int16
        elif rows:
            scores, tb = nw_cuda.nw_align_rows(Qd, Td, qd, td, band=band, int16=use_int16, **pen)
            mode, out = "rowtok", nw_cuda.nw_walk_rows(tb, qd, td, band=band)
            del tb
        elif fold:
            # the fold region must cover the certified band: widen it by the
            # chunk's largest length difference; the trip count halves
            maxdiff = max(abs(q.size - t.size) for *_, q, t in chunk)
            maxlen = max(max(q.size, t.size) for *_, q, t in chunk)
            band_eff = self._quantize_band(band + maxdiff, maxlen, maxlen)
            tmax_half = _round_up(tmax // 2 + 2, 256)
            self.stats["cells_padded"] += 2 * B * (tmax_half + 2) * (band_eff + 1)
            entry.update(band_eff=band_eff, tmax_half=tmax_half)
            Qr, Tr = (torch.from_numpy(a).to(dev) for a in self.pack_fold_rows(chunk, Q, T))
            scores, ops2, cross_m = nw_cuda.nw_align_fold(Qd, Td, Qr, Tr, qd, td, band=band_eff,
                                                          tmax_half=tmax_half, int16=use_int16,
                                                          **pen)
            mode, out = "fold", (ops2, cross_m)  # the fold's walk emits opcodes
        else:
            # kernel A's route on the card: "regs", "twins" or "wide"
            entry["sweep"] = nw_cuda.align_plan(B, band + 1, Q.shape[1], T.shape[1], int16=use_int16,
                                                **pen).route
            scores, tb = nw_cuda.nw_align(Qd, Td, qd, td, band=band, tmax=tmax, int16=use_int16,
                                          **pen)
            if self._use_runs(chunk, tmax):
                mode = "runs"
                out = nw_cuda.nw_walk_runs(tb, qd, td, band=band, tmax=tmax, run_max=nw.RUN_MAX)
            else:
                mode, out = "ops", (nw_cuda.nw_walk(tb, qd, td, band=band, tmax=tmax),)
            del tb  # stream-ordered: the allocator reuses it only after the walk
        entry["emit"] = "ops" if mode == "fold" else mode
        self.stats["dispatches"].append(entry)
        scores, out, ready = to_host(scores, out)
        return chunk, scores, (mode, out), ready, qlens, tlens, use_int16

    def _long_stream(self):
        """The stream of the next long chunk on the card (None on the CPU):
        two kept streams in turn, as at most two chunks are in flight (chunk
        k + 1 is dispatched before chunk k is collected), so the allocator
        reuses each stream's blocks from chunk to chunk."""
        if self.device.type != "cuda":
            return None
        if self._long_streams is None:
            self._long_streams = [torch.cuda.Stream(self.device) for _ in range(2)]
        self._long_turn ^= 1
        return self._long_streams[self._long_turn]

    def _dispatch_nw_chunk_mesh(self, chunk):
        """A chunk under a mesh: its rows padded with zero-length rows to a
        multiple of the mesh size and split into equal row slices, slice i
        through the chunk's kernels on device i (the row-major ones under
        sweep='rows', else the sweep and the runs or opcode walk), the
        outputs gathered in row order on the first device.  No fold and no
        long-pair route: a long chunk runs single-shot, in int16 where
        dp_dtype asks for it.  Returns _dispatch_nw_chunk's tuple."""
        from ..parallel.mesh import shard_batch

        mesh = self.cfg.mesh
        band, force32 = chunk[0][2], chunk[0][3]
        Q, T, qlens, tlens, tmax = self.pack_chunk(chunk)
        B = Q.shape[0]
        use_int16 = self.cfg.dp_dtype in ("int16", "auto") and not force32
        rows = self._use_rows(chunk)
        mode = "rowtok" if rows else "runs" if self._use_runs(chunk, tmax) else "ops"
        self.stats["cells_padded"] += B * (tmax + 2) * (band + 1)
        pad = -B % mesh.size
        Q = np.concatenate([Q, np.full((pad, Q.shape[1]), nw.QPAD, np.uint8)])
        T = np.concatenate([T, np.full((pad, T.shape[1]), nw.TPAD, np.uint8)])
        qlens = np.concatenate([qlens, np.zeros(pad, np.int32)])
        tlens = np.concatenate([tlens, np.zeros(pad, np.int32)])
        pen = self._penalties()
        parts = []
        for Qd, Td, qd, td in shard_batch(mesh, Q, T, qlens, tlens):
            if rows:
                scores, tb = nw_cuda.nw_align_rows(Qd, Td, qd, td, band=band, int16=use_int16, **pen)
                out = nw_cuda.nw_walk_rows(tb, qd, td, band=band)
            else:
                scores, tb = nw_cuda.nw_align(Qd, Td, qd, td, band=band, tmax=tmax, int16=use_int16, **pen)
                if mode == "runs":
                    out = nw_cuda.nw_walk_runs(tb, qd, td, band=band, tmax=tmax, run_max=nw.RUN_MAX)
                else:
                    out = (nw_cuda.nw_walk(tb, qd, td, band=band, tmax=tmax),)
            del tb
            parts.append((scores, out))
        first = mesh.devices[0]
        scores = torch.cat([s.to(first) for s, _ in parts])
        out = tuple(torch.cat([o[k].to(first) for _s, o in parts]) for k in range(len(parts[0][1])))
        self.stats["dispatches"].append(
            {"kind": "chunk", "B": B, "band": band, "tmax": tmax,
             "jobs": [[int(p), int(rc)] for p, rc, *_ in chunk], "fold": False, "rows": rows,
             "int16": use_int16, "emit": mode, "mesh": mesh.size})
        scores, out, ready = to_host(scores, out)
        return chunk, scores, (mode, out), ready, qlens, tlens, use_int16

    def _collect_nw_chunk(self, dispatched, pairs):
        """Returns (done: {(pair_idx, rc): result-or-None}, retries).

        A job is retried (not returned) when its int16 score saturated, when
        the band certificate fails, or when its row-major gap list or its run
        list overflowed; a None result means the pair exceeded the
        divergence cap with a certified-exact score."""
        chunk, scores, (mode, out), ready, qlens, tlens, used_int16 = dispatched
        if ready is not None:
            ready.synchronize()
        scores = scores.numpy()
        data = [a.numpy() for a in out]
        if mode == "fold":
            # forward ops ++ [M at the crossing] ++ reversed backward ops
            data = [nw.merge_fold_ops(data[0], data[1])]
            mode = "ops"

        done: dict[tuple[int, bool], AlignmentResult | None] = {}
        retries: list[tuple[tuple[int, bool, int, bool], int]] = []
        decode_jobs = []
        for b, (p, rc, bandj, force32, q, t) in enumerate(chunk):
            qlen, tlen = int(qlens[b]), int(tlens[b])
            score = int(scores[b])
            if used_int16 and score >= nw.INT16_CUTOFF:
                self.stats["int16_retries"] += 1
                retries.append(((p, rc, bandj, True), score))
                continue
            exact = bandj >= max(qlen, tlen) or (
                0 <= score < self._cert_bound(bandj, qlen, tlen)
            )
            if not exact:
                self.stats["band_escalations"] += 1
                retries.append(
                    (
                        (p, rc, self._escalated_band(max(score, 0), bandj, qlen, tlen), force32),
                        score if score >= 0 else np.iinfo(np.int32).max,
                    )
                )
                continue
            if score < 0 or score > self._pair_cap(qlen, tlen):
                done[(p, rc)] = None  # certified-exact score exceeds the cap
                continue
            if mode == "rowtok" and int(data[3][b]) > nw.GAP_MAX:
                # the gap list was cut on the device: retry on the
                # anti-diagonal kernels (same band: the score is certified)
                self.stats["gap_overflows"] += 1
                self._v3_set.add((p, rc))
                retries.append(((p, rc, bandj, force32), score))
                continue
            if mode == "runs" and int(data[1][b]) > nw.RUN_MAX:
                # the run list was cut on the device: retry through the
                # opcode walk (same band: the score is already certified)
                self.stats["run_overflows"] += 1
                self._runs_off_set.add((p, rc))
                retries.append(((p, rc, bandj, force32), score))
                continue
            self.stats["cells_true"] += (qlen + tlen + 1) * (bandj + 1)
            decode_jobs.append((b, p, rc, q, t, score))

        if decode_jobs:
            rows = [b for b, *_ in decode_jobs]
            qs = [q for _b, _p, _rc, q, _t, _s in decode_jobs]
            ts = [t for _b, _p, _rc, _q, t, _s in decode_jobs]
            if mode == "runs":
                items_all = nw.decode_runs_batch(data[0][rows], data[1][rows], qs, ts)
            elif mode == "rowtok":
                steps, grows, gvals, gcount = data
                items_all = [
                    nw.resolve_matches(nw.decode_rowtokens(steps[b], grows[b], gvals[b],
                                                           int(gcount[b]), q.size), q, t)
                    for b, q, t in zip(rows, qs, ts)
                ]
            else:
                items_all = nw.decode_batch(data[0][rows], qs, ts)
            for (b, p, rc, q, t, score), items in zip(decode_jobs, items_all):
                qi, tj = pairs[p]
                done[(p, rc)] = AlignmentResult(int(qi), int(tj), rc, score, items)
        return done, retries

    def _pair_cap(self, qlen: int, tlen: int) -> int:
        sc = self.cfg.scores
        hard = sc.mismatch_penalty * max(qlen, tlen) + sc.gap1_open + sc.gap1_extend * (
            qlen + tlen
        )
        if self.cfg.max_divergence is not None:
            return min(hard, sc.max_score_for_divergence(max(qlen, tlen), self.cfg.max_divergence))
        return hard
