#!/usr/bin/env python3
"""Drive seqrush_tpu_torch on one NVIDIA GPU and check it.

Run from the repository root with one CUDA device:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ok line):
  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. build the sweep and walk kernels from seqrush_tpu_torch/ops/csrc with
     nvcc (sm_90a), one process per source, then the host library
     (seqrush_tpu_torch/csrc/seqrush_native.cpp) with g++;
  3. the main path: the JAX bench's headline corpus (25 synthetic HLA-like
     sequences of ~3.3 kb, ~2% SNPs plus indels, one sample carrying an
     inversion; all 600 ordered pairs; scoring 0,5,8,2,24,1) through
     ``python -m seqrush_tpu_torch -s in.fa -o out.gfa`` (the CLI's main,
     no route flag: the inversion carrier's wide pairs take the anchored
     route, chained on the host, their small windows aligned by the host
     DP, their inversion cores by device window chunks): alignment,
     union-find, graph, compaction, the Ygs layout (PG-SGD on the card,
     groom, final order) and the GFA write, which the golden invariant
     gates.  The kernels' launch counters are reset just before and read
     just after each run; the chunks' walks fetch run tokens (kernel B's
     runs mode, the default emit).  Then the same run with ``--no-sort``,
     whose GFA must have the JAX package's sha256 (DEFAULT_GFA_SHA256).  The
     anchored route's counters and seconds, the align phase's rate and the
     dispatch shapes are printed.  The sorted graph must have node ids
     1..N, be isomorphic to the unsorted one, and have a layout RMSE no
     higher; the layout's phase seconds, the SGD's ticks and their width
     and both graphs' RMSE and MAE are printed (the default run's layout
     must have launched the SGD tick kernel);
  3d. the SGD tick kernel (ops/csrc/sgd_tick.cu, one cooperative launch a
     block of ticks; see run_sgd and seqrush_tpu_torch/tools/sgd_timing.py)
     on the unsorted headline graph: the whole run (800 ticks, 2 blocks) on
     the card against the plain tick on the CPU fed the same draws, bit for
     bit after every tick (a launch a tick) and at the end of every block (a
     launch a block), and the layout's own run ending at the same
     positions; the kernel's run and the plain ticks' run on the card timed
     in turns, the launches, device time and device-busy share of each from
     torch.profiler (one launch of the kernel a block of ticks), the
     kernel's time by phase, two kernel runs bit-equal; then the same on a
     synthetic 1,000-path graph (tools/headline.py::synth_variation_graph)
     and on it with a node of 20,000 steps (--loop 20), the first block of
     draws of each held to the CPU;
  3b. the same corpus with ``--wide-route full --no-sort`` (one wide-band
     sweep per wide pair): every pair aligned, every path in the graph;
     both graphs' counts and whether the two --no-sort GFA files are
     byte-identical are printed, not required (the host window DP and the
     device walk may break an equal-score tie differently, so a gap may
     slide; phase 5 holds every score equal), with the sha256 of both
     --no-sort GFA files (scripts/jax_route_graphs.py prints the JAX
     package's);
  3c. the same corpus with ``--wide-verify --no-sort``: every stitch must
     be certified by the score-only sweep (wide_verified == anchored_pairs
     > 0);
  4. small corpora through the pipeline: a 5 x 1.2 kb one with
     ``--no-sort`` on cuda and on cpu (the kernels' plain versions),
     byte-identical GFA files; with the layout twice on cuda, byte-identical
     GFA files, and once on cpu, a GFA isomorphic to the cuda one; then
     ``-x tree:2,1,0.2`` and ``--iterative`` on cuda, with their pair counts
     printed; and a 4 x 2.3 kb family with an inversion carrier (wide pairs
     on the anchored route) with ``--no-sort`` on cuda and on cpu,
     byte-identical GFA files;
  5. all 600 pairs through an anchored and a full-route WfaAligner on the
     card, three times each in turns: every pair's score equal (both are
     DP-exact), and the runner's seconds printed.  Each kernel
     against its plain PyTorch version on the card, on the main path's own
     dispatch inputs (the largest chunk in full; the widest chunk, from
     the full-route run, and the first device window chunk, each as its
     first 7 jobs plus a zero-length padding row): exact equality
     (tolerance 0, all integer).  The score-only sweep's scores must equal
     the full sweep's and the plain version's on the largest chunk and on
     the first verify dispatch of 3c.  Kernel times are CUDA-event medians
     of 3 runs after a warm-up, on each of those dispatches in full; the
     plain versions are timed once, on the largest chunk (score-only: on
     the verify dispatch).  The sweep is also timed at 1, 2 and 4 warps per
     pair on the largest dispatch and at each lanes-per-thread shape on the
     widest, each held bit-equal to the planner's launch; registers per
     thread, shared memory per block and resident pairs per SM come from
     the CUDA runtime and the launch code; the build's ptxas registers and
     spills are printed for every kernel;
  6. long pairs (qlen + tlen > 65,536) through the segmented route (kernels
     A and B in their segment modes, segments of 2,048 anti-diagonals; see
     run_long): the 110 kb pair of tests/test_zoo_extended.py through
     ``--no-sort``, whose GFA must have the JAX package's sha256
     (LONG_PAIR_GFA_SHA256); an 8 x 60 kb locus through the default run and
     ``--no-sort`` (whose GFA must have the JAX package's sha256,
     LOCUS_GFA_SHA256), every pair on the long route; each segment kernel
     against its plain version on the first, a middle and the last segment
     of the largest long chunk, and the route's launch shapes at the main
     path's shapes against theirs (the forward run and the grouped
     recompute of LONG_RUN segments on the first, a middle and the last
     group, into the chunk's whole traceback at the group's rows; the group
     walk over every segment); the route at G = n_seg and at G = 1 against
     single-shot kernels A + B on that chunk; the times of each segment
     kind and launch shape, of the route per chunk by G with the recompute
     overlapping the forward pass and without, of single-shot A + B, and
     of the locus's long chunks in series and at once (a stream each; equal
     results);
  7. the sweepga backend and --inversion-aware (see run_backends): the
     headline corpus through ``--aligner sweepga --no-sort`` (its GFA must
     have the JAX package's sha256, SWEEPGA_GFA_SHA256) and with the layout;
     kernels A and B against their plain versions on that run's device gap
     chunk; the orientation probe on a trio the sketch leaves undecided
     (probe_trio; score-only, one-piece) against its plain version and the
     JAX package's answer (PROBE_ORIENTATIONS); the headline corpus through
     ``--inversion-aware --no-sort`` (INVERSION_GFA_SHA256), with the route
     and time of the reverse pass's widest chunk, and kernels A and B
     against their plain versions on its inversion window batch;
  8. run tokens and the wavefront kernel (see run_phase8): 8a. kernel B's
     runs mode against its plain version on the largest chunk, the window
     chunk and the sweepga gap chunk (each at its own token budget) and on
     a synthetic batch whose runs split and overflow; each mode's
     run_overflows against the JAX package's (RUN_OVERFLOWS); all 600 pairs
     through the runner with emit='auto' and 'ops', in turns, with equal
     results; 8b. all 600 pairs through WfaAligner(kernel='wfa'): every
     batch's kernel against its plain version (scores, whole history,
     CIGARs), each batch's route, ring and staging bytes and microseconds a
     score step, the launches' sum and the score-only mode on one batch
     beside the first design's times from an earlier tree's run (EARLIER_MS,
     printed only, never in the kernels line), and the sha256 of a
     subset's records against the JAX package's (WFA_SUBSET_SHA256);
  9. dp_dtype='int16', sweep='rows', fold and band_tiling (see run_phase9):
     all 600 pairs through WfaAligner under each option of VARIANTS, in turns with
     the default (the runner's seconds), each option's kernels launched,
     every score the default run's, the records' sha256 and the counters
     the JAX package's (VARIANT_DIGESTS; the fold options on wfa_subset());
     kernel A's int16 mode (the packed s16x2 sweep where the planner gives
     it twins) and snapshot mode, kernel B's start mode and the row-major
     kernels C and D against their plain versions on every chunk those
     runs launched them on, timed on the first such run's largest chunk
     (the int16 mode in turns with the int32 mode and the int32 body's
     int16 mode, with its plan, registers, local bytes and twins an SM;
     kernel C with its plan, its pairs resident an SM and its microseconds
     a row; kernel D with its registers and pairs an SM; each beside the
     first design's time); the fold's combine kernel against its plain
     version on every fold chunk, timed with its launches on the largest;
     and
     int16 retries forced with a lowered INT16_CUTOFF;
 10. band_tiling='auto' (see run_phase10): the 600 pairs on the full wide
     route untiled and tiled, in turns (the runner's seconds), the tiled
     records equal to the untiled ones; kernel A's tiled mode and kernel B's
     tiled runs mode against their plain versions on every tiled chunk of
     phase 9's tiled and tiled_int16 runs (the sweep's traceback on the rows
     it promises, nw_cuda.tiled_promised_rows); on the merged chunk the
     tiled sweep's registers, spills and blocks an SM, both chunks' sweeps
     timed, and sweep and walk timed against the same pairs split as the
     untiled runner splits them; the phase's wall time;
 11. the mesh paths on the one card, D shards placed by Mesh([cuda:0] * D)
     (see run_phase11): a ~24 kb pair with an 8 kb translocation, over the
     default memory budget, through the band-sharded route (kernel A's
     sharded mode) against the run without a mesh, the sharded mode against
     its plain version and timed for D = 1, 2, 4, 8; the 600 pairs under
     meshes of 1, 2 and 4 shards (records equal); the sharded align + unite
     step for D = 1, 2, 4, 8; two processes joined by gloo on the headline
     FASTA with --no-sort (DEFAULT_GFA_SHA256 on both);
 11e. kernel A's wide route (see run_phase11e): translocation_pair() with
     wide_route='full' and no mesh through it (nw_sweep_wide) and through
     the long route at its band (nw_sweep_wide_segment), scores equal; the
     same for long_deletion_pair() (W 28,160: a chain of two 16-CTA
     clusters a pair, launched in slices), its score the 28 kb gap's; each
     site of tools/wide_timing.py against its plain version (exact) and
     timed, with its plan, registers, spills, bound and chain floor (the
     floor probe's step latency at the site's plan);
 12. the host library (seqrush_tpu_torch/csrc/seqrush_native.cpp) at the
     sizes users run (see run_phase12): the C++ FASTA parser against the
     Python loop on the headline, the locus and a 1,000 x 3.3 kb FASTA (equal
     records), and fasta_faults() through --no-sort (the JAX package's GFA
     or golden-check error, FASTA_FAULTS_JAX); in a fresh process (12b) the
     default headline run's pre_unite split into the CUDA context, loading
     the kernels' library, the edges' copy, the first launches and the
     unite itself (and again warm), the align phase's seconds and first
     chunk dispatches, the union-find kernels' launches by the pre-unite and
     by the flush, the Python match-run loop's seconds, and at three sizes
     (the headline's flush, the locus's, a synthetic 50 M-edge flush over
     1,000 x 3.3 kb) the unite's one launch (ops/csrc/unionfind.cu: the hook
     and the compress behind a grid barrier) and the compress launch alone
     (on an uncompressed forest of the flush's slots) timed, the edges'
     copy apart, the unite in turns with its plain version (with the
     plain version's host reads) and the host library's
     unite in turns with the pipeline's, every parent equal; find on an
     uncompressed forest against its plain version (DEFAULT_GFA_SHA256,
     the locus's phase 6 bytes); kernel='wfa' with the C++
     and the Python backtrace (equal records, WFA_SUBSET_SHA256); the
     translocation pair's host walk in C++ and Python (equal items); the
     sweepga align phase (SWEEPGA_GFA_SHA256) and chain_anchors' DP in C++
     and Python (equal chains);
 13. prints {"kernels": [...]}, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.  The walk's entries (nw_walk_runs,
     nw_walk_runs_tiled) give as ms the kernel's time behind a spin of the
     card (spun_ms), which leaves out the host's issue of the launch; before
     the walk's redesign their ms was a plain CUDA-event median (cuda_ms),
     which counts it, so the two are not compared.

Bounds: the least time the card could take for the same work, the larger
of (bytes moved / 3.35 TB/s) and (instructions / their peak rate).  The
H100 SXM data sheet gives 67 TFLOP/s in float32: 33.5 T lane operations a
second, one warp instruction per cycle on each of the 528 SM
sub-partitions (32 lanes x 4 x 132 SMs x 1.98 GHz), the most the card
issues of any 32-bit instruction.  Integer minima (IMNMX and the DPX forms)
run on the integer ALU pipe alone, 16 lanes a sub-partition: 16.7 T a
second.  The sweep must write the whole traceback tensor and needs, per
needed cell ((qlen + tlen) anti-diagonals x W lanes per pair), the fewest
instructions this recurrence takes on sm_90 with DPX (m: a minimum):
  8  the four gap candidates' open and extend additions;
  8  the four gap minima (4 m), each with the compare that gives its opened
     bit (sm_90 has no min that also sets a predicate);
  1  the four opened bits into the byte (one predicate-to-register move);
  3  the substitution cost (compare, select) and the diagonal candidate;
  9  the H choice: five keys value * 8 + tag, two 3-way DPX minima (2 m),
     the value and the choice taken back out of the key;
  2  the cell's validity (one range compare, one select);
  5  validity and INF clamp of the five states, one DPX add-min each (5 m);
  1  the byte into its packed word;
 = 37 instructions, 11 of them minima.  Per cell the bound is the larger of
37 / 33.5 T (issue) and 11 / 16.7 T (the ALU pipe), which is the first.
Only the minima are charged to the ALU pipe: the other instructions could
issue on the FMA pipe (IMAD forms) or not, and counting them there could
only raise the bound.  The score-only sweep moves no traceback, and per
cell it needs none of the instructions that build the byte:
  8  the four gap candidates' additions;
  4  the four gap minima (4 m);
  3  the substitution cost and the diagonal candidate;
  2  H: two 3-way DPX minima over the five values (2 m);
  2  the cell's validity;
  5  validity and INF clamp of the five states (5 m);
 = 24 instructions, 11 of them minima: again the issue rate bounds it.
The fold's combine is charged the 12 [B, W] int32 planes it reads, what
it writes and 55 instructions a forward lane (COMBINE_OPS_PER_LANE): bytes
bound it.  The SGD tick is charged each term's draws (18 B); its
gathers at 4 B a field, the width of the kernel's int32 and float32
records (the first step's node, position, path and rank, the second step's
node and position, the path's first step and count, and H[js] with up to
bit_length(space + 1) probes of the search), each table at its reads a
term times the terms or at its size where that is less (H and the path
tables, read by every term, come from cache); and the positions read once
and written once, 8 B a node (tools/sgd_timing.py::tick_bytes): 0.38 MB and 0.11 us a tick on the
headline, 11.05 MB and 3.3 us on the 1,000-path graph.  Bytes bound it,
while a term's chain of five dependent reads, the tick's four grid
barriers and the counting sort's scattered stores set its real floor.
The walk needs one byte read and about 25 instructions per step it takes,
at the issue rate, and writes the opcode rows (its runs mode: the token
rows and the counts instead).  The wavefront kernel must write its history
tensors whole and needs, per cell of each score step a pair takes
(2 * band + 1 diagonals), about 40 instructions for the five wavefronts'
loads, maxima, validity and stores (WFA_OPS_PER_CELL), at the issue rate;
its serial score steps, one barrier each, are its real floor.  The
row-major sweep (kernel C) must write its traceback [B, R + 1, 2K + 1] whole
and needs, per cell of the rows each pair has (qlen + 1 rows x 2K + 1
lanes), about 35 instructions, 10 of them minima (ROWS_OPS_PER_CELL): the
two I candidates and their minima and opened bits, the substitution and the
gap-free choice, the two closed-form D states (the lane ramp, the running
prefix minimum, the open, the clamp and the opened compare each) and the
override, and the byte; its row walk (kernel D) is charged as the
anti-diagonal walk is, a step a row.  The snapshot mode is charged the
cells the fold needs of it, each row's anti-diagonals up to t_snap + 1 (the
combine and the start walk read nothing later), their traceback bytes and
its SNAP, DIAGA and DIAGB stores.  The tiled mode is charged the sweep's instructions
for each pair's cells at its own lanes (W, or n_tiles * W for a wide pair)
and its whole tile-row traceback.  The int16 mode is charged half the sweep's 37
instructions and 11 minima a cell: its values fit 16-bit lanes, and the
packed s16x2 forms (__viaddmin_u16x2, __vimin3_u16x2) do two lanes an
instruction at the same rates; the packed sweep (nw_sweep_i16.cu) takes H's
choice and the opened bits without the int32 body's 19-bit keys, at more
instructions a twin's cell than half of 37, so this is a floor below what
it reaches.  A segment launch is charged
the same instructions for the cells its pairs need in its anti-diagonals,
its traceback rows [B, seg, W] (full mode), the carry read and written (2 x
24 bytes a lane) and its windows of the operands; a segment walk its steps,
its opcode columns [B, seg] and the cursor.  The sharded mode (the JAX
package's unclamped recurrence, no validity) needs per cell the sweep's
instructions without the validity and the five clamps: 30 instructions, 6
of them minima (SHARD_OPS_PER_CELL), at the issue rate, and writes its
strips whole; its handover of one column a step is latency, which no bound
of bytes or instructions sees.  The union-find's unite launch (the hook and
the compress) is charged its edges and the parent in and out once (8 B an
edge, int32 ends, and 8 B a slot); its compress launch alone the forest
read and written once (8 B a slot); find its positions in and roots out
(8 B a position) and the parent read once.  Their finds' chains of dependent
L2 reads set their real floor.
"""

from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from seqrush_tpu_torch.tools.headline import (SCORES, WFA_BAND_SLACK, long_deletion_pair, long_deletion_score,
                                              synth_hla, translocation_pair)
from seqrush_tpu_torch.tools.sweep_shapes import SPIN_CYCLES, device_ms, masked_rows_err, snapshot_rows_err, spun_ms

HBM_BYTES_PER_S = 3.35e12
ISSUE_OPS_PER_S = 33.5e12  # 32-bit lane instructions of any kind
ALU_OPS_PER_S = 16.7e12  # integer minima, on the ALU pipe alone
SWEEP_OPS_PER_CELL = 37
SWEEP_MIN_OPS_PER_CELL = 11
SCORE_ONLY_OPS_PER_CELL = 24
SCORE_ONLY_MIN_OPS_PER_CELL = 11
WALK_OPS_PER_STEP = 25
WFA_OPS_PER_CELL = 40
REPS = 3
# the synthetic flush of phase 12b: the pipeline flushes at 50,000,000 queued
# edges (pipeline.py::_queue_unites)
SYNTH_FLUSH_EDGES = 50_000_000
# the union-find's kernels on the pipeline's path (its pre-unite and flush)
UF_KERNELS = ("uf_unite",)


def synth_family(n_seqs=4, length=2304, seed=11):
    """Clone family: ~2% SNPs and indels per haplotype; the last one carries
    a reverse-complemented middle third (the anchored route's test family)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = bases[rng.integers(0, 4, size=length)]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    out = [("h0", base.tobytes())]
    for k in range(1, n_seqs):
        s = bytearray(base.tobytes())
        for pos in rng.integers(0, len(s), size=int(0.02 * len(s))):
            s[pos] = bases[rng.integers(0, 4)]
        for _ in range(rng.integers(2, 5)):
            pos = int(rng.integers(0, len(s) - 50))
            ln = int(rng.integers(1, 25))
            if rng.random() < 0.5:
                del s[pos : pos + ln]
            else:
                s[pos:pos] = bases[rng.integers(0, 4, size=ln)].tobytes()
        if k == n_seqs - 1:
            a, b = len(s) // 3, 2 * len(s) // 3
            s[a:b] = bytes(s[a:b]).translate(comp)[::-1]
        out.append((f"h{k}", bytes(s)))
    return out


def small_corpus(n=5, length=1200):
    """Gene-scale haplotypes (~1% SNPs, small deletions) for the cpu check."""
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = bases[rng.integers(0, 4, size=length)]
    named = [("s0", base.tobytes())]
    for k in range(1, n):
        v = bytearray(base.tobytes())
        for pos in rng.integers(0, len(v), size=12):
            v[pos] = bases[rng.integers(0, 4)]
        if k % 3 == 0:
            p = int(rng.integers(0, len(v) - 40))
            del v[p : p + int(rng.integers(1, 12))]
        named.append((f"s{k}", bytes(v)))
    return named


def long_pair():
    """The 110 kb pair of tests/test_zoo_extended.py (seed 11): a 55,000 bp
    base and a copy with 55 SNPs and a 20 bp deletion, qlen + tlen 109,980."""
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = bases[rng.integers(0, 4, size=55_000)]
    s = bytearray(base.tobytes())
    for pos in rng.integers(0, len(s), size=55):  # 0.1% SNPs
        s[pos] = bases[rng.integers(0, 4)]
    del s[30_000:30_020]
    return [("long0", base.tobytes()), ("long1", bytes(s))]


def synth_locus(n_seqs=8, length=60_000, seed=13):
    """A locus at real size: n_seqs haplotypes of one seeded ~60 kb base,
    each with 0.1% SNPs and two 20 bp deletions (long_pair's recipe), so
    every pair has qlen + tlen of about 120 k."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = bases[rng.integers(0, 4, size=length)]
    out = []
    for k in range(n_seqs):
        s = bytearray(base.tobytes())
        for pos in rng.integers(0, len(s), size=length // 1000):
            s[pos] = bases[rng.integers(0, 4)]
        for pos in sorted(rng.integers(1000, len(s) - 1000, size=2), reverse=True):
            del s[int(pos) : int(pos) + 20]
        out.append((f"hap{k}", bytes(s)))
    return out


def probe_trio(n=600, seed=0):
    """A base and two copies (about 2% SNPs) with one half reverse-
    complemented: rc(x) + y and rc(y) + x for base x + y.  Both orientations
    of every pair share k-mers, so the sketch leaves all PROBE_PAIRS
    undecided and choose_orientations' score-only probe decides them."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    a = bases[rng.integers(0, 4, size=n)].tobytes()
    x, y = a[: n // 2], a[n // 2 :]

    def snps(s):
        s = bytearray(s)
        for pos in rng.integers(0, len(s), size=len(s) // 50):
            s[pos] = bases[rng.integers(0, 4)]
        return bytes(s)

    return [("a", a), ("b", snps(x.translate(comp)[::-1] + y)),
            ("c", snps(y.translate(comp)[::-1] + x))]


PROBE_PAIRS = [[0, 1], [0, 2], [1, 0], [2, 0]]
# the JAX package's WfaAligner.choose_orientations(PROBE_PAIRS) on
# probe_trio() (tests/test_torch_sweep.py recomputes it)
PROBE_ORIENTATIONS = [False, True, False, True]

# sha256 of the JAX package's --no-sort GFA of synth_hla() under
# --aligner sweepga and under --inversion-aware (on the CPU;
# scripts/jax_backend_graphs.py recomputes them)
SWEEPGA_GFA_SHA256 = "142b8dd96b3035402896abd462a9af1a8571b47a4d7a7ce383a718a90a91cd6f"
INVERSION_GFA_SHA256 = "9f89f67b9901ba468f6d570c5aeb3625e0ca47436c464caa63026ef92c244c7f"
# the JAX package's inversion window batch on synth_hla() under
# --inversion-aware: [B, Lq, band, tmax] of its one nw_align_device call
INVERSION_BATCH_SHAPE = [8192, 1169, 101, 2302]

# sha256 of the JAX package's --no-sort GFA of long_pair() written to a
# FASTA (``python -m seqrush_tpu -s long.fa -o long.gfa --no-sort`` on the
# CPU; tests/test_torch_long.py recomputes it)
LONG_PAIR_GFA_SHA256 = "03cb6fe066479f93204cdbd7d217313ead1d884d6d3c21c701361be623a63c7e"
# sha256 of the JAX package's --no-sort GFA of synth_locus() (on the CPU;
# scripts/jax_locus_graph.py recomputes it, in about 80 s)
LOCUS_GFA_SHA256 = "ebfbd7a951b46899061c3f74b7ff76b3a8ffd7f3f29129df995c0eec744eb1ad"

# sha256 of the JAX package's --no-sort GFA of synth_hla() in its default
# mode, and each mode's run_overflows (scripts/jax_backend_graphs.py)
DEFAULT_GFA_SHA256 = "04375057ac55ede9d276479e1507de91a425ebf174d0ad114cd6614f902abb71"
RUN_OVERFLOWS = {"default": 0, "sweepga": 9, "inversion_aware": 0}
# sha256 of the JAX package's kernel='wfa' records of wfa_subset()'s 30
# ordered pairs (records_digest; scripts/jax_wfa_digest.py)
WFA_SUBSET_SHA256 = "6b2116f6a42dd54fad60540aa01b306aacf32e230d75243374235d22175dcb12"


def wfa_subset():
    """The WFA digest's corpus: synth_hla()'s first five sequences and its
    inversion carrier (30 ordered pairs)."""
    named = synth_hla()
    return named[:5] + [named[-1]]



def fasta_faults() -> dict[str, bytes]:
    """Three FASTA files (their bytes) that the C++ parser reads as the JAX
    package does and a Python loop of whitespace-stripped lines would not:
    'blank_names', headers with blanks after '>' (every name reads as '',
    so the --no-sort run fails the golden check); 'vertical_tab', a \x0b
    at the end of a sequence line and a \x0c at the start of another (each
    read as a base); 'long_header', headers of 70,000 bytes after '>'
    (the name ends at the 65,535-byte fgets buffer, and the line's other
    4,466 bytes are read as bases).  Three records of a seeded 300 bp base
    with one SNP each."""
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = acgt[rng.integers(0, 4, 300)].tobytes()

    def snp(pos):
        s = bytearray(base)
        s[pos] = ord("A") if s[pos] != ord("A") else ord("C")
        return bytes(s)

    recs = (base, snp(50), snp(200))
    filler = acgt[rng.integers(0, 4, 70_000)].tobytes()
    return {
        "blank_names": b"".join(h + s + b"\n" for h, s in zip((b">  s0 d\n", b">\tseqA\n", b">   \n"), recs)),
        "vertical_tab": (b">s0\n" + base[:150] + b"\x0b\n" + base[150:] + b"\n>s1\n\x0c" + recs[1]
                         + b"\n>s2\n" + recs[2] + b"\n"),
        "long_header": b"".join(b">r%d_" % k + filler[:70_000 - 3] + b"\n" + s + b"\n"
                                for k, s in enumerate(recs)),
    }


# what the JAX package's ``--no-sort`` run gives on each of fasta_faults()
# (on the CPU; scripts/jax_fasta_faults.py recomputes them): the GFA's
# sha256, or the sha256 of the golden check's RuntimeError message
FASTA_FAULTS_JAX = {
    "blank_names": ("error", "43956d3c5554ad1dc0c5e1cf2ef1e350b5cc0b1a3756b0b4b14059f72ae34b56"),
    "vertical_tab": ("gfa", "7b2dcc4e586cb5fe64cba0a31d2914894ee0466f4ef94e93ad16c1eab917a00d"),
    "long_header": ("gfa", "60fe4bf17d814e8cc678a513608fd2dc59ee343100d9855dd692e319291c9b54"),
}

# phase 9's RunnerConfig options (and scripts/jax_variant_digest.py's); the
# fold runs are held to the JAX package on wfa_subset()'s 30 pairs, since the
# JAX package's fold combine builds [5, B, W, W] arrays (about 7 GB for the
# headline's largest chunk on the CPU), the others on all 600 pairs (band
# tiling's JAX run peaks at 5.7 GB)
VARIANTS = {
    "int16": {"dp_dtype": "int16"},
    "rows": {"sweep": "rows"},
    "fold": {"fold": True},
    "fold_full": {"fold": True, "wide_route": "full"},
    "rows_int16": {"sweep": "rows", "dp_dtype": "int16"},
    "fold_int16": {"fold": True, "dp_dtype": "int16"},
    "tiled": {"band_tiling": "auto", "wide_route": "full"},
    "tiled_int16": {"band_tiling": "auto", "wide_route": "full", "dp_dtype": "int16"},
}
VARIANT_ON_SUBSET = ("fold", "fold_full", "fold_int16")
VARIANT_COUNTERS = ("int16_retries", "gap_overflows", "run_overflows", "band_escalations", "tiled_chunks",
                    "tiled_rows")
# the JAX package's records sha256 and counters of each (scripts/
# jax_variant_digest.py; int16 and rows_int16 give the same records as
# int32, fold and fold_int16 too, tiled and tiled_int16 too: no score
# reaches INT16_CUTOFF)
_NO_COUNTS = {"int16_retries": 0, "gap_overflows": 0, "run_overflows": 0, "band_escalations": 0,
              "tiled_chunks": 0, "tiled_rows": 0}
VARIANT_DIGESTS = {
    "int16": ("d4967907b16f98b3d4cb9795d1e90ec258d32d68b807d4ff50fcd86d69fd3381", _NO_COUNTS),
    "rows": ("5ac600448e35fc7431d162610e020b53b32ebf74b6c30686579dd2fd89b3ed31", _NO_COUNTS),
    "fold": ("5f79b69ec40e25304bbca8acbb290ba65c6863261d8dbc4ba38e3d40b473a63d", _NO_COUNTS),
    "fold_full": ("c4c2091a6143312748a8f8eb4192febf193e69925fab63a79ec2b7a372ecd640", _NO_COUNTS),
    "rows_int16": ("5ac600448e35fc7431d162610e020b53b32ebf74b6c30686579dd2fd89b3ed31", _NO_COUNTS),
    "fold_int16": ("5f79b69ec40e25304bbca8acbb290ba65c6863261d8dbc4ba38e3d40b473a63d", _NO_COUNTS),
    # one tiled chunk: the 48 wide pairs' 96 extra rows (peak 5.7 GB on the CPU)
    "tiled": ("c449a45cece4f593aec8d9b58c861b7eb1fde2a317d889256e1e008be83b0de8",
              {**_NO_COUNTS, "tiled_chunks": 1, "tiled_rows": 96}),
    "tiled_int16": ("c449a45cece4f593aec8d9b58c861b7eb1fde2a317d889256e1e008be83b0de8",
                    {**_NO_COUNTS, "tiled_chunks": 1, "tiled_rows": 96}),
}
# the kernels each option's run must launch (nw_cuda.LAUNCHES keys)
VARIANT_KERNELS = {
    "int16": ("nw_sweep_int16", "nw_walk_runs"),
    "rows": ("nw_rows_sweep", "nw_rows_walk"),
    "fold": ("nw_sweep_snapshot", "fold_combine", "nw_walk_start"),
    "fold_full": ("nw_sweep_snapshot", "fold_combine", "nw_walk_start"),
    "rows_int16": ("nw_rows_sweep", "nw_rows_walk"),
    "fold_int16": ("nw_sweep_snapshot", "fold_combine", "nw_walk_start"),
    "tiled": ("nw_sweep_tiled", "nw_walk_runs_tiled"),
    "tiled_int16": ("nw_sweep_tiled", "nw_walk_runs_tiled"),
}


def records_digest(results) -> str:
    """sha256 of the sorted (query, target, reverse, score, CIGAR) records of
    alignment results, one tab-separated line each."""
    lines = sorted(f"{r.query_idx}\t{r.target_idx}\t{int(r.is_reverse)}\t{r.score}\t"
                   f"{''.join(f'{n}{op}' for n, op in r.cigar)}\n" for r in results)
    return hashlib.sha256("".join(lines).encode()).hexdigest()


def write_fasta(path: Path, named) -> None:
    path.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s) for n, s in named))


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def once_ms(fn):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop), out


def sweep_bounds(Q, T, ql, tl, W, tb_numel: int) -> tuple[float, float]:
    """(bytes, operations) bounds in ms of one sweep launch; tb_numel 0 is
    the score-only mode.  W: the lanes of every pair, or a [B] tensor of each
    row's (a tiled launch: each pair's lanes on its first row, 0 on its
    other tile rows)."""
    cells = int(((ql + tl).to(torch.int64) * W).sum().item())
    sweep_bytes = Q.numel() + T.numel() + 8 * Q.shape[0] + 4 * Q.shape[0] + tb_numel
    ops, mins = ((SWEEP_OPS_PER_CELL, SWEEP_MIN_OPS_PER_CELL) if tb_numel
                 else (SCORE_ONLY_OPS_PER_CELL, SCORE_ONLY_MIN_OPS_PER_CELL))
    ops_ms = cells * max(ops / ISSUE_OPS_PER_S, mins / ALU_OPS_PER_S) * 1e3
    return sweep_bytes / HBM_BYTES_PER_S * 1e3, ops_ms


def walk_bounds(ops: torch.Tensor) -> tuple[float, float]:
    """(bytes, operations) bounds in ms of one walk launch that wrote ops:
    a traceback byte read per step, the opcode rows written, the lengths
    read; 25 instructions a step."""
    steps = int((ops != 0).sum().item())
    walk_bytes = steps + ops.numel() + 8 * ops.shape[0]
    return walk_bytes / HBM_BYTES_PER_S * 1e3, steps * WALK_OPS_PER_STEP / ISSUE_OPS_PER_S * 1e3


def walk_split_summary(split: dict) -> dict:
    """nw_cuda.walk_runs_split's split without its per-row cycles, rounded."""
    out = {k: round(v, 3) if isinstance(v, float) else v for k, v in split.items() if k != "row_cycles"}
    for k in ("cycles", "counts"):
        out[k] = {p: round(v, 1) for p, v in split[k].items()}
    return out


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel of nvcc's -Xptxas=-v log: its name,
    registers, barriers, stack frame and spill bytes."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(?:N(\d+)(?=_GLOBAL__N_))?(\w+)'", line)
        if m:
            # a kernel in an anonymous namespace: its name follows the namespace's
            mangled = m.group(2)[int(m.group(1) or 0):]
            lm = re.match(r"\d+", mangled)
            n = int(lm.group(0))
            name, rest = mangled[lm.end():lm.end() + n], mangled[lm.end() + n:]
            t = re.match(r"ILi(\d+)ELb([01])ELb([01])E", rest)
            w = re.match(r"ILb([01])E", rest)
            rows = re.match(r"ILi(\d+)ELb([01])ELb([01])ELb([01])ELi(\d+)ELi(\d+)E", rest)
            snap = re.match(r"ILi(\d+)ELb([01])EE", rest)
            wide = re.match(r"ILb([01])ELb([01])ELb([01])E", rest)
            if name == "nw_rows_sweep_kernel" and rows:
                name += (f"<{rows.group(1)}, {'two' if rows.group(2) == '1' else 'one'}-piece, "
                         f"{'int16' if rows.group(3) == '1' else 'int32'}"
                         f"{', windows' if rows.group(4) == '1' else ''}, {rows.group(5)} threads, "
                         f"{rows.group(6)} blocks>")
            elif name in ("nw_sweep_wide", "nw_sweep_wide_seg") and (
                    wa := re.match(r"ILi(\d+)ELb([01])ELb([01])ELi(\d)E", rest)):
                # the cell's arithmetic AR (csrc/nw_sweep_wide.cuh)
                name += (f"<{wa.group(1)}, {'two' if wa.group(2) == '1' else 'one'}-piece, "
                         f"{'traceback' if wa.group(3) == '1' else 'score-only'}, "
                         f"{('plain int32', 'keyed int32', 'int16')[int(wa.group(4))]}>")
            elif name in ("nw_sweep_wide_solo", "nw_sweep_wide_seg_solo") and (
                    ws := re.match(r"ILb([01])ELb([01])ELi(\d)E", rest)):
                name += (f"<{'two' if ws.group(1) == '1' else 'one'}-piece, "
                         f"{'traceback' if ws.group(2) == '1' else 'score-only'}, "
                         f"{('plain int32', 'keyed int32', 'int16')[int(ws.group(3))]}>")
            elif name == "nw_sweep_wide_floor" and (wf := re.match(r"ILi(\d+)E", rest)):
                name += f"<{wf.group(1)}>"
            elif name == "wfa_kernel" and wide:
                name += (f"<{'two' if wide.group(1) == '1' else 'one'}-piece, "
                         f"{'rings' if wide.group(2) == '1' else 'global'}"
                         f"{', staged' if wide.group(3) == '1' else ''}>")
            elif snap:
                name += f"<{snap.group(1)}, {'two' if snap.group(2) == '1' else 'one'}-piece>"
            elif wide:
                name += (f"<{'traceback' if wide.group(1) == '1' else 'score-only'}, "
                         f"{'int16' if wide.group(2) == '1' else 'int32'}"
                         f"{', snapshot' if wide.group(3) == '1' else ''}>")
            elif name.startswith(("nw_walk", "uf_unite")) and w:
                name += "<timed>" if w.group(1) == "1" else ""  # the walk's timer on (a timing tool's)
            elif name == "nw_sweep_tiled_wide" and w:
                name += f"<{'int16' if w.group(1) == '1' else 'int32'}>"
            elif name == "nw_sweep_tiled_regs" and t:
                name += (f"<{t.group(1)}, {'two' if t.group(2) == '1' else 'one'}-piece"
                         f"{', timed' if t.group(3) == '1' else ''}>")
            elif t:
                name += (f"<{t.group(1)}, {'two' if t.group(2) == '1' else 'one'}-piece, "
                         f"{'traceback' if t.group(3) == '1' else 'score-only'}>")
            elif w:
                name += f"<{'traceback' if w.group(1) == '1' else 'score-only'}>"
        elif "spill" in line:
            frame = line.strip()
        elif "Used" in line and "registers" in line and name:
            used = line.split("Used", 1)[1].strip()
            out.append(f"{name}: {used}; {frame}")
            name, frame = None, ""
    return out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over integer tensors, in slices of the first axis so a
    2 GB traceback needs no 16 GB int64 copy."""
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if not a.numel():
        return 0
    step = max(1, (1 << 27) // max(1, a[0].numel()))
    return max(
        int((a[k : k + step].to(torch.int64) - b[k : k + step].to(torch.int64)).abs().max().item())
        for k in range(0, a.shape[0], step)
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from seqrush_tpu_torch import native
    from seqrush_tpu_torch.ops import nw_cuda

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} | torch {torch.__version__} cuda {torch.version.cuda} | {smi}")

    # 2. build: nvcc for the kernels, then g++ for the host library
    t0 = time.time()
    lib_path, log = nw_cuda.build()
    t1 = time.time()
    host_path = native.build()
    print(f"build: {t1 - t0:.2f} s -> {lib_path.relative_to(root)}; host library "
          f"{time.time() - t1:.2f} s -> {host_path.relative_to(root)}")
    ptxas = ptxas_summary(log)
    for line in ptxas:
        print(f"  ptxas {line}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return run(Path(tmp), name, smi, ptxas)


def run(work: Path, name: str, smi: str, ptxas: list[str]) -> int:
    from seqrush_tpu_torch import cli
    from seqrush_tpu_torch.align import anchored
    from seqrush_tpu_torch.align.pairs import all_ordered_pairs
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
    from seqrush_tpu_torch.graph.bigraph import parse_gfa
    from seqrush_tpu_torch.layout.sgd import sgd_setup
    from seqrush_tpu_torch.layout.ygs import YgsParams
    from seqrush_tpu_torch.ops import nw, nw_cuda
    from seqrush_tpu_torch.tools.isomorphic import isomorphic
    from seqrush_tpu_torch.tools.measure_layout_quality import layout_quality
    from seqrush_tpu_torch.scores import AlignmentScores
    from seqrush_tpu_torch.sequences import make_sequence_set

    named = synth_hla()
    fa, gfa, prof = work / "hla25.fa", work / "hla25.gfa", work / "profile.json"
    gfa_ns = work / "hla25_nosort.gfa"
    write_fasta(fa, named)
    path_kernels = ("nw_sweep", "nw_walk_runs")

    def drive(out: Path, *flags: str, kernels=path_kernels, fasta=fa):
        """One CLI run on cuda with the launch counters reset just before and
        read just after: (profile report, launches, wall seconds).  Fails if
        a kernel of the run's path was not launched."""
        nw_cuda.reset_launch_counts()
        t0 = time.time()
        rc = cli.main(["-s", str(fasta), "-o", str(out), "--profile", str(prof), *flags])
        wall = time.time() - t0
        counts = dict(nw_cuda.LAUNCHES)
        if rc != 0:
            raise RuntimeError(f"cli.main returned {rc} with flags {flags}")
        for k in kernels:
            if counts[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched with flags {flags}")
        return json.loads(prof.read_text()), counts, wall

    def anchored_line(st):
        keys = ("anchored_pairs", "anchored_windows", "host_windows", "anchored_fallbacks",
                "wide_verified", "anchored_s")
        return json.dumps({k: st[k] for k in keys})

    def shapes(st, kind):
        return json.dumps([[d["B"], d["band"], d["tmax"], len(d["jobs"])]
                           for d in st["dispatches"] if d["kind"] == kind])

    # 3. main path (layout on), then the same with --no-sort
    rep, launches, wall = drive(gfa, kernels=path_kernels + ("sgd_tick",) + UF_KERNELS)
    rep_ns, launches_ns, wall_ns = drive(gfa_ns, "--no-sort", kernels=path_kernels + UF_KERNELS)
    st = rep["stats"]["aligner"]
    n_align = int(rep["counters"]["alignments"])
    g = rep["graph"]
    lines = gfa.read_text().splitlines()
    print(
        f"main path: {n_align} alignments, align phase {rep['phases_s']['align']:.3f} s "
        f"= {rep['alignments_per_s']:.1f} alignments/s, total {wall:.2f} s; "
        f"graph {g['nodes']} nodes, {g['edges']} edges, {g['paths']} paths; "
        f"launches {launches}"
    )
    print("  phases_s " + json.dumps({k: round(v, 4) for k, v in rep["phases_s"].items()}))
    print(
        "  aligner "
        + json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in st.items() if k != "dispatches"})
    )
    print("  anchored route " + anchored_line(st))
    print(f"  chunk dispatches {shapes(st, 'chunk')} window dispatches {shapes(st, 'window')}"
          " ([B, band, tmax, jobs])")
    st_ns = rep_ns["stats"]["aligner"]
    print(f"main path with --no-sort: total {wall_ns:.2f} s; align phase "
          f"{rep_ns['alignments_per_s']:.1f} alignments/s; launches {launches_ns}; anchored route "
          f"{anchored_line(st_ns)}; phases_s "
          + json.dumps({k: round(v, 4) for k, v in rep_ns["phases_s"].items()}))
    n_pairs = len(named) * (len(named) - 1)
    if n_align != n_pairs or g["paths"] != len(named) or not lines or not lines[0].startswith("H\t"):
        raise AssertionError(f"main path output is not a {len(named)}-path GFA of {n_pairs} alignments")
    if st["dropped"]:
        raise AssertionError(f"{st['dropped']} pairs dropped")
    if rep_ns["graph"] != g or int(rep_ns["counters"]["alignments"]) != n_pairs:
        raise AssertionError("the --no-sort run built another graph")
    if st["anchored_pairs"] <= 0 or not any(d["kind"] == "window" for d in st["dispatches"]):
        raise AssertionError("the default run did not take the anchored route's device windows")

    # 3b. the full wide route on the same corpus
    gfa_full = work / "hla25_full_nosort.gfa"
    rep_full, launches_full, wall_full = drive(gfa_full, "--wide-route", "full", "--no-sort")
    st_full = rep_full["stats"]["aligner"]
    same_bytes = gfa_full.read_bytes() == gfa_ns.read_bytes()
    digests = {tag: hashlib.sha256(f.read_bytes()).hexdigest()
               for tag, f in (("default", gfa_ns), ("full", gfa_full))}
    print(f"--wide-route full --no-sort: total {wall_full:.2f} s; align phase "
          f"{rep_full['phases_s']['align']:.3f} s = {rep_full['alignments_per_s']:.1f} alignments/s; "
          f"launches {launches_full}; chunk dispatches {shapes(st_full, 'chunk')}; graph "
          f"{json.dumps(rep_full['graph'])} (default route {json.dumps(g)}); GFA byte-identical "
          f"to the default --no-sort run: {same_bytes}; --no-sort GFA sha256 {json.dumps(digests)} "
          f"(the JAX package's default {DEFAULT_GFA_SHA256})")
    # the host window DP and the device walk may break an equal-score tie
    # differently (a gap slides inside a repeat), so the two routes' graphs
    # need not be equal; 5a holds every pair's score equal
    if int(rep_full["counters"]["alignments"]) != n_pairs or rep_full["graph"]["paths"] != len(named):
        raise AssertionError("the full-route run did not align every pair into every path")
    if digests["default"] != DEFAULT_GFA_SHA256:
        raise AssertionError("the default run's --no-sort GFA is not the JAX package's")

    # 3c. --wide-verify: the score-only sweep certifies every stitch
    gfa_v = work / "hla25_verify_nosort.gfa"
    rep_v, launches_v, wall_v = drive(gfa_v, "--wide-verify", "--no-sort",
                                      kernels=path_kernels + ("nw_sweep_score_only",))
    st_v = rep_v["stats"]["aligner"]
    print(f"--wide-verify --no-sort: total {wall_v:.2f} s; align phase "
          f"{rep_v['phases_s']['align']:.3f} s; launches {launches_v}; anchored route "
          f"{anchored_line(st_v)}; verify dispatches {shapes(st_v, 'verify')}")
    if not st_v["wide_verified"] == st_v["anchored_pairs"] > 0:
        raise AssertionError("--wide-verify did not certify every stitch")
    if rep_v["graph"] != g:
        raise AssertionError("the --wide-verify run built another graph")

    sorted_g, unsorted_g = parse_gfa(gfa.read_text()), parse_gfa(gfa_ns.read_text())
    if sorted(sorted_g.nodes) != list(range(1, g["nodes"] + 1)):
        raise AssertionError("sorted graph's node ids are not 1..N")
    same, why = isomorphic(sorted_g, unsorted_g)
    if not same:
        raise AssertionError(f"sorted and unsorted graphs are not isomorphic: {why}")
    q, q_ns = layout_quality(sorted_g), layout_quality(unsorted_g)
    plan = sgd_setup(unsorted_g, YgsParams.from_graph(unsorted_g).to_sgd(), "cuda")
    ph = rep["phases_s"]
    print(
        f"layout: {ph['layout']:.3f} s (sgd {ph['layout_sgd']:.3f}, groom "
        f"{ph['layout_groom']:.3f}, final order {ph['layout_final_order']:.3f}); "
        f"SGD {plan.n_ticks} ticks of {plan.u_per_sub} terms over {plan.n_steps} steps; "
        f"sorted rmse {q['rmse']:.3f} mae {q['mae']:.3f} | --no-sort rmse {q_ns['rmse']:.3f} "
        f"mae {q_ns['mae']:.3f} (bp)"
    )
    if not q["rmse"] <= q_ns["rmse"]:
        raise AssertionError("the sorted graph's RMSE is above the unsorted one's")
    sgd_entry = run_sgd(gfa_ns, launches, ph, smi)
    sgd_entry.update(regs_per_thread=ptxas_registers(ptxas, "sgd_ticks_kernel"),
                     spill_stores=ptxas_spills(ptxas, "sgd_ticks_kernel"))

    # 4. small corpora
    small = small_corpus()
    sfa = work / "small.fa"
    write_fasta(sfa, small)

    def small_run(tag: str, *flags: str, fasta: Path = sfa) -> bytes:
        out = work / f"small_{tag}.gfa"
        if cli.main(["-s", str(fasta), "-o", str(out), *flags]) != 0:
            raise RuntimeError(f"small corpus failed with flags {flags}")
        return out.read_bytes()

    cuda_ns = small_run("cuda_ns", "--no-sort")
    if cuda_ns != small_run("cpu_ns", "--no-sort", "--device", "cpu"):
        raise AssertionError("cuda and cpu GFA differ on the small corpus with --no-sort")
    print(f"small corpus --no-sort: cuda GFA == cpu GFA ({len(cuda_ns)} bytes)")
    cuda_a, cuda_b = small_run("cuda_a"), small_run("cuda_b")
    if cuda_a != cuda_b:
        raise AssertionError("two layout runs on cuda gave different GFA files")
    cpu_sorted = small_run("cpu", "--device", "cpu")
    ga, gc = parse_gfa(cuda_a.decode()), parse_gfa(cpu_sorted.decode())
    same, why = isomorphic(ga, gc)
    if not same:
        raise AssertionError(f"cuda and cpu sorted GFA are not isomorphic: {why}")
    print(
        f"small corpus with layout: cuda run 1 == cuda run 2 ({len(cuda_a)} bytes); cuda "
        f"isomorphic to cpu; rmse cuda {layout_quality(ga)['rmse']:.3f} cpu "
        f"{layout_quality(gc)['rmse']:.3f} --no-sort "
        f"{layout_quality(parse_gfa(cuda_ns.decode()))['rmse']:.3f} (bp)"
    )

    # 4b. the sparsified and the iterative schedule on the card (the golden
    # invariant gates each GFA write)
    sprof = work / "small_profile.json"
    for tag, flags in (("tree", ("-x", "tree:2,1,0.2")), ("iterative", ("--iterative",))):
        text = small_run(tag, "--profile", str(sprof), *flags).decode()
        srep = json.loads(sprof.read_text())
        faults = parse_gfa(text).comprehensive_verify(dict(small))
        if faults or srep["graph"]["paths"] != len(small):
            raise AssertionError(f"{tag} run wrote a faulty graph: {faults[:3]}")
        counts = {k: v for k, v in srep["stats"].items() if k.startswith("iterative_")}
        print(
            f"small corpus {' '.join(flags)}: {srep['stats']['aligner']['alignments']} "
            f"alignments of {len(small) * (len(small) - 1)} ordered pairs; graph "
            f"{json.dumps(srep['graph'])} {json.dumps(counts) if counts else ''}"
        )

    # 4c. a family with a >= 2,048 bp inversion carrier: its wide pairs take
    # the anchored route; cuda and cpu must write the same bytes
    ffa = work / "family.fa"
    write_fasta(ffa, synth_family())
    t0 = time.time()
    fam_cuda = small_run("family_cuda", "--no-sort", "--profile", str(sprof), fasta=ffa)
    fam_st = json.loads(sprof.read_text())["stats"]["aligner"]
    t1 = time.time()
    fam_cpu = small_run("family_cpu", "--no-sort", "--device", "cpu", fasta=ffa)
    print(f"family (4 x 2.3 kb, inversion carrier) --no-sort: cuda {t1 - t0:.2f} s, cpu "
          f"{time.time() - t1:.2f} s; anchored route {anchored_line(fam_st)}; cuda GFA == cpu "
          f"GFA: {fam_cuda == fam_cpu} ({len(fam_cuda)} bytes)")
    if fam_st["anchored_pairs"] <= 0:
        raise AssertionError("the family's wide pairs did not take the anchored route")
    if fam_cuda != fam_cpu:
        raise AssertionError("cuda and cpu GFA differ on the family with --no-sort")

    # 5a. the anchored and the full route give every pair the same score;
    # the runner's seconds for each, three runs each in turns
    scores = AlignmentScores.parse(SCORES)
    pairs = all_ordered_pairs(len(named))
    by_route, secs = {}, {"anchored": [], "full": []}
    for route in ("anchored", "full", "full", "anchored", "anchored", "full"):
        aligner = WfaAligner(make_sequence_set(named), RunnerConfig(scores=scores, wide_route=route))
        t0 = time.time()
        res = aligner.align_pairs(pairs)
        torch.cuda.synchronize()
        secs[route].append(round(time.time() - t0, 4))
        by_route.setdefault(route, ({(r.query_idx, r.target_idx): r.score for r in res},
                                    aligner.stats["anchored_pairs"]))
    (anch, anch_n), (full, _) = by_route["anchored"], by_route["full"]
    diff = [k for k in full if anch.get(k) != full[k]]
    print(f"anchored vs full route: {len(anch)} / {len(full)} pairs, {anch_n} anchored, "
          f"{len(diff)} scores differ; runner seconds in turns {json.dumps(secs)}")
    if len(anch) != n_pairs or len(full) != n_pairs or diff:
        raise AssertionError(f"anchored and full-route scores differ at {diff[:5]}")

    # 5b. kernels against their plain versions, on the main path's inputs
    al = WfaAligner(make_sequence_set(named), RunnerConfig(scores=scores, wide_route="full"))
    pen = al._penalties()
    dev = torch.device("cuda")

    def oriented(p, rc):
        qi, tj = pairs[p]
        return (al.rc_codes[qi] if rc else al.codes[qi]), al.codes[tj]

    def with_padding_row(arrays, n_jobs):
        """The first n_jobs rows and one zero-length padding row, at the
        dispatch's own Lq, Lt."""
        Q, T, ql, tl = arrays
        Q = np.concatenate([Q[:n_jobs], np.full((1, Q.shape[1]), nw.QPAD, np.uint8)])
        T = np.concatenate([T[:n_jobs], np.full((1, T.shape[1]), nw.TPAD, np.uint8)])
        return Q, T, np.append(ql[:n_jobs], 0).astype(np.int32), np.append(tl[:n_jobs], 0).astype(np.int32)

    def inputs(d, n_jobs=None):
        """Kernel inputs of a recorded dispatch (all of it, or its first
        n_jobs jobs plus a zero-length padding row) and its band and tmax."""
        if d["kind"] == "window":
            jobs = []
            for p, rc, q0, t0, nq, nt in d["jobs"]:
                q, t = oriented(p, rc)
                jobs.append((q[q0 : q0 + nq], t[t0 : t0 + nt], (p, rc, q0, t0)))
            Q, T, ql, tl, band, tmax = anchored.pack_windows(
                jobs, [(j, d["band"]) for j in range(len(jobs))], d["band"])
            arrays = (Q, T, ql, tl)
            if n_jobs:
                arrays = with_padding_row(arrays, n_jobs)
        elif d["kind"] == "verify":
            entries = [(*oriented(p, rc), d["band"], (p, rc)) for p, rc in d["jobs"]]
            Q, T, ql, tl, band, tmax = anchored.pack_verify(entries, np.arange(len(entries)))
            arrays = (Q, T, ql, tl)
        else:
            jobs = d["jobs"][:n_jobs] if n_jobs else d["jobs"]
            Q, T, ql, tl, _tmax = al.pack_chunk([(p, bool(rc), d["band"], *oriented(p, rc))
                                                 for p, rc in jobs])
            arrays = (Q, T, ql, tl)
        if d["kind"] != "chunk" and (band, tmax) != (d["band"], d["tmax"]):
            raise AssertionError(f"a rebuilt {d['kind']} dispatch has another shape")
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    def tb_bytes(d):
        return d["B"] * ((d["tmax"] + 1 + 127) // 128 * 128) * (d["band"] + 1)

    chunks = [d for d in st["dispatches"] if d["kind"] == "chunk"]
    main_d = max(chunks, key=tb_bytes)
    wide_d = max((d for d in st_full["dispatches"] if d["kind"] == "chunk"),
                 key=lambda d: (d["band"], tb_bytes(d)))
    win_d = next(d for d in st["dispatches"] if d["kind"] == "window")
    ver_d = next(d for d in st_v["dispatches"] if d["kind"] == "verify")
    two = pen["o2"] >= 0
    parity = []
    kernels = {}
    score_only = {}

    bounds = sweep_bounds

    for label, d, n_jobs in (("largest", main_d, None), ("widest", wide_d, 7), ("window", win_d, 7)):
        band, tmax = d["band"], d["tmax"]
        Q, T, ql, tl = inputs(d, n_jobs)
        if n_jobs and int((ql == 0).sum()) == 0:
            raise AssertionError("parity batch has no padding row")
        kw = dict(band=band, tmax=tmax, **pen)
        s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
        plain_sweep_ms, (s_p, tb_p) = once_ms(lambda: nw_cuda.nw_align_reference(Q, T, ql, tl, **kw))
        err_a = max(max_abs_err(s_k, s_p), max_abs_err(tb_k, tb_p))
        ops_k = nw_cuda.nw_walk(tb_k, ql, tl, band=band, tmax=tmax)
        plain_walk_ms, ops_p = once_ms(lambda: nw_cuda.nw_walk_reference(tb_k, ql, tl, band=band, tmax=tmax))
        err_b = max_abs_err(ops_k, ops_p)
        B, W = Q.shape[0], band + 1
        parity.append({"dispatch": label, "B": B, "W": W, "tmax": tmax,
                       "sweep_err": err_a, "walk_err": err_b})
        print(f"parity {label}: B={B} W={W} tmax={tmax} Lq={Q.shape[1]} Lt={T.shape[1]} "
              f"sweep max_abs_err={err_a} walk max_abs_err={err_b}")
        if err_a or err_b:
            raise AssertionError(f"kernel disagrees with its plain version ({label})")
        del tb_p, ops_p, ops_k
        if label == "largest":
            # the score-only mode on the same inputs: the full sweep's scores,
            # which are the plain version's
            s_o, none = nw_cuda.nw_align(Q, T, ql, tl, with_traceback=False, **kw)
            err_o = max(max_abs_err(s_o, s_k), max_abs_err(s_o, s_p))
            if none is not None or err_o:
                raise AssertionError("the score-only sweep disagrees on the largest dispatch")
            only_ms = cuda_ms(lambda: nw_cuda.nw_align(Q, T, ql, tl, with_traceback=False, **kw), REPS)
            score_only["largest"] = {"shape": {"B": B, "W": W, "tmax": tmax}, "ms": only_ms,
                                     "bound_ms": max(bounds(Q, T, ql, tl, W, 0)), "max_abs_err": err_o}
        del s_p
        if n_jobs:
            # time the kernels on the dispatch in full
            Q, T, ql, tl = inputs(d)
            B = Q.shape[0]
            s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
        plan = nw_cuda.plan_sweep(B, W, Q.shape[1], T.shape[1])
        occ = nw_cuda.sweep_occupancy(plan, W, two)
        sweep_ms = cuda_ms(lambda: nw_cuda.nw_align(Q, T, ql, tl, **kw), REPS)
        # each warps-per-pair shape, timed and held to the kernel's output
        # (itself held to the plain version above)
        if label == "largest":
            wpp_choices = (1, 2, 4)
        elif label == "widest":
            wpp_choices = sorted({-(-W // (32 * s)) for s in nw_cuda.SWEEP_LANES
                                  if -(-W // (32 * s)) * 32 <= nw_cuda._MAX_THREADS[s]})
        else:
            wpp_choices = ()
        by_wpp = {}
        for w in wpp_choices:
            try:
                alt = nw_cuda.plan_sweep(B, W, Q.shape[1], T.shape[1], warps_per_pair=w)
            except ValueError:
                continue
            s_w, tb_w = nw_cuda.sweep_launch(Q, T, ql, tl, alt, **kw)
            if max(max_abs_err(s_w, s_k), max_abs_err(tb_w, tb_k)):
                raise AssertionError(f"sweep at {w} warps per pair disagrees ({label})")
            del s_w, tb_w
            by_wpp[w] = cuda_ms(lambda: nw_cuda.sweep_launch(Q, T, ql, tl, alt, **kw), REPS)
        tb = tb_k
        walk_ms = cuda_ms(lambda: nw_cuda.nw_walk(tb, ql, tl, band=band, tmax=tmax), REPS)
        ops = nw_cuda.nw_walk(tb, ql, tl, band=band, tmax=tmax)
        steps = int((ops != 0).sum().item())
        kernels[label] = {
            "shape": {"B": B, "W": W, "tmax": tmax},
            "sweep": (sweep_ms, *bounds(Q, T, ql, tl, W, tb.numel())),
            "walk": (walk_ms, *walk_bounds(ops)),
            "sweep_occ": occ,
            "walk_occ": nw_cuda.walk_occupancy(),
            "wpp_ms": by_wpp,
        }
        if label == "largest":
            # the parity run above was the plain versions at this full shape
            kernels[label]["plain"] = (plain_sweep_ms, plain_walk_ms)
        print(f"timing {label}: B={B} W={W} tmax={tmax} sweep {sweep_ms:.3f} ms "
              f"(by warps per pair {json.dumps(by_wpp)}) walk {walk_ms:.3f} ms "
              f"(walk steps {steps}); {plan}")
        print(f"  occupancy sweep {json.dumps(kernels[label]['sweep_occ'])} "
              f"walk {json.dumps(kernels[label]['walk_occ'])}")
        del tb, tb_k, s_k, ops, Q, T, ql, tl
        torch.cuda.empty_cache()

    # the score-only sweep on the first verify dispatch of 3c, in full
    Q, T, ql, tl = inputs(ver_d)
    B, W, tmax = Q.shape[0], ver_d["band"] + 1, ver_d["tmax"]
    kw = dict(band=ver_d["band"], tmax=tmax, **pen)
    s_o, _ = nw_cuda.nw_align(Q, T, ql, tl, with_traceback=False, **kw)
    s_k, _tb = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    del _tb
    plain_only_ms, (s_p, _) = once_ms(
        lambda: nw_cuda.nw_align_reference(Q, T, ql, tl, with_traceback=False, **kw))
    err_o = max(max_abs_err(s_o, s_k), max_abs_err(s_o, s_p))
    print(f"parity verify (score-only): B={B} W={W} tmax={tmax} max_abs_err={err_o}; "
          f"largest {score_only['largest']['max_abs_err']}")
    if err_o:
        raise AssertionError("the score-only sweep disagrees on the verify dispatch")
    only_ms = cuda_ms(lambda: nw_cuda.nw_align(Q, T, ql, tl, with_traceback=False, **kw), REPS)
    full_ms = cuda_ms(lambda: nw_cuda.nw_align(Q, T, ql, tl, **kw), REPS)
    b_ms, o_ms = bounds(Q, T, ql, tl, W, 0)
    only_occ = nw_cuda.sweep_occupancy(nw_cuda.plan_sweep(B, W, Q.shape[1], T.shape[1]), W, two,
                                       with_traceback=False)
    print(f"timing verify: B={B} W={W} tmax={tmax} score-only {only_ms:.3f} ms, with traceback "
          f"{full_ms:.3f} ms; largest score-only {score_only['largest']['ms']:.3f} ms; bound "
          f"{max(b_ms, o_ms):.4f} ms; occupancy {json.dumps(only_occ)}")
    score_only["verify"] = {"shape": {"B": B, "W": W, "tmax": tmax}, "ms": only_ms,
                            "full_mode_ms": full_ms, "bound": (b_ms, o_ms), "plain_ms": plain_only_ms,
                            "max_abs_err": err_o, "occ": only_occ}
    del Q, T, ql, tl, s_o, s_k, s_p

    long_out = run_long(work, smi, drive, shapes, ptxas)
    sites = run_backends(work, smi, drive, shapes)
    parity.extend(sites["parity"])
    phase8 = run_phase8(smi, ptxas, {
        "named": named, "pairs": pairs, "scores": scores, "pen": pen, "launches": launches,
        "runs_sites": [("largest", inputs(main_d), main_d["band"], main_d["tmax"], nw.RUN_MAX),
                       ("window", inputs(win_d), win_d["band"], win_d["tmax"], anchored.WIN_RUN_MAX),
                       ("gap", sites["gap_inputs"][:4], *sites["gap_inputs"][4:], None),
                       ("corpus", *gap_corpus_site(dev), nw.RUN_MAX)],
        "run_overflows": {"default": st["run_overflows"], **sites["run_overflows"]},
    })

    big = kernels["largest"]
    out = []
    launches_of = {
        "nw_sweep": (launches["nw_sweep"], "default run"),
        # the default run's chunks take the runs walk; the opcode walk's
        # launches are the inversion-aware run's (its inversion batch)
        "nw_walk": (sites["inversion"]["walk"]["launches"], "--inversion-aware --no-sort"),
    }
    for kname, key, src, replaces, idx in (
        ("nw_sweep", "sweep", "seqrush_tpu_torch/ops/csrc/nw_sweep.cu", "seqrush_tpu/ops/nw_pallas.py:38", 0),
        ("nw_walk", "walk", "seqrush_tpu_torch/ops/csrc/nw_walk.cu", "seqrush_tpu/ops/nw_pallas.py:194", 1),
    ):
        ms, b_ms, o_ms = big[key]
        out.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches_of[kname][0], "launches_path": launches_of[kname][1],
            "max_abs_err": max(p[f"{key}_err"] for p in parity),
            "ms": ms, "plain_ms": big["plain"][idx],
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None,
            **big[f"{key}_occ"],
            "shape": big["shape"],
            "warps_per_pair_ms": big["wpp_ms"] if key == "sweep" else None,
            **{other: {"shape": kernels[other]["shape"], "ms": kernels[other][key][0],
                       "bound_ms": max(kernels[other][key][1:]), **kernels[other][f"{key}_occ"],
                       "warps_per_pair_ms": kernels[other]["wpp_ms"] if key == "sweep" else None}
               for other in ("widest", "window")},
            # this slice's launch sites: the sweepga gap chunk and the
            # inversion-aware window batch, each with its own path's launches
            **{site: sites[site][key] for site in ("gap", "inversion")},
            "parity": parity, "tolerance": 0,
        })
    v = score_only["verify"]
    out.append({
        "name": "nw_sweep_score_only", "route": "cuda",
        "source": "seqrush_tpu_torch/ops/csrc/nw_sweep.cu", "replaces": "seqrush_tpu/ops/nw_pallas.py:38",
        "launches": launches_v["nw_sweep_score_only"],
        "max_abs_err": max(v["max_abs_err"], score_only["largest"]["max_abs_err"]),
        "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": max(v["bound"]),
        "bound_by": "bytes" if v["bound"][0] >= v["bound"][1] else "operations",
        "library_ms": None, **v["occ"], "shape": v["shape"], "full_mode_ms": v["full_mode_ms"],
        "largest": score_only["largest"], "probe": sites["probe"], "tolerance": 0,
        "launches_path": "--wide-verify",
    })
    out.append(sgd_entry)
    out.extend(long_out)
    out.extend(phase8)
    ctx9 = {"named": named, "pairs": pairs, "scores": scores, "pen": pen}
    out.extend(run_phase9(smi, ptxas, ctx9))
    out.extend(run_phase10(smi, ptxas, ctx9))
    out.extend(run_phase11(work, smi, ptxas, ctx9))
    out.extend(run_phase11e(smi, ptxas, ctx9))
    ctx9["wfa_kernel_ms"] = sum(b["ms"] for e in phase8 if e["name"] == "wfa" for b in e["batches"])
    ctx9["launches"] = launches
    ctx9["ptxas"] = ptxas
    out.extend(run_phase12(work, smi, drive, ctx9))
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0

# kernel launches of the SGD a block of ticks (besides draw_block's draws)
SGD_LAUNCHES_PER_BLOCK = 1


def run_sgd(gfa_ns: Path, launches: dict, ph: dict, smi: str) -> dict:
    """3d. The SGD tick kernel (ops/csrc/sgd_tick.cu) on the headline's
    unsorted graph (the --no-sort GFA), on synth_variation_graph()'s 1,000
    paths and on the same with a node that every path visits 20 times in a
    row, each through tools/sgd_timing.py in a process of its own (profiler
    sessions after its own have recorded no device activity in the process
    that ran them, and phase 9 reads the profiler).

    On each: the kernel's ticks on the card against the plain tick on the
    CPU fed the same draws (tools/sgd_timing.py::cpu_parity), bit for bit
    after every tick (one launch a tick) and at the end of every block of
    draws (one launch the block) of the headline's whole run, where the
    layout's own run must end at the same positions, and of the first block
    of the other two; the kernel's whole run and the plain ticks' on the
    card in turns (time_sgd: plain, kernel, kernel, plain; both kernel runs
    bit-equal to the first), the launches, device time by kernel and
    device-busy share of the run's first block (SGD_LAUNCHES_PER_BLOCK
    launches of the tick kernel) and of 16 plain ticks from torch.profiler,
    and the kernel's device time a tick by phase from its own timer.
    Returns the kernels line's entry of the tick."""
    t_phase = time.time()
    got = {}
    for tag, args in (("headline", [str(gfa_ns), "--parity", "0"]),
                      ("paths_1000", ["--synthetic", "1000", "--parity", "1"]),
                      ("looped", ["--synthetic", "1000", "--loop", "20", "--parity", "1"])):
        proc = subprocess.run([sys.executable, "-m", "seqrush_tpu_torch.tools.sgd_timing", *args, "--profile"],
                              capture_output=True, text=True, timeout=300, cwd=Path(__file__).resolve().parent)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            raise AssertionError(f"tools/sgd_timing.py failed on the {tag} graph")
        tim = json.loads(proc.stdout.strip().splitlines()[-1])
        par = tim.pop("cpu_parity")
        kp, pp = tim["kernel_profile"], tim["plain_profile"]
        print(f"sgd tick kernel, {tag} graph ({tim['nodes']} nodes, {tim['paths']} paths, {tim['steps']} steps; "
              f"{tim['ticks']} ticks of {tim['tick_width']} terms, {tim['block_ticks']} a block): against the "
              f"plain tick on the CPU {json.dumps(par)}; run {tim['kernel_s']:.4f} s = "
              f"{tim['kernel_ms_per_tick']:.4f} ms a tick (runs {json.dumps(tim['kernel_runs_s'])}, first of the "
              f"process {tim['first_run_s']:.4f}); first block: {kp['tick_kernel_launches']} kernel launches and "
              f"{kp['other_launches']} others, device busy {kp['device_busy_share_of_run']:.4f} of the run "
              f"({kp['device_busy_share']:.4f} of the profiled block) ({kp['device_ms_per_tick']:.4f} ms a tick "
              f"on the device: {json.dumps(kp['device_ms_per_tick_by_kernel'])}); by phase "
              f"{json.dumps(tim['phase_ms_per_tick'])}; plain ticks on the card {tim['plain_s']:.4f} s = "
              f"{tim['plain_ms_per_tick']:.4f} ms a tick (runs {json.dumps(tim['plain_runs_s'])}), "
              f"{pp['launches_per_tick']} launches a tick, busy {pp['device_busy_share_of_run']:.4f} "
              f"({pp['device_busy_share']:.4f}); bound {tim['bound_ms_per_tick']:.6f} ms a tick "
              f"({tim['tick_bytes']} B, bytes); kernel runs bit-equal {tim['kernel_runs_bit_equal']} | {smi}")
        if not par["bit_equal"]:
            raise AssertionError(f"the SGD tick kernel differs from the plain tick on the CPU ({tag})")
        if not (tim["kernel_runs_bit_equal"] and tim["finite"]):
            raise AssertionError(f"two SGD runs with one seed gave different positions ({tag})")
        n_blocks = -(-tim["ticks"] // tim["block_ticks"])
        if kp["tick_kernel_launches"] != SGD_LAUNCHES_PER_BLOCK or par.get("layout_run_launches", n_blocks) != (
                SGD_LAUNCHES_PER_BLOCK * n_blocks):
            raise AssertionError(f"the SGD takes other than {SGD_LAUNCHES_PER_BLOCK} launch a block of ticks ({tag})")
        got[tag] = (par, tim)

    def numbers(par, tim):
        kp, pp = tim["kernel_profile"], tim["plain_profile"]
        return {"shape": {k: tim[k] for k in ("nodes", "paths", "steps", "ticks", "tick_width", "block_ticks")},
                "run_s": tim["kernel_s"], "plain_run_s": tim["plain_s"], "ms_per_tick": tim["kernel_ms_per_tick"],
                "plain_ms_per_tick": tim["plain_ms_per_tick"], "bound_ms_per_tick": tim["bound_ms_per_tick"],
                "launches_per_block": kp["tick_kernel_launches"], "draw_launches_per_block": kp["other_launches"],
                "plain_launches_per_tick": pp["launches_per_tick"],
                "device_busy_share": kp["device_busy_share_of_run"],
                "plain_device_busy_share": pp["device_busy_share_of_run"],
                "device_busy_share_profiled": kp["device_busy_share"],
                "plain_device_busy_share_profiled": pp["device_busy_share"],
                "plain_device_ms_per_tick": pp["device_ms_per_tick"],
                "device_ms_per_tick": kp["device_ms_per_tick"], "phase_ms_per_tick": tim["phase_ms_per_tick"],
                "ticks_held_to_cpu": par["ticks_compared"], "max_abs_err": par["max_abs_err"]}

    head = numbers(*got["headline"])
    print(f"3d wall {time.time() - t_phase:.1f} s")
    return {
        "name": "sgd_tick", "route": "cuda", "source": "seqrush_tpu_torch/ops/csrc/sgd_tick.cu",
        "replaces": "seqrush_tpu/layout/sgd.py:187", "launches": launches["sgd_tick"],
        "launches_path": "default run (layout), one a block of ticks",
        "max_abs_err": max(p["max_abs_err"] for p, _t in got.values()),
        "ms": head["ms_per_tick"], "plain_ms": head["plain_ms_per_tick"], "bound_ms": head["bound_ms_per_tick"],
        "bound_by": "bytes", "library_ms": None, **head, "layout_sgd_s": ph["layout_sgd"],
        "paths_1000": numbers(*got["paths_1000"]), "looped": numbers(*got["looped"]), "tolerance": 0,
    }


LONG_KERNELS = ("nw_sweep_segment_score_only", "nw_sweep_segment_group", "nw_walk_segment_group")


def gap_corpus_site(dev) -> tuple:
    """The walk gap corpus (tools/headline.py::walk_gap_corpus) on the card:
    ((Q, T, qlens, tlens), band, tmax)."""
    from seqrush_tpu_torch.tools.headline import walk_gap_corpus

    Q, T, ql, tl, band, tmax = walk_gap_corpus()
    return tuple(torch.from_numpy(a).to(dev) for a in (Q, T, ql, tl)), band, tmax


def ptxas_spills(ptxas: list[str], kernel: str) -> int | None:
    """Spill-store bytes of one kernel from ptxas_summary's lines (None when
    there is no log)."""
    for line in ptxas:
        m = re.match(r"(.*?): \d+ registers.*?(\d+) bytes spill stores", line)
        if m and m.group(1) == kernel:
            return int(m.group(2))
    return None


def ptxas_registers(ptxas: list[str], kernel: str) -> int | None:
    """Registers of one kernel from ptxas_summary's lines (None when the
    library was built before this process, so there is no log)."""
    for line in ptxas:
        m = re.match(r"(.*?): (\d+) registers", line)
        if m and m.group(1) == kernel:
            return int(m.group(2))
    return None


def run_long(work: Path, smi: str, drive, shapes, ptxas: list[str]) -> list[dict]:
    """6. Long pairs (qlen + tlen > 65,536) through the segmented route.

    6a. the 110 kb pair through ``--no-sort``: long_pairs >= 1 and the JAX
        package's GFA (its sha256);
    6b. the 8 x 60 kb locus through the default run (layout on) and with
        ``--no-sort``: all 56 ordered pairs aligned on the long route, none
        anchored; the sorted graph's checks of phase 3; the layout SGD's
        plan on the locus (H staged or read through L1, digit passes);
    6c. on the largest long chunk: each segment kernel against its plain
        version on the first, a middle and the last segment (exact); the
        forward pass in one launch against the chained launches; at the main
        path's shapes the middle forward run of LONG_RUN segments, the
        grouped recompute of the first, a middle and the last group (into
        the chunk's whole traceback at the group's rows, the rows outside
        untouched) and the group walk over every segment against their plain
        versions, and every segment's rows of the grouped traceback against
        the per-segment launch's; the route at G = n_seg (the runner's
        budget) and at G = 1 (its launches counted alone) against
        single-shot kernels A + B; CUDA-event times of each launch shape, of
        the route per chunk by G with the overlap on and off, of single-shot
        A + B, and of the locus's long chunks in series and at once (their
        scores and opcodes equal), with the peak memory at once and whether
        either chunk retries the other's jobs.
    Returns the kernels line's entries of the five segment launch kinds."""
    from seqrush_tpu_torch.align.pairs import all_ordered_pairs
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
    from seqrush_tpu_torch.graph.bigraph import parse_gfa
    from seqrush_tpu_torch.layout import sgd
    from seqrush_tpu_torch.layout.ygs import YgsParams
    from seqrush_tpu_torch.ops import nw_cuda
    from seqrush_tpu_torch.scores import AlignmentScores
    from seqrush_tpu_torch.sequences import make_sequence_set
    from seqrush_tpu_torch.tools.isomorphic import isomorphic
    from seqrush_tpu_torch.tools.measure_layout_quality import layout_quality

    def long_line(st):
        return json.dumps({k: st[k] for k in ("long_pairs", "anchored_pairs", "dropped",
                                              "band_escalations")})

    def long_shapes(st):
        return json.dumps([[d["B"], d["band"], d["tmax"], d["n_seg"], len(d["jobs"])]
                           for d in st["dispatches"] if d["kind"] == "long"])

    # 6a. the 110 kb pair
    pfa, pgfa = work / "long.fa", work / "long.gfa"
    write_fasta(pfa, long_pair())
    rep_p, launches_p, wall_p = drive(pgfa, "--no-sort", kernels=LONG_KERNELS, fasta=pfa)
    st_p = rep_p["stats"]["aligner"]
    digest = hashlib.sha256(pgfa.read_bytes()).hexdigest()
    print(f"long pair (2 x 55 kb) --no-sort: total {wall_p:.2f} s, align phase "
          f"{rep_p['phases_s']['align']:.3f} s; {long_line(st_p)}; long dispatches "
          f"{long_shapes(st_p)} ([B, band, tmax, n_seg, jobs]); launches {launches_p}; graph "
          f"{json.dumps(rep_p['graph'])}; GFA sha256 {digest} (JAX package's "
          f"{LONG_PAIR_GFA_SHA256}) | {smi}")
    if st_p["long_pairs"] < 1 or rep_p["graph"]["paths"] != 2:
        raise AssertionError("the 110 kb pair did not take the long route into a 2-path graph")
    if digest != LONG_PAIR_GFA_SHA256:
        raise AssertionError("the 110 kb pair's --no-sort GFA is not the JAX package's")

    # 6b. the 8 x 60 kb locus, default run and --no-sort
    dev = torch.device("cuda")
    named = synth_locus()
    n_pairs = len(named) * (len(named) - 1)
    lfa, lgfa, lgfa_ns = work / "locus.fa", work / "locus.gfa", work / "locus_nosort.gfa"
    write_fasta(lfa, named)
    rep, launches, wall = drive(lgfa, kernels=LONG_KERNELS, fasta=lfa)
    rep_ns, launches_ns, wall_ns = drive(lgfa_ns, "--no-sort", kernels=LONG_KERNELS, fasta=lfa)
    st, g = rep["stats"]["aligner"], rep["graph"]
    print(f"locus ({len(named)} x {len(named[0][1])} bp) default run: total {wall:.2f} s; align "
          f"phase {rep['phases_s']['align']:.3f} s = {rep['alignments_per_s']:.2f} alignments/s; "
          f"{long_line(st)}; long dispatches {long_shapes(st)}; other dispatches "
          f"{shapes(st, 'chunk')}; launches {launches}; graph {json.dumps(g)} | {smi}")
    print("  phases_s " + json.dumps({k: round(v, 4) for k, v in rep["phases_s"].items()}))
    print(f"locus --no-sort: total {wall_ns:.2f} s; align phase {rep_ns['phases_s']['align']:.3f} s "
          f"= {rep_ns['alignments_per_s']:.2f} alignments/s; launches {launches_ns}; phases_s "
          + json.dumps({k: round(v, 4) for k, v in rep_ns["phases_s"].items()}))
    for r in (rep, rep_ns):
        sr = r["stats"]["aligner"]
        if int(r["counters"]["alignments"]) != n_pairs or sr["dropped"]:
            raise AssertionError("the locus run did not align every pair")
        if sr["long_pairs"] < n_pairs or sr["anchored_pairs"] != 0:
            raise AssertionError("the locus's pairs did not all take the long route")
        if r["graph"]["paths"] != len(named):
            raise AssertionError("the locus graph lacks a path")
    if rep_ns["graph"] != g:
        raise AssertionError("the locus's --no-sort run built another graph")
    digest_ns = hashlib.sha256(lgfa_ns.read_bytes()).hexdigest()
    print(f"  locus --no-sort GFA sha256 {digest_ns} (JAX package's {LOCUS_GFA_SHA256})")
    if digest_ns != LOCUS_GFA_SHA256:
        raise AssertionError("the locus's --no-sort GFA is not the JAX package's")
    sorted_g, unsorted_g = parse_gfa(lgfa.read_text()), parse_gfa(lgfa_ns.read_text())
    if sorted(sorted_g.nodes) != list(range(1, g["nodes"] + 1)):
        raise AssertionError("the locus's sorted graph's node ids are not 1..N")
    same, why = isomorphic(sorted_g, unsorted_g)
    if not same:
        raise AssertionError(f"the locus's sorted and unsorted graphs are not isomorphic: {why}")
    # the layout's SGD plan on the locus: H (space + 1 floats) outgrows its
    # share of shared memory, so the Zipf search reads it through L1
    lplan = sgd.sgd_setup(unsorted_g, YgsParams.from_graph(unsorted_g).to_sgd(), dev)
    lwork = sgd.tick_work(lplan.x0.shape[0], lplan.u_per_sub, lplan.tables.space, dev, lplan.block_ticks)
    print(f"  locus SGD: {lplan.n_ticks} ticks of {lplan.u_per_sub} terms, {lplan.block_ticks} a block, space "
          f"{lplan.tables.space}; layout_sgd {rep['phases_s']['layout_sgd']:.4f} s; plan "
          f"{json.dumps(lwork.plan._asdict())}")
    q, q_ns = layout_quality(sorted_g), layout_quality(unsorted_g)
    print(f"  locus layout rmse {q['rmse']:.3f} mae {q['mae']:.3f} | --no-sort rmse "
          f"{q_ns['rmse']:.3f} (bp)")
    if not q["rmse"] <= q_ns["rmse"]:
        raise AssertionError("the locus's sorted graph's RMSE is above the unsorted one's")

    # 6c. the segment kernels on the largest long chunk
    al = WfaAligner(make_sequence_set(named), RunnerConfig(scores=AlignmentScores.parse(SCORES)),
                    device=dev)
    pen = al._penalties()
    pairs = all_ordered_pairs(len(named))

    def long_inputs(d):
        """Kernel inputs of a recorded long dispatch: (Q, T, qlens, tlens, tmax)."""
        chunk = []
        for p, rc in d["jobs"]:
            qi, tj = pairs[p]
            chunk.append((p, bool(rc), d["band"], al.rc_codes[qi] if rc else al.codes[qi],
                          al.codes[tj]))
        *arrays, tmax = al.pack_chunk(chunk)
        return (*(torch.from_numpy(a).to(dev) for a in arrays), tmax)

    longs = [d for d in st["dispatches"] if d["kind"] == "long"]
    # the route's time on every long chunk of the run: its device time
    chunk_ms = []
    for dd in longs:
        Qc, Tc, qc, tc, _ = long_inputs(dd)
        chunk_ms.append(cuda_ms(lambda: nw_cuda.nw_align_long(
            Qc, Tc, qc, tc, band=dd["band"], seg=dd["seg"], t_need=int((qc + tc).max()), **pen),
            REPS))
    print(f"long route per chunk {json.dumps(chunk_ms)} ms ([B, band] "
          f"{json.dumps([[dd['B'], dd['band']] for dd in longs])}), {sum(chunk_ms) / 1e3:.4f} s of the "
          f"{rep['phases_s']['align']:.4f} s align phase | {smi}")
    d = max(longs, key=lambda d: d["B"] * d["band"])
    Q, T, ql, tl, tmax = long_inputs(d)
    band, seg, n_seg = d["band"], d["seg"], d["n_seg"]
    B, W = Q.shape[0], band + 1
    t_need = int((ql + tl).max())
    two = pen["o2"] >= 0
    kw = dict(band=band, seg=seg, **pen)
    if (B, tmax) != (d["B"], d["tmax"]) or n_seg != -(-t_need // seg):
        raise AssertionError("the rebuilt long chunk has another shape")

    # the main path's launch shapes at G = n_seg: forward runs and recompute
    # groups of LONG_RUN segments from 0, LONG_RUN, ..., the last one shorter,
    # each group into the chunk's traceback [B, n_seg * seg, W] from its rows on
    runs = [(a, min(nw_cuda.LONG_RUN, n_seg - a)) for a in range(0, n_seg, nw_cuda.LONG_RUN)]
    g_picks = sorted({runs[0], runs[len(runs) // 2], runs[-1]})
    mid_g, R = runs[len(runs) // 2]

    # the forward pass as chained single-segment launches, keeping every
    # checkpoint
    carries = [nw_cuda.initial_carry(B, W, dev)]
    scores = [torch.full((B,), -1, dtype=torch.int32, device=dev)]
    for s in range(n_seg):
        c, sc, _ = nw_cuda.nw_align_segment(Q, T, ql, tl, carries[s], scores[s], t0=s * seg,
                                            with_traceback=False, **kw)
        carries.append(c)
        scores.append(sc)
    picks = sorted({0, n_seg // 2, n_seg - 1})
    mid = n_seg // 2
    err = {"sweep": 0, "score_only": 0, "walk": 0, "group": 0, "group_walk": 0, "run": 0}
    plain = {}
    for s in picks:
        c_k, s_k, tb_k = nw_cuda.nw_align_segment(Q, T, ql, tl, carries[s], scores[s], t0=s * seg, **kw)
        ms_p, (c_p, s_p, tb_p) = once_ms(lambda: nw_cuda.nw_align_segment_reference(
            Q, T, ql, tl, carries[s], scores[s], t0=s * seg, **kw))
        ms_o, (c_o, s_o, _) = once_ms(lambda: nw_cuda.nw_align_segment_reference(
            Q, T, ql, tl, carries[s], scores[s], t0=s * seg, with_traceback=False, **kw))
        err["sweep"] = max(err["sweep"], max_abs_err(c_k, c_p), max_abs_err(s_k, s_p),
                           max_abs_err(tb_k, tb_p))
        err["score_only"] = max(err["score_only"], max_abs_err(carries[s + 1], c_o),
                                max_abs_err(scores[s + 1], s_o), max_abs_err(c_o, c_p))
        if s == mid:
            plain["sweep"], plain["score_only"] = ms_p, ms_o
        del c_k, s_k, tb_k, c_p, s_p, tb_p, c_o, s_o

    # the forward pass in one launch: every checkpoint and the scores of the
    # chained launches; the middle forward run of the main path against its
    # plain version
    ckpt = torch.stack(carries[:n_seg])
    run_ckpt = torch.empty_like(ckpt)
    run_ckpt[0] = carries[0]
    s_run = nw_cuda.nw_align_segment_run(Q, T, ql, tl, run_ckpt, scores[0], s0=0, n_run=n_seg,
                                         **kw)
    err["run"] = max(max_abs_err(run_ckpt, ckpt), max_abs_err(s_run, scores[-1]))
    ck_k, ck_p = run_ckpt.clone(), run_ckpt.clone()
    s_k = nw_cuda.nw_align_segment_run(Q, T, ql, tl, ck_k, scores[mid_g], s0=mid_g, n_run=R, **kw)
    plain["run"], s_p = once_ms(lambda: nw_cuda.nw_align_segment_run_reference(
        Q, T, ql, tl, ck_p, scores[mid_g], s0=mid_g, n_run=R, **kw))
    err["run"] = max(err["run"], max_abs_err(ck_k, ck_p), max_abs_err(s_k, s_p),
                     max_abs_err(ck_k, ckpt))
    del ck_k, ck_p, s_k, s_p

    # the grouped recompute on the main path's first, a middle and its last
    # group, each into the whole traceback at its rows (filled with 0xA5
    # before: the rows outside the group stay so) against its plain version
    tb_all = torch.empty((B, n_seg * seg, W), dtype=torch.uint8, device=dev)
    for s0, g in g_picks:
        rows = slice(s0 * seg, (s0 + g) * seg)
        tb_all.fill_(0xA5)
        s_g, _ = nw_cuda.nw_align_segment_group(Q, T, ql, tl, ckpt, s0=s0, G=g, tb=tb_all,
                                                row0=rows.start, **kw)
        tb_gp = torch.empty((B, g * seg, W), dtype=torch.uint8, device=dev)
        ms_g, s_gp = once_ms(lambda: nw_cuda.nw_align_segment_group_reference(
            Q, T, ql, tl, ckpt, s0=s0, G=g, tb=tb_gp, **kw))
        outside = int(tb_all[:, : rows.start].ne(0xA5).any().item()
                      or tb_all[:, rows.stop :].ne(0xA5).any().item())
        err["group"] = max(err["group"], max_abs_err(s_g, s_gp), max_abs_err(tb_all[:, rows], tb_gp),
                           outside)
        if s0 == mid_g:
            plain["group"] = ms_g
        del s_g, tb_gp, s_gp
    # the whole traceback as the main path writes it, group after group
    for s0, g in runs:
        nw_cuda.nw_align_segment_group(Q, T, ql, tl, ckpt, s0=s0, G=g, tb=tb_all, row0=s0 * seg,
                                       **kw)

    # the reverse pass a segment a launch: every segment's traceback against
    # the grouped one's rows, each picked segment's walk against the plain
    # version
    state = nw_cuda.walk_state(ql, tl, band=band)
    ops = torch.zeros((B, n_seg * seg + 1), dtype=torch.uint8, device=dev)
    mid_walk = None
    for s in reversed(range(n_seg)):
        _, _, tb_s = nw_cuda.nw_align_segment(Q, T, ql, tl, carries[s], scores[s], t0=s * seg, **kw)
        err["group"] = max(err["group"], max_abs_err(tb_s, tb_all[:, s * seg : (s + 1) * seg]))
        st_in = state
        if s in picks:
            ops_p = ops.clone()
            ms_w, st_p = once_ms(lambda: nw_cuda.nw_walk_segment_reference(
                tb_s, st_in, ops_p, t0=s * seg, seg=seg, band=band))
            state = nw_cuda.nw_walk_segment(tb_s, st_in, ops, t0=s * seg, seg=seg, band=band)
            err["walk"] = max(err["walk"], max_abs_err(state, st_p), max_abs_err(ops, ops_p))
            if s == mid:
                plain["walk"] = ms_w
                mid_walk = (tb_s, st_in)
            del ops_p, st_p
        else:
            state = nw_cuda.nw_walk_segment(tb_s, st_in, ops, t0=s * seg, seg=seg, band=band)

    # the group walk over every segment in one launch (the main path's)
    # against its plain version and the per-segment walk
    st0 = nw_cuda.walk_state(ql, tl, band=band)
    ops_all, ops_allp = torch.zeros_like(ops), torch.zeros_like(ops)
    st_g = nw_cuda.nw_walk_segment_group(tb_all, st0, ops_all, s0=0, G=n_seg, seg=seg, band=band)
    plain["group_walk"], st_gp = once_ms(lambda: nw_cuda.nw_walk_segment_group_reference(
        tb_all, st0, ops_allp, s0=0, G=n_seg, seg=seg, band=band))
    err["group_walk"] = max(max_abs_err(st_g, st_gp), max_abs_err(ops_all, ops_allp),
                            max_abs_err(st_g, state), max_abs_err(ops_all, ops))
    del ops_allp, st_gp, st_g
    print(f"long parity (largest long chunk B={B} W={W} tmax={tmax} seg={seg} n_seg={n_seg}, "
          f"segments {picks}; groups [s0, G] {json.dumps(g_picks)} into [B, {n_seg * seg}, W] at "
          f"row s0 * seg, every segment's rows against the per-segment launch; the group walk over "
          f"all {n_seg}): max_abs_err {json.dumps(err)}")
    if any(err.values()):
        raise AssertionError("a segment kernel disagrees with its plain version")

    # the route at G = n_seg (the runner's budget) and at G = 1 against the
    # chained launches and single-shot A + B; G = 1's launches counted alone
    budget_g1 = B * seg * W  # one segment's traceback: G = 1
    if nw_cuda.long_group_size(B, W, seg, n_seg, nw_cuda.LONG_BUDGET) != n_seg:
        raise AssertionError("the largest long chunk's traceback does not fit the budget whole")
    s_long, ops_long = nw_cuda.nw_align_long(Q, T, ql, tl, t_need=t_need, **kw)
    nw_cuda.reset_launch_counts()
    s_g1, ops_g1 = nw_cuda.nw_align_long(Q, T, ql, tl, t_need=t_need, memory_budget=budget_g1, **kw)
    torch.cuda.synchronize()
    launches_g1 = {k: v for k, v in nw_cuda.LAUNCHES.items() if v}
    s_one, tb_one = nw_cuda.nw_align(Q, T, ql, tl, band=band, tmax=tmax, **pen)
    ops_one = nw_cuda.nw_walk(tb_one, ql, tl, band=band, tmax=tmax)
    del tb_one
    err_route = max(max_abs_err(s_long, scores[-1]), max_abs_err(ops_long, ops),
                    max_abs_err(s_g1, s_long), max_abs_err(ops_g1, ops_long),
                    max_abs_err(s_long, s_one),
                    max_abs_err(ops_long[:, : t_need + 1], ops_one[:, : t_need + 1]),
                    int(ops_long[:, t_need + 1 :].any().item()), int(ops_one[:, t_need + 1 :].any().item()))
    print(f"long route (G = {n_seg} and G = 1) vs single-shot A + B on that chunk: max_abs_err "
          f"{err_route} (scores {int((s_long >= 0).sum())} of {B} rows, "
          f"{int((ops_long != 0).sum())} walk steps); G = 1's launches {json.dumps(launches_g1)}")
    if err_route:
        raise AssertionError("the long route disagrees with single-shot kernels A + B")
    want_g1 = {"nw_sweep_segment_score_only": 1, "nw_sweep_segment_group": n_seg,
               "nw_walk_segment_group": n_seg}
    if launches_g1 != want_g1:
        raise AssertionError(f"the route at G = 1 launched {launches_g1}, not {want_g1}")
    del s_g1, ops_g1

    # times: each launch shape of the G = 1 route and of the main path on
    # the middle segment or group, the forward pass whole and in its runs,
    # the route by G with overlap on and off, single-shot A + B
    spare = torch.empty_like(carries[0])
    tb_mid, st_mid = mid_walk
    ops_w = torch.zeros_like(ops)
    ms = {
        "score_only": cuda_ms(lambda: nw_cuda.nw_align_segment(
            Q, T, ql, tl, carries[mid], scores[mid], t0=mid * seg, with_traceback=False, out=spare,
            **kw), REPS),
        # a segment's recompute and walk as the route makes them at G = 1
        "sweep": cuda_ms(lambda: nw_cuda.nw_align_segment_group(
            Q, T, ql, tl, ckpt, s0=mid, G=1, tb=tb_mid, **kw), REPS),
        "walk": cuda_ms(lambda: nw_cuda.nw_walk_segment_group(
            tb_mid, st_mid, ops_w, s0=mid, G=1, seg=seg, band=band), REPS),
        "run": cuda_ms(lambda: nw_cuda.nw_align_segment_run(
            Q, T, ql, tl, run_ckpt, scores[mid_g], s0=mid_g, n_run=R, **kw), REPS),
        "group": cuda_ms(lambda: nw_cuda.nw_align_segment_group(
            Q, T, ql, tl, ckpt, s0=mid_g, G=R, tb=tb_all, row0=mid_g * seg, **kw), REPS),
        "group_walk": cuda_ms(lambda: nw_cuda.nw_walk_segment_group(
            tb_all, st0, ops_w, s0=0, G=n_seg, seg=seg, band=band), REPS),
    }
    fwd_ms = cuda_ms(lambda: nw_cuda.nw_align_segment_run(
        Q, T, ql, tl, run_ckpt, scores[0], s0=0, n_run=n_seg, **kw), REPS)
    runs_ms = cuda_ms(lambda: [nw_cuda.nw_align_segment_run(
        Q, T, ql, tl, run_ckpt, scores[0], s0=a, n_run=r, **kw) for a, r in runs], REPS)
    group_all_ms = cuda_ms(lambda: nw_cuda.nw_align_segment_group(
        Q, T, ql, tl, ckpt, s0=0, G=n_seg, tb=tb_all, **kw), REPS)

    def in_turns():
        """The route at G = n_seg without the overlap: the forward pass in
        one launch, the recompute of every segment in one, the group walk."""
        ck = torch.empty_like(ckpt)
        ck[0] = carries[0]
        nw_cuda.nw_align_segment_run(Q, T, ql, tl, ck, scores[0], s0=0, n_run=n_seg, **kw)
        nw_cuda.nw_align_segment_group(Q, T, ql, tl, ck, s0=0, G=n_seg, tb=tb_all, **kw)
        return nw_cuda.nw_walk_segment_group(tb_all, st0, torch.zeros_like(ops), s0=0, G=n_seg,
                                             seg=seg, band=band)

    route_by_g = {f"G={g_name} overlap on": cuda_ms(
        lambda: nw_cuda.nw_align_long(Q, T, ql, tl, t_need=t_need, memory_budget=bud, **kw), REPS)
        for g_name, bud in ((1, budget_g1), (2, 2 * budget_g1), (n_seg, nw_cuda.LONG_BUDGET))}
    route_by_g[f"G={n_seg} overlap off"] = cuda_ms(in_turns, REPS)
    route_ms = route_by_g[f"G={n_seg} overlap on"]
    single_ms = cuda_ms(lambda: nw_cuda.nw_walk(nw_cuda.nw_align(Q, T, ql, tl, band=band, tmax=tmax,
                                                                  **pen)[1],
                                                 ql, tl, band=band, tmax=tmax), REPS)
    steps_mid = int((ops[:, mid * seg + 1 : (mid + 1) * seg + 1] != 0).sum().item())
    steps_all = int((ops_all != 0).sum().item())
    # other segment lengths: the same scores and opcodes, and their time
    by_seg = {}
    for sg in (1024, 4096):
        s_g, ops_g = nw_cuda.nw_align_long(Q, T, ql, tl, band=band, seg=sg, t_need=t_need, **pen)
        if max(max_abs_err(s_g, s_long), max_abs_err(ops_g[:, : t_need + 1], ops_long[:, : t_need + 1])):
            raise AssertionError(f"the long route at seg {sg} disagrees with seg {seg}")
        del s_g, ops_g
        by_seg[sg] = cuda_ms(lambda: nw_cuda.nw_align_long(Q, T, ql, tl, band=band, seg=sg,
                                                            t_need=t_need, **pen), REPS)
    by_seg[seg] = route_ms

    # the locus's long chunks in series and at once (a stream each, as the
    # runner dispatches them): equal scores and opcodes, their times, and the
    # peak device memory at once
    chunk_in = [long_inputs(dd) for dd in longs]
    chunk_streams = [torch.cuda.Stream() for _ in longs]  # kept, as the runner keeps its own

    def all_chunks(at_once):
        main = torch.cuda.current_stream()
        outs, streams = [], []
        for (Qc, Tc, qc, tc, _), dd, own in zip(chunk_in, longs, chunk_streams):
            st = own if at_once else main
            st.wait_stream(main)
            with torch.cuda.stream(st):
                outs.append(nw_cuda.nw_align_long(Qc, Tc, qc, tc, band=dd["band"], seg=dd["seg"],
                                                  t_need=int((qc + tc).max()), **pen))
            streams.append(st)
        for st in streams:
            main.wait_stream(st)
        for x in (x for o in outs for x in o):
            x.record_stream(main)
        return outs

    outs_series, outs_once = all_chunks(False), all_chunks(True)
    err_once = max(max_abs_err(a, b) for o1, o2 in zip(outs_series, outs_once) for a, b in zip(o1, o2))
    del outs_series, outs_once
    if err_once:
        raise AssertionError("the locus's long chunks at once disagree with the chunks in series")
    chunks_ms = {"series": cuda_ms(lambda: all_chunks(False), REPS),
                 "at_once": cuda_ms(lambda: all_chunks(True), REPS)}
    # the memory the chunks hold at once: their tracebacks and checkpoints as
    # reckoned, and what the allocator reserved anew for them (a freed block
    # waits for its streams' work before it is reused, so the allocated
    # peak undercounts it)
    live = sum(dd["B"] * dd["n_seg"] * dd["seg"] * (dd["band"] + 1) * (1 + 24 / dd["seg"])
               for dd in longs)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_reserved()
    all_chunks(True)
    torch.cuda.synchronize()
    peak_at_once = torch.cuda.max_memory_reserved() - base_mem
    retry = [sorted(map(tuple, dd["jobs"])) for dd in longs]
    firsts = all(not set(retry[k]) & set(retry[j]) for k in range(len(retry)) for j in range(k))
    print(f"locus long chunks {json.dumps([[dd['B'], dd['band'], dd['n_seg'], dd['group']] for dd in longs])}"
          f" ([B, band, n_seg, G]): at once equal to in series (scores and opcodes, max_abs_err "
          f"{err_once}); jobs disjoint (no chunk a band-escalation retry of another): "
          f"{firsts}; band_escalations {st['band_escalations']}; route in series "
          f"{chunks_ms['series']:.3f} ms, at once {chunks_ms['at_once']:.3f} ms; memory at once: "
          f"reserved anew {peak_at_once / 1e9:.3f} GB, tracebacks and checkpoints {live / 1e9:.3f} GB "
          f"(budget {nw_cuda.LONG_BUDGET / 1e9:.1f} GB a chunk) | {smi}")

    # bounds.  A segment: its needed cells (the rows each pair's matrix has
    # in it) at 37 (24 score-only) instructions each; the full mode writes
    # [B, seg, W] traceback bytes; both read and write the carry.  A forward
    # run and a recompute group of R segments: the same over their segments
    # (the run writes each carry; the group reads each checkpoint); the
    # group walk over every segment: its steps and opcode columns.
    t_final = (ql + tl).to(torch.int64)

    def needed_cells(a, b):  # the cells of anti-diagonals a * seg + 1 .. b * seg
        return int((torch.clamp(t_final, max=b * seg)
                    - torch.clamp(t_final, max=a * seg)).sum().item()) * W

    cells = needed_cells(mid, mid + 1)
    cells_run = needed_cells(mid_g, mid_g + R)
    carry_bytes = 2 * 24 * B * W
    win_bytes = B * (seg // 2 + seg + 2 * W)

    def bound(nbytes, n_ops, n_min):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = max(n_ops / ISSUE_OPS_PER_S, n_min / ALU_OPS_PER_S) * 1e3
        return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"

    bounds = {
        "sweep": bound(B * seg * W + carry_bytes // 2 + win_bytes, cells * SWEEP_OPS_PER_CELL,
                       cells * SWEEP_MIN_OPS_PER_CELL),
        "score_only": bound(carry_bytes + win_bytes, cells * SCORE_ONLY_OPS_PER_CELL,
                            cells * SCORE_ONLY_MIN_OPS_PER_CELL),
        "walk": bound(steps_mid + B * seg + 2 * 16 * B, steps_mid * WALK_OPS_PER_STEP, 0),
        "run": bound(R * (carry_bytes // 2 + win_bytes) + carry_bytes // 2,
                     cells_run * SCORE_ONLY_OPS_PER_CELL, cells_run * SCORE_ONLY_MIN_OPS_PER_CELL),
        "group": bound(R * (B * seg * W + carry_bytes // 2 + win_bytes),
                       cells_run * SWEEP_OPS_PER_CELL, cells_run * SWEEP_MIN_OPS_PER_CELL),
        "group_walk": bound(steps_all + B * n_seg * seg + 2 * 16 * B, steps_all * WALK_OPS_PER_STEP, 0),
    }
    plan = nw_cuda.plan_sweep(B, W, Q.shape[1], T.shape[1], seg=seg)
    plan_g = nw_cuda.plan_sweep(B, W, Q.shape[1], T.shape[1], seg=seg, groups=R)
    piece = "two-piece" if two else "one-piece"
    regs = {
        "sweep": ptxas_registers(ptxas, f"nw_sweep_regs_seg<{plan.lanes}, {piece}, traceback>"),
        "score_only": ptxas_registers(ptxas, f"nw_sweep_regs_seg<{plan.lanes}, {piece}, score-only>"),
        "walk": ptxas_registers(ptxas, "nw_walk_seg_kernel"),
        "run": ptxas_registers(ptxas, f"nw_sweep_regs_seg<{plan.lanes}, {piece}, score-only>"),
        "group": ptxas_registers(ptxas, f"nw_sweep_regs_seg<{plan_g.lanes}, {piece}, traceback>"),
        "group_walk": ptxas_registers(ptxas, "nw_walk_seg_kernel"),
    }
    print(f"timing long (B={B} W={W} seg={seg} n_seg={n_seg}, middle segment {mid}, middle group "
          f"{mid_g}..{mid_g + R - 1}): segment score-only {ms['score_only']:.4f} ms, recompute at "
          f"G = 1 {ms['sweep']:.4f} ms, walk at G = 1 {ms['walk']:.4f} ms ({steps_mid} steps); "
          f"forward run of {R} segments {ms['run']:.4f} ms, the forward pass in one launch "
          f"{fwd_ms:.3f} ms, in runs of {nw_cuda.LONG_RUN} {runs_ms:.3f} ms; grouped recompute of "
          f"{R} segments {ms['group']:.4f} ms, of all {n_seg} {group_all_ms:.3f} ms; group walk of "
          f"all {n_seg} {ms['group_walk']:.3f} ms ({steps_all} steps); route per chunk by G "
          f"{json.dumps(route_by_g)} ms; single-shot A + B {single_ms:.3f} ms; route by segment "
          f"length {json.dumps(by_seg)} ms; bounds {json.dumps(bounds)}; plain {json.dumps(plain)}; "
          f"{plan}; group {plan_g}; registers {json.dumps(regs)} | {smi}")

    shape = {"B": B, "W": W, "tmax": tmax, "seg": seg, "n_seg": n_seg, "segment": mid}
    common = {"route_per_chunk_ms": route_ms, "route_ms_by_group": route_by_g,
              "route_ms_by_seg": by_seg, "route_ms_by_chunk": chunk_ms,
              "locus_long_chunks_ms": chunks_ms, "single_shot_per_chunk_ms": single_ms,
              "locus_at_once_reserved_bytes": peak_at_once, "locus_at_once_live_bytes": live,
              "forward_pass_ms": fwd_ms, "forward_runs_ms": runs_ms,
              "group_all_segments_ms": group_all_ms, "tolerance": 0}
    main_path = "8 x 60 kb locus, default run"
    g1_path = f"nw_align_long at G = 1 (budget {budget_g1} B), the largest long chunk"
    out = []
    # at G = 1 the route recomputes and walks a segment a launch through the
    # group wrappers (their counters), the kernels of nw_align_segment and
    # nw_walk_segment at one segment's shape
    for kname, key, src, replaces, n_launch, path, per_chunk, shp in (
        ("nw_sweep_segment", "sweep", "seqrush_tpu_torch/ops/csrc/nw_sweep_seg.cu",
         "seqrush_tpu/ops/nw_pallas.py:38", launches_g1["nw_sweep_segment_group"], g1_path, n_seg,
         shape),
        ("nw_sweep_segment_score_only", "run", "seqrush_tpu_torch/ops/csrc/nw_sweep_seg.cu",
         "seqrush_tpu/ops/nw_pallas.py:38", launches["nw_sweep_segment_score_only"], main_path,
         len(runs), {**shape, "segment": f"{mid_g}..{mid_g + R - 1}, one run"}),
        ("nw_walk_segment", "walk", "seqrush_tpu_torch/ops/csrc/nw_walk.cu",
         "seqrush_tpu/ops/nw_pallas.py:194", launches_g1["nw_walk_segment_group"], g1_path, n_seg,
         shape),
        ("nw_sweep_segment_group", "group", "seqrush_tpu_torch/ops/csrc/nw_sweep_seg.cu",
         "seqrush_tpu/ops/nw_pallas.py:38", launches["nw_sweep_segment_group"], main_path,
         len(runs), {**shape, "segment": f"{mid_g}..{mid_g + R - 1}, one group"}),
        ("nw_walk_segment_group", "group_walk", "seqrush_tpu_torch/ops/csrc/nw_walk.cu",
         "seqrush_tpu/ops/nw_pallas.py:194", launches["nw_walk_segment_group"], main_path, 1,
         {**shape, "segment": f"all {n_seg}, one launch"}),
    ):
        out.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": n_launch, "max_abs_err": err[key], "ms": ms[key],
            "plain_ms": plain[key], "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": None, "regs_per_thread": regs[key], "shape": shp,
            "launches_per_chunk": per_chunk, "launches_path": path, **common,
        })
    for e in (out[0], out[2]):
        e["launches_counter"] = {"nw_sweep_segment": "nw_sweep_segment_group",
                                 "nw_walk_segment": "nw_walk_segment_group"}[e["name"]] + " (G = 1)"
    out[1]["segment_ms"] = ms["score_only"]  # one segment's score-only launch, as before
    out[1]["segment_max_abs_err"] = err["score_only"]
    del carries, scores, ops, ops_all, ops_long, ops_one, ops_w, mid_walk, tb_mid, tb_s, ckpt
    del run_ckpt, tb_all
    torch.cuda.empty_cache()
    return out


# both modes' chunks fetch run tokens; the sweepga gap windows that overflow
# GAP_RUN_MAX and the inversion batch take the opcode walk
BACKEND_KERNELS = ("nw_sweep", "nw_walk_runs", "nw_walk")


def run_backends(work: Path, smi: str, drive, shapes) -> dict:
    """7. The sweepga backend and --inversion-aware on the headline corpus.

    7a. ``--aligner sweepga --no-sort``: the JAX package's GFA
        (SWEEPGA_GFA_SHA256), both kernels launched; then the same with the
        layout (sorted graph isomorphic to the unsorted one, ids 1..N);
    7b. kernels A and B against their plain versions on 7a's device gap
        chunk (the inversion carrier's cores), with times and bounds;
    7c. the orientation probe: ``--aligner sweepga --no-sort`` on probe_trio
        must launch the score-only sweep; choose_orientations(PROBE_PAIRS)
        on the card must be PROBE_ORIENTATIONS, and the probe's scores the
        plain version's;
    7d. ``--inversion-aware --no-sort``: the JAX package's GFA
        (INVERSION_GFA_SHA256); each chunk's band and route, and the time
        of the reverse pass's widest chunk (kernels A + B);
    7e. kernels A and B against their plain versions on 7d's inversion
        window batch, with times and bounds.
    Returns the kernels line's entries of these launch sites ('gap',
    'inversion' for kernels A and B, 'probe' for the score-only sweep),
    their parity records, the gap chunk's inputs on the card ('gap_inputs':
    Q, T, qlens, tlens, band, tmax) and both modes' run_overflows."""
    from seqrush_tpu_torch.align.inversion import pack_inversion_batch
    from seqrush_tpu_torch.align.pairs import all_ordered_pairs
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner, pack_probe
    from seqrush_tpu_torch.align.sweep import SweepAligner, pack_gap_chunk
    from seqrush_tpu_torch.graph.bigraph import parse_gfa
    from seqrush_tpu_torch.ops import nw_cuda
    from seqrush_tpu_torch.ops.wfa import Penalties
    from seqrush_tpu_torch.pos import reverse_complement_codes
    from seqrush_tpu_torch.scores import AlignmentScores
    from seqrush_tpu_torch.sequences import make_sequence_set
    from seqrush_tpu_torch.tools.isomorphic import isomorphic

    dev = torch.device("cuda")
    named = synth_hla()
    fa = work / "hla25_backends.fa"
    write_fasta(fa, named)
    pairs = all_ordered_pairs(len(named))
    n_pairs = len(pairs)
    al = WfaAligner(make_sequence_set(named), RunnerConfig(scores=AlignmentScores.parse(SCORES)),
                    device=dev)
    pen = al._penalties()

    def oriented(p, rc):
        qi, tj = pairs[p]
        return (al.rc_codes[qi] if rc else al.codes[qi]), al.codes[tj]

    def on_card(arrays):
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    def bound_entry(b):
        return {"bound_ms": max(b), "bound_by": "bytes" if b[0] >= b[1] else "operations"}

    def site(label, Q, T, ql, tl, band, tmax, launches):
        """Kernels A and B on one launch site's inputs against their plain
        versions (exact), then CUDA-event times of each."""
        kw = dict(band=band, tmax=tmax, **pen)
        s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
        plain_a, (s_p, tb_p) = once_ms(lambda: nw_cuda.nw_align_reference(Q, T, ql, tl, **kw))
        err_a = max(max_abs_err(s_k, s_p), max_abs_err(tb_k, tb_p))
        del s_p, tb_p
        ops_k = nw_cuda.nw_walk(tb_k, ql, tl, band=band, tmax=tmax)
        plain_b, ops_p = once_ms(lambda: nw_cuda.nw_walk_reference(tb_k, ql, tl, band=band, tmax=tmax))
        err_b = max_abs_err(ops_k, ops_p)
        del ops_p
        B, W = Q.shape[0], band + 1
        print(f"parity {label}: B={B} W={W} tmax={tmax} Lq={Q.shape[1]} Lt={T.shape[1]} "
              f"sweep max_abs_err={err_a} walk max_abs_err={err_b}")
        if err_a or err_b:
            raise AssertionError(f"kernel disagrees with its plain version ({label})")
        a_ms = cuda_ms(lambda: nw_cuda.nw_align(Q, T, ql, tl, **kw), REPS)
        b_ms = cuda_ms(lambda: nw_cuda.nw_walk(tb_k, ql, tl, band=band, tmax=tmax), REPS)
        plan = nw_cuda.plan_sweep(B, W, Q.shape[1], T.shape[1])
        a_b, b_b = sweep_bounds(Q, T, ql, tl, W, tb_k.numel()), walk_bounds(ops_k)
        shape = {"B": B, "W": W, "tmax": tmax, "Lq": Q.shape[1], "Lt": T.shape[1]}
        print(f"timing {label}: sweep {a_ms:.4f} ms (bound {max(a_b):.4f}, plain {plain_a:.1f}) walk "
              f"{b_ms:.4f} ms (bound {max(b_b):.4f}, plain {plain_b:.1f}); {plan} | {smi}")
        out = {
            "sweep": {"shape": shape, "launches": launches["nw_sweep"], "ms": a_ms, "plain_ms": plain_a,
                      **bound_entry(a_b), "max_abs_err": err_a, "route": plan.route,
                      "lanes": plan.lanes, "warps_per_pair": plan.warps_per_pair},
            "walk": {"shape": shape, "launches": launches["nw_walk"], "ms": b_ms, "plain_ms": plain_b,
                     **bound_entry(b_b), "max_abs_err": err_b},
        }
        del s_k, tb_k, ops_k
        torch.cuda.empty_cache()
        return out, {"dispatch": label, "B": B, "W": W, "tmax": tmax, "sweep_err": err_a,
                     "walk_err": err_b}

    # 7a. --aligner sweepga, --no-sort and with the layout
    gfa_ns, gfa_sorted = work / "hla25_sweepga_nosort.gfa", work / "hla25_sweepga.gfa"
    rep, launches_sw, wall = drive(gfa_ns, "--aligner", "sweepga", "--no-sort",
                                   kernels=BACKEND_KERNELS, fasta=fa)
    st = rep["stats"]["aligner"]
    digest = hashlib.sha256(gfa_ns.read_bytes()).hexdigest()
    gaps = [d for d in st["dispatches"] if d["kind"] == "gap"]
    counters = {k: st[k] for k in ("chains", "filtered_1to1", "host_windows", "run_overflows",
                                   "dropped")}
    print(f"--aligner sweepga --no-sort: total {wall:.2f} s; align phase "
          f"{rep['phases_s']['align']:.4f} s = {rep['alignments_per_s']:.2f} alignments/s; "
          f"{json.dumps(counters)}; device gap windows {sum(len(d['jobs']) for d in gaps)} in chunks "
          f"{shapes(st, 'gap')} ([B, band, tmax, jobs]); launches {launches_sw}; graph "
          f"{json.dumps(rep['graph'])}; GFA sha256 {digest} (JAX package's {SWEEPGA_GFA_SHA256}) | {smi}")
    print("  phases_s " + json.dumps({k: round(v, 4) for k, v in rep["phases_s"].items()}))
    if int(rep["counters"]["alignments"]) != n_pairs or rep["graph"]["paths"] != len(named):
        raise AssertionError("the sweepga run did not align every pair into every path")
    if digest != SWEEPGA_GFA_SHA256:
        raise AssertionError("the sweepga --no-sort GFA is not the JAX package's")
    rep_s, launches_s, wall_s = drive(gfa_sorted, "--aligner", "sweepga", kernels=BACKEND_KERNELS,
                                      fasta=fa)
    ph = rep_s["phases_s"]
    print(f"--aligner sweepga (layout on): total {wall_s:.2f} s; align phase {ph['align']:.4f} s; "
          f"layout {ph['layout']:.4f} s; launches {launches_s}; phases_s "
          + json.dumps({k: round(v, 4) for k, v in ph.items()}))
    g_sorted, g_ns = parse_gfa(gfa_sorted.read_text()), parse_gfa(gfa_ns.read_text())
    same, why = isomorphic(g_sorted, g_ns)
    if not same or sorted(g_sorted.nodes) != list(range(1, rep_s["graph"]["nodes"] + 1)):
        raise AssertionError(f"the sorted sweepga graph is not the unsorted one renumbered: {why}")

    # 7b. kernels A and B on the device gap chunk
    d = max(gaps, key=lambda d: d["B"] * (d["band"] + 1) * d["tmax"])
    jobs = []
    for p, rc, q0, t0, nq, nt in d["jobs"]:
        q, t = oriented(p, rc)
        jobs.append((0, 0, q[q0 : q0 + nq], t[t0 : t0 + nt]))
    Q, T, ql, tl, band, tmax = pack_gap_chunk(jobs)
    if (Q.shape[0], band, tmax) != (d["B"], d["band"], d["tmax"]):
        raise AssertionError("the rebuilt gap chunk has another shape")
    gap_inputs = (*on_card((Q, T, ql, tl)), band, tmax)
    gap_site, gap_par = site("gap", *gap_inputs, launches_sw)

    # 7c. the orientation probe
    trio = probe_trio()
    tfa = work / "trio.fa"
    write_fasta(tfa, trio)
    rep_t, launches_t, _wall_t = drive(work / "trio.gfa", "--aligner", "sweepga", "--no-sort",
                                       kernels=("nw_sweep_score_only",), fasta=tfa)
    tal = SweepAligner(make_sequence_set(trio), RunnerConfig(), device=dev)
    probe_pairs = np.array(PROBE_PAIRS)
    undecided = tal._orient_and_estimate(probe_pairs)[1]
    got = tal.choose_orientations(probe_pairs).tolist()
    (pd,) = [d for d in tal.stats["dispatches"] if d["kind"] == "probe"]
    bq = [(tal.rc_codes if k % 2 else tal.codes)[PROBE_PAIRS[k // 2][0]] for (k,) in pd["jobs"]]
    bt = [tal.codes[PROBE_PAIRS[k // 2][1]] for (k,) in pd["jobs"]]
    Qn, Tn, qln, tln, pband, ptmax = pack_probe(bq, bt)
    if (Qn.shape[0], pband, ptmax) != (pd["B"], pd["band"], pd["tmax"]):
        raise AssertionError("the rebuilt probe chunk has another shape")
    Q, T, ql, tl = on_card((Qn, Tn, qln, tln))
    okw = dict(band=pband, tmax=ptmax, **Penalties(1, 1, 1).kernel_kwargs())
    s_k, _ = nw_cuda.nw_align(Q, T, ql, tl, with_traceback=False, **okw)
    plain_o, (s_p, _) = once_ms(lambda: nw_cuda.nw_align_reference(Q, T, ql, tl, with_traceback=False,
                                                                   **okw))
    err_o = max_abs_err(s_k, s_p)
    o_ms = cuda_ms(lambda: nw_cuda.nw_align(Q, T, ql, tl, with_traceback=False, **okw), REPS)
    o_b = sweep_bounds(Q, T, ql, tl, pband + 1, 0)
    oplan = nw_cuda.plan_sweep(Q.shape[0], pband + 1, Q.shape[1], T.shape[1])
    print(f"orientation probe (probe_trio, pairs {PROBE_PAIRS}): sketch-undecided "
          f"{undecided.tolist()}; choose_orientations {got} (JAX package's {PROBE_ORIENTATIONS}); "
          f"probe B={Q.shape[0]} W={pband + 1} tmax={ptmax} scores {s_k.tolist()} max_abs_err={err_o}; "
          f"score-only {o_ms:.4f} ms (bound {max(o_b):.5f}, plain {plain_o:.1f}); trio CLI launches "
          f"{launches_t}; {oplan} | {smi}")
    if not undecided.all() or got != PROBE_ORIENTATIONS or err_o:
        raise AssertionError("the orientation probe disagrees with the JAX package or its plain version")
    probe = {"shape": {"B": Q.shape[0], "W": pband + 1, "tmax": ptmax, "Lq": Q.shape[1],
                       "Lt": T.shape[1]},
             "launches": launches_t["nw_sweep_score_only"], "ms": o_ms, "plain_ms": plain_o,
             **bound_entry(o_b), "max_abs_err": err_o, "route": oplan.route,
             "launches_path": "--aligner sweepga on probe_trio", "penalties": "one-piece 0,1,1,1"}
    del Q, T, ql, tl, s_k, s_p

    # 7d. --inversion-aware
    gfa_inv = work / "hla25_inversion_nosort.gfa"
    rep_i, launches_i, wall_i = drive(gfa_inv, "--inversion-aware", "--no-sort",
                                      kernels=BACKEND_KERNELS, fasta=fa)
    st_i = rep_i["stats"]["aligner"]
    digest_i = hashlib.sha256(gfa_inv.read_bytes()).hexdigest()
    (inv_d,) = [d for d in st_i["dispatches"] if d["kind"] == "inversion"]
    routes = []
    for cd in (d for d in st_i["dispatches"] if d["kind"] == "chunk"):
        Qc, Tc, _qc, _tc, _tmax = al.pack_chunk([(p, bool(rc), cd["band"], *oriented(p, rc))
                                                 for p, rc in cd["jobs"]])
        plan = nw_cuda.plan_sweep(cd["B"], cd["band"] + 1, Qc.shape[1], Tc.shape[1])
        routes.append([cd["B"], cd["band"], cd["tmax"], plan.route,
                       "reverse" if all(rc for _p, rc in cd["jobs"]) else "forward"])
    widest = max((cd for cd in st_i["dispatches"] if cd["kind"] == "chunk"
                  and all(rc for _p, rc in cd["jobs"])), key=lambda cd: (cd["band"], cd["B"]))
    Qw, Tw, qw, tw, wtmax = al.pack_chunk([(p, bool(rc), widest["band"], *oriented(p, rc))
                                           for p, rc in widest["jobs"]])
    Qw, Tw, qw, tw = on_card((Qw, Tw, qw, tw))
    wkw = dict(band=widest["band"], tmax=wtmax, **pen)
    widest_ms = cuda_ms(lambda: nw_cuda.nw_walk(nw_cuda.nw_align(Qw, Tw, qw, tw, **wkw)[1], qw, tw,
                                                band=widest["band"], tmax=wtmax), REPS)
    wplan = nw_cuda.plan_sweep(Qw.shape[0], widest["band"] + 1, Qw.shape[1], Tw.shape[1])
    del Qw, Tw, qw, tw
    torch.cuda.empty_cache()
    counters = {k: st_i[k] for k in ("band_escalations", "anchored_pairs", "anchored_windows",
                                     "host_windows", "anchored_fallbacks", "inversion_windows",
                                     "inversion_patches", "cells_true", "cells_padded", "dropped")}
    ph = rep_i["phases_s"]
    print(f"--inversion-aware --no-sort: total {wall_i:.2f} s; {int(rep_i['counters']['alignments'])} "
          f"alignments; align phase {ph['align']:.4f} s = {rep_i['alignments_per_s']:.2f} "
          f"alignments/s; inversion_patch phase {ph['inversion_patch']:.4f} s; {json.dumps(counters)}; "
          f"inversion window batch [B {inv_d['B']}, Lq {inv_d['Lq']}, band {inv_d['band']}, tmax "
          f"{inv_d['tmax']}] of {len(inv_d['jobs'])} windows; launches {launches_i}; graph "
          f"{json.dumps(rep_i['graph'])}; GFA sha256 {digest_i} (JAX package's "
          f"{INVERSION_GFA_SHA256}) | {smi}")
    print("  phases_s " + json.dumps({k: round(v, 4) for k, v in ph.items()}))
    print(f"  chunks [B, band, tmax, route, pass] {json.dumps(routes)}; window chunks "
          f"{shapes(st_i, 'window')}; reverse pass's widest chunk B={widest['B']} band="
          f"{widest['band']} tmax={wtmax}: kernels A + B {widest_ms:.3f} ms on the {wplan.route} "
          f"route | {smi}")
    if int(rep_i["counters"]["alignments"]) != 2 * n_pairs or rep_i["graph"]["paths"] != len(named):
        raise AssertionError("the inversion-aware run did not align every pair both ways")
    if [inv_d["B"], inv_d["Lq"], inv_d["band"], inv_d["tmax"]] != INVERSION_BATCH_SHAPE:
        raise AssertionError("the inversion window batch is not the JAX package's shape")
    if digest_i != INVERSION_GFA_SHA256:
        raise AssertionError("the --inversion-aware --no-sort GFA is not the JAX package's")

    # 7e. kernels A and B on the inversion window batch
    jobs = []
    for qi, ti, qs, qe, ts, te in inv_d["jobs"]:
        jobs.append((None, None, al.codes[qi][qs:qe],
                     reverse_complement_codes(al.codes[ti][ts:te]).copy()))
    Q, T, ql, tl, band, tmax = pack_inversion_batch(jobs)
    if (Q.shape[0], Q.shape[1], band, tmax) != (inv_d["B"], inv_d["Lq"], inv_d["band"], inv_d["tmax"]):
        raise AssertionError("the rebuilt inversion batch has another shape")
    inv_site, inv_par = site("inversion", *on_card((Q, T, ql, tl)), band, tmax, launches_i)
    inv_site["sweep"]["reverse_pass_widest_chunk"] = {
        "B": widest["B"], "W": widest["band"] + 1, "tmax": wtmax, "route": wplan.route,
        "sweep_and_walk_ms": widest_ms}
    return {"gap": gap_site, "inversion": inv_site, "probe": probe, "parity": [gap_par, inv_par],
            "gap_inputs": gap_inputs, "launches_sweepga": launches_sw,
            "run_overflows": {"sweepga": st["run_overflows"], "inversion_aware": st_i["run_overflows"]}}


def run_phase8(smi: str, ptxas: list[str], ctx: dict) -> list[dict]:
    """8. Run tokens (kernel B's runs mode) and the wavefront kernel.

    8a. the runs mode against its plain version (tokens and counts, exact)
        on the traceback of each launch site that takes it, at its own token
        budget: the default run's largest chunk (RUN_MAX) and window chunk
        (WIN_RUN_MAX), the sweepga gap chunk (GAP_RUN_MAX), and the walk gap
        corpus (tools/headline.py::walk_gap_corpus, RUN_MAX); and
        on a seeded batch at run_len_max 8 and run_max 4, where runs split
        and lists overflow; CUDA-event times behind a spin of the card
        (spun_ms) beside the opcode walk's on the same traceback, the bound,
        the registers, and the walk's phase split from its own timer
        (nw_cuda.walk_runs_split, whose tokens must be the same); each
        mode's run_overflows against the JAX package's
        (RUN_OVERFLOWS); all 600 pairs through the runner with emit 'auto'
        (run tokens) and 'ops', in turns: equal results, the align seconds
        and the collect seconds of each;
    8b. all 600 pairs through WfaAligner(kernel='wfa', band_slack=
        WFA_BAND_SLACK) on the card, launch counters reset just before and
        read just after; every batch it launched rebuilt and run again
        through the kernel and the plain version: scores and the whole
        history tensors equal, and the plain version's backtrace equal to
        the run's CIGARs; the score-only mode (keep_history=False) through
        wfa_align_device on the first batch, its scores the full mode's;
        CUDA-event times, score steps and bounds of each batch; the sha256
        of wfa_subset()'s records against the JAX package's
        (WFA_SUBSET_SHA256).
    Returns the kernels line's entries of nw_walk_runs, wfa and
    wfa_score_only."""
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner, _quantized_pack
    from seqrush_tpu_torch.align.sweep import GAP_RUN_MAX
    from seqrush_tpu_torch.ops import nw_cuda, wfa
    from seqrush_tpu_torch.ops.wfa import Penalties
    from seqrush_tpu_torch.sequences import make_sequence_set

    dev = torch.device("cuda")
    named, pairs, scores, pen = ctx["named"], ctx["pairs"], ctx["scores"], ctx["pen"]
    n_pairs = len(pairs)

    def bound(nbytes, n_ops):
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, n_ops / ISSUE_OPS_PER_S * 1e3
        return {"bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations"}

    # 8a. the runs mode at each launch site
    runs = {}
    regs = ptxas_registers(ptxas, "nw_walk_runs_kernel")
    for label, (Q, T, ql, tl), band, tmax, run_max in ctx["runs_sites"]:
        run_max = run_max or GAP_RUN_MAX
        kw = dict(band=band, tmax=tmax, **pen)
        _s, tb = nw_cuda.nw_align(Q, T, ql, tl, **kw)
        tok, cnt = nw_cuda.nw_walk_runs(tb, ql, tl, band=band, tmax=tmax, run_max=run_max)
        plain_ms, (tok_p, cnt_p) = once_ms(lambda: nw_cuda.nw_walk_runs_reference(
            tb, ql, tl, band=band, tmax=tmax, run_max=run_max))
        err = max(max_abs_err(tok, tok_p), max_abs_err(cnt, cnt_p))
        ms = spun_ms(lambda: nw_cuda.nw_walk_runs(tb, ql, tl, band=band, tmax=tmax, run_max=run_max), REPS)
        ops_ms = spun_ms(lambda: nw_cuda.nw_walk(tb, ql, tl, band=band, tmax=tmax), REPS)
        tok_t, cnt_t, wsplit = nw_cuda.walk_runs_split(tb, ql, tl, band=band, tmax=tmax, run_max=run_max)
        err = max(err, max_abs_err(tok_t, tok), max_abs_err(cnt_t, cnt))
        steps = int((nw_cuda.nw_walk(tb, ql, tl, band=band, tmax=tmax) != 0).sum().item())
        B = Q.shape[0]
        b = bound(steps + 4 * tok.numel() + 4 * B + 8 * B, steps * WALK_OPS_PER_STEP)
        runs[label] = {"shape": {"B": B, "W": band + 1, "tmax": tmax, "run_max": run_max},
                       "ms": ms, "opcode_walk_ms": ops_ms, "plain_ms": plain_ms, **b,
                       "max_abs_err": err, "overflowing_rows": int((cnt > run_max).sum()),
                       "token_bytes": 4 * (tok.numel() + B), "opcode_bytes": B * (tmax + 1),
                       "regs_per_thread": regs, "split": walk_split_summary(wsplit)}
        print(f"runs walk {label}: B={B} W={band + 1} tmax={tmax} run_max={run_max} max_abs_err={err}; "
              f"{ms:.4f} ms (opcode walk {ops_ms:.4f} ms, bound {b['bound_ms']:.5f}, plain "
              f"{plain_ms:.1f}); {regs} registers; rows over budget {runs[label]['overflowing_rows']}; copy back "
              f"{runs[label]['token_bytes']} bytes of tokens for {runs[label]['opcode_bytes']} of "
              f"opcodes | {smi}")
        print(f"  its phase split (SM cycles a walked pair, and each phase's count): "
              f"{json.dumps(runs[label]['split'])} | {smi}")
        if err:
            raise AssertionError(f"the runs walk disagrees with its plain version ({label})")
        del tb, tok, cnt, tok_p, cnt_p, tok_t, cnt_t
        torch.cuda.empty_cache()

    # a seeded batch whose runs split (at 8 steps) and overflow (past 4)
    rng = np.random.default_rng(8)
    qs, ts = [], []
    for k in range(15):
        q = rng.integers(0, 4, 600).astype(np.uint8)
        t = q.copy()
        t[rng.integers(0, 600, 12)] = rng.integers(0, 4, 12)
        for _ in range(k % 4):
            p = int(rng.integers(50, 500))
            t = np.delete(t, np.arange(p, p + 1 + k))
        qs.append(q)
        ts.append(t)
    Q = np.full((16, 768), 6, np.uint8)
    T = np.full((16, 768), 7, np.uint8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        Q[b, : q.size], T[b, : t.size] = q, t
    ql = np.array([q.size for q in qs] + [0], np.int32)
    tl = np.array([t.size for t in ts] + [0], np.int32)
    Q, T, ql, tl = (torch.from_numpy(a).to(dev) for a in (Q, T, ql, tl))
    _s, tb = nw_cuda.nw_align(Q, T, ql, tl, band=127, tmax=1536, **pen)
    tok, cnt = nw_cuda.nw_walk_runs(tb, ql, tl, band=127, tmax=1536, run_max=4, run_len_max=8)
    tok_p, cnt_p = nw_cuda.nw_walk_runs_reference(tb, ql, tl, band=127, tmax=1536, run_max=4,
                                                  run_len_max=8)
    err_syn = max(max_abs_err(tok, tok_p), max_abs_err(cnt, cnt_p))
    split, over = bool(((tok >> 2) == 8).any()), int((cnt > 4).sum())
    print(f"runs walk synthetic (B=16 W=128 tmax=1536, run_len_max 8, run_max 4): max_abs_err={err_syn}; "
          f"runs split {split}; rows over budget {over}")
    if err_syn or not split or not over:
        raise AssertionError("the runs walk's split or overflow batch failed")
    del tb

    got = ctx["run_overflows"]
    print(f"run_overflows by mode {json.dumps(got)} (the JAX package's {json.dumps(RUN_OVERFLOWS)})")
    if got != RUN_OVERFLOWS:
        raise AssertionError("run_overflows differ from the JAX package's")

    # the align phase through the runner with run tokens and with opcodes
    keys, secs, collect = {}, {"auto": [], "ops": []}, {"auto": [], "ops": []}
    for emit in ("auto", "ops", "ops", "auto"):
        al = WfaAligner(make_sequence_set(named), RunnerConfig(scores=scores, emit=emit), device=dev)
        t0 = time.time()
        res = al.align_pairs(pairs)
        torch.cuda.synchronize()
        secs[emit].append(round(time.time() - t0, 4))
        collect[emit].append(round(al.stats["collect_s"], 4))
        keys.setdefault(emit, sorted((r.query_idx, r.target_idx, r.is_reverse, r.score, r.cigar_string)
                                     for r in res))
    print(f"align phase through the runner ({n_pairs} pairs, in turns): seconds {json.dumps(secs)}; "
          f"collect seconds {json.dumps(collect)}; results equal {keys['auto'] == keys['ops']} | {smi}")
    if keys["auto"] != keys["ops"] or len(keys["auto"]) != n_pairs:
        raise AssertionError("emit='auto' and emit='ops' gave different results")

    # 8b. the wavefront route on the headline corpus
    seqs = make_sequence_set(named)
    wcfg = RunnerConfig(scores=scores, kernel="wfa", band_slack=WFA_BAND_SLACK)
    wal = WfaAligner(seqs, wcfg, device=dev)
    nw_cuda.reset_launch_counts()
    t0 = time.time()
    res = wal.align_pairs(pairs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    wl = dict(nw_cuda.LAUNCHES)
    batches = [d for d in wal.stats["dispatches"] if d["kind"] == "wfa"]
    print(f"kernel='wfa' ({n_pairs} pairs, band_slack {WFA_BAND_SLACK}): {len(res)} aligned in {wall:.3f} s; "
          f"escalations {wal.stats['escalations']}, dropped {wal.stats['dropped']}; launches {wl}; "
          f"batches [B, band, smax, steps, jobs] "
          f"{json.dumps([[d['B'], d['band'], d['smax'], d['steps'], len(d['jobs'])] for d in batches])}"
          f" | {smi}")
    if wl["wfa"] != len(batches) or len(res) != n_pairs or wal.stats["dropped"]:
        raise AssertionError("the wavefront route did not align every pair through the kernel")
    by_pair = {(r.query_idx, r.target_idx): r for r in res}
    pobj = Penalties.from_scores(scores)
    names = ("M", "I1", "D1", "I2", "D2")
    per_batch, err_w, n_cigars = [], 0, 0
    first = None
    for d in batches:
        qs, ts, caps = [], [], []
        for p, rc in d["jobs"]:
            qi, tj = pairs[p]
            q, t = (wal.rc_codes[qi] if rc else wal.codes[qi]), wal.codes[tj]
            qs.append(q)
            ts.append(t)
            caps.append(wal._pair_cap(q.size, t.size))
        Q, T, ql, tl = _quantized_pack(qs, ts)
        caps = np.minimum(np.array(caps + [0] * (len(ql) - len(caps)), np.int32), d["smax"])
        args = [torch.from_numpy(a).to(dev) for a in (Q, T, ql, tl, caps)]
        kw = dict(smax=d["smax"], band=d["band"], keep_history=True, **pen)
        s_k, h_k = wfa.wfa_run(*args, **kw)
        plain_ms, (s_p, h_p) = once_ms(lambda: wfa.wfa_align_reference(*args, **kw))
        err = max([max_abs_err(s_k, s_p)] + [max_abs_err(a, b) for a, b in zip(h_k, h_p)])
        sp = s_p.cpu().numpy()
        top = int(sp.max(initial=-1)) + 1
        hh = {k: h[: len(qs), :top].cpu().numpy() for k, h in zip(names, h_p)}
        for b, (p, rc) in enumerate(d["jobs"]):
            if sp[b] < 0:
                continue
            items = wfa.backtrace_pair({k: v[b] for k, v in hh.items()}, int(sp[b]), int(ql[b]),
                                       int(tl[b]), d["band"], pobj)
            r = by_pair[tuple(int(x) for x in pairs[p])]
            n_cigars += 1
            if (r.score, r.cigar, r.is_reverse) != (int(sp[b]), items, bool(rc)):
                err = max(err, 1)
        err_w = max(err_w, err)
        del h_p, hh
        ms = cuda_ms(lambda: wfa.wfa_run(*args, **kw), REPS)
        nd = 2 * d["band"] + 1
        stepped = [int(s) if s >= 0 else int(c) for s, c in zip(s_k.tolist(), caps.tolist())]
        cells = sum(x + 1 for x in stepped) * nd
        hist_bytes = sum(h.numel() * 2 for h in h_k)
        b = bound(Q.size + T.size + 12 * len(ql) + hist_bytes, cells * WFA_OPS_PER_CELL)
        plan = wfa.wfa_plan(Q.shape[1], T.shape[1], d["band"], **pen)
        entry = {"shape": {"B": len(ql), "band": d["band"], "smax": d["smax"], "Lq": Q.shape[1],
                           "Lt": T.shape[1]},
                 "steps": max(stepped), "ms": ms, "us_per_step": ms * 1e3 / max(1, max(stepped)),
                 "plain_ms": plain_ms, **b, "max_abs_err": err, "route": plan.route, "staged": plan.staged,
                 "ring_bytes": plan.ring_bytes, "stage_bytes": plan.stage_bytes}
        per_batch.append(entry)
        print(f"wfa batch B={len(ql)} band={d['band']} smax={d['smax']}: max_abs_err={err}; {ms:.4f} ms for "
              f"{max(stepped)} score steps ({entry['us_per_step']:.3f} us a step; bound "
              f"{b['bound_ms']:.4f} ms, {b['bound_by']}); plain {plain_ms:.1f} ms; route {plan.route}"
              f"{' staged' if plan.staged else ''}, rings {plan.ring_bytes} B ({plan.ring_rows} rows), "
              f"staging {plan.stage_bytes} B")
        if err:
            raise AssertionError("the wavefront kernel disagrees with its plain version")
        if first is None:
            first = (args, kw, s_k)
        del h_k, s_k
        torch.cuda.empty_cache()

    # the score-only mode, called as the mesh step calls it, on the first batch
    args, kw, s_full = first
    kw0 = dict(kw, keep_history=False)
    nw_cuda.reset_launch_counts()
    s_o, none = wfa.wfa_align_device(*args, **kw0)
    torch.cuda.synchronize()
    launches_o = nw_cuda.LAUNCHES["wfa_score_only"]
    _s, roll_k = wfa.wfa_run(*args, **kw0)
    plain_o_ms, (s_op, roll_p) = once_ms(lambda: wfa.wfa_align_reference(*args, **kw0))
    err_o = max([max_abs_err(s_o, s_full), max_abs_err(s_o, s_op)]
                + [max_abs_err(a, b) for a, b in zip(roll_k, roll_p)])
    o_ms = cuda_ms(lambda: wfa.wfa_align_device(*args, **kw0), REPS)
    nd = 2 * kw["band"] + 1
    stepped = [int(s) if s >= 0 else int(c) for s, c in zip(s_o.tolist(), args[4].tolist())]
    b_o = bound(args[0].numel() + args[1].numel() + 12 * args[0].shape[0]
                + sum(h.numel() * 2 for h in roll_k), sum(x + 1 for x in stepped) * nd * WFA_OPS_PER_CELL)
    print(f"wfa batches: the {len(per_batch)} launches take {sum(e['ms'] for e in per_batch):.4f} ms (the first "
          f"design's, an earlier tree's run: {EARLIER_MS['wfa_launches']}) | {smi}")
    print(f"wfa score-only (first batch, keep_history=False): launches {launches_o}; scores equal the "
          f"full mode's; max_abs_err={err_o}; {o_ms:.4f} ms, {o_ms * 1e3 / max(1, max(stepped)):.3f} us a step "
          f"(the first design's, an earlier tree's run: {EARLIER_MS['wfa_score_only']}; full mode {per_batch[0]['ms']:.4f}; bound "
          f"{b_o['bound_ms']:.4f}, plain {plain_o_ms:.1f})")
    if err_o or none != {} or launches_o != 1:
        raise AssertionError("the score-only wavefront kernel disagrees")

    # the JAX package's records of a subset
    sub = wfa_subset()
    sal = WfaAligner(make_sequence_set(sub), wcfg, device=dev)
    sub_pairs = np.array([(i, j) for i in range(len(sub)) for j in range(len(sub)) if i != j])
    digest = records_digest(sal.align_pairs(sub_pairs))
    print(f"wfa subset ({len(sub)} sequences, {len(sub_pairs)} pairs): records sha256 {digest} (the JAX "
          f"package's {WFA_SUBSET_SHA256})")
    if digest != WFA_SUBSET_SHA256:
        raise AssertionError("the wavefront route's subset records are not the JAX package's")

    largest = runs["largest"]
    carrier = max(per_batch, key=lambda e: e["steps"])
    occ = wfa.wfa_occupancy(carrier["shape"]["Lq"], carrier["shape"]["Lt"], carrier["shape"]["band"], **pen)
    piece = "two-piece" if pobj.two_piece else "one-piece"
    wfa_name = f"wfa_kernel<{piece}, {occ['route']}{', staged' if occ['staged'] else ''}>"
    return [
        {"name": "nw_walk_runs", "route": "cuda", "source": "seqrush_tpu_torch/ops/csrc/nw_walk.cu",
         "replaces": "seqrush_tpu/ops/nw.py:1199 (_tb_scan_tbw, emit='runs'; XLA)",
         "launches": ctx["launches"]["nw_walk_runs"], "launches_path": "default run",
         "max_abs_err": max(max(e["max_abs_err"] for e in runs.values()), err_syn),
         "ms": largest["ms"], "plain_ms": largest["plain_ms"], "bound_ms": largest["bound_ms"],
         "bound_by": largest["bound_by"], "library_ms": None,
         "regs_per_thread": ptxas_registers(ptxas, "nw_walk_runs_kernel"), "shape": largest["shape"],
         "opcode_walk_ms": largest["opcode_walk_ms"], "split": largest["split"],
         **{k: v for k, v in runs.items() if k != "largest"}, "tolerance": 0},
        {"name": "wfa", "route": "cuda", "source": "seqrush_tpu_torch/ops/csrc/wfa.cu",
         "replaces": "seqrush_tpu/ops/wfa.py:232 (wfa_align_device; XLA)",
         "launches": wl["wfa"], "launches_path": "WfaAligner(kernel='wfa'), 600 headline pairs",
         "max_abs_err": err_w, "ms": carrier["ms"], "plain_ms": carrier["plain_ms"],
         "bound_ms": carrier["bound_ms"], "bound_by": carrier["bound_by"], "library_ms": None,
         "regs_per_thread": ptxas_registers(ptxas, wfa_name),
         **{("plan_route" if k == "route" else k): v for k, v in occ.items()},
         "shape": carrier["shape"], "serial_score_steps": carrier["steps"], "us_per_step": carrier["us_per_step"],
         "batches": per_batch, "launches_ms": sum(e["ms"] for e in per_batch), "cigars_checked": n_cigars,
         "route_wall_s": wall, "tolerance": 0},
        {"name": "wfa_score_only", "route": "cuda", "source": "seqrush_tpu_torch/ops/csrc/wfa.cu",
         "replaces": "seqrush_tpu/ops/wfa.py:232 (wfa_align_device, keep_history=False; XLA)",
         "launches": launches_o, "launches_path": "wfa_align_device(keep_history=False), first batch",
         "max_abs_err": err_o, "ms": o_ms, "plain_ms": plain_o_ms, **b_o, "library_ms": None,
         "regs_per_thread": ptxas_registers(ptxas, wfa_name), "resident_pairs_per_sm": occ["resident_pairs_per_sm"],
         "shape": per_batch[0]["shape"], "serial_score_steps": max(stepped),
         "us_per_step": o_ms * 1e3 / max(1, max(stepped)), "tolerance": 0},
    ]


# the first designs' times at the same shapes, measured by this script on
# the tree before their redesign, on an NVIDIA H100 80GB HBM3 at 700.00 W
# (not in this run): printed beside this run's in the text lines only.  The
# wavefront kernel with its history read back from device memory and a
# byte-wise extension (its 9 launches on the 600 pairs, and the score-only
# mode on the first batch [256, 256 steps]), kernel C with two barriers a
# row at 4 lanes x 256 threads on the rows run's largest chunk [576, R
# 3,584, Wr 1,023], kernel A's int16 mode on the int32 body at the int16
# run's chunk [576, W 512, tmax 7,168], and kernel D reading two or three
# bytes a row from device memory on the rows run's largest chunk
EARLIER_MS = {"wfa_launches": 38.6, "wfa_score_only": 1.6388, "nw_rows_sweep": 10.9157,
              "nw_sweep_int16": 7.6808, "nw_rows_walk": 1.9607}

ROWS_OPS_PER_CELL = 35
ROWS_MIN_OPS_PER_CELL = 10
# the fold's combine, per forward lane of a pair: the backward lanes'
# index, range test and six gathers and selects (17), the six terms' adds and
# minima (14), the per-term minimum over the lanes (6), and the first lane
# reaching it (compare, select, minimum: 18)
COMBINE_OPS_PER_LANE = 55
# the int16 mode as if every instruction of the int32 count ran on two lanes
# of a register (the s16x2 forms)
INT16_OPS_PER_CELL = SWEEP_OPS_PER_CELL / 2
INT16_MIN_OPS_PER_CELL = SWEEP_MIN_OPS_PER_CELL / 2


def run_phase9(smi: str, ptxas: list[str], ctx: dict) -> list[dict]:
    """9. dp_dtype='int16', sweep='rows' and fold on the card.

    9a. the headline's 600 pairs through WfaAligner under each option of
        VARIANTS, launch counters reset just before each run and read just
        after (the option's kernels, VARIANT_KERNELS, must have launched),
        in two rounds in turns with the default configuration (the runner's
        seconds of each); every pair's score must equal the default run's
        (each option is DP-exact).  The records' sha256 and the counters of
        VARIANT_COUNTERS must equal the JAX package's (VARIANT_DIGESTS): on
        the 600 pairs, and for the fold options on wfa_subset()'s 30 pairs,
        run again for that.
    9b. each new kernel and mode against its plain version on the card, on
        9a's own dispatch inputs, exactly, on every distinct chunk that ran
        it: kernel A's int16 mode on the int16 run's chunks (scores, whole
        traceback); kernel A's snapshot mode on the chunks of the fold,
        fold_full and fold_int16 runs (scores, each row's traceback rows 0
        .. t_snap + 1, SNAP, DIAGA, DIAGB), the combine kernel (scores, cursors, crossings) and kernel
        B's start mode from the combine's cursors there;
        kernels C and D on the rows and rows_int16 runs' chunks (scores,
        whole row-major traceback, steps, gap list, counts).  Timed on the
        largest chunk of the int16, fold and rows runs: CUDA-event medians
        of REPS runs after a warm-up, the plain versions once (the
        combine's as CUDA-event medians too); the combine's and its plain
        version's device launches from torch.profiler.
    9c. the int16 run again with the port's nw.INT16_CUTOFF lowered to 300:
        int16_retries > 0, every score the int16 run's.
    Returns the kernels line's entries of the six kernels and modes;
    9a's runs go into ctx['runs'] for phase 10."""
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
    from seqrush_tpu_torch.ops import nw, nw_cuda
    from seqrush_tpu_torch.sequences import make_sequence_set

    dev = torch.device("cuda")
    named, pairs, scores = ctx["named"], ctx["pairs"], ctx["scores"]
    n_pairs = len(pairs)
    seqs = make_sequence_set(named)

    def bound(nbytes, n_ops, n_min=0):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = max(n_ops / ISSUE_OPS_PER_S, n_min / ALU_OPS_PER_S) * 1e3
        return {"bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations"}

    def run_cfg(name, cfg, pairs_=pairs, seqs_=seqs):
        al = WfaAligner(seqs_, RunnerConfig(scores=scores, **cfg), device=dev)
        nw_cuda.reset_launch_counts()
        t0 = time.time()
        res = al.align_pairs(pairs_)
        torch.cuda.synchronize()
        return al, res, time.time() - t0, dict(nw_cuda.LAUNCHES)

    # 9a. each option on the 600 pairs, in turns with the default
    order = ["default", *VARIANTS]
    secs = {k: [] for k in order}
    runs = {}
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            al, res, wall, launches = run_cfg(name, VARIANTS.get(name, {}))
            secs[name].append(round(wall, 4))
            if rnd == 0:
                runs[name] = (al, res, launches)
    ctx["runs"] = runs
    default_scores = {(r.query_idx, r.target_idx): r.score for r in runs["default"][1]}
    for name in VARIANTS:
        al, res, launches = runs[name]
        missing = [k for k in VARIANT_KERNELS[name] if launches[k] <= 0]
        got = {(r.query_idx, r.target_idx): r.score for r in res}
        sub = ""
        if name in VARIANT_ON_SUBSET:
            sub_named = wfa_subset()
            m = len(sub_named)
            sub_pairs = np.array([(i, j) for i in range(m) for j in range(m) if i != j])
            al_d, res_d, _w, _l = run_cfg(name, VARIANTS[name], sub_pairs, make_sequence_set(sub_named))
            sub = " (wfa_subset(), 30 pairs)"
        else:
            al_d, res_d = al, res
        digest = records_digest(res_d)
        counters = {k: al_d.stats[k] for k in VARIANT_COUNTERS}
        want_digest, want_counters = VARIANT_DIGESTS[name]
        kinds = sorted({(d["B"], d["band"], d.get("band_eff", d["band"]), d["fold"], d["rows"], d["int16"],
                         d["emit"]) for d in al.stats["dispatches"] if d["kind"] == "chunk"})
        print(f"option {name} {json.dumps(VARIANTS[name])}: {len(res)} aligned; launches "
              f"{json.dumps({k: launches[k] for k in VARIANT_KERNELS[name]})}; scores equal the default run's "
              f"{got == default_scores}; records{sub} sha256 {digest} (the JAX package's {want_digest}); "
              f"counters {json.dumps(counters)} (the JAX package's {json.dumps(want_counters)}); chunks "
              f"[B, band, band_eff, fold, rows, int16, emit] {json.dumps(kinds)}")
        if (missing or len(res) != n_pairs or got != default_scores or digest != want_digest
                or counters != want_counters):
            raise AssertionError(f"option {name} failed: missing launches {missing}, or records, "
                                 "counters or scores differ")
    print(f"runner seconds in turns ({n_pairs} pairs; default first and last) {json.dumps(secs)} | {smi}")

    # 9b. every chunk each new kernel ran in 9a against its plain version; the
    # primary run's largest chunk of each also timed
    seen = set()

    def chunks_of(tag, names, key):
        """(name, rank, al, d, chunk, host arrays, tmax) of each distinct chunk
        dispatch of the named 9a runs that key selects, each run's largest
        first (rank 0)."""
        for name in names:
            al = runs[name][0]
            ds = sorted((d for d in al.stats["dispatches"] if d["kind"] == "chunk" and key(d)),
                        key=lambda d: -(d["B"] * d["tmax"] * d["band"]))
            for rank, d in enumerate(ds):
                sig = (tag, d["band"], d["int16"], tuple(tuple(j) for j in d["jobs"]))
                if sig in seen:
                    continue
                seen.add(sig)
                chunk = []
                for p, rc in d["jobs"]:
                    qi, tj = pairs[p]
                    chunk.append((p, bool(rc), d["band"], False, (al.rc_codes[qi] if rc else al.codes[qi]),
                                  al.codes[tj]))
                Q, T, ql, tl, tmax = al.pack_chunk(chunk)
                yield name, rank, al, d, chunk, (Q, T, ql, tl), tmax

    pen = ctx["pen"]
    out = {}
    checked = {k: [] for k in ("nw_sweep_int16", "nw_sweep_snapshot", "nw_walk_start", "nw_rows_sweep",
                               "nw_rows_walk", "fold_combine")}

    def cuda_launches(fn):
        """Device launches of fn() from torch.profiler's device events (None
        where it does not trace the card)."""
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA) or None
        except Exception as exc:  # noqa: BLE001 - a measurement that is not there is reported as such
            print(f"  the profiler did not count the launches: {exc!r}")
            return None

    # kernel A, int16 mode: every int16 chunk of the int16 run
    for name, rank, al, d, _chunk, arrays, tmax in chunks_of("int16", ("int16",), lambda d: d["int16"]):
        Q, T, ql, tl = (torch.from_numpy(a).to(dev) for a in arrays)
        W = d["band"] + 1
        kw = dict(band=d["band"], tmax=tmax, int16=True, **pen)
        s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
        plain_ms, (s_p, tb_p) = once_ms(lambda: nw_cuda.nw_align_reference(Q, T, ql, tl, **kw))
        err = max(max_abs_err(s_k, s_p), max_abs_err(tb_k, tb_p))
        del tb_p
        checked["nw_sweep_int16"].append([Q.shape[0], W, tmax, err])
        print(f"kernel A int16 mode, {name} chunk [B {Q.shape[0]}, W {W}, tmax {tmax}]: max_abs_err={err}")
        if err:
            raise AssertionError("kernel A's int16 mode disagrees with its plain version")
        if rank == 0:
            B_, Lq, Lt = Q.shape[0], Q.shape[1], T.shape[1]
            plan = nw_cuda.plan_sweep_i16(B_, W, Lq, Lt)
            body = nw_cuda.plan_sweep(B_, W, Lq, Lt)
            # in turns: the packed sweep (the planner's), the int32 mode, the
            # int32 body's int16 mode (the earlier design, still built for
            # the dispatches the planner gives it), the packed sweep again
            ms = cuda_ms(lambda: nw_cuda.nw_align(Q, T, ql, tl, **kw), REPS)
            int32_ms = cuda_ms(lambda: nw_cuda.nw_align(Q, T, ql, tl, **dict(kw, int16=False)), REPS)
            body_ms = cuda_ms(lambda: nw_cuda.sweep_launch(Q, T, ql, tl, body, **kw), REPS)
            ms2 = cuda_ms(lambda: nw_cuda.nw_align(Q, T, ql, tl, **kw), REPS)
            cells = int((ql + tl).to(torch.int64).sum().item()) * W
            b = bound(Q.numel() + T.numel() + 12 * B_ + tb_k.numel(), cells * INT16_OPS_PER_CELL,
                      cells * INT16_MIN_OPS_PER_CELL)
            b32 = bound(Q.numel() + T.numel() + 12 * B_ + tb_k.numel(), cells * SWEEP_OPS_PER_CELL,
                        cells * SWEEP_MIN_OPS_PER_CELL)
            occ = nw_cuda.sweep_occupancy(plan, W, pen["o2"] >= 0)
            name = (f"nw_sweep_i16<{plan.lanes}, two-piece, traceback>" if plan.route == "twins"
                    else f"nw_sweep_regs<{plan.lanes}, two-piece, traceback>")
            out["nw_sweep_int16"] = {
                "shape": {"B": B_, "W": W, "tmax": tmax}, "ms": ms, "ms_again": ms2, "plain_ms": plain_ms,
                "int32_ms": int32_ms, "int32_body_int16_ms": body_ms, **b, "int32_bound_ms": b32["bound_ms"],
                "max_abs_err": err, "launches": runs["int16"][2]["nw_sweep_int16"],
                "launches_path": "dp_dtype='int16'", "plan_route": plan.route, "lanes_per_thread": plan.lanes,
                "warps_per_twin": plan.warps_per_pair, "regs_per_thread": occ["regs_per_thread"],
                "ptxas": ptxas_registers(ptxas, name), "spill_bytes": ptxas_spills(ptxas, name),
                "local_bytes_per_thread": occ.get("local_bytes_per_thread"),
                "resident_twins_per_sm": occ.get("resident_twins_per_sm"),
                **({k: v for k, v in nw_cuda.twins_reckoning(plan, B_, occ["resident_blocks_per_sm"]).items()
                    if k != "resident_blocks_per_sm"} if plan.route == "twins" else {})}
            print(f"  timed: {ms:.4f} / {ms2:.4f} ms, {plan.route} {plan.lanes} lanes x {plan.warps_per_pair} warps, "
                  f"{occ['regs_per_thread']} registers, {occ.get('local_bytes_per_thread')} local bytes, "
                  f"{occ.get('resident_twins_per_sm')} twins an SM (the first design's, an earlier tree's run: "
                  f"{EARLIER_MS['nw_sweep_int16']}; the int32 body's int16 mode in this run {body_ms:.4f}; "
                  f"int32 mode {int32_ms:.4f}; bound {b['bound_ms']:.4f} at the packed s16x2 rate, the int32 "
                  f"mode's {b32['bound_ms']:.4f}; plain {plain_ms:.1f}) | {smi}")
        del tb_k
        torch.cuda.empty_cache()

    # kernel A snapshot mode, the combine, kernel B start mode: every fold chunk
    for name, rank, al, d, chunk, arrays, _tmax in chunks_of("fold", ("fold", "fold_full", "fold_int16"),
                                                             lambda d: d["fold"]):
        Qr, Tr = al.pack_fold_rows(chunk, arrays[0], arrays[1])
        Q, T, Qr, Tr, ql, tl = (torch.from_numpy(a).to(dev) for a in (arrays[0], arrays[1], Qr, Tr, *arrays[2:]))
        band, tmax_half, int16 = d["band_eff"], d["tmax_half"], d["int16"]
        Q2, T2 = torch.cat([Q, Qr]), torch.cat([T, Tr])
        ql2, tl2 = torch.cat([ql, ql]), torch.cat([tl, tl])
        fin = ql + tl
        tm = torch.div(fin + 1, 2, rounding_mode="floor")
        t_snap = torch.cat([tm, fin - tm]).to(torch.int32)
        kw = dict(band=band, tmax=tmax_half, t_snap=t_snap, int16=int16, **pen)
        s_k, tb_k, snaps_k = nw_cuda.nw_align(Q2, T2, ql2, tl2, **kw)
        plain_ms, (s_p, tb_p, snaps_p) = once_ms(lambda: nw_cuda.nw_align_reference(Q2, T2, ql2, tl2, **kw))
        err = max([max_abs_err(s_k, s_p), snapshot_rows_err(tb_k, tb_p, t_snap, tmax_half)]
                  + [max_abs_err(a, b) for a, b in zip(snaps_k, snaps_p)])
        del tb_p, snaps_p
        SNAP, DIAGA, DIAGB = snaps_k
        combine = dict(o1=pen["o1"], o2=pen["o2"], band=band)
        fold_s, state, cross_m = nw_cuda.fold_combine(SNAP, DIAGA, DIAGB, ql, tl, **combine)
        plain_c_ms, want = once_ms(lambda: nw_cuda.fold_combine_reference(SNAP, DIAGA, DIAGB, ql, tl, **combine))
        err_c = max(max_abs_err(a, b) for a, b in zip((fold_s, state, cross_m), want))
        checked["fold_combine"].append([ql.shape[0], band + 1, int(int16), err_c])
        if err_c:
            raise AssertionError(f"the fold's combine kernel disagrees with its plain version ({name} chunk)")
        ops_k = nw_cuda.nw_walk_start(tb_k, state, band=band, tmax=tmax_half)
        plain_w_ms, ops_p = once_ms(lambda: nw_cuda.nw_walk_start_reference(tb_k, state, band=band,
                                                                            tmax=tmax_half))
        err_w = max_abs_err(ops_k, ops_p)
        n_rows, W = Q2.shape[0], band + 1
        checked["nw_sweep_snapshot"].append([n_rows, W, tmax_half, int(int16), err])
        checked["nw_walk_start"].append([n_rows, W, tmax_half, int(int16), err_w])
        print(f"kernel A snapshot mode and kernel B start mode, {name} chunk [{n_rows} rows, W {W}, tmax_half "
              f"{tmax_half}, int16 {int16}]: max_abs_err={err} / {err_w}")
        if err or err_w:
            raise AssertionError("kernel A's snapshot mode or kernel B's start mode disagrees with its plain version")
        if name == "fold" and rank == 0:
            ms = cuda_ms(lambda: nw_cuda.nw_align(Q2, T2, ql2, tl2, **kw), REPS)
            plain_sweep_ms = cuda_ms(lambda: nw_cuda.nw_align(Q2, T2, ql2, tl2, **dict(kw, t_snap=None)), REPS)
            # the half sweeps need the anti-diagonals up to t_snap + 1 (DIAGB) of each row
            cells = int(torch.clamp(t_snap.to(torch.int64) + 1, max=tmax_half).sum().item()) * W
            b = bound(Q2.numel() + T2.numel() + 12 * n_rows + cells + 4 * n_rows + 8 * 4 * n_rows * W,
                      cells * SWEEP_OPS_PER_CELL, cells * SWEEP_MIN_OPS_PER_CELL)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            plan = nw_cuda.plan_sweep(n_rows, W, Q2.shape[1], T2.shape[1])
            occ = nw_cuda.sweep_occupancy(plan, W, pen["o2"] >= 0, snapshot=True)
            kname = f"nw_sweep_regs_snap<{plan.lanes}, two-piece>"
            out["nw_sweep_snapshot"] = {
                "shape": {"B": n_rows, "W": W, "tmax": tmax_half}, "ms": ms, "plain_ms": plain_ms,
                "no_snapshot_ms": plain_sweep_ms, **b, "max_abs_err": err,
                "launches": runs["fold"][2]["nw_sweep_snapshot"], "launches_path": "fold=True",
                "ptxas": ptxas_registers(ptxas, kname), "spill_bytes": ptxas_spills(ptxas, kname),
                "lanes_per_thread": plan.lanes,
                "regs_per_thread": occ["regs_per_thread"], "resident_pairs_per_sm": occ["resident_pairs_per_sm"],
                "rounds": nw_cuda.snap_rounds(n_rows, occ["resident_pairs_per_sm"], sms)}
            print(f"  snapshot sweep timed: {ms:.4f} ms (without snapshots {plain_sweep_ms:.4f}; bound "
                  f"{b['bound_ms']:.4f} for the {cells} cells up to t_snap + 1; plain {plain_ms:.1f}; "
                  f"{occ['regs_per_thread']} registers at {plan.lanes} lanes, {occ['resident_pairs_per_sm']} "
                  f"pairs an SM, {out['nw_sweep_snapshot']['rounds']} rounds) | {smi}")
            # in turns: the plain version, the kernel, the kernel, the plain version
            plain_cs = [cuda_ms(lambda: nw_cuda.fold_combine_reference(SNAP, DIAGA, DIAGB, ql, tl, **combine),
                                REPS)]
            combine_mss = [cuda_ms(lambda: nw_cuda.fold_combine(SNAP, DIAGA, DIAGB, ql, tl, **combine), REPS)
                           for _ in range(2)]
            plain_cs.append(cuda_ms(lambda: nw_cuda.fold_combine_reference(SNAP, DIAGA, DIAGB, ql, tl, **combine),
                                    REPS))
            combine_ms = statistics.median(combine_mss)
            # the kernel's own device time: a call's CUDA-event time above
            # also holds the host's time to issue it
            combine_dev_ms = device_ms(lambda: nw_cuda.fold_combine(SNAP, DIAGA, DIAGB, ql, tl, **combine),
                                       "fold_combine_kernel", REPS)
            combine_launches = cuda_launches(lambda: nw_cuda.fold_combine(SNAP, DIAGA, DIAGB, ql, tl, **combine))
            plain_launches = cuda_launches(
                lambda: nw_cuda.fold_combine_reference(SNAP, DIAGA, DIAGB, ql, tl, **combine))
            if combine_launches not in (None, 1):
                raise AssertionError(f"the combine took {combine_launches} launches")
            # the combine reads 12 [B, W] int32 planes (the forward rows' six
            # snapshot planes, the backward rows' four gap planes, DIAGA and
            # DIAGB) and the lengths, and writes the scores, the cursors
            # [4, 2B] and cross_m
            n_pairs = ql.shape[0]
            cb = bound(12 * n_pairs * W * 4 + 8 * n_pairs + 4 * n_pairs + 32 * n_pairs + n_pairs,
                       n_pairs * W * COMBINE_OPS_PER_LANE)
            ms_w = cuda_ms(lambda: nw_cuda.nw_walk_start(tb_k, state, band=band, tmax=tmax_half), REPS)
            wb_b, wb_o = walk_bounds(ops_k)
            wb = {"bound_ms": max(wb_b, wb_o), "bound_by": "bytes" if wb_b >= wb_o else "operations"}
            out["nw_walk_start"] = {
                "shape": {"B": n_rows, "W": W, "tmax": tmax_half}, "ms": ms_w, "plain_ms": plain_w_ms, **wb,
                "max_abs_err": err_w, "launches": runs["fold"][2]["nw_walk_start"], "launches_path": "fold=True",
                "ptxas": ptxas_registers(ptxas, "nw_walk_seg_kernel")}
            out["fold_combine"] = {
                "shape": {"B": n_pairs, "W": W}, "ms": combine_ms, "ms_runs": combine_mss,
                "device_ms": combine_dev_ms,
                "plain_ms": statistics.median(plain_cs), "plain_ms_runs": plain_cs, **cb, "max_abs_err": err_c,
                "launches": runs["fold"][2]["fold_combine"], "launches_path": "fold=True, one a fold chunk",
                "cuda_launches_per_call": combine_launches, "plain_cuda_launches_per_call": plain_launches,
                "plain_once_ms": plain_c_ms, "ptxas": ptxas_registers(ptxas, "fold_combine_kernel")}
            print(f"  start walk timed: {ms_w:.4f} ms (bound {wb['bound_ms']:.5f}; plain {plain_w_ms:.1f}); the "
                  f"combine between them {combine_ms:.4f} ms in {combine_launches} CUDA launches (runs "
                  f"{json.dumps(combine_mss)}, {combine_dev_ms} ms on the device; bound {cb['bound_ms']:.5f}, "
                  f"{cb['bound_by']}; the plain version "
                  f"{json.dumps(plain_cs)} ms in {plain_launches} launches; "
                  f"{out['fold_combine']['ptxas']} registers) | {smi}")
        del tb_k, snaps_k, SNAP, DIAGA, DIAGB
        torch.cuda.empty_cache()

    # kernels C and D: every rows chunk
    for name, rank, al, d, _chunk, arrays, _tmax in chunks_of("rows", ("rows", "rows_int16"), lambda d: d["rows"]):
        Q, T, ql, tl = (torch.from_numpy(a).to(dev) for a in arrays)
        kw = dict(band=d["band"], int16=d["int16"], **pen)
        s_k, tb_k = nw_cuda.nw_align_rows(Q, T, ql, tl, **kw)
        plain_c_ms, (s_p, tb_p) = once_ms(lambda: nw_cuda.nw_align_rows_reference(Q, T, ql, tl, **kw))
        err_c = max(max_abs_err(s_k, s_p), max_abs_err(tb_k, tb_p))
        del tb_p
        walk_k = nw_cuda.nw_walk_rows(tb_k, ql, tl, band=d["band"])
        plain_d_ms, walk_p = once_ms(lambda: nw_cuda.nw_walk_rows_reference(tb_k, ql, tl, band=d["band"]))
        err_d = max(max_abs_err(a, b) for a, b in zip(walk_k, walk_p))
        Wr = 2 * d["band"] + 1
        S, threads = nw_cuda.rows_plan(Wr)
        checked["nw_rows_sweep"].append([Q.shape[0], Wr, S, threads, int(d["int16"]), err_c])
        checked["nw_rows_walk"].append([Q.shape[0], Wr, int(d["int16"]), err_d])
        print(f"kernels C and D, {name} chunk [B {Q.shape[0]}, R {Q.shape[1]}, Wr {Wr}, {S} lanes x {threads} "
              f"threads, int16 {d['int16']}]: max_abs_err {err_c} / {err_d}")
        if err_c or err_d:
            raise AssertionError("kernel C or D disagrees with its plain version")
        if name == "rows" and rank == 0:
            occ = nw_cuda.nw_rows_occupancy(Q.shape[1], d["band"], pen["o2"] >= 0, d["int16"])
            print(f"  kernel C's plan: {S} lanes x {threads} threads a pair, rows staged {occ['window_rows']} at a "
                  f"time of {Q.shape[1]}, {occ['regs_per_thread']} registers, "
                  f"{occ['resident_pairs_per_sm']} pairs resident an SM (reckoned {occ['reckoned_pairs_per_sm']}; "
                  f"{Q.shape[0]} pairs on {torch.cuda.get_device_properties(0).multi_processor_count} SMs)")
            ms_c = cuda_ms(lambda: nw_cuda.nw_align_rows(Q, T, ql, tl, **kw), REPS)
            ms_d = cuda_ms(lambda: nw_cuda.nw_walk_rows(tb_k, ql, tl, band=d["band"]), REPS)
            # beside it kernel D's own time from the profiler: about 0.1 ms,
            # near the host's time to issue a call, which cuda_ms counts too
            dev_d_ms = device_ms(lambda: nw_cuda.nw_walk_rows(tb_k, ql, tl, band=d["band"]),
                                 "nw_rows_walk_kernel", REPS)
            occ_d = nw_cuda.rows_walk_occupancy(min(nw.GAP_MAX, Q.shape[1] + 1))
            cells = int((ql.to(torch.int64) + 1).sum().item()) * Wr
            b_c = bound(Q.numel() + T.numel() + 12 * Q.shape[0] + tb_k.numel(), cells * ROWS_OPS_PER_CELL,
                        cells * ROWS_MIN_OPS_PER_CELL)
            steps = int((ql.to(torch.int64) + 1).sum().item())
            b_d = bound(2 * steps + walk_k[0].numel() + 4 * walk_k[1].numel() + 12 * Q.shape[0],
                        steps * WALK_OPS_PER_STEP)
            shape = {"B": Q.shape[0], "R": Q.shape[1], "Wr": Wr, "lanes_per_thread": S, "threads": threads}
            most, blocks = nw_cuda.rows_bounds(S, threads)
            out["nw_rows_sweep"] = {
                "shape": shape, "ms": ms_c, "plain_ms": plain_c_ms, **b_c, "max_abs_err": err_c,
                "launches": runs["rows"][2]["nw_rows_sweep"], "launches_path": "sweep='rows'",
                "us_per_row": ms_c * 1e3 / Q.shape[1], "window_rows": occ["window_rows"],
                **{k: occ[k] for k in ("regs_per_thread", "resident_pairs_per_sm", "reckoned_pairs_per_sm")},
                "ptxas": ptxas_registers(ptxas, f"nw_rows_sweep_kernel<{S}, two-piece, int32, {most} threads, "
                                                f"{blocks} blocks>")}
            out["nw_rows_walk"] = {
                "shape": shape, "ms": ms_d, "device_ms": dev_d_ms, "plain_ms": plain_d_ms, **b_d, "max_abs_err": err_d,
                "launches": runs["rows"][2]["nw_rows_walk"], "launches_path": "sweep='rows'",
                "gap_lists_over_gap_max": int((walk_k[3] > nw.GAP_MAX).sum()),
                "ptxas": ptxas_registers(ptxas, "nw_rows_walk_kernel"),
                "spill_bytes": ptxas_spills(ptxas, "nw_rows_walk_kernel"),
                **{k: occ_d[k] for k in ("regs_per_thread", "local_bytes_per_thread", "smem_per_block",
                                         "resident_pairs_per_sm", "reckoned_pairs_per_sm")}}
            print(f"  timed: sweep {ms_c:.4f} ms, {ms_c * 1e3 / Q.shape[1]:.4f} us a row (the first design's, an "
                  f"earlier tree's run: {EARLIER_MS['nw_rows_sweep']}; bound {b_c['bound_ms']:.4f}, plain {plain_c_ms:.1f}); walk "
                  f"{ms_d:.4f} ms a call, {dev_d_ms} on the device (the first design's, an earlier tree's run: "
                  f"{EARLIER_MS['nw_rows_walk']}; bound "
                  f"{b_d['bound_ms']:.5f}, plain {plain_d_ms:.1f}; {occ_d['regs_per_thread']} registers, "
                  f"{occ_d['local_bytes_per_thread']} local bytes, {occ_d['resident_pairs_per_sm']} pairs an SM, "
                  f"reckoned {occ_d['reckoned_pairs_per_sm']}) | {smi}")
        del tb_k, walk_k, walk_p
        torch.cuda.empty_cache()
    print(f"9b chunks held to their plain versions {json.dumps(checked)}")
    for k, v in out.items():
        v["chunks_checked"] = checked[k]

    # 9c. int16 retries on the card
    saved = nw.INT16_CUTOFF
    nw.INT16_CUTOFF = 300
    try:
        al_r, res_r, wall_r, launches_r = run_cfg("int16", VARIANTS["int16"])
    finally:
        nw.INT16_CUTOFF = saved
    retries = al_r.stats["int16_retries"]
    int16_scores = {(r.query_idx, r.target_idx): r.score for r in runs["int16"][1]}
    same = {(r.query_idx, r.target_idx): r.score for r in res_r} == int16_scores
    int32_chunks = sum(1 for d in al_r.stats["dispatches"] if d["kind"] == "chunk" and not d["int16"])
    print(f"int16 with INT16_CUTOFF 300: int16_retries {retries} in {int32_chunks} int32 chunks; scores equal "
          f"the int16 run's {same}; records equal {records_digest(res_r) == records_digest(runs['int16'][1])}; "
          f"launches {json.dumps({k: launches_r[k] for k in ('nw_sweep_int16', 'nw_sweep')})}; {wall_r:.3f} s")
    if retries <= 0 or not same or launches_r["nw_sweep"] <= 0:
        raise AssertionError("the forced int16 retries did not re-run in int32")

    src = {"nw_sweep_int16": "seqrush_tpu_torch/ops/csrc/nw_sweep_i16.cu",
           "nw_sweep_snapshot": "seqrush_tpu_torch/ops/csrc/nw_sweep_snap.cu",
           "nw_walk_start": "seqrush_tpu_torch/ops/csrc/nw_walk.cu",
           "nw_rows_sweep": "seqrush_tpu_torch/ops/csrc/nw_rows.cu",
           "nw_rows_walk": "seqrush_tpu_torch/ops/csrc/nw_rows.cu",
           "fold_combine": "seqrush_tpu_torch/ops/csrc/fold_combine.cu"}
    replaces = {"nw_sweep_int16": "seqrush_tpu/ops/nw.py:275 (_sweep_v3, dtype=int16; XLA)",
                "nw_sweep_snapshot": "seqrush_tpu/ops/nw.py:275 (_sweep_v3, t_snap; XLA; nw_align_fold :1678)",
                "nw_walk_start": "seqrush_tpu/ops/nw.py:1199 (_tb_scan_tbw, start; XLA)",
                "nw_rows_sweep": "seqrush_tpu/ops/nw.py:1877 (_sweep_rows; XLA)",
                "nw_rows_walk": "seqrush_tpu/ops/nw.py:2021 (_tb_rows_scan; XLA)",
                "fold_combine": "seqrush_tpu/ops/nw.py:1720"}
    return [{"name": k, "route": "cuda", "source": src[k], "replaces": replaces[k], "library_ms": None,
             **v, "tolerance": 0} for k, v in out.items()]



def run_phase10(smi: str, ptxas: list[str], ctx: dict) -> list[dict]:
    """10. band_tiling='auto' on the card.

    10a. the headline's 600 pairs through WfaAligner with wide_route='full',
         untiled and tiled (VARIANTS['tiled']), in turns (untiled, tiled,
         tiled, untiled; the runner's seconds of each): the tiled run must
         launch both tiled modes in at least one tiled chunk, and its records
         must equal the untiled run's (each pair at its own band either way).
    10b. kernel A's tiled mode and kernel B's tiled runs mode against their
         plain versions on every distinct tiled chunk of phase 9's tiled and
         tiled_int16 runs, exactly: scores, the tile-row traceback on every
         row the tiled mode promises (each pair's rows 0 .. min(tmax,
         t_final + 2), nw_cuda.tiled_promised_rows; its register route
         leaves the later rows unwritten and the walk starts at t_final),
         and tokens and counts.  On the tiled run's first chunk the
         tiled sweep's registers, spills and resident blocks an SM, and
         CUDA-event medians of the tiled sweep (and of the tiled_int16
         chunk's) and walk behind a spin of the card (spun_ms; the walk with
         its registers and its phase split from its own timer), and of the
         same pairs split as the untiled runner splits them (the narrow jobs
         at their band, the wide ones at theirs: sweep and runs walk of
         each), the two in turns (split, tiled, tiled, split); the plain
         versions once.
    Returns the kernels line's entries of the two tiled modes."""
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner, _TiledChunk
    from seqrush_tpu_torch.ops import nw, nw_cuda
    from seqrush_tpu_torch.sequences import make_sequence_set

    t_phase = time.time()
    dev = torch.device("cuda")
    named, pairs, scores, pen, runs = ctx["named"], ctx["pairs"], ctx["scores"], ctx["pen"], ctx["runs"]
    seqs = make_sequence_set(named)

    def bound(nbytes, n_ops_ms):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return {"bound_ms": max(b_ms, n_ops_ms), "bound_by": "bytes" if b_ms >= n_ops_ms else "operations"}

    # 10a. the runner, untiled and tiled, in turns
    secs = {"untiled": [], "tiled": []}
    host = {"untiled": [], "tiled": []}  # the runner's host timers of each run
    got = {}
    for name in ("untiled", "tiled", "tiled", "untiled"):
        cfg = VARIANTS["tiled"] if name == "tiled" else {"wide_route": "full"}
        al = WfaAligner(seqs, RunnerConfig(scores=scores, **cfg), device=dev)
        nw_cuda.reset_launch_counts()
        t0 = time.time()
        res = al.align_pairs(pairs)
        torch.cuda.synchronize()
        secs[name].append(round(time.time() - t0, 4))
        host[name].append({k: round(al.stats[k], 4) for k in ("orient_s", "dispatch_s", "collect_s")})
        got.setdefault(name, (al, records_digest(res), dict(nw_cuda.LAUNCHES)))
    al_t, digest_t, launches_t = got["tiled"]
    shapes = [[d["B"], d["band"], d["band_wide"], d["n_tiles"], d["n_wide"], d["tmax"]]
              for d in al_t.stats["dispatches"] if d["kind"] == "tiled"]
    print(f"band tiling, 600 pairs, wide_route='full': tiled_chunks {al_t.stats['tiled_chunks']}, tiled_rows "
          f"{al_t.stats['tiled_rows']}, tiled chunks [B, band, band_wide, n_tiles, n_wide, tmax] "
          f"{json.dumps(shapes)}; launches {json.dumps({k: launches_t[k] for k in VARIANT_KERNELS['tiled']})}; "
          f"records equal the untiled run's {digest_t == got['untiled'][1]}; runner seconds in turns "
          f"{json.dumps(secs)}, their orient/dispatch/collect seconds {json.dumps(host)} | {smi}")
    if (digest_t != got["untiled"][1] or al_t.stats["tiled_chunks"] < 1
            or min(launches_t[k] for k in VARIANT_KERNELS["tiled"]) < 1):
        raise AssertionError("the tiled run did not launch its kernels or differs from the untiled run")

    # 10b. every distinct tiled chunk against the plain versions; the first timed
    seen, checked, out = set(), [], {}
    for name in ("tiled", "tiled_int16"):
        al = runs[name][0]
        for d in (d for d in al.stats["dispatches"] if d["kind"] == "tiled"):
            sig = (d["band"], d["n_tiles"], d["int16"], tuple(tuple(j) for j in d["jobs"]))
            if sig in seen:
                continue
            seen.add(sig)
            n_narrow = len(d["jobs"]) - d["n_wide"]
            entries = []
            for k, (p, rc) in enumerate(d["jobs"]):
                qi, tj = pairs[p]
                entries.append((p, bool(rc), d["band"] if k < n_narrow else d["band_wide"], not d["int16"],
                                al.rc_codes[qi] if rc else al.codes[qi], al.codes[tj]))
            chunk = _TiledChunk(entries, d["band"], d["band_wide"], d["n_tiles"])
            Q, T, ql, tl, tile, wide, _rowmap, tmax = al.pack_tiled_chunk(chunk)
            Qd, Td, qd, td = (torch.from_numpy(a).to(dev) for a in (Q, T, ql, tl))
            lay = dict(band=d["band"], n_tiles=d["n_tiles"], tmax=tmax)
            kw = dict(int16=d["int16"], **lay, **pen)
            s_k, tb_k = nw_cuda.nw_align_tiled(Qd, Td, qd, td, tile, wide, **kw)
            plain_ms, (s_p, tb_p) = once_ms(lambda: nw_cuda.nw_align_tiled_reference(Qd, Td, qd, td, tile, wide,
                                                                                      **kw))
            # the rows the tiled mode promises: each pair's 0 .. min(tmax, t_final + 2)
            keep = nw_cuda.tiled_promised_rows(qd, td, tile, wide, d["n_tiles"], tmax, tb_k.shape[1])
            err = max(max_abs_err(s_k, s_p), masked_rows_err(tb_k, tb_p, keep))
            wk = dict(run_max=nw.RUN_MAX, **lay)
            tok_k, cnt_k = nw_cuda.nw_walk_runs_tiled(tb_k, qd, td, tile, wide, **wk)
            plain_w_ms, (tok_p, cnt_p) = once_ms(
                lambda: nw_cuda.nw_walk_runs_tiled_reference(tb_k, qd, td, tile, wide, **wk))
            err_w = max(max_abs_err(tok_k, tok_p), max_abs_err(cnt_k, cnt_p))
            del tb_p
            W = d["band"] + 1
            plan = nw_cuda.plan_sweep_tiled(n_narrow, d["n_wide"], W, d["n_tiles"], Q.shape[1], T.shape[1])
            checked.append([name, Q.shape[0], W, d["n_tiles"], d["n_wide"], tmax, int(d["int16"]), plan.route,
                            plan.lanes, err, err_w])
            print(f"tiled kernels, {name} chunk [{Q.shape[0]} rows, W {W}, {d['n_tiles']} tiles, {d['n_wide']} wide "
                  f"pairs, tmax {tmax}, int16 {d['int16']}; {plan.route} route, {plan.lanes} lanes x "
                  f"{plan.threads} threads]: max_abs_err {err} / {err_w}")
            if err or err_w:
                raise AssertionError("a tiled kernel disagrees with its plain version")
            if name == "tiled" and not out:
                first = torch.from_numpy(tile == 0).to(dev)
                lanes = torch.from_numpy(np.where(tile == 0, np.where(wide, d["n_tiles"] * W, W), 0)).to(dev)
                narrow = [e for e in chunk if e[2] == d["band"]]
                wides = [e for e in chunk if e[2] != d["band"]]
                split = []  # the untiled runner's two launches of the same pairs
                for part in (narrow, wides):
                    Qs, Ts, qs_, ts_, tmax_s = al.pack_chunk(part)
                    split.append((*(torch.from_numpy(a).to(dev) for a in (Qs, Ts, qs_, ts_)), part[0][2], tmax_s))

                def run_tiled():
                    _s, tb = nw_cuda.nw_align_tiled(Qd, Td, qd, td, tile, wide, **kw)
                    nw_cuda.nw_walk_runs_tiled(tb, qd, td, tile, wide, **wk)

                def run_split():
                    for Qs, Ts, qs_, ts_, band_s, tmax_s in split:
                        _s, tb = nw_cuda.nw_align(Qs, Ts, qs_, ts_, band=band_s, tmax=tmax_s, **pen)
                        nw_cuda.nw_walk_runs(tb, qs_, ts_, band=band_s, tmax=tmax_s, run_max=nw.RUN_MAX)

                turns = {"split": [], "tiled": []}
                for which in ("split", "tiled", "tiled", "split"):
                    turns[which].append(cuda_ms(run_tiled if which == "tiled" else run_split, REPS))
                ms = spun_ms(lambda: nw_cuda.nw_align_tiled(Qd, Td, qd, td, tile, wide, **kw), REPS)
                occ = nw_cuda.tiled_occupancy(plan, pen["o2"] >= 0, W) if plan.route == "regs" else None
                ms_w = spun_ms(lambda: nw_cuda.nw_walk_runs_tiled(tb_k, qd, td, tile, wide, **wk), REPS)
                tok_t, cnt_t, wsplit = nw_cuda.walk_runs_split(tb_k, qd, td, band=d["band"], tmax=tmax,
                                                               run_max=nw.RUN_MAX, tiled=(tile, wide, d["n_tiles"]))
                if max_abs_err(tok_t, tok_k) or max_abs_err(cnt_t, cnt_k):
                    raise AssertionError("the timed tiled walk differs from the tiled walk")
                del tok_t, cnt_t
                split_parts = []  # [B, W, sweep ms, runs walk ms] of each untiled launch
                for Qs, Ts, qs_, ts_, band_s, tmax_s in split:
                    _s, tb_s = nw_cuda.nw_align(Qs, Ts, qs_, ts_, band=band_s, tmax=tmax_s, **pen)
                    split_parts.append([int(Qs.shape[0]), band_s + 1, cuda_ms(
                        lambda: nw_cuda.nw_align(Qs, Ts, qs_, ts_, band=band_s, tmax=tmax_s, **pen), REPS), cuda_ms(
                        lambda: nw_cuda.nw_walk_runs(tb_s, qs_, ts_, band=band_s, tmax=tmax_s, run_max=nw.RUN_MAX),
                        REPS)])
                    del tb_s
                # the traceback bytes the launch must write: the rows it promises
                sb, so = sweep_bounds(Qd, Td, qd, td, lanes, int(keep.sum().item()) * W)
                steps = int(((tok_k >> 2) * (tok_k > 0)).sum().item())
                B = Qd.shape[0]
                wb = bound(steps + 4 * tok_k.numel() + 12 * B, steps * WALK_OPS_PER_STEP / ISSUE_OPS_PER_S * 1e3)
                shape = {"B": B, "W": W, "n_tiles": d["n_tiles"], "n_wide": d["n_wide"], "tmax": tmax,
                         "lanes_per_thread": plan.lanes, "threads": plan.threads, "route": plan.route}
                common = {"shape": shape, "launches_path": "band_tiling='auto', wide_route='full'",
                          "sweep_walk_ms_in_turns": turns}
                out["nw_sweep_tiled"] = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": max(sb, so),
                    "bound_by": "bytes" if sb >= so else "operations", "max_abs_err": err,
                    "launches": launches_t["nw_sweep_tiled"], "split_ms": split_parts,
                    "ptxas": ptxas_registers(ptxas, f"nw_sweep_tiled_regs<{plan.lanes}, two-piece>"),
                    "ptxas_line": next((x for x in ptxas if x.startswith(f"nw_sweep_tiled_regs<{plan.lanes}, two-piece>:")),
                                       None), "occupancy": occ, **common}
                out["nw_walk_runs_tiled"] = {
                    "ms": ms_w, "plain_ms": plain_w_ms, **wb, "max_abs_err": err_w,
                    "launches": launches_t["nw_walk_runs_tiled"],
                    "ptxas": ptxas_registers(ptxas, "nw_walk_runs_tiled_kernel"),
                    "split": walk_split_summary(wsplit), **common}
                print(f"  tiled sweep's kernel: {out['nw_sweep_tiled']['ptxas_line']}; occupancy {json.dumps(occ)} "
                      f"| {smi}")
                print(f"  timed: tiled sweep {ms:.4f} ms (bound {max(sb, so):.4f}; plain {plain_ms:.1f}), tiled walk "
                      f"{ms_w:.4f} ms (bound {wb['bound_ms']:.5f}; plain {plain_w_ms:.1f}; "
                      f"{out['nw_walk_runs_tiled']['ptxas']} registers); the same pairs split "
                      f"[B, W, sweep ms, walk ms] {json.dumps(split_parts)}; sweep + walk in turns (split, tiled, tiled, "
                      f"split) {json.dumps(turns)} | {smi}")
                print(f"  the tiled walk's phase split (SM cycles a walked pair, and each phase's count): "
                      f"{json.dumps(out['nw_walk_runs_tiled']['split'])} | {smi}")
            if name == "tiled_int16" and "nw_sweep_tiled" in out and "ms_int16" not in out["nw_sweep_tiled"]:
                out["nw_sweep_tiled"]["ms_int16"] = spun_ms(
                    lambda: nw_cuda.nw_align_tiled(Qd, Td, qd, td, tile, wide, **kw), REPS)
                print(f"  timed: tiled sweep, tiled_int16 chunk {out['nw_sweep_tiled']['ms_int16']:.4f} ms | {smi}")
            del tb_k, tok_k, cnt_k, tok_p, cnt_p, keep
            torch.cuda.empty_cache()
    print(f"10b tiled chunks held to their plain versions [run, rows, W, tiles, wide, tmax, int16, route, lanes, "
          f"err sweep, err walk] {json.dumps(checked)}; phase 10 wall {time.time() - t_phase:.1f} s")
    for v in out.values():
        v["chunks_checked"] = checked
    replaces = {"nw_sweep_tiled": "seqrush_tpu/ops/nw.py:2232 (_sweep_tiled; XLA; nw_align_with_runs_tiled :2664)",
                "nw_walk_runs_tiled": "seqrush_tpu/ops/nw.py:2531 (_tb_scan_tiled; XLA)"}
    src = {"nw_sweep_tiled": "seqrush_tpu_torch/ops/csrc/nw_sweep_tiled.cu",
           "nw_walk_runs_tiled": "seqrush_tpu_torch/ops/csrc/nw_walk.cu"}
    return [{"name": k, "route": "cuda", "source": src[k], "replaces": replaces[k], "library_ms": None, **v,
             "tolerance": 0} for k, v in out.items()]

SHARD_OPS_PER_CELL = 30
SHARD_MIN_OPS_PER_CELL = 6
SHARD_PHASE_LIMIT_S = 480  # phase 11's wall-clock limit: a hang fails the run
MESH_SIZES = (1, 2, 4, 8)


def sharded_err(out, ref) -> int:
    """Largest difference of one sharded run's (scores, strips) from another's."""
    (s, strips), (s_ref, strips_ref) = out, ref
    return max([max_abs_err(s, s_ref)] + [max_abs_err(a, b) for a, b in zip(strips, strips_ref)])


def cigar_cost(items, q: np.ndarray, t: np.ndarray, pen: dict) -> int:
    """The cost of CIGAR items under two-piece penalties; fails unless the
    CIGAR consumes both sequences and its '=' / 'X' runs are right."""
    qi = ti = cost = 0

    def gap(n):
        return min(pen["o1"] + n * pen["e1"], pen["o2"] + n * pen["e2"])

    for n, op in items:
        if op in "=X":
            if not np.all((q[qi : qi + n] == t[ti : ti + n]) == (op == "=")):
                raise AssertionError(f"a {op} run does not match the bases at q {qi}, t {ti}")
            cost += n * pen["mismatch"] * (op == "X")
            qi, ti = qi + n, ti + n
        elif op == "I":
            cost, qi = cost + gap(n), qi + n
        elif op == "D":
            cost, ti = cost + gap(n), ti + n
        else:
            raise AssertionError(f"bad op {op}")
    if qi != q.size or ti != t.size:
        raise AssertionError(f"the CIGAR consumes {qi}/{q.size} and {ti}/{t.size} bases")
    return cost


def run_phase11(work: Path, smi: str, ptxas: list[str], ctx: dict) -> list[dict]:
    """11. The mesh paths on the one card, shards placed by Mesh([cuda:0] * D).

    11a. translocation_pair() through WfaAligner(wide_route='full') without a
         mesh and under Mesh([cuda:0] * 2), the launch counters reset just
         before and read just after the mesh run: the pair's job exceeds the
         default memory budget, so under the mesh it takes the band-sharded
         route (band_sharded >= 1, nw_sweep_sharded launched); its score
         equals the no-mesh run's, its CIGAR is valid and costs the score,
         and equals the CIGAR of kernel A single-shot at the route's band
         walked on the host (traceback_pair), and the no-mesh run's where
         that run's band is the same.  Kernel A's sharded mode against its
         plain version on the card: at the route's shape (D = 2, the plain
         version once) and on a 4 kb piece of the two haplotypes at band
         2,047 for D = 2, 4 and 8 (with a zero-length row), exactly, each
         at the planner's pick and at every cluster size it takes there
         (nw_align_sharded_at).  CUDA-event medians of the sharded sweep at
         the route's shape (the pick and every cluster size) and at the
         full pair for D = 1, 2, 4 and 8 at one band, its
         microseconds per anti-diagonal, the planner's pick (cluster size,
         lanes a thread, threads) and its bound, the kernels' ptxas lines,
         and kernel A single-shot at that band;
    11b. the headline's 600 pairs through WfaAligner without a mesh and under
         Mesh([cuda:0] * D), D = 1, 2, 4, in turns (none, 1, 2, 4, 4, 2, 1,
         none): the records' sha256 equal, every chunk split D ways; the
         runner's seconds of each;
    11c. parallel.mesh.distributed_align_unite on B = 256 pairs (one SNP
         each, tests/test_multidevice.py's workload at L 256) for D = 1, 2,
         4, 8: scores and parent arrays equal across D, the wavefront
         kernel's score-only mode launched; the step's seconds and its
         bound (inputs read once, outputs written once, the wavefront's
         cells at WFA_OPS_PER_CELL); the step's wavefront through the
         kernel's score-only mode and its plain version, timed;
    11d. two processes on cuda:0 joined by gloo (parallel/distributed.py,
         tests/torch_multihost_worker.py) on the headline FASTA with
         --no-sort: both GFA files must have DEFAULT_GFA_SHA256; the wall
         time.
    A watchdog ends the run (exit 3) if the phase passes SHARD_PHASE_LIMIT_S.
    Returns the kernels line's entry of nw_sweep_sharded."""
    import os
    import threading
    from dataclasses import asdict

    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
    from seqrush_tpu_torch.ops import nw, nw_cuda, wfa
    from seqrush_tpu_torch.ops import unionfind as uf
    from seqrush_tpu_torch.parallel.bandshard import band_for_mesh
    from seqrush_tpu_torch.parallel.mesh import Mesh, distributed_align_unite
    from seqrush_tpu_torch.sequences import make_sequence_set

    def expire():
        print(f"chip_smoke: phase 11 passed its {SHARD_PHASE_LIMIT_S} s limit", file=sys.stderr, flush=True)
        os._exit(3)

    watchdog = threading.Timer(SHARD_PHASE_LIMIT_S, expire)
    watchdog.daemon = True
    watchdog.start()
    t_phase = time.time()
    dev = torch.device("cuda", 0)
    named, pairs, scores, pen = ctx["named"], ctx["pairs"], ctx["scores"], ctx["pen"]

    def shard_bounds(Q, T, ql, tl, W, tb_numel):
        cells = int(((ql + tl).to(torch.int64) * W).sum().item())
        nbytes = Q.numel() + T.numel() + 8 * Q.shape[0] + 4 * Q.shape[0] + tb_numel
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = cells * max(SHARD_OPS_PER_CELL / ISSUE_OPS_PER_S, SHARD_MIN_OPS_PER_CELL / ALU_OPS_PER_S) * 1e3
        return b_ms, o_ms

    # 11a. the band-sharded route
    tr = translocation_pair()
    seqs_tr = make_sequence_set(tr)
    one = np.array([[0, 1]])
    cfg = dict(scores=scores, wide_route="full")
    t0 = time.time()
    al_plain = WfaAligner(seqs_tr, RunnerConfig(**cfg), device=dev)
    (r_plain,) = al_plain.align_pairs(one)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    plain_bands = [d["band"] for d in al_plain.stats["dispatches"]]
    nw_cuda.reset_launch_counts()
    t0 = time.time()
    al_mesh = WfaAligner(seqs_tr, RunnerConfig(mesh=Mesh([dev] * 2), **cfg), device=dev)
    (r_mesh,) = al_mesh.align_pairs(one)
    torch.cuda.synchronize()
    mesh_s = time.time() - t0
    launches_mesh = dict(nw_cuda.LAUNCHES)
    shard_d = [d for d in al_mesh.stats["dispatches"] if d["kind"] == "band_shard"]
    q, t = al_mesh.codes[0], al_mesh.codes[1]
    cost = cigar_cost(r_mesh.cigar, q, t, pen)
    print(f"band-shard route, 2 x {q.size} bp translocation pair, wide_route='full': without a mesh "
          f"score {r_plain.score} at bands {plain_bands} in {plain_s:.3f} s; under Mesh([cuda:0] * 2) score "
          f"{r_mesh.score} (CIGAR cost {cost}), band_sharded {al_mesh.stats['band_sharded']}, band escalations "
          f"{al_mesh.stats['band_escalations']}, dispatches {json.dumps([[d['kind'], d['B'], d['band'], d['tmax']] for d in al_mesh.stats['dispatches']])} "
          f"in {mesh_s:.3f} s; launches {json.dumps({k: v for k, v in launches_mesh.items() if v})}")
    if al_mesh.stats["band_sharded"] < 1 or launches_mesh["nw_sweep_sharded"] < 1 or not shard_d:
        raise AssertionError("the over-budget pair did not take the band-sharded route")
    if r_mesh.score != r_plain.score or cost != r_mesh.score or r_mesh.is_reverse != r_plain.is_reverse:
        raise AssertionError("the band-sharded route's score differs from the run without a mesh")
    band = shard_d[-1]["band"]
    tmax = shard_d[-1]["tmax"]
    same_band = plain_bands[-1] == band
    print(f"  CIGAR equal to the no-mesh run's {r_mesh.cigar == r_plain.cigar} (its last band {plain_bands[-1]}, "
          f"the route's {band})")
    if same_band and r_mesh.cigar != r_plain.cigar:
        raise AssertionError("at the same band the band-sharded route's CIGAR differs from the no-mesh run's")

    Qf, Tf = (torch.from_numpy(x[None, :].copy()).to(dev) for x in (q, t))
    qlf, tlf = (torch.tensor([x.size], dtype=torch.int32, device=dev) for x in (q, t))
    kw = dict(band=band, tmax=tmax, **pen)
    # the route's shape against the plain version (once: its step loop is
    # slow), the planner's launch and every cluster size it takes there
    plain_ms, ref = once_ms(lambda: nw_cuda.nw_align_sharded_reference(Qf, Tf, qlf, tlf, n_shards=2, **kw))
    err_full = sharded_err(nw_cuda.nw_align_sharded([dev] * 2, Qf, Tf, qlf, tlf, **kw), ref)
    route_clusters = {cs: sharded_err(nw_cuda.nw_align_sharded_at([dev] * 2, Qf, Tf, qlf, tlf, cluster=cs, **kw), ref)
                      for cs in nw_cuda.shard_cluster_sizes(band, 2, 2)}
    err_full = max([err_full, *route_clusters.values()])
    del ref
    # kernel A single-shot at the route's band: its walk gives the route's CIGAR
    s_a, tb_a = nw_cuda.nw_align(Qf, Tf, qlf, tlf, **kw)
    tb_host = tb_a[0].cpu().numpy()
    walked = nw.traceback_pair(tb_host, q.size, t.size, band)
    items = nw.resolve_matches(walked, q, t)
    del tb_a
    ctx["translocation_walk"] = (tb_host, q.size, t.size, band, walked)  # timed in phase 12d
    print(f"  sharded mode at the route's shape [B 1, W {band + 1}, 2 shards, tmax {tmax}]: max_abs_err "
          f"{err_full} against the plain version ({plain_ms:.1f} ms), by cluster size {json.dumps(route_clusters)}; "
          f"kernel A single-shot score {int(s_a[0])}, its CIGAR equal to the route's {items == r_mesh.cigar}")
    if err_full or int(s_a[0]) != r_mesh.score or items != r_mesh.cigar:
        raise AssertionError("the sharded mode disagrees with its plain version or with kernel A")

    # a 4 kb piece at band 2,047, D = 2, 4, 8, against the plain version
    lo, hi = 2000, 6000
    piece = [(q[lo:hi], t[lo:hi]), (np.zeros(0, np.uint8), np.zeros(0, np.uint8))]
    Qp = torch.full((2, hi - lo), nw.QPAD, dtype=torch.uint8)
    Tp = torch.full((2, hi - lo), nw.TPAD, dtype=torch.uint8)
    Qp[0], Tp[0] = torch.from_numpy(piece[0][0].copy()), torch.from_numpy(piece[0][1].copy())
    Qp, Tp = Qp.to(dev), Tp.to(dev)
    qlp = torch.tensor([hi - lo, 0], dtype=torch.int32, device=dev)
    tlp = qlp.clone()
    kwp = dict(band=2047, tmax=8192, **pen)
    # the piece's bound, as the full pair's: its cells and its strips' rows
    pb, po = shard_bounds(Qp, Tp, qlp, tlp, 2048, (nw_cuda.sharded_rows(2047, 8192) + 1) * 2048)
    piece_bound = {"bound_ms": max(pb, po), "bound_by": "bytes" if pb >= po else "operations"}
    piece_checked = []
    for D in (2, 4, 8):
        s_k, st_k = nw_cuda.nw_align_sharded([dev] * D, Qp, Tp, qlp, tlp, **kwp)
        p_ms, ref = once_ms(lambda: nw_cuda.nw_align_sharded_reference(Qp, Tp, qlp, tlp, n_shards=D, **kwp))
        by_cluster = {cs: sharded_err(nw_cuda.nw_align_sharded_at([dev] * D, Qp, Tp, qlp, tlp, cluster=cs, **kwp), ref)
                      for cs in nw_cuda.shard_cluster_sizes(2047, D, D)}
        err = max([sharded_err((s_k, st_k), ref), *by_cluster.values()])
        piece_checked.append({"D": D, "max_abs_err": err, "max_abs_err_by_cluster": by_cluster,
                              "scores": s_k.tolist(), "plain_ms": p_ms,
                              "plan": asdict(nw_cuda.pick_shard_plan(dev, 2047, D, D, 2, True)),
                              "ms": cuda_ms(lambda: nw_cuda.nw_align_sharded([dev] * D, Qp, Tp, qlp, tlp, **kwp),
                                            REPS), **piece_bound})
        if err:
            raise AssertionError(f"the sharded mode disagrees with its plain version at D = {D} on the piece")
    print(f"  4 kb piece [B 2, W 2048, tmax 8192] against the plain version: {json.dumps(piece_checked)}")

    # the full pair at one band for every D, and kernel A single-shot there
    band8 = band_for_mesh(band, 8)
    kw8 = dict(band=band8, tmax=tmax, **pen)
    t_total = nw_cuda.sharded_rows(band8, tmax)
    per_d = {}
    for D in MESH_SIZES:
        ms = cuda_ms(lambda: nw_cuda.nw_align_sharded([dev] * D, Qf, Tf, qlf, tlf, **kw8), REPS)
        b_ms, o_ms = shard_bounds(Qf, Tf, qlf, tlf, band8 + 1, (t_total + 1) * (band8 + 1))
        per_d[D] = {"ms": ms, "us_per_antidiagonal": ms * 1e3 / t_total, "bound_ms": max(b_ms, o_ms),
                    "bound_by": "bytes" if b_ms >= o_ms else "operations",
                    "plan": asdict(nw_cuda.pick_shard_plan(dev, band8, D, D, 1, True))}
    a_ms = cuda_ms(lambda: nw_cuda.nw_align(Qf, Tf, qlf, tlf, **kw8), REPS)
    sb, so = sweep_bounds(Qf, Tf, qlf, tlf, band8 + 1, nw.tmax_pad_of(tmax) * (band8 + 1))
    print(f"  sharded sweep at the full pair [B 1, W {band8 + 1}, tmax {tmax}, {t_total} anti-diagonals] by "
          f"shards: {json.dumps(per_d)}; kernel A single-shot {a_ms:.4f} ms (bound {max(sb, so):.4f}) | {smi}")

    # route's shape, timed (D = 2 at the route's band): the planner's launch
    # and every cluster size
    route_rows = nw_cuda.sharded_rows(band, tmax)
    route_pick = nw_cuda.pick_shard_plan(dev, band, 2, 2, 1, True)
    ms_route = cuda_ms(lambda: nw_cuda.nw_align_sharded([dev] * 2, Qf, Tf, qlf, tlf, **kw), REPS)
    route_by_cluster = {cs: cuda_ms(lambda: nw_cuda.nw_align_sharded_at([dev] * 2, Qf, Tf, qlf, tlf, cluster=cs, **kw),
                                    REPS) for cs in route_clusters}
    rb, ro = shard_bounds(Qf, Tf, qlf, tlf, band + 1, (route_rows + 1) * (band + 1))
    shard_ptxas = [x for x in ptxas if x.startswith("nw_sweep_cluster")]
    print(f"  route's shape timed: {ms_route:.4f} ms, {ms_route * 1e3 / route_rows:.4f} us an anti-diagonal "
          f"(plan {json.dumps(asdict(route_pick))}); by cluster size {json.dumps(route_by_cluster)}; bound "
          f"{max(rb, ro):.4f} ms; ptxas {json.dumps(shard_ptxas)} | {smi}")
    torch.cuda.empty_cache()

    # 11b. batch sharding of the headline's 600 pairs
    seqs = make_sequence_set(named)
    secs, digests, splits = {}, {}, {}
    for D in (None, 1, 2, 4, 4, 2, 1, None):  # in turns
        mesh = None if D is None else Mesh([dev] * D)
        al = WfaAligner(seqs, RunnerConfig(scores=scores, mesh=mesh), device=dev)
        nw_cuda.reset_launch_counts()
        t0 = time.time()
        res = al.align_pairs(pairs)
        torch.cuda.synchronize()
        key = "none" if D is None else str(D)
        secs.setdefault(key, []).append(round(time.time() - t0, 4))
        digests.setdefault(key, set()).add(records_digest(res))
        chunks = [d for d in al.stats["dispatches"] if d["kind"] == "chunk"]
        splits[key] = sorted({d.get("mesh", 0) for d in chunks})
        if D is not None and (splits[key] != [D] or nw_cuda.LAUNCHES["nw_sweep"] < D):
            raise AssertionError(f"the {D}-shard run did not split its chunks {D} ways")
    print(f"batch sharding, 600 pairs: records sha256 {json.dumps({k: sorted(v) for k, v in digests.items()})}; "
          f"chunk splits {json.dumps(splits)}; runner seconds in turns {json.dumps(secs)} | {smi}")
    if len(set().union(*digests.values())) != 1:
        raise AssertionError("a mesh run's records differ from the run without a mesh")

    # 11c. the sharded align + unite step
    rng = np.random.default_rng(0)
    B, L = 256, 256
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    qs, ts = [], []
    for k in range(B):
        tt = base.copy()
        tt[(13 * k + 7) % L] = (tt[(13 * k + 7) % L] + 1) % 4
        qs.append(base.copy())
        ts.append(tt)
    Q, T, qlens, tlens = wfa.pack_batch(qs, ts)
    caps = np.full(B, 256, dtype=np.int32)
    qoffs = np.arange(B, dtype=np.int64) * L
    toffs = qoffs + B * L
    pen_w = wfa.Penalties(pen["mismatch"], pen["o1"], pen["e1"], pen["o2"], pen["e2"])
    step_out, step_s = [], {}
    for D in MESH_SIZES:
        nw_cuda.reset_launch_counts()
        t0 = time.time()
        s, par = distributed_align_unite(Mesh([dev] * D), uf.create(4 * B * L + 2, dev), Q, T, qlens, tlens, caps,
                                         qoffs, toffs, pen_w, smax=256, band=32)
        torch.cuda.synchronize()
        step_s[D] = round(time.time() - t0, 4)
        if nw_cuda.LAUNCHES["wfa_score_only"] != D:
            raise AssertionError(f"the align + unite step launched {nw_cuda.LAUNCHES['wfa_score_only']} score-only "
                                 f"wavefront kernels on {D} shards")
        step_out.append((s.cpu(), par.cpu()))
    same = all(torch.equal(a[0], step_out[0][0]) and torch.equal(a[1], step_out[0][1]) for a in step_out)
    # the step's bound: its inputs read once (Q, T, lengths, caps, offsets,
    # the parent) and its outputs written once (scores, the parent); the
    # wavefront's cells of each pair's score steps at WFA_OPS_PER_CELL
    n_slots = 4 * B * L + 2
    step_bytes = Q.size + T.size + 12 * B + 16 * B + 2 * 4 * n_slots + 4 * B
    step_ops = sum(int(x) + 1 for x in step_out[0][0].tolist()) * (2 * 32 + 1) * WFA_OPS_PER_CELL
    sb_ms, so_ms = step_bytes / HBM_BYTES_PER_S * 1e3, step_ops / ISSUE_OPS_PER_S * 1e3
    # the step's wavefront alone: the kernel's score-only mode and its plain version
    w_args = [torch.from_numpy(a).to(dev) for a in (Q, T, qlens, tlens, caps)]
    w_kw = dict(smax=256, band=32, keep_history=False, **pen)
    w_ms = cuda_ms(lambda: wfa.wfa_align_device(*w_args, **w_kw), REPS)
    w_plain_ms, _ = once_ms(lambda: wfa.wfa_align_reference(*w_args, **w_kw))
    print(f"distributed_align_unite, B {B}, L {L}: scores {sorted(set(step_out[0][0].tolist()))}, equal across "
          f"D = 1, 2, 4, 8 {same}; seconds {json.dumps(step_s)}; bound {max(sb_ms, so_ms):.6f} ms "
          f"({'bytes' if sb_ms >= so_ms else 'operations'}; {step_bytes} bytes, {step_ops} operations); its "
          f"wavefront (score-only kernel) {w_ms:.4f} ms, plain version {w_plain_ms:.1f} ms")
    if not same or not bool((step_out[0][0] == pen["mismatch"]).all()):
        raise AssertionError("the align + unite step differs across shard counts")

    # 11d. two processes on the one card
    import socket

    root = Path(__file__).resolve().parent
    fa, out = work / "hla25.fa", work / "mh.gfa"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, str(root / "tests" / "torch_multihost_worker.py"), f"127.0.0.1:{port}", "2"]
    t0 = time.time()
    procs = [subprocess.Popen([*cmd, str(pid), "--", "-s", str(fa), "-o", str(out), "--no-sort", "-v"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=300)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    mh_s = time.time() - t0
    shas = [hashlib.sha256(Path(f).read_bytes()).hexdigest() if Path(f).exists() else None
            for f in (out, f"{out}.host1")]
    stripes = [ln for log in logs for ln in log.splitlines() if "[multihost]" in ln]
    print(f"two processes on cuda:0 (gloo), headline --no-sort: {mh_s:.2f} s wall; {stripes}; GFA sha256 {shas}")
    if any(pr.returncode != 0 for pr in procs) or shas != [DEFAULT_GFA_SHA256] * 2:
        print("\n".join(log[-3000:] for log in logs), file=sys.stderr)
        raise AssertionError("the two-process run failed or its GFA files differ from the JAX package's")
    watchdog.cancel()
    print(f"phase 11 wall {time.time() - t_phase:.1f} s")
    return [{
        "name": "nw_sweep_sharded", "route": "cuda", "source": "seqrush_tpu_torch/ops/csrc/nw_sweep_shard.cu",
        "replaces": "seqrush_tpu/parallel/bandshard.py:64 (_build_sharded_sweep; XLA)",
        "launches": launches_mesh["nw_sweep_sharded"],
        "launches_path": "translocation_pair() through WfaAligner(wide_route='full', mesh=Mesh([cuda:0] * 2))",
        "max_abs_err": max([err_full] + [c["max_abs_err"] for c in piece_checked]),
        "ms": ms_route, "plain_ms": plain_ms, "bound_ms": max(rb, ro),
        "bound_by": "bytes" if rb >= ro else "operations", "library_ms": None,
        "shape": {"B": 1, "W": band + 1, "shards": 2, "tmax": tmax},
        "plan": asdict(route_pick),
        "us_per_antidiagonal": ms_route * 1e3 / route_rows,
        "ms_by_cluster": route_by_cluster,
        "max_abs_err_by_cluster": route_clusters,
        "by_shards_full_pair": {"W": band8 + 1, **{str(k): v for k, v in per_d.items()}},
        "kernel_a_single_shot_ms": a_ms, "kernel_a_bound_ms": max(sb, so),
        "piece_4kb": piece_checked,
        "ptxas": ptxas_registers(ptxas, f"nw_sweep_cluster<{route_pick.lanes}, two-piece>"),
        "tolerance": 0,
    }]


WIDE_PLAIN_ON_HOST = ("long8_w128",)  # phase 11e's sites whose plain version runs on the host CPU
WIDE_PHASE_LIMIT_S = 420  # phase 11e's wall-clock limit: a hang fails the run


def run_phase11e(smi: str, ptxas: list[str], ctx: dict) -> list[dict]:
    """11e. Kernel A's wide route (ops/csrc/nw_sweep_wide.cuh: nw_sweep_wide,
    nw_sweep_wide_seg; one pair a thread-block cluster, its lanes in
    registers).

    The main paths, the launch counters reset just before each and read
    just after: translocation_pair() through WfaAligner(wide_route='full')
    without a mesh (its band passes REG_MAX_W: nw_sweep_wide launched), and
    the same with long_pair_threshold 32,768 (the long route at that band:
    nw_sweep_wide_segment launched); the two scores equal, each run's wall.
    Then long_deletion_pair() the same two ways (threshold 16,384): its band
    passes 24,576 lanes, so each pair is a chain of two 16-CTA clusters and
    the chunk's 8 padded pairs run in slices of resident clusters; both
    scores the 28 kb gap's, the alignments equal.
    Then every site of tools/wide_timing.py (the translocation pair [1, W
    17,408, tmax 48,128] with its traceback and score-only, W 4,097 and its
    int16 and snapshot modes, [8, W 5,120] and score-only, int16 penalties
    that wrap at [64, W 128], [8, W 128, Lq = Lt = 120,064], the segment
    mode's forward run and grouped recompute at W 4,608): the kernel against
    its plain version on the same inputs (exact; the plain version once a
    site, its time; on the host CPU for WIDE_PLAIN_ON_HOST, on the card for
    the others), timed behind a spin of the card, with its plan, the
    kernel's registers and spilled bytes, its bound and its chain floor
    (tools/wide_timing.py::site_row: the site's longest pair's
    anti-diagonals at the step latency of the floor probe, the column
    exchange and barrier alone, at the same plan).  A watchdog ends the
    run (exit 3) past WIDE_PHASE_LIMIT_S.  Returns the kernels line's entries of nw_sweep_wide
    and nw_sweep_wide_segment."""
    import os
    import threading
    from dataclasses import asdict

    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
    from seqrush_tpu_torch.ops import nw, nw_cuda
    from seqrush_tpu_torch.sequences import make_sequence_set
    from seqrush_tpu_torch.tools import wide_timing as wt

    def expire():
        print(f"chip_smoke: phase 11e passed its {WIDE_PHASE_LIMIT_S} s limit", file=sys.stderr, flush=True)
        os._exit(3)

    watchdog = threading.Timer(WIDE_PHASE_LIMIT_S, expire)
    watchdog.daemon = True
    watchdog.start()
    t_phase = time.time()
    dev = torch.device("cuda", 0)
    scores_cfg = ctx["scores"]
    seqs_tr = make_sequence_set(translocation_pair())
    one = np.array([[0, 1]])
    paths = {}
    seqs_del = make_sequence_set(long_deletion_pair())
    for key, seqs, kernel, extra in (
            ("single_shot", seqs_tr, "nw_sweep_wide", {}),
            ("long_route", seqs_tr, "nw_sweep_wide_segment", {"long_pair_threshold": 32_768}),
            ("chain_single_shot", seqs_del, "nw_sweep_wide", {}),
            ("chain_long_route", seqs_del, "nw_sweep_wide_segment", {"long_pair_threshold": 16_384})):
        al = WfaAligner(seqs, RunnerConfig(scores=scores_cfg, wide_route="full", **extra), device=dev)
        nw_cuda.reset_launch_counts()
        t0 = time.time()
        (res,) = al.align_pairs(one)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = dict(nw_cuda.LAUNCHES)
        if counts[kernel] <= 0:
            raise AssertionError(f"{kernel} was not launched on the {key} path")
        paths[key] = {"wall_s": wall, "score": res.score, "launches": {k: v for k, v in counts.items() if v},
                      "dispatches": [[d["kind"], d["B"], d["band"], d["tmax"], d.get("sweep")]
                                     for d in al.stats["dispatches"]],
                      "cigar": res.cigar_string if key.startswith("chain") else None}
    print(f"wide route main paths, translocation_pair() and long_deletion_pair() with wide_route='full' "
          f"(no mesh): {json.dumps(paths)} | {smi}")
    if paths["single_shot"]["score"] != paths["long_route"]["score"]:
        raise AssertionError("the long route's score differs from single-shot's on the translocation pair")
    # past 24,576 lanes a pair is a chain of 16-CTA clusters: the chunk's 8
    # padded pairs exceed the clusters the card holds, so it runs in slices
    want = long_deletion_score(scores_cfg)
    for key in ("chain_single_shot", "chain_long_route"):
        p = paths[key]
        if p["score"] != want or p["cigar"] != paths["chain_single_shot"]["cigar"]:
            raise AssertionError(f"{key}: score {p['score']} (the 28 kb gap's is {want}) or its alignment differs")
        if not all(d[2] + 1 > 24_576 and d[4] == "wide" for d in p["dispatches"]):
            raise AssertionError(f"{key}: a dispatch did not take the wide route past 24,576 lanes")
    if paths["chain_single_shot"]["launches"]["nw_sweep_wide"] < 2:
        raise AssertionError("the chain's single-shot dispatch was not sliced")

    sites = wt.wide_sites(dev)
    rows = {}
    for name in wt.SITES:
        site = sites[name]
        Q, T, ql, tl = site["inputs"]
        kw = site["kw"]
        ckpt = wt._ckpt(site, dev) if site["kind"] != "align" else None
        if site["kind"] == "group":
            wt.launcher(nw_cuda, dict(site, kind="run"), ckpt)()
        out_k = [x.clone() for x in wt.launcher(nw_cuda, site, ckpt)()]
        torch.cuda.synchronize()
        plain_ms = None
        if name == "translocation_score_only":  # the plain version's scores of the traceback site
            ref = [rows["translocation"]["ref_scores"]]
        elif site["kind"] == "align":
            # the plain version of [8, W 128, 120,064] on the host: its 120,000
            # steps of [8, 128] ops are launch-bound on the card (118 s there, NVIDIA H100 80GB HBM3)
            pd = torch.device("cpu") if name in WIDE_PLAIN_ON_HOST else dev
            args_p = [x.to(pd) for x in (Q, T, ql, tl)]
            kw_p = {k: v.to(pd) if torch.is_tensor(v) else v for k, v in kw.items()}
            plain_ms, ref = once_ms(lambda: nw_cuda.nw_align_reference(*args_p, **kw_p))
            ref = [x.to(dev) for x in [x for x in ref[:2] if x is not None] + (list(ref[2]) if len(ref) > 2 else [])]
        elif site["kind"] == "run":
            ck = ckpt.clone()
            ck[1:] = -7
            s0 = torch.full((Q.shape[0],), -1, dtype=torch.int32, device=dev)
            plain_ms, s_p = once_ms(lambda: nw_cuda.nw_align_segment_run_reference(
                Q, T, ql, tl, ck, s0, s0=0, n_run=wt.N_RUN, **kw))
            ref = [s_p, ck[1:]]
        else:
            tb_p = torch.zeros_like(out_k[1])
            plain_ms, s_p = once_ms(lambda: nw_cuda.nw_align_segment_group_reference(
                Q, T, ql, tl, ckpt, s0=0, G=wt.N_RUN, tb=tb_p, **kw))
            ref = [s_p, tb_p]
        err = max(max_abs_err(a, b) for a, b in zip(out_k, ref))
        if name == "translocation_score_only":
            err = max_abs_err(out_k[0], ref[0])
        if err:
            raise AssertionError(f"kernel A's wide route differs from its plain version at {name}")
        ms = spun_ms(wt.launcher(nw_cuda, site, ckpt), REPS)
        row = wt.site_row(nw_cuda, sys.modules[__name__], site, ms, REPS)
        rows[name] = {"shape": {"B": Q.shape[0], "W": kw["band"] + 1, "Lq": Q.shape[1], "tmax": kw.get("tmax")},
                      "ms": ms, "plain_ms": plain_ms,
                      "plain_device": "cpu" if name in WIDE_PLAIN_ON_HOST else "cuda", "max_abs_err": err,
                      "bound_ms": row["bound_ms"],
                      "bound_by": row["bound_by"], "chain_floor_ms": row["chain"]["floor_ms"],
                      "chain": row["chain"], "plan": asdict(wt.site_plan(nw_cuda, site)), **row["kernel"]}
        if name == "translocation":
            rows[name]["ref_scores"] = ref[0]
        del out_k, ref, ckpt
        sites[name] = None
        torch.cuda.empty_cache()
    rows["translocation"].pop("ref_scores")
    print(f"  wide route sites: {json.dumps(rows)} | {smi}")
    wide_ptxas = [x for x in ptxas if x.startswith("nw_sweep_wide")]
    print(f"  ptxas {json.dumps(wide_ptxas)}")
    watchdog.cancel()
    print(f"phase 11e wall {time.time() - t_phase:.1f} s")
    single = [n for n in rows if not n.startswith("segment")]
    seg = [n for n in rows if n.startswith("segment")]
    main_s, main_g = rows["translocation"], rows["segment_group_w4608"]
    return [
        {"name": "nw_sweep_wide", "route": "cuda", "source": "seqrush_tpu_torch/ops/csrc/nw_sweep_wide.cu",
         "replaces": "seqrush_tpu/ops/nw_pallas.py:38 (_kernel, nw_align_pallas :402; the wide route)",
         "launches": paths["single_shot"]["launches"]["nw_sweep_wide"],
         "launches_path": "translocation_pair() through WfaAligner(wide_route='full'), no mesh",
         "max_abs_err": max(rows[n]["max_abs_err"] for n in single),
         "ms": main_s["ms"], "plain_ms": main_s["plain_ms"], "bound_ms": main_s["bound_ms"],
         "bound_by": main_s["bound_by"], "library_ms": None, "chain_floor_ms": main_s["chain_floor_ms"],
         "shape": main_s["shape"], "plan": main_s["plan"], "sites": {n: rows[n] for n in single},
         "path_wall_s": paths["single_shot"]["wall_s"], "ptxas": wide_ptxas, "tolerance": 0},
        {"name": "nw_sweep_wide_segment", "route": "cuda",
         "source": "seqrush_tpu_torch/ops/csrc/nw_sweep_wide_seg.cu",
         "replaces": "seqrush_tpu/ops/nw.py:968 (_nw_segment; the wide route)",
         "launches": paths["long_route"]["launches"]["nw_sweep_wide_segment"],
         "launches_path": "translocation_pair() through WfaAligner(wide_route='full', long_pair_threshold=32768)",
         "max_abs_err": max(rows[n]["max_abs_err"] for n in seg),
         "ms": main_g["ms"], "plain_ms": main_g["plain_ms"], "bound_ms": main_g["bound_ms"],
         "bound_by": main_g["bound_by"], "library_ms": None, "chain_floor_ms": main_g["chain_floor_ms"],
         "shape": main_g["shape"], "plan": main_g["plan"], "sites": {n: rows[n] for n in seg},
         "path_wall_s": paths["long_route"]["wall_s"], "tolerance": 0},
    ]


def in_turns(a: str, b: str) -> tuple[str, ...]:
    """Phase 12's order of runs: three of each variant, in turns."""
    return (a, b, b, a, a, b)


def _uf_roots(p: torch.Tensor) -> int:
    """Self-parented slots of a parent array on the card."""
    return int((p == torch.arange(p.numel(), dtype=p.dtype, device=p.device)).sum().item())


def uf_flush_numbers(tag: str, parent0: np.ndarray, u: np.ndarray, v: np.ndarray, host_unite) -> dict:
    """One flush (parent0 and its edges, int64 numpy) at one size, on the
    card: the edges' host cast and copy to the card timed apart; the unite's
    one launch (hook and compress behind a grid barrier; CUDA events, median
    of 3 after a warm-up) on the edges already on the card, four runs equal;
    the compress launch alone on an uncompressed forest of the flush's
    slots (tools/headline.py::deep_forest: the flush's input parent is
    compressed already, so the launch would move nothing there) against
    compress_reference on the same forest, four runs equal; the unite (its
    copy of the parent and its launch) and its plain version in turns,
    with the plain version's host reads; the host C++ unite (parent to the
    host, uf_unite_bulk and full compression, back to the card) against the
    pipeline's unite from numpy edges, in turns; every parent equal.  The
    launches are timed behind a spin of the card (see spun_ms)."""
    from seqrush_tpu_torch.ops import unionfind as uf
    from seqrush_tpu_torch.tools.headline import deep_forest

    dev = torch.device("cuda")
    p_dev = torch.from_numpy(parent0).to(dev)
    n_slots, n_edges = int(p_dev.numel()), int(u.size)
    forest = torch.from_numpy(deep_forest(n_slots)).to(dev)
    cast_s, copy_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        u32, v32 = u.astype(np.int32), v.astype(np.int32)
        t1 = time.perf_counter()
        ud, vd = torch.from_numpy(u32).to(dev), torch.from_numpy(v32).to(dev)
        torch.cuda.synchronize()
        cast_s.append(t1 - t0)
        copy_s.append(time.perf_counter() - t1)
    del u32, v32

    def spun_launch(fn, src):
        """(ms, parent) of fn on a copy of src, the copy made before the
        spin; the card spins while the host enqueues the launch, so the
        events time the kernel alone."""
        p = src.clone()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn(p)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1), p

    unite_ms, comp_ms, runs, comp_runs = [], [], [], []
    for rep in range(4):
        ms, p = spun_launch(lambda q: uf._unite_cuda(q, ud, vd), p_dev)
        ms_c, c = spun_launch(uf._compress_cuda, forest)
        if rep:
            unite_ms.append(ms)
            comp_ms.append(ms_c)
        runs.append(p)
        comp_runs.append(c)
    if not all(torch.equal(r, runs[0]) for r in runs[1:]):
        raise AssertionError(f"the {tag} flush's kernel runs differ")
    if not all(torch.equal(r, comp_runs[0]) for r in comp_runs[1:]):
        raise AssertionError(f"the compress runs on the {tag} flush's forest differ")
    kernel, comp_k = runs[0], comp_runs[0]
    comp_plain = uf.compress_reference(forest)
    comp_plain_ms = cuda_ms(lambda: uf.compress_reference(forest), REPS)
    forest_moved = int((forest != comp_plain).sum().item())
    hooks = _uf_roots(p_dev) - _uf_roots(kernel)
    # the unite and its plain version in turns, edges on the card, each
    # warmed first (a process's first call of the plain version also loads
    # torch's kernels)
    turns, got = {"plain": [], "kernel": []}, {}
    uf.unite_edges_reference(p_dev, ud, vd)
    uf.unite_edges(p_dev, ud, vd)
    for mode in in_turns("plain", "kernel"):
        fn = uf.unite_edges_reference if mode == "plain" else uf.unite_edges
        ms, res = once_ms(lambda: fn(p_dev, ud, vd))
        turns[mode].append(ms)
        if mode in got and not torch.equal(got[mode], res):
            raise AssertionError(f"two {mode} unites of the {tag} flush differ")
        got[mode] = res
    reads = [0]
    equal = torch.equal

    def counted(a, b):
        reads[0] += 1
        return equal(a, b)

    torch.equal = counted
    try:
        uf.unite_edges_reference(p_dev, ud, vd)
    finally:
        torch.equal = equal
    # the host C++ unite against the pipeline's unite from numpy edges
    secs = {"cpp": [], "device": []}
    split = {"to_host": [], "cpp": [], "to_card": []}
    for mode in in_turns("cpp", "device"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "cpp":
            par = p_dev.to("cpu", torch.int32, copy=True).numpy()
            t1 = time.perf_counter()
            host_unite(par, u, v)
            t2 = time.perf_counter()
            res = torch.from_numpy(par).to(dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
                split[key].append(dt)
        else:
            res = uf.unite_edges(p_dev, u, v)
            torch.cuda.synchronize()
        secs[mode].append(time.perf_counter() - t0)
        if mode in got and not torch.equal(got[mode], res):
            raise AssertionError(f"two {mode} unites of the {tag} flush differ")
        got[mode] = res
    err = max(max_abs_err(kernel, got[m]) for m in ("plain", "kernel", "cpp", "device"))
    err = max(err, max_abs_err(comp_k, comp_plain))
    return {
        "edges": n_edges, "parent_slots": n_slots, "hooks": hooks,
        "edge_cast_s": cast_s, "edge_copy_s": copy_s,
        "unite_kernel_ms": statistics.median(unite_ms), "compress_ms": statistics.median(comp_ms),
        "unite_kernel_ms_each": unite_ms, "compress_ms_each": comp_ms,
        "unite_in_turns_ms": turns, "plain_host_reads": reads[0], "compress_plain_ms": comp_plain_ms,
        "compress_bound_ms": 8 * n_slots / HBM_BYTES_PER_S * 1e3, "compress_forest_moved": forest_moved,
        "unite_bound_ms": (8 * n_edges + 8 * n_slots) / HBM_BYTES_PER_S * 1e3,
        "flush_in_turns_s": secs, "cpp_flush_split_s": split, "max_abs_err": err,
        "parents_equal": err == 0,
    }


def uf_find_numbers(n_slots: int, seed: int = 5) -> dict:
    """find over every slot of an uncompressed forest of n_slots
    (tools/headline.py::deep_forest: each slot below a random smaller one
    with probability 1/2): the kernel (spun_ms) against find_reference
    (cuda_ms), each the median of 3 after a warm-up, equal."""
    from seqrush_tpu_torch.ops import unionfind as uf
    from seqrush_tpu_torch.tools.headline import deep_forest

    p = torch.from_numpy(deep_forest(n_slots, seed)).to("cuda")
    pos = torch.arange(n_slots, dtype=torch.int32, device="cuda")
    ms = spun_ms(lambda: uf.find(p, pos), REPS)
    want = uf.find_reference(p, pos)
    plain_ms = cuda_ms(lambda: uf.find_reference(p, pos), REPS)
    got = uf.find(p, pos)
    depth = int(torch.where(got == pos, 0, 1).sum().item())
    return {"slots": n_slots, "positions": n_slots, "not_roots": depth, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": (8 * n_slots + 4 * n_slots) / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": max_abs_err(got, want)}


def unite_split(runs: list[tuple[str, str, str]]) -> dict:
    """12b's measurements, in a fresh process (``python3 chip_smoke.py
    --unite-split TAG FASTA GFA ...``): each FASTA through the CLI on the
    card with --no-sort, in order.  The pre-unite of the process's first run
    is split, each part synchronised: its first device tensor (the CUDA
    context), loading the kernels' library, the edges' cast and copy, the
    first unite launch (the library's load apart);
    then the same pre-unite again, warm.  The align phase's seconds and each
    run's first two chunk dispatches (host seconds) show a cost that moves
    from the pre-unite into the align phase.  The union-find's launches of
    the pre-unite and of the flush are counted apart; _result_to_unites'
    seconds are summed; the flush's unite is timed and the largest flush's
    parent and edges kept for uf_flush_numbers.  Then a synthetic flush at
    the top of the users' range (1,000 x 3.3 kb, 50,000,000 edges of match
    runs after the F/R pre-unite, tools/headline.py::synth_flush_edges)
    through uf_flush_numbers, and find on an uncompressed forest of the
    headline's size.  Returns a dict by tag; each run's GFA sha256 is in
    it."""
    from seqrush_tpu_torch import cli, pipeline
    from seqrush_tpu_torch.align import runner
    from seqrush_tpu_torch.native import uf_unite_bulk_native as host_unite
    from seqrush_tpu_torch.ops import nw_cuda
    from seqrush_tpu_torch.ops import unionfind as uf
    from seqrush_tpu_torch.tools.headline import synth_flush_edges

    create, unite_edges = uf.create, uf.unite_edges
    parts = {"edges_s": "edges_on", "unite_s": "_unite_cuda"}
    originals = {key: getattr(uf, name) for key, name in parts.items()}
    library = nw_cuda._library
    to_unites = pipeline.SeqRushTorch._result_to_unites
    flush = pipeline.SeqRushTorch._flush_unites
    dispatch = runner.WfaAligner._dispatch_nw_chunk
    t: dict = {}
    pre: dict = {}
    flushes: list = []
    dispatch_s: list = []
    site = [None]
    uf_launches = {"pre_unite": {}, "flush": {}}

    def timed(fn, key):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            t[key] = t.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    def part(fn, key):
        """fn timed on its own, synchronised, while a pre-unite runs."""
        def wrapper(*a, **k):
            if site[0] != "pre_unite":
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            pre[key] = pre.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    pre_unite_unite = timed(unite_edges, "pre_unite_unite_s")
    flush_unite = timed(unite_edges, "flush_device_s")

    def counted(kind, fn, *a):
        before = dict(nw_cuda.LAUNCHES)
        site[0] = kind
        try:
            return fn(*a)
        finally:
            site[0] = None
            for k in UF_KERNELS:
                uf_launches[kind][k] = uf_launches[kind].get(k, 0) + nw_cuda.LAUNCHES[k] - before[k]

    def capturing_unite(parent, u, v):
        if site[0] != "flush":
            return counted("pre_unite", pre_unite_unite, parent, u, v)
        flushes.append((parent.to("cpu", torch.int32, copy=True).numpy(), np.asarray(u), np.asarray(v)))
        return flush_unite(parent, u, v)

    def flagged_flush(self):
        counted("flush", flush, self)

    def timed_dispatch(self, chunk):
        t0 = time.perf_counter()
        out = dispatch(self, chunk)
        dispatch_s.append(time.perf_counter() - t0)
        return out

    uf.create, uf.unite_edges = timed(create, "create_s"), capturing_unite
    for key, name in parts.items():
        setattr(uf, name, part(originals[key], key))
    nw_cuda._library = part(library, "library_s")
    pipeline.SeqRushTorch._result_to_unites = timed(to_unites, "result_to_unites_s")
    pipeline.SeqRushTorch._flush_unites = flagged_flush
    runner.WfaAligner._dispatch_nw_chunk = timed_dispatch
    out, largest = {}, {}
    try:
        for k, (tag, fasta, gfa) in enumerate(runs):
            t.clear()
            pre.clear()
            flushes.clear()
            dispatch_s.clear()
            for d in uf_launches.values():
                d.clear()
            prof = Path(gfa + ".json")
            t0 = time.time()
            if cli.main(["-s", fasta, "-o", gfa, "--no-sort", "--profile", str(prof)]) != 0:
                raise RuntimeError(f"the {tag} run failed")
            rep = json.loads(prof.read_text())
            parent0, u, v = max(flushes, key=lambda f: f[1].size)
            out[tag] = {"wall_s": time.time() - t0, "phases_s": rep["phases_s"], **t,
                        "pre_unite_parts_s": dict(pre), "first_dispatches_s": dispatch_s[:2],
                        "uf_launches": {kk: dict(d) for kk, d in uf_launches.items()},
                        "flushes": len(flushes),
                        "gfa_sha256": hashlib.sha256(Path(gfa).read_bytes()).hexdigest()}
            if "library_s" in pre:
                out[tag]["pre_unite_parts_s"]["first_unite_launch_s"] = pre["unite_s"] - pre["library_s"]
            if k == 0:
                # the same pre-unite again, warm
                pre.clear()
                n_total = (parent0.size - 2) // 2
                i = np.arange(n_total, dtype=np.int64)
                p0 = create(parent0.size, "cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                counted("pre_unite", unite_edges, p0, i << 1, (i << 1) | 1)
                torch.cuda.synchronize()
                out[tag]["pre_unite_warm_s"] = {"unite_s": time.perf_counter() - t0, **pre}
            largest[tag] = (parent0, u, v)
    finally:
        uf.create, uf.unite_edges = create, unite_edges
        for key, name in parts.items():
            setattr(uf, name, originals[key])
        nw_cuda._library = library
        pipeline.SeqRushTorch._result_to_unites = to_unites
        pipeline.SeqRushTorch._flush_unites = flush
        runner.WfaAligner._dispatch_nw_chunk = dispatch
    for tag, (parent0, u, v) in largest.items():
        out[tag].update(uf_flush_numbers(tag, parent0, u, v, host_unite))
    # the top of the users' range: 1,000 x 3.3 kb, a flush of 50 M edges
    n_seqs, length = 1000, 3300
    t0 = time.perf_counter()
    u, v = synth_flush_edges(n_seqs=n_seqs, length=length, n_edges=SYNTH_FLUSH_EDGES)
    i = np.arange(n_seqs * length, dtype=np.int64)
    parent0 = uf.unite_edges(uf.create(2 * n_seqs * length + 2, "cuda"), i << 1, (i << 1) | 1)
    made_s = time.perf_counter() - t0
    if not torch.equal(parent0, uf.unite_edges_reference(uf.create(parent0.numel(), "cuda"), i << 1, (i << 1) | 1)):
        raise AssertionError("the synthetic pre-unite differs from its plain version")
    out["synthetic"] = {"made_s": made_s, **uf_flush_numbers("synthetic", parent0.cpu().numpy(), u, v, host_unite)}
    out["find"] = uf_find_numbers(out[runs[0][0]]["parent_slots"])
    return out


def run_phase12(work: Path, smi: str, drive, ctx: dict) -> list[dict]:
    """12. The host library's parser, unite and walks at the sizes users run.

    12a. the FASTA parser: the headline FASTA, the 8 x 60 kb locus FASTA and a
         1,000 x 3.3 kb one (synth_hla(n_seqs=1000)) through load_fasta (the
         C++ parser) and load_fasta_python (the plain loop), three times
         each in turns: equal records, the seconds of each; then each of
         fasta_faults() through the CLI on the card with --no-sort: its GFA's
         sha256, or the golden check's RuntimeError, equal to the JAX
         package's (FASTA_FAULTS_JAX);
    12b. the unite, in a fresh process (unite_split): the default headline
         run's pre_unite split into its parts, cold and warm, the align
         phase's seconds and first dispatches, the union-find launches of
         the pre-unite and of the flush (each must launch both kernels), the
         Python seconds of _result_to_unites; at the headline's flush, the
         locus's and a synthetic 50 M-edge one the kernels timed apart and
         against the plain version and the host library's unite, equal
         parents; find against its plain version; the headline GFA must have
         DEFAULT_GFA_SHA256, the locus's the bytes of phase 6's --no-sort
         run.  Returns the union-find's entries of the kernels line;
    12c. the 600 pairs through kernel='wfa' with the C++ backtrace and with
         the Python specification (native.backtrace_native patched to
         return None), three times each in turns: equal records, the
         route's wall and the backtrace's own seconds; wfa_subset()'s
         records against WFA_SUBSET_SHA256;
    12d. the translocation pair's host walk (phase 11a's kernel A traceback
         at the route's band) through the C++ walk and the Python
         specification: equal items, the seconds of each;
    12e. the sweepga backend's align phase with --no-sort (its GFA must keep
         SWEEPGA_GFA_SHA256), and chain_anchors' DP through the C++ and the
         Python lookback on the anchors of the headline's pairs (0, j):
         equal chains, the seconds of each."""
    from seqrush_tpu_torch import cli, native
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
    from seqrush_tpu_torch.ops import anchors, nw, wfa
    from seqrush_tpu_torch.pos import encode_bases
    from seqrush_tpu_torch.sequences import load_fasta, load_fasta_python, make_sequence_set

    t_phase = time.time()
    named, pairs, scores = ctx["named"], ctx["pairs"], ctx["scores"]

    def records(seqs):
        return [(s.id, s.data.tobytes()) for s in seqs.sequences]

    # 12a. the parser
    big = work / "hla1000.fa"
    write_fasta(big, synth_hla(n_seqs=1000))
    parse = {}
    for tag, fa in (("headline", work / "hla25.fa"), ("locus", work / "locus.fa"), ("hla1000", big)):
        secs, got = {"cpp": [], "python": []}, {}
        for mode in in_turns("cpp", "python"):
            t0 = time.perf_counter()
            seqs = (load_fasta if mode == "cpp" else load_fasta_python)(fa)
            secs[mode].append(time.perf_counter() - t0)
            got[mode] = records(seqs)
        if got["cpp"] != got["python"]:
            raise AssertionError(f"the C++ parser and the Python loop read {fa.name} differently")
        parse[tag] = {"bytes": fa.stat().st_size, "records": len(got["cpp"]), **secs}
    print(f"FASTA parse, C++ against the Python loop, seconds in turns: {json.dumps(parse)} | {smi}")
    faults = {}
    for tag, data in fasta_faults().items():
        fa, gfa = work / f"fault_{tag}.fa", work / f"fault_{tag}.gfa"
        fa.write_bytes(data)
        try:
            if cli.main(["-s", str(fa), "-o", str(gfa), "--no-sort"]) != 0:
                raise RuntimeError(f"the {tag} run returned non-zero")
            faults[tag] = ("gfa", hashlib.sha256(gfa.read_bytes()).hexdigest())
        except RuntimeError as exc:
            faults[tag] = ("error", hashlib.sha256(str(exc).encode()).hexdigest())
    print(f"FASTA fault inputs --no-sort on the card: {json.dumps(faults)}; equal to the JAX package's "
          f"{faults == {k: tuple(v) for k, v in FASTA_FAULTS_JAX.items()}}")
    if faults != {k: tuple(v) for k, v in FASTA_FAULTS_JAX.items()}:
        raise AssertionError("a FASTA fault input does not give the JAX package's result")

    # 12b. the unite, in a fresh process
    runs = [("headline", str(work / "hla25.fa"), str(work / "split_hla25.gfa")),
            ("locus", str(work / "locus.fa"), str(work / "split_locus.gfa"))]
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--unite-split",
                           *[x for r in runs for x in r]], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
        raise AssertionError("the unite-split process failed")
    split = json.loads(proc.stdout.strip().splitlines()[-1])
    for tag, r in split.items():
        print(f"unite split, {tag}{' --no-sort (fresh process)' if 'gfa_sha256' in r else ''}: "
              + json.dumps(r) + f" | {smi}")
    if split["headline"]["gfa_sha256"] != DEFAULT_GFA_SHA256:
        raise AssertionError("the unite-split process's headline GFA is not the JAX package's")
    if Path(runs[1][2]).read_bytes() != (work / "locus_nosort.gfa").read_bytes():
        raise AssertionError("the unite-split process's locus GFA differs from phase 6's")
    sizes = {tag: split[tag] for tag in ("headline", "locus", "synthetic")}
    if not all(r["parents_equal"] for r in sizes.values()) or split["find"]["max_abs_err"]:
        raise AssertionError("the union-find kernels, their plain versions and the host unite disagree")
    if not all(r["compress_forest_moved"] > 0 for r in sizes.values()):
        raise AssertionError("a compress was checked on a forest with nothing to compress")
    for kind in ("pre_unite", "flush"):
        if not all(split["headline"]["uf_launches"][kind].get(k, 0) > 0 for k in UF_KERNELS):
            raise AssertionError(f"the headline run's {kind} did not launch the union-find kernels")
    print(f"phase 12 wall {time.time() - t_phase:.1f} s (12b done)")
    keys = ("edges", "parent_slots", "hooks", "unite_kernel_ms", "unite_kernel_ms_each", "compress_ms",
            "unite_bound_ms", "compress_bound_ms", "compress_forest_moved", "unite_in_turns_ms", "plain_host_reads",
            "compress_plain_ms",
            "edge_cast_s", "edge_copy_s", "flush_in_turns_s", "max_abs_err")
    h, launches = sizes["headline"], ctx["launches"]
    common = {"route": "cuda", "source": "seqrush_tpu_torch/ops/csrc/unionfind.cu",
              "max_abs_err": max(r["max_abs_err"] for r in sizes.values()), "library_ms": None,
              "shape": {"edges": h["edges"], "slots": h["parent_slots"]}, "bound_by": "bytes",
              "unite_plain_ms": statistics.median(h["unite_in_turns_ms"]["plain"]),
              "plain_host_reads": h["plain_host_reads"],
              **{tag: {k: sizes[tag][k] for k in keys} for tag in ("locus", "synthetic")}, "tolerance": 0}
    uf_entries = [
        {"name": "uf_unite", "replaces": "seqrush_tpu/ops/unionfind.py:105 (unite_edges; XLA while_loop)",
         "launches": launches["uf_unite"], "launches_path": "default run: the pre-unite and the flush",
         "ms": h["unite_kernel_ms"], "ms_each": h["unite_kernel_ms_each"], "plain_ms": common["unite_plain_ms"],
         "plain_of": "unite_edges_reference, its hooks and compression", "bound_ms": h["unite_bound_ms"],
         "unite_call_ms": statistics.median(h["unite_in_turns_ms"]["kernel"]),
         "ptxas": ptxas_registers(ctx["ptxas"], "uf_unite_kernel"), **common},
        {"name": "uf_compress",
         "replaces": "seqrush_tpu/ops/unionfind.py:88 (compress; XLA while_loop) and :133 (find, uf_find_kernel)",
         "launches": launches["uf_compress"],
         "launches_path": "compress() and count_components; no longer on the default run (the unite compresses)",
         "ms": h["compress_ms"], "plain_ms": h["compress_plain_ms"],
         "plain_of": "compress_reference on an uncompressed forest of the flush's slots (headline.deep_forest)",
         "bound_ms": h["compress_bound_ms"], "forest_slots_moved": h["compress_forest_moved"],
         "ptxas": ptxas_registers(ctx["ptxas"], "uf_compress_kernel"), "find": split["find"], **common},
    ]

    # 12c. the wavefront route with the C++ and the Python backtrace
    seqs = make_sequence_set(named)
    wcfg = RunnerConfig(scores=scores, kernel="wfa", band_slack=WFA_BAND_SLACK)
    backtrace, bt_native = wfa.backtrace_pair, native.backtrace_native
    bt_s = [0.0]

    def timed_backtrace(*a, **k):
        t0 = time.perf_counter()
        items = backtrace(*a, **k)
        bt_s[0] += time.perf_counter() - t0
        return items

    wall, own, digests = {"cpp": [], "python": []}, {"cpp": [], "python": []}, {}
    wfa.backtrace_pair = timed_backtrace
    try:
        for mode in in_turns("cpp", "python"):
            native.backtrace_native = bt_native if mode == "cpp" else (lambda *a, **k: None)
            bt_s[0] = 0.0
            al = WfaAligner(seqs, wcfg, device="cuda")
            t0 = time.perf_counter()
            res = al.align_pairs(pairs)
            torch.cuda.synchronize()
            wall[mode].append(time.perf_counter() - t0)
            own[mode].append(bt_s[0])
            digests.setdefault(mode, set()).add(records_digest(res))
    finally:
        wfa.backtrace_pair, native.backtrace_native = backtrace, bt_native
    sub = wfa_subset()
    sub_pairs = np.array([(i, j) for i in range(len(sub)) for j in range(len(sub)) if i != j])
    sub_digest = records_digest(WfaAligner(make_sequence_set(sub), wcfg, device="cuda").align_pairs(sub_pairs))
    kernel_ms = ctx["wfa_kernel_ms"]
    print(f"kernel='wfa' route, {len(pairs)} pairs, C++ against Python backtrace in turns: wall s "
          f"{json.dumps(wall)}; backtrace s {json.dumps(own)}; its launches' kernel time (phase 8b) "
          f"{kernel_ms:.3f} ms; records equal {len(set().union(*digests.values())) == 1}; subset sha256 "
          f"{sub_digest} | {smi}")
    if len(set().union(*digests.values())) != 1 or sub_digest != WFA_SUBSET_SHA256:
        raise AssertionError("the C++ and the Python backtrace disagree, or the subset is not the JAX package's")

    # 12d. the translocation pair's host walk
    tb, qlen, tlen, band, walked = ctx["translocation_walk"]
    walk_secs, items = {"cpp": [], "python": []}, {}
    nw_native = native.nw_traceback_native
    try:
        for mode in in_turns("cpp", "python"):
            native.nw_traceback_native = nw_native if mode == "cpp" else (lambda *a, **k: None)
            t0 = time.perf_counter()
            items[mode] = nw.traceback_pair(tb, qlen, tlen, band)
            walk_secs[mode].append(time.perf_counter() - t0)
    finally:
        native.nw_traceback_native = nw_native
    steps = sum(n for n, _ in items["cpp"])
    print(f"translocation pair host walk [{tb.shape[0]} x {tb.shape[1]} traceback, {steps} steps], C++ "
          f"against Python, seconds in turns: {json.dumps(walk_secs)}; items equal "
          f"{items['cpp'] == items['python'] == walked} | {smi}")
    if not items["cpp"] == items["python"] == walked:
        raise AssertionError("the C++ and the Python host walk disagree")
    del tb
    ctx.pop("translocation_walk")

    # 12e. the sweepga align phase, and chain_anchors' DP
    gfa_sw = work / "split_sweepga_nosort.gfa"
    rep, _launches, wall_sw = drive(gfa_sw, "--aligner", "sweepga", "--no-sort", kernels=BACKEND_KERNELS,
                                    fasta=work / "hla25.fa")
    digest = hashlib.sha256(gfa_sw.read_bytes()).hexdigest()
    codes = [encode_bases(s) for _, s in named]
    sets = []
    for j in range(1, len(codes)):
        a = anchors.anchor_matches(codes[0], codes[j])
        sets.append(a[np.lexsort((a[:, 1], a[:, 0]))])
    chain_secs, chains = {"cpp": [], "python": []}, {}
    for mode in in_turns("cpp", "python"):
        t0 = time.perf_counter()
        if mode == "cpp":
            chains[mode] = [list(native.chain_anchors_native(a, 15, anchors.DEFAULT_MAX_GAP,
                                                             anchors.DEFAULT_MAX_SKEW)) for a in sets]
        else:
            chains[mode] = [anchors._chain_indices_python(a, 15, anchors.DEFAULT_MAX_GAP, anchors.DEFAULT_MAX_SKEW)
                            for a in sets]
        chain_secs[mode].append(time.perf_counter() - t0)
    print(f"--aligner sweepga --no-sort: align phase {rep['phases_s']['align']:.4f} s, total {wall_sw:.2f} s, "
          f"GFA sha256 {digest}; chain_anchors over {len(sets)} pairs ({sum(a.shape[0] for a in sets)} "
          f"anchors), C++ against the Python lookback, seconds in turns {json.dumps(chain_secs)}; chains "
          f"equal {chains['cpp'] == chains['python']} | {smi}")
    if digest != SWEEPGA_GFA_SHA256 or chains["cpp"] != chains["python"]:
        raise AssertionError("the sweepga GFA is not the JAX package's, or the chaining DPs disagree")
    print(f"phase 12 wall {time.time() - t_phase:.1f} s")
    return uf_entries


if __name__ == "__main__":
    if sys.argv[1:2] == ["--unite-split"]:
        rest = sys.argv[2:]
        print(json.dumps(unite_split([tuple(rest[i : i + 3]) for i in range(0, len(rest), 3)])))
        sys.exit(0)
    sys.exit(main())
