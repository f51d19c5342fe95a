"""Time the long-pair route's launches at chosen shapes on one GPU.

    python3 seqrush_tpu_torch/tools/long_shapes.py [--shapes B:W,...]
        [--length N] [--seg N]

The pairs are synthetic locus haplotypes made from seed 0 (one random base
of --length bases, 0.1% SNPs and two 20-base deletions per copy, the recipe
of chip_smoke.py's locus), packed as the runner packs a chunk, with the
headline scoring 0,5,8,2,24,1.  For each shape B:W it prints one JSON line:
for every lanes-per-thread strip that covers W, the forward pass of every
segment in one launch (``nw_align_segment_run``), the grouped recompute of
LONG_RUN segments and of every segment (``nw_align_segment_group``), each a
CUDA-event median of 3 runs after a warm-up and held bit-equal to the
planner's launch first; the planner's picks; the group walk over every
segment; the route (``nw_align_long``) as the package runs it; and the
route's launches at the planner's shapes in turns on one stream (the
forward pass in one launch, the recompute of every segment in one launch,
the group walk) and overlapped as ``nw_align_long`` overlaps them, at each
--runs length of a forward launch (the package runs LONG_RUN).

--root imports seqrush_tpu_torch from another checkout, such as an earlier
commit unpacked with ``git archive``, so two versions can be timed on one
card in one call; --strips 0 leaves out the strips other than the planner's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

PENALTIES = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1)
REPS = 3


def make_pairs(B: int, length: int, seed: int):
    """B pairs of haplotypes of one seeded base: 0.1% SNPs and two 20-base
    deletions per copy."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, length).astype(np.uint8)

    def variant():
        v = base.copy()
        pos = rng.integers(0, length, length // 1000)
        v[pos] = rng.integers(0, 4, pos.size)
        for p in sorted(rng.integers(1000, length - 1000, 2), reverse=True):
            v = np.delete(v, np.arange(p, p + 20))
        return v

    return [(variant(), variant()) for _ in range(B)]


def pack(pairs, device):
    B = len(pairs)
    lq = -(-max(q.size for q, _ in pairs) // 256) * 256
    lt = -(-max(t.size for _, t in pairs) // 256) * 256
    Q = np.full((B, lq), 6, np.uint8)
    T = np.full((B, lt), 7, np.uint8)
    for b, (q, t) in enumerate(pairs):
        Q[b, : q.size] = q
        T[b, : t.size] = t
    ql = np.array([q.size for q, _ in pairs], np.int32)
    tl = np.array([t.size for _, t in pairs], np.int32)
    return [torch.from_numpy(a).to(device) for a in (Q, T, ql, tl)]


def cuda_ms(fn, reps: int = REPS) -> float:
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


def overlapped(nw_cuda, Q, T, ql, tl, *, n_seg, run, seg, band, pen):
    """nw_align_long's launches at G = n_seg with forward runs of `run`
    segments: each run on the current stream, its recompute after it on a
    second stream, then the group walk there."""
    B, W = Q.shape[0], band + 1
    dev = Q.device
    main, side = torch.cuda.current_stream(), torch.cuda.Stream()
    ckpt = torch.empty((n_seg, 6, B, W), dtype=torch.int32, device=dev)
    ckpt[0] = nw_cuda.initial_carry(B, W, dev)
    scores = torch.full((B,), -1, dtype=torch.int32, device=dev)
    ops = torch.zeros((B, n_seg * seg + 1), dtype=torch.uint8, device=dev)
    state = nw_cuda.walk_state(ql, tl, band=band)
    tb = torch.empty((B, n_seg * seg, W), dtype=torch.uint8, device=dev)
    side.wait_stream(main)
    for s0 in range(0, n_seg, run):
        n_run = min(run, n_seg - s0)
        scores = nw_cuda.nw_align_segment_run(Q, T, ql, tl, ckpt, scores, s0=s0, n_run=n_run,
                                              seg=seg, band=band, **pen)
        done = torch.cuda.Event()
        done.record(main)
        side.wait_event(done)
        with torch.cuda.stream(side):
            nw_cuda.nw_align_segment_group(Q, T, ql, tl, ckpt, s0=s0, G=n_run, seg=seg, tb=tb,
                                           row0=s0 * seg, band=band, **pen)
    with torch.cuda.stream(side):
        nw_cuda.nw_walk_segment_group(tb, state, ops, s0=0, G=n_seg, seg=seg, band=band)
    main.wait_stream(side)
    return scores, ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="48:384,16:512")
    ap.add_argument("--length", type=int, default=60_000)
    ap.add_argument("--seg", type=int, default=2048)
    ap.add_argument("--runs", default="2,4,8",
                    help="forward segments a launch to time the overlapped launches at")
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2])
    ap.add_argument("--strips", type=int, default=1)
    args = ap.parse_args(argv)
    args.runs = [int(x) for x in args.runs.split(",")]
    if not torch.cuda.is_available():
        print("long_shapes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from seqrush_tpu_torch.ops import nw_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    seg = args.seg
    for spec in args.shapes.split(","):
        B, W = (int(x) for x in spec.split(":"))
        Q, T, ql, tl = pack(make_pairs(B, args.length, 0), dev)
        t_need = int((ql + tl).max())
        n_seg = -(-t_need // seg)
        R = min(nw_cuda.LONG_RUN, n_seg)
        kw = dict(PENALTIES, band=W - 1, seg=seg)
        pen = dict(PENALTIES, band=W - 1)
        Lq, Lt = Q.shape[1], T.shape[1]
        ckpt = torch.empty((n_seg, 6, B, W), dtype=torch.int32, device=dev)
        ckpt[0] = nw_cuda.initial_carry(B, W, dev)
        s0 = torch.full((B,), -1, dtype=torch.int32, device=dev)
        scores = nw_cuda.nw_align_segment_run(Q, T, ql, tl, ckpt, s0, s0=0, n_run=n_seg, **kw)
        ref_ckpt = ckpt.clone()
        _, tb_ref = nw_cuda.nw_align_segment_group(Q, T, ql, tl, ckpt, s0=0, G=n_seg, **kw)
        row = {"root": str(args.root), "B": B, "W": W, "n_seg": n_seg, "seg": seg, "card": smi,
               "plan_forward": repr(nw_cuda.plan_sweep(B, W, Lq, Lt, seg=seg)),
               "plan_group_run": repr(nw_cuda.plan_sweep(B, W, Lq, Lt, seg=seg, groups=R)),
               "plan_group_all": repr(nw_cuda.plan_sweep(B, W, Lq, Lt, seg=seg, groups=n_seg)),
               "strips": {}}
        planned = nw_cuda.plan_sweep(B, W, Lq, Lt, seg=seg).lanes
        for s in nw_cuda.SWEEP_LANES:
            wpp = -(-W // (32 * s))
            if (W > nw_cuda.REG_MAX_W or 32 * wpp > nw_cuda._MAX_THREADS[s]
                    or (not args.strips and s != planned)):
                continue
            plans = {g: nw_cuda._regs_plan(B, W, Lq, Lt, s, wpp, seg, g) for g in (1, R, n_seg)}
            sc = torch.empty_like(s0)
            tb = torch.empty_like(tb_ref)

            def forward():  # the forward pass in one launch at this strip
                nw_cuda._seg_launch(Q, T, ql, tl, ckpt[0], ckpt[1], s0, sc, None, 0, plans[1],
                                    t_lo=1, seg=seg, n_run=n_seg, n_out=n_seg - 1, **pen)

            def group(G):  # the recompute of segments 0 .. G - 1 in one launch
                gs = torch.full_like(s0, -1)
                nw_cuda._seg_launch(Q, T, ql, tl, ckpt[0], None, None, gs, tb, 0, plans[G],
                                    t_lo=1, seg=seg, n_run=1, n_out=0, **pen)

            forward()
            group(n_seg)
            if not (torch.equal(sc, scores) and torch.equal(ckpt, ref_ckpt)
                    and torch.equal(tb, tb_ref)):
                raise AssertionError(f"strip {s} x {wpp} disagrees with the planner's launches")
            row["strips"][f"{s} lanes x {wpp} warps"] = {
                "forward_ms": cuda_ms(forward),
                f"group_{R}_ms": cuda_ms(lambda: group(R)),
                "group_all_ms": cuda_ms(lambda: group(n_seg)),
            }
            del tb
        state = nw_cuda.walk_state(ql, tl, band=W - 1)
        ops = torch.zeros((B, n_seg * seg + 1), dtype=torch.uint8, device=dev)
        row["group_walk_ms"] = cuda_ms(lambda: nw_cuda.nw_walk_segment_group(
            tb_ref, state, ops, s0=0, G=n_seg, seg=seg, band=W - 1))
        s_long, ops_long = nw_cuda.nw_align_long(Q, T, ql, tl, t_need=t_need, **kw)
        for run in args.runs:
            s_r, ops_r = overlapped(nw_cuda, Q, T, ql, tl, n_seg=n_seg, run=run, seg=seg, pen=PENALTIES,
                                    band=W - 1)
            if not (torch.equal(s_r, s_long) and torch.equal(ops_r, ops_long)):
                raise AssertionError(f"the overlapped launches in runs of {run} disagree with "
                                     "nw_align_long")
        del s_long, ops_long

        def in_turns():
            ck = torch.empty_like(ckpt)
            ck[0] = ckpt[0]
            nw_cuda.nw_align_segment_run(Q, T, ql, tl, ck, s0, s0=0, n_run=n_seg, **kw)
            _, tb = nw_cuda.nw_align_segment_group(Q, T, ql, tl, ck, s0=0, G=n_seg, **kw)
            nw_cuda.nw_walk_segment_group(tb, nw_cuda.walk_state(ql, tl, band=W - 1),
                                          torch.zeros_like(ops), s0=0, G=n_seg, seg=seg, band=W - 1)

        row["route_ms"] = {
            f"nw_align_long (runs of {nw_cuda.LONG_RUN})": cuda_ms(
                lambda: nw_cuda.nw_align_long(Q, T, ql, tl, t_need=t_need, **kw)),
            "overlap off": cuda_ms(in_turns)}
        for run in args.runs:
            row["route_ms"][f"overlap on, runs of {run}"] = cuda_ms(lambda: overlapped(
                nw_cuda, Q, T, ql, tl, n_seg=n_seg, run=run, seg=seg, pen=PENALTIES, band=W - 1))
        print(json.dumps(row), flush=True)
        del Q, T, ql, tl, ckpt, ref_ckpt, tb_ref, ops
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
