"""Time kernel A (the sweep) at chosen batch sizes and bands on one GPU.

    python3 seqrush_tpu_torch/tools/sweep_shapes.py [--shapes B:W,...]
        [--int16] [--each-strip] [--root DIR] [--ptxas]

The pairs are synthetic gene-length haplotypes made from seed 0 (a random
base of 3,300 bases, ~2% SNPs and a few indels per copy), packed as the
runner packs a chunk (lengths rounded up to 256, tmax to 512), with the
headline scoring 0,5,8,2,24,1.  For each shape B:W it prints one JSON line
with the time of ``nw_align`` (the planner's launch; a CUDA-event median of
5 runs after a warm-up).  With --each-strip it also times every other
lanes-per-thread strip that covers W, at as many warps as it needs, and on
the wide route each lanes a thread it is built for (``wide_plan(lanes=)``);
each is held bit-equal to ``nw_align``'s scores and traceback first.

--int16 times the int16 mode instead, with the int32 mode's time on the
same pairs beside it (``int32_ms``) and a sha256 of the int16 scores and
traceback; with --each-strip, every warps-a-twin count of the packed sweep
(``plan_sweep_i16``) and the int32 body's int16 mode at the planner's
int32 strip (``int32_body_ms``), each held bit-equal first.

--root imports seqrush_tpu_torch from another checkout, such as an earlier
commit unpacked with ``git archive`` (``load_root``, under a name of its
own); only ``nw_align`` is used then, so two versions of the kernel can be
timed on one card in one call.  --ptxas
first prints the registers, stack and spills ptxas reports for each kernel
of that checkout's build (empty when the library was already built).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

PENALTIES = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1)
LENGTH = 3300
REPS = 5


def make_pairs(B: int, length: int, seed: int):
    """B pairs (query, target) of ~length bases: a base with ~2% SNPs and
    two to five indels of 1-29 bases per copy."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, length).astype(np.uint8)

    def variant():
        v = base.copy()
        pos = rng.integers(0, length, length // 50)
        v[pos] = rng.integers(0, 4, pos.size)
        for _ in range(int(rng.integers(2, 6))):
            p = int(rng.integers(0, v.size - 50))
            n = int(rng.integers(1, 30))
            if rng.random() < 0.5:
                v = np.delete(v, np.arange(p, p + n))
            else:
                v = np.insert(v, p, rng.integers(0, 4, n).astype(np.uint8))
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
    tmax = -(-int((ql + tl).max()) // 512) * 512
    return [torch.from_numpy(a).to(device) for a in (Q, T, ql, tl)], tmax


def cuda_ms(fn, reps: int) -> float:
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


# cycles the card spins before a timed launch of a few microseconds (about
# 1 ms at 1.98 GHz), while the host enqueues it
SPIN_CYCLES = 2_000_000


def spun_ms(fn, reps: int, setup=None) -> float:
    """Median CUDA-event time of fn() over reps runs after one warm-up, each
    behind a spin of the card (torch.cuda._sleep) long enough for the host
    to enqueue fn's launches, so the events time the kernels alone and not
    the host's issue of a launch of a few microseconds (which cuda_ms
    counts).  With setup, each run calls fn(setup()), setup's work (a copy
    of an input the launch writes in place) done before the spin and left
    out of the time."""
    def inputs():
        return (setup(),) if setup is not None else ()

    fn(*inputs())
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        args = inputs()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn(*args)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int) -> float | None:
    """Mean device time of the CUDA kernels whose name holds `kernel` over
    reps calls of fn(), from the profiler's trace (None where it traces no
    device time): unlike cuda_ms it leaves out the host's time to issue a
    call, which exceeds a kernel's own below about 0.1 ms."""
    fn()
    torch.cuda.synchronize()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - a measurement that is not there is reported as such
        print(f"the profiler did not trace {kernel}: {exc!r}", file=sys.stderr)
        return None
    # the device events themselves: key_averages() has been seen to list no
    # device time for a kernel launched outside torch where events() holds it
    hits = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    total_us = sum(e.device_time for e in hits)
    return total_us / 1e3 / len(hits) if hits and total_us else None


def load_root(root: Path, alias: str):
    """root's seqrush_tpu_torch package imported as `alias` (its modules
    import each other relatively, so they resolve inside it); returns its
    ops.nw_cuda."""
    pkg = root / "seqrush_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops.nw_cuda")


def ptxas_lines(log: str, pick: str = "") -> list[str]:
    """ptxas' lines of nvcc's -Xptxas=-v log (registers; stack frame and
    spills), each after the name of its kernel, for the kernels whose
    mangled name holds pick."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and pick in name and ("Used" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def build_one(root: Path, src_name: str, out_dir: Path, flags: tuple[str, ...] = (),
              pick: str = "") -> tuple[Path, list[str]]:
    """nvcc of root's seqrush_tpu_torch/ops/csrc/<src_name> alone (with
    flags) into a library of its own under out_dir, named by a hash of the
    source and flags; returns its path and ptxas_lines(log, pick)."""
    from seqrush_tpu_torch.ops import nw_cuda

    src = root / "seqrush_tpu_torch" / "ops" / "csrc" / src_name
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    lib = out_dir / f"{Path(src_name).stem}-{tag}.so"
    out_dir.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([nw_cuda._nvcc(), *nw_cuda._NVCC_FLAGS, *flags, "-shared", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    return lib, ptxas_lines(res.stdout + res.stderr, pick)


def masked_rows_err(tb_k: torch.Tensor, tb_p: torch.Tensor, keep: torch.Tensor) -> int:
    """Largest |tb_k - tb_p| of two tracebacks [B, rows, W] over the rows
    keep [B, rows] marks (a mode that leaves the others unwritten), a slice
    of rows at a time."""
    if tb_k.shape != tb_p.shape:
        raise AssertionError(f"shape mismatch {tuple(tb_k.shape)} vs {tuple(tb_p.shape)}")
    step = max(1, (1 << 27) // max(1, tb_k[0].numel()))
    err = 0
    for k in range(0, tb_k.shape[0], step):
        diff = torch.where(keep[k : k + step, :, None],
                           tb_k[k : k + step].to(torch.int64) - tb_p[k : k + step].to(torch.int64), 0)
        err = max(err, int(diff.abs().max().item()) if diff.numel() else 0)
    return err


def snapshot_rows_err(tb_k: torch.Tensor, tb_p: torch.Tensor, t_snap: torch.Tensor, tmax: int) -> int:
    """masked_rows_err of two snapshot-mode tracebacks over the rows the mode
    promises (nw_cuda.snapshot_rows: each row's rows 0 .. t_snap + 1; the
    register route leaves the others unwritten)."""
    from seqrush_tpu_torch.ops import nw_cuda

    return masked_rows_err(tb_k, tb_p, nw_cuda.snapshot_rows(t_snap, tmax, tb_k.shape[1]))


def strips(nw_cuda, B: int, W: int, Lq: int, Lt: int):
    """(label, plan) of every strip that covers W: on the register route
    each lanes a thread at as many warps as it needs, on the wide route
    (W > REG_MAX_W) each lanes a thread it is built for."""
    out = []
    if W <= nw_cuda.REG_MAX_W:
        for s in nw_cuda.SWEEP_LANES:
            wpp = -(-W // (32 * s))
            if 32 * wpp <= nw_cuda._MAX_THREADS[s]:
                out.append((f"{s} lanes x {wpp} warps", nw_cuda._regs_plan(B, W, Lq, Lt, s, wpp, None)))
    else:
        for s in nw_cuda.WIDE_LANES:
            plan = nw_cuda.wide_plan(B, W, lanes=s)
            out.append((f"wide, {s} lanes x {plan.threads} threads x {plan.ctas} CTAs", plan))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="576:512,48:1536")
    ap.add_argument("--int16", action="store_true")
    ap.add_argument("--each-strip", action="store_true")
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2])
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_shapes: no CUDA device", file=sys.stderr)
        return 2
    nw_cuda = load_root(args.root.resolve(), "_sweep_root")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    if args.ptxas:
        _path, log = nw_cuda.build()
        for line in ptxas_lines(log):
            print(json.dumps({"root": str(args.root), "ptxas": line}), flush=True)
    dev = torch.device("cuda")
    for spec in args.shapes.split(","):
        B, W = (int(x) for x in spec.split(":"))
        (Q, T, ql, tl), tmax = pack(make_pairs(B, LENGTH, 0), dev)
        kw = dict(PENALTIES, band=W - 1, tmax=tmax)
        if args.int16:
            kw["int16"] = True
        s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
        row = {"root": str(args.root), "B": B, "W": W, "tmax": tmax, "card": smi,
               "nw_align_ms": cuda_ms(lambda: nw_cuda.nw_align(Q, T, ql, tl, **kw), REPS)}
        if hasattr(nw_cuda, "plan_sweep"):
            row["plan"] = repr(nw_cuda.plan_sweep(B, W, Q.shape[1], T.shape[1]))
        if args.int16:
            kw32 = dict(kw, int16=False)
            row["int32_ms"] = cuda_ms(lambda: nw_cuda.nw_align(Q, T, ql, tl, **kw32), REPS)
            digest = hashlib.sha256(s_k.cpu().numpy().tobytes())
            digest.update(tb_k.cpu().numpy().tobytes())
            row["sha256"] = digest.hexdigest()[:16]
            if hasattr(nw_cuda, "plan_sweep_i16"):
                row["plan"] = repr(nw_cuda.plan_sweep_i16(B, W, Q.shape[1], T.shape[1]))
        if args.each_strip and args.int16:
            row["strips_ms"] = {}
            plans = [(f"int32 body, {p.lanes} lanes x {p.warps_per_pair} warps", p)
                     for p in [nw_cuda.plan_sweep(B, W, Q.shape[1], T.shape[1])] if p.route == "regs"]
            for w in (1, 2, 4, 8, 16, 32):
                try:
                    p = nw_cuda.plan_sweep_i16(B, W, Q.shape[1], T.shape[1], warps_per_twin=w)
                except ValueError:
                    continue
                if p.route == "twins":
                    plans.append((f"twins, {p.lanes} lanes x {w} warps", p))
            for label, plan in plans:
                s_w, tb_w = nw_cuda.sweep_launch(Q, T, ql, tl, plan, **kw)
                if not (torch.equal(s_w, s_k) and torch.equal(tb_w, tb_k)):
                    raise AssertionError(f"{label} disagrees with nw_align at B={B} W={W}")
                del s_w, tb_w
                row["strips_ms"][label] = cuda_ms(
                    lambda: nw_cuda.sweep_launch(Q, T, ql, tl, plan, **kw), REPS)
        elif args.each_strip:
            row["strips_ms"] = {}
            for label, plan in strips(nw_cuda, B, W, Q.shape[1], T.shape[1]):
                s_w, tb_w = nw_cuda.sweep_launch(Q, T, ql, tl, plan, **kw)
                if not (torch.equal(s_w, s_k) and torch.equal(tb_w, tb_k)):
                    raise AssertionError(f"{label} disagrees with nw_align at B={B} W={W}")
                del s_w, tb_w
                row["strips_ms"][label] = cuda_ms(
                    lambda: nw_cuda.sweep_launch(Q, T, ql, tl, plan, **kw), REPS)
        print(json.dumps(row), flush=True)
        del s_k, tb_k, Q, T, ql, tl
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
