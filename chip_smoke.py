#!/usr/bin/env python3
"""Drive seqrush_tpu_torch on one NVIDIA GPU and check it.

Run from the repository root with one CUDA device:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ok line):
  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. build the sweep and walk kernels from seqrush_tpu_torch/ops/csrc with
     nvcc (sm_90a), one process per source;
  3. the main path: the JAX bench's headline corpus (25 synthetic HLA-like
     sequences of ~3.3 kb, ~2% SNPs plus indels, one sample carrying an
     inversion; all 600 ordered pairs; scoring 0,5,8,2,24,1) through
     ``python -m seqrush_tpu_torch ... --no-sort --wide-route full`` (the
     CLI's main); the golden invariant gates the GFA write, and the kernels'
     launch counters are reset just before and read just after;
  4. a small corpus through the pipeline on cuda and on cpu (the kernels'
     plain versions): the GFA files must be byte-identical;
  5. each kernel against its plain PyTorch version on the card, on the
     main path's own chunk inputs (the largest dispatch in full, the widest
     band's first 7 jobs plus a zero-length padding row): exact equality
     (tolerance 0, all integer).  Kernel times are CUDA-event medians of 3
     runs after a warm-up, on the largest dispatch and on the widest one in
     full; the plain versions are timed once, on the largest dispatch.  The
     sweep is also timed at 1, 2 and 4 warps per pair on the largest
     dispatch and at each lanes-per-thread shape on the widest, each held
     bit-equal to the planner's launch; registers per thread, shared memory
     per block and resident pairs per SM come from the CUDA runtime and the
     launch code; the build's ptxas registers and spills are printed for
     every kernel;
  6. prints {"kernels": [...]}, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.

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
only raise the bound.  The walk needs one byte read and about 25
instructions per step it takes, at the issue rate, and writes the opcode
rows.
"""

from __future__ import annotations

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

HBM_BYTES_PER_S = 3.35e12
ISSUE_OPS_PER_S = 33.5e12  # 32-bit lane instructions of any kind
ALU_OPS_PER_S = 16.7e12  # integer minima, on the ALU pipe alone
SWEEP_OPS_PER_CELL = 37
SWEEP_MIN_OPS_PER_CELL = 11
WALK_OPS_PER_STEP = 25
REPS = 3
SCORES = "0,5,8,2,24,1"


def synth_hla(n_seqs=25, length=3300, seed=7):
    """HLA-like corpus: one base, ~2% SNPs and a few indels per sample, the
    last sample's middle third reverse-complemented (the JAX bench's
    headline generator)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = bases[rng.integers(0, 4, size=length)]
    out = [("gene*00", base.tobytes())]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for k in range(1, n_seqs):
        s = bytearray(base.tobytes())
        for pos in rng.integers(0, len(s), size=int(0.02 * len(s))):
            s[pos] = bases[rng.integers(0, 4)]
        for _ in range(rng.integers(2, 6)):
            pos = int(rng.integers(0, len(s) - 50))
            ln = int(rng.integers(1, 30))
            if rng.random() < 0.5:
                del s[pos : pos + ln]
            else:
                s[pos:pos] = bases[rng.integers(0, 4, size=ln)].tobytes()
        if k == n_seqs - 1:
            a, b = len(s) // 3, 2 * len(s) // 3
            s[a:b] = bytes(s[a:b]).translate(comp)[::-1]
        out.append((f"gene*{k:02d}", bytes(s)))
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


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel of nvcc's -Xptxas=-v log: its name,
    registers, barriers, stack frame and spill bytes."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            name, rest = m.group(2)[:n], m.group(2)[n:]
            t = re.match(r"ILi(\d+)ELb([01])E", rest)
            if t:
                name += f"<{t.group(1)}, {'two' if t.group(2) == '1' else 'one'}-piece>"
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
    from seqrush_tpu_torch.ops import nw_cuda

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} | torch {torch.__version__} cuda {torch.version.cuda} | {smi}")

    # 2. build
    t0 = time.time()
    lib_path, log = nw_cuda.build()
    print(f"build: {time.time() - t0:.2f} s -> {lib_path.relative_to(root)}")
    for line in ptxas_summary(log):
        print(f"  ptxas {line}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return run(Path(tmp), name, smi)


def run(work: Path, name: str, smi: str) -> int:
    from seqrush_tpu_torch import cli
    from seqrush_tpu_torch.align.pairs import all_ordered_pairs
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
    from seqrush_tpu_torch.ops import nw_cuda
    from seqrush_tpu_torch.scores import AlignmentScores
    from seqrush_tpu_torch.sequences import make_sequence_set

    named = synth_hla()
    fa, gfa, prof = work / "hla25.fa", work / "hla25.gfa", work / "profile.json"
    write_fasta(fa, named)

    # 3. main path, counters reset just before and read just after
    nw_cuda.reset_launch_counts()
    t0 = time.time()
    rc = cli.main(["-s", str(fa), "-o", str(gfa), "--no-sort", "--wide-route", "full",
                   "--profile", str(prof)])
    wall = time.time() - t0
    launches = dict(nw_cuda.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"main path returned {rc}")
    rep = json.loads(prof.read_text())
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
    print("  dispatches " + json.dumps([[d["B"], d["band"], d["tmax"], len(d["jobs"])]
                                        for d in st["dispatches"]]) + " ([B, band, tmax, jobs])")
    if n_align != 600 or g["paths"] != 25 or not lines or not lines[0].startswith("H\t"):
        raise AssertionError("main path output is not a 25-path GFA of 600 alignments")
    if st["dropped"]:
        raise AssertionError(f"{st['dropped']} pairs dropped")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")

    # 4. small corpus: cuda vs cpu, byte-identical GFA
    small = small_corpus()
    sfa = work / "small.fa"
    write_fasta(sfa, small)
    outs = {}
    for dev in ("cuda", "cpu"):
        out = work / f"small_{dev}.gfa"
        if cli.main(["-s", str(sfa), "-o", str(out), "--no-sort", "--device", dev]) != 0:
            raise RuntimeError(f"small corpus failed on {dev}")
        outs[dev] = out.read_bytes()
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError("cuda and cpu GFA differ on the small corpus")
    print(f"small corpus: cuda GFA == cpu GFA ({len(outs['cuda'])} bytes)")

    # 5. kernels against their plain versions, on the main path's inputs
    al = WfaAligner(make_sequence_set(named),
                    RunnerConfig(scores=AlignmentScores.parse(SCORES), wide_route="full"))
    pen = al._penalties()
    pairs = all_ordered_pairs(len(named))

    def chunk_inputs(d, n_jobs=None):
        jobs = d["jobs"][:n_jobs] if n_jobs else d["jobs"]
        entries = []
        for p, rc in jobs:
            qi, tj = pairs[p]
            q = al.rc_codes[qi] if rc else al.codes[qi]
            entries.append((p, bool(rc), d["band"], q, al.codes[tj]))
        Q, T, ql, tl, _tmax = al.pack_chunk(entries)
        dev = torch.device("cuda")
        return tuple(torch.from_numpy(a).to(dev) for a in (Q, T, ql, tl))

    def tb_bytes(d):
        return d["B"] * ((d["tmax"] + 1 + 127) // 128 * 128) * (d["band"] + 1)

    main_d = max(st["dispatches"], key=tb_bytes)
    wide_d = max(st["dispatches"], key=lambda d: (d["band"], tb_bytes(d)))
    two = pen["o2"] >= 0
    parity = []
    kernels = {}
    for label, d, n_jobs in (("largest", main_d, None), ("widest", wide_d, 7)):
        band, tmax = d["band"], d["tmax"]
        Q, T, ql, tl = chunk_inputs(d, n_jobs)
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
        print(f"parity {label}: B={B} W={W} tmax={tmax} sweep max_abs_err={err_a} "
              f"walk max_abs_err={err_b}")
        if err_a or err_b:
            raise AssertionError(f"kernel disagrees with its plain version ({label})")
        del s_p, tb_p, ops_p, ops_k
        if n_jobs:
            # time the kernels on the widest dispatch in full
            Q, T, ql, tl = chunk_inputs(d)
            B = Q.shape[0]
            s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
        plan = nw_cuda.plan_sweep(B, W, Q.shape[1], T.shape[1])
        occ = nw_cuda.sweep_occupancy(plan, W, two)
        sweep_ms = cuda_ms(lambda: nw_cuda.nw_align(Q, T, ql, tl, **kw), REPS)
        # each warps-per-pair shape, timed and held to the kernel's output
        # (itself held to the plain version above)
        if label == "largest":
            wpp_choices = (1, 2, 4)
        else:
            wpp_choices = sorted({-(-W // (32 * s)) for s in nw_cuda.SWEEP_LANES
                                  if -(-W // (32 * s)) * 32 <= nw_cuda._MAX_THREADS[s]})
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
        cells = int((ql + tl).to(torch.int64).sum().item()) * W
        sweep_bytes = Q.numel() + T.numel() + 8 * B + 4 * B + tb.numel()
        walk_bytes = steps + ops.numel() + 8 * B
        kernels[label] = {
            "shape": {"B": B, "W": W, "tmax": tmax},
            "sweep": (sweep_ms, sweep_bytes / HBM_BYTES_PER_S * 1e3,
                      cells * max(SWEEP_OPS_PER_CELL / ISSUE_OPS_PER_S,
                                  SWEEP_MIN_OPS_PER_CELL / ALU_OPS_PER_S) * 1e3),
            "walk": (walk_ms, walk_bytes / HBM_BYTES_PER_S * 1e3,
                     steps * WALK_OPS_PER_STEP / ISSUE_OPS_PER_S * 1e3),
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

    big, wide = kernels["largest"], kernels["widest"]
    out = []
    for kname, key, src, replaces, idx in (
        ("nw_sweep", "sweep", "seqrush_tpu_torch/ops/csrc/nw_sweep.cu", "seqrush_tpu/ops/nw_pallas.py:38", 0),
        ("nw_walk", "walk", "seqrush_tpu_torch/ops/csrc/nw_walk.cu", "seqrush_tpu/ops/nw_pallas.py:194", 1),
    ):
        ms, b_ms, o_ms = big[key]
        out.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(p[f"{key}_err"] for p in parity),
            "ms": ms, "plain_ms": big["plain"][idx],
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None,
            **big[f"{key}_occ"],
            "shape": big["shape"],
            "warps_per_pair_ms": big["wpp_ms"] if key == "sweep" else None,
            "widest": {"shape": wide["shape"], "ms": wide[key][0], "bound_ms": max(wide[key][1:]),
                       **wide[f"{key}_occ"],
                       "warps_per_pair_ms": wide["wpp_ms"] if key == "sweep" else None},
            "parity": parity, "tolerance": 0,
        })
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
