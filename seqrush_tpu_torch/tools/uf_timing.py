"""Time the union-find's unite of checkouts in turns on one GPU, with the hook's own split.

    python -m seqrush_tpu_torch.tools.uf_timing [--root DIR ...]
        [--flushes headline,locus,synthetic] [--reps 5] [--spread 10]

The flushes are the pipeline's own: the headline corpus
(``tools/headline.py::synth_hla``, 25 x ~3.3 kb, 600 ordered pairs) and the
8 x 60 kb locus (``chip_smoke.synth_locus``), each run through the CLI on the
card with ``--no-sort`` while ``unionfind.unite_edges`` is watched, its
largest unite (the flush) kept with the parent it started from; and the
synthetic flush at the top of the users' range (1,000 x 3.3 kb, 50,000,000
edges of match runs after the F/R pre-unite,
``tools/headline.py::synth_flush_edges``).  The edges lie on the card as
int32 before any timing.

Each ``--root`` is a checkout (the default: this one; an older commit
unpacked with ``git archive``): its ``csrc/unionfind.cu`` alone is compiled
with nvcc into a library of its own (``sweep_shapes.build_one``; ptxas'
registers printed), and, where the source has the hook's timer
(``UF_TIMED``), once more with it into a second library.  A root's unite is its launch path: one launch of
``uf_unite_launch`` where the library has it (the grid from this checkout's
``unionfind.unite_grid``), else ``uf_hook_launch`` then
``uf_compress_launch``.  Per flush the roots run in turns, forward then
backward (A B B A), each turn the CUDA-event median of ``--reps`` unites
after a warm-up, each behind a spin of the card while the host enqueues it
(``sweep_shapes.spun_ms``); each unite works on a copy of the flush's
parent made before the spin, so only its launches are timed.  Every root's
parent must equal this checkout's ``unite_edges_reference`` (the headline
and locus flushes) or the first root's (the synthetic one), on every run.
``--spread`` more unites of the synthetic flush a root give the spread
between runs.  Then, in turns the same way, each root's compress launch
alone on an uncompressed forest of the flush's slots
(``headline.deep_forest``; a copy made before each spin), equal to
``compress_reference``.

A root with the timer is then launched once a flush with it: per edge the
finds, hops a find (and the most), cycles a find, halving stores, CAS
attempts and failures, the edges whose ends had one parent at the first
hop and those done without a CAS; the compress's hops a slot; the
grid-stride tail (the last warp's end against the median warp's, from each
warp's %globaltimer); the L2 sectors an edge reckoned from those counts
(each end's first hop a quarter sector, as 32 consecutive edges of a match
run read 8 sectors a side; every later hop, store and CAS one) against the
rate this card serves scattered 4-byte loads at (``uf_l2_probe``, measured
here over a 26 MB array); and ``--spread`` timed runs of the synthetic flush,
whose fastest and slowest runs' counts are printed side by side.  Prints
one JSON line a flush and root, each with the nvidia-smi name and power
limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .headline import deep_forest
from .sweep_shapes import build_one, spun_ms

_REPO = Path(__file__).resolve().parents[2]


class Unite:
    """One checkout's union-find library, called through ctypes."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.fused = hasattr(lib, "uf_unite_launch")
        self.timed = hasattr(lib, "uf_timed_launch")
        if self.fused:
            lib.uf_unite_launch.argtypes = [ptr] * 3 + [i64, i32, i32, ptr]
            lib.uf_unite_launch.restype = i32
            lib.uf_unite_occupancy.argtypes = [ptr, ptr]
            lib.uf_unite_occupancy.restype = i32
        else:
            lib.uf_hook_launch.argtypes = [ptr] * 3 + [i64, i32, ptr]
            lib.uf_hook_launch.restype = i32
        lib.uf_compress_launch.argtypes = [ptr, i32, ptr]
        lib.uf_compress_launch.restype = i32
        if self.timed:
            lib.uf_timed_warps.argtypes = [i64, i32]
            lib.uf_timed_warps.restype = i32
            lib.uf_timed_launch.argtypes = [ptr] * 3 + [i64, i32, ptr, ptr, ptr]
            lib.uf_timed_launch.restype = i32
            lib.uf_l2_probe_launch.argtypes = [ptr, i32, i32, ptr, ptr]
            lib.uf_l2_probe_launch.restype = i32
            lib.uf_l2_probe_threads.restype = i32
        self.lib = lib

    def grid(self, n_edges: int, n_slots: int) -> int:
        from seqrush_tpu_torch.ops import unionfind as uf

        bps, sms = ctypes.c_int(), ctypes.c_int()
        err = self.lib.uf_unite_occupancy(ctypes.byref(bps), ctypes.byref(sms))
        if err:
            raise RuntimeError(f"uf_unite_occupancy failed with CUDA error {err}")
        return uf.unite_grid(n_edges, n_slots, bps.value, sms.value)

    def launch(self, p: torch.Tensor, u: torch.Tensor, v: torch.Tensor, grid: int) -> None:
        """The root's unite in place on p: its launch path's kernels (grid:
        the fused launch's blocks, from grid())."""
        stream = torch.cuda.current_stream().cuda_stream
        if self.fused:
            err = self.lib.uf_unite_launch(p.data_ptr(), u.data_ptr(), v.data_ptr(), u.numel(), p.numel(), grid,
                                           stream)
        else:
            err = self.lib.uf_hook_launch(p.data_ptr(), u.data_ptr(), v.data_ptr(), u.numel(), p.numel(), stream)
            err = err or self.lib.uf_compress_launch(p.data_ptr(), p.numel(), stream)
        if err:
            raise RuntimeError(f"unite launch failed with CUDA error {err}")

    def unite(self, p0: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """The root's unite on a copy of p0."""
        p = p0.clone()
        self.launch(p, u, v, self.grid(u.numel(), p.numel()) if self.fused else 0)
        return p

    def compress(self, p: torch.Tensor) -> None:
        """The root's compress launch alone, in place on p."""
        err = self.lib.uf_compress_launch(p.data_ptr(), p.numel(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"compress launch failed with CUDA error {err}")

    def timed_unite(self, p0, u, v) -> tuple[torch.Tensor, dict, float]:
        """One unite with the timer: (parent, counts by name with the warps'
        tail, CUDA-event ms of the timed launch)."""
        from seqrush_tpu_torch.ops import unionfind as uf

        p = p0.clone()
        counts = torch.zeros(len(uf.UF_COUNTS), dtype=torch.int64, device=p.device)
        n_warps = self.lib.uf_timed_warps(u.numel(), p.numel())
        warp_ns = torch.zeros(2 * n_warps, dtype=torch.int64, device=p.device)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        start.record()
        err = self.lib.uf_timed_launch(p.data_ptr(), u.data_ptr(), v.data_ptr(), u.numel(), p.numel(),
                                       counts.data_ptr(), warp_ns.data_ptr(), torch.cuda.current_stream().cuda_stream)
        stop.record()
        if err:
            raise RuntimeError(f"timed unite launch failed with CUDA error {err}")
        stop.synchronize()
        out = dict(zip(uf.UF_COUNTS, counts.cpu().tolist()))
        w = warp_ns.view(-1, 2).cpu().numpy()
        w = w[w[:, 1] > 0]
        t0 = int(w[:, 0].min())
        ends = (w[:, 1] - t0) / 1e3
        out["warp_end_us_median"] = float(np.median(ends))
        out["warp_end_us_last"] = float(ends.max())
        out["warp_start_us_last"] = float((w[:, 0] - t0).max() / 1e3)
        return p, out, start.elapsed_time(stop)

    def l2_probe(self, dev) -> dict:
        """Scattered 4-byte loads a second from a 26 MB array resident in L2."""
        n, per = 6_600_002, 64
        data = torch.zeros(n, dtype=torch.int32, device=dev)
        sink = torch.zeros(1, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            err = self.lib.uf_l2_probe_launch(data.data_ptr(), n, per, sink.data_ptr(), stream)
            if err:
                raise RuntimeError(f"L2 probe launch failed with CUDA error {err}")

        ms = spun_ms(run, 5)
        loads = self.lib.uf_l2_probe_threads() * per
        return {"loads": loads, "ms": ms, "sectors_per_s": loads / (ms / 1e3)}


def reckon(c: dict, n_slots: int, probe: dict | None) -> dict:
    """Per-edge figures of a timed run and the L2 sectors they imply."""
    e = max(c["edges"], 1)
    first = 2 * c["edges"]
    sectors = 0.25 * e + 0.25 * first + max(c["hops"] - first, 0) + c["halving_stores"] + c["cas"]
    comp_sectors = n_slots / 8 + max(c["compress_hops"] - n_slots, 0) + n_slots
    out = {"finds_per_edge": c["finds"] / e, "hops_per_find": c["hops"] / max(c["finds"], 1),
           "max_hops": c["max_hops"], "cycles_per_find": c["find_cycles"] / max(c["finds"], 1),
           "stores_per_edge": c["halving_stores"] / e, "cas_per_edge": c["cas"] / e,
           "cas_failed_per_edge": c["cas_failed"] / e, "first_hop_equal_share": c["first_hop_equal"] / e,
           "no_cas_share": c["no_cas"] / e, "compress_hops_per_slot": c["compress_hops"] / max(n_slots, 1),
           "hook_sectors_per_edge": sectors / e, "hook_sectors": sectors, "compress_sectors": comp_sectors,
           "tail_us": c["warp_end_us_last"] - c["warp_end_us_median"]}
    if probe:
        out["hook_sectors_ms_at_probe_rate"] = sectors / probe["sectors_per_s"] * 1e3
        out["compress_sectors_ms_at_probe_rate"] = comp_sectors / probe["sectors_per_s"] * 1e3
    return out


def pipeline_flush(fasta: Path, gfa: Path):
    """The CLI's largest unite on the card (--no-sort): (parent before it,
    u, v) as int64 numpy edges and an int32 numpy parent."""
    from seqrush_tpu_torch import cli
    from seqrush_tpu_torch.ops import unionfind as uf

    seen = []
    unite = uf.unite_edges

    def watched(parent, u, v):
        seen.append((parent.to("cpu", torch.int32, copy=True).numpy(), np.asarray(u), np.asarray(v)))
        return unite(parent, u, v)

    uf.unite_edges = watched
    try:
        if cli.main(["-s", str(fasta), "-o", str(gfa), "--no-sort"]) != 0:
            raise RuntimeError(f"the run on {fasta} failed")
    finally:
        uf.unite_edges = unite
    return max(seen, key=lambda f: f[1].size)


def flushes(names: set[str], work: Path) -> dict:
    """name -> (parent0 int32 numpy, u int64, v int64)."""
    sys.path.insert(0, str(_REPO))
    import chip_smoke

    from seqrush_tpu_torch.ops import unionfind as uf

    from .headline import synth_flush_edges, synth_hla

    out = {}
    if "headline" in names:
        fa = work / "headline.fa"
        chip_smoke.write_fasta(fa, synth_hla())
        out["headline"] = pipeline_flush(fa, work / "headline.gfa")
    if "locus" in names:
        fa = work / "locus.fa"
        chip_smoke.write_fasta(fa, chip_smoke.synth_locus())
        out["locus"] = pipeline_flush(fa, work / "locus.gfa")
    if "synthetic" in names:
        n_seqs, length = 1000, 3300
        u, v = synth_flush_edges(n_seqs=n_seqs, length=length, n_edges=chip_smoke.SYNTH_FLUSH_EDGES)
        i = np.arange(n_seqs * length, dtype=np.int64)
        p0 = uf.unite_edges_reference(uf.create(2 * n_seqs * length + 2, "cuda"), i << 1, (i << 1) | 1)
        out["synthetic"] = (p0.cpu().numpy(), u, v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", help="a checkout whose unite is timed (default: this one)")
    ap.add_argument("--flushes", default="headline,locus,synthetic")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--spread", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("uf_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_REPO))
    from seqrush_tpu_torch.ops import unionfind as uf

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    out_dir = _REPO / "build" / "uf_timing"
    libs, timed_libs = {}, {}
    for spec in args.root or [str(_REPO)]:
        root = Path(spec).resolve()
        path, ptxas = build_one(root, "unionfind.cu", out_dir)
        libs[spec] = Unite(path)
        src = (root / "seqrush_tpu_torch" / "ops" / "csrc" / "unionfind.cu").read_text()
        if "UF_TIMED" in src:
            tpath, tptxas = build_one(root, "unionfind.cu", out_dir, ("-DUF_TIMED",))
            timed_libs[spec] = Unite(tpath)
            ptxas += [f"timed {x}" for x in tptxas]
        print(json.dumps({"root": spec, "fused": libs[spec].fused, "timer": spec in timed_libs, "ptxas": ptxas,
                          "card": smi}), flush=True)
    probe = None
    if timed_libs:
        probe = next(iter(timed_libs.values())).l2_probe(dev)
        print(json.dumps({"l2_probe": probe, "card": smi}), flush=True)
    order = list(libs)
    turns = order + order[::-1]
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cases = flushes(set(args.flushes.split(",")), Path(tmp))
    for name, (parent0, u, v) in cases.items():
        p0 = torch.from_numpy(parent0).to(dev)
        ud = torch.from_numpy(u.astype(np.int32)).to(dev)
        vd = torch.from_numpy(v.astype(np.int32)).to(dev)
        want = uf.unite_edges_reference(p0, ud, vd) if name != "synthetic" else libs[order[0]].unite(p0, ud, vd)
        for r in order:
            if not torch.equal(libs[r].unite(p0, ud, vd), want):
                raise AssertionError(f"{r}'s unite differs on the {name} flush")
        grids = {r: libs[r].grid(ud.numel(), p0.numel()) if libs[r].fused else 0 for r in order}

        def unite_ms(r, reps):
            # the copy of the parent is made before the spin: the launches alone are timed
            return spun_ms(lambda p: libs[r].launch(p, ud, vd, grids[r]), reps, setup=p0.clone)

        times = {r: [] for r in order}
        for r in turns:
            times[r].append(unite_ms(r, args.reps))
        spread = {}
        if name == "synthetic":
            for r in order:
                spread[r] = [unite_ms(r, 1) for _ in range(args.spread)]
                if not torch.equal(libs[r].unite(p0, ud, vd), want):
                    raise AssertionError(f"{r}'s unite differs between runs of the {name} flush")
        # the compress launch alone on an uncompressed forest of the flush's slots
        forest = torch.from_numpy(deep_forest(p0.numel())).to(dev)
        forest_want = uf.compress_reference(forest)
        comp_times = {r: [] for r in order}
        for r in order:
            got = forest.clone()
            libs[r].compress(got)
            if not torch.equal(got, forest_want):
                raise AssertionError(f"{r}'s compress differs on the {name} flush's forest")
        for r in turns:
            comp_times[r].append(spun_ms(libs[r].compress, args.reps, setup=forest.clone))
        forest_hops = int((forest != forest_want).sum())
        hooks = int((p0 == torch.arange(p0.numel(), dtype=p0.dtype, device=dev)).sum()) - int(
            (want == torch.arange(want.numel(), dtype=want.dtype, device=dev)).sum())
        for r in order:
            row = {"flush": name, "root": r, "edges": int(u.size), "slots": int(parent0.size), "hooks": hooks,
                   "unite_ms": times[r], "unite_ms_median": statistics.median(times[r]),
                   "compress_forest_ms": comp_times[r], "compress_forest_ms_median": statistics.median(comp_times[r]),
                   "forest_slots_off_their_root": forest_hops, "card": smi}
            if r in spread:
                row["spread_ms"] = spread[r]
                row["spread_max_over_min"] = max(spread[r]) / min(spread[r])
            if r in timed_libs:
                runs = []
                for _ in range(args.spread if name == "synthetic" else 1):
                    got, counts, ms = timed_libs[r].timed_unite(p0, ud, vd)
                    if not torch.equal(got, want):
                        raise AssertionError(f"{r}'s timed unite differs on the {name} flush")
                    runs.append((ms, counts))
                runs.sort(key=lambda x: x[0])
                ms, counts = runs[len(runs) // 2]
                row["split"] = {"timed_ms": ms, **counts, **reckon(counts, int(parent0.size), probe)}
                if len(runs) > 1:
                    row["split_fastest"] = {"timed_ms": runs[0][0], **runs[0][1]}
                    row["split_slowest"] = {"timed_ms": runs[-1][0], **runs[-1][1]}
            print(json.dumps(row), flush=True)
        del p0, ud, vd, want, forest, forest_want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
