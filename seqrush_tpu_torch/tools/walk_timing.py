"""Time kernel B's runs walk of checkouts in turns on one GPU, with the walk's own phase split.

    python -m seqrush_tpu_torch.tools.walk_timing [--root DIR ...]
        [--sites largest,window,gap,tiled,corpus] [--reps 5]

The sites are the launch sites ``chip_smoke.py`` phases 8a and 10b hold the
walk to, rebuilt here from the runner's own dispatch records on the headline
corpus (``tools/headline.py::synth_hla``, 600 ordered pairs, scoring
0,5,8,2,24,1): the default run's largest chunk [576, W 512] (run budget
``nw.RUN_MAX``) and its first window chunk [64, W 1170]
(``anchored.WIN_RUN_MAX``), the sweepga backend's device gap chunk [64, W
128] (``sweep.GAP_RUN_MAX``), ``band_tiling='auto'``'s merged chunk [704
rows, W 512, 3 tiles] for the tiled walk, and the gap corpus
(``tools/headline.py::walk_gap_corpus``).  Each traceback comes from this
checkout's kernel A.

Each ``--root`` is a checkout (the default: this one; an older commit
unpacked with ``git archive``, or a copy with other design constants at the
top of its ``nw_walk.cu``): its ``csrc/nw_walk.cu`` alone is compiled with
nvcc into a library of its own (ptxas' registers printed) and its launch
functions are called through ctypes on the same tensors, so two designs of
the walk run on one card in one process.  Per site the roots run in turns,
forward then backward (A B B A), each turn a CUDA-event median of
``--reps`` launches after a warm-up, each launch behind a spin of the card
while the host enqueues it (``sweep_shapes.spun_ms``); the opcode walk of
each root on the same traceback likewise, and its segment kernel walking
the whole traceback from the first cursors (the start mode's launch shape,
the cursors' copy inside the time).  Every root's tokens and counts must
equal this checkout's ``nw_walk_runs`` (or ``nw_walk_runs_tiled``), and
every root's segment walk the first root's.  A root whose walk has the
timer (``nw_walk_timer_slots``) is then launched once with it: SM cycles
and counts a pair by phase (``nw_cuda.WALK_PHASES``), beside the site's
gap tokens.  Prints one JSON line a site and root, and the nvidia-smi name
and power limit on each.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .sweep_shapes import build_one, spun_ms

_REPO = Path(__file__).resolve().parents[2]


class Walk:
    """One checkout's walk library, called through ctypes."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        self.timed = hasattr(lib, "nw_walk_timer_slots")
        extra = [ptr] if self.timed else []
        lib.nw_walk_launch.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.nw_walk_segment_launch.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
        lib.nw_walk_runs_launch.argtypes = [ptr] * 5 + [i32] * 6 + extra + [ptr]
        lib.nw_walk_runs_tiled_launch.argtypes = [ptr] * 6 + [i32] * 8 + extra + [ptr]
        for f in (lib.nw_walk_launch, lib.nw_walk_runs_launch, lib.nw_walk_runs_tiled_launch,
                  lib.nw_walk_segment_launch):
            f.restype = i32
        if self.timed:
            lib.nw_walk_timer_slots.restype = i32
        self.lib = lib

    def runs(self, site, phase=None):
        tb, ql, tl = site["tb"], site["ql"], site["tl"]
        B = tb.shape[0]
        tok = torch.zeros((B, site["run_max"]), dtype=torch.int32, device=tb.device)
        cnt = torch.zeros(B, dtype=torch.int32, device=tb.device)
        timer = [None if phase is None else phase.data_ptr()] if self.timed else []
        stream = torch.cuda.current_stream().cuda_stream
        if site.get("tiled") is None:
            err = self.lib.nw_walk_runs_launch(tb.data_ptr(), ql.data_ptr(), tl.data_ptr(), tok.data_ptr(),
                                               cnt.data_ptr(), B, site["band"] + 1, site["tmax"], tb.shape[1],
                                               site["run_max"], site["run_len_max"], *timer, stream)
        else:
            order, n_wide, n_tiles = site["tiled"]
            err = self.lib.nw_walk_runs_tiled_launch(
                tb.data_ptr(), ql.data_ptr(), tl.data_ptr(), order.data_ptr(), tok.data_ptr(), cnt.data_ptr(),
                order.numel(), n_wide, n_tiles, site["band"] + 1, site["tmax"], tb.shape[1], site["run_max"],
                site["run_len_max"], *timer, stream)
        if err:
            raise RuntimeError(f"walk launch failed with CUDA error {err}")
        return tok, cnt

    def ops(self, site):
        tb, ql, tl = site["tb"], site["ql"], site["tl"]
        out = torch.zeros((tb.shape[0], site["tmax"] + 1), dtype=torch.uint8, device=tb.device)
        err = self.lib.nw_walk_launch(tb.data_ptr(), ql.data_ptr(), tl.data_ptr(), out.data_ptr(), tb.shape[0],
                                      site["band"] + 1, site["tmax"], tb.shape[1],
                                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"walk launch failed with CUDA error {err}")
        return out

    def seg(self, site, state):
        """The segment kernel over the whole traceback from the walk's first
        cursors (the start mode's launch shape: rows 1..tmax from row 1,
        pairs tmax_pad rows apart), state [4, B] the cursors, copied first."""
        tb = site["tb"]
        cur = state.clone()
        out = torch.zeros((tb.shape[0], site["tmax"] + 1), dtype=torch.uint8, device=tb.device)
        W = site["band"] + 1
        err = self.lib.nw_walk_segment_launch(tb.data_ptr() + W, cur.data_ptr(), out.data_ptr(), tb.shape[0], W, 1,
                                              site["tmax"], site["tmax"] + 1, tb.shape[1],
                                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"walk launch failed with CUDA error {err}")
        return out, cur

    def split(self, site):
        """The timed launch's split (nw_cuda.walk_split, without the rows'
        cycles); then that of the slowest pair walked alone."""
        from seqrush_tpu_torch.ops import nw_cuda

        slots = self.lib.nw_walk_timer_slots()

        def timed(one):
            phase = torch.zeros(slots + one["tb"].shape[0], dtype=torch.int64, device=one["tb"].device)
            self.runs(one, phase)
            out = nw_cuda.walk_split(phase.cpu().tolist(), slots)
            return out, out.pop("row_cycles")

        out, rows = timed(site)
        if any(rows):  # the library keeps each row's cycles
            r = max(range(len(rows)), key=rows.__getitem__)
            one = dict(site)
            if site.get("tiled") is None:
                one.update(tb=site["tb"][r : r + 1], ql=site["ql"][r : r + 1], tl=site["tl"][r : r + 1])
            else:
                order, n_wide, n_tiles = site["tiled"]
                k = int((order == r).nonzero()[0, 0])
                one["tiled"] = (order[k : k + 1].contiguous(), int(k < n_wide), n_tiles)
            out["slowest"] = {"row": r, **timed(one)[0]}
        return out


def headline_sites(names: set[str], dev) -> dict:
    """The launch sites' tracebacks, from the runner's dispatch records."""
    from seqrush_tpu_torch.align import anchored
    from seqrush_tpu_torch.align.pairs import all_ordered_pairs
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner, _TiledChunk
    from seqrush_tpu_torch.align.sweep import GAP_RUN_MAX, SweepAligner, pack_gap_chunk
    from seqrush_tpu_torch.ops import nw, nw_cuda
    from seqrush_tpu_torch.scores import AlignmentScores
    from seqrush_tpu_torch.sequences import make_sequence_set

    from .headline import SCORES, synth_hla, walk_gap_corpus

    named = synth_hla()
    pairs = all_ordered_pairs(len(named))
    scores = AlignmentScores.parse(SCORES)
    seqs = make_sequence_set(named)
    sites = {}

    # the CLI's defaults, as pipeline.py builds its RunnerConfig
    from seqrush_tpu_torch.cli import build_parser
    from seqrush_tpu_torch.config import Args

    ns = build_parser().parse_args(["-s", "in.fa", "-o", "out.gfa"])
    a = Args(**{k: v for k, v in vars(ns).items() if hasattr(Args, k)})
    cli_cfg = dict(orientation_scores=AlignmentScores.parse_orientation(a.orientation_scores),
                   max_divergence=a.max_divergence, band_slack=a.band_slack, max_chunk_pairs=a.max_chunk_pairs,
                   threads=a.threads, frequency=a.frequency, wide_route=a.wide_route, wide_verify=a.wide_verify)

    def aligned(cls, **cfg):
        al = cls(seqs, RunnerConfig(scores=scores, **cfg), device=dev)
        al.align_pairs(pairs)
        return al

    def oriented(al, p, rc):
        qi, tj = pairs[p]
        return (al.rc_codes[qi] if rc else al.codes[qi]), al.codes[tj]

    def add(name, al, Q, T, ql, tl, band, tmax, run_max, **extra):
        Q, T, ql, tl = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (Q, T, ql, tl))
        pen = al._penalties()
        if "tiled" in extra:
            tile, wide, n_tiles = extra["tiled"]
            _s, tb = nw_cuda.nw_align_tiled(Q, T, ql, tl, tile, wide, band=band, n_tiles=n_tiles, tmax=tmax,
                                            **pen)
            order, n_wide = nw_cuda._tiled_order(tile, wide, n_tiles, band, Q.shape[0], dev)
            extra = {"tiled": (order, n_wide, n_tiles), "tiled_np": extra["tiled"]}
        else:
            _s, tb = nw_cuda.nw_align(Q, T, ql, tl, band=band, tmax=tmax, **pen)
        sites[name] = {"tb": tb, "ql": ql, "tl": tl, "band": band, "tmax": tmax, "run_max": run_max,
                       "run_len_max": nw._RUN_LEN_MAX, **extra}

    if names & {"largest", "window"}:
        al = aligned(WfaAligner, **cli_cfg)
        st = al.stats["dispatches"]
        tb_bytes = lambda d: d["B"] * ((d["tmax"] + 1 + 127) // 128 * 128) * (d["band"] + 1)  # noqa: E731
        if "largest" in names:
            d = max((d for d in st if d["kind"] == "chunk"), key=tb_bytes)
            Q, T, ql, tl, _tmax = al.pack_chunk([(p, bool(rc), d["band"], *oriented(al, p, rc))
                                                 for p, rc in d["jobs"]])
            add("largest", al, Q, T, ql, tl, d["band"], d["tmax"], nw.RUN_MAX)
        if "window" in names:
            d = next(d for d in st if d["kind"] == "window")
            jobs = []
            for p, rc, q0, t0, nq, nt in d["jobs"]:
                q, t = oriented(al, p, rc)
                jobs.append((q[q0 : q0 + nq], t[t0 : t0 + nt], (p, rc, q0, t0)))
            Q, T, ql, tl, band, tmax = anchored.pack_windows(jobs, [(j, d["band"]) for j in range(len(jobs))],
                                                             d["band"])
            add("window", al, Q, T, ql, tl, band, tmax, anchored.WIN_RUN_MAX)
    if "gap" in names:
        al = aligned(SweepAligner, **cli_cfg)
        d = max((d for d in al.stats["dispatches"] if d["kind"] == "gap"),
                key=lambda d: d["B"] * (d["band"] + 1) * d["tmax"])
        jobs = []
        for p, rc, q0, t0, nq, nt in d["jobs"]:
            q, t = oriented(al, p, rc)
            jobs.append((0, 0, q[q0 : q0 + nq], t[t0 : t0 + nt]))
        Q, T, ql, tl, band, tmax = pack_gap_chunk(jobs)
        add("gap", al, Q, T, ql, tl, band, tmax, GAP_RUN_MAX)
    if "tiled" in names:
        al = aligned(WfaAligner, band_tiling="auto", wide_route="full")
        d = next(d for d in al.stats["dispatches"] if d["kind"] == "tiled")
        n_narrow = len(d["jobs"]) - d["n_wide"]
        entries = []
        for k, (p, rc) in enumerate(d["jobs"]):
            qi, tj = pairs[p]
            entries.append((p, bool(rc), d["band"] if k < n_narrow else d["band_wide"], True,
                            al.rc_codes[qi] if rc else al.codes[qi], al.codes[tj]))
        chunk = _TiledChunk(entries, d["band"], d["band_wide"], d["n_tiles"])
        Q, T, ql, tl, tile, wide, _rowmap, tmax = al.pack_tiled_chunk(chunk)
        add("tiled", al, Q, T, ql, tl, d["band"], tmax, nw.RUN_MAX, tiled=(tile, wide, d["n_tiles"]))
    if "corpus" in names:
        al = WfaAligner(seqs, RunnerConfig(scores=scores), device=dev)
        Q, T, ql, tl, band, tmax = walk_gap_corpus()
        add("corpus", al, Q, T, ql, tl, band, tmax, nw.RUN_MAX)
    return sites


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", help="a checkout whose walk is timed (default: this one)")
    ap.add_argument("--sites", default="largest,window,gap,tiled,corpus")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("walk_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_REPO))
    from seqrush_tpu_torch.ops import nw_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    walks = {}
    for spec in args.root or [str(_REPO)]:
        path, ptxas = build_one(Path(spec).resolve(), "nw_walk.cu", _REPO / "build" / "walk_timing", pick="walk")
        walks[spec] = Walk(path)
        print(json.dumps({"root": spec, "timer": walks[spec].timed, "ptxas": ptxas}), flush=True)
    sites = headline_sites(set(args.sites.split(",")), dev)
    order = list(walks)
    turns = order + order[::-1]
    for name, site in sites.items():
        if site.get("tiled") is None:
            want = nw_cuda.nw_walk_runs(site["tb"], site["ql"], site["tl"], band=site["band"], tmax=site["tmax"],
                                        run_max=site["run_max"])
        else:
            tile, wide, n_tiles = site["tiled_np"]
            want = nw_cuda.nw_walk_runs_tiled(site["tb"], site["ql"], site["tl"], tile, wide, band=site["band"],
                                              n_tiles=n_tiles, tmax=site["tmax"], run_max=site["run_max"])
        for r in order:
            got = walks[r].runs(site)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"{r}'s walk differs from this checkout's on {name}")
        times = {r: [] for r in order}
        ops_times = {r: [] for r in order}
        seg_times = {r: [] for r in order}
        if site.get("tiled") is None:
            state = nw_cuda.walk_state(site["ql"], site["tl"], band=site["band"])
            seg_want = walks[order[0]].seg(site, state)
            for r in order:
                got = walks[r].seg(site, state)
                if not all(torch.equal(a, b) for a, b in zip(got, seg_want)):
                    raise AssertionError(f"{r}'s segment walk differs from {order[0]}'s on {name}")
        for r in turns:
            times[r].append(spun_ms(lambda: walks[r].runs(site), args.reps))
            if site.get("tiled") is None:
                ops_times[r].append(spun_ms(lambda: walks[r].ops(site), args.reps))
                seg_times[r].append(spun_ms(lambda: walks[r].seg(site, state), args.reps))
        steps = int(((want[0] >> 2) * (want[0] > 0)).sum().item())
        # the tokens of I and D runs (those stored: a pair past run_max keeps its first run_max)
        gap_tokens = int((((want[0] & 3) >= 2) & (want[0] > 0)).sum().item())
        for r in order:
            row = {"site": name, "root": r, "B": int(site["tb"].shape[0]), "W": site["band"] + 1,
                   "tmax": site["tmax"], "run_max": site["run_max"], "runs_ms": times[r],
                   "runs_ms_median": statistics.median(times[r]), "opcode_walk_ms": ops_times[r] or None,
                   "segment_walk_ms": seg_times[r] or None,
                   "token_steps": steps, "gap_tokens": gap_tokens, "card": smi}
            if walks[r].timed:
                row["split"] = walks[r].split(site)
            print(json.dumps(row), flush=True)
        del site["tb"]
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
