"""Time kernel A's wide route of checkouts in turns on one GPU.

    python -m seqrush_tpu_torch.tools.wide_timing [--root DIR ...] [--reps 3] [--sites a,b,...] [--extras]

The sites (``wide_sites``) are the dispatches the wide route takes:
``translocation`` (``tools/headline.py::translocation_pair``, [1, W 17,408,
tmax 48,128], the band-sharded route's pair without a mesh) with its
traceback and score-only; ``w4097`` (4 pairs of ~3.3 kb and a zero-length
row at the first wide band) with its traceback, int16 and snapshot modes;
``batch8_w5120`` (8 pairs of ~5 kb at band 5,119) with its traceback and
score-only; ``wrap64_w128_int16`` ([64, W 128], int16 penalties whose adds
wrap); ``long8_w128`` ([8, W 128, Lq = Lt = 120,064], 8 pairs of ~60 kb,
sequences beyond the register route's shared memory); and the segment mode
at W 4,608 (4 pairs of ~8 kb): a forward run of 8 segments of 2,048
(``segment_run_w4608``) and the grouped recompute of those 8
(``segment_group_w4608``).  All at scoring 0,5,8,2,24,1 but the wrapping
site.

Each ``--root`` is a checkout (the default: this one; an older commit
unpacked with ``git archive``): its ``seqrush_tpu_torch`` package is
imported under a name of its own (``sweep_shapes.load_root``), so its
planner and its kernels' library (built from its own sources into its own
``build/``) run side by side.  Every root's outputs at a site (scores, the
whole traceback, the snapshot's captures, the checkpoints) must equal the
first root's.  Then in turns (A B B A), each root's launch behind a spin of
the card (``sweep_shapes.spun_ms``, a CUDA-event median of ``--reps``).

Per site and root it prints the times and, for this checkout, what
``site_row`` puts beside them: the plan, the kernel's registers and spilled
bytes (``nw_cuda.wide_query``), the throughput bound of
``chip_smoke.sweep_bounds`` and the chain floor: the site's longest pair's
anti-diagonals at the step latency of the chain floor's probe at the same
plan (``nw_cuda.wide_floor``: the column exchange and barrier alone, no
cell work).  With ``--extras``
(this checkout alone): the tiled mode's wide route (``nw_sweep_tiled_wide``,
n_tiles x W > 3,072) timed once on its merged chunk shape with its bound,
and the mesh step's wavefront (the wavefront kernel's score-only mode at B
256, L 256, band 32, ``chip_smoke.py`` phase 11c's shape).  One JSON line
a site, each with the nvidia-smi name and power limit.  Needs a CUDA
device.
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

from .sweep_shapes import load_root, make_pairs, pack, spun_ms

_REPO = Path(__file__).resolve().parents[2]
PEN = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1)
WRAP16 = dict(mismatch=5, o1=8, e1=2, o2=3000, e2=1)  # 30,000 + 3,001 wraps in int16
SEG, N_RUN = 2048, 8
SITES = ("translocation", "translocation_score_only", "w4097", "w4097_int16", "w4097_snapshot",
         "batch8_w5120", "batch8_w5120_score_only", "wrap64_w128_int16", "long8_w128",
         "segment_run_w4608", "segment_group_w4608")

_CODES = np.full(256, 4, np.uint8)
for _k, _b in enumerate(b"ACGT"):
    _CODES[_b] = _k


def _padded(pairs, dev, L=None):
    """pack()'s tensors, the sequences padded to L (QPAD / TPAD) where given."""
    (Q, T, ql, tl), tmax = pack(pairs, dev)
    if L is not None:
        Qp = torch.full((Q.shape[0], L), 6, dtype=torch.uint8, device=dev)
        Tp = torch.full((T.shape[0], L), 7, dtype=torch.uint8, device=dev)
        Qp[:, : Q.shape[1]], Tp[:, : T.shape[1]] = Q, T
        Q, T = Qp, Tp
    return (Q, T, ql, tl), tmax


def wide_sites(dev, names=SITES) -> dict:
    """{name: site}: a site is its kind ("align", "run" or "group"), its
    inputs (Q, T, qlens, tlens on dev) and its keyword arguments."""
    from .headline import translocation_pair

    empty = (np.zeros(0, np.uint8), np.zeros(0, np.uint8))
    out = {}
    want = set(names)
    if want & {"translocation", "translocation_score_only"}:
        (_a, q), (_b, t) = translocation_pair()
        qc, tc = _CODES[np.frombuffer(q, np.uint8)], _CODES[np.frombuffer(t, np.uint8)]
        inputs = (torch.from_numpy(qc[None].copy()).to(dev), torch.from_numpy(tc[None].copy()).to(dev),
                  torch.tensor([qc.size], dtype=torch.int32, device=dev),
                  torch.tensor([tc.size], dtype=torch.int32, device=dev))
        kw = dict(band=17_407, tmax=48_128, **PEN)
        out["translocation"] = dict(kind="align", inputs=inputs, kw=kw)
        out["translocation_score_only"] = dict(kind="align", inputs=inputs, kw=dict(kw, with_traceback=False))
    if want & {"w4097", "w4097_int16", "w4097_snapshot"}:
        inputs, tmax = pack(make_pairs(4, 3300, 41) + [empty], dev)
        kw = dict(band=4096, tmax=tmax, **PEN)
        fin = inputs[2] + inputs[3]
        out["w4097"] = dict(kind="align", inputs=inputs, kw=kw)
        out["w4097_int16"] = dict(kind="align", inputs=inputs, kw=dict(kw, int16=True))
        out["w4097_snapshot"] = dict(kind="align", inputs=inputs,
                                     kw=dict(kw, t_snap=torch.div(fin + 1, 2, rounding_mode="floor").to(torch.int32)))
    if want & {"batch8_w5120", "batch8_w5120_score_only"}:
        inputs, tmax = pack(make_pairs(8, 5000, 43), dev)
        kw = dict(band=5119, tmax=tmax, **PEN)
        out["batch8_w5120"] = dict(kind="align", inputs=inputs, kw=kw)
        out["batch8_w5120_score_only"] = dict(kind="align", inputs=inputs, kw=dict(kw, with_traceback=False))
    if "wrap64_w128_int16" in want:
        inputs, tmax = pack(make_pairs(64, 1200, 47), dev)
        out["wrap64_w128_int16"] = dict(kind="align", inputs=inputs, kw=dict(band=127, tmax=tmax, int16=True,
                                                                               **WRAP16))
    if "long8_w128" in want:
        inputs, tmax = _padded(make_pairs(8, 60_000, 53), dev, 120_064)
        out["long8_w128"] = dict(kind="align", inputs=inputs, kw=dict(band=127, tmax=tmax, **PEN))
    if want & {"segment_run_w4608", "segment_group_w4608"}:
        inputs, _tmax = pack(make_pairs(4, 8000, 59), dev)
        B, W = inputs[0].shape[0], 4608
        kw = dict(seg=SEG, band=W - 1, **PEN)
        out["segment_run_w4608"] = dict(kind="run", inputs=inputs, kw=kw, B=B, W=W)
        out["segment_group_w4608"] = dict(kind="group", inputs=inputs, kw=kw, B=B, W=W)
    return out


def _ckpt(site, dev):
    """The checkpoints of a segment site: the initial carry, the others
    filled by a forward run."""
    from seqrush_tpu_torch.ops import nw_cuda

    ckpt = torch.empty((N_RUN + 1, 6, site["B"], site["W"]), dtype=torch.int32, device=dev)
    ckpt[0] = nw_cuda.initial_carry(site["B"], site["W"], dev)
    return ckpt


def launcher(mod, site, ckpt=None):
    """A no-argument call of root `mod`'s wrapper at the site, returning its
    outputs (a tuple of tensors)."""
    args, kw = site["inputs"], site["kw"]
    if site["kind"] == "align":
        def call():
            out = mod.nw_align(*args, **kw)
            return tuple(x for x in out[:2] if x is not None) + (tuple(out[2]) if len(out) > 2 else ())
    elif site["kind"] == "run":
        scores0 = torch.full((site["B"],), -1, dtype=torch.int32, device=args[0].device)

        def call():
            return mod.nw_align_segment_run(*args, ckpt, scores0, s0=0, n_run=N_RUN, **kw), ckpt[1:]
    else:
        def call():
            return mod.nw_align_segment_group(*args, ckpt, s0=0, G=N_RUN, **kw)
    return call


def site_plan(nw_cuda, site):
    """This checkout's plan at a site (align_plan, or the segment plan)."""
    Q, T = site["inputs"][:2]
    B = Q.shape[0]
    if site["kind"] == "align":
        kw = site["kw"]
        pen = {k: kw[k] for k in ("mismatch", "o1", "e1", "o2", "e2")}
        return nw_cuda.align_plan(B, kw["band"] + 1, Q.shape[1], T.shape[1], int16=kw.get("int16", False),
                                  snapshot=kw.get("t_snap") is not None, **pen)
    groups = N_RUN if site["kind"] == "group" else 1
    pen = {k: site["kw"][k] for k in ("mismatch", "o1", "e1", "o2", "e2")}
    return nw_cuda._segment_plan(B, site["W"], Q.shape[1], T.shape[1], SEG, groups, pen)


def site_steps(site) -> tuple[int, int]:
    """(the anti-diagonals the site's longest pair sweeps, that pair's row):
    to min(tmax, t_final + 2) with a traceback, to t_final without; a
    segment site's run or group."""
    ql, tl = site["inputs"][2], site["inputs"][3]
    fin = (ql + tl).to(torch.int64)
    b = int(torch.argmax(fin))
    if site["kind"] != "align":
        return min(int(fin[b]) + 2, N_RUN * SEG), b
    kw = site["kw"]
    tb = kw.get("with_traceback", True)
    return min(kw["tmax"], int(fin[b]) + (2 if tb else 0)), b


def site_row(nw_cuda, chip_smoke, site, ms: float, reps: int) -> dict:
    """What stands beside a site's time `ms` on this checkout (needs the
    card): its plan, the kernel's registers and spilled bytes (wide_query),
    its throughput bound (the bytes it must move over the HBM rate or its
    instructions over the issue rate, chip_smoke.py's reckoning) and its
    chain floor: the site's longest pair's anti-diagonals (site_steps) times
    the step latency of the chain floor's probe at the same plan
    (nw_cuda.wide_floor: the column exchange and barrier alone, timed
    behind a spin), beside the step the kernel itself takes (ms over those
    anti-diagonals)."""
    Q, T, ql, tl = site["inputs"]
    kw = site["kw"]
    W = kw["band"] + 1
    plan = site_plan(nw_cuda, site)
    if site["kind"] == "align":
        tb_numel = Q.shape[0] * nw_cuda.nw.tmax_pad_of(kw["tmax"]) * W if kw.get("with_traceback", True) else 0
        b_ms, o_ms = chip_smoke.sweep_bounds(Q, T, ql, tl, W, tb_numel)
    else:
        rows = Q.shape[0] * N_RUN * SEG * W if site["kind"] == "group" else 0
        cells = int(torch.clamp(ql + tl, max=N_RUN * SEG).to(torch.int64).sum()) * W
        b_ms = (Q.numel() + T.numel() + rows + 2 * 6 * Q.shape[0] * W * 4) / chip_smoke.HBM_BYTES_PER_S * 1e3
        per = (chip_smoke.SWEEP_OPS_PER_CELL, chip_smoke.SWEEP_MIN_OPS_PER_CELL) if rows else (
            chip_smoke.SCORE_ONLY_OPS_PER_CELL, chip_smoke.SCORE_ONLY_MIN_OPS_PER_CELL)
        o_ms = cells * max(per[0] / chip_smoke.ISSUE_OPS_PER_S, per[1] / chip_smoke.ALU_OPS_PER_S) * 1e3
    row = {"bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations"}
    if site["kind"] == "align":
        row["tmax"] = kw["tmax"]
    if plan.route != "wide":
        row["plan"] = repr(plan)
        return row
    tb_mode = site["kind"] == "group" or (site["kind"] == "align" and kw.get("with_traceback", True))
    row["plan"] = {k: getattr(plan, k) for k in ("lanes", "ctas", "cluster", "clusters", "threads",
                                                 "smem_bytes", "groups")}
    ar = nw_cuda.wide_arith(*(kw[k] for k in ("mismatch", "o1", "e1", "o2", "e2")), kw.get("int16", False))
    row["kernel"] = nw_cuda.wide_query(Q.device, plan, kw["o2"] >= 0, tb_mode, ar, site["kind"] != "align")
    steps, _b = site_steps(site)
    floor_ms = spun_ms(lambda: nw_cuda.wide_floor(plan, W, steps, Q.device), reps)
    row["chain"] = {"anti_diagonals": steps, "floor_ms": floor_ms, "floor_step_us": floor_ms * 1e3 / steps,
                    "step_us": ms * 1e3 / steps}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", help="a checkout whose wide route is timed (default: this one)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sites", default=",".join(SITES))
    ap.add_argument("--extras", action="store_true")
    ap.add_argument("--strips", action="store_true",
                    help="also time this checkout's wide route at each lanes a thread (wide_plan(lanes=...))")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wide_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_REPO))
    import chip_smoke
    from seqrush_tpu_torch.ops import nw_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    roots = {}
    for k, spec in enumerate(args.root or [str(_REPO)]):
        mod = load_root(Path(spec).resolve(), f"_wide_root{k}")
        mod.build()
        roots[spec] = mod
    order = list(roots)
    names = [n for n in args.sites.split(",") if n]
    sites = wide_sites(dev, names)
    for name in names:
        site = sites[name]
        ckpt = _ckpt(site, dev) if site["kind"] != "align" else None
        if site["kind"] == "group":  # the checkpoints the recompute starts from
            launcher(nw_cuda, dict(site, kind="run"), ckpt)()
        first = None
        for r in order:
            out = [x.clone() for x in launcher(roots[r], site, ckpt)()]
            if first is None:
                first = out
            elif not all(torch.equal(a, b) for a, b in zip(out, first)):
                raise AssertionError(f"{r} differs from {order[0]} at {name}")
        del first
        times = {r: [] for r in order}
        for r in order + order[::-1]:
            times[r].append(spun_ms(launcher(roots[r], site, ckpt), args.reps))
        Q = site["inputs"][0]
        row = {"site": name, "B": Q.shape[0], "W": site["kw"]["band"] + 1, "Lq": Q.shape[1], "card": smi,
               "ms": {r: times[r] for r in order},
               "ms_median": {r: statistics.median(times[r]) for r in order}}
        row.update(site_row(nw_cuda, chip_smoke, site, row["ms_median"][order[-1]], args.reps))
        if args.strips and site["kind"] == "align":
            row["strips_ms"] = strips_ms(nw_cuda, site, site_plan(nw_cuda, site), args.reps)
        print(json.dumps(row), flush=True)
        del ckpt, site
        sites[name] = None
        torch.cuda.empty_cache()
    if args.extras:
        extras(nw_cuda, chip_smoke, dev, smi, args.reps)
    return 0


def strips_ms(nw_cuda, site, plan, reps) -> dict:
    """The site at each lanes a thread the wide route is built for, the
    planner's pick at those lanes (each held to nw_align's outputs first)."""
    Q, T, ql, tl = site["inputs"]
    kw = site["kw"]
    want = [x for x in nw_cuda.nw_align(Q, T, ql, tl, **kw) if torch.is_tensor(x)]
    out = {}
    for s in nw_cuda.WIDE_LANES:
        p = nw_cuda.wide_plan(Q.shape[0], kw["band"] + 1, lanes=s)
        got = [x for x in nw_cuda.sweep_launch(Q, T, ql, tl, p, **kw) if torch.is_tensor(x)]
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{s} lanes a thread disagree with nw_align's pick")
        out[f"{s} lanes, {p.ctas} CTAs of {p.threads}"] = spun_ms(lambda: nw_cuda.sweep_launch(Q, T, ql, tl, p, **kw),
                                                                    reps)
    return out


def extras(nw_cuda, chip_smoke, dev, smi, reps):
    """The tiled mode's wide route and the mesh step's wavefront, timed once
    on this checkout."""
    from seqrush_tpu_torch.ops import wfa

    # the tiled mode's wide route: 8 narrow pairs at band 1,023 and 2 wide
    # pairs of 5 tiles (n_tiles x W = 5,120 > REG_MAX_W lanes)
    n_tiles, band = 5, 1023
    (Q, T, ql, tl), tmax = pack(make_pairs(8 + 2 * n_tiles, 3000, 61), dev)
    tile = np.array([0] * 8 + list(range(n_tiles)) * 2, np.int32)
    wide = np.array([False] * 8 + [True] * (2 * n_tiles))
    kw = dict(band=band, n_tiles=n_tiles, tmax=tmax, **PEN)
    plan = nw_cuda.plan_sweep_tiled(8, 2, band + 1, n_tiles, Q.shape[1], T.shape[1])
    ms = spun_ms(lambda: nw_cuda.nw_align_tiled(Q, T, ql, tl, tile, wide, **kw), reps)
    lanes = torch.from_numpy(np.where(tile == 0, np.where(wide, n_tiles * (band + 1), band + 1), 0)).to(dev)
    b_ms, o_ms = chip_smoke.sweep_bounds(Q, T, ql, tl, lanes, Q.shape[0] * nw_cuda.nw.tmax_pad_of(tmax) * (band + 1))
    print(json.dumps({"site": "tiled_wide", "rows": Q.shape[0], "W": band + 1, "n_tiles": n_tiles, "n_wide": 2,
                      "tmax": tmax, "route": plan.route, "ms": ms, "bound_ms": max(b_ms, o_ms),
                      "bound_by": "bytes" if b_ms >= o_ms else "operations", "card": smi}), flush=True)
    # the mesh step's wavefront (chip_smoke.py phase 11c's workload at D = 1)
    rng = np.random.default_rng(0)
    B, L = 256, 256
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    qs, ts = [], []
    for k in range(B):
        tt = base.copy()
        tt[(13 * k + 7) % L] = (tt[(13 * k + 7) % L] + 1) % 4
        qs.append(base.copy())
        ts.append(tt)
    Qw, Tw, qlw, tlw = wfa.pack_batch(qs, ts)
    caps = np.full(B, 256, dtype=np.int32)
    w_args = [torch.from_numpy(a).to(dev) for a in (Qw, Tw, qlw, tlw, caps)]
    w_kw = dict(smax=256, band=32, keep_history=False, **PEN)
    w_ms = spun_ms(lambda: wfa.wfa_align_device(*w_args, **w_kw), reps)
    print(json.dumps({"site": "mesh_step_wavefront", "B": B, "L": L, "ms": w_ms, "card": smi}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
