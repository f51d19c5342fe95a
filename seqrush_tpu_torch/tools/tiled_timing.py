"""Time kernel A's tiled mode (band tiling's merged sweep) of checkouts in turns on one GPU, with its own split.

    python -m seqrush_tpu_torch.tools.tiled_timing [--root DIR ...] [--reps 5] [--plans] [--narrow]

The chunk is ``band_tiling='auto'``'s merged chunk on the headline corpus
(``tools/headline.py::synth_hla``, 600 ordered pairs, scoring
0,5,8,2,24,1) with ``wide_route='full'``: the pairs through ``WfaAligner``
on the card, its first tiled dispatch packed as the runner packs it
([704 rows, W 512, 3 tiles, 48 wide pairs, tmax 7,168] on that corpus),
once from the int32 run and once from the ``dp_dtype='int16'`` run (the
same chunk in the int16 mode).

Each ``--root`` is a checkout (the default: this one; an older commit
unpacked with ``git archive``): its ``seqrush_tpu_torch`` package is
imported under a name of its own (``sweep_shapes.load_root``), so its
planner and its kernels' library (built from its own sources into its own
``build/``) run side by side with the others' in one process.  Every
root's scores must equal this checkout's plain version
(``nw_cuda.nw_align_tiled_reference``) on the card, and its traceback the
plain version's on every row the tiled walk can read (each pair's rows
0 .. min(tmax, t_final + 2), ``nw_cuda.tiled_promised_rows``).  Then in turns,
forward then backward (A B B A), each root's ``nw_align_tiled`` on both
chunks, each turn a CUDA-event median of ``--reps`` launches after a
warm-up, behind a spin of the card (``sweep_shapes.spun_ms``).

Per root it prints the plan, the ptxas registers and spills of the tiled
kernels (from the root's build log, where this run built it), and, where
the root has the register route's timer (``nw_cuda.sweep_tiled_split``),
its split of one timed launch (and the timed and the untimed launch alone,
behind a spin, on the int32 chunk): the wide blocks' time against the narrow
blocks', each SM's live warps and blocks, the busiest SM's warps, time and
cycles against the mean, the nanoseconds a cycle, and the recurrence's
cycles an anti-diagonal a warp by the warps on its SM.  Beside it, the
anti-diagonals the chunk's rows need (to t_final + 2) against tmax, those
of the zero-length padding rows, and those of the rows past each pair's
t_final + 2.  With ``--plans`` every register-route strip that fits the
chunk (each lanes-per-thread count within its launch bound) of the last
root is timed on the int32 chunk too, each held to ``nw_align_tiled``'s
outputs first, with its occupancy where the root reports it.  With
``--narrow`` the chunk's narrow rows alone are also
timed, in turns, through kernel A (``nw_align``, its own plan, and 8 lanes
at 2 warps a pair) and through the last root's tiled mode with no wide
pair, to set the tiled mode's cost a cell beside kernel A's.
Prints one JSON line a root, each with the nvidia-smi name and power limit.
Needs a CUDA device.
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

from .sweep_shapes import load_root, masked_rows_err, ptxas_lines, spun_ms

_REPO = Path(__file__).resolve().parents[2]


def tiled_chunk(dev, int16: bool):
    """band_tiling's first merged chunk of the headline run (int16: the
    dp_dtype='int16' run's): (Q, T, ql, tl) on the card, tile, wide (host
    arrays), band, n_tiles, tmax and the penalties."""
    from seqrush_tpu_torch.align.pairs import all_ordered_pairs
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner, _TiledChunk
    from seqrush_tpu_torch.scores import AlignmentScores
    from seqrush_tpu_torch.sequences import make_sequence_set

    from .headline import SCORES, synth_hla

    named = synth_hla()
    pairs = all_ordered_pairs(len(named))
    cfg = dict(band_tiling="auto", wide_route="full", **({"dp_dtype": "int16"} if int16 else {}))
    al = WfaAligner(make_sequence_set(named), RunnerConfig(scores=AlignmentScores.parse(SCORES), **cfg),
                    device=dev)
    al.align_pairs(pairs)
    d = next(d for d in al.stats["dispatches"] if d["kind"] == "tiled")
    n_narrow = len(d["jobs"]) - d["n_wide"]
    entries = []
    for k, (p, rc) in enumerate(d["jobs"]):
        qi, tj = pairs[p]
        entries.append((p, bool(rc), d["band"] if k < n_narrow else d["band_wide"], not d["int16"],
                        al.rc_codes[qi] if rc else al.codes[qi], al.codes[tj]))
    Q, T, ql, tl, tile, wide, _rowmap, tmax = al.pack_tiled_chunk(_TiledChunk(entries, d["band"], d["band_wide"],
                                                                             d["n_tiles"]))
    Q, T, ql, tl = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (Q, T, ql, tl))
    return Q, T, ql, tl, tile, wide, d["band"], d["n_tiles"], tmax, bool(d["int16"]), al._penalties()


def anti_diagonals(ql, tl, tile, wide, n_tiles: int, tmax: int) -> dict:
    """The chunk's anti-diagonals a row: all rows swept to tmax, the rows
    each pair needs (1 .. min(tmax, t_final + 2), a wide pair's on each of
    its tile rows), the padding rows' (zero-length narrow rows) and those
    past each pair's t_final + 2."""
    fin = (ql + tl).to(torch.int64).cpu().numpy()
    first = np.where(tile == 0)[0]
    lengths = np.zeros(tile.size, np.int64)
    for b in first:
        lengths[b : b + (n_tiles if wide[b] else 1)] = fin[b]
    need = np.minimum(lengths + 2, tmax)
    pad = (~wide) & (lengths == 0)
    return {"rows": int(tile.size), "to_tmax": int(tile.size) * tmax, "needed": int(need.sum()),
            "padding_rows": int(pad.sum()), "padding_to_tmax": int(pad.sum()) * tmax,
            "past_t_final_plus_2": int((tmax - need).sum()),
            "past_share": round(float((tmax - need).sum() / (tile.size * tmax)), 4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", help="a checkout whose tiled sweep is timed (default: this one)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--narrow", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tiled_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_REPO))
    from seqrush_tpu_torch.ops import nw_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    roots = {}
    for k, spec in enumerate(args.root or [str(_REPO)]):
        mod = load_root(Path(spec).resolve(), f"_tiled_root{k}")
        _path, log = mod.build()
        roots[spec] = (mod, ptxas_lines(log, "tiled"))
    chunks = {}
    for name, int16 in (("int32", False), ("int16", True)):
        Q, T, ql, tl, tile, wide, band, R, tmax, i16, pen = tiled_chunk(dev, int16)
        kw = dict(band=band, n_tiles=R, tmax=tmax, int16=i16, **pen)
        s_p, tb_p = nw_cuda.nw_align_tiled_reference(Q, T, ql, tl, tile, wide, **kw)
        keep = nw_cuda.tiled_promised_rows(ql, tl, tile, wide, R, tmax, tb_p.shape[1])
        for spec, (mod, _regs) in roots.items():
            s_k, tb_k = mod.nw_align_tiled(Q, T, ql, tl, tile, wide, **kw)
            if not torch.equal(s_k, s_p) or masked_rows_err(tb_k, tb_p, keep):
                raise AssertionError(f"{spec}'s tiled sweep differs from the plain version ({name} chunk)")
            del s_k, tb_k
        del tb_p
        torch.cuda.empty_cache()
        chunks[name] = (Q, T, ql, tl, tile, wide, kw)
    order = list(roots)
    times = {r: {c: [] for c in chunks} for r in order}
    for r in order + order[::-1]:
        mod = roots[r][0]
        for c, (Q, T, ql, tl, tile, wide, kw) in chunks.items():
            times[r][c].append(spun_ms(lambda: mod.nw_align_tiled(Q, T, ql, tl, tile, wide, **kw), args.reps))
    Q, T, ql, tl, tile, wide, kw = chunks["int32"]
    W, R = kw["band"] + 1, kw["n_tiles"]
    counts = anti_diagonals(ql, tl, tile, wide, R, kw["tmax"])
    for r in order:
        mod, regs = roots[r]
        order_t, n_wide = mod._tiled_order(tile, wide, R, kw["band"], Q.shape[0], dev)
        plan = mod.plan_sweep_tiled(order_t.numel() - n_wide, n_wide, W, R, Q.shape[1], T.shape[1])
        row = {"root": r, "B": Q.shape[0], "W": W, "n_tiles": R, "n_wide": n_wide, "tmax": kw["tmax"],
               "plan": repr(plan), "tiled_registers": regs,
               **{f"{c}_ms": v for c, v in times[r].items()},
               **{f"{c}_ms_median": statistics.median(v) for c, v in times[r].items()},
               "anti_diagonals": counts, "card": smi}
        if hasattr(mod, "tiled_occupancy"):
            row["occupancy"] = mod.tiled_occupancy(plan, kw["o2"] >= 0, W)
        if hasattr(mod, "sweep_tiled_split") and plan.route == "regs":
            for c, (Qc, Tc, qlc, tlc, tilec, widec, kwc) in chunks.items():
                _s, _tb, split = mod.sweep_tiled_split(Qc, Tc, qlc, tlc, order_t, n_wide, plan, **kwc)
                row[f"{c}_split"] = split
                del _s, _tb
            # the timed instantiation's launch alone, beside the untimed one's
            timer = torch.zeros(plan.blocks * (plan.threads // 32) * mod.TILED_TIMER_SLOTS, dtype=torch.int64,
                                device=dev)
            row["timed_launch_ms"] = spun_ms(
                lambda: mod.sweep_tiled_launch(Q, T, ql, tl, order_t, n_wide, plan, timer=timer, **kw), args.reps)
            row["untimed_launch_ms"] = spun_ms(
                lambda: mod.sweep_tiled_launch(Q, T, ql, tl, order_t, n_wide, plan, **kw), args.reps)
        print(json.dumps(row), flush=True)
    if args.plans:
        mod = roots[order[-1]][0]
        order_t, n_wide = mod._tiled_order(tile, wide, R, kw["band"], Q.shape[0], dev)
        s_k, tb_k = mod.nw_align_tiled(Q, T, ql, tl, tile, wide, **kw)
        keep = nw_cuda.tiled_promised_rows(ql, tl, tile, wide, R, kw["tmax"], tb_k.shape[1])
        out = {}
        for s in mod.SWEEP_LANES:
            wpp = -(-W // (32 * s))
            threads = 32 * wpp * R
            pair_bytes = mod.pair_smem_bytes(Q.shape[1], T.shape[1], W, s, wpp)
            smem = max(R * pair_bytes, mod.pair_smem_bytes(Q.shape[1], T.shape[1], R * W, s, wpp * R))
            if threads > mod._MAX_THREADS[s]:
                continue
            plan = mod.TiledPlan("regs", s, wpp, threads, pair_bytes, smem, n_wide + -(-(order_t.numel() - n_wide) // R))
            s_w, tb_w = mod.sweep_tiled_launch(Q, T, ql, tl, order_t, n_wide, plan, **kw)
            if not torch.equal(s_w, s_k) or masked_rows_err(tb_w, tb_k, keep):
                raise AssertionError(f"{s} lanes disagree with nw_align_tiled")
            del s_w, tb_w
            entry = {"plan": repr(plan),
                     "ms": spun_ms(lambda: mod.sweep_tiled_launch(Q, T, ql, tl, order_t, n_wide, plan, **kw),
                                   args.reps)}
            if hasattr(mod, "tiled_occupancy"):
                entry["occupancy"] = mod.tiled_occupancy(plan, kw["o2"] >= 0, W)
            out[f"{s} lanes x {wpp} warps a tile"] = entry
        del s_k, tb_k
        print(json.dumps({"root": order[-1], "strips": out, "card": smi}), flush=True)
    if args.narrow:
        mod = roots[order[-1]][0]
        narrow = np.flatnonzero(~wide)
        idx = torch.from_numpy(narrow).to(dev)
        Qn, Tn, qn, tn = (x[idx].contiguous() for x in (Q, T, ql, tl))
        kn = dict(kw, n_tiles=R)
        zeros = np.zeros(narrow.size, np.int32)
        flat = np.zeros(narrow.size, bool)
        order_n, _ = mod._tiled_order(zeros, flat, R, kw["band"], narrow.size, dev)
        plan_t = mod.plan_sweep_tiled(narrow.size, 0, W, R, Qn.shape[1], Tn.shape[1])
        pen = {k: kw[k] for k in ("mismatch", "o1", "e1", "o2", "e2")}
        a_kw = dict(band=kw["band"], tmax=kw["tmax"], **pen)
        plan_a = mod.plan_sweep(narrow.size, W, Qn.shape[1], Tn.shape[1])
        plan_a8 = mod.plan_sweep(narrow.size, W, Qn.shape[1], Tn.shape[1], warps_per_pair=2)
        runs = {f"kernel A, its plan ({plan_a.lanes} lanes x {plan_a.warps_per_pair} warps)":
                lambda: mod.sweep_launch(Qn, Tn, qn, tn, plan_a, **a_kw),
                f"kernel A, {plan_a8.lanes} lanes x {plan_a8.warps_per_pair} warps, {plan_a8.pairs_per_block} "
                f"pairs a block": lambda: mod.sweep_launch(Qn, Tn, qn, tn, plan_a8, **a_kw),
                f"tiled mode, no wide pair ({plan_t.lanes} lanes x {plan_t.threads} threads)":
                lambda: mod.sweep_tiled_launch(Qn, Tn, qn, tn, order_n, 0, plan_t, **kn)}
        got = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            got[k].append(spun_ms(runs[k], args.reps))
        print(json.dumps({"root": order[-1], "narrow_rows": int(narrow.size), "W": W, "tmax": kw["tmax"],
                          "ms_in_turns": got, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
