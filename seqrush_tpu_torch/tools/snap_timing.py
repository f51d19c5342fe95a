"""Time kernel A's snapshot mode (the fold's half sweeps) of checkouts in turns on one GPU.

    python -m seqrush_tpu_torch.tools.snap_timing [--root DIR ...] [--reps 5] [--plans]

The chunk is the fold's largest on the headline corpus
(``tools/headline.py::synth_hla``, 600 ordered pairs, scoring
0,5,8,2,24,1): the pairs through ``WfaAligner`` with ``RunnerConfig(fold=
True)`` on the card, its largest fold chunk packed as the runner packs it,
the forward rows and the reversed rows of every pair in one batch, each row's
``t_snap`` the fold's (``ceil(fin / 2)`` forward, ``fin - ceil(fin / 2)``
backward): [1,152 rows, W 768, tmax_half 3,840] on that corpus.

Each ``--root`` is a checkout (the default: this one; an older commit
unpacked with ``git archive``): its ``seqrush_tpu_torch`` package is
imported under a name of its own (``sweep_shapes.load_root``), so its
planner and its kernels' library (built from its own sources into its own
``build/``) run side by side with the others' in one process.  Every
root's scores, SNAP, DIAGA, DIAGB and traceback rows 0 .. t_snap + 1 of
each row (``sweep_shapes.snapshot_rows_err``) must equal this checkout's
plain version (``nw_cuda.nw_align_reference``) on the card.  Then in turns,
forward then backward (A B B A), each root's snapshot sweep (``nw_align``
with ``t_snap``) and the same rows swept without captures
(``t_snap=None``), each turn a CUDA-event median of ``--reps`` launches
after a warm-up, behind a spin of the card (``sweep_shapes.spun_ms``).

Per root it prints the plan, the ptxas registers and spills of the
snapshot kernels (from the root's build log, where this run built it), the
anti-diagonals the sweep runs against those the fold reads (each row's up
to ``t_snap + 1``), and, where the root's ``sweep_occupancy`` reads the
snapshot kernel's own, the resident pairs an SM and the waves and rounds
the plan makes on this card's SMs.  With ``--plans`` every strip that
covers W (``sweep_shapes.strips``) of the last root is timed in its
snapshot mode too, each held to the planner's outputs first, with the same
occupancy figures.
Prints one JSON line a root, each with the nvidia-smi name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .sweep_shapes import load_root, ptxas_lines, snapshot_rows_err, spun_ms, strips

_REPO = Path(__file__).resolve().parents[2]


def fold_chunk(dev):
    """The largest fold chunk of the headline run: (Q2, T2, ql2, tl2,
    t_snap, band, tmax_half, penalties) on the card."""
    from seqrush_tpu_torch.align.pairs import all_ordered_pairs
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
    from seqrush_tpu_torch.scores import AlignmentScores
    from seqrush_tpu_torch.sequences import make_sequence_set

    from .headline import SCORES, synth_hla

    named = synth_hla()
    pairs = all_ordered_pairs(len(named))
    al = WfaAligner(make_sequence_set(named), RunnerConfig(scores=AlignmentScores.parse(SCORES), fold=True),
                    device=dev)
    al.align_pairs(pairs)
    d = max((d for d in al.stats["dispatches"] if d["kind"] == "chunk" and d["fold"]),
            key=lambda d: d["B"] * d["tmax"] * d["band"])
    chunk = []
    for p, rc in d["jobs"]:
        qi, tj = pairs[p]
        chunk.append((p, bool(rc), d["band"], False, al.rc_codes[qi] if rc else al.codes[qi], al.codes[tj]))
    Q, T, ql, tl, _tmax = al.pack_chunk(chunk)
    Qr, Tr = al.pack_fold_rows(chunk, Q, T)
    Q, T, Qr, Tr, ql, tl = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (Q, T, Qr, Tr, ql, tl))
    fin = ql + tl
    tm = torch.div(fin + 1, 2, rounding_mode="floor")
    t_snap = torch.cat([tm, fin - tm]).to(torch.int32)
    return (torch.cat([Q, Qr]), torch.cat([T, Tr]), torch.cat([ql, ql]), torch.cat([tl, tl]), t_snap,
            d["band_eff"], d["tmax_half"], al._penalties())


def snap_occupancy(nw_cuda) -> bool:
    """Whether a root's sweep_occupancy reads the snapshot kernel's own."""
    return "snapshot" in inspect.signature(nw_cuda.sweep_occupancy).parameters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", help="a checkout whose snapshot sweep is timed (default: this one)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("snap_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_REPO))
    from seqrush_tpu_torch.ops import nw_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    roots = {}
    for k, spec in enumerate(args.root or [str(_REPO)]):
        mod = load_root(Path(spec).resolve(), f"_snap_root{k}")
        _path, log = mod.build()
        roots[spec] = (mod, ptxas_lines(log, "snap"))
    Q, T, ql, tl, t_snap, band, tmax, pen = fold_chunk(dev)
    B, W = Q.shape[0], band + 1
    kw = dict(band=band, tmax=tmax, t_snap=t_snap, **pen)
    two = pen["o2"] >= 0
    s_p, tb_p, snaps_p = nw_cuda.nw_align_reference(Q, T, ql, tl, **kw)
    for spec, (mod, _regs) in roots.items():
        s_k, tb_k, snaps_k = mod.nw_align(Q, T, ql, tl, **kw)
        if not (torch.equal(s_k, s_p) and all(torch.equal(a, b) for a, b in zip(snaps_k, snaps_p))
                and snapshot_rows_err(tb_k, tb_p, t_snap, tmax) == 0):
            raise AssertionError(f"{spec}'s snapshot sweep differs from the plain version")
        del s_k, tb_k, snaps_k
    del tb_p
    torch.cuda.empty_cache()
    order = list(roots)
    times = {r: [] for r in order}
    plain_times = {r: [] for r in order}
    for r in order + order[::-1]:
        mod = roots[r][0]
        times[r].append(spun_ms(lambda: mod.nw_align(Q, T, ql, tl, **kw), args.reps))
        plain_times[r].append(spun_ms(lambda: mod.nw_align(Q, T, ql, tl, **dict(kw, t_snap=None)), args.reps))
    fin = (ql + tl).to(torch.int64)
    needed = int(torch.clamp(t_snap.to(torch.int64) + 1, max=tmax).sum())
    recurrence_full = int(torch.clamp(fin + 2, max=tmax).sum())
    for r in order:
        mod, regs = roots[r]
        plan = mod.plan_sweep(B, W, Q.shape[1], T.shape[1])
        row = {"root": r, "B": B, "W": W, "tmax_half": tmax, "plan": repr(plan), "snap_registers": regs,
               "snapshot_ms": times[r], "snapshot_ms_median": statistics.median(times[r]),
               "no_snapshot_ms": plain_times[r], "no_snapshot_ms_median": statistics.median(plain_times[r]),
               "anti_diagonals_needed": needed, "anti_diagonals_to_tmax": B * tmax,
               "recurrence_to_t_final_plus_2": recurrence_full, "sms": sms, "card": smi}
        if snap_occupancy(mod):
            occ = mod.sweep_occupancy(plan, W, two, snapshot=True)
            row["occupancy"] = occ
            row["waves"] = B / (sms * occ["resident_pairs_per_sm"])
            row["rounds"] = mod.snap_rounds(B, occ["resident_pairs_per_sm"], sms)
        print(json.dumps(row), flush=True)
    if args.plans:
        mod = roots[order[-1]][0]
        s_k, tb_k, snaps_k = mod.nw_align(Q, T, ql, tl, **kw)
        out = {}
        for label, plan in strips(mod, B, W, Q.shape[1], T.shape[1]):
            s_w, tb_w, snaps_w = mod.sweep_launch(Q, T, ql, tl, plan, **kw)
            if not (torch.equal(s_w, s_k) and all(torch.equal(a, b) for a, b in zip(snaps_w, snaps_k))
                    and snapshot_rows_err(tb_w, tb_k, t_snap, tmax) == 0):
                raise AssertionError(f"{label} disagrees with nw_align's snapshot sweep")
            del s_w, tb_w, snaps_w
            entry = {"plan": repr(plan), "ms": spun_ms(lambda: mod.sweep_launch(Q, T, ql, tl, plan, **kw), args.reps)}
            if snap_occupancy(mod):
                entry["occupancy"] = mod.sweep_occupancy(plan, W, two, snapshot=True)
                entry["rounds"] = mod.snap_rounds(B, entry["occupancy"]["resident_pairs_per_sm"], sms)
            out[label] = entry
        print(json.dumps({"root": order[-1], "strips": out, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
