"""Time the default CLI run (FASTA to GFA with the layout) of two or more
checkouts of the repository in turns on one GPU.

  python -m seqrush_tpu_torch.tools.cli_turns --root OLD --root . [--rounds 2] [--runs 3] [--fasta F]

Each ``--root`` is a checkout (an older commit unpacked with ``git
archive``, for example).  The headline corpus (``tools/headline.py::
synth_hla``) is written once, or ``--fasta`` names another; each root first runs it once in a process of
its own (its kernels' build, not timed), then in each round the roots run
in turns, forward then backward (A B B A), each in a fresh process that
calls that checkout's ``cli.main`` ``runs`` times in a row with
``--profile``.  Per run: ``cli.main``'s wall seconds, its phase seconds, the
GFA's sha256 and the sorted graph's layout RMSE and MAE (that checkout's
``tools/measure_layout_quality``).  Prints one JSON object with every run,
per root the median wall of the first run of a process (what a user's
single run pays) and of the later runs, and the nvidia-smi name and power
limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

from .headline import synth_hla

# run in each root's own directory, so ``import seqrush_tpu_torch`` is that
# checkout's package
_CHILD = r"""
import hashlib, json, sys, time
from pathlib import Path
fasta, out, runs = sys.argv[1], Path(sys.argv[2]), int(sys.argv[3])
from seqrush_tpu_torch import cli
from seqrush_tpu_torch.graph.bigraph import parse_gfa
from seqrush_tpu_torch.tools.measure_layout_quality import layout_quality
res = []
for r in range(runs):
    gfa, prof = out / f"run{r}.gfa", out / f"run{r}.json"
    t0 = time.perf_counter()
    rc = cli.main(["-s", fasta, "-o", str(gfa), "--profile", str(prof)])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"cli.main returned {rc}")
    rep = json.loads(prof.read_text())
    with open(gfa) as fh:
        q = layout_quality(parse_gfa(fh))
    res.append({"wall_s": wall, "phases_s": rep["phases_s"], "rmse": q["rmse"], "mae": q["mae"],
                "gfa_sha256": hashlib.sha256(gfa.read_bytes()).hexdigest()})
print(json.dumps(res))
"""


def _child(root: Path, fasta: Path, out: Path, runs: int) -> list[dict]:
    out.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(fasta), str(out), str(runs)], cwd=root,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
        raise RuntimeError(f"the CLI run in {root} failed")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cli_turns")
    p.add_argument("--root", action="append", required=True, help="a checkout of the repository")
    p.add_argument("--rounds", type=int, default=2, help="rounds of turns (A B B A each)")
    p.add_argument("--runs", type=int, default=3, help="cli.main runs a process")
    p.add_argument("--fasta", help="a FASTA file to run instead of the headline corpus")
    ns = p.parse_args(argv)
    roots = [Path(r).resolve() for r in ns.root]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    runs: dict[str, list[list[dict]]] = {str(r): [] for r in roots}
    with tempfile.TemporaryDirectory(prefix="cli_turns_") as tmp:
        work = Path(tmp)
        if ns.fasta:
            fasta = Path(ns.fasta).resolve()
        else:
            fasta = work / "hla25.fa"
            fasta.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s) for n, s in synth_hla()))
        for k, root in enumerate(roots):
            _child(root, fasta, work / f"warm{k}", 1)
        order = []
        for _ in range(ns.rounds):
            order += roots + roots[::-1]
        for n, root in enumerate(order):
            runs[str(root)].append(_child(root, fasta, work / f"turn{n}", ns.runs))
    summary = {}
    for root, procs in runs.items():
        first = [ps[0]["wall_s"] for ps in procs]
        later = [r["wall_s"] for ps in procs for r in ps[1:]]
        sgd = [r["phases_s"].get("layout_sgd") for ps in procs for r in ps]
        summary[root] = {
            "first_run_wall_s": statistics.median(first), "first_run_walls_s": first,
            "later_run_wall_s": statistics.median(later) if later else None,
            "layout_sgd_s": statistics.median(s for s in sgd if s is not None),
            "rmse": sorted({r["rmse"] for ps in procs for r in ps}),
            "gfa_sha256": sorted({r["gfa_sha256"] for ps in procs for r in ps}),
        }
    print(json.dumps({"order": [str(r) for r in order], "summary": summary, "runs": runs, "smi": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
