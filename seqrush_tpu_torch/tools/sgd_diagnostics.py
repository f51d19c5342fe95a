"""SGD layout diagnostics (reference src/bin/sgd_diagnostics.rs): per-step
displacement analysis — for every consecutive path step pair, compare the
layout distance implied by node order against the genomic distance, and
report the largest displacements (the reference's "catastrophic edge"
analysis, docs/povu_guided_sorting.md).

  python -m seqrush_tpu_torch.tools.sgd_diagnostics graph.gfa [--top 20]

Copied from seqrush_tpu/tools/sgd_diagnostics.py (host numpy).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..graph.bigraph import parse_gfa


def diagnostics(graph, top=20):
    node_ids = sorted(graph.nodes)
    pos = {}
    cum = 0
    for nid in node_ids:
        pos[nid] = cum
        cum += len(graph.nodes[nid])
    rows = []
    for path in graph.paths:
        for rank, (a, b) in enumerate(zip(path.steps[:-1], path.steps[1:])):
            na, nb = int(a) >> 1, int(b) >> 1
            layout_jump = pos[nb] - pos[na]
            genomic = len(graph.nodes[na])
            rows.append((abs(layout_jump - genomic), path.name, rank, na, nb, layout_jump, genomic))
    rows.sort(reverse=True)
    return rows[:top], rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sgd_diagnostics")
    p.add_argument("input")
    p.add_argument("--top", type=int, default=20)
    ns = p.parse_args(argv)
    with open(ns.input) as fh:
        graph = parse_gfa(fh)
    worst, rows = diagnostics(graph, ns.top)
    errs = np.array([r[0] for r in rows], dtype=np.float64)
    if errs.size == 0:
        print("0 step transitions")
        return 0
    print(f"{len(rows)} step transitions; RMSE {np.sqrt(np.mean(errs**2)):.2f} bp, MAE {np.mean(errs):.2f} bp")
    print(f"top {len(worst)} displacements:")
    for err, name, rank, na, nb, jump, genomic in worst:
        print(
            f"  path {name} step {rank}: node {na} -> {nb}, layout jump {jump:+d} "
            f"vs genomic {genomic} (err {err})"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
