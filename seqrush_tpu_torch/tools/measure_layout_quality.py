"""Layout-quality metric — equivalent of the reference's
measure_layout_quality binary (reference src/bin/
measure_layout_quality.rs:150-213): for every consecutive path step, the
error is |layout distance - genomic distance| where layout position of a
node is the cumulative sequence offset of nodes in id order; reports
MSE / RMSE / MAE plus length-normalized variants.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..graph.bigraph import BidirectedGraph, parse_gfa


def layout_quality(graph: BidirectedGraph, order: list[int] | None = None) -> dict:
    """Layout-quality stats for the graph's CURRENT node-id order, or for a
    hypothetical ``order`` (forward handles) without mutating the graph —
    the single definition of the metric (layout/ygs.py's final-ordering
    candidate selection scores with this same function)."""
    if order is None:
        node_ids = sorted(graph.nodes)
    else:
        node_ids = [int(h) >> 1 for h in order]
    # id-indexed length/position tables: one pass over nodes, then every
    # path scores with pure array gathers (this metric runs 6-8x per
    # ygs_sort for the candidate-ordering selection — it must be cheap)
    ids = np.fromiter(node_ids, dtype=np.int64, count=len(node_ids))
    lens = np.fromiter(
        (len(graph.nodes[nid]) for nid in node_ids),
        dtype=np.float64,
        count=len(node_ids),
    )
    size = int(ids.max()) + 1 if ids.size else 1
    lens_by_id = np.zeros(size, dtype=np.float64)
    lens_by_id[ids] = lens
    pos_by_id = np.zeros(size, dtype=np.float64)
    pos_by_id[ids] = np.concatenate([[0.0], np.cumsum(lens)[:-1]])
    errors = []
    for path in graph.paths:
        ns = (np.asarray(path.steps) >> 1).astype(np.int64)
        if ns.size < 2:
            continue
        la = lens_by_id[ns[:-1]]
        p = pos_by_id[ns]
        errors.append(np.abs(np.abs(np.diff(p)) - la))
    if not errors:
        return {"mse": 0.0, "rmse": 0.0, "mae": 0.0, "n_terms": 0}
    e = np.concatenate(errors)
    total_len = sum(len(s) for s in graph.nodes.values())
    return {
        "mse": float(np.mean(e**2)),
        "rmse": float(np.sqrt(np.mean(e**2))),
        "mae": float(np.mean(e)),
        "rmse_normalized": float(np.sqrt(np.mean(e**2)) / max(total_len, 1)),
        "n_terms": int(e.size),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="measure_layout_quality")
    p.add_argument("input")
    p.add_argument("--json", action="store_true")
    ns = p.parse_args(argv)
    with open(ns.input) as fh:
        graph = parse_gfa(fh)
    q = layout_quality(graph)
    if ns.json:
        print(json.dumps(q))
    else:
        print(f"Layout quality for {ns.input} ({graph.node_count()} nodes):")
        for k, v in q.items():
            print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
