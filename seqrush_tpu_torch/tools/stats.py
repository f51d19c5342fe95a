"""Graph statistics — the `odgi stats` analog the reference README points
users at for verification (reference README.md:41).

  python -m seqrush_tpu_torch.tools.stats graph.gfa [--json]

Reports length/node/edge/path counts, node length distribution (N50),
degree distribution, and per-path step/length summaries.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..graph.bigraph import BidirectedGraph, parse_gfa


def graph_stats(g: BidirectedGraph) -> dict:
    lens = np.array([len(s) for s in g.nodes.values()], dtype=np.int64)
    total = int(lens.sum()) if lens.size else 0
    n50 = 0
    if lens.size:
        s = np.sort(lens)[::-1]
        c = np.cumsum(s)
        n50 = int(s[np.searchsorted(c, total / 2)])
    deg = {}
    for (f, t) in g.edges:
        deg[f >> 1] = deg.get(f >> 1, 0) + 1
        deg[t >> 1] = deg.get(t >> 1, 0) + 1
    degs = np.array(list(deg.values()), dtype=np.int64) if deg else np.zeros(1, np.int64)
    paths = []
    for p in g.paths:
        plen = int(sum(len(g.nodes[int(h) >> 1]) for h in p.steps))
        rev = int((p.steps & 1).sum())
        paths.append(
            {"name": p.name, "steps": int(p.steps.size), "length_bp": plen, "reverse_steps": rev}
        )
    return {
        "length_bp": total,
        "nodes": g.node_count(),
        "edges": len(g.edges),
        "paths": len(g.paths),
        "node_len_min": int(lens.min()) if lens.size else 0,
        "node_len_max": int(lens.max()) if lens.size else 0,
        "node_len_mean": float(lens.mean()) if lens.size else 0.0,
        "node_len_n50": n50,
        "degree_max": int(degs.max()),
        "degree_mean": float(degs.mean()),
        "path_summaries": paths,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="stats")
    p.add_argument("input")
    p.add_argument("--json", action="store_true")
    ns = p.parse_args(argv)
    with open(ns.input) as fh:
        g = parse_gfa(fh)
    st = graph_stats(g)
    if ns.json:
        print(json.dumps(st))
        return 0
    print(f"#length\t{st['length_bp']}")
    print(f"#nodes\t{st['nodes']}")
    print(f"#edges\t{st['edges']}")
    print(f"#paths\t{st['paths']}")
    print(
        f"#node-length\tmin {st['node_len_min']}  mean {st['node_len_mean']:.1f}  "
        f"N50 {st['node_len_n50']}  max {st['node_len_max']}"
    )
    print(f"#degree\tmean {st['degree_mean']:.2f}  max {st['degree_max']}")
    for ps in st["path_summaries"]:
        print(
            f"path\t{ps['name']}\t{ps['steps']} steps\t{ps['length_bp']} bp\t"
            f"{ps['reverse_steps']} reverse"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
