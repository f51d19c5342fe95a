"""Standalone GFA sorter — equivalent of the reference's sort_gfa binary
(reference src/bin/sort_gfa.rs): read GFA, apply the Ygs pipeline, write
sorted GFA.

  python -m seqrush_tpu_torch.tools.sort_gfa in.gfa out.gfa [--skip-sgd ...]
"""

from __future__ import annotations

import argparse

from ..graph.bigraph import parse_gfa
from ..layout.ygs import YgsParams, ygs_sort


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sort_gfa")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--skip-sgd", action="store_true")
    p.add_argument("--skip-groom", action="store_true")
    p.add_argument("--skip-topo", action="store_true")
    p.add_argument("--sgd-iter-max", type=int, default=100)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument(
        "--device", default="cuda",
        help="torch device of the SGD phase: 'cuda' or 'cpu' (no fallback)",
    )
    ns = p.parse_args(argv)

    with open(ns.input) as fh:
        graph = parse_gfa(fh)
    params = YgsParams.from_graph(graph, verbose=ns.verbose)
    params.iter_max = ns.sgd_iter_max
    ygs_sort(
        graph,
        params,
        use_sgd=not ns.skip_sgd,
        use_groom=not ns.skip_groom,
        use_topo=not ns.skip_topo,
        device=ns.device,
    )
    with open(ns.output, "w") as fh:
        graph.write_gfa(fh)
    if ns.verbose:
        print(f"Sorted {graph.node_count()} nodes -> {ns.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
