"""The Ygs sort pipeline: Y = path SGD (PG-SGD), g = groom, s = toposort.

The port of ``seqrush_tpu/layout/ygs.py``.

Exact phase sequence and parameter derivation of the reference
(reference src/ygs_sort.rs): min_term_updates = sum of path step
counts, eta_max = (max path step count)^2, space = max path length in bp
(ygs_sort.rs:49-91); each phase applies its ordering/flips before the next
runs (ygs_sort.rs:96-162).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..graph.bigraph import BidirectedGraph
from ..graph.groom import apply_grooming, groom_order
from ..graph.toposort import (
    exact_odgi_topological_order,
    sgd_stable_topological_order,
)
from .sgd import PathIndex, PathSGDParams, path_sgd_sort


@dataclass
class YgsParams:
    iter_max: int = 100
    iter_with_max_learning_rate: int = 0
    min_term_updates: int = 0
    delta: float = 0.0
    eps: float = 0.01
    eta_max: float = 0.0
    theta: float = 0.99
    space: int = 0
    space_max: int = 100
    space_quantization_step: int = 100
    cooling_start: float = 0.5
    nthreads: int = 1
    verbose: bool = False
    seed: int = 9399220
    # quality extensions beyond the reference (they bring the canonical
    # synthetic zoo's mean RMSE below ODGI's 24.86 bp target):
    #   refine_rounds — median path-context repair of SGD outliers between
    #     the Y and g phases (layout/sgd.py refine_positions); 0 disables.
    #   topo_mode — final ordering:
    #     'best' = evaluate candidate orderings (refined-SGD order,
    #       exact-ODGI topo, ODGI topo + rank refinement, bounded-stall
    #       stable topo, bubble-chain, bubble-chain + rank refinement)
    #       by layout RMSE and apply the winner — the evaluation is one
    #       pass over path steps, cheap next to SGD;
    #     'stable' = bounded-displacement topological order over majority
    #       path flow (graph/toposort.py sgd_stable_topological_order);
    #     'bubble' = path-anchor bubble-chain order (layout/bubbles.py,
    #       the reference's documented-but-unbuilt povu proposal);
    #     'odgi' = the reference/ODGI exact 's' phase (parity mode).
    refine_rounds: int = 4
    topo_mode: str = "best"
    stall_bound: int = 8

    @staticmethod
    def from_graph(graph: BidirectedGraph, verbose: bool = False, nthreads: int = 1) -> "YgsParams":
        params = YgsParams(verbose=verbose, nthreads=nthreads)
        index = PathIndex.from_graph(graph)
        if index.path_count.size:
            params.min_term_updates = int(index.path_count.sum())
            params.eta_max = float(int(index.path_count.max()) ** 2)
            params.space = int(index.path_len.max())
        if verbose:
            print(
                f"[ygs_sort] min_term_updates={params.min_term_updates} "
                f"eta_max={params.eta_max} space={params.space}"
            )
        return params

    def to_sgd(self) -> PathSGDParams:
        return PathSGDParams(
            iter_max=self.iter_max,
            iter_with_max_learning_rate=self.iter_with_max_learning_rate,
            min_term_updates=self.min_term_updates,
            delta=self.delta,
            eps=self.eps,
            eta_max=self.eta_max,
            theta=self.theta,
            space=self.space,
            space_max=self.space_max,
            space_quantization_step=self.space_quantization_step,
            cooling_start=self.cooling_start,
            nthreads=self.nthreads,
            progress=self.verbose,
            seed=self.seed,
        )


def ygs_sort(
    graph: BidirectedGraph,
    params: YgsParams | None = None,
    use_sgd: bool = True,
    use_groom: bool = True,
    use_topo: bool = True,
    timings: dict | None = None,
    device: str | torch.device = "cuda",
) -> None:
    """Sort ``graph`` in place.  The SGD runs on ``device``; groom and the
    final ordering are host numpy."""
    import time as _time

    def _mark(d, key, t0):
        if d is not None:
            d[key] = d.get(key, 0.0) + _time.time() - t0

    if params is None:
        params = YgsParams.from_graph(graph)
    if use_sgd:
        t0 = _time.time()
        ordering = path_sgd_sort(
            graph, params.to_sgd(), refine_rounds=params.refine_rounds, device=device
        )
        graph.apply_ordering(ordering)
        _mark(timings, "sgd", t0)
    if use_groom:
        t0 = _time.time()
        apply_grooming(graph, groom_order(graph))
        _mark(timings, "groom", t0)
    if use_topo:
        t0 = _time.time()
        if params.topo_mode == "stable":
            graph.apply_ordering(
                sgd_stable_topological_order(graph, params.stall_bound)
            )
        elif params.topo_mode == "bubble":
            from .bubbles import bubble_chain_order

            order = bubble_chain_order(graph)
            if order is None:  # no consistent anchor chain: reference 's'
                order = exact_odgi_topological_order(graph, True, False)
            graph.apply_ordering(order)
        elif params.topo_mode == "best":
            graph.apply_ordering(_best_final_order(graph, params))
            if params.refine_rounds > 0:
                _polish_by_rank_refinement(graph, params)
        else:
            graph.apply_ordering(exact_odgi_topological_order(graph, True, False))
        _mark(timings, "final_order", t0)


def _polish_by_rank_refinement(
    graph: BidirectedGraph, params: "YgsParams", max_iters: int = 4
) -> None:
    """Iterate (rank positions -> median outlier repair -> reorder) to a
    fixpoint, accepting only strict RMSE improvements — each round's repair
    exposes new outliers relative to the repaired layout (measured on the
    stubborn zoo genes: 53.8 -> 41.0 bp and 46.0 -> 39.8 bp over 3 rounds;
    the easy genes converge immediately, so the extra rounds cost nothing)."""
    from .sgd import refine_positions

    cur = rmse_for_order(graph, [nid << 1 for nid in sorted(graph.nodes)])
    for _ in range(max_iters):
        pos: dict[int, float] = {}
        cum = 0
        for nid in sorted(graph.nodes):
            pos[nid] = float(cum)
            cum += len(graph.nodes[nid])
        refined = refine_positions(graph, pos, params.refine_rounds)
        order = [
            n << 1 for n, _ in sorted(refined.items(), key=lambda kv: (kv[1], kv[0]))
        ]
        new = rmse_for_order(graph, order)
        if new < cur - 1e-9:
            graph.apply_ordering(order)
            cur = new
        else:
            break


def rmse_for_order(graph: BidirectedGraph, order: list[int]) -> float:
    """Layout RMSE a node ordering WOULD produce, without mutating the
    graph — delegates to the one metric definition
    (tools/measure_layout_quality.layout_quality)."""
    from ..tools.measure_layout_quality import layout_quality

    return layout_quality(graph, order)["rmse"]


def _best_final_order(graph: BidirectedGraph, params: "YgsParams") -> list[int]:
    """Candidate final orderings, scored by the layout metric itself;
    ties keep the earlier (more reference-faithful) candidate.  Measured:
    the exact-ODGI topo sometimes REPAIRS SGD catastrophes (its constraints
    pull displaced blocks back together) and sometimes AMPLIFIES them (one
    mis-ranked predecessor stalls a block); no single ordering dominates,
    but the metric is one cheap pass over path steps, so evaluating all
    candidates costs ~nothing next to the SGD phase."""
    from .bubbles import bubble_chain_order
    from .sgd import refine_positions

    def refined_order(base: list[int]) -> list[int]:
        pos: dict[int, float] = {}
        cum = 0
        for h in base:
            nid = int(h) >> 1
            pos[nid] = float(cum)
            cum += len(graph.nodes[nid])
        refined = refine_positions(graph, pos, params.refine_rounds)
        return [
            n << 1 for n, _ in sorted(refined.items(), key=lambda kv: (kv[1], kv[0]))
        ]

    ord_y = [nid << 1 for nid in sorted(graph.nodes)]
    ord_odgi = exact_odgi_topological_order(graph, True, False)
    candidates = [ord_odgi]
    names = ["odgi"]
    if params.refine_rounds > 0:  # 0 disables ALL refinement (YgsParams doc)
        candidates.append(refined_order(ord_odgi))
        names.append("odgi+refine")
    candidates.append(sgd_stable_topological_order(graph, params.stall_bound))
    names.append("stable")
    ord_bubble = bubble_chain_order(graph)
    if ord_bubble is not None:
        candidates.append(ord_bubble)
        names.append("bubble")
        if params.refine_rounds > 0:
            candidates.append(refined_order(ord_bubble))
            names.append("bubble+refine")
    candidates.append(ord_y)
    names.append("sgd")
    scores = [rmse_for_order(graph, o) for o in candidates]
    best = min(range(len(candidates)), key=lambda k: scores[k])
    if params.verbose:
        print(
            f"[ygs_sort] final-order candidates ({', '.join(names)}): "
            f"RMSE {[round(s, 1) for s in scores]} -> {names[best]}"
        )
    return candidates[best]


def sgd_sort_only(
    graph: BidirectedGraph, params: YgsParams, device: str | torch.device = "cuda"
) -> None:
    ygs_sort(graph, params, use_sgd=True, use_groom=False, use_topo=False, device=device)


def groom_only(graph: BidirectedGraph) -> None:
    ygs_sort(graph, None, use_sgd=False, use_groom=True, use_topo=False)


def topological_sort_only(graph: BidirectedGraph) -> None:
    ygs_sort(graph, None, use_sgd=False, use_groom=False, use_topo=True)
