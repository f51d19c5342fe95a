"""Time the path SGD (PG-SGD) of one graph on a GPU: the run as shipped (each
tick's displacement sums in a fixed order), the same ticks with
``index_add_``'s float atomics (not reproducible; what the fixed order
costs), and, with ``--profile``, the kernel launches, the distinct kernels
and the device-busy share of a window of ticks from ``torch.profiler``.
``first_tick_s`` and ``first_run_s`` are the first tick and the first whole
run of this process: in a fresh process they include the first use of every
torch kernel of the tick.

  python -m seqrush_tpu_torch.tools.sgd_timing graph.gfa [--profile] [--reps 3]

Prints one JSON object.  Needs a CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import torch

from ..graph.bigraph import BidirectedGraph, parse_gfa
from ..layout import sgd
from ..layout.ygs import YgsParams


def _run_seconds(plan: sgd.SGDPlan, seed: int) -> tuple[float, torch.Tensor]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = sgd._sgd_run(
        plan.x0, plan.tables, seed, plan.n_steps, plan.n_sub, plan.u_per_sub, plan.block_ticks
    )
    torch.cuda.synchronize()
    return time.perf_counter() - t0, x


def _scatter_terms_atomics(x, i, j, r_x, nvalid):
    """``sgd._scatter_terms`` with ``index_add_`` for the displacements too."""
    ij = torch.cat([i, j])
    upd = torch.zeros_like(x).index_add_(0, ij, torch.cat([-r_x, r_x]))
    term_cnt = torch.zeros_like(x).index_add_(0, ij, torch.cat([nvalid, nvalid]))
    return upd, term_cnt


@contextlib.contextmanager
def _float_atomics():
    """Within the body the ticks sum with plain ``index_add_``."""
    keep = sgd._scatter_terms
    sgd._scatter_terms = _scatter_terms_atomics
    try:
        yield
    finally:
        sgd._scatter_terms = keep


def profile_ticks(plan: sgd.SGDPlan, seed: int, n_ticks: int = 16) -> dict:
    """Kernel launches per tick and the device-busy share over ``n_ticks``
    ticks of the first iteration, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=plan.x0.device)
    gen.manual_seed(seed)
    draws = sgd.draw_block(gen, n_ticks, plan.u_per_sub, plan.n_steps)
    x = plan.x0
    for k in range(2):  # warm-up
        x = sgd.sgd_tick(x, 0, *(d[k] for d in draws), plan.tables)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(n_ticks):
            x = sgd.sgd_tick(x, 0, *(d[k] for d in draws), plan.tables)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.device_time for e in kernels) * 1e-6
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device activity")
    return {
        "profiled_ticks": n_ticks,
        "launches_per_tick": len(kernels) / n_ticks,
        "distinct_kernels": len({e.name for e in kernels}),
        "device_busy_share": busy_s / wall,
        "profiled_ms_per_tick": wall / n_ticks * 1e3,
    }


def time_sgd(graph: BidirectedGraph, reps: int = 3, with_profile: bool = False) -> dict:
    """Median wall seconds of the whole SGD run on cuda, both ways."""
    params = YgsParams.from_graph(graph).to_sgd()
    plan = sgd.sgd_setup(graph, params, "cuda")
    if plan is None:
        raise ValueError("the graph has no path of two steps: nothing to lay out")
    gen = torch.Generator(device=plan.x0.device)
    gen.manual_seed(params.seed)
    draws = sgd.draw_block(gen, 1, plan.u_per_sub, plan.n_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sgd.sgd_tick(plan.x0, 0, *(d[0] for d in draws), plan.tables)
    torch.cuda.synchronize()
    first_tick_s = time.perf_counter() - t0
    first_run_s = _run_seconds(plan, params.seed)[0]
    fixed, atomics = [], []
    same = True
    first = None
    for _ in range(reps):
        s, x = _run_seconds(plan, params.seed)
        fixed.append(s)
        same = same and (first is None or torch.equal(x, first))
        first = x if first is None else first
        with _float_atomics():
            atomics.append(_run_seconds(plan, params.seed)[0])
    out = {
        "nodes": int(plan.node_ids.size),
        "steps": plan.n_steps,
        "ticks": plan.n_ticks,
        "tick_width": plan.u_per_sub,
        "first_tick_s": first_tick_s,
        "first_run_s": first_run_s,
        "fixed_order_s": statistics.median(fixed),
        "float_atomics_s": statistics.median(atomics),
        "fixed_order_ms_per_tick": statistics.median(fixed) / plan.n_ticks * 1e3,
        "float_atomics_ms_per_tick": statistics.median(atomics) / plan.n_ticks * 1e3,
        "fixed_order_runs_bit_equal": same,
        "reps": reps,
        "device": torch.cuda.get_device_name(0),
    }
    if with_profile:
        out.update(profile_ticks(plan, params.seed))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sgd_timing")
    p.add_argument("input", help="GFA file")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--profile", action="store_true")
    ns = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sgd_timing: no CUDA device")
    with open(ns.input) as fh:
        graph = parse_gfa(fh)
    print(json.dumps(time_sgd(graph, ns.reps, ns.profile)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
