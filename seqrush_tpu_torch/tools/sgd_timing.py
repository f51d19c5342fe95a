"""Check and time the path SGD (PG-SGD) of one graph on a GPU.

* ``cpu_parity``: the run's ticks through the tick kernel on the card and
  through the plain tick (``sgd.sgd_tick``) on the CPU, fed the same draws
  (made on the card, copied to the host): the positions must be equal bit
  for bit after each tick of the first block of draws and at the end of
  every block (of the first ``blocks`` blocks, when given); over the whole
  run, the layout's own run (``sgd._sgd_run``) must give the same positions.
* ``time_sgd``: the whole run on the tick kernel (``sgd._sgd_run``, as the
  layout runs it) and on the plain ticks on the card, in turns (plain,
  kernel, kernel, plain, ``reps`` times); whether the kernel runs with one
  seed are bit-equal; with ``--profile`` the launches a tick, the distinct
  kernels and the device-busy share of a window of ticks of each, from
  torch.profiler.  ``first_run_s`` is the first kernel run of this process
  (in a fresh process it includes loading the kernels' library).

  python -m seqrush_tpu_torch.tools.sgd_timing graph.gfa [--profile] [--reps 1] [--parity [BLOCKS]]
  python -m seqrush_tpu_torch.tools.sgd_timing --synthetic 1000 [--loop K] [--profile] [--parity [BLOCKS]]

``--synthetic N`` lays out ``tools/headline.py::synth_variation_graph`` with
N paths instead of a GFA file (``--loop K``: each path also visits one node
K times in a row, a collapsed tandem repeat, so that node is named by
thousands of terms a tick); ``--long-node-terms N`` sets the count of terms
a tick above which the kernel ranks a node with a block, not a warp
(``sgd.LONG_NODE_TERMS``); ``--parity`` runs ``cpu_parity`` over the first
BLOCKS blocks of draws (1 when none is given, 0 for every block).
Prints one JSON object.  Needs a CUDA device; there is no CPU mode.
``chip_smoke.py`` runs it in a process of its own: later profiler sessions
in a process that ran these have recorded no device activity.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..graph.bigraph import BidirectedGraph, parse_gfa
from ..layout import sgd
from ..layout.ygs import YgsParams
from .headline import synth_variation_graph

# the bytes each term's draws take: an int64 step, two coin bytes, two
# float32 uniforms
TERM_DRAW_BYTES = 8 + 1 + 1 + 4 + 4


def tick_bytes(plan: sgd.SGDPlan) -> int:
    """The bytes one tick must move at this plan's width, nodes and tables
    (csrc/sgd_tick.cu's header): each term's draws, read once; each table
    the terms gather from charged at its reads a term times the terms, or
    at its size where that is less (H and the path tables, read by every
    term, come from cache after their first read): two reads of
    node_of_step and step_pos, one of step_path, step_rank, path_first and
    path_count, and H[js] with up to bit_length(space + 1) probes of the
    search; the positions x read once (the terms' reads of x are reads of
    that table) and written once."""
    t, w = plan.tables, plan.u_per_sub

    def table(a: torch.Tensor, reads: int) -> int:
        return min(reads * w, a.numel()) * a.element_size()

    probes = int(t.space + 1).bit_length() + 1
    gathers = (table(t.node_of_step, 2) + table(t.step_pos, 2) + table(t.step_path, 1) + table(t.step_rank, 1)
               + table(t.path_first, 1) + table(t.path_count, 1) + table(t.Hmain, probes))
    return w * TERM_DRAW_BYTES + gathers + 2 * plan.x0.numel() * plan.x0.element_size()


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """float32 tensors equal bit for bit (-0.0 is not 0.0)."""
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _setup(graph: BidirectedGraph, device: str) -> tuple[sgd.PathSGDParams, sgd.SGDPlan]:
    params = YgsParams.from_graph(graph).to_sgd()
    plan = sgd.sgd_setup(graph, params, device)
    if plan is None:
        raise ValueError("the graph has no path of two steps: nothing to lay out")
    return params, plan


def _plain_run(plan: sgd.SGDPlan, seed: int) -> torch.Tensor:
    """The run's ticks as plain torch ticks (``sgd.sgd_tick``) on the plan's
    device: ``sgd._sgd_run``'s loop, draws and block layout, without the
    kernel."""
    T = plan.n_ticks
    B = plan.block_ticks or T
    gen = torch.Generator(device=plan.x0.device)
    gen.manual_seed(int(seed))
    x = plan.x0
    for lo in range(0, T, B):
        draws = sgd.draw_block(gen, min(B, T - lo), plan.u_per_sub, plan.n_steps)
        for k in range(draws[0].shape[0]):
            x = sgd.sgd_tick(x, (lo + k) // plan.n_sub, *(d[k] for d in draws), plan.tables)
    return x


def _run_seconds(plan: sgd.SGDPlan, seed: int, plain: bool = False) -> tuple[float, torch.Tensor]:
    """Wall seconds of the whole run on the card: the layout's own run
    (``sgd._sgd_run``, the tick kernel), or with ``plain`` ``_plain_run``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if plain:
        x = _plain_run(plan, seed)
    else:
        x = sgd._sgd_run(plan.x0, plan.tables, seed, plan.n_steps, plan.n_sub, plan.u_per_sub,
                         plan.block_ticks)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, x


def cpu_parity(graph: BidirectedGraph, blocks: int | None = None) -> dict:
    """The tick kernel on the card against the plain tick on the CPU, fed
    the same draws, tick by tick through the first block of draws and block
    by block after it (the first ``blocks`` blocks, or all).  Returns the
    ticks and blocks compared, the largest |difference| seen and whether
    every comparison was bit-equal."""
    params, gpu = _setup(graph, "cuda")
    cpu = sgd.sgd_setup(graph, params, "cpu")
    T, B = gpu.n_ticks, gpu.block_ticks
    n_blocks = -(-T // B) if blocks is None else min(blocks, -(-T // B))
    gen = torch.Generator(device=gpu.x0.device)
    gen.manual_seed(int(params.seed))
    work = sgd.tick_work(gpu.x0.shape[0], gpu.u_per_sub, gpu.x0.device)
    xk, xc = gpu.x0, cpu.x0
    err, unequal, ticks = 0.0, [], 0
    t0 = time.perf_counter()
    for b in range(n_blocks):
        lo = b * B
        draws = sgd.draw_block(gen, min(B, T - lo), gpu.u_per_sub, gpu.n_steps)
        host = [d.cpu() for d in draws]
        for k in range(draws[0].shape[0]):
            it = (lo + k) // gpu.n_sub
            xk = sgd.sgd_tick_cuda(xk, it, *(d[k] for d in draws), gpu.tables, work=work)
            xc = sgd.sgd_tick(xc, it, *(d[k] for d in host), cpu.tables)
            ticks += 1
            if b == 0 or k == draws[0].shape[0] - 1:
                got = xk.cpu()
                err = max(err, float((got - xc).abs().max()))
                if not _bits_equal(got, xc):
                    unequal.append(lo + k)
    out = {
        "nodes": int(gpu.x0.shape[0]), "steps": gpu.n_steps, "tick_width": gpu.u_per_sub,
        "block_ticks": B, "ticks_compared": ticks, "blocks_compared": n_blocks,
        "ticks_compared_one_by_one": min(B, T), "max_abs_err": err, "unequal_ticks": unequal[:8],
        "bit_equal": not unequal, "parity_s": time.perf_counter() - t0,
    }
    if n_blocks * B >= T:
        _s, x_run = _run_seconds(gpu, params.seed)
        out["layout_run_equal"] = _bits_equal(x_run, xk)
        out["bit_equal"] = out["bit_equal"] and out["layout_run_equal"]
    return out


def profile_ticks(plan: sgd.SGDPlan, seed: int, plain: bool = False, n_ticks: int = 16) -> dict:
    """Kernel launches per tick and the device-busy share over ``n_ticks``
    ticks of the first iteration, from torch.profiler: the tick kernel, or
    with ``plain`` the plain tick on the card."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=plan.x0.device)
    gen.manual_seed(seed)
    draws = sgd.draw_block(gen, n_ticks, plan.u_per_sub, plan.n_steps)
    if plain:
        def tick(x, it, *d):
            return sgd.sgd_tick(x, it, *d, plan.tables)
    else:
        tick = sgd._kernel_ticks(plan.x0, plan.tables, plan.u_per_sub)
    x = plan.x0
    for k in range(2):  # warm-up
        x = tick(x, 0, *(d[k] for d in draws))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(n_ticks):
            x = tick(x, 0, *(d[k] for d in draws))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy_s = sum(e.device_time for e in kernels) * 1e-6
    return {
        "profiled_ticks": n_ticks,
        "launches_per_tick": len(kernels) / n_ticks,
        "distinct_kernels": len({e.name for e in kernels}),
        "device_busy_share": busy_s / wall,
        "profiled_ms_per_tick": wall / n_ticks * 1e3,
        "device_ms_per_tick": busy_s / n_ticks * 1e3,
    }


def time_sgd(graph: BidirectedGraph, reps: int = 1, with_profile: bool = False) -> dict:
    """Wall seconds of the whole SGD run on cuda, on the tick kernel and on
    the plain ticks, in turns (plain, kernel, kernel, plain per rep)."""
    params, plan = _setup(graph, "cuda")
    first_run_s, first = _run_seconds(plan, params.seed)
    secs = {"kernel": [], "plain": []}
    same = True
    for _ in range(reps):
        for kind in ("plain", "kernel", "kernel", "plain"):
            s, x = _run_seconds(plan, params.seed, plain=kind == "plain")
            secs[kind].append(s)
            if kind == "kernel":
                same = same and _bits_equal(x, first)
    kernel_s, plain_s = statistics.median(secs["kernel"]), statistics.median(secs["plain"])
    out = {
        "nodes": int(plan.node_ids.size),
        "steps": plan.n_steps,
        "paths": len(graph.paths),
        "ticks": plan.n_ticks,
        "tick_width": plan.u_per_sub,
        "block_ticks": plan.block_ticks,
        "first_run_s": first_run_s,
        "kernel_s": kernel_s,
        "plain_s": plain_s,
        "kernel_runs_s": secs["kernel"],
        "plain_runs_s": secs["plain"],
        "kernel_ms_per_tick": kernel_s / plan.n_ticks * 1e3,
        "plain_ms_per_tick": plain_s / plan.n_ticks * 1e3,
        "max_node_steps": int(torch.bincount(plan.tables.node_of_step).max()),
        "long_node_terms": sgd.LONG_NODE_TERMS,
        "tick_bytes": tick_bytes(plan),
        "bound_ms_per_tick": tick_bytes(plan) / 3.35e12 * 1e3,
        "kernel_runs_bit_equal": same,
        "finite": bool(torch.isfinite(first).all()),
        "reps": reps,
        "device": torch.cuda.get_device_name(0),
    }
    if with_profile:
        # under the profiler the host takes longer to issue a tick, so the
        # busy share of its window is low; the device time a tick over the
        # unprofiled runs' time a tick is the share of a run as shipped
        for kind in ("kernel", "plain"):
            prof = profile_ticks(plan, params.seed, plain=kind == "plain")
            prof["device_busy_share_of_run"] = prof["device_ms_per_tick"] / out[f"{kind}_ms_per_tick"]
            out[f"{kind}_profile"] = prof
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sgd_timing")
    p.add_argument("input", nargs="?", help="GFA file")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="lay out synth_variation_graph(n_paths=N) instead of a GFA file")
    p.add_argument("--loop", type=int, default=0, metavar="K",
                   help="with --synthetic: each path visits one node K times in a row")
    p.add_argument("--long-node-terms", type=int, default=None, metavar="N",
                   help="rank a node of more than N terms a tick with a block (default "
                        f"{sgd.LONG_NODE_TERMS}; a large N ranks every node with a warp)")
    p.add_argument("--reps", type=int, default=1)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--parity", type=int, nargs="?", const=1, default=None, metavar="BLOCKS",
                   help="also hold the kernel to the plain tick on the CPU over the first BLOCKS blocks "
                        "of draws (1 when none is given; 0: every block)")
    ns = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sgd_timing: no CUDA device")
    if ns.synthetic:
        graph = synth_variation_graph(n_paths=ns.synthetic, loop_visits=ns.loop)
    elif ns.input:
        with open(ns.input) as fh:
            graph = parse_gfa(fh)
    else:
        raise SystemExit("sgd_timing: give a GFA file or --synthetic N")
    if ns.long_node_terms is not None:
        sgd.LONG_NODE_TERMS = ns.long_node_terms
    out = time_sgd(graph, ns.reps, ns.profile)
    if ns.parity is not None:
        out["cpu_parity"] = cpu_parity(graph, blocks=ns.parity or None)
    print(json.dumps(out, default=lambda v: v.item() if isinstance(v, np.generic) else str(v)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
