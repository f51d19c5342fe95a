"""Check and time the path SGD (PG-SGD) of one graph on a GPU.

* ``cpu_parity``: the run's ticks through the tick kernel on the card and
  through the plain tick (``sgd.sgd_tick``) on the CPU, fed the same draws
  (made on the card, copied to the host): the positions must be equal bit
  for bit after every tick, each tick one launch of one tick
  (``sgd.sgd_tick_cuda``), and at the end of every block of draws, the block
  one launch of its ticks (``sgd.sgd_ticks_cuda``), for the first
  ``blocks`` blocks or all; over the whole run, the layout's own run
  (``sgd._sgd_run``) must give the same positions.
* ``time_sgd``: the whole run on the tick kernel (``sgd._sgd_run``, as the
  layout runs it) and on the plain ticks on the card, in turns (plain,
  kernel, kernel, plain, ``reps`` times); whether the kernel runs with one
  seed are bit-equal; with ``--profile`` the kernel launches a block of
  ticks (and the draws' RNG launches apart), the device time a tick by
  kernel and the device-busy share of the run's first block, from
  torch.profiler, the same for 16 plain ticks, and the tick kernel's
  device time a tick by phase (its own timer, ``phase_split``).
  ``first_run_s`` is the first kernel run of this process (in a fresh
  process it includes loading the kernels' library).

  python -m seqrush_tpu_torch.tools.sgd_timing graph.gfa [--profile] [--reps 1] [--parity [BLOCKS]]
  python -m seqrush_tpu_torch.tools.sgd_timing --synthetic 1000 [--loop K] [--profile] [--parity [BLOCKS]]

``--synthetic N`` lays out ``tools/headline.py::synth_variation_graph`` with
N paths instead of a GFA file (``--loop K``: each path also visits one node
K times in a row, a collapsed tandem repeat, so that node is named by
thousands of terms a tick); ``--parity`` runs ``cpu_parity`` over the first
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
from ..ops import nw_cuda
from .headline import synth_variation_graph

# the bytes each term's draws take: an int64 step, two coin bytes, two
# float32 uniforms
TERM_DRAW_BYTES = 8 + 1 + 1 + 4 + 4
# the bytes of a field of the tables the terms gather from: the tick
# kernel's records hold every step and path field as int32 or float32
# (sgd.kernel_tables), and H is float32
FIELD_BYTES = 4


def tick_bytes(plan: sgd.SGDPlan) -> int:
    """The bytes one tick must move at this plan's width, nodes and tables
    (csrc/sgd_tick.cu's header): each term's draws, read once; each table
    the terms gather from charged at FIELD_BYTES a field, its reads a term
    times the terms, or its size where that is less (H and the path tables,
    read by every term, come from cache after their first read): the first
    step's node, position, path and rank, the second step's node and
    position, the path's first step and count, and H[js] with up to
    bit_length(space + 1) probes of the search; the positions x read once
    (the terms' reads of x are reads of that table) and written once."""
    t, w = plan.tables, plan.u_per_sub

    def table(a: torch.Tensor, reads: int) -> int:
        return min(reads * w, a.numel()) * FIELD_BYTES

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
    gen = torch.Generator(device=plan.x0.device)
    gen.manual_seed(int(seed))
    x = plan.x0
    for lo, n in sgd.tick_blocks(plan.n_ticks, plan.block_ticks):
        draws = sgd.draw_block(gen, n, plan.u_per_sub, plan.n_steps)
        for k in range(n):
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
    the same draws: every tick of the first ``blocks`` blocks of draws (or
    all) one launch at a time, and each block's end as one launch of the
    block's ticks from the same positions.  Returns the ticks and blocks
    compared, the kernel launches made, the largest |difference| seen and
    whether every comparison was bit-equal."""
    params, gpu = _setup(graph, "cuda")
    cpu = sgd.sgd_setup(graph, params, "cpu")
    T, B = gpu.n_ticks, gpu.block_ticks
    n_blocks = -(-T // B) if blocks is None else min(blocks, -(-T // B))
    gen = torch.Generator(device=gpu.x0.device)
    gen.manual_seed(int(params.seed))
    work = sgd.tick_work(gpu.x0.shape[0], gpu.u_per_sub, gpu.tables.space, gpu.x0.device, B)
    bufs = (torch.empty_like(gpu.x0), torch.empty_like(gpu.x0))
    before = nw_cuda.LAUNCHES["sgd_tick"]
    xk, xb, xc = gpu.x0, gpu.x0, cpu.x0
    err, unequal, unequal_blocks, ticks = 0.0, [], [], 0
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
            got = xk.cpu()
            err = max(err, float((got - xc).abs().max()))
            if not _bits_equal(got, xc):
                unequal.append(lo + k)
        outs = bufs if xb is not bufs[0] else bufs[::-1]
        xb = sgd.sgd_ticks_cuda(xb, lo, gpu.n_sub, draws, gpu.tables, work, outs)
        got = xb.cpu()
        err = max(err, float((got - xc).abs().max()))
        if not _bits_equal(got, xc):
            unequal_blocks.append(b)
    out = {
        "nodes": int(gpu.x0.shape[0]), "steps": gpu.n_steps, "tick_width": gpu.u_per_sub,
        "block_ticks": B, "ticks_compared": ticks, "blocks_compared": n_blocks,
        "launches": nw_cuda.LAUNCHES["sgd_tick"] - before, "max_abs_err": err,
        "unequal_ticks": unequal[:8], "unequal_blocks": unequal_blocks[:8],
        "bit_equal": not unequal and not unequal_blocks, "parity_s": time.perf_counter() - t0,
        "plan": work.plan._asdict(),
    }
    if n_blocks * B >= T:
        before = nw_cuda.LAUNCHES["sgd_tick"]
        _s, x_run = _run_seconds(gpu, params.seed)
        out["layout_run_launches"] = nw_cuda.LAUNCHES["sgd_tick"] - before
        out["layout_run_equal"] = _bits_equal(x_run, xk)
        out["bit_equal"] = out["bit_equal"] and out["layout_run_equal"]
    return out


def profile_block(plan: sgd.SGDPlan, seed: int) -> dict:
    """The run's first block of ticks as ``sgd._sgd_run`` runs it (its draws,
    then one launch of the tick kernel) under torch.profiler, after one
    unprofiled block: the tick kernel's launches, the other launches (the
    draws'), the device time a tick by kernel and the device-busy share of
    the block's wall time."""
    from torch.profiler import ProfilerActivity, profile

    B = plan.block_ticks or plan.n_ticks
    work = sgd.tick_work(plan.x0.shape[0], plan.u_per_sub, plan.tables.space, plan.x0.device, B)
    bufs = (torch.empty_like(plan.x0), torch.empty_like(plan.x0))

    def block():
        gen = torch.Generator(device=plan.x0.device)
        gen.manual_seed(seed)
        draws = sgd.draw_block(gen, B, plan.u_per_sub, plan.n_steps)
        return sgd.sgd_ticks_cuda(plan.x0, 0, plan.n_sub, draws, plan.tables, work, bufs)

    block()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _kernel_summary(prof, B, wall, "sgd_ticks_kernel")


def profile_ticks(plan: sgd.SGDPlan, seed: int, n_ticks: int = 16) -> dict:
    """The plain tick on the card over ``n_ticks`` ticks of the first
    iteration under torch.profiler: launches a tick, the device time a tick
    by kernel and the device-busy share."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=plan.x0.device)
    gen.manual_seed(seed)
    draws = sgd.draw_block(gen, n_ticks, plan.u_per_sub, plan.n_steps)
    x = plan.x0
    for k in range(2):  # warm-up
        x = sgd.sgd_tick(x, 0, *(d[k] for d in draws), plan.tables)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(n_ticks):
            x = sgd.sgd_tick(x, 0, *(d[k] for d in draws), plan.tables)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = _kernel_summary(prof, n_ticks, wall, None)
    out["launches_per_tick"] = out.pop("other_launches") / n_ticks
    return out


def _kernel_summary(prof, n_ticks: int, wall: float, tick_kernel: str | None) -> dict:
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy_s = sum(e.device_time for e in kernels) * 1e-6
    by_kernel: dict[str, float] = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time * 1e-3 / n_ticks
    mine = sum(tick_kernel is not None and tick_kernel in e.name for e in kernels)
    return {
        "profiled_ticks": n_ticks,
        "tick_kernel_launches": mine,
        "other_launches": len(kernels) - mine,
        "distinct_kernels": len(by_kernel),
        "device_busy_share": busy_s / wall,
        "profiled_ms_per_tick": wall / n_ticks * 1e3,
        "device_ms_per_tick": busy_s / n_ticks * 1e3,
        "device_ms_per_tick_by_kernel": by_kernel,
    }


def phase_split(plan: sgd.SGDPlan, seed: int) -> dict:
    """The tick kernel's device time a tick by phase (``sgd.TICK_PHASES``)
    over the run's first block, from its own timer (block 0 reads the global
    timer after each grid barrier), after one untimed block; and the
    block's CUDA-event time a tick beside their sum."""
    B = plan.block_ticks or plan.n_ticks
    work = sgd.tick_work(plan.x0.shape[0], plan.u_per_sub, plan.tables.space, plan.x0.device, B)
    gen = torch.Generator(device=plan.x0.device)
    gen.manual_seed(seed)
    draws = sgd.draw_block(gen, B, plan.u_per_sub, plan.n_steps)
    bufs = (torch.empty_like(plan.x0), torch.empty_like(plan.x0))
    sgd.sgd_ticks_cuda(plan.x0, 0, plan.n_sub, draws, plan.tables, work, bufs)
    work.phase_ns.zero_()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    sgd.sgd_ticks_cuda(plan.x0, 0, plan.n_sub, draws, plan.tables, work, bufs, timed=True)
    stop.record()
    torch.cuda.synchronize()
    ns = work.phase_ns.cpu().tolist()
    out = {name: ns[k] * 1e-6 / B for k, name in enumerate(sgd.TICK_PHASES)}
    out["sum"] = sum(ns) * 1e-6 / B
    out["event_ms_per_tick"] = start.elapsed_time(stop) / B
    out["plan"] = work.plan._asdict()
    return out


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
        profiles = {"kernel": profile_block(plan, params.seed), "plain": profile_ticks(plan, params.seed)}
        for kind, prof in profiles.items():
            prof["device_busy_share_of_run"] = prof["device_ms_per_tick"] / out[f"{kind}_ms_per_tick"]
            out[f"{kind}_profile"] = prof
        out["phase_ms_per_tick"] = phase_split(plan, params.seed)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sgd_timing")
    p.add_argument("input", nargs="?", help="GFA file")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="lay out synth_variation_graph(n_paths=N) instead of a GFA file")
    p.add_argument("--loop", type=int, default=0, metavar="K",
                   help="with --synthetic: each path visits one node K times in a row")
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
    out = time_sgd(graph, ns.reps, ns.profile)
    if ns.parity is not None:
        out["cpu_parity"] = cpu_parity(graph, blocks=ns.parity or None)
    print(json.dumps(out, default=lambda v: v.item() if isinstance(v, np.generic) else str(v)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
