"""Path stochastic gradient descent (PG-SGD) layout (the 'Y' phase of Ygs).

The port of ``seqrush_tpu/layout/sgd.py``: ODGI's path_linear_sgd as ported
by the reference (reference src/path_sgd.rs).  The reference runs N CPU
threads doing one term update at a time against an atomic f64 position
array (Hogwild); here each SGD "tick" takes a whole vector of term pairs,
computes their displacement updates in parallel from one snapshot of the
positions, and applies them with a scatter-add.

Parameter semantics preserved exactly (path_sgd.rs:202-359, 552-573):
  * learning-rate schedule eta(t) = eta_max * exp(-lambda * |t - t_max|),
    lambda = ln(eta_max/eta_min)/(iter_max-1), eta_min = eps;
  * per-iteration term budget min_term_updates = sum of path step counts;
  * "dirty Zipfian" second-step sampling over jump distances, theta = 0.99,
    switching to 0.001 in the cooling phase (after cooling_start*iter_max);
  * 50% uniform-across-path / 50% Zipfian-jump before cooling, always
    Zipfian during cooling;
  * term weight w = 1/term_dist, mu = min(eta*w, 1), displacement
    mu*(|dx|-d)/2 applied symmetrically.

The Zipfian is sampled exactly by inverse CDF over precomputed partial
harmonic sums (the reference quantizes the normalizer for large spaces;
we keep the exact table).

Two things differ from the JAX module, by design:

  * The tick is a function of the positions and one tick's draws, and the
    loop (``_sgd_run``) makes the draws a block at a time from a seeded
    ``torch.Generator`` on the run's device.  The stream is torch's (Philox
    on a GPU, Mersenne Twister on the CPU), not JAX's threefry, so positions
    differ from the JAX package's for the same seed; fed the same draws, the
    tick computes the same positions bit for bit.
  * On a GPU each block of ticks is one launch of a hand-written kernel
    (``sgd_ticks_cuda``, ``ops/csrc/sgd_tick.cu``, a cooperative launch
    with a stable counting sort of each tick's terms by node); on the CPU
    the plain version (``sgd_tick``) runs.  Both sum each node's terms
    in one fixed order, that of the JAX tick's ``.at[i].add(-r_x)
    .at[j].add(r_x)``: a left fold from 0.0 over the terms that name the node
    first, in term order, then over those that name it second.  So the
    kernel's positions equal the plain version's run on the CPU bit for bit,
    and the same seed on the same device gives the same positions.  On the
    CPU ``_scatter_terms`` adds with ``index_add_``, a serial loop in index
    order at every size; ``index_put_(accumulate=True)`` adds with parallel
    float atomics there from 32,768 entries on.  The plain version run on a
    GPU sums with ``index_put_(accumulate=True)``, which sorts the indices
    first and is reproducible, but not in that order.

The reference's reverse-handle position bug class (looking up a step's
position index with the oriented handle instead of the forward handle —
docs/sgd_rc_fix.md, docs/sgd_reverse_handle_bug.md) is structurally
impossible here: ``node_of_step`` strips the orientation bit (``h >> 1``)
when the flat index is built, so every lookup is by node id.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..graph.bigraph import BidirectedGraph
from ..ops import nw_cuda
from ..utils import resolve_device


@dataclass
class PathSGDParams:
    iter_max: int = 100
    iter_with_max_learning_rate: int = 0
    min_term_updates: int = 0  # derived from graph when 0
    delta: float = 0.0
    eps: float = 0.01
    eta_max: float = 0.0  # derived: (max path step count)^2
    theta: float = 0.99
    space: int = 0  # derived: max path length (bp)
    space_max: int = 100
    space_quantization_step: int = 100
    cooling_start: float = 0.5
    nthreads: int = 1  # accepted for parity; device parallelism is implicit
    progress: bool = False
    seed: int = 9399220  # reference worker seed base (path_sgd.rs:381)
    n_sub: int = 8  # sequential sub-batches per iteration (mixing granularity)
    # initial positions: 'path' = each node starts at its mean bp position
    # over all path steps (an embedding-consistent init that avoids the
    # id-order local minima the reference documents — SGD "initializes
    # nodes by ID order (not path order)" is the named root cause of its
    # A-3105 catastrophic edges, the povu sorting note in the reference docs);
    # 'id' = reference-faithful cumulative length in node-id order
    # (path_sgd.rs:229-249)
    init: str = "path"
    # round the tick width up to the JAX package's shape ladder, so that
    # both packages run ticks of the same width on the same graph (the
    # width decides the result).  The arrays themselves are not padded
    # here: padded entries are never read.
    bucket: bool = True


@dataclass
class PathIndex:
    """Flat step arrays (reference PathIndex, path_sgd.rs:15-117)."""

    step_handle: np.ndarray  # int64 [S]
    step_pos: np.ndarray  # int64 [S] bp position within path
    step_path: np.ndarray  # int32 [S]
    step_rank: np.ndarray  # int32 [S]
    path_first: np.ndarray  # int32 [P]
    path_count: np.ndarray  # int32 [P]
    path_len: np.ndarray  # int64 [P]

    @staticmethod
    def from_graph(graph: BidirectedGraph) -> "PathIndex":
        # vectorized build: a per-step Python loop dominates at millions of
        # steps, and this runs twice per ygs_sort
        ids = np.fromiter(graph.nodes.keys(), dtype=np.int64, count=len(graph.nodes))
        order = np.argsort(ids, kind="stable")
        ids_sorted = ids[order]
        lens = np.fromiter(
            (len(s) for s in graph.nodes.values()), dtype=np.int64, count=ids.size
        )[order]
        P = len(graph.paths)
        counts = np.array([p.steps.size for p in graph.paths], dtype=np.int32)
        firsts = np.zeros(P, dtype=np.int32)
        if P:
            firsts[1:] = np.cumsum(counts[:-1])
        handles = (
            np.concatenate([np.asarray(p.steps, dtype=np.int64) for p in graph.paths])
            if P and counts.sum()
            else np.zeros(0, np.int64)
        )
        step_len = lens[np.searchsorted(ids_sorted, handles >> 1)]
        # per-path exclusive cumsum of step lengths = bp position
        cum = np.concatenate([[0], np.cumsum(step_len)])
        poss = cum[:-1] - np.repeat(cum[firsts], counts)
        plens = (
            cum[firsts + counts] - cum[firsts]
            if P
            else np.zeros(0, np.int64)
        )
        pids = np.repeat(np.arange(P, dtype=np.int32), counts)
        ranks = (
            np.arange(handles.size, dtype=np.int32)
            - np.repeat(firsts, counts)
        )
        return PathIndex(
            handles,
            poss.astype(np.int64),
            pids,
            ranks,
            firsts,
            counts,
            plens.astype(np.int64),
        )

    @property
    def total_steps(self) -> int:
        return self.step_handle.size


def sgd_schedule(w_min, w_max, iter_max, iter_with_max_lr, eps) -> np.ndarray:
    """Exact port of path_linear_sgd_schedule (path_sgd.rs:552-573)."""
    eta_max = 1.0 / w_min
    eta_min = eps / w_max
    lam = np.log(eta_max / eta_min) / (iter_max - 1.0)
    t = np.arange(iter_max + 1, dtype=np.float64)
    return eta_max * np.exp(-lam * np.abs(t - iter_with_max_lr))


class KernelTables(NamedTuple):
    """The tick kernel's copies of a run's tables (``ops/csrc/sgd_tick.cu``),
    made by ``kernel_tables``: one record a step (a single 16-byte read), one
    a path, and the learning rates on the device."""

    step_rec: torch.Tensor  # int32 [S, 4]: node_of_step, step_path, step_rank, step_pos's float32 bits
    path_rec: torch.Tensor  # int32 [P, 2]: path_first, path_count
    etas: torch.Tensor  # float32 [iter_max + 1]


class SGDTables(NamedTuple):
    """What a tick reads besides the positions and its draws.  The tensors
    live on the run's device; integer tables are int64 (torch's index type)."""

    node_of_step: torch.Tensor  # int64 [S] index of the step's node in sorted-id order
    step_pos: torch.Tensor  # float32 [S] bp position within the path
    step_path: torch.Tensor  # int64 [S]
    step_rank: torch.Tensor  # int64 [S]
    path_first: torch.Tensor  # int64 [P]
    path_count: torch.Tensor  # int64 [P]
    Hmain: torch.Tensor  # float32 [space + 1] partial harmonic sums, theta
    Hcool: torch.Tensor  # float32 [space + 1] the same for the cooling theta
    etas: np.ndarray  # float32 [iter_max + 1], on the host
    first_cooling_iter: int
    space: int
    kernel: KernelTables | None = None  # on a GPU, the tick kernel's tables; None on the CPU


def kernel_tables(t: SGDTables) -> KernelTables:
    """The tick kernel's tables from the plain ones, on their device.  The
    kernel indexes steps and paths with int32: more steps raise."""
    if t.node_of_step.numel() >= 1 << 31:
        raise ValueError(f"{t.node_of_step.numel()} path steps: the tick kernel indexes them with int32")
    step_rec = torch.stack([t.node_of_step.int(), t.step_path.int(), t.step_rank.int(),
                            t.step_pos.view(torch.int32)], dim=1)
    path_rec = torch.stack([t.path_first.int(), t.path_count.int()], dim=1)
    etas = torch.as_tensor(t.etas, device=t.node_of_step.device)
    return KernelTables(step_rec.contiguous(), path_rec.contiguous(), etas)


def make_tables(
    node_of_step: np.ndarray,
    index: PathIndex,
    etas: np.ndarray,
    first_cooling_iter: int,
    space: int,
    theta: float,
    device: torch.device,
) -> SGDTables:
    """Move the step index and the harmonic tables to ``device``, once; on a
    GPU also the tick kernel's (``kernel_tables``)."""
    # exact partial harmonic sums H[i] = sum_{1..i} i^-theta (H[0] = 0)
    i_arr = np.arange(1, space + 1, dtype=np.float64)
    Hmain = np.concatenate([[0.0], np.cumsum(i_arr ** (-theta))]).astype(np.float32)
    Hcool = np.concatenate([[0.0], np.cumsum(i_arr ** (-0.001))]).astype(np.float32)

    def dev(a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    tables = SGDTables(
        dev(node_of_step, torch.int64),
        dev(index.step_pos, torch.float32),
        dev(index.step_path, torch.int64),
        dev(index.step_rank, torch.int64),
        dev(index.path_first, torch.int64),
        dev(index.path_count, torch.int64),
        dev(Hmain, torch.float32),
        dev(Hcool, torch.float32),
        np.asarray(etas, dtype=np.float32),
        int(first_cooling_iter),
        int(space),
    )
    return tables._replace(kernel=kernel_tables(tables)) if device.type == "cuda" else tables


def _scatter_terms(
    x: torch.Tensor, i: torch.Tensor, j: torch.Tensor, r_x: torch.Tensor, nvalid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(upd, term_cnt): per node, the sum of -r_x over the terms that name it
    as ``i`` plus r_x over those that name it as ``j``, and how many valid
    terms name it.

    On the CPU the displacements go through ``index_add_``, which adds them
    one by one in the order of ``cat([i, j])`` at every size (the order the
    tick kernel keeps); ``index_put_(accumulate=True)`` would add them with
    parallel float atomics from 32,768 entries on.  On a GPU ``index_add_``
    adds with float atomics in the order the threads arrive, so the
    displacements go through ``index_put_(accumulate=True)``, which sorts
    the indices and sums each node's terms in a fixed order.  The counts are
    sums of 0.0 and 1.0, exact in any order."""
    ij = torch.cat([i, j])
    terms = torch.cat([-r_x, r_x])
    if x.device.type == "cpu":
        upd = torch.zeros_like(x).index_add_(0, ij, terms)
    else:
        upd = torch.zeros_like(x).index_put_((ij,), terms, accumulate=True)
    term_cnt = torch.zeros_like(x).index_add_(0, ij, torch.cat([nvalid, nvalid]))
    return upd, term_cnt


def sgd_tick(
    x: torch.Tensor,
    it: int,
    step_idx: torch.Tensor,
    coin_zipf: torch.Tensor,
    coin_back: torch.Tensor,
    u01: torch.Tensor,
    u02: torch.Tensor,
    tables: SGDTables,
) -> torch.Tensor:
    """One tick: ``u`` term pairs drawn by (step_idx, coin_zipf, coin_back,
    u01, u02), each [u], moved against the snapshot ``x``; returns the new
    positions.  float32 arithmetic in the order of the JAX tick
    (seqrush_tpu/layout/sgd.py, ``_sgd_run.tick``).  The plain version of
    the tick kernel (``sgd_tick_cuda``); it runs on any device."""
    t = tables
    eta = float(t.etas[min(it, t.etas.shape[0] - 1)])
    cooling = it >= t.first_cooling_iter
    H = t.Hcool if cooling else t.Hmain

    pid = t.step_path[step_idx]
    cnt = t.path_count[pid]
    rank_a = t.step_rank[step_idx]

    go_back = (rank_a > 0) & (coin_back | (rank_a == cnt - 1))
    space_back = torch.clamp(rank_a, max=t.space)
    space_fwd = torch.clamp(cnt - rank_a - 1, max=t.space)
    jump_space = torch.where(go_back, space_back, space_fwd).clamp_(min=1)
    # inverse-CDF Zipfian over 1..jump_space (exact partial sums)
    z = torch.searchsorted(H, u01 * H[jump_space], side="left")
    z = torch.minimum(z.clamp_(min=1), jump_space)
    rank_b = torch.where(
        go_back,
        (rank_a - z).clamp_(min=0),
        torch.minimum(rank_a + z, cnt - 1),
    )
    if not cooling:
        rank_b_unif = torch.minimum(
            (u02 * cnt.to(torch.float32)).to(torch.int64), (cnt - 1).clamp_(min=0)
        )
        rank_b = torch.where(coin_zipf, rank_b, rank_b_unif)

    sb = t.path_first[pid] + rank_b
    valid = (cnt > 1) & (rank_a != rank_b)

    term_dist = (t.step_pos[step_idx] - t.step_pos[sb]).abs_()
    # validity is taken before the clamp: a zero distance is no term
    valid &= term_dist > 0
    term_dist = term_dist.clamp_(min=1e-9)

    w = 1.0 / term_dist
    mu = (eta * w).clamp_(max=1.0)

    i = t.node_of_step[step_idx]
    j = t.node_of_step[sb]
    dx = x[i] - x[j]
    dx = torch.where(dx == 0.0, 1e-9, dx)
    mag = dx.abs()
    delta_update = mu * (mag - term_dist) / 2.0
    r_x = (delta_update / mag) * dx
    r_x = torch.where(valid, r_x, 0.0)

    # Per-node MEAN of this tick's term updates, not the raw sum: all
    # terms in a tick read the same position snapshot, so a node drawn
    # k times would compound k half-discrepancy moves and the iteration
    # diverges (positions -> inf -> NaN) once the tick width approaches the
    # node count.  The reference's Hogwild applies terms one at a time
    # against fresh positions (path_sgd.rs:475-511) and cannot compound; the
    # mean is the batch-synchronous estimator with the same fixed points and
    # a per-tick step bounded by the largest single-term move.
    upd, term_cnt = _scatter_terms(x, i, j, r_x, valid.to(x.dtype))
    return x + upd / term_cnt.clamp_(min=1.0)


def draw_block(
    gen: torch.Generator, n_ticks: int, width: int, n_steps: int
) -> tuple[torch.Tensor, ...]:
    """The draws of ``n_ticks`` ticks, each [n_ticks, width], on the
    generator's device: (step_idx, coin_zipf, coin_back, u01, u02)."""
    shape = (n_ticks, width)
    dev = gen.device
    step_idx = torch.randint(0, n_steps, shape, generator=gen, device=dev)
    coin_zipf = torch.randint(0, 2, shape, generator=gen, device=dev, dtype=torch.uint8) == 1
    coin_back = torch.randint(0, 2, shape, generator=gen, device=dev, dtype=torch.uint8) == 1
    u01 = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
    u02 = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
    return step_idx, coin_zipf, coin_back, u01, u02


# The tick kernel's launch (ops/csrc/sgd_tick.cu): threads a block; the
# count matrix's budget (bins x chunks int32, kept well inside the H100's 50
# MB L2 with the offsets beside it); the most bins one pass of the counting
# sort takes (two histograms of them in a block's shared memory, 48 KB); the
# most shared memory H may take when it is staged; the fold's staging
# buffers (two of 256 floats a warp).
TICK_THREADS = 256
COUNT_BUDGET_BYTES = 8 << 20
MAX_BINS = 6144
H_SMEM_BYTES = 64 << 10
FOLD_SMEM_BYTES = TICK_THREADS // 32 * 2 * 256 * 4
# the most shared memory the positions may take when a block stages them
# for its terms' reads (only where a block has more terms than threads: with
# one term a thread the staging's round trip costs more than the gathers)
X_SMEM_BYTES = 32 << 10
# the kernel's phases, in the order of its timer's slots: the terms (and the
# first pass's count), the count of each later digit pass, the scans, the
# places, the folds
TICK_PHASES = ("terms", "count", "scan", "place", "fold")


class TicksPlan(NamedTuple):
    """How the tick kernel runs a graph's ticks (``ticks_plan``)."""

    block_ticks: int  # ticks a launch in the run (tick_plan's block_ticks)
    chunk: int  # C: terms of a term chunk, entries of an entry chunk
    chunks: int  # entry chunks of a tick, 2 * ceil(width / C): a side's last may be part padding
    bins: int  # bins of the first pass of the counting sort (the most of any pass)
    digit_bits: int  # 0: one pass by node id; else the bits of a digit
    passes: int  # passes of the counting sort
    count_bytes: int  # the count matrix, bins x chunks int32
    stage_h: bool  # H in shared memory for the Zipf search
    stage_x: bool  # the positions in shared memory for the terms' reads
    smem_bytes: int  # dynamic shared memory a block
    blocks_per_sm: int  # the occupancy figure (0 when not known)
    grid: int  # blocks_per_sm x SMs: every block the card holds at once


def ticks_plan(
    n_nodes: int,
    width: int,
    space: int,
    block_ticks: int,
    blocks_per_sm: int = 0,
    sms: int = 0,
) -> TicksPlan:
    """The tick kernel's launch for N nodes, ``width`` terms a tick and H of
    ``space + 1`` floats: one pass by node id where the nodes fit
    ``MAX_BINS``, else passes by digits of the node id (the most bits whose
    bins fit); the smallest chunk (256 terms, doubled while it is narrower
    than the width) whose count matrix fits ``COUNT_BUDGET_BYTES``, each
    side's last chunk padded where the chunk does not divide the width; H
    staged where it fits its share of shared memory, the positions where
    they fit theirs and a chunk has more terms than a block has threads; the
    grid from the card's occupancy figure.  The module's budgets are read at
    each call."""
    if n_nodes < 1 or width < 1 or space < 1:
        raise ValueError(f"no ticks to plan for {n_nodes} nodes, width {width}, space {space}")
    if n_nodes <= MAX_BINS:
        digit_bits, passes, bins = 0, 1, n_nodes
    else:
        digit_bits = MAX_BINS.bit_length() - 1
        passes = -(-(n_nodes - 1).bit_length() // digit_bits)
        bins = 1 << digit_bits
    chunk = min(width, TICK_THREADS)
    while chunk < width and 2 * -(-width // chunk) * bins * 4 > COUNT_BUDGET_BYTES:
        chunk *= 2
    chunks = 2 * -(-width // chunk)
    h_bytes, x_bytes = (space + 1) * 4, n_nodes * 4
    stage_h, stage_x = h_bytes <= H_SMEM_BYTES, chunk > TICK_THREADS and x_bytes <= X_SMEM_BYTES
    smem = FOLD_SMEM_BYTES + 2 * bins * 4 + (h_bytes if stage_h else 0) + (x_bytes if stage_x else 0)
    return TicksPlan(
        block_ticks, chunk, chunks, bins, digit_bits, passes, chunks * bins * 4, stage_h, stage_x, smem,
        blocks_per_sm, blocks_per_sm * sms,
    )


class TickWork(NamedTuple):
    """The tick kernel's plan and scratch for N nodes and w terms (int32
    unless said)."""

    plan: TicksPlan
    ti: torch.Tensor  # [w] each term's first node, -1 where the term is not valid
    tj: torch.Tensor  # [w] each term's second node
    tr: torch.Tensor  # float32 [w] each term's displacement
    counts: torch.Tensor  # [bins * chunks] the count matrix; 0 between launches, the kernel leaves it so
    offs: torch.Tensor  # [bins * chunks] each (bin, chunk)'s first slot among the bin's entries
    totals: torch.Tensor  # [bins] each bin's entries
    node_off: torch.Tensor  # [N] each node's first slot (one pass)
    node_cnt: torch.Tensor  # [N] each node's valid terms (one pass)
    keys: torch.Tensor  # [2, 2w] node ids in each digit pass's order ([0] with one pass)
    vals: torch.Tensor  # float32 [passes > 1 ? 2 : 1, 2w] displacements in each pass's order
    phase_ns: torch.Tensor  # int64 [len(TICK_PHASES)] the phases' nanoseconds, when timed


def tick_work(n_nodes: int, width: int, space: int, device: torch.device, block_ticks: int = 1) -> TickWork:
    """``ticks_plan`` with the card's occupancy figure for its shared memory,
    and its scratch on ``device``.  Raises where the card cannot run the
    kernel as one cooperative launch."""
    lib = nw_cuda._library()
    plan = ticks_plan(n_nodes, width, space, block_ticks)
    blocks, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.sgd_ticks_occupancy(plan.smem_bytes, ctypes.byref(blocks), ctypes.byref(sms))
    if err != 0:
        raise RuntimeError(f"sgd_ticks_occupancy failed with CUDA error {err}")
    if blocks.value < 1:
        raise RuntimeError(f"no block of the tick kernel fits an SM with {plan.smem_bytes} B of shared memory")
    plan = plan._replace(blocks_per_sm=blocks.value, grid=blocks.value * sms.value)
    i32, f32 = torch.int32, torch.float32
    entries = 2 * width

    def empty(n, dtype=i32):
        return torch.empty(n, dtype=dtype, device=device)

    multi = plan.passes > 1
    return TickWork(
        plan, empty(width), empty(width), empty(width, f32),
        torch.zeros(plan.bins * plan.chunks, dtype=i32, device=device), empty(plan.bins * plan.chunks),
        empty(plan.bins), empty(n_nodes), empty(n_nodes),
        empty((2 if multi else 0, entries)), empty((2 if multi else 1, entries), f32),
        torch.zeros(len(TICK_PHASES), dtype=torch.int64, device=device),
    )


class _TicksArgs(ctypes.Structure):
    """ops/csrc/sgd_tick.cu's ``Ticks``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x_in", "out0", "out1", "step_idx", "coin_zipf", "coin_back", "u01", "u02", "step_rec", "path_rec",
        "Hmain", "Hcool", "etas", "ti", "tj", "tr", "counts", "offs", "totals", "node_off", "node_cnt",
        "keys0", "keys1", "vals0", "vals1", "phase_ns")]
    _fields_ += [("space", ctypes.c_longlong), ("lo", ctypes.c_longlong)]
    _fields_ += [(name, ctypes.c_int) for name in (
        "n_etas", "first_cooling", "n_sub", "n_ticks", "w", "N", "chunk", "chunks", "bins", "digit_bits",
        "passes", "stage_h", "stage_x")]


def _launch_ticks(lib, stream: int, x, outs, lo: int, n_sub: int, draws, tables: SGDTables,
                  work: TickWork, timed: bool = False) -> torch.Tensor:
    """Ticks lo .. lo + B - 1 (B = the draws' rows) in one launch; returns
    the buffer of outs that the last tick wrote."""
    t, k, p = tables, tables.kernel, work.plan
    n_ticks, width = draws[0].shape
    multi = p.passes > 1
    ptr = lambda a: a.data_ptr()  # noqa: E731
    args = _TicksArgs(
        ptr(x), ptr(outs[0]), ptr(outs[1]), *map(ptr, draws), ptr(k.step_rec), ptr(k.path_rec), ptr(t.Hmain),
        ptr(t.Hcool), ptr(k.etas), ptr(work.ti), ptr(work.tj), ptr(work.tr), ptr(work.counts),
        ptr(work.offs), ptr(work.totals), ptr(work.node_off), ptr(work.node_cnt),
        ptr(work.keys[0]) if multi else None, ptr(work.keys[1]) if multi else None,
        ptr(work.vals[0]), ptr(work.vals[1]) if multi else None, ptr(work.phase_ns) if timed else None,
        t.space, lo, k.etas.shape[0], t.first_cooling_iter, n_sub, n_ticks, width, x.shape[0],
        p.chunk, p.chunks, p.bins, p.digit_bits, p.passes, int(p.stage_h), int(p.stage_x),
    )
    with torch.cuda.device(x.device):
        err = lib.sgd_ticks_launch(ctypes.byref(args), p.grid, p.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"sgd_ticks launch failed with CUDA error {err}")
    nw_cuda.LAUNCHES["sgd_tick"] += 1
    return outs[(n_ticks - 1) & 1]


def sgd_ticks_cuda(
    x: torch.Tensor,
    lo: int,
    n_sub: int,
    draws: tuple[torch.Tensor, ...],
    tables: SGDTables,
    work: TickWork | None = None,
    outs: tuple[torch.Tensor, torch.Tensor] | None = None,
    timed: bool = False,
) -> torch.Tensor:
    """Ticks lo .. lo + B - 1 of a run of ``n_sub`` ticks an iteration on a
    GPU, in one launch of ``ops/csrc/sgd_tick.cu``: the draws are
    ``draw_block``'s (step_idx, coin_zipf, coin_back, u01, u02), each [B, w];
    tick lo + b writes ``outs[b % 2]`` (two buffers of x's shape, made when
    None; x may be outs[1], never outs[0]).  Returns the last tick's buffer,
    whose positions equal those of B ticks of ``sgd_tick`` run on the CPU
    on the same inputs bit for bit.  ``work`` is ``tick_work``'s plan and
    scratch, made when None.  With ``timed`` the kernel adds each phase's
    nanoseconds to ``work.phase_ns``."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"sgd_ticks_cuda runs on a GPU, got {device}: the CPU runs sgd_tick")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 1-D float32 tensor on {device}")
    shape = draws[0].shape
    for name, a, dtype in zip(("step_idx", "coin_zipf", "coin_back", "u01", "u02"), draws,
                              (torch.int64, torch.bool, torch.bool, torch.float32, torch.float32)):
        if a.dtype != dtype or a.dim() != 2 or a.device != device or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D {dtype} tensor on {device}")
        if a.shape != shape:
            raise ValueError(f"the draws must have one shape, got {tuple(a.shape)} and {tuple(shape)}")
    if len(draws) != 5 or shape[0] < 1:
        raise ValueError("give the five draws of at least one tick")
    if tables.kernel is None or tables.kernel.step_rec.device != device:
        where = "the CPU" if tables.kernel is None else tables.kernel.step_rec.device
        raise ValueError(f"the tick kernel's tables are on {where}, expected {device}")
    if outs is None:
        outs = (torch.empty_like(x), torch.empty_like(x))
    if any(o.shape != x.shape or o.dtype != x.dtype or o.device != device for o in outs):
        raise ValueError("outs must be two buffers of x's shape")
    if outs[0] is x or outs[0].data_ptr() == x.data_ptr():
        raise ValueError("outs[0] must be another buffer than x")
    if shape[0] > 1 and outs[0].data_ptr() == outs[1].data_ptr():
        raise ValueError("outs must be two buffers")
    w = shape[1]
    if work is None:
        work = tick_work(x.shape[0], w, tables.space, device, shape[0])
    if work.ti.shape[0] != w or work.node_off.shape[0] != x.shape[0] or work.ti.device != device:
        raise ValueError(f"work is for {work.ti.shape[0]} terms and {work.node_off.shape[0]} nodes on "
                         f"{work.ti.device}, not {w} and {x.shape[0]} on {device}")
    stream = torch.cuda.current_stream(device).cuda_stream
    return _launch_ticks(nw_cuda._library(), stream, x, outs, lo, n_sub, draws, tables, work, timed)


def sgd_tick_cuda(
    x: torch.Tensor,
    it: int,
    step_idx: torch.Tensor,
    coin_zipf: torch.Tensor,
    coin_back: torch.Tensor,
    u01: torch.Tensor,
    u02: torch.Tensor,
    tables: SGDTables,
    work: TickWork | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``sgd_tick`` on a GPU: ``sgd_ticks_cuda``'s launch with one tick (of
    iteration ``it``) into ``out`` (made when None; never ``x``), whose
    positions equal those of ``sgd_tick`` run on the CPU on the same inputs
    bit for bit."""
    if out is None:
        out = torch.empty_like(x)
    draws = tuple(d.unsqueeze(0) for d in (step_idx, coin_zipf, coin_back, u01, u02))
    return sgd_ticks_cuda(x, it, 1, draws, tables, work, (out, out))


def tick_blocks(n_ticks: int, block_ticks: int) -> list[tuple[int, int]]:
    """(first tick, ticks) of each block of draws of a run of ``n_ticks``,
    ``block_ticks`` at a time (all at once when 0): on a GPU each block is
    one launch of the tick kernel."""
    B = block_ticks if block_ticks > 0 else n_ticks
    return [(lo, min(B, n_ticks - lo)) for lo in range(0, n_ticks, B)]


def _sgd_run(
    x0: torch.Tensor,
    tables: SGDTables,
    seed: int,
    n_steps: int,
    n_sub: int,
    u_per_sub: int,
    block_ticks: int = 0,
) -> torch.Tensor:
    """All ``(len(etas) - 1) * n_sub`` ticks from ``x0``.  The draws are made
    ``block_ticks`` ticks at a time from one generator, to bound their
    memory.  The block size is part of how the stream is laid out, so it
    comes from ``tick_plan`` alone: one graph and seed, one stream.  On a
    GPU each block of ticks is one launch of the tick kernel
    (``_launch_ticks``); on the CPU every tick is the plain ``sgd_tick``."""
    blocks = tick_blocks((tables.etas.shape[0] - 1) * n_sub, block_ticks)
    gen = torch.Generator(device=x0.device)
    gen.manual_seed(int(seed))
    cuda = x0.device.type == "cuda"
    if cuda:
        lib = nw_cuda._library()
        B = max((n for _lo, n in blocks), default=1)
        work = tick_work(x0.shape[0], u_per_sub, tables.space, x0.device, B)
        bufs = (torch.empty_like(x0), torch.empty_like(x0))
        stream = torch.cuda.current_stream(x0.device).cuda_stream
    x = x0
    for lo, n in blocks:
        draws = draw_block(gen, n, u_per_sub, n_steps)
        if cuda:
            outs = bufs if x is not bufs[0] else bufs[::-1]
            x = _launch_ticks(lib, stream, x, outs, lo, n_sub, draws, tables, work)
            continue
        for k in range(n):
            x = sgd_tick(x, (lo + k) // n_sub, *(d[k] for d in draws), tables)
    return x


def tick_plan(n_steps: int, min_term_updates: int, params: PathSGDParams) -> tuple[int, int, int]:
    """(n_sub, u_per_sub, block_ticks): ticks per iteration, terms per tick,
    and ticks per block of draws."""
    n_sub = max(1, params.n_sub)
    u_per_sub = max(1, -(-min_term_updates // n_sub))
    # quantize the tick width up to a small ladder: min_term_updates is a
    # MINIMUM term budget in the reference (the checker thread advances the
    # iteration once at least that many updates ran, path_sgd.rs:311-359),
    # so rounding up only adds updates.  With ``bucket`` the floor is the
    # JAX package's step-array bucket over n_sub.
    u_per_sub = 1 << max(0, (u_per_sub - 1).bit_length())
    if params.bucket:
        u_per_sub = max(u_per_sub, _tier(n_steps, 1024, 16384) // n_sub)

    # block size: the largest divisor of the tick count whose draws stay
    # under ~4 M lanes (14 B a lane)
    T_ticks = params.iter_max * n_sub
    cap_lanes = 4 << 20
    block = T_ticks
    while block > 1 and block * u_per_sub > cap_lanes:
        block = max(d for d in range(1, block) if T_ticks % d == 0)
    return n_sub, int(u_per_sub), int(block)


class SGDPlan(NamedTuple):
    """One graph's SGD run, ready to start: what ``path_linear_sgd`` runs."""

    node_ids: np.ndarray  # int64 [N] sorted; x[k] is the position of node_ids[k]
    x0: torch.Tensor  # float32 [N] on the device
    tables: SGDTables
    n_steps: int
    n_sub: int
    u_per_sub: int
    block_ticks: int

    @property
    def n_ticks(self) -> int:
        return (self.tables.etas.shape[0] - 1) * self.n_sub


def sgd_setup(
    graph: BidirectedGraph, params: PathSGDParams, device: str | torch.device = "cuda"
) -> SGDPlan | None:
    """Index ``graph``, derive the schedule and the tick shape, and move the
    tables to ``device``; None when no path has two steps."""
    device = resolve_device(device)
    if not graph.nodes:
        return None
    index = PathIndex.from_graph(graph)
    if not (index.path_count > 1).any():
        return None

    node_ids = np.array(sorted(graph.nodes), dtype=np.int64)
    node_of_step = np.searchsorted(node_ids, index.step_handle >> 1)
    if params.init == "path":
        # mean bp position of the node over every step that visits it
        sums = np.zeros(len(node_ids), dtype=np.float64)
        cnts = np.zeros(len(node_ids), dtype=np.float64)
        np.add.at(sums, node_of_step, index.step_pos.astype(np.float64))
        np.add.at(cnts, node_of_step, 1.0)
        x0 = (sums / np.maximum(cnts, 1.0)).astype(np.float32)
    else:
        # cumulative length in node-id order (path_sgd.rs:229-249)
        lens = np.array([len(graph.nodes[int(nid)]) for nid in node_ids], dtype=np.float64)
        x0 = np.concatenate([[0.0], np.cumsum(lens)[:-1]]).astype(np.float32)

    mtu = params.min_term_updates or int(index.path_count.sum())
    eta_max = params.eta_max or float(int(index.path_count.max()) ** 2)
    space = max(params.space or int(index.path_len.max()), 1)

    etas = sgd_schedule(
        1.0 / eta_max, 1.0, params.iter_max, params.iter_with_max_learning_rate, params.eps
    )
    first_cooling = int(np.floor(params.cooling_start * params.iter_max))
    tables = make_tables(node_of_step, index, etas, first_cooling, space, params.theta, device)
    return SGDPlan(
        node_ids,
        torch.from_numpy(x0).to(device),
        tables,
        index.total_steps,
        *tick_plan(index.total_steps, mtu, params),
    )


def path_linear_sgd(
    graph: BidirectedGraph, params: PathSGDParams, device: str | torch.device = "cuda"
) -> dict[int, float]:
    """Run PG-SGD on ``device``; returns node id -> 1D layout position."""
    plan = sgd_setup(graph, params, device)
    if plan is None:
        return {}
    x = _sgd_run(
        plan.x0, plan.tables, params.seed, plan.n_steps,
        plan.n_sub, plan.u_per_sub, plan.block_ticks,
    )
    x = x.cpu().numpy()
    return {int(nid): float(x[k]) for k, nid in enumerate(plan.node_ids)}


def _bucket_pow2(n: int, minimum: int = 16) -> int:
    """Next power of two >= n (floor `minimum`) — the shape ladder."""
    return max(minimum, 1 << max(0, int(n) - 1).bit_length())


def _tier(n: int, small: int, big: int) -> int:
    """Two-tier shape ladder: sizes <= `small` share the small bucket,
    sizes <= `big` share the big bucket, larger sizes go pow2."""
    p = _bucket_pow2(n, small)
    return p if p <= small else max(p, big)


def refine_positions(
    graph: BidirectedGraph,
    positions: dict[int, float],
    rounds: int = 4,
) -> dict[int, float]:
    """Median path-context repair of SGD outliers.

    The SGD's documented failure mode is a heavy tail: a handful of nodes
    trapped far from every path context (the reference's A-3105
    "catastrophic edges", the povu sorting note in the reference docs — p50
    error ~1 bp but p99.9 jumps of kilobases dominate RMSE).  Each round recomputes, for
    every node, the median over its path occurrences of the midpoint of its
    step neighbors' positions, and moves the node there when its current
    position deviates by more than 3x its length + 50 bp — well-placed
    nodes never move, so the SGD layout is preserved except at the
    catastrophic tail."""
    if not positions:
        return positions
    node_ids = np.array(sorted(graph.nodes), dtype=np.int64)
    x = np.array([positions[int(n)] for n in node_ids], dtype=np.float64)
    lens = np.array([len(graph.nodes[int(n)]) for n in node_ids], dtype=np.float64)
    prevs, mids, nexts = [], [], []
    for p in graph.paths:
        ns = (np.asarray(p.steps) >> 1).astype(np.int64)
        if ns.size < 3:
            continue
        ix = np.searchsorted(node_ids, ns)
        prevs.append(ix[:-2])
        mids.append(ix[1:-1])
        nexts.append(ix[2:])
    if not mids:
        return positions
    prevs = np.concatenate(prevs)
    mids = np.concatenate(mids)
    nexts = np.concatenate(nexts)
    order = np.argsort(mids, kind="stable")
    m_s = mids[order]
    starts = np.searchsorted(m_s, np.arange(len(node_ids)))
    ends = np.searchsorted(m_s, np.arange(len(node_ids)) + 1)
    glens = ends - starts
    has = glens > 0
    # median index pair per group (np.median = mean of the two central
    # elements for even lengths); one grouped lexsort per round replaces a
    # per-node python median loop
    lo = starts + (np.maximum(glens, 1) - 1) // 2
    hi = starts + np.maximum(glens, 1) // 2
    thresh = 3.0 * lens + 50.0
    for _ in range(max(rounds, 0)):
        implied = (x[prevs] + x[nexts]) / 2.0
        vals = implied[order]
        vals_sorted = vals[np.lexsort((vals, m_s))]
        med = (vals_sorted[np.minimum(lo, vals.size - 1)]
               + vals_sorted[np.minimum(hi, vals.size - 1)]) / 2.0
        move = has & (np.abs(x - med) > thresh)
        if not move.any():
            break
        x = np.where(move, med, x)
    return {int(n): float(x[k]) for k, n in enumerate(node_ids)}


def path_sgd_sort(
    graph: BidirectedGraph,
    params: PathSGDParams,
    refine_rounds: int = 0,
    device: str | torch.device = "cuda",
) -> list[int]:
    """Handles (forward) ordered by final SGD position (path_sgd.rs:576-600);
    with refine_rounds > 0, catastrophic outliers are median-repaired first
    (refine_positions)."""
    positions = path_linear_sgd(graph, params, device)
    if not positions:
        return [nid << 1 for nid in sorted(graph.nodes)]
    if refine_rounds:
        positions = refine_positions(graph, positions, refine_rounds)
    order = sorted(positions.items(), key=lambda kv: (kv[1], kv[0]))
    return [nid << 1 for nid, _ in order]
