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

  * The tick (``sgd_tick``) is a plain function of the positions and one
    tick's draws, and the loop (``_sgd_run``) makes the draws a block at a
    time from a seeded ``torch.Generator`` on the run's device.  The stream
    is torch's (Philox on a GPU, Mersenne Twister on the CPU), not JAX's
    threefry, so positions differ from the JAX package's for the same seed;
    fed the same draws, the tick computes the same positions.
  * The same seed on the same device gives the same positions bit for bit.
    On a GPU that needs care: ``index_add_`` there sums with float atomics
    in whatever order the threads arrive.  ``_scatter_terms`` sums the
    displacements with ``index_put_(accumulate=True)`` instead, which sorts
    the indices and adds each node's terms in a fixed order.

The reference's reverse-handle position bug class (looking up a step's
position index with the oriented handle instead of the forward handle —
docs/sgd_rc_fix.md, docs/sgd_reverse_handle_bug.md) is structurally
impossible here: ``node_of_step`` strips the orientation bit (``h >> 1``)
when the flat index is built, so every lookup is by node id.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..graph.bigraph import BidirectedGraph
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


def make_tables(
    node_of_step: np.ndarray,
    index: PathIndex,
    etas: np.ndarray,
    first_cooling_iter: int,
    space: int,
    theta: float,
    device: torch.device,
) -> SGDTables:
    """Move the step index and the harmonic tables to ``device``, once."""
    # exact partial harmonic sums H[i] = sum_{1..i} i^-theta (H[0] = 0)
    i_arr = np.arange(1, space + 1, dtype=np.float64)
    Hmain = np.concatenate([[0.0], np.cumsum(i_arr ** (-theta))]).astype(np.float32)
    Hcool = np.concatenate([[0.0], np.cumsum(i_arr ** (-0.001))]).astype(np.float32)

    def dev(a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return SGDTables(
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


def _scatter_terms(
    x: torch.Tensor, i: torch.Tensor, j: torch.Tensor, r_x: torch.Tensor, nvalid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(upd, term_cnt): per node, the sum of -r_x over the terms that name it
    as ``i`` plus r_x over those that name it as ``j``, and how many valid
    terms name it.

    The displacements go through ``index_put_(accumulate=True)``: on a GPU
    it sorts the indices and sums each node's terms in a fixed order, where
    ``index_add_`` would add them with float atomics in the order the
    threads arrive; on the CPU both add in index order.  The counts are sums
    of 0.0 and 1.0, exact in any order, so they take the cheaper call."""
    ij = torch.cat([i, j])
    upd = torch.zeros_like(x).index_put_((ij,), torch.cat([-r_x, r_x]), accumulate=True)
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
    (seqrush_tpu/layout/sgd.py, ``_sgd_run.tick``)."""
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
    comes from ``tick_plan`` alone: one graph and seed, one stream."""
    T = (tables.etas.shape[0] - 1) * n_sub
    B = block_ticks if block_ticks > 0 else T
    gen = torch.Generator(device=x0.device)
    gen.manual_seed(int(seed))
    x = x0
    for lo in range(0, T, B):
        draws = draw_block(gen, min(B, T - lo), u_per_sub, n_steps)
        for k in range(draws[0].shape[0]):
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
