"""The port's kernel launch planning, checked on the CPU.

* ``plan_sweep`` (ops/nw_cuda.py) for every batch size and band the runner
  can dispatch: within the card's limits (1,024 threads, 232,448 bytes of
  shared memory a block), and every pair and every lane covered exactly
  once.
* ``rows_plan`` (kernel C) for every width it takes, and ``wfa_plan`` (the
  wavefront kernel): its lookback rings from the penalties and the route
  boundaries in band, lookback and sequence length.
* Which launch sites fetch kernel B's run tokens and which its opcodes.
* The walk kernel's tile (ops/csrc/nw_walk.cu): on seeded pairs run through
  the plain versions, the walk's cursor moves by at most one lane per
  anti-diagonal, so a tile of R rows x 2R lanes centred on the cursor serves
  it until its rows run out; and the kernel's narrower, prefetched tiles
  hold the cursor along SNPs and short gaps.
"""

import numpy as np
import pytest
import torch

from seqrush_tpu_torch.align import anchored, sweep
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.ops import nw, nw_cuda, wfa
from seqrush_tpu_torch.ops.nw import OP_D, OP_I, OP_M, _i0_of
from seqrush_tpu_torch.sequences import make_sequence_set

MAX_THREADS = 1024
MAX_SMEM = 232448
MAX_W = 5376  # band 5,375


def _batch_ladder(limit=4096):
    out = sorted({WfaAligner._quantize_batch(n) for n in range(1, limit + 1)})
    return [b for b in out if b <= limit]


def _check_wide_plan(plan, B, W, groups=1):
    """A wide_plan within the card's limits: lanes a thread it is built
    for, at most WIDE_MAX_THREADS threads and WIDE_MAX_CLUSTER CTAs a
    cluster, the pair's CTAs whole clusters, every CTA given at least one
    unit and at most its threads, the rings and slots in its shared memory."""
    assert plan.route == "wide" and plan.lanes in nw_cuda.WIDE_LANES
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= nw_cuda.WIDE_MAX_THREADS
    assert 1 <= plan.cluster <= nw_cuda.WIDE_MAX_CLUSTER and plan.ctas == plan.cluster * plan.clusters
    assert plan.clusters == 1 or plan.cluster == nw_cuda.WIDE_MAX_CLUSTER
    U = -(-W // plan.lanes)
    assert plan.ctas <= U and -(-U // plan.ctas) <= plan.threads < -(-U // plan.ctas) + 32
    # the clusters a pair needs: a chain only where 16 CTAs of the most
    # threads cannot hold the band
    assert plan.clusters == max(1, -(-(-(-U // nw_cuda.WIDE_MAX_THREADS)) // nw_cuda.WIDE_MAX_CLUSTER))
    span = plan.threads * plan.lanes
    assert plan.qring >= span + nw_cuda.SHARD_TILE + 2 and plan.tring >= span + 2 * nw_cuda.SHARD_TILE + 1
    assert 96 + 48 * plan.threads // 32 + plan.qring + plan.tring <= plan.smem_bytes <= MAX_SMEM
    assert plan.blocks == B * plan.ctas and plan.groups == groups


def _check_plan(plan, B, W, Lq, Lt):
    if plan.route == "wide":
        _check_wide_plan(plan, B, W)
        return
    assert plan.threads <= MAX_THREADS and plan.threads % 32 == 0
    assert plan.smem_bytes <= MAX_SMEM
    assert plan.blocks * plan.pairs_per_block >= B
    assert (plan.blocks - 1) * plan.pairs_per_block < max(B, 1)
    assert plan.route == "regs"
    assert plan.lanes in nw_cuda.SWEEP_LANES
    assert plan.threads == 32 * plan.warps_per_pair * plan.pairs_per_block
    assert plan.threads <= nw_cuda._MAX_THREADS[plan.lanes]
    assert plan.lanes * 32 * plan.warps_per_pair >= W
    # the last warp of a pair owns at least one real lane
    assert plan.lanes * 32 * (plan.warps_per_pair - 1) < W
    assert plan.pair_bytes == nw_cuda.pair_smem_bytes(Lq, Lt, W, plan.lanes, plan.warps_per_pair)
    assert plan.smem_bytes == plan.pair_bytes * plan.pairs_per_block
    if plan.warps_per_pair > 1:
        assert plan.pairs_per_block <= 2  # named barriers 1 and 2


def _coverage(plan, B, W):
    """(pair, lane) -> times covered, from the kernel's index arithmetic."""
    cover = np.zeros((B, W), np.int32)
    for blk in range(plan.blocks):
        for tid in range(plan.threads):
            if plan.route == "wide":
                # the kernel's index arithmetic (csrc/nw_sweep_wide.cuh::wide_body)
                b, ci = divmod(blk, plan.ctas)
                U = -(-W // plan.lanes)
                u0, u1 = ci * U // plan.ctas, (ci + 1) * U // plan.ctas
                g0 = (u0 + tid) * plan.lanes
                lanes = range(g0, min(g0 + plan.lanes, W)) if tid < u1 - u0 else ()
            else:
                warp, lane = divmod(tid, 32)
                pib, wip = divmod(warp, plan.warps_per_pair)
                b = blk * plan.pairs_per_block + pib
                r = wip * 32 + lane
                lanes = range(r * plan.lanes, min(r * plan.lanes + plan.lanes, W))
            if b < B:
                for lane_ in lanes:
                    cover[b, lane_] += 1
    return cover


@pytest.mark.parametrize("B", _batch_ladder())
def test_sweep_plan_within_limits(B):
    """Every band 0..5,375 at this batch size, with sequences sized as the
    runner packs them (the band never exceeds the longer sequence + 1)."""
    for W in range(1, MAX_W + 1):
        L = max(256, -(-W // 256) * 256)
        plan = nw_cuda.plan_sweep(B, W, L, L)
        _check_plan(plan, B, W, L, L)
    # the longest pairs the runner dispatches (tmax 65,536)
    for W in (1, 512, 1536, 4096, 4097, MAX_W):
        _check_plan(nw_cuda.plan_sweep(B, W, 32768, 32768), B, W, 32768, 32768)


@pytest.mark.parametrize(
    "B,W,wpp",
    [(8, 1, None), (9, 100, None), (576, 512, None), (576, 512, 1), (576, 512, 2),
     (48, 1536, None), (48, 1536, 3), (48, 1536, 6), (40, 2049, None), (40, 4096, None),
     (8, 4097, None), (13, 33, None)],
)
def test_sweep_plan_covers_each_lane_once(B, W, wpp):
    L = max(256, -(-W // 256) * 256)
    plan = nw_cuda.plan_sweep(B, W, L, L, warps_per_pair=wpp)
    _check_plan(plan, B, W, L, L)
    assert (_coverage(plan, B, W) == 1).all()


def test_sweep_plan_routes():
    """The planner's strip on the runner's band ladder, where it was timed on
    the card against every other strip (PERF.md), the switch to the wide
    route above the widest register strip, and the wide route's plan at W =
    5,282 and 5,283 for 8 pairs (8 CTAs of 2 lanes a thread, 352 threads,
    each holding an SM: eight clusters of 16 would not all be resident)."""
    for B, W, lanes, wpp in ((576, 128, 4, 1), (576, 256, 4, 2), (576, 384, 4, 3),
                             (576, 512, 4, 4), (144, 768, 12, 2), (144, 1280, 12, 4),
                             (144, 1536, 12, 4), (48, 1536, 12, 4), (48, 3072, 12, 8),
                             (48, 4096, 16, 8)):
        p = nw_cuda.plan_sweep(B, W, 3584, 3584)
        assert (p.route, p.lanes, p.warps_per_pair) == ("regs", lanes, wpp), (B, W)
    assert nw_cuda.plan_sweep(8, nw_cuda.REG_MAX_W, 4864, 4864).route == "regs"
    assert nw_cuda.plan_sweep(8, nw_cuda.REG_MAX_W + 1, 4864, 4864).route == "wide"
    for W in (5282, 5283):
        p = nw_cuda.plan_sweep(8, W, 5376, 5376)
        assert (p.lanes, p.ctas, p.cluster, p.threads) == (2, 8, 8, 352)
        assert p.smem_bytes == nw_cuda.SHARD_SPREAD_SMEM
    with pytest.raises(ValueError):
        nw_cuda.plan_sweep(8, 2048, 2048, 2048, warps_per_pair=1)
    with pytest.raises(ValueError):  # a second warp of ghost lanes only
        nw_cuda.plan_sweep(8, 100, 256, 256, warps_per_pair=2)


# bands from the first wide one to the widest the runner dispatches
# single-shot: a pair of qlen + tlen <= long_pair_threshold (65,536) has a
# band of at most max(qlen, tlen) + 1 (runner._band_for), so W <= 65,538
_WIDE_WS = (4097, 4225, 5120, 6143, 8192, 8193, 12_345, 16_385, 17_408, 24_576, 24_577, 32_769, 40_000,
            49_153, 65_538)


@pytest.mark.parametrize("B", [1, 2, 8, 48])
@pytest.mark.parametrize("W", _WIDE_WS)
def test_wide_plan_covers_each_lane_once(B, W):
    """The wide route's plan (a cluster of CTAs a pair, or a chain of
    clusters of 16) at bands from 4,097 to the widest the runner can
    dispatch: within the card's limits, the clusters a pair needs counted,
    and every (pair, lane) owned by exactly one thread of the kernel's
    index arithmetic."""
    plan = nw_cuda.plan_sweep(B, W, 65536, 65536)
    assert plan == nw_cuda.wide_plan(B, W)
    _check_wide_plan(plan, B, W)
    if W <= 16 * nw_cuda.WIDE_MAX_THREADS * 4:
        assert plan.clusters == 1
    if B == 1:  # a lone pair spreads over 16 CTAs (or a chain of them)
        assert plan.cluster == nw_cuda.WIDE_MAX_CLUSTER
    if B <= 8 and W <= 24_576:
        assert plan.smem_bytes == nw_cuda.SHARD_SPREAD_SMEM  # one CTA an SM
    if B <= 8 and W <= 8 * nw_cuda.WIDE_MAX_THREADS * 4:
        # every cluster resident at once, where CTAs of at most
        # WIDE_MAX_THREADS threads allow it
        assert B * plan.clusters <= nw_cuda.WIDE_RESIDENT[plan.cluster]
    cover = _coverage(plan, B, W) if B * W <= 200_000 else _coverage(nw_cuda.wide_plan(1, W), 1, W)
    assert (cover == 1).all()


@pytest.mark.parametrize(
    "B,W,Lq,Lt,pen,int16",
    [
        (64, 128, 1280, 1280, (5, 70000, 2, 24, 1), False),  # a gap open past 2^16
        (64, 128, 1280, 1280, (-3, 8, 2, -1, -1), False),  # negative penalties
        (64, 128, 1280, 1280, (5, 8, 2, 3000, 1), True),  # int16 adds that wrap
        (9, 601, 768, 768, (2800, 8, 2, 24, 1), True),
        (8, 128, 120_064, 120_064, (5, 8, 2, 24, 1), False),  # beyond the register route's shared memory
        (3, 4097, 8192, 8192, (5, 8, 2, 24, 1), True),
        (1, 17_408, 24_064, 24_064, (5, 8, 2, 24, 1), False),  # the translocation pair
    ],
)
def test_wide_plan_at_the_corners(B, W, Lq, Lt, pen, int16):
    """The dispatches the register route does not take go to the wide
    route's plan (align_plan, as nw_align launches), each lane once; narrow
    bands take one CTA a pair, a lane a thread (the solo kernels)."""
    kw = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), pen))
    plan = nw_cuda.align_plan(B, W, Lq, Lt, int16=int16, **kw)
    assert plan.route == "wide"
    _check_wide_plan(plan, B, W)
    assert (_coverage(plan, B, W) == 1).all()
    if W <= 128:  # the solo kernels: one CTA a pair, a lane a thread
        assert (plan.lanes, plan.ctas, plan.threads) == (1, 1, 128) and plan.solo
    assert plan.solo == (plan.ctas == 1 and plan.lanes == 1)
    assert nw_cuda.align_plan(B, W, 768, 768, mismatch=5, o1=8, e1=2, o2=24, e2=1).route == (
        "wide" if W > nw_cuda.REG_MAX_W else "regs")


def test_wide_plan_segment_groups():
    """The long route's grouped recompute at a wide band: B pairs x G grid
    rows share the card, so a pair takes fewer CTAs, never a CTA over
    WIDE_MAX_THREADS threads; forced lanes are kept."""
    for B, W, G in ((8, 4201, 59), (1, 5000, 3), (48, 4097, 1), (2, 40_000, 2)):
        plan = nw_cuda._segment_plan(B, W, 256, 256, 2048, G, dict(mismatch=5, o1=8, e1=2, o2=24, e2=1))
        assert plan == nw_cuda.wide_plan(B, W, G)
        _check_wide_plan(plan, B, W, G)
        assert (_coverage(plan, B, W) == 1).all()
        if B * G > nw_cuda.WIDE_RESIDENT[16] and plan.clusters == 1:
            assert plan.ctas < 16
        _check_slices(plan, B, nw_cuda.WIDE_RESIDENT[plan.cluster])
    for lanes in nw_cuda.WIDE_LANES:
        plan = nw_cuda.wide_plan(2, 5000, lanes=lanes)
        assert plan.lanes == lanes
        _check_wide_plan(plan, 2, 5000)
    with pytest.raises(ValueError):
        nw_cuda.wide_plan(2, 5000, lanes=8)


def _check_slices(plan, B, held):
    """wide_slices at `held` resident clusters: every (pair, grid row) in
    exactly one launch, and a chain's launches within `held` clusters."""
    slices = nw_cuda.wide_slices(plan, B, held)
    seen = np.zeros((plan.groups, max(B, 1)), np.int32)
    for b0, nb, y0, ny in slices:
        assert nb >= 1 and ny >= 1 and 0 <= b0 and b0 + nb <= B and 0 <= y0 and y0 + ny <= plan.groups
        seen[y0 : y0 + ny, b0 : b0 + nb] += 1
        if plan.clusters > 1:
            assert nb * ny * plan.clusters <= held
    assert (seen[:, :B] == 1).all()
    if plan.clusters == 1:
        assert slices == [(0, B, 0, plan.groups)]
    return slices


@pytest.mark.parametrize("B", [8, 9, 16, 48])
@pytest.mark.parametrize("W", _WIDE_WS)
def test_wide_slices_hold_the_resident_clusters(B, W):
    """Every wide-route dispatch the runner can make launches: a chunk of at
    least 8 (padded) pairs single-shot, and the long route's forward run and
    grouped recompute at its G (LONG_RUN, and long_group_size's G under the
    default budget, 1 at least), at bands up to 65,538: each launch's
    clusters within the card's resident clusters (WIDE_RESIDENT, the
    H100's), each pair and grid row launched once."""
    pen = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1)
    n_seg = -(-65_536 // nw_cuda.LONG_SEG)
    groups = {1, nw_cuda.LONG_RUN, nw_cuda.long_group_size(B, W, nw_cuda.LONG_SEG, n_seg, nw_cuda.LONG_BUDGET)}
    plans = [nw_cuda.align_plan(B, W, 65_536, 65_536, **pen)]
    plans += [nw_cuda._segment_plan(B, W, 65_536, 65_536, nw_cuda.LONG_SEG, G, pen) for G in sorted(groups)]
    for plan in plans:
        assert plan.route == "wide"
        slices = _check_slices(plan, B, nw_cuda.WIDE_RESIDENT[plan.cluster])
        if W > 24_576:  # a chain of 16-CTA clusters: the card holds 7 at once
            assert plan.clusters >= 2 and len(slices) > 1


def test_wide_slices_at_a_measured_count():
    """The launches follow the resident count the wrapper measures, not the
    planner's table: a card that holds fewer clusters gets more launches; a
    pair whose chain alone exceeds it raises."""
    plan = nw_cuda.wide_plan(8, 40_000, 3)
    assert (plan.clusters, plan.groups) == (2, 3)
    assert _check_slices(plan, 8, 7) == [(b, min(3, 8 - b), y, 1) for y in range(3) for b in (0, 3, 6)]
    assert _check_slices(plan, 8, 48) == [(0, 8, 0, 3)]
    assert _check_slices(plan, 8, 32) == [(0, 8, 0, 2), (0, 8, 2, 1)]
    assert len(_check_slices(plan, 8, 2)) == 24
    with pytest.raises(RuntimeError, match="resident"):
        nw_cuda.wide_slices(plan, 8, 1)
    assert nw_cuda.wide_slices(plan, 0, 7) == []
    one = nw_cuda.wide_plan(64, 8193)
    assert one.clusters == 1 and nw_cuda.wide_slices(one, 64, 1) == [(0, 64, 0, 1)]


def test_runner_records_kernel_a_route():
    """The runner's chunk records name kernel A's route on the card
    (align_plan, pure): the register route at the runner's usual bands, the
    wide route for a gap open the register route does not take and for a
    pair whose band passes REG_MAX_W (a 4.3 kb insertion, wide_route='full'),
    each aligned here through the plain versions."""
    from seqrush_tpu_torch.scores import AlignmentScores

    rng = np.random.default_rng(9)
    base = rng.integers(0, 4, 300).astype(np.uint8)
    ins = np.concatenate([base[:150], rng.integers(0, 4, 4300).astype(np.uint8), base[150:]])
    named = [("a", bytes(b"ACGT"[k] for k in base)), ("b", bytes(b"ACGT"[k] for k in ins))]
    pairs = np.array([[0, 1]])
    routes = {}
    for label, cfg in (("regs", RunnerConfig()), ("open", RunnerConfig(scores=AlignmentScores(0, 5, 70000, 2, 24, 1))),
                       ("band", RunnerConfig(wide_route="full"))):
        seqs = _two_seqs() if label != "band" else make_sequence_set(named)
        al = WfaAligner(seqs, cfg, device="cpu")
        (res,) = al.align_pairs(pairs)
        chunks = [d for d in al.stats["dispatches"] if d["kind"] == "chunk"]
        routes[label] = [(d["sweep"], d["band"]) for d in chunks]
        if label == "band":
            assert res.score == 24 + 4300 and chunks[-1]["band"] + 1 > nw_cuda.REG_MAX_W
    assert {r for r, _b in routes["regs"]} == {"regs"}
    assert {r for r, _b in routes["open"]} == {"wide"}
    assert routes["band"][-1][0] == "wide"


def _shard_launch_cover(band, D, n_local, cluster, B=2):
    """(pair, shard, lane) -> times covered by a launch of shards [0, n_local)
    at this cluster size, from the kernel's index arithmetic: block x of the
    grid [B x clusters x cluster] is rank x % cluster of cluster x // cluster,
    pair b = cluster // clusters, CTA ci = m * cluster + rank of the pair's
    CTAs, shard ci // C, units [c * U // C, (c + 1) * U // C) of the shard,
    thread r the r-th of them (threads past them are ghosts)."""
    plan = nw_cuda.shard_plan(band, D, n_local, cluster)
    Wl = (band + 1) // D
    S, C = plan.lanes, plan.ctas_per_shard
    U = Wl // S
    cover = np.zeros((B, n_local, Wl), np.int32)
    for blk in range(B * plan.clusters * plan.cluster):
        cl, rank = divmod(blk, plan.cluster)
        b, m = divmod(cl, plan.clusters)
        ls, c = divmod(m * plan.cluster + rank, C)
        u0, u1 = c * U // C, (c + 1) * U // C
        assert 1 <= u1 - u0 <= plan.threads  # a lane for every CTA, a thread for every unit
        for r in range(plan.threads):
            if r < u1 - u0:  # the ragged tail's threads own no real lane
                cover[b, ls, (u0 + r) * S:(u0 + r + 1) * S] += 1
    return plan, cover


@pytest.mark.parametrize("band,D,n_local", [
    (16639, 2, 2), (17407, 1, 1), (17407, 8, 8), (2047, 2, 2), (2047, 8, 8), (255, 8, 8), (1023, 4, 2),
    (279, 1, 1), (699, 2, 2), (104, 3, 3), (6143, 1, 1), (383, 3, 3), (9, 1, 1), (65535, 1, 1)])
def test_shard_plan_covers_each_lane_once(band, D, n_local):
    """Every cluster size the sharded planner takes covers each lane of each
    of the device's shards once, within the card's limits: 1,024 threads
    (and the instantiation's launch bound), 232,448 bytes of shared memory,
    more than half an SM's so one CTA holds an SM, clusters of 1 to 16."""
    sizes = nw_cuda.shard_cluster_sizes(band, D, n_local)
    assert sizes and set(sizes) <= {1, 2, 4, 8, 16}
    Wl = (band + 1) // D
    for cs in sizes:
        plan, cover = _shard_launch_cover(band, D, n_local, cs)
        assert (cover == 1).all(), cs
        assert plan.cluster == cs and plan.clusters * cs == n_local * plan.ctas_per_shard
        assert plan.lanes == nw_cuda.shard_lanes(Wl) and Wl % plan.lanes == 0
        assert plan.threads % 32 == 0 and plan.threads <= min(MAX_THREADS, nw_cuda._SHARD_MAX_THREADS)
        assert MAX_SMEM // 2 < plan.smem_bytes <= MAX_SMEM
        # the staged-base rings: a tile and a half of bases beyond the span,
        # and a tile's new bases within the threads' share
        span = plan.threads * plan.lanes
        assert plan.qring >= span + nw_cuda.SHARD_TILE + 2 and plan.tring >= span + 2 * nw_cuda.SHARD_TILE + 1
        assert plan.qring & (plan.qring - 1) == 0 and plan.tring & (plan.tring - 1) == 0
        assert plan.threads * nw_cuda._SHARD_STAGE >= nw_cuda.SHARD_TILE // 2 + 1 + nw_cuda.SHARD_TILE


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("band,D,B", [(1023, 2, 3), (279, 1, 2), (4095, 4, 1), (1399, 2, 2), (1049, 3, 2),
                                      (2999, 5, 1), (104, 3, 2), (7, 1, 2)])
def test_shard_plan_ragged(cluster, band, D, B):
    """Ragged shards (Wl not a multiple of CTAs x threads x lanes; 4, 2 and
    1 lanes a thread): each lane of each pair's shards once, the tails'
    threads ghosts, at every cluster size the planner takes."""
    if cluster not in nw_cuda.shard_cluster_sizes(band, D, D):
        with pytest.raises(ValueError):
            nw_cuda.shard_plan(band, D, D, cluster)
        return
    plan, cover = _shard_launch_cover(band, D, D, cluster, B=B)
    assert (cover == 1).all()
    assert plan.threads * plan.lanes * plan.ctas_per_shard >= (band + 1) // D


def test_shard_plan_choices():
    """The planner's lanes, its cluster layout at the route's shapes, and
    what it refuses."""
    assert [nw_cuda.shard_lanes(w) for w in (8320, 280, 350, 35)] == [4, 4, 2, 1]
    # the route's shape: both shards in one cluster of 16, 8 CTAs a shard
    p = nw_cuda.shard_plan(16639, 2, 2, 16)
    assert (p.lanes, p.ctas_per_shard, p.clusters, p.threads) == (4, 8, 1, 288)
    # one shard a device (distinct cards): 16 CTAs of the shard in one cluster
    assert nw_cuda.shard_plan(16639, 2, 1, 16).clusters == 1
    # eight shards: two CTAs each, one cluster; at four CTAs a cluster
    # (two shards of two CTAs), four
    p = nw_cuda.shard_plan(17407, 8, 8, 16)
    assert (p.ctas_per_shard, p.clusters) == (2, 1)
    assert nw_cuda.shard_plan(17407, 8, 8, 4).clusters == 4
    # a shard too wide for cluster x 512 threads x 4 lanes takes more CTAs
    assert nw_cuda.shard_plan(65535, 1, 1, 16).ctas_per_shard == 32
    # a CTA without a lane, a cluster size the card does not take, lanes
    # that do not divide the shard
    with pytest.raises(ValueError):
        nw_cuda.shard_plan(31, 1, 1, 16)
    assert 16 not in nw_cuda.shard_cluster_sizes(31, 1, 1)
    for bad in (3, 32, 0):
        with pytest.raises(ValueError):
            nw_cuda.shard_plan(1023, 1, 1, bad)
    with pytest.raises(ValueError):
        nw_cuda.nw_align_sharded_at(["cpu"], *[torch.zeros(1, 8, dtype=torch.uint8)] * 2,
                                    *[torch.zeros(1, dtype=torch.int32)] * 2, cluster=3, mismatch=5, o1=8,
                                    e1=2, o2=24, e2=1, band=7, tmax=8)


def test_rows_plan_covers_each_lane_once():
    """Kernel C's strip for every width from 1 to the widest: each lane on
    one thread (thread r owns [r * S, r * S + S)), no warp without a real
    lane, an instantiation that takes it within the card's limits; at the
    rows run's main width, Wr 1,023, five pairs resident an SM as the launch
    bounds, threads and shared memory reckon it (576 pairs in one wave on
    132 SMs)."""
    for Wr in range(1, nw_cuda.ROWS_MAX_LANES + 1):
        S, threads = nw_cuda.rows_plan(Wr)
        most, _blocks = nw_cuda.rows_bounds(S, threads)
        assert threads % 32 == 0 and threads <= min(most, MAX_THREADS)
        assert threads * S >= Wr > (threads - 32) * S
        if Wr in (1, 2, 95, 1023, 1024, 1025, 4095, 4096, 4097, 8193, nw_cuda.ROWS_MAX_LANES):
            owner = np.arange(threads * S) // S
            cover = np.bincount(owner[:Wr], minlength=threads)
            assert cover.sum() == Wr and (cover[: Wr // S] == S).all()
    with pytest.raises(ValueError):
        nw_cuda.rows_plan(nw_cuda.ROWS_MAX_LANES + 1)
    S, threads = nw_cuda.rows_plan(1023)
    assert (S, threads) == (8, 128) and nw_cuda.rows_bounds(S, threads) == (128, 5)
    assert nw_cuda.rows_pairs_per_sm(S, threads, 3584, 511) >= -(-576 // 132) == 5
    win, nq, t_off, nt = nw_cuda.rows_smem(3584, 511, S, threads)
    assert win == 3584 and nq + nt <= MAX_SMEM and t_off >= 512 and nt >= t_off - 511 + threads * S + 3584


@pytest.mark.parametrize("Wr", [1, 1023, 1025, 4097, nw_cuda.ROWS_MAX_LANES])
def test_rows_window_keeps_pairs_resident(Wr):
    """Kernel C stages a pair's rows whole while they fit the share of an
    SM's shared memory that keeps its launch bound's pairs resident, and a
    window of rows (a multiple of 16) past that, so no query length is too
    long and the pairs an SM never drop below the launch bound's; the
    boundary is where the whole rows stop fitting."""
    band = (Wr - 1) // 2
    S, threads = nw_cuda.rows_plan(Wr)
    _most, blocks = nw_cuda.rows_bounds(S, threads)
    static = nw_cuda._ROWS_STATIC_SMEM

    def fits(R):
        win, nq, t_off, nt = nw_cuda.rows_smem(R, band, S, threads)
        w = min(win, R)
        assert t_off % 16 == 0 and t_off >= band + 1 and nq % 16 == 0 and nt % 16 == 0
        assert nq >= w + 1 and nt >= t_off - band + threads * S + w
        assert nq + nt + static <= MAX_SMEM and blocks * (nq + nt + static + 1024) <= 233472
        assert nw_cuda.rows_pairs_per_sm(S, threads, R, band) >= min(blocks, nw_cuda.rows_pairs_per_sm(S, threads, 1, band))
        if win < R:
            assert win % 16 == 0 and win >= 4096
        return win >= R

    lo, hi = 0, 1 << 20
    assert fits(lo) and fits(3584) and not fits(hi)
    while hi - lo > 1:  # the longest query staged whole
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    assert all(fits(R) for R in range(max(0, lo - 40), lo + 1))
    assert not any(fits(R) for R in (hi, hi + 1, hi + 17, 3 * hi, 1 << 22))
    if blocks == 5:
        assert 20000 < lo < 23000  # Wr <= 1,024: about 21,500-21,900 rows whole


HEADLINE_PEN = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1)


@pytest.mark.parametrize("pen,rows", [
    (HEADLINE_PEN, (26, 3, 2)),
    (dict(mismatch=5, o1=8, e1=2, o2=-1, e2=-1), (11, 3, 0)),  # one-piece
    (dict(mismatch=5, o1=8, e1=2, o2=40, e2=1), (42, 3, 2)),  # a long lookback
    (dict(mismatch=30, o1=4, e1=3, o2=9, e2=2), (31, 4, 3)),  # the mismatch the deepest
])
def test_wfa_plan_rings_from_penalties(pen, rows):
    """The wavefront kernel's rings: M keeps its deepest lookback plus one
    rows, I and D their extend plus one, as int16 rows of the diagonals and
    a NULL16 column either side, rounded up to 16 bytes."""
    plan = wfa.wfa_plan(3648, 3648, 255, **pen)
    assert plan.ring_rows == rows == wfa.ring_rows(**pen)
    assert plan.ring_bytes == -(-(rows[0] + 2 * rows[1] + 2 * rows[2]) * 513 * 2 // 16) * 16
    assert plan.route == "rings" and plan.staged and plan.smem_bytes <= MAX_SMEM - 1024
    assert plan.stage_bytes == 2 * (3648 + 16)


def test_wfa_plan_route_boundaries():
    """Where the rings and the staged sequences stop fitting a block's
    shared memory: in sequence length, band and lookback; and mismatch 0,
    whose M reads the row it writes, on the history in device memory."""
    def route(Lq, band, **pen):
        p = wfa.wfa_plan(Lq, Lq, band, **{**HEADLINE_PEN, **pen})
        assert p.smem_bytes <= MAX_SMEM - 1024
        return p.route, p.staged

    # sequence length at band 255: 36,944 bytes of rings, then 2 x (L + 16)
    assert route(97_216, 255) == ("rings", True)
    assert route(97_232, 255) == ("rings", False)
    # band: 36 rows of 2 * band + 3 int16 columns
    assert route(600, 1605) == ("rings", False)
    assert route(600, 1606) == ("global", True)
    assert route(200_000, 1606) == ("global", False)
    assert route(600, 1500) == ("rings", True)
    # lookback at band 600 (1,203 columns): 95 rows fit beside the
    # sequences, 96 alone, 97 not at all
    assert route(600, 600, o2=83, e2=1) == ("rings", True)
    assert route(600, 600, o2=84, e2=1) == ("rings", False)
    assert route(600, 600, o2=85, e2=1) == ("global", True)
    assert wfa.wfa_plan(600, 600, 600, **{**HEADLINE_PEN, "o2": 84}).ring_rows == (86, 3, 2)
    # mismatch 0
    assert route(600, 63, mismatch=0) == ("global", True)
    # threads: a warp at band 0, 1,024 (striding) past 511
    assert wfa.wfa_plan(100, 100, 0, **HEADLINE_PEN).threads == 32
    assert wfa.wfa_plan(100, 100, 600, **HEADLINE_PEN).threads == 1024


def test_register_route_penalties():
    """The register route's keyed arithmetic needs penalties in [0, 2^16);
    one-piece scoring leaves o2/e2 (negative) out."""
    assert nw_cuda.register_route_penalties(5, 8, 2, 24, 1)
    assert nw_cuda.register_route_penalties(5, 8, 2, -1, -1)
    assert not nw_cuda.register_route_penalties(-1, 8, 2, 24, 1)
    assert not nw_cuda.register_route_penalties(5, 1 << 16, 2, 24, 1)
    assert not nw_cuda.register_route_penalties(5, 8, 2, 24, 1 << 16)


def _walk_cells(ops, qlen, tlen, K, with_ops=False):
    """The (anti-diagonal, lane) cells the walk visits, rebuilt from its
    opcodes (one opcode per visited cell, at column td), with each cell's
    opcode where with_ops."""
    i, j = qlen, tlen
    cells = []
    for td in range(ops.size - 1, 0, -1):
        op = int(ops[td])
        if op == 0:
            continue
        assert td == i + j, "an opcode off the cursor's anti-diagonal"
        cells.append((td, i - _i0_of(td, K), op) if with_ops else (td, i - _i0_of(td, K)))
        if op == OP_M:
            i, j = i - 1, j - 1
        elif op == OP_I:
            i -= 1
        else:
            assert op == OP_D
            j -= 1
    return cells


def _pairs(rng, n, L, band):
    qs, ts = [], []
    for k in range(n):
        q = rng.integers(0, 4, L).astype(np.uint8)
        t = q.copy()
        t[rng.integers(0, L, L // 20)] = rng.integers(0, 4, L // 20)
        if k % 3 == 1:
            t = np.delete(t, np.arange(L // 4, L // 4 + band // 2 + 3))
        if k % 3 == 2:
            t = np.insert(t, L // 2, rng.integers(0, 4, band + 2).astype(np.uint8))
        if k % 2:
            q, t = t, q
        qs.append(q)
        ts.append(t)
    lq = max(q.size for q in qs)
    lt = max(t.size for t in ts)
    Q = np.full((n, lq), 6, np.uint8)
    T = np.full((n, lt), 7, np.uint8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        Q[b, : q.size] = q
        T[b, : t.size] = t
    ql = np.array([q.size for q in qs], np.int32)
    tl = np.array([t.size for t in ts], np.int32)
    return Q, T, ql, tl


def _walk(Q, T, ql, tl, band, two_piece, with_ops=False):
    tmax = int((ql + tl).max())
    kw = dict(mismatch=5, o1=8, e1=2, o2=24 if two_piece else -1, e2=1 if two_piece else -1,
              band=band, tmax=tmax)
    args = [torch.from_numpy(a) for a in (Q, T, ql, tl)]
    _scores, tb = nw_cuda.nw_align(*args, **kw)
    ops = nw_cuda.nw_walk(tb, args[2], args[3], band=band, tmax=tmax).numpy()
    return [_walk_cells(ops[b], int(ql[b]), int(tl[b]), band, with_ops) for b in range(Q.shape[0])]


def _tile_loads(steps, K, W):
    """The steps at which the walk kernel loads a tile around a cursor its
    tiles in flight missed (csrc/nw_walk.cu), for a traceback whose rows lie
    W bytes apart from a 32-byte boundary: a tile holds WALK_ROWS rows, each
    the window nw_cuda.walk_row_window gives for the lane of the path the
    tile was loaded for (from the cursor where it was issued: the diagonal,
    or the gap the cursor is in, carried on); WALK_DEPTH tiles load below
    the one walked; where a gap run closes inside the tile and the next tile
    does not hold the diagonal from there at its top or bottom row, the
    tiles in flight load again on it (the kernel checks after each gap
    ballot).  steps: the walk's (anti-diagonal, lane, opcode) cells."""
    R = nw_cuda.WALK_ROWS
    gap_state = {nw.OP_D: nw.H_D1, nw.OP_I: nw.H_I1}

    def on_band(lane):
        return min(max(lane, 0), W - 1)

    def tile(top, path):
        wins = {}
        for t in range(max(top - R + 1, 1), top + 1):
            p = on_band(nw_cuda.walk_path_lane(*path, t, K))
            wins[t] = nw_cuda.walk_row_window(p, t * W + p, 0, W)
        return top, wins

    def holds(tl, t, lane):
        top, wins = tl
        if not top - R < t <= top:
            return False
        if not 0 <= lane < W:
            return True
        c0, s, e = wins[t]
        return s <= lane - c0 < e

    cur, flight, demand = (-1, {}), [], []
    for n, (td, lane, op) in enumerate(steps):
        if not holds(cur, td, lane):
            inside = n > 0 and op == steps[n - 1][2] and op in gap_state
            path = (lane, td, gap_state[op] if inside else 0)
            if flight and holds(flight[0], td, lane):
                cur, flight = flight[0], flight[1:]
            else:
                demand.append(n)
                cur, flight = tile(td, path), []
            while len(flight) < nw_cuda.WALK_DEPTH and cur[0] - R * (len(flight) + 1) >= 1:
                flight.append(tile(cur[0] - R * (len(flight) + 1), path))
        closes = op in gap_state and n + 1 < len(steps) and steps[n + 1][2] != op
        if closes and flight and holds(cur, *steps[n + 1][:2]):
            t2, l2, _op = steps[n + 1]
            ntop = cur[0] - R
            nlow = max(ntop - R + 1, 1)
            path = (l2, t2, 0)
            if not all(holds(flight[0], t, on_band(nw_cuda.walk_path_lane(*path, t, K))) for t in (ntop, nlow)):
                flight = [tile(cur[0] - R * (q + 1), path) for q in range(len(flight))]
    return demand


@pytest.mark.parametrize("seed,band,two_piece", [(0, 15, True), (1, 31, True), (2, 48, False), (3, 100, True)])
def test_walk_cursor_moves_one_lane_per_antidiagonal(seed, band, two_piece):
    """The lane moves by at most one per anti-diagonal, so a tile of R rows
    and 2R lanes centred on the cursor is left only through its last row."""
    rng = np.random.default_rng(seed)
    R = nw_cuda.WALK_ROWS
    for cells in _walk(*_pairs(rng, 6, 160, band), band, two_piece):
        assert cells
        for (t1, l1), (t2, l2) in zip(cells, cells[1:]):
            assert 1 <= t1 - t2 <= 2
            assert abs(l2 - l1) <= 1
        top, c0 = -1, 0
        for td, lane in cells:
            if td > top or td <= top - R or not (c0 <= lane < c0 + 2 * R):
                assert top < 0 or td <= top - R, "the cursor left the tile sideways"
                top, c0 = td, lane - R


@pytest.mark.parametrize("seed,two_piece", [(0, True), (1, False)])
def test_walk_prefetch_serves_short_gaps(seed, two_piece):
    """Along SNPs and gaps of up to 15 steps the tiles in flight hold every
    step the path they were loaded for takes: after the first tile, a tile is
    loaded around the cursor only where a gap step took it off that path,
    at most once a gap run."""
    rng = np.random.default_rng(seed)
    C = 32
    qs, ts = [], []
    for k in range(4):
        q = rng.integers(0, 4, 600).astype(np.uint8)
        t = q.copy()
        t[rng.integers(0, 600, 12)] = rng.integers(0, 4, 12)
        t = np.delete(t, np.arange(150, 150 + 3 + k))
        t = np.insert(t, 400, rng.integers(0, 4, C // 2 - 1 - k).astype(np.uint8))
        qs.append(q)
        ts.append(t)
    Q, T = np.stack(qs), np.full((4, max(t.size for t in ts)), 7, np.uint8)
    for b, t in enumerate(ts):
        T[b, : t.size] = t
    ql = np.full(4, 600, np.int32)
    tl = np.array([t.size for t in ts], np.int32)
    for steps in _walk(Q, T, ql, tl, 63, two_piece, with_ops=True):
        loads = _tile_loads(steps, 63, 64)
        gap_runs = sum(op != OP_M and (n == 0 or steps[n - 1][2] != op) for n, (_t, _l, op) in enumerate(steps))
        assert loads[0] == 0 and len(loads) <= 1 + gap_runs
        assert all(steps[n - 1][2] != OP_M for n in loads[1:])


def test_new_launch_sites_routes():
    """The routes nw_align takes at this slice's launch shapes: the
    orientation probe [8, W 128, 256-rounded lengths], the headline gap chunk
    [64, W 128, Lq 1,280] and the inversion batch [8,192, W 102, Lq 1,169]
    stay on the register route; gap or inversion windows whose sequences do
    not fit the register route's shared memory (about 115 kb + 115 kb) take
    the wide route, as any chunk does."""
    probe = nw_cuda.plan_sweep(8, 128, 768, 768)
    gap = nw_cuda.plan_sweep(64, 128, 1280, 1280)
    inv = nw_cuda.plan_sweep(8192, 102, 1169, 1172)
    for p, (B, W, Lq, Lt) in ((probe, (8, 128, 768, 768)), (gap, (64, 128, 1280, 1280)),
                              (inv, (8192, 102, 1169, 1172))):
        assert p.route == "regs"
        _check_plan(p, B, W, Lq, Lt)
    assert inv.lanes * 32 * inv.warps_per_pair >= 102
    big = nw_cuda.plan_sweep(8, 128, 120_064, 120_064)
    assert big.route == "wide" and big.blocks == 8
    odd = nw_cuda.plan_sweep(8, 131, 130, 131)
    assert odd.route == "regs"
    _check_plan(odd, 8, 131, 130, 131)


def _two_seqs(n=300):
    rng = np.random.default_rng(6)
    base = rng.integers(0, 4, n)
    alt = base.copy()
    alt[rng.integers(0, n, 6)] = rng.integers(0, 4, 6)
    return make_sequence_set([("a", bytes(b"ACGT"[k] for k in base)),
                              ("b", bytes(b"ACGT"[k] for k in alt))])


def test_walk_output_by_launch_site():
    """Run tokens where they fit (tmax + 4 < 2^15) at the runner's chunks
    (RUN_MAX tokens a pair), the anchored route's window chunks (WIN_RUN_MAX)
    and the sweepga gap chunks (GAP_RUN_MAX), the JAX package's budgets;
    opcodes for emit='ops', for chunks of pairs whose runs overflowed, for
    the long route's segment walk and for the inversion batch
    (tests/test_torch_inversion.py)."""
    assert (nw.RUN_MAX, anchored.WIN_RUN_MAX, sweep.GAP_RUN_MAX) == (128, 32, 24)
    assert nw.runs_fit(32763) and not nw.runs_fit(32764)
    seqs = _two_seqs()
    chunk = [(0, False, 127, None, None)]
    auto = WfaAligner(seqs, RunnerConfig(), device="cpu")
    assert auto._use_runs(chunk, 7168) and not auto._use_runs(chunk, 32764)
    auto._runs_off_set.add((0, False))
    assert not auto._use_runs(chunk, 7168)
    assert not WfaAligner(seqs, RunnerConfig(emit="ops"), device="cpu")._use_runs(chunk, 7168)
    forced = WfaAligner(seqs, RunnerConfig(emit="runs"), device="cpu")
    assert forced._use_runs(chunk, 7168)
    with pytest.raises(ValueError, match="32k"):
        forced._use_runs(chunk, 32764)
    # a dispatch record per site: a chunk, then the same pair on the long route
    pairs = np.array([[0, 1]])
    auto = WfaAligner(seqs, RunnerConfig(), device="cpu")
    auto.align_pairs(pairs)
    longr = WfaAligner(seqs, RunnerConfig(long_pair_threshold=512), device="cpu")
    longr.align_pairs(pairs)
    assert [(d["kind"], d["emit"]) for d in auto.stats["dispatches"]] == [("chunk", "runs")]
    assert [(d["kind"], d["emit"]) for d in longr.stats["dispatches"]] == [("long", "ops")]



# -- the packed int16 sweep's planner (twins) and kernel D's shared memory


def _check_twin_plan(plan, B, W, Lq, Lt):
    """A plan_sweep_i16 pick within the card's limits: the packed sweep's
    ("twins") or the int32 body's (plan_sweep's, "regs" or "wide")."""
    if plan.route != "twins":
        assert plan == nw_cuda.plan_sweep(B, W, Lq, Lt)
        return
    n_twins = -(-B // 2)
    most, _blocks = nw_cuda._I16_BOUNDS[plan.lanes]
    assert plan.lanes in nw_cuda.I16_LANES and W <= nw_cuda.REG_MAX_W
    assert plan.threads == 32 * plan.warps_per_pair * plan.pairs_per_block <= most <= MAX_THREADS
    assert plan.lanes * 32 * plan.warps_per_pair >= W > plan.lanes * 32 * (plan.warps_per_pair - 1)
    assert plan.pair_bytes == nw_cuda.twin_smem_bytes(Lq, Lt, W, plan.lanes, plan.warps_per_pair)
    assert plan.smem_bytes == plan.pair_bytes * plan.pairs_per_block <= MAX_SMEM
    assert plan.blocks * plan.pairs_per_block >= n_twins > (plan.blocks - 1) * plan.pairs_per_block
    if plan.warps_per_pair > 1:
        assert plan.pairs_per_block <= 2  # named barriers 1 and 2


@pytest.mark.parametrize("B", _batch_ladder())
def test_twin_plan_within_limits(B):
    """Every band the register route takes at this batch size, with
    sequences sized as the runner packs them, and the longest pairs."""
    for W in range(1, nw_cuda.REG_MAX_W + 1, 7):
        L = max(256, -(-W // 256) * 256)
        _check_twin_plan(nw_cuda.plan_sweep_i16(B, W, L, L), B, W, L, L)
    for W in (1, 512, 1536, 4096, 4097, MAX_W):
        _check_twin_plan(nw_cuda.plan_sweep_i16(B, W, 32768, 32768), B, W, 32768, 32768)


@pytest.mark.parametrize("B,W,wpt", [(9, 128, 1), (9, 512, 4), (576, 512, None), (576, 512, 1), (576, 512, 2),
                                     (144, 768, None), (7, 100, 1), (3, 3072, 12), (1, 4096, 8)])
def test_twin_plan_covers_each_lane_once(B, W, wpt):
    """Every (pair, lane) once, from the kernel's index arithmetic: twin i of
    block x * pairs_per_block + i is pairs 2i and 2i + 1 (an odd B's last
    twin has none past B), thread r of a twin owns lanes [r * S, r * S + S)
    of both."""
    L = max(256, -(-W // 256) * 256)
    plan = nw_cuda.plan_sweep_i16(B, W, L, L, warps_per_twin=wpt)
    assert plan.route == "twins"
    _check_twin_plan(plan, B, W, L, L)
    cover = np.zeros((B, W), np.int32)
    for blk in range(plan.blocks):
        for tid in range(plan.threads):
            warp, lane = divmod(tid, 32)
            pib, wip = divmod(warp, plan.warps_per_pair)
            twin = blk * plan.pairs_per_block + pib
            r = wip * 32 + lane
            for b in (2 * twin, 2 * twin + 1):
                if b < B:
                    cover[b, r * plan.lanes:min(r * plan.lanes + plan.lanes, W)] += 1
    assert (cover == 1).all()


def test_twin_plan_picks_and_reckoning():
    """The planner's picks where every strip was timed on the card
    (PERF.md): 4 lanes a thread wherever they cover W, 8 where they do not, the
    int32 body's int16 mode where twins leave the SMs a warp or two (few
    pairs); at the int16 run's shape [576, W 512] 288 twins, 12 warps on the
    busiest SM, one wave; the twin's shared memory and the forcing."""
    picks = {(576, 512): ("twins", 4, 4), (288, 512): ("twins", 4, 4), (576, 128): ("twins", 4, 1),
             (144, 768): ("twins", 8, 3), (48, 1536): ("regs", 12, 4), (64, 1170): ("regs", 12, 4),
             (9, 512): ("regs", 4, 4), (576, 4096): ("twins", 16, 8), (8, 4097): ("wide", 2, 72)}
    for (B, W), want in picks.items():
        p = nw_cuda.plan_sweep_i16(B, W, 3584, 3584)
        assert (p.route, p.lanes, p.warps_per_pair) == want, (B, W)
    p = nw_cuda.plan_sweep_i16(576, 512, 3584, 3584)
    assert (p.pairs_per_block, p.threads, p.blocks) == (1, 128, 288)
    assert p.pair_bytes == 8208 + 9216 + 2 * 4 * 6 * 4 == 17616  # 2 x (Lq + 1 + L) and 2 x (Lt + W + L), rounded to 16
    reck = nw_cuda.twins_reckoning(p, 576)
    assert reck == {"twins": 288, "warps_per_sm": 12, "resident_blocks_per_sm": 3, "waves": 1}
    assert nw_cuda.twins_reckoning(p, 576, resident_blocks=2)["waves"] == 2
    odd = nw_cuda.plan_sweep_i16(9, 512, 768, 768, warps_per_twin=4)
    assert (odd.route, odd.lanes, odd.blocks) == ("twins", 4, 5)
    assert nw_cuda.twin_smem_bytes(100, 200, 64, 4, 1) == 464 + 784 + 48
    with pytest.raises(ValueError):  # a second warp of ghost lanes only
        nw_cuda.plan_sweep_i16(8, 100, 256, 256, warps_per_twin=2)
    with pytest.raises(ValueError):  # more threads than any instantiation takes
        nw_cuda.plan_sweep_i16(8, 4096, 4096, 4096, warps_per_twin=1)
    # twins too long for shared memory take the int32 body's plan: its
    # register route while one pair fits, the wide route past that
    assert nw_cuda.plan_sweep_i16(576, 512, 60000, 60000) == nw_cuda.plan_sweep(576, 512, 60000, 60000)
    assert nw_cuda.plan_sweep(576, 512, 60000, 60000).route == "regs"
    assert nw_cuda.plan_sweep_i16(576, 512, 120000, 120000).route == "wide"


def test_rows_walk_smem():
    """Kernel D's block: four warps, each with three tiles of 64 rows of 48
    bytes (the 16-byte blocks that cover 32 lanes at any alignment) and a
    gap ring of G (row, length) slots; 41,984 bytes at GAP_MAX, which leaves
    20 pairs an SM (five blocks' shared memory), 45,056 at the ring's 256
    slots, below the 48 KB a block takes without opting in."""
    assert nw_cuda.rows_walk_smem(1) == 4 * (3 * 64 * 48 + 8) == 36896
    assert nw_cuda.rows_walk_smem(nw_cuda.ROWS_WALK_RING) == 45056 <= 48 * 1024
    assert nw_cuda.rows_walk_smem(nw.GAP_MAX) == 4 * (9216 + 8 * 160) == 41984
    assert nw_cuda.rows_walk_pairs_per_sm(nw.GAP_MAX) == 20
    assert nw_cuda.rows_walk_pairs_per_sm(1) == 24
    for G in (0, nw_cuda.ROWS_WALK_RING + 1):
        with pytest.raises(ValueError):
            nw_cuda.rows_walk_smem(G)


# -- the snapshot mode's rounds (snap_rounds) ----------------------------------


@pytest.mark.parametrize("B,resident,sms,want", [(1152, 4, 132, 3), (1152, 5, 132, 2), (528, 4, 132, 1),
                                                 (529, 4, 132, 2), (1, 1, 132, 1), (132 * 9, 5, 132, 2)])
def test_snap_rounds(B, resident, sms, want):
    """Rounds of pairs on the busiest SM: B pairs over the SMs, resident at
    once on each."""
    assert nw_cuda.snap_rounds(B, resident, sms) == want


def test_fold_chunk_plan():
    """The fold's largest headline chunk [1,152 rows, W 768] takes 8 lanes x
    3 warps, a pair a block of 96 threads: at the four pairs an SM its 168
    registers hold, three rounds of rows on the busiest SM."""
    plan = nw_cuda.plan_sweep(1152, 768, 3584, 3584)
    assert (plan.route, plan.lanes, plan.warps_per_pair, plan.pairs_per_block, plan.threads) == ("regs", 8, 3, 1, 96)
    assert nw_cuda.snap_rounds(plan.blocks * plan.pairs_per_block, 65536 // (168 * plan.threads)) == 3


# -- kernel A's tiled mode: the planner, the block layout and the live warps ----


def _tiled_layout(n_narrow, n_wide, R):
    """tile [B] and wide [B] of n_narrow narrow rows, then n_wide pairs of R rows."""
    tile = np.concatenate([np.zeros(n_narrow, np.int32), np.tile(np.arange(R, dtype=np.int32), n_wide)])
    wide = np.concatenate([np.zeros(n_narrow, bool), np.ones(n_wide * R, bool)])
    return tile, wide


def _tiled_pairs_of_blocks(plan, order, n_wide, R):
    """The register route's pair of each warp (csrc/nw_sweep_tiled.cu):
    {pair's first row: [(block, warp in pair), ...]} and each block's kind."""
    out = {}
    for blk in range(plan.blocks):
        wide = blk < n_wide
        for warp in range(plan.threads // 32):
            pib = 0 if wide else warp // plan.warps_per_pair
            wip = warp - pib * (R * plan.warps_per_pair if wide else plan.warps_per_pair)
            slot = blk if wide else n_wide + (blk - n_wide) * R + pib
            if slot < len(order):
                out.setdefault(int(order[slot]), []).append((blk, wip, wide))
    return out


@pytest.mark.parametrize("n_narrow,n_wide,W,R", [
    (560, 48, 512, 3),   # the headline's merged chunk (552 pairs and 8 padding rows)
    (7, 2, 64, 2),
    (5, 3, 128, 4),
    (4, 2, 102, 3),      # W not a multiple of 32: strips cross tile rows
    (3, 1, 200, 2),
    (6, 2, 16, 4),
    (2, 0, 512, 3),      # no wide pair
    (0, 5, 256, 3),      # no narrow pair
])
def test_tiled_plan_covers_every_row_once(n_narrow, n_wide, W, R):
    """plan_sweep_tiled within each strip's launch bound and the shared
    memory; every pair's first row in exactly one block, a wide pair alone
    in its block with every warp and its n_tiles * W lanes covered by them, a
    narrow pair's last warp holding a real lane; every row of the layout
    some pair's."""
    Lq = Lt = 1792
    plan = nw_cuda.plan_sweep_tiled(n_narrow, n_wide, W, R, Lq, Lt)
    assert plan.route == "regs"
    assert plan.threads <= nw_cuda._MAX_THREADS[plan.lanes] and plan.threads % 32 == 0
    assert plan.smem_bytes <= MAX_SMEM
    assert plan.smem_bytes >= R * plan.pair_bytes
    assert plan.smem_bytes >= nw_cuda.pair_smem_bytes(Lq, Lt, R * W, plan.lanes, R * plan.warps_per_pair)
    assert plan.blocks == n_wide + -(-n_narrow // R)
    tile, wide = _tiled_layout(n_narrow, n_wide, R)
    order, nw_ = nw_cuda._tiled_order(tile, wide, R, W - 1, len(tile), "cpu")
    assert nw_ == n_wide
    owners = _tiled_pairs_of_blocks(plan, order.numpy(), n_wide, R)
    assert sorted(owners) == sorted(np.flatnonzero(tile == 0).tolist())
    rows = []
    lanes_per_warp = 32 * plan.lanes
    for first, warps in owners.items():
        is_wide = bool(wide[first])
        assert len({b for b, _w, _k in warps}) == 1 and all(k == is_wide for _b, _w, k in warps)
        Wp = R * W if is_wide else W
        assert sorted(w for _b, w, _k in warps) == list(range(len(warps)))
        assert len(warps) * lanes_per_warp >= Wp
        if is_wide:  # each tile's warps_per_pair warps: a warp past the pair's lanes holds ghosts only
            assert len(warps) == plan.threads // 32 == R * plan.warps_per_pair
        else:
            assert Wp > (len(warps) - 1) * lanes_per_warp
        rows += list(range(first, first + (R if is_wide else 1)))
    assert sorted(rows) == list(range(len(tile)))


def test_tiled_plan_headline_merge():
    """The headline's merged chunk [704 rows, W 512, 3 tiles, 48 wide]: 8
    lanes a thread, 2 warps a narrow pair, 6-warp blocks, 235 of them."""
    plan = nw_cuda.plan_sweep_tiled(560, 48, 512, 3, 3584, 3584)
    assert (plan.route, plan.lanes, plan.warps_per_pair, plan.threads, plan.blocks) == ("regs", 8, 2, 192, 235)
    assert plan.pair_bytes == nw_cuda.pair_smem_bytes(3584, 3584, 512, 8, 2)


def test_tiled_plan_wide_route_past_the_register_route():
    """n_tiles * W over REG_MAX_W takes the wide route (one block a pair)."""
    plan = nw_cuda.plan_sweep_tiled(4, 2, 1100, 4, 2048, 2048)
    assert plan.route == "wide" and plan.blocks == 6 and plan.threads <= MAX_THREADS


@pytest.mark.parametrize("W,R,S", [(512, 3, 8), (512, 3, 4), (102, 3, 4), (102, 2, 8), (200, 2, 16),
                                   (16, 4, 8), (64, 2, 12), (1536, 2, 16)])
def test_tiled_strip_stores_cover_each_lane_once(W, R, S):
    """The register route's store of a wide pair's row (csrc/nw_sweep_tiled.cu):
    a thread's strip [s0, s0 + S) goes to tile row s0 // W from lane
    s0 % W (to nothing past the pair's R * W lanes, W as its first lane),
    byte by byte through each lane's own tile row where it crosses a tile
    row's end (only where W is not a multiple of S): every lane of the pair
    lands once, at [l // W, l % W]."""
    Wp = R * W
    wpp = -(-W // (32 * S))
    seen = np.zeros((R, W), int)
    for s0 in range(0, 32 * S * wpp * R, S):
        tile = s0 // W if s0 < Wp else 0
        tc0 = s0 - tile * W if s0 < Wp else W
        split = W % S != 0 and s0 < Wp and s0 + S > (tile + 1) * W and (tile + 1) * W < Wp
        for k in range(S):
            lane = s0 + k
            if split:
                if lane < Wp:
                    seen[lane // W, lane % W] += 1
            elif tc0 + k < W:  # store_row: lanes of the strip inside its tile row
                seen[tile, tc0 + k] += 1
                assert tile * W + tc0 + k == lane
    assert (seen == 1).all()
    assert W % S or not any(s0 + S > (s0 // W + 1) * W for s0 in range(0, Wp, S))




def test_tiled_split_of_a_timer():
    """nw_cuda.tiled_split on a hand-made timer: three 2-warp blocks, the
    first wide, two of them on SM 4 and one alone on SM 9; an empty slot."""
    ns = 1_000_000
    rows = []  # entry, staged, end, cycles, smid, first row, anti-diagonals
    for blk, (sm, end_ms, cycles) in enumerate([(4, 5, 2000), (4, 7, 3000), (9, 3, 1000)]):
        for warp in range(2):
            first = -1 if (blk, warp) == (2, 1) else 10 * blk
            rows.append([0, 1000, end_ms * ns, cycles * 100, sm, first, 100])
    split = nw_cuda.tiled_split(np.array(rows), 2, 1)
    assert split["kernel_ms"] == 7.0
    assert split["wide_block_ms"] == {"mean": 5.0, "max": 5.0}
    assert split["narrow_block_ms"]["max"] == 7.0
    assert split["sm_blocks"] == {"1": 1, "2": 1} and split["sm_warps"] == {"1": 1, "4": 1}
    assert split["busiest_sm"] == {"warps": 4, "ms": 7.0, "cycles": 2 * (200_000 + 300_000)}
    assert split["lone_blocks"] == [2]
    assert split["cycles_per_anti_diagonal"] == {"4 warps, wide": 2000.0, "4 warps, narrow": 3000.0,
                                                 "1 warps, narrow": 1000.0}


def test_tiled_timer_slots_equal_the_kernel():
    """nw_cuda.TILED_TIMER_SLOTS (the timer's size a warp, read by
    sweep_tiled_split and tiled_split) equals the one #define in
    csrc/nw_sweep_tiled.cu."""
    import re
    from pathlib import Path

    src = (Path(nw_cuda.__file__).parent / "csrc" / "nw_sweep_tiled.cu").read_text()
    assert re.findall(r"^#define TILED_TIMER_SLOTS (\d+)$", src, re.M) == [str(nw_cuda.TILED_TIMER_SLOTS)]
