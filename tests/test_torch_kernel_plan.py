"""The port's kernel launch planning, checked on the CPU.

* ``plan_sweep`` (ops/nw_cuda.py) for every batch size and band the runner
  can dispatch: within the card's limits (1,024 threads, 232,448 bytes of
  shared memory a block), and every pair and every lane covered exactly
  once.
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
from seqrush_tpu_torch.ops import nw, nw_cuda
from seqrush_tpu_torch.ops.nw import OP_D, OP_I, OP_M, _i0_of
from seqrush_tpu_torch.sequences import make_sequence_set

MAX_THREADS = 1024
MAX_SMEM = 232448
MAX_W = 5376  # band 5,375


def _batch_ladder(limit=4096):
    out = sorted({WfaAligner._quantize_batch(n) for n in range(1, limit + 1)})
    return [b for b in out if b <= limit]


def _check_plan(plan, B, W, Lq, Lt):
    assert plan.threads <= MAX_THREADS and plan.threads % 32 == 0
    assert plan.smem_bytes <= MAX_SMEM
    assert plan.blocks * plan.pairs_per_block >= B
    assert (plan.blocks - 1) * plan.pairs_per_block < max(B, 1)
    if plan.route == "wide":
        assert plan.lanes == 0 and plan.pairs_per_block == 1 and plan.blocks == B
        assert plan.threads == min(MAX_THREADS, -(-W // 32) * 32)
        # the DP rows in shared memory where 11 rows of W int32 fit
        assert plan.smem_bytes == (44 * W if 44 * W <= MAX_SMEM else 0)
        return
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
                b, lanes = blk, range(tid, W, plan.threads)
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
    route above the widest register strip, and the wide route's rows
    leaving shared memory above W = 5,282."""
    for B, W, lanes, wpp in ((576, 128, 4, 1), (576, 256, 4, 2), (576, 384, 4, 3),
                             (576, 512, 4, 4), (144, 768, 12, 2), (144, 1280, 12, 4),
                             (144, 1536, 12, 4), (48, 1536, 12, 4), (48, 3072, 12, 8),
                             (48, 4096, 16, 8)):
        p = nw_cuda.plan_sweep(B, W, 3584, 3584)
        assert (p.route, p.lanes, p.warps_per_pair) == ("regs", lanes, wpp), (B, W)
    assert nw_cuda.plan_sweep(8, nw_cuda.REG_MAX_W, 4864, 4864).route == "regs"
    assert nw_cuda.plan_sweep(8, nw_cuda.REG_MAX_W + 1, 4864, 4864).route == "wide"
    assert nw_cuda.plan_sweep(8, 5282, 5376, 5376).smem_bytes == 44 * 5282
    assert nw_cuda.plan_sweep(8, 5283, 5376, 5376).smem_bytes == 0
    with pytest.raises(ValueError):
        nw_cuda.plan_sweep(8, 2048, 2048, 2048, warps_per_pair=1)
    with pytest.raises(ValueError):  # a second warp of ghost lanes only
        nw_cuda.plan_sweep(8, 100, 256, 256, warps_per_pair=2)


def test_register_route_penalties():
    """The register route's keyed arithmetic needs penalties in [0, 2^16);
    one-piece scoring leaves o2/e2 (negative) out."""
    assert nw_cuda.register_route_penalties(5, 8, 2, 24, 1)
    assert nw_cuda.register_route_penalties(5, 8, 2, -1, -1)
    assert not nw_cuda.register_route_penalties(-1, 8, 2, 24, 1)
    assert not nw_cuda.register_route_penalties(5, 1 << 16, 2, 24, 1)
    assert not nw_cuda.register_route_penalties(5, 8, 2, 24, 1 << 16)


def _walk_cells(ops, qlen, tlen, K):
    """The (anti-diagonal, lane) cells the walk visits, rebuilt from its
    opcodes (one opcode per visited cell, at column td)."""
    i, j = qlen, tlen
    cells = []
    for td in range(ops.size - 1, 0, -1):
        op = int(ops[td])
        if op == 0:
            continue
        assert td == i + j, "an opcode off the cursor's anti-diagonal"
        cells.append((td, i - _i0_of(td, K)))
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


def _walk(Q, T, ql, tl, band, two_piece):
    tmax = int((ql + tl).max())
    kw = dict(mismatch=5, o1=8, e1=2, o2=24 if two_piece else -1, e2=1 if two_piece else -1,
              band=band, tmax=tmax)
    args = [torch.from_numpy(a) for a in (Q, T, ql, tl)]
    _scores, tb = nw_cuda.nw_align(*args, **kw)
    ops = nw_cuda.nw_walk(tb, args[2], args[3], band=band, tmax=tmax).numpy()
    return [_walk_cells(ops[b], int(ql[b]), int(tl[b]), band) for b in range(Q.shape[0])]


def _tile_loads(cells, R, C, K):
    """Tiles the walk kernel loads on demand (csrc/nw_walk.cu): it keeps a
    tile of R rows x C lanes and prefetches the R rows below it, each centred
    on the lanes a path of matches would take."""

    def drift(top):
        rows = min(top, K) - max(top - R, 0)
        return rows // 2 if rows > 0 else 0

    top, c0, ntop, nc0, demand = -1, 0, -1, 0, 0
    for td, lane in cells:
        if not (top - R < td <= top and c0 <= lane < c0 + C):
            if not (ntop - R < td <= ntop and nc0 <= lane < nc0 + C):
                demand += 1
                ntop, nc0 = td, lane - min(drift(td) // 2 + C // 2, C - 1)
            top, c0 = ntop, nc0
            assert top - R < td <= top and c0 <= lane < c0 + C
            ntop = top - R
            nc0 = lane - drift(td) - drift(ntop) // 2 - C // 2
    return demand


@pytest.mark.parametrize("seed,band,two_piece", [(0, 15, True), (1, 31, True), (2, 48, False), (3, 100, True)])
def test_walk_cursor_moves_one_lane_per_antidiagonal(seed, band, two_piece):
    """The lane moves by at most one per anti-diagonal, so a tile of R rows
    and 2R lanes centred on the cursor is left only through its last row."""
    rng = np.random.default_rng(seed)
    R, _C = nw_cuda.WALK_TILE
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
    """Along SNPs and gaps shorter than half the tile's lanes the prefetched
    tile always holds the cursor: only the first tile is a demand load."""
    rng = np.random.default_rng(seed)
    R, C = nw_cuda.WALK_TILE
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
    for cells in _walk(Q, T, ql, tl, 63, two_piece):
        assert _tile_loads(cells, R, C, 63) == 1


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

