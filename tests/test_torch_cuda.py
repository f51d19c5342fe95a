"""Kernels A and B (their runs, int16, snapshot, start and tiled modes too), the
row-major kernels C and D, the wavefront kernel, the fold's combine, the
SGD tick and the union-find on the card against their plain versions (the
tick against the plain tick run on the CPU), and the pipeline on cuda
against cpu.  Marked ``cuda``; each test skips without a
CUDA device.  This file imports nothing of JAX, so it runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from seqrush_tpu_torch import cli
from seqrush_tpu_torch.ops import nw_cuda, wfa
from seqrush_tpu_torch.ops import unionfind as uf
from seqrush_tpu_torch.tools.headline import synth_flush_edges
from seqrush_tpu_torch.tools.sweep_shapes import masked_rows_err
from torch_edge_corpora import INT16_EDGE_PENALTIES, int16_edge_corpus, rows_edge_corpus, walk_gap_pairs
from torch_uf_cases import pre_unite_edges, uf_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pack(qs, ts, device):
    """Pairs packed as the runner packs them (lengths rounded up to 256,
    tmax to 512), padded to a batch of len(qs) rows."""
    B = len(qs)
    lq = max(-(-max(q.size for q in qs) // 256) * 256, 256)
    lt = max(-(-max(t.size for t in ts) // 256) * 256, 256)
    Q = np.full((B, lq), 6, np.uint8)
    T = np.full((B, lt), 7, np.uint8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        Q[b, : q.size] = q
        T[b, : t.size] = t
    ql = np.array([q.size for q in qs], np.int32)
    tl = np.array([t.size for t in ts], np.int32)
    tmax = max(-(-int((ql + tl).max()) // 512) * 512, 512)
    return [torch.from_numpy(a).to(device) for a in (Q, T, ql, tl)], tmax


def _variants(rng, B, L, band, inv_frac):
    """B-1 variant pairs of length ~L (SNPs, a deletion or an insertion, an
    inversion on every other pair) plus one zero-length padding row."""
    qs, ts = [], []
    for k in range(B - 1):
        q = rng.integers(0, 4, L).astype(np.uint8)
        t = q.copy()
        t[rng.integers(0, L, L // 50)] = rng.integers(0, 4, L // 50)
        if k % 3 == 1:
            t = np.delete(t, np.arange(L // 3, L // 3 + 17))
        if k % 3 == 2:
            t = np.insert(t, L // 2, rng.integers(0, 4, 11).astype(np.uint8))
        if inv_frac and k % 2:
            a, b = int(L * 0.3), int(L * (0.3 + inv_frac))
            t[a:b] = (3 - t[a:b])[::-1]
        qs.append(q)
        ts.append(t)
    return qs + [np.zeros(0, np.uint8)], ts + [np.zeros(0, np.uint8)]


def _ties(rng, B, L, band, inv_frac):
    """Tie-heavy pairs: identical sequences, homopolymer runs of unequal
    length, and short tandem repeats, where many paths share one score."""
    qs, ts = [], []
    for k in range(B - 1):
        kind = k % 4
        if kind == 0:
            q = rng.integers(0, 4, L).astype(np.uint8)
            t = q.copy()
        elif kind == 1:
            q = np.zeros(L, np.uint8)
            t = np.zeros(L - 1 - k % 7, np.uint8)
        elif kind == 2:
            q = np.tile(np.array([0, 1], np.uint8), L // 2)
            t = np.tile(np.array([0, 1], np.uint8), L // 2 - 3)
        else:
            q = np.repeat(rng.integers(0, 4, L // 8).astype(np.uint8), 8)
            t = np.repeat(rng.integers(0, 4, L // 8).astype(np.uint8), 7)
        qs.append(q)
        ts.append(t)
    return qs + [np.zeros(0, np.uint8)], ts + [np.zeros(0, np.uint8)]


def _edges(rng, B, L, band, inv_frac):
    """Length differences around the band, both ways: the path runs along
    lane 0 or lane W - 1, and past it the final cell leaves the band (score
    -1) and the walk starts outside [0, W)."""
    qs, ts = [], []
    for k in range(B - 1):
        d = (band - 1, band, band + 1, band + 2, 2 * band + 5)[k % 5]
        q = rng.integers(0, 4, L).astype(np.uint8)
        t = np.concatenate([q, rng.integers(0, 4, d).astype(np.uint8)])
        if k % 2:
            q, t = t, q
        qs.append(q)
        ts.append(t)
    return qs + [np.zeros(0, np.uint8)], ts + [np.zeros(0, np.uint8)]


def _gaps(rng, B, L, band, inv_frac):
    """The walk gap corpus (tests/torch_edge_corpora.py::walk_gap_pairs,
    18 pairs ending in a zero-length row): gap runs of 1 to 200 steps, in
    the band's corner and out to its edges, walks ending inside a gap."""
    pairs = walk_gap_pairs()
    return [q for q, _ in pairs], [t for _, t in pairs]


def _penalties(two_piece, band, tmax):
    return dict(mismatch=5, o1=8, e1=2, o2=24 if two_piece else -1,
                e2=1 if two_piece else -1, band=band, tmax=tmax)


@pytest.mark.parametrize(
    "kind,B,L,band,two_piece,inv",
    [
        ("variants", 8, 300, 127, True, 0.0),
        ("variants", 8, 300, 63, False, 0.0),
        ("variants", 16, 1200, 383, True, 0.2),
        ("variants", 8, 1500, 1535, True, 0.4),
        ("variants", 4, 700, 5375, True, 0.3),  # wide route: 16 CTAs a pair, 4 lanes a thread
        ("variants", 4, 700, 5281, True, 0.3),  # W 5282: 96 threads a CTA, two of them whole warps
        ("variants", 4, 700, 5282, False, 0.3),  # W 5283: W not a multiple of the strip, byte stores
        ("variants", 8, 200, 0, True, 0.0),  # W 1
        ("variants", 8, 300, 31, True, 0.0),
        ("variants", 8, 300, 32, True, 0.0),
        ("variants", 8, 300, 33, True, 0.0),
        ("variants", 8, 300, 100, True, 0.0),  # W not a multiple of 4
        ("variants", 9, 300, 100, False, 0.0),  # B not a multiple of pairs per block
        ("variants", 13, 600, 511, False, 0.0),  # one-piece at the main band
        ("variants", 4, 700, 4095, True, 0.3),  # W 4096: the widest register route
        ("variants", 4, 700, 4096, True, 0.3),  # W 4097: the first wide-route band
        ("variants", 8, 300, 127, False, 0.0),  # W 128: one warp of 4 lanes, 4 pairs a block
        ("variants", 8, 300, 128, True, 0.0),  # W 129: two warps
        ("variants", 8, 600, 512, True, 0.2),  # W 513: 8 lanes
        ("variants", 8, 600, 1023, False, 0.2),  # W 1024: the widest 8-lane strip
        ("variants", 8, 600, 1024, True, 0.2),  # W 1025: 12 lanes
        ("variants", 8, 700, 1536, True, 0.3),  # W 1537: 16 lanes
        ("variants", 4, 700, 2047, True, 0.3),  # W 2048: four warps of 16 lanes
        ("variants", 4, 700, 2048, False, 0.3),  # W 2049: 12 lanes, six warps
        ("ties", 9, 400, 127, True, 0.0),
        ("ties", 9, 400, 100, False, 0.0),
        ("edges", 11, 300, 31, True, 0.0),
        ("edges", 11, 300, 100, True, 0.0),
        ("gaps", 18, 0, 199, True, 0.0),  # the opcode walk's gap ballots
        ("gaps", 18, 0, 199, False, 0.0),
        ("gaps", 18, 0, 127, True, 0.0),  # runs past the band's edges
    ],
)
def test_kernels_equal_plain_versions(cuda, kind, B, L, band, two_piece, inv):
    """Exact equality (integers): scores, the whole traceback tensor, opcodes."""
    rng = np.random.default_rng(band + B)
    make = {"variants": _variants, "ties": _ties, "edges": _edges, "gaps": _gaps}[kind]
    (Q, T, ql, tl), tmax = _pack(*make(rng, B, L, band, inv), cuda)
    kw = _penalties(two_piece, band, tmax)
    before = dict(nw_cuda.LAUNCHES)
    s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    ops_k = nw_cuda.nw_walk(tb_k, ql, tl, band=band, tmax=tmax)
    torch.cuda.synchronize()
    key = "nw_sweep_wide" if band + 1 > nw_cuda.REG_MAX_W else "nw_sweep"
    assert nw_cuda.LAUNCHES[key] == before[key] + 1
    assert nw_cuda.LAUNCHES["nw_walk"] == before["nw_walk"] + 1
    s_p, tb_p = nw_cuda.nw_align_reference(Q, T, ql, tl, **kw)
    ops_p = nw_cuda.nw_walk_reference(tb_k, ql, tl, band=band, tmax=tmax)
    assert torch.equal(s_k, s_p)
    assert int(s_k[-1]) == -1
    assert torch.equal(tb_k, tb_p)
    assert torch.equal(ops_k, ops_p)


@pytest.mark.parametrize(
    "band,plan,two_piece",
    [
        (511, 1, True),  # 16 lanes a thread
        (511, 2, True),  # 8
        (511, 4, False),  # 4
        (1535, 4, True),  # 12
        (100, 1, False),  # 4 lanes, 4 pairs a block
        (1535, 3, False),
        (1535, 6, True),
        (3071, 6, True),  # 16 lanes, 6 warps
        (511, "wide", True),  # the wide route's pick: 4 CTAs of a lane a thread
        (511, "scratch", False),  # the wide route as a chain: 4 clusters of 2 CTAs, 4 lanes a thread
    ],
)
def test_sweep_launch_shapes_equal_plain(cuda, band, plan, two_piece):
    """Every launch shape the planner can pick (lanes per thread, warps per
    pair, the wide route) gives the plain version's scores and traceback
    exactly."""
    rng = np.random.default_rng(band)
    (Q, T, ql, tl), tmax = _pack(*_variants(rng, 7, 600, band, 0.0), cuda)
    kw = _penalties(two_piece, band, tmax)
    B, W = Q.shape[0], band + 1
    if plan == "wide":
        p = nw_cuda.wide_plan(B, W)
    elif plan == "scratch":
        p = nw_cuda.wide_plan(B, W, lanes=4, ctas=8, cluster=2)
    else:
        p = nw_cuda.plan_sweep(B, W, Q.shape[1], T.shape[1], warps_per_pair=plan)
    s_k, tb_k = nw_cuda.sweep_launch(Q, T, ql, tl, p, **kw)
    torch.cuda.synchronize()
    s_p, tb_p = nw_cuda.nw_align_reference(Q, T, ql, tl, **kw)
    assert torch.equal(s_k, s_p)
    assert torch.equal(tb_k, tb_p)


def test_penalties_outside_register_range_take_wide_route(cuda):
    """Penalties outside [0, 2^16) (here a gap open of 70,000 and a negative
    mismatch) go to the wide route and still equal the plain version."""
    rng = np.random.default_rng(5)
    (Q, T, ql, tl), tmax = _pack(*_variants(rng, 5, 300, 63, 0.0), cuda)
    for pen in (dict(mismatch=5, o1=70000, e1=2, o2=24, e2=1),
                dict(mismatch=-3, o1=8, e1=2, o2=-1, e2=-1)):
        kw = dict(pen, band=63, tmax=tmax)
        s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
        torch.cuda.synchronize()
        s_p, tb_p = nw_cuda.nw_align_reference(Q, T, ql, tl, **kw)
        assert torch.equal(s_k, s_p)
        assert torch.equal(tb_k, tb_p)
    plan = nw_cuda.plan_sweep(Q.shape[0], 64, Q.shape[1], T.shape[1])
    with pytest.raises(ValueError):
        nw_cuda.sweep_launch(Q, T, ql, tl, plan, mismatch=-3, o1=8, e1=2, o2=-1, e2=-1,
                             band=63, tmax=tmax)


def _window_chunk(rng, n, mx, device):
    """n divergence-core windows of up to mx bases a side (an inverted
    block, SNPs, unequal lengths) packed as the anchored route packs a
    device window chunk at full band: B a power of two >= 8 (padding rows of
    length 0), Lq and Lt multiples of 128, tmax of 256, W = mx + 2."""
    from seqrush_tpu_torch.align import anchored

    jobs = []
    for k in range(n):
        q = rng.integers(0, 4, mx - (int(rng.integers(0, 40)) if k else 0)).astype(np.uint8)
        t = (3 - q[::-1]).copy()
        t[rng.integers(0, t.size, t.size // 40)] = rng.integers(0, 4, t.size // 40)
        if k % 2:
            t = t[: t.size - int(rng.integers(1, 30))]
        jobs.append((q, t, (k, False, 0, 0)))
    chunk = [(j, anchored._initial_window_band(q, t)) for j, (q, t, _s) in enumerate(jobs)]
    Q, T, ql, tl, band, tmax = anchored.pack_windows(jobs, chunk, max(b for _j, b in chunk))
    return [torch.from_numpy(a).to(device) for a in (Q, T, ql, tl)], band, tmax


@pytest.mark.parametrize("n,mx,two_piece", [(6, 300, True), (7, 701, False), (5, 1100, True),
                                            (3, 1149, True)])
def test_kernels_equal_plain_versions_at_window_shapes(cuda, n, mx, two_piece):
    """The anchored route's device window chunks: W is rarely a multiple of
    4, Lq and Lt are multiples of 128 and tmax of 256, and the padding rows
    are empty.  Scores, the traceback and the opcodes equal the plain
    versions exactly."""
    rng = np.random.default_rng(mx)
    (Q, T, ql, tl), band, tmax = _window_chunk(rng, n, mx, cuda)
    B = Q.shape[0]
    assert B >= 8 and B & (B - 1) == 0 and int((ql == 0).sum()) == B - n
    assert Q.shape[1] % 128 == 0 and T.shape[1] % 128 == 0 and tmax % 256 == 0
    assert band == mx + 1
    kw = _penalties(two_piece, band, tmax)
    s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    ops_k = nw_cuda.nw_walk(tb_k, ql, tl, band=band, tmax=tmax)
    torch.cuda.synchronize()
    s_p, tb_p = nw_cuda.nw_align_reference(Q, T, ql, tl, **kw)
    ops_p = nw_cuda.nw_walk_reference(tb_k, ql, tl, band=band, tmax=tmax)
    assert torch.equal(s_k, s_p) and (s_k[:n] >= 0).all()
    assert torch.equal(tb_k, tb_p)
    assert torch.equal(ops_k, ops_p)


@pytest.mark.parametrize("band,two_piece", [(511, True), (1535, False), (1101, True), (4607, True)])
def test_score_only_sweep_equals_full_sweep(cuda, band, two_piece):
    """with_traceback=False (the verify sweep) launches the score-only
    kernel, on the register route and on the wide route (W > 4,096): the
    scores equal the full launch's and the plain version's; no traceback."""
    rng = np.random.default_rng(band)
    (Q, T, ql, tl), tmax = _pack(*_variants(rng, 7, 1500, band, 0.3), cuda)
    kw = _penalties(two_piece, band, tmax)
    assert nw_cuda.plan_sweep(Q.shape[0], band + 1, Q.shape[1], T.shape[1]).route == (
        "wide" if band + 1 > nw_cuda.REG_MAX_W else "regs")
    s_full, _tb = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    before = dict(nw_cuda.LAUNCHES)
    s_only, none = nw_cuda.nw_align(Q, T, ql, tl, with_traceback=False, **kw)
    torch.cuda.synchronize()
    assert none is None
    key = "nw_sweep_wide" if band + 1 > nw_cuda.REG_MAX_W else "nw_sweep_score_only"
    assert nw_cuda.LAUNCHES[key] == before[key] + 1
    assert nw_cuda.LAUNCHES["nw_sweep"] == before["nw_sweep"]
    s_p, _ = nw_cuda.nw_align_reference(Q, T, ql, tl, with_traceback=False, **kw)
    assert torch.equal(s_only, s_full)
    assert torch.equal(s_only, s_p)


# -- kernel A's wide route (csrc/nw_sweep_wide.cuh): a cluster of CTAs a pair


def _wide_batch(cuda, B, L, band, seed):
    """B - 1 variant pairs of ~L bases with ragged lengths (an inversion on
    every other pair) and a zero-length row."""
    return _pack(*_variants(np.random.default_rng(seed), B, L, band, 0.3), cuda)


@pytest.mark.parametrize(
    "band,B,L,two_piece,forced",
    [
        (4096, 5, 2500, True, None),  # W 4097: 16 CTAs of 288 threads, a lane a thread
        (8192, 4, 2500, False, None),  # W 8193: 2 lanes a thread, not a multiple of the strip (byte stores)
        (4096, 2, 2500, True, (1, 48, 16)),  # a chain of 3 clusters of 16, a lane a thread
        (4096, 4, 2500, False, (2, 16, 4)),  # a chain of 4 clusters of 4
        (8192, 3, 5200, True, (4, 32, 16)),  # a chain of 2 clusters of 16 across which the cells run
        (127, 9, 600, True, (1, 1, 1)),  # a narrow band: one CTA a pair, a lane a thread (solo)
        (200, 5, 500, False, (1, 1, 1)),  # solo, 7 warps, the last one's lanes partly past W
        (20, 6, 300, True, (1, 1, 1)),  # solo on one warp, 11 lanes past W
        (127, 9, 600, False, (4, 1, 1)),  # one warp of 4 lanes a pair
    ],
)
def test_wide_route_equals_plain(cuda, band, B, L, two_piece, forced):
    """The wide route, full and score-only: scores and every traceback row
    bit-equal to the plain version, at the planner's pick and at forced
    lanes, CTAs and clusters; one nw_sweep_wide launch each."""
    (Q, T, ql, tl), tmax = _wide_batch(cuda, B, L, band, band + B)
    kw = _penalties(two_piece, band, tmax)
    W = band + 1
    if forced is None:
        plan = nw_cuda.plan_sweep(B, W, Q.shape[1], T.shape[1])
    else:
        lanes, ctas, cluster = forced
        plan = nw_cuda.wide_plan(B, W, lanes=lanes, ctas=ctas, cluster=cluster)
    assert plan.route == "wide"
    before = dict(nw_cuda.LAUNCHES)
    s_k, tb_k = nw_cuda.sweep_launch(Q, T, ql, tl, plan, **kw)
    s_o, none = nw_cuda.sweep_launch(Q, T, ql, tl, plan, with_traceback=False, **kw)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_sweep_wide"] == before["nw_sweep_wide"] + 2
    assert all(nw_cuda.LAUNCHES[k] == before[k] for k in ("nw_sweep", "nw_sweep_score_only"))
    s_p, tb_p = nw_cuda.nw_align_reference(Q, T, ql, tl, **kw)
    assert none is None and torch.equal(s_k, s_p) and torch.equal(s_o, s_p)
    assert torch.equal(tb_k, tb_p)
    assert (s_k[:-1] >= 0).all() and int(s_k[-1]) == -1


@pytest.mark.parametrize(
    "pen,int16,arith",
    [
        (dict(mismatch=5, o1=70_000, e1=2, o2=24, e2=1), False, "plain"),  # a gap open past 2^16
        (dict(mismatch=-3, o1=8, e1=2, o2=-1, e2=-1), False, "plain"),  # a negative mismatch, one-piece
        (dict(mismatch=5, o1=8, e1=2, o2=24, e2=1), False, "keyed"),  # the register route's penalties
        (dict(mismatch=5, o1=8, e1=2, o2=-1, e2=-1), False, "keyed"),
        (dict(mismatch=5, o1=8, e1=2, o2=3000, e2=1), True, "keyed16"),  # int16 adds that wrap
    ],
)
def test_wide_arith_equals_plain(cuda, pen, int16, arith):
    """Each cell arithmetic of the wide route (nw_cuda.wide_arith: plain
    compares, unsigned keys, the int16 mode's signed keys) on a pair's two
    CTAs and on one CTA at a lane a thread (the solo kernels): single-shot
    scores and every traceback row, and in int32 a segment's carry, scores
    and rows, bit-equal to the plain versions."""
    assert nw_cuda.wide_arith(**pen, int16=int16) == {
        "plain": nw_cuda.WIDE_PLAIN, "keyed": nw_cuda.WIDE_KEYED, "keyed16": nw_cuda.WIDE_KEYED16}[arith]
    band = 299
    (Q, T, ql, tl), tmax = _pack(*_variants(np.random.default_rng(31), 6, 700, band, 0.3), cuda)
    B, W = Q.shape[0], band + 1
    kw = dict(pen, band=band, tmax=tmax, int16=int16)
    assert nw_cuda.wide_plan(B, W).solo
    s_p, tb_p = nw_cuda.nw_align_reference(Q, T, ql, tl, **kw)
    for plan in (nw_cuda.wide_plan(B, W, lanes=1, ctas=2, cluster=2), nw_cuda.wide_plan(B, W)):
        s_k, tb_k = nw_cuda.sweep_launch(Q, T, ql, tl, plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(s_k, s_p) and torch.equal(tb_k, tb_p)
    if int16:
        return
    seg = 512
    carry = nw_cuda.initial_carry(B, W, cuda)
    scores = torch.full((B,), -1, dtype=torch.int32, device=cuda)
    seg_kw = dict(pen, band=band, t0=seg, seg=seg)
    c_p, s_p, tb_p = nw_cuda.nw_align_segment_reference(Q, T, ql, tl, carry, scores, t0=0, seg=seg, band=band,
                                                        **pen)
    c_p2, s_p2, tb_p2 = nw_cuda.nw_align_segment_reference(Q, T, ql, tl, c_p, s_p, **seg_kw)
    for plan in (nw_cuda.wide_plan(B, W, lanes=2, ctas=2, cluster=2), nw_cuda.wide_plan(B, W)):
        before = nw_cuda.LAUNCHES["nw_sweep_wide_segment"]
        c_k, s_k, tb_k = nw_cuda.segment_launch(Q, T, ql, tl, c_p, s_p, plan, **seg_kw)
        torch.cuda.synchronize()
        assert nw_cuda.LAUNCHES["nw_sweep_wide_segment"] == before + 1
        assert torch.equal(c_k, c_p2) and torch.equal(s_k, s_p2) and torch.equal(tb_k, tb_p2)


def test_wide_route_chain_by_planner_equals_plain(cuda):
    """A band the planner gives a chain of clusters (W 24,577: 32 CTAs of 4
    lanes, two clusters of 16, 12,288 lanes each), pairs long enough that
    their cells cross from one cluster to the other: scores and the whole
    traceback equal the plain version's.  A dispatch with more clusters than
    the card holds at once is launched in slices (wide_slices at the
    measured count), each pair's bytes those of its plain version."""
    band = 24_576
    (Q, T, ql, tl), tmax = _wide_batch(cuda, 3, 13_000, band, 5)
    kw = _penalties(True, band, tmax)
    plan = nw_cuda.plan_sweep(3, band + 1, Q.shape[1], T.shape[1])
    assert (plan.route, plan.lanes, plan.ctas, plan.cluster, plan.clusters) == ("wide", 4, 32, 16, 2)
    s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    torch.cuda.synchronize()
    s_p, tb_p = nw_cuda.nw_align_reference(Q, T, ql, tl, **kw)
    assert torch.equal(s_k, s_p) and torch.equal(tb_k, tb_p) and (s_k[:-1] >= 0).all()
    held = nw_cuda.wide_query(cuda, plan, True)["resident_clusters"]
    assert held >= 6
    too_many = held // 2 + 1  # pairs whose 2 clusters each exceed the card's resident clusters
    rows = torch.tensor([0, 2] * too_many, device=cuda)[:too_many]  # a long pair and the zero-length row
    many = nw_cuda.wide_plan(too_many, band + 1, ctas=32)
    assert len(nw_cuda.wide_slices(many, too_many, held)) == 2
    before = nw_cuda.LAUNCHES["nw_sweep_wide"]
    s_m, tb_m = nw_cuda.sweep_launch(Q[rows], T[rows], ql[rows], tl[rows], many, **kw)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_sweep_wide"] == before + 2
    assert torch.equal(s_m, s_p[rows]) and torch.equal(tb_m, tb_p[rows])


@pytest.mark.parametrize("long_route", [False, True])
def test_wide_chain_through_the_runner(cuda, long_route):
    """A pair whose band passes 24,576 lanes (tools/headline.py::
    long_deletion_pair: W 28,160) through WfaAligner(wide_route='full')
    without a mesh, single-shot and on the long route: the chunk holds 8
    padded pairs of two 16-CTA clusters each, more than the card holds at
    once, so each wide-route dispatch is launched in slices; the score is
    the one 28 kb gap's and the single-shot and long routes give the same
    alignment."""
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
    from seqrush_tpu_torch.sequences import make_sequence_set
    from seqrush_tpu_torch.tools.headline import long_deletion_pair, long_deletion_score

    seqs = make_sequence_set(long_deletion_pair())
    extra = {"long_pair_threshold": 16_384} if long_route else {}
    cfg = RunnerConfig(wide_route="full", **extra)
    al = WfaAligner(seqs, cfg, device="cuda")
    nw_cuda.reset_launch_counts()
    (res,) = al.align_pairs(np.array([[0, 1]]))
    torch.cuda.synchronize()
    assert res is not None and res.score == long_deletion_score(cfg.scores) and not res.is_reverse
    ops = {}
    for n, op in res.cigar:
        ops[op] = ops.get(op, 0) + n
    assert ops == {"=": 2000, "I": 28_000}  # the two flanks matched, the deleted 28 kb one gap
    disp = [d for d in al.stats["dispatches"] if d["kind"] == ("long" if long_route else "chunk")]
    assert disp and all(d["band"] + 1 > 24_576 and d["B"] == 8 and d.get("sweep") == "wide" for d in disp)
    if long_route:
        assert nw_cuda.LAUNCHES["nw_sweep_wide_segment"] > 2  # the forward run's slices and the groups'
        single = WfaAligner(seqs, RunnerConfig(wide_route="full"), device="cuda")
        (one,) = single.align_pairs(np.array([[0, 1]]))
        assert (one.score, one.is_reverse, one.cigar) == (res.score, res.is_reverse, res.cigar)
    else:
        assert nw_cuda.LAUNCHES["nw_sweep_wide"] > len(disp)  # sliced


def test_wide_route_long_sequences_equal_plain(cuda):
    """Sequences beyond the register route's shared memory ([8, W 128,
    Lq = Lt = 120,064], the runner's long gap and inversion windows): the
    bases come from the rings, so the wide route takes them; scores and
    the whole traceback equal the plain version's."""
    rng = np.random.default_rng(120)
    qs, ts = [], []
    for k in range(7):
        n = (20_000, 3_000, 17_000, 900, 12_000, 5, 8_000)[k]
        q = rng.integers(0, 4, n).astype(np.uint8)
        t = q.copy()
        t[rng.integers(0, n, n // 30 + 1)] = rng.integers(0, 4, n // 30 + 1)
        if k % 2:
            t = np.delete(t, np.arange(n // 2, n // 2 + min(40, n // 3)))
        qs.append(q)
        ts.append(t)
    (Q, T, ql, tl), tmax = _pack(qs + [np.zeros(0, np.uint8)], ts + [np.zeros(0, np.uint8)], cuda)
    Qp = torch.full((8, 120_064), 6, dtype=torch.uint8, device=cuda)
    Tp = torch.full((8, 120_064), 7, dtype=torch.uint8, device=cuda)
    Qp[:, : Q.shape[1]], Tp[:, : T.shape[1]] = Q, T
    kw = _penalties(True, 127, tmax)
    assert nw_cuda.plan_sweep(8, 128, 120_064, 120_064).route == "wide"
    s_k, tb_k = nw_cuda.nw_align(Qp, Tp, ql, tl, **kw)
    torch.cuda.synchronize()
    s_p, tb_p = nw_cuda.nw_align_reference(Qp, Tp, ql, tl, **kw)
    assert torch.equal(s_k, s_p) and torch.equal(tb_k, tb_p) and (s_k[:-1] >= 0).all()


@pytest.mark.parametrize("band,two_piece", [(4200, True), (4200, False)])
def test_wide_long_route_equals_single_shot(cuda, band, two_piece):
    """The long route at a band above REG_MAX_W runs the wide route's
    segment mode (forward runs and the grouped recompute, nw_sweep_wide_
    segment): its scores and opcodes equal the single-shot wide kernel's
    walked by kernel B, and the segment launches equal their plain versions
    on the way (test_segment_group_kernels_equal_plain_versions)."""
    (Q, T, ql, tl), tmax = _wide_batch(cuda, 4, 2600, band, band)
    kw = _penalties(two_piece, band, tmax)
    kw.pop("tmax")
    t_need = int((ql + tl).max())
    nw_cuda.reset_launch_counts()
    scores, ops = nw_cuda.nw_align_long(Q, T, ql, tl, seg=1024, t_need=t_need, **kw)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_sweep_wide_segment"] >= 2
    assert nw_cuda.LAUNCHES["nw_sweep_segment_score_only"] == nw_cuda.LAUNCHES["nw_sweep_segment_group"] == 0
    s_one, tb = nw_cuda.nw_align(Q, T, ql, tl, tmax=tmax, **kw)
    ops_one = nw_cuda.nw_walk(tb, ql, tl, band=band, tmax=tmax)
    assert torch.equal(scores, s_one)
    assert torch.equal(ops[:, : t_need + 1], ops_one[:, : t_need + 1])


def test_host_library_equals_python_chain(cuda):
    """The host library builds with g++ on the card's host, and its chain
    equals the Python chain on seeded anchor sets."""
    from seqrush_tpu_torch import native
    from seqrush_tpu_torch.ops import anchors

    rng = np.random.default_rng(8)
    sets = []
    for k in range(12):
        n = int(rng.integers(1, 150))
        q = np.sort(rng.choice(5000, size=n, replace=False))
        t = np.where(rng.random(n) < 0.2, rng.integers(0, 5000, n), q + 30)
        sets.append(np.unique(np.stack([q, t], axis=1), axis=0).astype(np.int64))
    offs = np.cumsum([0] + [a.shape[0] for a in sets]).astype(np.int64)
    flat = np.concatenate(sets)
    chain_pair, chain_off, rq, rt, rl = native.chain_pairs_native(
        flat[:, 0].copy(), flat[:, 1].copy(), offs, 15, max_gap=anchors.DEFAULT_MAX_GAP,
        max_skew=anchors.DEFAULT_MAX_SKEW, max_chains=1, min_matched=0)
    assert chain_pair.tolist() == list(range(len(sets)))
    for c, a in enumerate(sets):
        got = list(zip(*(x[chain_off[c]:chain_off[c + 1]].tolist() for x in (rq, rt, rl))))
        assert got == anchors.chain_to_runs(anchors.chain_anchors(a), 15)


def test_pipeline_cuda_equals_cpu(cuda, tmp_path):
    """The same FASTA gives byte-identical GFA on cuda and on cpu."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, 900)
    fa = tmp_path / "in.fa"
    recs = []
    for k in range(4):
        v = base.copy()
        v[rng.integers(0, v.size, 15)] = rng.integers(0, 4, 15)
        if k == 3:
            v = np.delete(v, np.arange(300, 320))
        recs.append(b">s%d\n%s\n" % (k, np.frombuffer(b"ACGT", np.uint8)[v].tobytes()))
    fa.write_bytes(b"".join(recs))
    out = {}
    for dev in ("cuda", "cpu"):
        gfa = tmp_path / f"{dev}.gfa"
        assert cli.main(["-s", str(fa), "-o", str(gfa), "--no-sort", "--device", dev]) == 0
        out[dev] = gfa.read_bytes()
    assert out["cuda"] == out["cpu"]


def _chain_graph(seed, n_nodes=400, n_paths=6):
    """A backbone of short segments under shuffled ids, each path skipping a
    few segments: enough terms for the SGD, no alignment needed."""
    from seqrush_tpu_torch.graph.bigraph import BidirectedGraph

    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(1, n_nodes + 1))
    g = BidirectedGraph()
    for nid in ids:
        g.add_node(int(nid), bytes(rng.choice(list(b"ACGT"), size=int(rng.integers(1, 9))).astype(np.uint8)))
    for p in range(n_paths):
        keep = rng.random(n_nodes) > 0.05
        g.add_path(f"p{p}", ids[keep].astype(np.int64) << 1)
    g.verify_path_edges()
    return g


def test_sgd_tick_on_cuda_close_to_cpu_and_reproducible(cuda):
    """The same draws through sgd_tick on cuda and on cpu: after one
    iteration the positions agree within 1e-3 bp (float32 sums in another
    order), and two cuda runs are bit-equal (the sums' order is fixed)."""
    from seqrush_tpu_torch.layout import sgd

    g = _chain_graph(4)
    params = sgd.PathSGDParams()
    on_cpu, on_gpu = sgd.sgd_setup(g, params, "cpu"), sgd.sgd_setup(g, params, "cuda")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    draws = sgd.draw_block(gen, on_cpu.n_sub, on_cpu.u_per_sub, on_cpu.n_steps)

    def run(plan):
        x = plan.x0
        for k in range(plan.n_sub):
            x = sgd.sgd_tick(x, 0, *(d[k].to(x.device) for d in draws), plan.tables)
        return x.cpu()

    a, b, c = run(on_gpu), run(on_gpu), run(on_cpu)
    assert torch.equal(a, b)
    assert torch.isfinite(a).all()
    assert (a - c).abs().max().item() <= 1e-3
    first = sgd.path_linear_sgd(g, params, "cuda")
    assert sgd.path_linear_sgd(g, params, "cuda") == first


def _variation_graph(seed, n_nodes=120, n_paths=5):
    """tests/test_torch_graph_order.py::variation_gfa's graph (skipped
    segments, SNP bubbles, an inverted block, a tandem repeat, segments
    stored reverse-complemented), built with the port's BidirectedGraph."""
    from seqrush_tpu_torch.graph.bigraph import BidirectedGraph

    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(1, 2 * n_nodes + 1))
    main, alt = ids[:n_nodes], ids[n_nodes:]
    has_alt = rng.random(n_nodes) < 0.2
    stored_rev = rng.random(n_nodes) < 0.1
    g = BidirectedGraph()
    for k in range(n_nodes):
        g.add_node(int(main[k]), bytes(rng.choice(list(b"ACGT"), size=int(rng.integers(1, 7))).astype(np.uint8)))
        if has_alt[k]:
            g.add_node(int(alt[k]), bytes(rng.choice(list(b"ACGT"), size=1).astype(np.uint8)))
    for p in range(n_paths):
        steps = []
        for k in range(n_nodes):
            if 0 < k < n_nodes - 1 and rng.random() < 0.05:
                continue
            if has_alt[k] and rng.random() < 0.5:
                steps.append((int(alt[k]), False))
            else:
                steps.append((int(main[k]), bool(stored_rev[k])))
        if p % 2 == 1:
            a, b = len(steps) // 3, len(steps) // 3 + int(rng.integers(4, 12))
            steps[a:b] = [(n, not r) for n, r in reversed(steps[a:b])]
        if p == 0:
            a = 2 * len(steps) // 3
            steps[a:a] = steps[a : a + 5]
        g.build_path(f"path{p}", steps)
    visited = {int(h) >> 1 for path in g.paths for h in path.steps}
    g.nodes = {n: seq for n, seq in g.nodes.items() if n in visited}
    g.verify_path_edges()
    return g


def _edge_graph(kind):
    """Graphs at the edges of the tick: a one-step path beside longer ones,
    only two-step paths, and a hub node on every path (several times each)."""
    from seqrush_tpu_torch.graph.bigraph import BidirectedGraph

    rng = np.random.default_rng(len(kind))
    if kind == "one_step":
        g = _variation_graph(4, n_nodes=60)
        g.add_path("single", np.array([g.paths[0].steps[3]]))
        return g
    g = BidirectedGraph()
    n = 40
    for nid in range(1, n + 1):
        g.add_node(nid, bytes(rng.choice(list(b"ACGT"), size=int(rng.integers(1, 6))).astype(np.uint8)))
    for p in range(12 if kind == "two_steps" else 30):
        if kind == "two_steps":
            steps = rng.choice(np.arange(1, n + 1), size=2, replace=False)
        else:
            body = rng.choice(np.arange(2, n + 1), size=20, replace=False)
            steps = np.insert(body, [0, 5, 10, 15, 20], 1)  # node 1 five times a path
        g.add_path(f"p{p}", steps.astype(np.int64) << 1)
    g.verify_path_edges()
    return g


def _held_to_cpu_ticks(g, blocks=None):
    """tools/sgd_timing.py::cpu_parity on g: the tick kernel on the card
    against the plain tick on the CPU fed the same draws, compared after
    every tick of the first ``blocks`` blocks of draws (or all), one launch
    a tick, and at the end of each of those blocks, one launch a block;
    the whole run's check adds the layout's own run, one launch a block."""
    from seqrush_tpu_torch.tools.sgd_timing import cpu_parity

    before = nw_cuda.LAUNCHES["sgd_tick"]
    par = cpu_parity(g, blocks)
    assert par["bit_equal"] and par["max_abs_err"] == 0.0, par
    assert par["launches"] == par["ticks_compared"] + par["blocks_compared"]
    n_blocks = -(-par["ticks_compared"] // par["block_ticks"])
    whole = par.get("layout_run_launches", 0)
    assert whole == (n_blocks if "layout_run_equal" in par else 0)
    assert nw_cuda.LAUNCHES["sgd_tick"] - before == par["launches"] + whole
    return par


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sgd_tick_kernel_equals_cpu_ticks_whole_run(cuda, seed):
    """Every tick of a whole run (800 ticks in one block of draws: before
    and after cooling) of the tick kernel bit-equal to the plain tick run on
    the CPU; the layout's own run on the card (sgd._sgd_run) ends at the
    same positions, and two such runs with one seed are bit-equal."""
    from seqrush_tpu_torch.layout import sgd
    from seqrush_tpu_torch.layout.ygs import YgsParams

    g = _variation_graph(seed)
    par = _held_to_cpu_ticks(g)
    params = YgsParams.from_graph(g).to_sgd()
    plan = sgd.sgd_setup(g, params, "cuda")
    assert par["ticks_compared"] == plan.n_ticks == 800 and par["layout_run_equal"]
    assert plan.tables.first_cooling_iter * plan.n_sub < plan.n_ticks
    run = lambda: sgd._sgd_run(plan.x0, plan.tables, params.seed, plan.n_steps, plan.n_sub,
                               plan.u_per_sub, plan.block_ticks)
    assert torch.equal(run().view(torch.int32), run().view(torch.int32))


@pytest.mark.parametrize("kind", ["one_step", "two_steps", "hub"])
def test_sgd_tick_kernel_equals_cpu_ticks_edge_graphs(cuda, kind):
    par = _held_to_cpu_ticks(_edge_graph(kind))
    assert par["ticks_compared"] == par["block_ticks"] == 800


def test_sgd_tick_kernel_equals_cpu_ticks_1000_paths(cuda):
    """The first block of draws (16 ticks of 262,144 terms) of the 1,000-path
    graph bit-equal to the plain tick on the CPU."""
    from seqrush_tpu_torch.tools.headline import synth_variation_graph

    par = _held_to_cpu_ticks(synth_variation_graph(), blocks=1)
    assert par["tick_width"] == 262144 and par["ticks_compared"] == par["block_ticks"] == 16


# the counting sort's plans held to the CPU on the same inputs, as budgets
# of layout/sgd.py set while the plan is made: the default (one pass by node
# id), one chunk a side (a count budget of 0 leaves the chunk at the tick's
# width or above it), digit passes of 2 bits, and both
SORT_PLANS = ({}, {"COUNT_BUDGET_BYTES": 0}, {"MAX_BINS": 4}, {"MAX_BINS": 4, "COUNT_BUDGET_BYTES": 0})


def _sort_graph(kind):
    """The sort's cases: the edge graphs, a small graph whose every node
    some term of a tick names, and a variation graph with a node on no path,
    which no term names."""
    from seqrush_tpu_torch.graph.bigraph import BidirectedGraph

    if kind in ("one_step", "two_steps", "hub"):
        return _edge_graph(kind)
    if kind == "all_named":
        g = BidirectedGraph()
        for nid in range(1, 11):
            g.add_node(nid, b"ACGT"[: 1 + nid % 4])
        for p in range(5):
            g.add_path(f"p{p}", np.roll(np.arange(1, 11), p).astype(np.int64) << 1)
        g.verify_path_edges()
        return g
    g = _variation_graph(1)
    g.add_node(max(g.nodes) + 1, b"ACG")
    return g


def _sort_plans_equal_cpu(g, n_ticks, params=None):
    """n_ticks ticks of g under each of SORT_PLANS, one launch a tick and one
    launch them all, against the plain tick on the CPU fed the same draws,
    bit for bit after every tick.  Returns the one-pass plan's last node
    counts."""
    from seqrush_tpu_torch.layout import sgd
    from seqrush_tpu_torch.layout.ygs import YgsParams

    params = params or YgsParams.from_graph(g).to_sgd()
    gpu, cpu = sgd.sgd_setup(g, params, "cuda"), sgd.sgd_setup(g, params, "cpu")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    draws = sgd.draw_block(gen, n_ticks, gpu.u_per_sub, gpu.n_steps)
    host = [d.cpu() for d in draws]
    want, xc = [], cpu.x0
    for k in range(n_ticks):
        xc = sgd.sgd_tick(xc, k // cpu.n_sub, *(d[k] for d in host), cpu.tables)
        want.append(xc.view(torch.int32))
    counts = None
    for kw in SORT_PLANS:
        with pytest.MonkeyPatch.context() as mp:
            for name, value in kw.items():
                mp.setattr(sgd, name, value)
            work = sgd.tick_work(gpu.x0.shape[0], gpu.u_per_sub, gpu.tables.space, gpu.x0.device, n_ticks)
        assert (work.plan.passes > 1) == ("MAX_BINS" in kw), work.plan
        xk = gpu.x0
        for k in range(n_ticks):
            xk = sgd.sgd_tick_cuda(xk, k // gpu.n_sub, *(d[k] for d in draws), gpu.tables, work=work)
            assert torch.equal(xk.cpu().view(torch.int32), want[k]), (kw, k)
        if not kw:
            counts = work.node_cnt.cpu()  # the last tick's
        xb = sgd.sgd_ticks_cuda(gpu.x0, 0, gpu.n_sub, draws, gpu.tables, work)
        assert torch.equal(xb.cpu().view(torch.int32), want[-1]), kw
    return counts


@pytest.mark.parametrize("kind", ["one_step", "two_steps", "hub", "all_named", "unnamed"])
def test_sgd_tick_sort_equals_cpu_ticks(cuda, kind):
    """Every tick of a whole run (800 ticks, cooling included) under each
    plan of the counting sort bit-equal to the plain tick on the CPU: on the
    edge graphs, on a graph whose every node is named in the last tick, and
    on one with a node that no term names (its position moves by +0.0)."""
    g = _sort_graph(kind)
    counts = _sort_plans_equal_cpu(g, 800)
    if kind == "all_named":
        assert (counts > 0).all()
    if kind == "unnamed":
        assert counts[-1] == 0 and (counts > 0).any()


def test_sgd_tick_sort_equals_cpu_ticks_looped(cuda):
    """A node that every one of 1,000 paths visits 20 times in a row (about
    5,900 entries a tick on that node): 16 ticks of 262,144 terms under each
    plan of the counting sort bit-equal to the plain tick on the CPU."""
    from seqrush_tpu_torch.tools.headline import synth_variation_graph

    g = synth_variation_graph(loop_visits=20)
    steps = np.bincount(np.concatenate([p.steps >> 1 for p in g.paths]))
    assert steps.max() == 1000 * 20
    counts = _sort_plans_equal_cpu(g, 16)
    assert counts.max() > 4000


@pytest.mark.parametrize("kind, width", [("variation", 341), ("chain", 5461)])
def test_sgd_tick_kernel_any_width_equals_cpu_ticks(cuda, kind, width):
    """Three ticks an iteration make tick_plan's width no power of two (the
    JAX package's step bucket over n_sub), so each side's last chunk of the
    counting sort is part padding (under a count budget of 0 the one chunk
    is wider than the tick): every tick of a whole run under each plan of
    the sort bit-equal to the plain tick on the CPU."""
    from seqrush_tpu_torch.layout import sgd
    from seqrush_tpu_torch.layout.ygs import YgsParams

    g = _variation_graph(0) if kind == "variation" else _chain_graph(1)
    params = YgsParams.from_graph(g).to_sgd()
    params.n_sub = 3
    plan = sgd.sgd_setup(g, params, "cpu")
    assert plan.u_per_sub == width and plan.n_ticks == plan.block_ticks == 300
    _sort_plans_equal_cpu(g, 300, params)
    before = nw_cuda.LAUNCHES["sgd_tick"]
    pos = sgd.path_linear_sgd(g, params, "cuda")
    assert nw_cuda.LAUNCHES["sgd_tick"] == before + 1 and np.isfinite(list(pos.values())).all()


def test_sgd_tick_unstaged_tables_equal_cpu_ticks(cuda, monkeypatch):
    """H read from device memory (a graph whose longest path outgrows H's
    share of shared memory) and the positions too: every tick of a whole
    run under each plan of the counting sort bit-equal to the plain tick on
    the CPU."""
    from seqrush_tpu_torch.layout import sgd

    monkeypatch.setattr(sgd, "H_SMEM_BYTES", 0)
    monkeypatch.setattr(sgd, "X_SMEM_BYTES", 0)
    g = _variation_graph(0)
    params_space = sgd.sgd_setup(g, sgd.PathSGDParams(), "cpu").tables.space
    assert not sgd.ticks_plan(len(g.nodes), 128, params_space, 1).stage_h
    _sort_plans_equal_cpu(g, 800)


def test_sgd_ticks_refused_launch_raises(cuda):
    """A grid larger than the card holds at once is refused, not run another
    way: the wrapper raises and the launch count stays."""
    from seqrush_tpu_torch.layout import sgd

    g = _chain_graph(2)
    plan = sgd.sgd_setup(g, sgd.PathSGDParams(), "cuda")
    work = sgd.tick_work(plan.x0.shape[0], plan.u_per_sub, plan.tables.space, cuda)
    big = work._replace(plan=work.plan._replace(grid=4 * work.plan.grid))
    d = sgd.draw_block(torch.Generator(device="cuda"), 2, plan.u_per_sub, plan.n_steps)
    before = nw_cuda.LAUNCHES["sgd_tick"]
    with pytest.raises(RuntimeError, match="sgd_ticks launch failed"):
        sgd.sgd_ticks_cuda(plan.x0, 0, plan.n_sub, d, plan.tables, big)
    assert nw_cuda.LAUNCHES["sgd_tick"] == before
    torch.cuda.synchronize()


def test_sgd_layout_runs_the_tick_kernel(cuda):
    """path_linear_sgd on cuda launches the tick kernel once a block of
    ticks and gives the same positions on every call."""
    from seqrush_tpu_torch.layout import sgd

    g = _chain_graph(1)
    params = sgd.PathSGDParams()
    before = nw_cuda.LAUNCHES["sgd_tick"]
    first = sgd.path_linear_sgd(g, params, "cuda")
    plan = sgd.sgd_setup(g, params, "cuda")
    assert nw_cuda.LAUNCHES["sgd_tick"] == before + -(-plan.n_ticks // plan.block_ticks)
    assert sgd.path_linear_sgd(g, params, "cuda") == first
    d = sgd.draw_block(torch.Generator(device="cuda"), 1, plan.u_per_sub, plan.n_steps)
    with pytest.raises(ValueError, match="another buffer"):
        sgd.sgd_tick_cuda(plan.x0, 0, *(a[0] for a in d), plan.tables, out=plan.x0)


def test_layout_and_schedules_on_cuda(cuda, tmp_path):
    """The default run (layout on) twice on cuda: byte-identical; against
    cpu: isomorphic; the tree schedule picks the same pairs on both."""
    from seqrush_tpu_torch.graph.bigraph import parse_gfa
    from seqrush_tpu_torch.ops.kmer import kmer_distance_matrix
    from seqrush_tpu_torch.tools.isomorphic import isomorphic_gfa

    rng = np.random.default_rng(1)
    base = rng.integers(0, 4, 700)
    codes, recs = [], []
    for k in range(5):
        v = base.copy()
        v[rng.integers(0, v.size, 12)] = rng.integers(0, 4, 12)
        codes.append(v.astype(np.uint8))
        recs.append(b">s%d\n%s\n" % (k, np.frombuffer(b"ACGT", np.uint8)[v].tobytes()))
    fa = tmp_path / "in.fa"
    fa.write_bytes(b"".join(recs))
    out = {}
    for tag, flags in (("a", []), ("b", []), ("cpu", ["--device", "cpu"]),
                       ("tree", ["-x", "tree:2,1,0.2", "--no-sort"]),
                       ("tree_cpu", ["-x", "tree:2,1,0.2", "--no-sort", "--device", "cpu"]),
                       ("iter", ["--iterative", "--no-sort"]),
                       ("iter_cpu", ["--iterative", "--no-sort", "--device", "cpu"])):
        gfa = tmp_path / f"{tag}.gfa"
        assert cli.main(["-s", str(fa), "-o", str(gfa), *flags]) == 0
        out[tag] = gfa.read_text()
    assert out["a"] == out["b"]
    assert isomorphic_gfa(out["a"], out["cpu"]) == (True, "isomorphic")
    ids = sorted(parse_gfa(out["a"]).nodes)
    assert ids == list(range(1, len(ids) + 1))
    assert out["tree"] == out["tree_cpu"]
    assert out["iter"] == out["iter_cpu"]
    d_gpu = kmer_distance_matrix(codes, 16, "cuda")
    d_cpu = kmer_distance_matrix(codes, 16, "cpu")
    assert np.abs(d_gpu - d_cpu).max() <= 4e-6


def _segment_batch(seg, seed, device):
    """The boundary batch of tests/test_torch_long.py: pairs ending on
    segment 1's first, last and second-to-last row and inside segment 2, and
    a zero-length padding row."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k, total in enumerate((seg + 1, 2 * seg, 2 * seg - 1, 3 * seg - 37, 0)):
        qlen = total // 2 + (3 if k % 2 else -4) if total else 0
        tlen = total - qlen
        q = rng.integers(0, 4, qlen).astype(np.uint8)
        t = q.copy()
        if tlen < qlen:
            t = np.delete(t, np.arange(qlen // 3, qlen // 3 + qlen - tlen))
        elif tlen > qlen:
            t = np.insert(t, qlen // 2, rng.integers(0, 4, tlen - qlen).astype(np.uint8))
        if t.size:
            t[rng.integers(0, t.size, t.size // 40 + 1)] = rng.integers(0, 4, t.size // 40 + 1)
        qs.append(q)
        ts.append(t)
    return _pack(qs, ts, device)[0]


def _segments_equal_plain(args, band, seg, pen, plan=None):
    """Chain the segment kernels over every segment (forward: the sweep,
    full and score-only, from the kernel's own carry; backward: the walk
    from the kernel's own cursor) and hold each launch to its plain version
    on the same inputs.  Returns (scores, opcodes)."""
    Q, T, ql, tl = args
    B = Q.shape[0]
    n_seg = -(-int((ql + tl).max()) // seg)
    kw = dict(band=band, seg=seg, **pen)
    carry = nw_cuda.initial_carry(B, band + 1, Q.device)
    scores = torch.full((B,), -1, dtype=torch.int32, device=Q.device)
    tbs = []
    for s in range(n_seg):
        if plan is None:
            c_k, s_k, tb_k = nw_cuda.nw_align_segment(*args, carry, scores, t0=s * seg, **kw)
            c_o, s_o, none = nw_cuda.nw_align_segment(*args, carry, scores, t0=s * seg,
                                                      with_traceback=False, **kw)
        else:
            c_k, s_k, tb_k = nw_cuda.segment_launch(*args, carry, scores, plan, t0=s * seg, **kw)
            c_o, s_o, none = nw_cuda.segment_launch(*args, carry, scores, plan, t0=s * seg,
                                                    with_traceback=False, **kw)
        torch.cuda.synchronize()
        c_p, s_p, tb_p = nw_cuda.nw_align_segment_reference(*args, carry, scores, t0=s * seg, **kw)
        assert torch.equal(c_k, c_p) and torch.equal(s_k, s_p) and torch.equal(tb_k, tb_p), s
        assert none is None and torch.equal(c_o, c_p) and torch.equal(s_o, s_p), s
        carry, scores = c_k, s_k
        tbs.append(tb_k)
    state = nw_cuda.walk_state(ql, tl, band=band)
    ops = torch.zeros((B, n_seg * seg + 1), dtype=torch.uint8, device=Q.device)
    ops_p = ops.clone()
    for s in reversed(range(n_seg)):
        st_k = nw_cuda.nw_walk_segment(tbs[s], state, ops, t0=s * seg, seg=seg, band=band)
        torch.cuda.synchronize()
        st_p = nw_cuda.nw_walk_segment_reference(tbs[s], state, ops_p, t0=s * seg, seg=seg, band=band)
        assert torch.equal(st_k, st_p) and torch.equal(ops, ops_p), s
        state = st_k
    return scores, ops


@pytest.mark.parametrize(
    "seg,band,two_piece,route",
    [
        (256, 63, True, "regs"),
        (256, 300, False, "regs"),  # K >= seg: a boundary in the corner phase
        (512, 600, True, "regs"),
        (512, 127, False, "regs"),
        (2048, 767, True, "regs"),  # the long route's segment length
        (256, 4200, True, "wide"),  # W 4201: above the register route
        (256, 63, True, "scratch"),  # wide route forced: a chain of 2 clusters of 2 CTAs, a lane a thread
        (256, 63, "big", "wide"),  # penalties outside [0, 2^16)
    ],
)
def test_segment_kernels_equal_plain_versions(cuda, seg, band, two_piece, route):
    """Kernel A's segment mode (full and score-only) and kernel B's, on the
    boundary batch over every segment, bit-equal to their plain versions:
    carries, scores, traceback rows, cursors and opcodes."""
    args = _segment_batch(seg, seg + band, cuda)
    if two_piece == "big":
        pen = dict(mismatch=5, o1=70000, e1=2, o2=24, e2=1)
    else:
        pen = dict(mismatch=5, o1=8, e1=2, o2=24 if two_piece else -1, e2=1 if two_piece else -1)
    B, W = args[0].shape[0], band + 1
    plan = nw_cuda.plan_sweep(B, W, args[0].shape[1], args[1].shape[1], seg=seg)
    assert plan.route == ("wide" if route == "wide" and two_piece != "big" else "regs")
    scratch = nw_cuda.wide_plan(B, W, lanes=1, ctas=4, cluster=2) if route == "scratch" else None
    before = dict(nw_cuda.LAUNCHES)
    scores, ops = _segments_equal_plain(args, band, seg, pen, scratch)
    n_seg = 3
    wide = route != "regs" or two_piece == "big"
    want = ({"nw_sweep_wide_segment": 2 * n_seg, "nw_sweep_segment": 0, "nw_sweep_segment_score_only": 0} if wide
            else {"nw_sweep_wide_segment": 0, "nw_sweep_segment": n_seg, "nw_sweep_segment_score_only": n_seg})
    for k, n in {**want, "nw_walk_segment": n_seg}.items():
        assert nw_cuda.LAUNCHES[k] == before[k] + n, k
    assert (scores[:-1] >= 0).all() and int(scores[-1]) == -1
    assert not ops[-1].any()


def test_segment_walk_on_random_bytes_equals_plain(cuda):
    """Random traceback bytes (choice codes that consume nothing, cursors
    leaving the band): the walk kernel's cursors and opcodes equal the plain
    version's segment by segment, and ended walks stay ended."""
    rng = np.random.default_rng(4)
    seg, band = 64, 20
    ql = torch.tensor([150, 90, 37, 0, 120, 7, 300, 64, 65], dtype=torch.int32, device=cuda)
    tl = torch.tensor([100, 99, 64, 0, 130, 3, 280, 64, 63], dtype=torch.int32, device=cuda)
    n_seg = -(-int((ql + tl).max()) // seg)
    state = nw_cuda.walk_state(ql, tl, band=band)
    ops = torch.zeros((ql.numel(), n_seg * seg + 1), dtype=torch.uint8, device=cuda)
    ops_p = ops.clone()
    for s in reversed(range(n_seg)):
        tb = torch.from_numpy(rng.integers(0, 128, (ql.numel(), seg, band + 1)).astype(np.uint8)).to(cuda)
        st_k = nw_cuda.nw_walk_segment(tb, state, ops, t0=s * seg, seg=seg, band=band)
        st_p = nw_cuda.nw_walk_segment_reference(tb, state, ops_p, t0=s * seg, seg=seg, band=band)
        torch.cuda.synchronize()
        assert torch.equal(st_k, st_p) and torch.equal(ops, ops_p), s
        state = st_k


def _long_launches(n_fwd, n_grp, n_gwalk, n_seg_tb, n_seg_walk):
    return {"nw_sweep": 0, "nw_sweep_score_only": 0, "nw_walk": 0, "nw_walk_runs": 0,
            "nw_sweep_segment": n_seg_tb, "nw_sweep_segment_score_only": n_fwd,
            "nw_walk_segment": n_seg_walk, "nw_sweep_segment_group": n_grp,
            "nw_walk_segment_group": n_gwalk, "wfa": 0, "wfa_score_only": 0,
            "nw_sweep_int16": 0, "nw_sweep_snapshot": 0, "nw_walk_start": 0, "nw_rows_sweep": 0,
            "nw_rows_walk": 0, "nw_sweep_tiled": 0, "nw_walk_runs_tiled": 0,
            "nw_sweep_sharded": 0, "fold_combine": 0, "sgd_tick": 0, "uf_unite": 0, "uf_compress": 0,
            "uf_find": 0, "nw_sweep_wide": 0, "nw_sweep_wide_segment": 0}


@pytest.mark.parametrize("G", ["all", 2, 1])
def test_long_route_launches_and_equals_single_shot(cuda, G):
    """nw_align_long on the card at G = n_seg (the recompute overlapping the
    forward pass), 2 and 1: the launches of each shape (LONG_RUN segments a
    forward launch while it overlaps, else one; a grouped recompute and a
    group walk a group, at G = 1 a segment each), and the single-shot
    kernels' scores and opcodes."""
    (Q, T, ql, tl), tmax = _pack(*_variants(np.random.default_rng(3), 9, 2600, 255, 0.0), cuda)
    kw = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1, band=255)
    t_need = int((ql + tl).max())
    seg = 1024
    n_seg = -(-t_need // seg)
    B, W = Q.shape[0], 256
    g = n_seg if G == "all" else G
    budget = g * B * seg * W
    nw_cuda.reset_launch_counts()
    scores, ops = nw_cuda.nw_align_long(Q, T, ql, tl, seg=seg, t_need=t_need, memory_budget=budget,
                                        **kw)
    torch.cuda.synchronize()
    runs = -(-n_seg // nw_cuda.LONG_RUN)
    want = {"all": _long_launches(runs, runs, 1, 0, 0),
            2: _long_launches(1, -(-n_seg // 2), -(-n_seg // 2), 0, 0),
            1: _long_launches(1, n_seg, n_seg, 0, 0)}[G]
    assert nw_cuda.LAUNCHES == want
    s_one, tb = nw_cuda.nw_align(Q, T, ql, tl, tmax=tmax, **kw)
    ops_one = nw_cuda.nw_walk(tb, ql, tl, band=255, tmax=tmax)
    assert torch.equal(scores, s_one)
    assert torch.equal(ops[:, : t_need + 1], ops_one[:, : t_need + 1])
    assert not ops[:, t_need + 1 :].any() and not ops_one[:, t_need + 1 :].any()


@pytest.mark.parametrize(
    "seg,band,two_piece,route",
    [
        (256, 63, True, "regs"),
        (256, 300, False, "regs"),  # K >= seg: a boundary in the corner phase
        (2048, 767, True, "regs"),  # the long route's segment length
        (256, 4200, True, "wide"),  # W 4201: above the register route
        (256, 63, True, "scratch"),  # wide route forced: a chain of 2 clusters of 2 CTAs, a lane a thread
    ],
)
def test_segment_group_kernels_equal_plain_versions(cuda, seg, band, two_piece, route):
    """The long route's launch shapes on the boundary batch, each against
    its plain version on the same inputs: a forward run over every segment
    in one launch (checkpoints and scores), the grouped recompute of all
    segments and of the last two (traceback bytes and scores; the last two
    also into a traceback of every segment's rows from their first row on,
    as the route's overlap writes them, rows outside left untouched), and
    the group walk over them (cursors and opcodes)."""
    args = _segment_batch(seg, seg + band, cuda)
    pen = dict(mismatch=5, o1=8, e1=2, o2=24 if two_piece else -1, e2=1 if two_piece else -1)
    B, W = args[0].shape[0], band + 1
    n_seg = 3
    kw = dict(seg=seg, band=band, **pen)
    ckpt = torch.empty((n_seg, 6, B, W), dtype=torch.int32, device=cuda)
    ckpt[0] = nw_cuda.initial_carry(B, W, cuda)
    ckpt_p = ckpt.clone()
    s_init = torch.full((B,), -1, dtype=torch.int32, device=cuda)
    if route == "scratch":
        real = nw_cuda._segment_plan
        nw_cuda._segment_plan = lambda B, W, Lq, Lt, seg, groups, pen: nw_cuda.wide_plan(
            B, W, groups, lanes=1, ctas=4, cluster=2)
    try:
        scores = nw_cuda.nw_align_segment_run(*args, ckpt, s_init, s0=0, n_run=n_seg, **kw)
        torch.cuda.synchronize()
        s_p = nw_cuda.nw_align_segment_run_reference(*args, ckpt_p, s_init, s0=0, n_run=n_seg, **kw)
        assert torch.equal(scores, s_p) and torch.equal(ckpt, ckpt_p)
        assert (scores[:-1] >= 0).all() and int(scores[-1]) == -1
        for s0, g in ((0, n_seg), (1, 2)):
            s_k, tb_k = nw_cuda.nw_align_segment_group(*args, ckpt, s0=s0, G=g, **kw)
            torch.cuda.synchronize()
            tb_p = torch.zeros_like(tb_k)
            s_p = nw_cuda.nw_align_segment_group_reference(*args, ckpt, s0=s0, G=g, tb=tb_p, **kw)
            assert torch.equal(s_k, s_p) and torch.equal(tb_k, tb_p), s0
            tb_all = torch.full((B, n_seg * seg, W), 0xA5, dtype=torch.uint8, device=cuda)
            s_a, _ = nw_cuda.nw_align_segment_group(*args, ckpt, s0=s0, G=g, tb=tb_all,
                                                    row0=s0 * seg, **kw)
            torch.cuda.synchronize()
            rows = slice(s0 * seg, (s0 + g) * seg)
            assert torch.equal(s_a, s_p) and torch.equal(tb_all[:, rows], tb_p), s0
            assert (tb_all[:, : s0 * seg] == 0xA5).all() and (tb_all[:, rows.stop :] == 0xA5).all()
            state = nw_cuda.walk_state(args[2], args[3], band=band)
            ops = torch.zeros((B, n_seg * seg + 1), dtype=torch.uint8, device=cuda)
            ops_p = ops.clone()
            st_k = nw_cuda.nw_walk_segment_group(tb_k, state, ops, s0=s0, G=g, seg=seg, band=band)
            torch.cuda.synchronize()
            st_p = nw_cuda.nw_walk_segment_group_reference(tb_p, state, ops_p, s0=s0, G=g, seg=seg,
                                                           band=band)
            assert torch.equal(st_k, st_p) and torch.equal(ops, ops_p), s0
    finally:
        if route == "scratch":
            nw_cuda._segment_plan = real


@pytest.mark.parametrize("osc", [(1, 1, 1), (2, 3, 1)])
def test_orientation_probe_score_only_one_piece_band_127(cuda, osc):
    """choose_orientations' probe shape: score-only, one-piece penalties
    (the orientation scores), band 127, lengths rounded to 256 and tmax to
    512, a batch of a power of two: scores equal the plain version's and the
    full sweep's, and the choice equals the plain version's choice."""
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner, pack_probe
    from seqrush_tpu_torch.scores import AlignmentScores
    from seqrush_tpu_torch.sequences import make_sequence_set

    import chip_smoke

    named = chip_smoke.probe_trio()
    seqs = make_sequence_set(named)
    pairs = np.array(chip_smoke.PROBE_PAIRS)
    cfg = RunnerConfig(orientation_scores=AlignmentScores(0, *osc, None, None))
    al = WfaAligner(seqs, cfg, device=cuda)
    qs, ts = [], []
    for i, j in pairs:
        qs += [al.codes[i], al.rc_codes[i]]
        ts += [al.codes[j], al.codes[j]]
    Q, T, ql, tl, band, tmax = pack_probe(qs, ts)
    assert (Q.shape[0], band, tmax) == (8, 127, 1536)
    Q, T, ql, tl = (torch.from_numpy(a).to(cuda) for a in (Q, T, ql, tl))
    kw = dict(mismatch=osc[0], o1=osc[1], e1=osc[2], o2=-1, e2=-1, band=band, tmax=tmax)
    before = nw_cuda.LAUNCHES["nw_sweep_score_only"]
    s_k, none = nw_cuda.nw_align(Q, T, ql, tl, with_traceback=False, **kw)
    torch.cuda.synchronize()
    assert none is None and nw_cuda.LAUNCHES["nw_sweep_score_only"] == before + 1
    s_p, _ = nw_cuda.nw_align_reference(Q, T, ql, tl, with_traceback=False, **kw)
    s_f, _tb = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    assert torch.equal(s_k, s_p) and torch.equal(s_k, s_f) and (s_k >= 0).all()
    cpu = WfaAligner(seqs, cfg, device="cpu").choose_orientations(pairs)
    assert al.choose_orientations(pairs).tolist() == cpu.tolist()


@pytest.mark.parametrize("sizes,diff", [((40, 100, 128), 70), ((500, 900, 1178), 20), ((3, 7, 60), 0)])
def test_gap_chunk_shapes_equal_plain(cuda, sizes, diff):
    """The sweepga gap chunk (pack_gap_chunk): B a power of two of at least
    8 with padding rows, lengths rounded to 128, tmax to 256, and the band
    capped at max(lq, lt) + 1 where the length difference is large.  Scores,
    the traceback and the opcodes equal the plain versions exactly."""
    from seqrush_tpu_torch.align.sweep import pack_gap_chunk

    rng = np.random.default_rng(sum(sizes) + diff)
    jobs = []
    for k, n in enumerate(sizes * 2):
        q = rng.integers(0, 4, n).astype(np.uint8)
        t = q.copy()
        t[rng.integers(0, n, max(n // 20, 1))] = rng.integers(0, 4, max(n // 20, 1))
        if k % 2:
            t = (3 - t[::-1]).copy()
        t = t[: max(n - diff, 1)] if n == max(sizes) else t
        jobs.append((0, k, q, t))
    Q, T, ql, tl, band, tmax = pack_gap_chunk(jobs)
    if diff >= 64:
        assert band == max(Q.shape[1], T.shape[1]) + 1
    assert Q.shape[0] == 8 and tmax % 256 == 0 and Q.shape[1] % 128 == 0
    Q, T, ql, tl = (torch.from_numpy(a).to(cuda) for a in (Q, T, ql, tl))
    kw = _penalties(True, band, tmax)
    s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    ops_k = nw_cuda.nw_walk(tb_k, ql, tl, band=band, tmax=tmax)
    torch.cuda.synchronize()
    s_p, tb_p = nw_cuda.nw_align_reference(Q, T, ql, tl, **kw)
    ops_p = nw_cuda.nw_walk_reference(tb_k, ql, tl, band=band, tmax=tmax)
    assert torch.equal(s_k, s_p) and (s_k[: len(jobs)] >= 0).all()
    assert torch.equal(tb_k, tb_p) and torch.equal(ops_k, ops_p)


@pytest.mark.parametrize("n_win,two_piece", [(5, True), (11, True), (9, False)])
def test_inversion_batch_unrounded_equals_plain(cuda, n_win, two_piece):
    """The inversion-aware window batch (pack_inversion_batch): Q and T
    widths lq + 1 and lt + 1, not rounded; tmax = max(qlen + tlen) + 1; the
    band max(64, |diff| + 64) capped at max(lq, lt) + 1.  Kernel A and
    kernel B equal their plain versions exactly."""
    from types import SimpleNamespace

    from seqrush_tpu_torch.align.inversion import pack_inversion_batch

    rng = np.random.default_rng(n_win)
    jobs = []
    for k in range(n_win):
        n = int(rng.integers(20, 300))
        q = rng.integers(0, 4, n).astype(np.uint8)
        t = (3 - q[::-1]).copy()
        t[rng.integers(0, n, max(n // 25, 1))] = rng.integers(0, 4, max(n // 25, 1))
        if k % 3 == 1:
            t = t[: n - int(rng.integers(1, 40))]
        if k % 3 == 2:
            t = rng.integers(0, 4, n + 17).astype(np.uint8)
        jobs.append((SimpleNamespace(score=0), None, q, t))
    Q, T, ql, tl, band, tmax = pack_inversion_batch(jobs)
    assert Q.shape[1] == max(j[2].size for j in jobs) + 1
    assert tmax == int((ql + tl).max()) + 1
    Q, T, ql, tl = (torch.from_numpy(a).to(cuda) for a in (Q, T, ql, tl))
    kw = _penalties(two_piece, band, tmax)
    s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    ops_k = nw_cuda.nw_walk(tb_k, ql, tl, band=band, tmax=tmax)
    torch.cuda.synchronize()
    s_p, tb_p = nw_cuda.nw_align_reference(Q, T, ql, tl, **kw)
    ops_p = nw_cuda.nw_walk_reference(tb_k, ql, tl, band=band, tmax=tmax)
    assert torch.equal(s_k, s_p) and (s_k[:n_win] >= 0).all()
    assert torch.equal(tb_k, tb_p) and torch.equal(ops_k, ops_p)


@pytest.mark.parametrize("flags", [("--aligner", "sweepga"), ("--aligner", "sweepga", "-f", "3"),
                                   ("--inversion-aware",)])
def test_backend_modes_cuda_equals_cpu(cuda, flags, tmp_path):
    """--aligner sweepga and --inversion-aware: the same FASTA gives
    byte-identical --no-sort GFA on cuda and on cpu."""
    import chip_smoke

    fa = tmp_path / "in.fa"
    chip_smoke.write_fasta(fa, chip_smoke.synth_family(n_seqs=3, length=700, seed=5))
    out = {}
    for dev in ("cuda", "cpu"):
        gfa = tmp_path / f"{dev}.gfa"
        assert cli.main(["-s", str(fa), "-o", str(gfa), "--no-sort", "--device", dev, *flags]) == 0
        out[dev] = gfa.read_bytes()
    assert out["cuda"] == out["cpu"]


def test_fuzz_tool_runs_on_cuda(cuda):
    """python -m seqrush_tpu_torch.tools.fuzz --device cuda --trials 2 (the
    first trial is --inversion-aware) exits 0."""
    from seqrush_tpu_torch.tools import fuzz

    nw_cuda.reset_launch_counts()
    assert fuzz.main(["--device", "cuda", "--trials", "2"]) == 0
    # the chunks' walks fetch run tokens (the default emit)
    assert nw_cuda.LAUNCHES["nw_sweep"] > 0 and nw_cuda.LAUNCHES["nw_walk_runs"] > 0


@pytest.mark.parametrize(
    "kind,B,L,band,two_piece,run_max,run_len_max",
    [
        ("variants", 8, 300, 127, True, 128, (1 << 14) - 1),
        ("variants", 8, 300, 127, True, 2, (1 << 14) - 1),  # counts past run_max
        ("variants", 8, 300, 127, False, 32, 8),  # runs split at 8 steps
        ("variants", 16, 1200, 383, True, 24, 1),  # every step its own token
        ("variants", 8, 1500, 1535, True, 128, 40),  # diagonal ballots across the cap
        ("ties", 9, 400, 127, True, 128, 7),
        ("edges", 11, 300, 31, True, 16, 5),  # walks from outside the band
        # the walk gap corpus: gap runs taken by ballot, cut by the cap
        ("gaps", 18, 0, 199, True, 128, 1),
        ("gaps", 18, 0, 199, True, 128, 5),
        ("gaps", 18, 0, 199, True, 128, 31),
        ("gaps", 18, 0, 199, True, 128, 32),
        ("gaps", 18, 0, 199, True, 128, 33),
        ("gaps", 18, 0, 199, False, 128, (1 << 14) - 1),  # one-piece
        ("gaps", 18, 0, 199, True, 2, (1 << 14) - 1),  # counts past run_max
        ("gaps", 18, 0, 127, True, 128, 40),  # runs past the band's edges
    ],
)
def test_walk_runs_equal_plain(cuda, kind, B, L, band, two_piece, run_max, run_len_max):
    """Kernel B's runs mode: tokens and counts exactly the plain version's
    (the run-length encoding of the opcode walk, in walk order)."""
    rng = np.random.default_rng(band + B + run_max)
    make = {"variants": _variants, "ties": _ties, "edges": _edges, "gaps": _gaps}[kind]
    (Q, T, ql, tl), tmax = _pack(*make(rng, B, L, band, 0.3 if band > 1000 else 0.0), cuda)
    kw = _penalties(two_piece, band, tmax)
    _s, tb = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    before = dict(nw_cuda.LAUNCHES)
    tok, cnt = nw_cuda.nw_walk_runs(tb, ql, tl, band=band, tmax=tmax, run_max=run_max,
                                    run_len_max=run_len_max)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_walk_runs"] == before["nw_walk_runs"] + 1
    assert nw_cuda.LAUNCHES["nw_walk"] == before["nw_walk"]
    tok_p, cnt_p = nw_cuda.nw_walk_runs_reference(tb, ql, tl, band=band, tmax=tmax, run_max=run_max,
                                                  run_len_max=run_len_max)
    assert torch.equal(tok, tok_p) and torch.equal(cnt, cnt_p)
    assert int(cnt[-1]) == 0 and (tok >> 2).max() <= run_len_max
    if run_max == 2:
        assert (cnt > run_max).any()


def _wfa_pairs(rng, n, L, n_snp, indel, n_frac=0.0, same=False):
    """n seeded pairs of length ~L with SNPs and an indel of up to `indel`
    bases (n_frac of the bases N, code 4; same: every target its query), an
    identical pair, and a zero-length row."""
    qs, ts = [], []
    for k in range(n):
        q = rng.integers(0, 4, L).astype(np.uint8)
        q[rng.random(L) < n_frac] = 4
        t = q.copy()
        if not same:
            t[rng.integers(0, L, n_snp)] = rng.integers(0, 5 if n_frac else 4, n_snp)
            if indel and k % 2:
                p = int(rng.integers(L // 4, L // 2))
                t = np.delete(t, np.arange(p, p + 1 + k % indel))
            elif indel:
                t = np.insert(t, L // 2, rng.integers(0, 4, 1 + k % indel).astype(np.uint8))
        qs.append(q)
        ts.append(t)
    return qs + [qs[0], np.zeros(0, np.uint8)], ts + [qs[0].copy(), np.zeros(0, np.uint8)]


HEADLINE_PEN = (5, 8, 2, 24, 1)


@pytest.mark.parametrize(
    "n,L,n_snp,indel,band,smax,two_piece,keep,pad,pen,n_frac,same,route",
    [
        (6, 600, 8, 30, 63, 300, True, True, 0, None, 0.0, False, "rings staged"),
        (6, 600, 8, 30, 63, 300, True, False, 0, None, 0.0, False, "rings staged"),  # score-only
        (6, 600, 8, 12, 63, 300, False, True, 0, None, 0.0, False, "rings staged"),  # one-piece
        (6, 600, 8, 12, 63, 300, False, False, 0, None, 0.0, False, "rings staged"),
        (5, 800, 10, 40, 600, 400, True, True, 0, None, 0.0, False, "rings staged"),  # threads stride
        (3, 400, 8, 9, 48, 100, True, True, 0, None, 0.0, False, "rings staged"),  # a cap stops a pair
        # rows padded to 120,000 columns: too wide for shared memory beside
        # the rings (the pairs stay short: offsets past 32,767 saturate the
        # int16 history)
        (2, 3000, 15, 20, 31, 200, True, True, 120_000, None, 0.0, False, "rings"),
        (2, 3000, 15, 20, 31, 200, True, False, 120_000, None, 0.0, False, "rings"),
        # the staging boundary at band 255: rings 36,944 bytes, the sequences
        # 194,464 bytes fit beside them, 194,496 do not
        (3, 2000, 10, 20, 255, 150, True, True, 97_216, None, 0.0, False, "rings staged"),
        (3, 2000, 10, 20, 255, 150, True, True, 97_232, None, 0.0, False, "rings"),
        # the rings' boundary: 3,213 columns of 36 rows fit at band 1,605, not at 1,606
        (3, 600, 8, 20, 1605, 150, True, True, 0, None, 0.0, False, "rings"),
        (3, 600, 8, 20, 1606, 150, True, True, 0, None, 0.0, False, "global staged"),
        (3, 600, 8, 20, 1606, 150, True, False, 120_000, None, 0.0, False, "global"),
        # a long lookback (o2 + e2 = 41: a 42-row M ring), mismatch 0 (the
        # global route), bands 0 and 15, N-rich pairs, identical pairs
        (4, 900, 10, 40, 255, 300, True, True, 0, (5, 8, 2, 40, 1), 0.0, False, "rings staged"),
        (4, 900, 10, 40, 255, 300, True, False, 0, (5, 8, 2, 40, 1), 0.0, False, "rings staged"),
        (4, 300, 10, 6, 63, 200, True, True, 0, (0, 8, 2, 24, 1), 0.0, False, "global staged"),
        (4, 300, 6, 0, 0, 100, True, True, 0, None, 0.0, False, "rings staged"),
        (4, 300, 6, 8, 15, 120, False, True, 0, None, 0.0, False, "rings staged"),
        (5, 1200, 20, 10, 255, 300, True, True, 0, None, 0.3, False, "rings staged"),
        (3, 3000, 0, 0, 255, 20, True, True, 0, None, 0.05, True, "rings staged"),
        (3, 3000, 0, 0, 255, 20, True, False, 0, None, 0.0, True, "rings staged"),
    ],
)
def test_wfa_kernel_equals_plain(cuda, n, L, n_snp, indel, band, smax, two_piece, keep, pad, pen,
                                 n_frac, same, route):
    """The wavefront kernel on each route of its planner: scores and the
    whole history tensors (every row a pair stepped, NULL16 past its end),
    or the score-only mode's rolling rows, exactly the plain version's."""
    rng = np.random.default_rng(L + band + int(keep) + pad)
    qs, ts = _wfa_pairs(rng, n, L, n_snp, indel, n_frac, same)
    Q, T, ql, tl = wfa.pack_batch(qs, ts)
    if pad:
        Q = np.pad(Q, ((0, 0), (0, pad - Q.shape[1])), constant_values=wfa.QPAD)
        T = np.pad(T, ((0, 0), (0, pad - T.shape[1])), constant_values=wfa.TPAD)
    caps = np.full(len(qs), smax, np.int32)
    if smax == 100 and band:
        caps[0] = 20
    args = [torch.from_numpy(a).to(cuda) for a in (Q, T, ql, tl, caps)]
    x, o1, e1, o2, e2 = pen or HEADLINE_PEN
    kw = dict(mismatch=x, o1=o1, e1=e1, o2=o2 if two_piece else -1, e2=e2 if two_piece else -1,
              smax=smax, band=band, keep_history=keep)
    plan = wfa.wfa_plan(Q.shape[1], T.shape[1], band, **{k: kw[k] for k in ("mismatch", "o1", "e1", "o2", "e2")})
    assert f"{plan.route}{' staged' if plan.staged else ''}" == route
    before = dict(nw_cuda.LAUNCHES)
    s_k, h_k = wfa.wfa_run(*args, **kw)
    torch.cuda.synchronize()
    name = "wfa" if keep else "wfa_score_only"
    assert nw_cuda.LAUNCHES[name] == before[name] + 1
    s_p, h_p = wfa.wfa_align_reference(*args, **kw)
    assert torch.equal(s_k, s_p)
    assert int(s_k[-1]) == 0 and int(s_k[-2]) == 0  # the zero-length and identical pairs
    if same:
        assert (s_k == 0).all()
    elif band:
        assert (s_k[:-2] > 0).sum() >= 1
    if smax == 100 and band:
        assert int(s_k[0]) == -1
    for a, b in zip(h_k, h_p):
        assert torch.equal(a, b)
    # the public entry point: the history by name, or none in score-only mode
    s_d, named = wfa.wfa_align_device(*args, **kw)
    assert torch.equal(s_d, s_k) and (sorted(named) if keep else named) == (
        sorted(["M", "I1", "D1", "I2", "D2"][: 5 if two_piece else 3]) if keep else {})



# -- kernel A's int16 and snapshot modes, kernel B's start mode, kernels C and D


@pytest.mark.parametrize(
    "band,pen,route",
    [
        (127, (5, 8, 2, 24, 1), "regs"),
        (511, (5, 8, 2, 24, 1), "regs"),
        (100, (5, 8, 2, -1, -1), "regs"),  # one-piece, W not a multiple of 4
        (1535, (5, 8, 2, 24, 1), "regs"),
        (4096, (5, 8, 2, 24, 1), "wide"),  # the first wide-route band
        (127, (5, 8, 2, 3000, 1), "wide"),  # adds past 32,767 wrap: the wide route
        (255, (2800, 8, 2, 24, 1), "wide"),
    ],
)
def test_int16_sweep_equals_plain(cuda, band, pen, route):
    """Kernel A's int16 mode: scores and the whole traceback exactly the
    plain version's, on both routes, with penalties whose int16 adds wrap."""
    rng = np.random.default_rng(band + pen[3])
    (Q, T, ql, tl), tmax = _pack(*_variants(rng, 9, 700, band, 0.3 if band > 1000 else 0.0), cuda)
    kw = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), pen), band=band, tmax=tmax)
    regs = nw_cuda.register_route_penalties(*pen, int16=True) and band + 1 <= nw_cuda.REG_MAX_W
    assert regs == (route == "regs")
    key = "nw_sweep_int16" if regs else "nw_sweep_wide"
    before = nw_cuda.LAUNCHES[key]
    s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, int16=True, **kw)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES[key] == before + 1
    s_p, tb_p = nw_cuda.nw_align_reference(Q, T, ql, tl, int16=True, **kw)
    assert torch.equal(s_k, s_p) and int(s_k[-1]) == 0
    assert torch.equal(tb_k, tb_p)


@pytest.mark.parametrize("band,pen", [(255, (5, 8, 2, 24, 1)), (255, (2800, 8, 2, 24, 1)),
                                      (4096, (5, 8, 2, 24, 1))])
def test_int16_score_only_equals_plain(cuda, band, pen):
    """Kernel A's int16 mode without a traceback (the wide route's own
    instantiation where the penalties wrap or W passes REG_MAX_W): the full
    mode's and the plain version's scores."""
    rng = np.random.default_rng(band + pen[0])
    (Q, T, ql, tl), tmax = _pack(*_variants(rng, 6, 500, band, 0.0), cuda)
    kw = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), pen), band=band, tmax=tmax, int16=True)
    s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, with_traceback=False, **kw)
    torch.cuda.synchronize()
    assert tb_k is None
    s_p, _ = nw_cuda.nw_align_reference(Q, T, ql, tl, with_traceback=False, **kw)
    s_full, _ = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    assert torch.equal(s_k, s_p) and torch.equal(s_k, s_full)


@pytest.mark.parametrize(
    "band,two_piece,int16,plan",
    [
        (127, True, False, None),
        (767, True, True, None),
        (100, False, False, None),
        (1791, True, False, None),
        (511, True, True, "wide"),
        (200, True, True, "wide"),  # one CTA a pair, a lane a thread: the solo kernel
        (63, False, False, "wide"),
        (511, False, False, "scratch"),  # the wide route as a chain of 2 clusters of 4 CTAs
        (4096, True, True, None),  # W 4097: the wide route
    ],
)
def test_snapshot_sweep_equals_plain(cuda, band, two_piece, int16, plan):
    """Kernel A's snapshot mode: SNAP, DIAGA and DIAGB, the scores and each
    row's traceback rows 0 .. t_snap + 1 (nw_cuda.snapshot_rows: the rows
    past them the register route leaves unwritten) exactly the plain
    version's, with t_snap 0, in the middle, at tmax - 1 and past a pair's
    end."""
    rng = np.random.default_rng(band + 3)
    (Q, T, ql, tl), tmax = _pack(*_variants(rng, 10, 600, band, 0.0), cuda)
    kw = _penalties(two_piece, band, tmax)
    fin = (ql + tl).cpu().numpy()
    t_snap = np.array([(f + 1) // 2 for f in fin], np.int32)
    t_snap[0], t_snap[1], t_snap[2] = 0, tmax - 1, min(int(fin[2]) + 5, tmax - 1)
    t_snap = torch.from_numpy(t_snap).to(cuda)
    if plan is None:
        out_k = nw_cuda.nw_align(Q, T, ql, tl, int16=int16, t_snap=t_snap, **kw)
    else:
        B, W = Q.shape[0], band + 1
        p = nw_cuda.wide_plan(B, W) if plan == "wide" else nw_cuda.wide_plan(B, W, lanes=2, ctas=8, cluster=4)
        out_k = nw_cuda.sweep_launch(Q, T, ql, tl, p, int16=int16, t_snap=t_snap, **kw)
    torch.cuda.synchronize()
    out_p = nw_cuda.nw_align_reference(Q, T, ql, tl, int16=int16, t_snap=t_snap, **kw)
    rows = nw_cuda.snapshot_rows(t_snap, tmax, out_p[1].shape[1])[:, :, None]
    assert torch.equal(out_k[0], out_p[0])
    assert torch.equal(torch.where(rows, out_k[1], 0), torch.where(rows, out_p[1], 0))
    for a, b in zip(out_k[2], out_p[2]):
        assert torch.equal(a, b)


def _fold_inputs(rng, B, L, band, device):
    qs, ts = _variants(rng, B, L, band, 0.0)
    qs[0], ts[0] = qs[0][:1], ts[0][:2]  # a tiny pair
    if B > 3:
        ts[2] = ts[2][:-1]  # an odd qlen + tlen beside even ones
    (Q, T, ql, tl), tmax = _pack(qs, ts, device)
    Qr, Tr = Q.clone(), T.clone()
    for b, (q, t) in enumerate(zip(qs, ts)):
        Qr[b, : q.size] = torch.from_numpy(q[::-1].copy()).to(device)
        Tr[b, : t.size] = torch.from_numpy(t[::-1].copy()).to(device)
    diff = max(abs(q.size - t.size) for q, t in zip(qs, ts))
    return (Q, T, Qr, Tr, ql, tl), band + diff, -(-(tmax // 2 + 2) // 256) * 256


@pytest.mark.parametrize("B,L,band,two_piece,int16", [(9, 600, 127, True, False),
                                                      (9, 600, 127, True, True),
                                                      (6, 900, 255, False, False),
                                                      (5, 1500, 1535, True, False)])
def test_fold_equals_plain(cuda, B, L, band, two_piece, int16):
    """The fold on the card (the snapshot sweep, the combine on the device,
    the start-mode walk) gives the plain versions' scores, half-walk
    opcodes and crossings, and each kernel launches once."""
    rng = np.random.default_rng(L + band)
    args, band_eff, tmax_half = _fold_inputs(rng, B, L, band, cuda)
    pen = _penalties(two_piece, band_eff, 0)
    pen.pop("tmax")
    pen.pop("band")
    before = dict(nw_cuda.LAUNCHES)
    s_k, ops_k, cm_k = nw_cuda.nw_align_fold(*args, band=band_eff, tmax_half=tmax_half, int16=int16, **pen)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_sweep_snapshot"] == before["nw_sweep_snapshot"] + 1
    assert nw_cuda.LAUNCHES["nw_walk_start"] == before["nw_walk_start"] + 1
    assert nw_cuda.LAUNCHES["fold_combine"] == before["fold_combine"] + 1
    cpu = [a.cpu() for a in args]
    s_p, ops_p, cm_p = nw_cuda.nw_align_fold(*cpu, band=band_eff, tmax_half=tmax_half, int16=int16, **pen)
    assert torch.equal(s_k.cpu(), s_p) and torch.equal(ops_k.cpu(), ops_p) and torch.equal(cm_k.cpu(), cm_p)
    assert (s_k[:-1] > 0).all() and int(s_k[-1]) == 0


def _combine_both(SNAP, DIAGA, DIAGB, ql, tl, **kw):
    before = nw_cuda.LAUNCHES["fold_combine"]
    got = nw_cuda.fold_combine(SNAP, DIAGA, DIAGB, ql, tl, **kw)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["fold_combine"] == before + 1
    want = nw_cuda.fold_combine_reference(SNAP, DIAGA, DIAGB, ql, tl, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return got


@pytest.mark.parametrize("B,L,band,two_piece,int16,narrow", [(9, 600, 127, True, False, False),
                                                             (9, 600, 127, True, True, False),
                                                             (6, 900, 255, False, False, False),
                                                             (5, 1500, 1535, True, False, False),
                                                             (7, 600, 127, False, True, False),
                                                             (8, 300, 4, True, False, True),
                                                             (8, 300, 4, False, False, True)])
def test_fold_combine_kernel_equals_plain(cuda, B, L, band, two_piece, int16, narrow):
    """The combine kernel on the snapshot sweep's own outputs: scores, the
    half-walks' starts and the crossings exactly fold_combine_reference's,
    in one launch.  The batches hold a zero-length pair (fin == 0) and a
    tiny one; with ``narrow`` the band is below the pairs' length
    differences, so rows do not finish (score -1, inert starts)."""
    rng = np.random.default_rng(L + band + int(narrow))
    (Q, T, Qr, Tr, ql, tl), band_eff, tmax_half = _fold_inputs(rng, B, L, band, cuda)
    if narrow:
        band_eff = band
    pen = _penalties(two_piece, band_eff, tmax_half)
    fin = ql + tl
    tm = torch.div(fin + 1, 2, rounding_mode="floor")
    t_snap = torch.cat([tm, fin - tm]).to(torch.int32)
    _s, _tb, (SNAP, DIAGA, DIAGB) = nw_cuda.nw_align(torch.cat([Q, Qr]), torch.cat([T, Tr]), torch.cat([ql, ql]),
                                                     torch.cat([tl, tl]), int16=int16, t_snap=t_snap, **pen)
    scores, state, cross_m = _combine_both(SNAP, DIAGA, DIAGB, ql, tl, o1=pen["o1"], o2=pen["o2"], band=band_eff)
    assert int(scores[-1]) == 0 and int(fin[-1]) == 0
    if narrow:
        assert (scores == -1).any()
    else:
        assert (scores[:-1] > 0).all()


@pytest.mark.parametrize("two_piece", [True, False])
@pytest.mark.parametrize("B,W", [(1, 1), (3, 40), (17, 129), (4, 700)])
def test_fold_combine_kernel_on_random_snapshots(cuda, B, W, two_piece):
    """The combine as a function of any snapshots: small values (many ties
    between lanes and terms), INF cells, lengths from 0 past the band, each
    pair's rows read at its own seam."""
    rng = np.random.default_rng(B * 1000 + W + two_piece)
    INF = 1 << 28
    SNAP = rng.integers(0, 12, (6, 2 * B, W)).astype(np.int32)
    DIAGA = rng.integers(0, 12, (2 * B, W)).astype(np.int32)
    DIAGB = rng.integers(0, 12, (2 * B, W)).astype(np.int32)
    for a in (SNAP, DIAGA, DIAGB):
        a[rng.random(a.shape) < 0.3] = INF
    ql = rng.integers(0, 3 * W + 3, B).astype(np.int32)
    tl = rng.integers(0, 3 * W + 3, B).astype(np.int32)
    ql[0] = tl[0] = 0
    args = [torch.from_numpy(a).to(cuda) for a in (SNAP, DIAGA, DIAGB, ql, tl)]
    _combine_both(*args, o1=8, o2=24 if two_piece else -1, band=W - 1)


def test_walk_start_on_random_cursors_equals_plain(cuda):
    """Kernel B's start mode from arbitrary cursors (every material, lanes at
    the band's edges, anti-diagonals 0 and past tmax) over a real traceback."""
    rng = np.random.default_rng(21)
    band = 255
    (Q, T, ql, tl), tmax = _pack(*_variants(rng, 24, 500, band, 0.0), cuda)
    kw = _penalties(True, band, tmax)
    _s, tb = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    B = Q.shape[0]
    cur = rng.integers(0, tmax + 3, B)
    cur[0], cur[1] = 0, tmax
    lane = rng.integers(0, band + 1, B)
    lane[2], lane[3] = 0, band
    mat = rng.integers(0, 5, B)
    state = torch.from_numpy(np.stack([cur, lane, mat, cur <= 0]).astype(np.int32)).to(cuda)
    ops_k = nw_cuda.nw_walk_start(tb, state, band=band, tmax=tmax)
    torch.cuda.synchronize()
    ops_p = nw_cuda.nw_walk_start_reference(tb, state, band=band, tmax=tmax)
    assert torch.equal(ops_k, ops_p)


@pytest.mark.parametrize(
    "B,L,band,two_piece,int16,pen2,sm_smem",
    [
        (8, 300, 63, True, False, None, None),
        (8, 300, 63, True, True, None, None),
        (8, 600, 511, False, False, None, None),  # Wr 1023: 8 lanes, 128 threads
        (7, 600, 511, True, False, None, None),
        (7, 600, 511, True, True, None, None),
        (5, 600, 512, True, False, None, None),  # Wr 1025: 8 lanes, 160 threads
        (6, 800, 1535, True, False, None, None),  # Wr 3071: 8 lanes, 384 threads
        (3, 700, 2047, True, False, None, None),  # Wr 4095: 8 lanes, 512 threads
        (3, 700, 2048, False, True, None, None),  # Wr 4097: 16 lanes, 288 threads
        (4, 700, 4095, True, True, None, None),  # Wr 8191: 16 lanes, 512 threads
        (3, 500, 4096, True, False, None, None),  # Wr 8193: 16 lanes, 544 threads
        (3, 500, 5000, True, False, None, None),  # Wr 10001: 16 lanes, 640 threads
        (8, 300, 127, True, True, 3000, None),  # int16 adds that wrap
        # rows staged a window at a time: past the share that keeps five
        # pairs an SM (R 22,784 at Wr 63: two windows of up to 21,920), and
        # with less shared memory an SM in the planner, many windows
        (3, 22600, 31, True, False, None, None),
        (7, 600, 511, True, False, None, 19400),  # six 128-row windows
        (7, 600, 511, True, True, None, 19400),
        (5, 300, 95, False, False, None, 15700),  # four 144-row windows
        (3, 700, 2048, True, False, None, 7760),  # 16 lanes, 288 threads: 272-row windows
    ],
)
def test_rows_kernels_equal_plain(cuda, monkeypatch, B, L, band, two_piece, int16, pen2, sm_smem):
    """Kernels C and D: scores, the whole row-major traceback, the steps,
    the gap list and its count exactly the plain versions'."""
    if sm_smem is not None:
        monkeypatch.setattr(nw_cuda, "_SM_SMEM", sm_smem)
    rng = np.random.default_rng(band + B)
    qs, ts = _variants(rng, B, L, band, 0.0)
    (Q, T, ql, tl), _tmax = _pack(qs, ts, cuda)
    kw = dict(mismatch=5, o1=8, e1=2, o2=(pen2 or 24) if two_piece else -1,
              e2=1 if two_piece else -1, band=band)
    if L > 20000 or sm_smem is not None:
        assert nw_cuda.rows_smem(Q.shape[1], band, *nw_cuda.rows_plan(2 * band + 1))[0] < Q.shape[1]
    before = dict(nw_cuda.LAUNCHES)
    s_k, tb_k = nw_cuda.nw_align_rows(Q, T, ql, tl, int16=int16, **kw)
    walk_k = nw_cuda.nw_walk_rows(tb_k, ql, tl, band=band)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_rows_sweep"] == before["nw_rows_sweep"] + 1
    assert nw_cuda.LAUNCHES["nw_rows_walk"] == before["nw_rows_walk"] + 1
    s_p, tb_p = nw_cuda.nw_align_rows_reference(Q, T, ql, tl, int16=int16, **kw)
    assert torch.equal(s_k, s_p) and torch.equal(tb_k, tb_p)
    walk_p = nw_cuda.nw_walk_rows_reference(tb_k, ql, tl, band=band)
    for a, b in zip(walk_k, walk_p):
        assert torch.equal(a, b)


def test_rows_occupancy_fills_card_in_one_wave(cuda):
    """At the rows run's main shape [Wr 1023, R 3,584] kernel C keeps five
    pairs on an SM, as its plan reckons."""
    occ = nw_cuda.nw_rows_occupancy(3584, 511, True)
    assert occ["resident_pairs_per_sm"] >= 5
    assert occ["resident_pairs_per_sm"] == occ["reckoned_pairs_per_sm"]


@pytest.mark.parametrize("gap_max", [1, 3, 160])
def test_rows_walk_gap_caps_equal_plain(cuda, gap_max):
    """Kernel D with more D-runs than the gap list holds: the gaps of the
    lowest rows, ascending, and the full count, as the plain version's."""
    rng = np.random.default_rng(gap_max)
    qs, ts = [], []
    for k in range(7):
        q = rng.integers(0, 4, 1500).astype(np.uint8)
        t = q.copy()
        # inserted target bases: D-runs of the walk, up to 187 of them
        for p in np.sort(rng.choice(np.arange(5, 1495), 5 + 150 * (k % 3), replace=False))[::-1]:
            t = np.insert(t, p, rng.integers(0, 4, 1 + k % 2).astype(np.uint8))
        qs.append(q)
        ts.append(t)
    (Q, T, ql, tl), _tmax = _pack(qs + [np.zeros(0, np.uint8)], ts + [np.zeros(0, np.uint8)], cuda)
    band = 639
    _s, tb = nw_cuda.nw_align_rows(Q, T, ql, tl, mismatch=5, o1=8, e1=2, o2=24, e2=1, band=band)
    walk_k = nw_cuda.nw_walk_rows(tb, ql, tl, band=band, gap_max=gap_max)
    torch.cuda.synchronize()
    walk_p = nw_cuda.nw_walk_rows_reference(tb, ql, tl, band=band, gap_max=gap_max)
    for a, b in zip(walk_k, walk_p):
        assert torch.equal(a, b)
    assert (walk_k[3] > gap_max).any()


# -- the packed int16 sweep and the tiled row walk on their edge corpora


def _twin_strips(B, W, Lq, Lt):
    """Every warps-a-twin count of the packed sweep that covers W."""
    out = []
    for w in (1, 2, 4, 8, 16, 32):
        try:
            plan = nw_cuda.plan_sweep_i16(B, W, Lq, Lt, warps_per_twin=w)
        except ValueError:
            continue
        if plan.route == "twins":
            out.append(plan)
    return out


@pytest.mark.parametrize("band", [127, 511])
@pytest.mark.parametrize("case", sorted(INT16_EDGE_PENALTIES))
def test_int16_packed_edge_corpus_equals_plain(cuda, case, band):
    """The packed int16 sweep on its edge corpus (twins of very different
    lengths, an odd B, an empty pair beside a full one, penalties at the
    int16 limit, ties in H's choice): scores and the whole traceback
    exactly the plain version's, at every warps-a-twin count and at the
    planner's pick (the int32 body's int16 mode where twins do not pay);
    the score-only mode's scores too."""
    Q, T, ql, tl, tmax = (torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
                          for a in int16_edge_corpus())
    pen = INT16_EDGE_PENALTIES[case]
    assert nw_cuda.register_route_penalties(*pen, int16=True)
    kw = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), pen), band=band, tmax=tmax, int16=True)
    B, W = Q.shape[0], band + 1
    before = dict(nw_cuda.LAUNCHES)
    s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    s_o, _ = nw_cuda.nw_align(Q, T, ql, tl, with_traceback=False, **kw)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_sweep_int16"] == before["nw_sweep_int16"] + 1
    assert nw_cuda.LAUNCHES["nw_sweep_score_only"] == before["nw_sweep_score_only"] + 1
    s_p, tb_p = nw_cuda.nw_align_reference(Q, T, ql, tl, **kw)
    assert torch.equal(s_k, s_p) and torch.equal(tb_k, tb_p) and torch.equal(s_o, s_p)
    assert int(s_k[2]) == 0 and int(s_k[1]) > 0
    strips = _twin_strips(B, W, Q.shape[1], T.shape[1])
    assert len(strips) >= (3 if W == 512 else 1)
    for plan in strips:
        s_w, tb_w = nw_cuda.sweep_launch(Q, T, ql, tl, plan, **kw)
        assert torch.equal(s_w, s_p) and torch.equal(tb_w, tb_p), plan


def test_int16_packed_occupancy(cuda):
    """At the int16 run's main shape [576, W 512] the packed sweep's plan
    spills nothing and keeps at least the twins an SM the planner reckons."""
    plan = nw_cuda.plan_sweep_i16(576, 512, 3584, 3584)
    occ = nw_cuda.sweep_occupancy(plan, 512, True)
    assert plan.route == "twins" and occ["local_bytes_per_thread"] == 0
    reck = nw_cuda.twins_reckoning(plan, 576, occ["resident_blocks_per_sm"])
    assert occ["resident_blocks_per_sm"] >= nw_cuda.twins_resident_blocks(plan) and reck["waves"] == 1


@pytest.mark.parametrize("int16,gap_max", [(False, None), (True, None), (False, 4), (True, 4)])
def test_rows_walk_edge_corpus_equals_plain(cuda, int16, gap_max):
    """Kernel D on its edge corpus (D-runs longer than a tile's lanes, an
    I-drift to the band's last lane, R not a multiple of the tile's rows,
    more D-runs than the gap list holds, int16 tracebacks): steps, gap
    rows, lengths and counts exactly the plain version's."""
    Q, T, ql, tl = (torch.from_numpy(a).to(cuda) for a in rows_edge_corpus())
    band = 63
    _s, tb = nw_cuda.nw_align_rows(Q, T, ql, tl, mismatch=5, o1=8, e1=2, o2=24, e2=1, band=band, int16=int16)
    before = nw_cuda.LAUNCHES["nw_rows_walk"]
    walk_k = nw_cuda.nw_walk_rows(tb, ql, tl, band=band, gap_max=gap_max)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_rows_walk"] == before + 1
    walk_p = nw_cuda.nw_walk_rows_reference(tb, ql, tl, band=band, gap_max=gap_max)
    for a, b in zip(walk_k, walk_p):
        assert torch.equal(a, b)
    assert int(walk_k[2].max()) >= band - 2 and int(walk_k[3].max()) > 4


@pytest.mark.parametrize("seed,band,R,plain", [(0, 63, 700, 0.9), (1, 200, 333, 0.97), (2, 511, 1100, 0.99),
                                               (3, 15, 257, 0.5)])
def test_rows_walk_random_bytes_equals_plain(cuda, seed, band, R, plain):
    """Kernel D on random traceback bytes, a share `plain` of them plain M
    (no D override, the diagonal choice), with random lengths (empty, row
    0 only, full): every state, D-run, I-drift and lane off the band the
    bytes lead to, exactly as the plain version walks it."""
    rng = np.random.default_rng(seed)
    B, Wr = 13, 2 * band + 1
    tb = rng.integers(0, 256, (B, R + 1, Wr)).astype(np.uint8)
    tb[rng.random(tb.shape) < plain] &= 0xF0
    ql = rng.integers(0, R + 1, B).astype(np.int32)
    tl = np.clip(ql + rng.integers(-band - 5, band + 6, B), 0, None).astype(np.int32)
    ql[:3], tl[:3] = (0, 0, R), (0, 7, R)
    tb, ql, tl = (torch.from_numpy(a).to(cuda) for a in (tb, ql, tl))
    for gap_max in (None, 3):
        walk_k = nw_cuda.nw_walk_rows(tb, ql, tl, band=band, gap_max=gap_max)
        torch.cuda.synchronize()
        walk_p = nw_cuda.nw_walk_rows_reference(tb, ql, tl, band=band, gap_max=gap_max)
        for a, b in zip(walk_k, walk_p):
            assert torch.equal(a, b), gap_max


@pytest.mark.parametrize("tl0", [1, 15])
@pytest.mark.parametrize("skip", [1, 2, 3])
def test_rows_walk_unaligned_view_equals_plain(cuda, skip, tl0):
    """Kernel D on a contiguous view tb[skip:] that starts off a 16-byte
    boundary (odd Wr): pair 0 starts in row 0 at lane band + tl0 with a
    D-run back to lane 0, which lies in the block that straddles the view's
    start (in the cursor's first tile at tl0 = 1, left of it at tl0 =
    band), and the walk equals the plain version's."""
    rng = np.random.default_rng(skip)
    B, R, band = 9, 40, 15
    Wr = 2 * band + 1
    cl = band + tl0
    full = rng.integers(0, 256, (B + skip, R + 1, Wr)).astype(np.uint8)
    full[rng.random(full.shape) < 0.7] &= 0xF0
    full[skip, 0] = 0
    full[skip, 0, cl] = 1 << 2  # in H, a D-run (tag 1) ends at the cursor
    full[skip, 0, 0] = 1 << 6   # and opens at lane 0
    ql = rng.integers(0, R + 1, B).astype(np.int32)
    tl = np.clip(ql + rng.integers(-band, band + 1, B), 0, None).astype(np.int32)
    ql[0], tl[0] = 0, tl0
    tb = torch.from_numpy(full).to(cuda)[skip:]
    ql, tl = (torch.from_numpy(a).to(cuda) for a in (ql, tl))
    assert tb.is_contiguous() and tb.data_ptr() % 16
    walk_k = nw_cuda.nw_walk_rows(tb, ql, tl, band=band)
    torch.cuda.synchronize()
    walk_p = nw_cuda.nw_walk_rows_reference(tb, ql, tl, band=band)
    assert int(walk_p[2][0, 0]) == cl + 1
    for a, b in zip(walk_k, walk_p):
        assert torch.equal(a, b)


# -- band tiling: kernel A's tiled mode and kernel B's tiled runs mode


def _tiled_batch(rng, band, R, n_narrow, n_wide, L):
    """n_narrow variant pairs and n_wide inversion-carrying ones of length
    ~L in the tiled row layout (narrow rows, then R rows a wide pair, wide
    rows holding their pair), plus a zero-length padding row."""
    qs, ts = _variants(rng, n_narrow + n_wide + 1, L, band, 0.3)
    qs, ts = qs[:-1], ts[:-1]
    order = list(range(0, n_narrow + n_wide, 2)) + list(range(1, n_narrow + n_wide, 2))
    narrow, wide = order[:n_narrow], order[n_narrow:]  # the inversion carriers are odd
    rows = [(k, 0) for k in narrow] + [(k, r) for k in wide for r in range(R)] + [(None, 0)]
    rq = [qs[k] if k is not None else np.zeros(0, np.uint8) for k, _r in rows]
    rt = [ts[k] if k is not None else np.zeros(0, np.uint8) for k, _r in rows]
    tile = np.array([r for _k, r in rows], np.int32)
    is_wide = np.array([k in wide for k, _r in rows])
    return rq, rt, tile, is_wide


def _gap_tiled_batch(R):
    """The walk gap corpus in the tiled row layout: its gappiest pairs (the D
    runs of 150 and 200, the many-gap pair, both band-edge pairs) wide, R
    rows each, the rest narrow, then a zero-length padding row."""
    pairs = walk_gap_pairs()[:-1]
    gappy = {6, 7, 8, 11, 12}
    rows = [(k, 0) for k in range(len(pairs)) if k not in gappy]
    rows += [(k, r) for k in sorted(gappy) for r in range(R)] + [(None, 0)]
    empty = np.zeros(0, np.uint8)
    qs = [pairs[k][0] if k is not None else empty for k, _r in rows]
    ts = [pairs[k][1] if k is not None else empty for k, _r in rows]
    tile = np.array([r for _k, r in rows], np.int32)
    is_wide = np.array([k in gappy for k, _r in rows])
    return qs, ts, tile, is_wide


def _tiled_rows_equal(tb_k, tb_p, ql, tl, tile, is_wide, R, tmax):
    """Whether two tiled tracebacks agree on every row the tiled mode
    promises (nw_cuda.tiled_promised_rows: each pair's rows 0 .. min(tmax,
    t_final + 2); the register route leaves the rest unwritten)."""
    keep = nw_cuda.tiled_promised_rows(ql, tl, tile, is_wide, R, tmax, tb_k.shape[1])
    return masked_rows_err(tb_k, tb_p, keep) == 0


@pytest.mark.parametrize(
    "band,R,int16,pen",
    [
        (63, 2, False, (5, 8, 2, 24, 1)),
        (63, 3, True, (5, 8, 2, 24, 1)),
        (63, 4, False, (5, 8, 2, -1, -1)),  # one-piece
        (101, 2, True, (5, 8, 2, 24, 1)),  # W 102: strips and walk windows cross tile rows
        (101, 3, False, (5, 8, 2, 24, 1)),
        (101, 4, True, (5, 8, 2, 24, 1)),
        (511, 3, False, (5, 8, 2, 24, 1)),  # the headline's merge: 512 and 1536 lanes
        (101, 3, True, (5, 8, 2, 3000, 1)),  # int16 adds that wrap: the wide route
        (1099, 4, True, (5, 8, 2, 24, 1)),  # 4400 lanes: the wide route
        # the walk gap corpus, its gappiest pairs wide: windows that straddle
        # tile rows at any offset (W 200), and tile rows of fewer than 32
        # lanes (W 16), each window the tile row's own lanes of its sector
        (199, 2, False, "gaps"),
        (199, 3, True, "gaps"),
        (15, 3, False, "gaps"),
    ],
)
def test_tiled_kernels_equal_plain(cuda, band, R, int16, pen):
    """Kernel A's tiled mode (scores, the tile-row traceback on every row
    it promises: each pair's rows up to t_final + 2) and kernel B's tiled
    runs mode (tokens, counts, on the kernel's traceback and on the plain
    version's whole one) exactly their plain versions', each launched
    once."""
    rng = np.random.default_rng(band * 10 + R)
    L = 3 * (band + 1) if band < 500 else 1400
    gaps = pen == "gaps"
    if gaps:
        qs, ts, tile, is_wide = _gap_tiled_batch(R)
        pen = (5, 8, 2, 24, 1)
    else:
        qs, ts, tile, is_wide = _tiled_batch(rng, band, R, 5, 3, L)
    (Q, T, ql, tl), tmax = _pack(qs, ts, cuda)
    kw = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), pen), band=band, n_tiles=R, tmax=tmax, int16=int16)
    before = dict(nw_cuda.LAUNCHES)
    s_k, tb_k = nw_cuda.nw_align_tiled(Q, T, ql, tl, tile, is_wide, **kw)
    lay = dict(band=band, n_tiles=R, tmax=tmax, run_max=64)
    tok_k, cnt_k = nw_cuda.nw_walk_runs_tiled(tb_k, ql, tl, tile, is_wide, **lay)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_sweep_tiled"] == before["nw_sweep_tiled"] + 1
    assert nw_cuda.LAUNCHES["nw_walk_runs_tiled"] == before["nw_walk_runs_tiled"] + 1
    s_p, tb_p = nw_cuda.nw_align_tiled_reference(Q, T, ql, tl, tile, is_wide, **kw)
    assert torch.equal(s_k, s_p)
    assert _tiled_rows_equal(tb_k, tb_p, ql, tl, tile, is_wide, R, tmax)
    tok_p, cnt_p = nw_cuda.nw_walk_runs_tiled_reference(tb_k, ql, tl, tile, is_wide, **lay)
    assert torch.equal(tok_k, tok_p) and torch.equal(cnt_k, cnt_p)
    tok_w, cnt_w = nw_cuda.nw_walk_runs_tiled_reference(tb_p, ql, tl, tile, is_wide, **lay)
    assert torch.equal(tok_k, tok_w) and torch.equal(cnt_k, cnt_w)
    first = torch.from_numpy((tile == 0) & (np.arange(len(tile)) < len(tile) - 1)).to(cuda)
    assert bool((cnt_k[first] > 0).all())
    # int16 adds past 32,767 wrap, as the JAX package's do: negative scores there
    # (W 16 leaves the corpus's long gaps' final cells off the band: score -1)
    if not (gaps and band < 32):
        assert bool((s_k[first] >= 0).all()) == (not int16 or pen[3] < 3000)


@pytest.mark.parametrize("lanes", [8, 12, 16])
def test_tiled_sweep_every_strip_equals_plain(cuda, lanes):
    """Kernel A's tiled mode at each lanes-per-thread shape that fits the
    headline's merge (W 512, 3 tiles; 4 lanes would need 384 threads, over
    that strip's 128-thread bound), against the plain version on every row
    it promises."""
    rng = np.random.default_rng(lanes)
    band, R = 511, 3
    qs, ts, tile, is_wide = _tiled_batch(rng, band, R, 4, 2, 1200)
    (Q, T, ql, tl), tmax = _pack(qs, ts, cuda)
    wpp = -(-(band + 1) // (32 * lanes))
    threads = 32 * wpp * R
    assert threads <= nw_cuda._MAX_THREADS[lanes]
    pair_bytes = nw_cuda.pair_smem_bytes(Q.shape[1], T.shape[1], band + 1, lanes, wpp)
    smem = max(R * pair_bytes, nw_cuda.pair_smem_bytes(Q.shape[1], T.shape[1], R * (band + 1), lanes, wpp * R))
    order, n_wide = nw_cuda._tiled_order(tile, is_wide, R, band, len(tile), cuda)
    plan = nw_cuda.TiledPlan("regs", lanes, wpp, threads, pair_bytes, smem, 0)
    kw = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1, band=band, n_tiles=R, tmax=tmax)
    s_k, tb_k = nw_cuda.sweep_tiled_launch(Q, T, ql, tl, order, n_wide, plan, **kw)
    torch.cuda.synchronize()
    s_p, tb_p = nw_cuda.nw_align_tiled_reference(Q, T, ql, tl, tile, is_wide, **kw)
    assert torch.equal(s_k, s_p) and _tiled_rows_equal(tb_k, tb_p, ql, tl, tile, is_wide, R, tmax)


def _tiled_layout_batch(rng, case):
    """The tiled row layout (narrow rows, then R rows a wide pair) of one
    case: (qs, ts, tile, is_wide, band, R)."""
    empty = np.zeros(0, np.uint8)
    band, R = 511, 3
    if case == "few_blocks":  # 4 blocks on 132 SMs
        qs, ts, tile, is_wide = _tiled_batch(rng, band, R, 3, 1, 1400)
        return qs, ts, tile, is_wide, band, R
    if case == "rounds":  # 571 blocks of 6 warps, two resident an SM: more than two rounds
        qs, ts, tile, is_wide = _tiled_batch(rng, band, R, 1700, 4, 160)
        return qs, ts, tile, is_wide, band, R
    if case == "padding":  # zero-length rows among the narrow ones, and one-sided empty pairs
        qs, ts, tile, is_wide = _tiled_batch(rng, band, R, 6, 2, 900)
        for k in (1, 3):
            qs[k], ts[k] = empty, empty
        qs[4] = empty
        ts[5] = empty
        return qs, ts, tile, is_wide, band, R
    # short_wide: wide pairs of 60 bases among narrow pairs of 1,400
    qs, ts, tile, is_wide = _tiled_batch(rng, band, R, 5, 2, 1400)
    short = rng.integers(0, 4, 60).astype(np.uint8)
    for b in np.flatnonzero(is_wide):
        qs[b], ts[b] = short, short[::-1].copy()
    return qs, ts, tile, is_wide, band, R


@pytest.mark.parametrize("case", ["few_blocks", "rounds", "padding", "short_wide"])
@pytest.mark.parametrize("int16", [False, True])
@pytest.mark.parametrize("two_piece", [False, True])
@pytest.mark.parametrize("lanes", [8, 16])
def test_tiled_sweep_layouts_equal_plain(cuda, case, int16, two_piece, lanes):
    """Kernel A's tiled register route against the plain version, scores
    and every promised row exactly, on fewer blocks than SMs, more than two
    rounds of blocks, zero-length and one-sided empty pairs, and wide pairs
    much shorter than the narrow ones (ending thousands of anti-diagonals
    before them), in int32 and int16, one- and two-piece, at 8 lanes a
    thread (the headline merge's strip) and 16 (the planner's pick for
    these batches)."""
    rng = np.random.default_rng(sum(map(ord, case)) + 2 * int16 + two_piece)
    qs, ts, tile, is_wide, band, R = _tiled_layout_batch(rng, case)
    (Q, T, ql, tl), tmax = _pack(qs, ts, cuda)
    pen = (5, 8, 2, 24, 1) if two_piece else (5, 8, 2, -1, -1)
    kw = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), pen), band=band, n_tiles=R, tmax=tmax, int16=int16)
    order, n_wide = nw_cuda._tiled_order(tile, is_wide, R, band, len(tile), cuda)
    W = band + 1
    wpp = -(-W // (32 * lanes))
    pair_bytes = nw_cuda.pair_smem_bytes(Q.shape[1], T.shape[1], W, lanes, wpp)
    plan = nw_cuda.TiledPlan("regs", lanes, wpp, 32 * wpp * R, pair_bytes,
                             max(R * pair_bytes, nw_cuda.pair_smem_bytes(Q.shape[1], T.shape[1], R * W, lanes, wpp * R)),
                             n_wide + -(-(order.numel() - n_wide) // R))
    if case == "few_blocks":
        assert plan.blocks < torch.cuda.get_device_properties(cuda).multi_processor_count
    if case == "rounds":
        occ = nw_cuda.tiled_occupancy(plan, two_piece, W)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert plan.blocks > 2 * sms * occ["resident_blocks_per_sm"]
    s_k, tb_k = nw_cuda.sweep_tiled_launch(Q, T, ql, tl, order, n_wide, plan, **kw)
    torch.cuda.synchronize()
    s_p, tb_p = nw_cuda.nw_align_tiled_reference(Q, T, ql, tl, tile, is_wide, **kw)
    assert torch.equal(s_k, s_p)
    assert _tiled_rows_equal(tb_k, tb_p, ql, tl, tile, is_wide, R, tmax)
    lay = dict(band=band, n_tiles=R, tmax=tmax, run_max=64)
    tok_k, cnt_k = nw_cuda.nw_walk_runs_tiled(tb_k, ql, tl, tile, is_wide, **lay)
    tok_p, cnt_p = nw_cuda.nw_walk_runs_tiled_reference(tb_p, ql, tl, tile, is_wide, **lay)
    assert torch.equal(tok_k, tok_p) and torch.equal(cnt_k, cnt_p)


def test_tiled_timer_split(cuda):
    """The register route's timed instantiation (nw_cuda.sweep_tiled_split)
    gives the untimed launch's outputs and puts every launched block on
    some SM; a plan whose W is not a multiple of its strip has no timed
    instantiation and raises."""
    rng = np.random.default_rng(31)
    qs, ts, tile, is_wide = _tiled_batch(rng, 511, 3, 6, 2, 1400)
    (Q, T, ql, tl), tmax = _pack(qs, ts, cuda)
    kw = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1, band=511, n_tiles=3, tmax=tmax)
    order, n_wide = nw_cuda._tiled_order(tile, is_wide, 3, 511, len(tile), cuda)
    plan = nw_cuda.plan_sweep_tiled(order.numel() - n_wide, n_wide, 512, 3, Q.shape[1], T.shape[1])
    s_k, tb_k = nw_cuda.nw_align_tiled(Q, T, ql, tl, tile, is_wide, **kw)
    s_t, tb_t, split = nw_cuda.sweep_tiled_split(Q, T, ql, tl, order, n_wide, plan, **kw)
    assert torch.equal(s_t, s_k) and _tiled_rows_equal(tb_t, tb_k, ql, tl, tile, is_wide, 3, tmax)
    assert sum(int(k) * v for k, v in split["sm_blocks"].items()) == plan.blocks
    assert split["wide_block_ms"]["max"] > 0 and split["narrow_block_ms"]["max"] > 0
    qs, ts, tile, is_wide = _tiled_batch(rng, 101, 3, 4, 2, 300)
    (Q, T, ql, tl), tmax = _pack(qs, ts, cuda)
    order, n_wide = nw_cuda._tiled_order(tile, is_wide, 3, 101, len(tile), cuda)
    plan = nw_cuda.TiledPlan("regs", 8, 1, 96, nw_cuda.pair_smem_bytes(Q.shape[1], T.shape[1], 102, 8, 1),
                             3 * nw_cuda.pair_smem_bytes(Q.shape[1], T.shape[1], 306, 8, 3),
                             n_wide + -(-(order.numel() - n_wide) // 3))
    with pytest.raises(RuntimeError):
        nw_cuda.sweep_tiled_split(Q, T, ql, tl, order, n_wide, plan, **dict(kw, band=101, tmax=tmax))


def test_tiled_runner_equals_untiled(cuda):
    """WfaAligner(band_tiling='auto') on the card: at least one tiled chunk,
    the records of the untiled run."""
    from seqrush_tpu_torch.align.pairs import all_ordered_pairs
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
    from seqrush_tpu_torch.scores import AlignmentScores
    from seqrush_tpu_torch.sequences import make_sequence_set

    # tests/test_tiled.py's _bench_like_seqs(): 2% SNPs, the last one inverted
    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, 900).astype(np.uint8)
    codes = [base]
    for k in range(1, 8):
        s = base.copy()
        for p in rng.integers(0, 900, 18):
            s[p] = rng.integers(0, 4)
        if k == 7:
            s[300:600] = (3 - s[300:600])[::-1]
        codes.append(s)
    named = [(f"s{k}", np.frombuffer(b"ACGT", np.uint8)[c].tobytes()) for k, c in enumerate(codes)]
    pairs = all_ordered_pairs(8)

    def run(tiling):
        cfg = RunnerConfig(scores=AlignmentScores.parse("0,5,8,2,24,1"), band_tiling=tiling,
                           memory_budget_bytes=int(70e6))
        al = WfaAligner(make_sequence_set(named), cfg, device="cuda")
        res = al.align_pairs(pairs)
        return al, [(r.query_idx, r.target_idx, r.is_reverse, r.score, r.cigar_string) for r in res]

    on, res_on = run("auto")
    off, res_off = run("off")
    assert on.stats["tiled_chunks"] >= 1 and off.stats["tiled_chunks"] == 0
    assert res_on == res_off


def _sharded_case(rng, n_pairs, L, band):
    """n_pairs variant pairs of length ~L (SNPs and an indel, the last pair
    holding a 2*L/5 translocation) plus one zero-length row, QPAD / TPAD
    packed on the card; tmax with an odd tmax - band."""
    qs, ts = [], []
    for k in range(n_pairs):
        q = rng.integers(0, 4, L).astype(np.uint8)
        t = q.copy()
        t[rng.integers(0, L, L // 40)] = rng.integers(0, 4, L // 40)
        t = np.delete(t, np.arange(L // 3, L // 3 + 5 + k))
        if k == n_pairs - 1:
            a, b = L // 5, 3 * L // 5
            t = np.concatenate([t[:a], t[b:], t[a:b]])
        qs.append(q)
        ts.append(t)
    qs.append(np.zeros(0, np.uint8))
    ts.append(np.zeros(0, np.uint8))
    (Q, T, ql, tl), _tmax = _pack(qs, ts, torch.device("cuda"))
    tmax = int((ql + tl).max())
    tmax += (tmax - band) % 2 == 0
    return Q, T, ql, tl, tmax


def _sharded_equal(s_k, strips_k, s_p, strips_p) -> bool:
    return torch.equal(s_k, s_p) and all(torch.equal(a, b) for a, b in zip(strips_k, strips_p))


@pytest.mark.parametrize("D,band,two_piece", [
    *((D, band, two) for D in (1, 2, 4, 8) for band, two in ((255, True), (1023, True), (511, False))),
    (1, 279, True),    # Wl 280: 4 lanes a thread, CTAs of 4 and 5 units, a warp each
    (2, 699, True),    # Wl 350: 2 lanes a thread
    (3, 104, False),   # Wl 35: one lane a thread, three shards on one card
])
def test_sharded_sweep_equals_plain(cuda, D, band, two_piece):
    """Kernel A's sharded mode, D shards on one card (Mesh([cuda:0] * D)),
    four rows (three pairs and an empty one): scores and every strip equal
    the plain version's at the planner's pick and at every cluster size the
    planner takes (16 CTAs a cluster: D x CTAs a shard = 16); a cluster size
    whose clusters cannot all be resident raises."""
    Q, T, ql, tl, tmax = _sharded_case(np.random.default_rng(D + band), 3, 700, band)
    kw = dict(mismatch=5, o1=8, e1=2, o2=24 if two_piece else -1, e2=1 if two_piece else -1, band=band, tmax=tmax)
    before = nw_cuda.LAUNCHES["nw_sweep_sharded"]
    s_k, strips_k = nw_cuda.nw_align_sharded([cuda] * D, Q, T, ql, tl, **kw)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_sweep_sharded"] == before + 1
    s_p, strips_p = nw_cuda.nw_align_sharded_reference(Q, T, ql, tl, n_shards=D, **kw)
    assert _sharded_equal(s_k, strips_k, s_p, strips_p)
    assert int(s_k[-1]) == 0 and (s_k[:-1] > 0).all()
    sizes = nw_cuda.shard_cluster_sizes(band, D, D)
    assert 16 in sizes
    for cs in sizes:
        plan = nw_cuda.shard_plan(band, D, D, cs)
        if Q.shape[0] * plan.clusters > nw_cuda.shard_capacity(cuda, plan, two_piece):
            with pytest.raises(RuntimeError, match="resident"):
                nw_cuda.nw_align_sharded_at([cuda] * D, Q, T, ql, tl, cluster=cs, **kw)
            continue
        assert _sharded_equal(*nw_cuda.nw_align_sharded_at([cuda] * D, Q, T, ql, tl, cluster=cs, **kw),
                              s_p, strips_p), cs


def test_sharded_sweep_scratch_rows_equal_plain(cuda):
    """A shard too wide for one CTA (Wl 6,144, whose DP rows once went to a
    global scratch): at the planner's pick, and at one CTA a cluster, where
    four clusters of one pair hand their columns over through global memory
    with flags."""
    band = 6143
    assert nw_cuda.shard_plan(band, 1, 1, 1).clusters > 1
    Q, T, ql, tl, tmax = _sharded_case(np.random.default_rng(1), 1, 3000, band)
    kw = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1, band=band, tmax=tmax)
    s_p, strips_p = nw_cuda.nw_align_sharded_reference(Q, T, ql, tl, n_shards=1, **kw)
    assert _sharded_equal(*nw_cuda.nw_align_sharded([cuda], Q, T, ql, tl, **kw), s_p, strips_p)
    assert _sharded_equal(*nw_cuda.nw_align_sharded_at([cuda], Q, T, ql, tl, cluster=1, **kw), s_p, strips_p)


def test_sharded_sweep_distinct_devices_equal_plain(cuda):
    """Shards on two cards (peer access, system-scope flags): the strips of
    the plain version, each on its card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    devs = [torch.device("cuda", 0)] * 2 + [torch.device("cuda", 1)] * 2
    Q, T, ql, tl, tmax = _sharded_case(np.random.default_rng(2), 3, 700, 1023)
    kw = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1, band=1023, tmax=tmax)
    s_k, strips_k = nw_cuda.nw_align_sharded(devs, Q, T, ql, tl, **kw)
    s_p, strips_p = nw_cuda.nw_align_sharded_reference(Q, T, ql, tl, n_shards=4, **kw)
    assert torch.equal(s_k, s_p)
    for a, b, dev in zip(strips_k, strips_p, devs):
        assert a.device == dev and torch.equal(a.cpu(), b.cpu())


def test_mesh_runner_and_band_shard_on_card(cuda):
    """WfaAligner under Mesh([cuda:0] * 2): the records of the run without a
    mesh, and an over-budget pair through the band-sharded route with the
    score of the run without a mesh."""
    from seqrush_tpu_torch.align.pairs import all_ordered_pairs
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
    from seqrush_tpu_torch.parallel.mesh import Mesh
    from seqrush_tpu_torch.sequences import make_sequence_set

    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    A, B, C, X = (acgt[rng.integers(0, 4, n)].tobytes() for n in (250, 300, 250, 400))
    named = [("q", A + X + B + C), ("t", A + B + X + C), ("u", A + X + B + C[:200])]
    pairs = all_ordered_pairs(3)

    def run(mesh):
        al = WfaAligner(make_sequence_set(named), RunnerConfig(mesh=mesh, memory_budget_bytes=4_000_000,
                                                               wide_route="full"), device="cuda")
        res = al.align_pairs(pairs)
        return al, [(r.query_idx, r.target_idx, r.is_reverse, r.score) for r in res]

    plain, rec_plain = run(None)
    meshed, rec_mesh = run(Mesh([cuda] * 2))
    assert meshed.stats["band_sharded"] >= 1 and plain.stats["band_sharded"] == 0
    assert rec_mesh == rec_plain


# -- the union-find (ops/csrc/unionfind.cu) ---------------------------------------


@pytest.mark.parametrize("name", sorted(uf_cases()))
def test_unionfind_kernels_equal_plain(cuda, name):
    """unite_edges, compress and find on the card against their plain
    versions on the card and on the CPU, bit for bit, on the CPU tests'
    cases (input forests uncompressed with roots that are not minima,
    self-loops and duplicates, a reversed chain, a star, match runs, no
    edges); the input parent is left as it was."""
    parent, u, v = uf_cases()[name]
    p = torch.from_numpy(parent.copy()).to(cuda)
    before = dict(nw_cuda.LAUNCHES)
    got = uf.unite_edges(p, u, v)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["uf_unite"] == before["uf_unite"] + 1
    assert nw_cuda.LAUNCHES["uf_compress"] == before["uf_compress"]
    assert got.dtype == torch.int32 and got.device == p.device
    assert torch.equal(got, uf.unite_edges_reference(p, u, v))
    assert torch.equal(got.cpu(), uf.unite_edges_reference(torch.from_numpy(parent.copy()), u, v))
    assert torch.equal(uf.compress(p), uf.compress_reference(p))
    pos = np.concatenate([np.arange(parent.size), np.arange(parent.size)[::-3]])
    found = uf.find(p, pos)
    assert found.shape == pos.shape and torch.equal(found, uf.find_reference(p, pos))
    assert torch.equal(uf.find(p, pos.reshape(1, -1)), found.reshape(1, -1))
    assert torch.equal(p.cpu(), torch.from_numpy(parent))


def _pre_united(cuda, n_seqs, length):
    return uf.unite_edges(uf.create(2 * n_seqs * length + 2, cuda), *pre_unite_edges(n_seqs * length))


@pytest.mark.parametrize("n_seqs,n_edges", [(200, 1_000_000), (1000, 6_000_000)])
def test_unionfind_run_edges_equal_plain(cuda, n_seqs, n_edges):
    """A flush of match runs of 20-400 positions between random pairs on
    both strands after the F/R pre-unite (1.32 M and 6.6 M slots): the
    kernel's parent equals the plain version's on the card; three kernel
    runs are equal; every root is its component's minimum Pos."""
    length = 3300
    p0 = _pre_united(cuda, n_seqs, length)
    assert torch.equal(p0, uf.unite_edges_reference(uf.create(p0.numel(), cuda),
                                                    *pre_unite_edges(n_seqs * length)))
    u, v = synth_flush_edges(n_seqs=n_seqs, length=length, n_edges=n_edges, seed=n_seqs)
    ud, vd = torch.from_numpy(u).to(cuda), torch.from_numpy(v).to(cuda)
    runs = [uf.unite_edges(p0, ud, vd) for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    assert torch.equal(runs[0], uf.unite_edges_reference(p0, ud, vd))
    idx = torch.arange(p0.numel(), device=cuda, dtype=torch.int32)
    first = torch.full_like(idx, p0.numel()).scatter_reduce(0, runs[0].long(), idx, reduce="amin")
    assert torch.equal(first[runs[0].long()], runs[0])


@pytest.mark.parametrize("name", ["star", "reverse_chain", "self_loops_duplicates", "runs", "flush_2m"])
def test_unionfind_ten_runs_equal_plain(cuda, name):
    """Ten unites of one input on the card give one parent, the plain
    version's: a star (every edge onto one root, the CAS's most shared
    target), a chain given in reverse order (the longest climbs),
    self-loops and duplicate edges, match runs, and a 2 M-edge flush of
    match runs after the F/R pre-unite (tools/headline.py::
    synth_flush_edges)."""
    if name == "flush_2m":
        p0 = _pre_united(cuda, 300, 3300)
        u, v = synth_flush_edges(n_seqs=300, length=3300, n_edges=2_000_000, seed=7)
    else:
        parent, u, v = uf_cases()[name]
        p0 = torch.from_numpy(parent).to(cuda)
    ud, vd = torch.from_numpy(u).to(cuda), torch.from_numpy(v).to(cuda)
    want = uf.unite_edges_reference(p0, ud, vd)
    for _ in range(10):
        assert torch.equal(uf.unite_edges(p0, ud, vd), want)


def test_unite_grid_fits_the_card(cuda):
    """The unite's cooperative grid is what the card holds at once or less:
    a launch at the full grid and at one block more (refused, raising)."""
    bps, sms = uf._occupancy(cuda)
    assert bps >= 1 and sms == torch.cuda.get_device_properties(cuda).multi_processor_count
    parent, u, v = uf_cases()["runs"]
    p = torch.from_numpy(parent).to(cuda)
    ud, vd = uf.edges_on(u, cuda), uf.edges_on(v, cuda)
    want = uf.unite_edges_reference(p, ud, vd)
    for grid in (1, bps * sms):
        out = p.clone()
        uf._launch("uf_unite", cuda, out.data_ptr(), ud.data_ptr(), vd.data_ptr(), ud.numel(), out.numel(), grid)
        assert torch.equal(out, want)
    with pytest.raises(RuntimeError):
        uf._launch("uf_unite", cuda, p.clone().data_ptr(), ud.data_ptr(), vd.data_ptr(), ud.numel(), p.numel(),
                   bps * sms + 1)


def test_unionfind_edge_types_equal(cuda):
    """Edges as int64 and int32 numpy, as int32 and int64 tensors on the
    CPU and on the card: one parent."""
    u, v = synth_flush_edges(n_seqs=40, length=3300, n_edges=200_000, seed=3)
    p0 = _pre_united(cuda, 40, 3300)
    want = uf.unite_edges_reference(p0, u, v)
    for conv in (lambda a: a, lambda a: a.astype(np.int32), lambda a: torch.from_numpy(a),
                 lambda a: torch.from_numpy(a.astype(np.int32)), lambda a: torch.from_numpy(a).to(cuda),
                 lambda a: torch.from_numpy(a.astype(np.int32)).to(cuda)):
        assert torch.equal(uf.unite_edges(p0, conv(u), conv(v)), want)


def test_unite_is_two_launches_and_reads_nothing_back(cuda):
    """With the edges on the card a unite is exactly one launch (the hook
    and the compress behind a grid barrier; two launches before the fused
    design) and no device-to-host read (torch's sync debug mode raises on
    one); compress and find one launch each, also without a read."""
    parent, u, v = uf_cases()["runs"]
    p = torch.from_numpy(parent).to(cuda)
    ud, vd = torch.from_numpy(u).to(cuda), torch.from_numpy(v).to(cuda)
    uf.unite_edges(p, ud, vd)
    torch.cuda.synchronize()
    nw_cuda.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = uf.unite_edges(p, ud, vd)
        launched = dict(nw_cuda.LAUNCHES)
        uf.compress(out)
        roots = uf.find(out, ud)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sum(launched.values()) == 1 and launched["uf_unite"] == 1
    assert nw_cuda.LAUNCHES["uf_compress"] == 1 and nw_cuda.LAUNCHES["uf_find"] == 1
    assert torch.equal(roots, uf.find_reference(out, ud))


def test_unionfind_refuses_what_the_kernel_does_not_take(cuda):
    p = uf.create(10, cuda)
    with pytest.raises(ValueError):
        uf.unite_edges(p.long(), np.array([1]), np.array([2]))
    with pytest.raises(ValueError):
        uf.compress(torch.arange(20, dtype=torch.int32, device=cuda)[::2])
    with pytest.raises(ValueError):
        uf.unite_edges(p, np.array([1, 2]), np.array([2]))
