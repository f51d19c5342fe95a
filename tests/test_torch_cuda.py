"""Kernels A and B on the card against their plain versions, and the
pipeline on cuda against cpu.  Marked ``cuda``; each test skips without a
CUDA device.  This file imports nothing of JAX, so it runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from seqrush_tpu_torch import cli
from seqrush_tpu_torch.ops import nw_cuda

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
        ("variants", 4, 700, 5375, True, 0.3),  # wide route: rows in global scratch
        ("variants", 4, 700, 5281, True, 0.3),  # W 5282: the widest with rows in shared memory
        ("variants", 4, 700, 5282, False, 0.3),  # W 5283: the first with rows in global scratch
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
    ],
)
def test_kernels_equal_plain_versions(cuda, kind, B, L, band, two_piece, inv):
    """Exact equality (integers): scores, the whole traceback tensor, opcodes."""
    rng = np.random.default_rng(band + B)
    make = {"variants": _variants, "ties": _ties, "edges": _edges}[kind]
    (Q, T, ql, tl), tmax = _pack(*make(rng, B, L, band, inv), cuda)
    kw = _penalties(two_piece, band, tmax)
    before = dict(nw_cuda.LAUNCHES)
    s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    ops_k = nw_cuda.nw_walk(tb_k, ql, tl, band=band, tmax=tmax)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_sweep"] == before["nw_sweep"] + 1
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
        (511, "wide", True),  # rows in shared memory
        (511, "scratch", False),  # rows in global scratch
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
        p = nw_cuda.SweepPlan("wide", 0, W // 32, 1, W, 0, 0, B)
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
