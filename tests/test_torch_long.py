"""The long-pair route of seqrush_tpu_torch (device='cpu': the plain versions
of kernels A and B in their segment modes) against seqrush_tpu's segmented
sweep (``ops/nw.py::_nw_segment``, ``_tb_scan_segment``, ``nw_align_long``),
its runner and its pipeline.

Everything is integer, so every comparison is exact equality: carries,
traceback rows, walk states, opcodes, scores, CIGARs, counters and GFA bytes.
The boundary cases put a pair's final anti-diagonal on the first, the last
and the second-to-last row of a segment, let the pairs of one batch end in
different segments, keep a zero-length padding row, and give a band K >= seg
so that a segment boundary falls in the band's corner phase.
"""

import functools
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import seqrush_tpu.pipeline as jax_pipeline
import seqrush_tpu_torch.pipeline as port_pipeline
from seqrush_tpu.align.runner import RunnerConfig as JaxRunnerConfig
from seqrush_tpu.align.runner import WfaAligner as JaxAligner
from seqrush_tpu.cli import main as jax_main
from seqrush_tpu.config import Args as JaxArgs
from seqrush_tpu.ops import nw as jnw
from seqrush_tpu.ops.wfa import Penalties
from seqrush_tpu.scores import AlignmentScores as JaxScores
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.config import Args
from seqrush_tpu_torch.ops import nw as tnw
from seqrush_tpu_torch.ops import nw_cuda
from seqrush_tpu_torch.scores import AlignmentScores
from seqrush_tpu_torch.sequences import make_sequence_set

SCORES = "0,5,8,2,24,1"
BASES = np.frombuffer(b"ACGT", np.uint8)


def _pen(two_piece):
    return dict(mismatch=5, o1=8, e1=2, o2=24 if two_piece else -1, e2=1 if two_piece else -1)


def _boundary_batch(seg, seed):
    """Pairs whose qlen + tlen falls on segment 1's first row (seg + 1), its
    last row (2 seg) and second-to-last row (2 seg - 1), inside segment 2
    (3 seg - 37), and a zero-length padding row; SNPs, a deletion or an
    insertion, lengths unequal.  Returns (Q, T, qlens, tlens) numpy arrays,
    padded to a multiple of 64 with QPAD/TPAD."""
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
    lq = -(-max(q.size for q in qs) // 64) * 64
    lt = -(-max(t.size for t in ts) // 64) * 64
    Q = np.full((len(qs), lq), tnw.QPAD, np.uint8)
    T = np.full((len(ts), lt), tnw.TPAD, np.uint8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        Q[b, : q.size] = q
        T[b, : t.size] = t
    return Q, T, np.array([q.size for q in qs], np.int32), np.array([t.size for t in ts], np.int32)


# (seg, band, two_piece): both segment lengths, both penalty kinds, and for
# each segment length a band K >= seg
CASES = [(256, 63, True), (256, 300, False), (512, 63, False), (512, 600, True)]


def _jax_segments(Q, T, ql, tl, band, seg, two_piece):
    """nw._nw_segment chained over every segment from the initial rows:
    [(carry in as [6, B, W], scores in, carry out, scores out, tb_seg)]."""
    B, W = Q.shape[0], band + 1
    n_seg = -(-int((ql + tl).max()) // seg)
    carry = np.full((6, B, W), tnw.INF, np.int32)
    carry[0, :, 0] = 0
    scores = np.full(B, -1, np.int32)
    out = []
    for s in range(n_seg):
        c, tb = jnw._nw_segment(Q, T, ql, tl, s * seg, *(jnp.asarray(x) for x in carry),
                                jnp.asarray(scores), band=band, seg=seg, **_pen(two_piece))
        c_out = np.stack([np.asarray(x) for x in c[:6]])
        s_out = np.array(c[6])
        out.append((carry, scores, c_out, s_out, np.array(tb)))
        carry, scores = c_out, s_out
    return out


@pytest.mark.parametrize("seg,band,two_piece", CASES)
def test_segment_sweep_equals_nw_segment(seg, band, two_piece):
    """nw_align_segment (plain version) chained over every segment equals
    _nw_segment chained the same way: the carry, the scores and every
    traceback row of every segment, rows past a pair's end included."""
    Q, T, ql, tl = _boundary_batch(seg, seed=seg + band)
    ref = _jax_segments(Q, T, ql, tl, band, seg, two_piece)
    assert len(ref) == 3
    args = [torch.from_numpy(a) for a in (Q, T, ql, tl)]
    carry = nw_cuda.initial_carry(Q.shape[0], band + 1, "cpu")
    scores = torch.full((Q.shape[0],), -1, dtype=torch.int32)
    assert (carry.numpy() == ref[0][0]).all()
    for s, (_c_in, _s_in, c_ref, s_ref, tb_ref) in enumerate(ref):
        carry, scores, tb = nw_cuda.nw_align_segment(*args, carry, scores, t0=s * seg, seg=seg,
                                                     band=band, **_pen(two_piece))
        assert tb.shape == (Q.shape[0], seg, band + 1)
        assert (carry.numpy() == c_ref).all(), s
        assert (scores.numpy() == s_ref).all(), s
        assert (tb.numpy() == tb_ref).all(), s
        # score-only: the same carry and scores, no traceback
        c_o, s_o, none = nw_cuda.nw_align_segment(*args, torch.from_numpy(ref[s][0]),
                                                  torch.from_numpy(ref[s][1]), t0=s * seg, seg=seg,
                                                  band=band, with_traceback=False, **_pen(two_piece))
        assert none is None and (c_o.numpy() == c_ref).all() and (s_o.numpy() == s_ref).all()
    # every real pair scored, each in its own segment; the padding row not
    assert (scores.numpy()[:-1] >= 0).all() and int(scores[-1]) == -1


def _jax_walk(tbs, ql, tl, band, seg):
    """_tb_scan_segment from the last segment down: [(state in, state out,
    ops_seg)], states as [4, B] int32 (cur_t, lane, mat, done)."""
    K = band
    cur_t = jnp.asarray(ql + tl, jnp.int32)
    lane = jnp.asarray(ql, jnp.int32) - jnp.maximum((cur_t - K + 1) // 2, 0)
    mat = jnp.zeros(ql.size, jnp.int32)
    done = cur_t == 0
    out = {}
    for s in reversed(range(len(tbs))):
        st_in = np.stack([np.asarray(x).astype(np.int32) for x in (cur_t, lane, mat, done)])
        (cur_t, lane, mat, done), ops = jnw._tb_scan_segment(
            jnp.asarray(tbs[s]), s * seg, cur_t, lane, mat, done, band=band, seg=seg)
        st_out = np.stack([np.asarray(x).astype(np.int32) for x in (cur_t, lane, mat, done)])
        out[s] = (st_in, st_out, np.asarray(ops))
    return out


def _port_walk_equals(tbs, ql, tl, band, seg):
    ref = _jax_walk(tbs, ql, tl, band, seg)
    B = ql.size
    state = nw_cuda.walk_state(torch.from_numpy(ql), torch.from_numpy(tl), band=band)
    ops = torch.zeros((B, len(tbs) * seg + 1), dtype=torch.uint8)
    for s in reversed(range(len(tbs))):
        st_in, st_out, ops_ref = ref[s]
        assert (state.numpy() == st_in).all(), s
        state = nw_cuda.nw_walk_segment(torch.from_numpy(tbs[s]), state, ops, t0=s * seg, seg=seg,
                                        band=band)
        assert (state.numpy() == st_out).all(), s
        assert (ops.numpy()[:, s * seg + 1 : (s + 1) * seg + 1] == ops_ref).all(), s
    assert not ops[:, 0].any()
    return state, ops


@pytest.mark.parametrize("seg,band,two_piece", CASES)
def test_segment_walk_equals_tb_scan_segment(seg, band, two_piece):
    """nw_walk_segment (plain version) over the segments' traceback rows,
    from the last segment down, equals _tb_scan_segment: the cursor state
    after every segment and every segment's opcodes.  Every real pair's walk
    ends at (0, 0); the padding row's never starts."""
    Q, T, ql, tl = _boundary_batch(seg, seed=seg + band)
    tbs = [tb for *_, tb in _jax_segments(Q, T, ql, tl, band, seg, two_piece)]
    state, ops = _port_walk_equals(tbs, ql, tl, band, seg)
    assert state[3].tolist() == [1] * ql.size
    assert not ops[-1].any()


def test_segment_walk_on_random_bytes():
    """Random traceback bytes (choice codes 5-7, which consume nothing and
    end a walk, gap states left through their opened bits, cursors leaving
    the band): the states and opcodes still equal _tb_scan_segment's, and a
    walk that ended stays ended in the segments below."""
    rng = np.random.default_rng(4)
    seg, band = 64, 20
    ql = np.array([150, 90, 37, 0, 120, 7], np.int32)
    tl = np.array([100, 99, 64, 0, 130, 3], np.int32)
    n_seg = -(-int((ql + tl).max()) // seg)
    tbs = [rng.integers(0, 128, (ql.size, seg, band + 1)).astype(np.uint8) for _ in range(n_seg)]
    state, _ops = _port_walk_equals(tbs, ql, tl, band, seg)
    assert int(state[3].sum()) < ql.size  # some walks ended without reaching (0, 0)


def _items(ops):
    return [tnw.decode_opcodes(row) for row in ops.numpy()]


@pytest.mark.parametrize("seg", [256, 2048])
def test_long_route_equals_jax_and_single_shot(seg):
    """nw_align_long (cpu) equals nw.nw_align_long (scores and per-pair
    items) and the port's single-shot nw_align + nw_walk (scores, opcodes and
    items), at seg 256 and 2,048."""
    Q, T, ql, tl = _boundary_batch(384, seed=9)
    band = 127
    s_ref, items_ref = jnw.nw_align_long(Q, T, ql, tl, Penalties(5, 8, 2, 24, 1), band=band, seg=seg)
    args = [torch.from_numpy(a) for a in (Q, T, ql, tl)]
    before = dict(nw_cuda.LAUNCHES)
    scores, ops = nw_cuda.nw_align_long(*args, band=band, seg=seg, **_pen(True))
    n_seg = -(-int((ql + tl).max()) // seg)
    assert ops.shape == (Q.shape[0], n_seg * seg + 1)
    assert (scores.numpy() == np.asarray(s_ref)).all()
    assert _items(ops) == items_ref
    tmax = int((ql + tl).max())
    s_one, tb = nw_cuda.nw_align(*args, band=band, tmax=tmax, **_pen(True))
    ops_one = nw_cuda.nw_walk(tb, args[2], args[3], band=band, tmax=tmax)
    assert torch.equal(scores, s_one)
    assert torch.equal(ops[:, : tmax + 1], ops_one) and not ops[:, tmax + 1 :].any()
    assert nw_cuda.LAUNCHES == before  # the cpu runs no kernel


def _long_corpus():
    """The tests/test_nw.py long-route pair (1.5 kb, 20 SNPs) and a third
    haplotype with a deletion and an insertion: every pair's qlen + tlen is
    above 1,024."""
    rng = np.random.default_rng(5)
    base = BASES[rng.integers(0, 4, size=1500)].tobytes()
    alt = bytearray(base)
    for pos in rng.integers(0, len(alt), size=20):
        alt[pos] = BASES[rng.integers(0, 4)]
    third = bytearray(base)
    for pos in rng.integers(0, len(third), size=12):
        third[pos] = BASES[rng.integers(0, 4)]
    del third[400:417]
    third[900:900] = BASES[rng.integers(0, 4, size=9)].tobytes()
    return [("a", base), ("b", bytes(alt)), ("c", bytes(third))]


def test_runner_long_route_matches_jax():
    """A WfaAligner with long_pair_threshold=1024 takes the long route for
    every chunk and equals the JAX package's under the same config: every
    (query, target, orientation, score, CIGAR) and long_pairs."""
    named = _long_corpus()
    pairs = np.array([[i, j] for i in range(3) for j in range(3) if i != j], dtype=np.int32)
    jax_al = JaxAligner(jax_seqs(named),
                        JaxRunnerConfig(scores=JaxScores.parse(SCORES), long_pair_threshold=1024))
    port = WfaAligner(make_sequence_set(named),
                      RunnerConfig(scores=AlignmentScores.parse(SCORES), long_pair_threshold=1024),
                      device="cpu")

    def keys(results):
        return [(r.query_idx, r.target_idx, r.is_reverse, r.score, r.cigar_string) for r in results]

    assert keys(port.align_pairs(pairs)) == keys(jax_al.align_pairs(pairs))
    assert port.stats["long_pairs"] == jax_al.stats["long_pairs"] >= len(pairs)
    # qlen + tlen is 2,992 to 3,000 for every pair: two segments of 2,048
    assert [(d["kind"], d["seg"], d["n_seg"]) for d in port.stats["dispatches"]] == [
        ("long", nw_cuda.LONG_SEG, 2)] * len(port.stats["dispatches"])


def test_pipeline_long_route_gfa_equals_jax(tmp_path, monkeypatch):
    """The --no-sort pipeline with long_pair_threshold forced to 1,024 in both
    packages (their RunnerConfig, no CLI flag): byte-identical GFA files, and
    both took the long route."""
    named = [(n, s[:700]) for n, s in _long_corpus()]
    monkeypatch.setattr(jax_pipeline, "RunnerConfig",
                        functools.partial(JaxRunnerConfig, long_pair_threshold=1024))
    monkeypatch.setattr(port_pipeline, "RunnerConfig",
                        functools.partial(RunnerConfig, long_pair_threshold=1024))
    out_j, out_p = tmp_path / "jax.gfa", tmp_path / "port.gfa"
    sr = jax_pipeline.SeqRushTPU(jax_seqs(named), JaxArgs(no_sort=True, output=str(out_j)))
    sr.align_and_unite()
    sr.write_gfa()
    tr = port_pipeline.SeqRushTorch(make_sequence_set(named),
                                    Args(no_sort=True, output=str(out_p), device="cpu"))
    tr.align_and_unite()
    tr.write_gfa()
    assert sr.stats["aligner"]["long_pairs"] > 0
    assert tr.stats["aligner"]["long_pairs"] == sr.stats["aligner"]["long_pairs"]
    assert out_p.read_bytes() == out_j.read_bytes()


def test_jax_long_pair_gfa_digest(tmp_path):
    """The JAX package's --no-sort GFA of the 110 kb pair (its segmented route
    on the CPU) has the sha256 that chip_smoke.py requires of the port's run
    on the card."""
    fa, out = tmp_path / "long.fa", tmp_path / "long.gfa"
    chip_smoke.write_fasta(fa, chip_smoke.long_pair())
    assert jax_main(["-s", str(fa), "-o", str(out), "--no-sort"]) == 0
    assert hashlib.sha256(out.read_bytes()).hexdigest() == chip_smoke.LONG_PAIR_GFA_SHA256


def test_segment_plan_independent_of_length():
    """A segment's launch needs the same shared memory whatever the pairs'
    length, so pairs of any length stay on the register route; the wide
    route still takes bands above REG_MAX_W."""
    for W in (128, 384, 768, 1536, 4096):
        plans = {nw_cuda.plan_sweep(24, W, L, L, seg=2048) for L in (256, 60_000, 1 << 20)}
        assert len(plans) == 1
        (p,) = plans
        assert p.route == "regs"
        assert p.pair_bytes == nw_cuda.pair_smem_bytes(0, 0, W, p.lanes, p.warps_per_pair, seg=2048)
        assert p.smem_bytes <= 232448
    # single-shot, a pair this long leaves the register route
    assert nw_cuda.plan_sweep(24, 768, 1 << 20, 1 << 20).route == "wide"
    assert nw_cuda.plan_sweep(8, nw_cuda.REG_MAX_W + 1, 256, 256, seg=2048).route == "wide"


def test_segment_wrappers_check_arguments():
    """The segment wrappers reject wrong shapes and types and an output
    carry that is the input; a CPU call counts no kernel launch."""
    Q = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.full((2,), 8, dtype=torch.int32)
    carry = nw_cuda.initial_carry(2, 16, "cpu")
    scores = torch.full((2,), -1, dtype=torch.int32)
    kw = dict(band=15, **_pen(True))
    before = dict(nw_cuda.LAUNCHES)
    c, s, tb = nw_cuda.nw_align_segment(Q, Q, lens, lens, carry, scores, t0=0, seg=16, **kw)
    assert s.tolist() == [0, 0] and tb.shape == (2, 16, 16)
    ops = torch.zeros((2, 17), dtype=torch.uint8)
    st = nw_cuda.nw_walk_segment(tb, nw_cuda.walk_state(lens, lens, band=15), ops, t0=0, seg=16,
                                 band=15)
    assert st[3].tolist() == [1, 1] and (ops[:, 2::2] == tnw.OP_M).all()
    assert nw_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        nw_cuda.nw_align_segment(Q, Q, lens, lens, carry[:, :, :8].contiguous(), scores, t0=0,
                                 seg=16, **kw)
    with pytest.raises(ValueError):
        nw_cuda.nw_align_segment(Q, Q, lens, lens, carry, scores, t0=0, seg=16, out=carry, **kw)
    with pytest.raises(ValueError):
        nw_cuda.nw_align_segment(Q, Q, lens, lens, carry, scores.to(torch.int64), t0=0, seg=16, **kw)
    with pytest.raises(ValueError):
        nw_cuda.nw_walk_segment(tb, st, ops[:, :16].contiguous(), t0=0, seg=16, band=15)
    with pytest.raises(ValueError):
        nw_cuda.nw_walk_segment(tb, st.to(torch.int64), ops, t0=0, seg=16, band=15)


# -- the grouped launch shapes (forward runs, grouped recompute, group walk) --

GROUP_CASES = [(seg, two_piece, G) for seg in (256, 2048) for two_piece in (False, True)
               for G in (1, 2, "all")]


@functools.lru_cache(maxsize=None)
def _jax_chain(seg, band, two_piece):
    """The boundary batch at seg and _nw_segment chained over it (cached:
    each case's JAX reference is shared by its group sizes)."""
    Q, T, ql, tl = _boundary_batch(seg, seed=seg + band + 1)
    return (Q, T, ql, tl), _jax_segments(Q, T, ql, tl, band, seg, two_piece)


def _groups(n_seg, G):
    G = n_seg if G == "all" else G
    return [(s0, min(G, n_seg - s0)) for s0 in range(0, n_seg, G)]


@pytest.mark.parametrize("seg,two_piece,G", GROUP_CASES)
def test_segment_groups_equal_nw_segment(seg, two_piece, G):
    """The forward runs (nw_align_segment_run, plain version) of G segments
    a launch fill the checkpoints with _nw_segment's carries and end with
    its scores; the grouped recompute (nw_align_segment_group) from those
    checkpoints gives every segment's traceback rows and, per group, the
    scores of the pairs that end in it; the group walk
    (nw_walk_segment_group) from the last group down gives
    _tb_scan_segment's cursor at each group's lower edge and its opcodes.
    G = 1, 2 and n_seg; one-piece and two-piece; seg 256 and 2,048."""
    band = 63
    (Q, T, ql, tl), ref = _jax_chain(seg, band, two_piece)
    n_seg = len(ref)
    assert n_seg == 3
    args = [torch.from_numpy(a) for a in (Q, T, ql, tl)]
    B, W = Q.shape[0], band + 1
    kw = dict(seg=seg, band=band, **_pen(two_piece))
    groups = _groups(n_seg, G)
    ckpt = torch.empty((n_seg, 6, B, W), dtype=torch.int32)
    ckpt[0] = nw_cuda.initial_carry(B, W, "cpu")
    scores = torch.full((B,), -1, dtype=torch.int32)
    for s0, g in groups:
        scores = nw_cuda.nw_align_segment_run(*args, ckpt, scores, s0=s0, n_run=g, **kw)
        assert (scores.numpy() == ref[s0 + g - 1][3]).all(), s0
    for s, (c_in, *_rest) in enumerate(ref):
        assert (ckpt[s].numpy() == c_in).all(), s
    tbs = {}
    for s0, g in groups:
        s_g, tb = nw_cuda.nw_align_segment_group(*args, ckpt, s0=s0, G=g, **kw)
        assert tb.shape == (B, g * seg, W)
        s_before, s_after = ref[s0][1], ref[s0 + g - 1][3]
        assert (s_g.numpy() == np.where(s_before < 0, s_after, -1)).all(), s0
        for k in range(g):
            assert (tb[:, k * seg : (k + 1) * seg].numpy() == ref[s0 + k][4]).all(), (s0, k)
        tbs[s0] = tb
    walk = _jax_walk([r[4] for r in ref], ql, tl, band, seg)
    state = nw_cuda.walk_state(args[2], args[3], band=band)
    ops = torch.zeros((B, n_seg * seg + 1), dtype=torch.uint8)
    for s0, g in reversed(groups):
        assert (state.numpy() == walk[s0 + g - 1][0]).all(), s0
        state = nw_cuda.nw_walk_segment_group(tbs[s0], state, ops, s0=s0, G=g, seg=seg, band=band)
        assert (state.numpy() == walk[s0][1]).all(), s0
    for s in range(n_seg):
        assert (ops.numpy()[:, s * seg + 1 : (s + 1) * seg + 1] == walk[s][2]).all(), s
    assert state[3].tolist() == [1] * B and not ops[:, 0].any()


def test_group_walk_on_random_bytes():
    """Random traceback bytes (walks that end without reaching (0, 0),
    cursors leaving the band) through the group walk, in groups of 2 and
    all at once: _tb_scan_segment's cursors and opcodes."""
    rng = np.random.default_rng(4)
    seg, band = 64, 20
    ql = np.array([150, 90, 37, 0, 120, 7], np.int32)
    tl = np.array([100, 99, 64, 0, 130, 3], np.int32)
    n_seg = -(-int((ql + tl).max()) // seg)
    tbs = [rng.integers(0, 128, (ql.size, seg, band + 1)).astype(np.uint8) for _ in range(n_seg)]
    walk = _jax_walk(tbs, ql, tl, band, seg)
    for G in (2, "all"):
        state = nw_cuda.walk_state(torch.from_numpy(ql), torch.from_numpy(tl), band=band)
        ops = torch.zeros((ql.size, n_seg * seg + 1), dtype=torch.uint8)
        for s0, g in reversed(_groups(n_seg, G)):
            tb = torch.from_numpy(np.concatenate(tbs[s0 : s0 + g], axis=1))
            state = nw_cuda.nw_walk_segment_group(tb, state, ops, s0=s0, G=g, seg=seg, band=band)
            assert (state.numpy() == walk[s0][1]).all(), (G, s0)
        for s in range(n_seg):
            assert (ops.numpy()[:, s * seg + 1 : (s + 1) * seg + 1] == walk[s][2]).all(), (G, s)
        assert int(state[3].sum()) < ql.size


@pytest.mark.parametrize("G", [1, 2, "all"])
def test_long_route_groups_equal_jax_and_single_shot(G):
    """nw_align_long with a memory budget that gives G = 1, 2 and n_seg
    (cpu) equals nw.nw_align_long (scores and per-pair items) and the port's
    single-shot nw_align + nw_walk (scores, opcodes and items), with
    tolerance 0; the route of every group size gives the same opcodes."""
    Q, T, ql, tl = _boundary_batch(384, seed=9)
    band, seg = 127, 256
    B, W = Q.shape[0], band + 1
    t_need = int((ql + tl).max())
    n_seg = -(-t_need // seg)
    assert n_seg == 5
    g = n_seg if G == "all" else G
    budget = g * B * seg * W + (B * seg * W - 1)  # just under g + 1 segments
    assert nw_cuda.long_group_size(B, W, seg, n_seg, budget) == g
    s_ref, items_ref = jnw.nw_align_long(Q, T, ql, tl, Penalties(5, 8, 2, 24, 1), band=band, seg=seg)
    args = [torch.from_numpy(a) for a in (Q, T, ql, tl)]
    before = dict(nw_cuda.LAUNCHES)
    scores, ops = nw_cuda.nw_align_long(*args, band=band, seg=seg, memory_budget=budget,
                                        **_pen(True))
    assert ops.shape == (B, n_seg * seg + 1)
    assert (scores.numpy() == np.asarray(s_ref)).all()
    assert _items(ops) == items_ref
    s_one, tb = nw_cuda.nw_align(*args, band=band, tmax=t_need, **_pen(True))
    ops_one = nw_cuda.nw_walk(tb, args[2], args[3], band=band, tmax=t_need)
    assert torch.equal(scores, s_one)
    assert torch.equal(ops[:, : t_need + 1], ops_one) and not ops[:, t_need + 1 :].any()
    assert nw_cuda.LAUNCHES == before  # the cpu runs no kernel


def test_long_group_size_rule():
    """G is the most segments whose traceback B * G * seg * W fits the
    budget, at least 1 (a budget below one segment keeps the per-segment
    route) and at most n_seg; the runner's default budget gives the 8 x 60
    kb locus's chunks and the 110 kb pair G = n_seg."""
    per = 48 * 2048 * 384
    assert nw_cuda.long_group_size(48, 384, 2048, 59, 59 * per) == 59
    assert nw_cuda.long_group_size(48, 384, 2048, 59, 59 * per - 1) == 58
    assert nw_cuda.long_group_size(48, 384, 2048, 59, 2 * per) == 2
    assert nw_cuda.long_group_size(48, 384, 2048, 59, 2 * per - 1) == 1
    assert nw_cuda.long_group_size(48, 384, 2048, 59, 1) == 1
    assert nw_cuda.long_group_size(48, 384, 2048, 59, 10**15) == 59
    assert nw_cuda.long_group_size(0, 384, 2048, 3, 1) == 3
    default = RunnerConfig().memory_budget_bytes
    assert default == nw_cuda.LONG_BUDGET == int(2.6e9)
    for B, W, n_seg in ((48, 384, 59), (16, 512, 59), (8, 256, 54)):
        assert nw_cuda.long_group_size(B, W, 2048, n_seg, default) == n_seg
    # the plan's cost counts the group's blocks: its strip is picked for B x G
    one = nw_cuda.plan_sweep(48, 384, 0, 0, seg=2048)
    grp = nw_cuda.plan_sweep(48, 384, 0, 0, seg=2048, groups=59)
    assert grp.groups == 59 and one.groups == 1
    assert nw_cuda._sweep_cost(grp) >= nw_cuda._sweep_cost(one)
    for p in (one, grp):
        assert p.route == "regs" and p.smem_bytes <= 232448


def test_runner_long_route_records_group():
    """A long chunk's dispatch record carries its group size, the runner's
    memory_budget_bytes passed down: every segment at the default budget,
    and what long_group_size gives for a budget of one segment and a half."""
    named = _long_corpus()
    pairs = np.array([[0, 1], [2, 0]], dtype=np.int32)
    for budget in (None, "1.5 segments"):
        cfg = RunnerConfig(scores=AlignmentScores.parse(SCORES), long_pair_threshold=1024)
        if budget:
            cfg.memory_budget_bytes = 3 * 2 * nw_cuda.LONG_SEG * 2 * 64 // 2
        port = WfaAligner(make_sequence_set(named), cfg, device="cpu")
        port.align_pairs(pairs)
        longs = port.stats["dispatches"]
        assert longs and all(d["kind"] == "long" and d["emit"] == "ops" for d in longs)
        for d in longs:
            want = nw_cuda.long_group_size(d["B"], d["band"] + 1, d["seg"], d["n_seg"],
                                           cfg.memory_budget_bytes)
            assert d["group"] == want == (d["n_seg"] if budget is None else want), d
        if budget is None:
            assert {d["group"] for d in longs} == {2}  # qlen + tlen 2,992-3,000: 2 segments
