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
