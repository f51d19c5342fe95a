"""seqrush_tpu_torch's band-sharded alignment (device='cpu', the plain
version of kernel A's sharded mode) against seqrush_tpu's lane-sharded sweep
on the virtual 8-CPU mesh of tests/conftest.py: scores and every traceback
row and lane bit for bit, then the pair helper, the runner's over-budget
route and the pipeline's golden gate on it."""

import numpy as np
import pytest
import torch

from seqrush_tpu.align.runner import RunnerConfig as JaxRunnerConfig
from seqrush_tpu.align.runner import WfaAligner as JaxAligner
from seqrush_tpu.parallel.bandshard import nw_align_band_sharded as jax_band_sharded
from seqrush_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.config import Args
from seqrush_tpu_torch.ops import nw, nw_cuda
from seqrush_tpu_torch.ops.wfa import Penalties, affine2p_score_dp
from seqrush_tpu_torch.parallel.bandshard import align_pair_sharded, band_for_mesh, gather_strips
from seqrush_tpu_torch.parallel.bandshard import nw_align_band_sharded
from seqrush_tpu_torch.parallel.mesh import make_mesh
from seqrush_tpu_torch.pipeline import SeqRushTorch
from seqrush_tpu_torch.pos import encode_bases
from seqrush_tpu_torch.scores import AlignmentScores
from seqrush_tpu_torch.sequences import make_sequence_set

PEN = Penalties(5, 8, 2, 24, 1)
KW = PEN.kernel_kwargs()
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these shapes gain nothing from more, and the
    suite's workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _mutate(rng, s, n_snp=6, indels=2):
    s = bytearray(s)
    for pos in rng.integers(0, len(s), size=n_snp):
        s[pos] = b"ACGT"[rng.integers(0, 4)]
    for _ in range(indels):
        pos = int(rng.integers(0, len(s) - 12))
        ln = int(rng.integers(1, 9))
        if rng.random() < 0.5:
            del s[pos : pos + ln]
        else:
            s[pos:pos] = bytes(b"ACGT"[rng.integers(0, 4)] for _ in range(ln))
    return bytes(s)


def _make_pairs(seed=11, n=3, length=260):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        q = BASES[rng.integers(0, 4, size=length)].tobytes()
        pairs.append((q, _mutate(rng, q)))
    return pairs


def _pack(pairs, pad_rows=0):
    """Pairs packed QPAD / TPAD, plus pad_rows zero-length rows."""
    qs = [encode_bases(q) for q, _ in pairs] + [np.zeros(0, np.uint8)] * pad_rows
    ts = [encode_bases(t) for _, t in pairs] + [np.zeros(0, np.uint8)] * pad_rows
    lq = max(q.size for q in qs)
    lt = max(t.size for t in ts)
    Q = np.stack([np.concatenate([q, np.full(lq - q.size, nw.QPAD, np.uint8)]) for q in qs])
    T = np.stack([np.concatenate([t, np.full(lt - t.size, nw.TPAD, np.uint8)]) for t in ts])
    qlens = np.array([q.size for q in qs], np.int32)
    tlens = np.array([t.size for t in ts], np.int32)
    return Q, T, qlens, tlens


def _both(Q, T, qlens, tlens, D, band, tmax):
    """(port scores, port traceback [T_total + 1, B, W]; the JAX package's)."""
    s_p, strips = nw_cuda.nw_align_sharded_reference(
        *(torch.from_numpy(a) for a in (Q, T, qlens, tlens)), n_shards=D, band=band, tmax=tmax, **KW)
    assert len(strips) == D and all(s.shape == strips[0].shape for s in strips)
    tb_p = gather_strips(strips).transpose(1, 0, 2)
    s_j, tb_j = jax_band_sharded(jax_make_mesh(D), Q, T, qlens, tlens, band=band, tmax=tmax, **KW)
    return (s_p.numpy(), tb_p), (np.asarray(s_j), np.asarray(tb_j))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_bit_parity_with_jax(n_dev):
    """Scores and every traceback row and lane equal the JAX program's; the
    batch holds a zero-length row, and tmax - band is odd, so the last
    macro-step writes row tmax + 1."""
    Q, T, qlens, tlens = _pack(_make_pairs(), pad_rows=1)
    band = 127  # W = 128 divides every mesh size tested
    tmax = int((qlens + tlens).max()) + 1
    assert (tmax - band) % 2 == 1 and nw_cuda.sharded_rows(band, tmax) == tmax + 1
    (s_p, tb_p), (s_j, tb_j) = _both(Q, T, qlens, tlens, n_dev, band, tmax)
    np.testing.assert_array_equal(s_p, s_j)
    assert s_p[-1] == 0  # the zero-length row ends at the origin
    assert tb_p.shape == tb_j.shape == (tmax + 2, Q.shape[0], band + 1)
    np.testing.assert_array_equal(tb_p, tb_j)


def test_mesh_size_invariance():
    """The gathered traceback and scores are the same for 1, 2 and 8 shards,
    and through nw_align_band_sharded on a CPU mesh."""
    Q, T, qlens, tlens = _pack(_make_pairs(seed=5, n=2))
    band = 127
    tmax = int((qlens + tlens).max())
    outs = []
    for n in (1, 2, 8):
        s, strips = nw_align_band_sharded(make_mesh(n, "cpu"), Q, T, qlens, tlens, band=band, tmax=tmax, **KW)
        outs.append((s.numpy(), gather_strips(strips)))
    for s, tb in outs[1:]:
        np.testing.assert_array_equal(s, outs[0][0])
        np.testing.assert_array_equal(tb, outs[0][1])


def test_unequal_lengths_and_wide_band():
    """A band wider than both sequences (the first phase only) is exact."""
    Q, T, qlens, tlens = _pack([(b"ACGTACGTACGT" * 6, b"ACGTACGTACGT" * 5)])
    band = 255
    tmax = int((qlens + tlens).max())
    (s_p, tb_p), (s_j, tb_j) = _both(Q, T, qlens, tlens, 8, band, tmax)
    np.testing.assert_array_equal(s_p, s_j)
    np.testing.assert_array_equal(tb_p, tb_j)


def test_band_for_mesh():
    assert (band_for_mesh(100, 8, quantum=16) + 1) % (8 * 16) == 0
    assert band_for_mesh(127, 4, quantum=32) == 127
    for k in (1, 100, 1000):  # never below k
        assert band_for_mesh(k, 8) >= k
    with pytest.raises(ValueError):
        nw_cuda.nw_align_sharded_reference(*(torch.zeros((1, 4), dtype=torch.uint8),) * 2,
                                           torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
                                           n_shards=3, band=127, tmax=8, **KW)


def _cigar_cost(items, q, t):
    """Check that the CIGAR consumes both sequences and return its cost."""
    qc, tc = encode_bases(q), encode_bases(t)
    qi = ti = cost = 0
    gap = lambda n: min(PEN.gap1_open + n * PEN.gap1_extend, PEN.gap2_open + n * PEN.gap2_extend)  # noqa: E731
    for n, op in items:
        if op in "=X":
            assert np.all((qc[qi : qi + n] == tc[ti : ti + n]) == (op == "="))
            cost += n * PEN.mismatch * (op == "X")
            qi, ti = qi + n, ti + n
        elif op == "I":
            cost, qi = cost + gap(n), qi + n
        else:
            assert op == "D"
            cost, ti = cost + gap(n), ti + n
    assert qi == len(q) and ti == len(t)
    return cost


def test_align_pair_sharded_end_to_end():
    rng = np.random.default_rng(3)
    q = BASES[rng.integers(0, 4, size=400)].tobytes()
    t = _mutate(rng, q, n_snp=10, indels=3)
    score, items = align_pair_sharded(make_mesh(8, "cpu"), q, t)
    assert score == affine2p_score_dp(encode_bases(q), encode_bases(t), PEN)
    assert _cigar_cost(items, q, t) == score


def test_default_band_exact_at_full_divergence():
    """A fully divergent pair's optimum (delete all, insert all) hugs the DP
    edges: only the full default band finds it."""
    q, t = b"A" * 400, b"C" * 400
    score, items = align_pair_sharded(make_mesh(4, "cpu"), q, t)
    assert score == affine2p_score_dp(encode_bases(q), encode_bases(t), PEN) == 848
    assert _cigar_cost(items, q, t) == score


def _translocation(seed, a, b, c, x):
    rng = np.random.default_rng(seed)

    def rand(n):
        return BASES[rng.integers(0, 4, size=n)].tobytes()

    A, B, C, X = rand(a), rand(b), rand(c), rand(x)
    return A + X + B + C, A + B + X + C, rng


def test_runner_routes_over_budget_pair_to_band_shard():
    """With a mesh, a job whose traceback alone busts the memory budget
    aligns through the band-sharded route, exactly, with certification and
    escalation; the JAX runner gives the same record."""
    q, t, _rng = _translocation(5, 250, 300, 250, 400)
    named = [("q", q), ("t", t)]
    cfg = dict(scores=AlignmentScores.parse("0,5,8,2,24,1"), memory_budget_bytes=4_000_000)
    al = WfaAligner(make_sequence_set(named), RunnerConfig(mesh=make_mesh(8, "cpu"), **cfg), device="cpu")
    res = al.align_pairs(np.array([[0, 1]]))
    assert al.stats["band_sharded"] >= 1
    assert len(res) == 1
    assert res[0].score == affine2p_score_dp(encode_bases(q), encode_bases(t), PEN)
    assert _cigar_cost(res[0].cigar, q, t) == res[0].score
    from seqrush_tpu.scores import AlignmentScores as JaxScores

    jal = JaxAligner(jax_seqs(named), JaxRunnerConfig(mesh=jax_make_mesh(8), memory_budget_bytes=4_000_000,
                                                      scores=JaxScores.parse("0,5,8,2,24,1")))
    jres = jal.align_pairs(np.array([[0, 1]]))
    assert [(r.score, r.is_reverse, r.cigar_string) for r in res] == [
        (r.score, r.is_reverse, r.cigar_string) for r in jres]
    for k in ("band_sharded", "band_escalations", "cells_true"):
        assert al.stats[k] == jal.stats[k], k


def test_pipeline_band_shard_route_golden_gate(tmp_path):
    """A pair over the budget inside a full pipeline run over a mesh: the
    GFA still passes the golden path-reconstruction gate."""
    q, t, rng = _translocation(11, 200, 250, 200, 350)
    v = bytearray(q)
    for pos in rng.integers(0, len(v), size=4):
        v[pos] = BASES[rng.integers(0, 4)]
    seqs = make_sequence_set([("s0", q), ("s1", t), ("s2", bytes(v))])
    out = tmp_path / "shard.gfa"
    sr = SeqRushTorch(seqs, Args(output=str(out), mesh_devices=8, memory_budget_bytes=3_000_000, no_sort=True,
                                 device="cpu"))
    sr.align_and_unite()
    g = sr.write_gfa()  # raises unless every path reconstructs its input
    assert sr.stats["aligner"]["band_sharded"] >= 1
    assert sr.validate_paths_match_sequences(g) == []
