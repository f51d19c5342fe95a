"""Kernels C and D, the row-major sweep and walk (through their plain
versions on the CPU), against the JAX package's ``nw._sweep_rows`` and
``nw.nw_align_rows``: scores, the whole row-major traceback, the steps, the
gap list and its count bit-equal, in int32 and int16, with pairs whose gap
list overflows GAP_MAX; ``decode_rowtokens`` equal to the JAX package's; and
``WfaAligner(RunnerConfig(sweep='rows'))`` against the JAX package's,
results and counters equal, with GAP_MAX lowered on both sides so that pairs
retry on the anti-diagonal kernels.  Tolerance 0: all integer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrush_tpu.align.runner import RunnerConfig as JaxRunnerConfig
from seqrush_tpu.align.runner import WfaAligner as JaxAligner
from seqrush_tpu.ops import nw as jnw
from seqrush_tpu.scores import AlignmentScores as JaxScores
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.ops import nw, nw_cuda
from seqrush_tpu_torch.scores import AlignmentScores
from seqrush_tpu_torch.sequences import make_sequence_set
from test_torch_int16 import COUNTERS, PENALTIES, SCORES, _corpus, _keys, _runners, sweep_batch
from torch_edge_corpora import rows_edge_corpus


def _unpacked_steps(packed, n):
    return jnw.unpack_opcodes(np.asarray(packed), np.asarray(packed).shape[1] * 4)[:, :n]


def _both(Q, T, ql, tl, band, int16, pen, gap_max=None):
    """(JAX outputs, port outputs) of the fused row-major program as numpy:
    scores, steps, grows, gvals, gcount."""
    out = jnw.nw_align_rows(*(jnp.asarray(a) for a in (Q, T, ql, tl)), band=band,
                            use_int16=int16, **pen)
    s_p, tb_p = nw_cuda.nw_align_rows(*(torch.from_numpy(a) for a in (Q, T, ql, tl)), band=band,
                                      int16=int16, **pen)
    walk = nw_cuda.nw_walk_rows(tb_p, torch.from_numpy(ql), torch.from_numpy(tl), band=band,
                                gap_max=gap_max)
    got = [s_p.numpy()] + [a.numpy() for a in walk]
    ref = [np.asarray(out[0]), _unpacked_steps(out[1], got[1].shape[1])] + [np.asarray(a) for a in out[2:]]
    return ref, got, tb_p


@pytest.mark.parametrize("case,int16", [(c, False) for c in ("one_piece", "two_piece")]
                         + [(c, True) for c in sorted(PENALTIES)])
def test_rows_equal_jax(case, int16):
    """Every output of the fused program, and the traceback against
    _sweep_rows' (the int16 mode's wrapping adds included)."""
    Q, T, ql, tl, _qs, _ts = sweep_batch()
    band = 47
    pen = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), PENALTIES[case]))
    ref, got, tb_p = _both(Q, T, ql, tl, band, int16, pen)
    for name, a, b in zip(("scores", "steps", "grows", "gvals", "gcount"), ref, got):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[2].dtype == np.int16 and got[2].shape == (len(ql), nw.GAP_MAX)
    _s, tb_j, _r = jnw._sweep_rows(*(jnp.asarray(a) for a in (Q, T, ql, tl)), band=band,
                                   with_traceback=True, dtype=jnp.int16 if int16 else jnp.int32, **pen)
    np.testing.assert_array_equal(np.transpose(np.asarray(tb_j), (1, 0, 2)), tb_p.numpy())


def _gappy_batch():
    """Pairs with many inserted target bases (up to about 190 D-runs), a
    narrow control pair and a zero-length row."""
    rng = np.random.default_rng(160)
    qs, ts = [], []
    for k in range(5):
        q = rng.integers(0, 4, 1500).astype(np.uint8)
        t = q.copy()
        for p in np.sort(rng.choice(np.arange(5, 1495), 5 + 150 * (k % 3), replace=False))[::-1]:
            t = np.insert(t, p, rng.integers(0, 4, 1 + k % 2).astype(np.uint8))
        qs.append(q)
        ts.append(t)
    qs.append(np.zeros(0, np.uint8))
    ts.append(np.zeros(0, np.uint8))
    B = len(qs)
    Q = np.full((B, 1536), nw.QPAD, np.uint8)
    T = np.full((B, 2048), nw.TPAD, np.uint8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        Q[b, : q.size] = q
        T[b, : t.size] = t
    return Q, T, np.array([q.size for q in qs], np.int32), np.array([t.size for t in ts], np.int32)


def test_rows_gap_list_overflow_equals_jax():
    """Pairs with more than GAP_MAX D-runs: the whole outputs equal the JAX
    package's (the gaps of the lowest rows, ascending, and the full count)."""
    Q, T, ql, tl = _gappy_batch()
    pen = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), PENALTIES["two_piece"]))
    ref, got, _tb = _both(Q, T, ql, tl, 639, False, pen)
    for name, a, b in zip(("scores", "steps", "grows", "gvals", "gcount"), ref, got):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got[4] > nw.GAP_MAX).any() and (got[4] < nw.GAP_MAX).any()


@pytest.fixture
def small_gap_max(monkeypatch):
    """GAP_MAX lowered to 2 in both packages (the JAX package reads it while
    tracing: its caches are dropped around the patch)."""
    jax.clear_caches()
    monkeypatch.setattr(jnw, "GAP_MAX", 2)
    monkeypatch.setattr(nw, "GAP_MAX", 2)
    yield 2
    jax.clear_caches()


def test_rows_small_gap_max_equals_jax(small_gap_max):
    """With GAP_MAX 2 the gap lists of most pairs overflow: the whole
    outputs still equal the JAX package's, and decode_rowtokens agrees on
    the pairs that fit."""
    Q, T, ql, tl, qs, ts = sweep_batch(seed=9, L=240)
    pen = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), PENALTIES["two_piece"]))
    ref, got, _tb = _both(Q, T, ql, tl, 63, False, pen)
    for name, a, b in zip(("scores", "steps", "grows", "gvals", "gcount"), ref, got):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[2].shape[1] == 2
    for b in range(len(qs)):
        if got[4][b] <= 2:
            args = (got[1][b], got[2][b], got[3][b], int(got[4][b]), int(ql[b]))
            assert nw.decode_rowtokens(*args) == jnw.decode_rowtokens(*args)


@pytest.mark.parametrize("int16", [False, True])
def test_rows_edge_corpus_equals_jax(int16):
    """Kernel D's edge corpus (D-runs longer than a tile's 32 lanes, an
    I-run drifting the cursor to the band's last lane, R = 700 rows, not a
    multiple of the tile's 64, a pair of 13 D-runs), in int32 and int16:
    every output of the plain versions, which the card holds kernel D to
    bit for bit, equals the JAX package's fused program."""
    Q, T, ql, tl = rows_edge_corpus()
    pen = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), PENALTIES["two_piece"]))
    ref, got, _tb = _both(Q, T, ql, tl, 63, int16, pen)
    for name, a, b in zip(("scores", "steps", "grows", "gvals", "gcount"), ref, got):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(got[3].max()) >= 61 and int(got[4].max()) == 13


def test_rows_edge_corpus_small_gap_max_equals_jax(small_gap_max):
    """The same corpus with GAP_MAX 2 in both packages: the pair of 13
    D-runs overflows the list (its lowest two kept, the full count)."""
    Q, T, ql, tl = rows_edge_corpus()
    pen = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), PENALTIES["two_piece"]))
    ref, got, _tb = _both(Q, T, ql, tl, 63, False, pen)
    for name, a, b in zip(("scores", "steps", "grows", "gvals", "gcount"), ref, got):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[2].shape[1] == 2 and int(got[4].max()) == 13


def test_decode_rowtokens_equals_jax():
    """The host expansion of the row-major walk, on the gappy batch's
    outputs (leading, inner and adjacent D-runs)."""
    Q, T, ql, tl = _gappy_batch()
    pen = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), PENALTIES["two_piece"]))
    _ref, (s, steps, grows, gvals, gcount), _tb = _both(Q, T, ql, tl, 639, False, pen)
    for b in range(len(ql)):
        if gcount[b] <= nw.GAP_MAX:
            args = (steps[b], grows[b], gvals[b], int(gcount[b]), int(ql[b]))
            items = nw.decode_rowtokens(*args)
            assert items == jnw.decode_rowtokens(*args)
            assert sum(n for n, op in items if op != "I") == tl[b]


@pytest.mark.parametrize("dp_dtype", ["int32", "int16"])
@pytest.mark.parametrize("corpus", ["nw", "family"])
def test_runner_rows_equals_jax(corpus, dp_dtype):
    """Results and counters equal the JAX runner's under sweep='rows'; the
    anchored route stays off (the family's wide pairs run as row-major
    chunks)."""
    named, pairs = _corpus(corpus)
    ref, jst, got, pst = _runners(named, pairs, sweep="rows", dp_dtype=dp_dtype)
    assert got == ref and len(got) == len(pairs)
    for k in COUNTERS:
        assert pst[k] == jst[k], k
    assert pst["anchored_pairs"] == 0
    chunks = [d for d in pst["dispatches"] if d["kind"] == "chunk"]
    assert all(d["rows"] and d["emit"] == "rowtok" for d in chunks)
    assert all(d["int16"] == (dp_dtype == "int16") for d in chunks)


def _deletion_corpus():
    """A 400 bp base and three copies with five short deletions each: a copy
    aligned against the base walks five D-runs."""
    rng = np.random.default_rng(12)
    base = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 400)]
    named = [("b", base.tobytes())]
    for k in range(3):
        v = bytearray(base.tobytes())
        for p in sorted(rng.choice(np.arange(20, 380), 5, replace=False), reverse=True):
            del v[p : p + 2 + k]
        named.append((f"d{k}", bytes(v)))
    return named, np.array([(i, j) for i in range(4) for j in range(4) if i != j])


def test_runner_gap_overflow_equals_jax(small_gap_max):
    """With GAP_MAX 2, pairs with more D-runs retry on the anti-diagonal
    kernels at their band (gap_overflows), in a chunk of their own, and stay
    there on a second call."""
    named, pairs = _deletion_corpus()
    ref_al = JaxAligner(jax_seqs(named), JaxRunnerConfig(scores=JaxScores.parse(SCORES), sweep="rows"))
    port = WfaAligner(make_sequence_set(named),
                      RunnerConfig(scores=AlignmentScores.parse(SCORES), sweep="rows"), device="cpu")
    for call in range(2):
        assert _keys(port.align_pairs(pairs)) == _keys(ref_al.align_pairs(pairs))
        for k in COUNTERS:
            assert port.stats[k] == ref_al.stats[k], k
    n = port.stats["gap_overflows"]
    assert n > 0
    first, retried, *later = port.stats["dispatches"]
    assert first["rows"] and not retried["rows"] and len(retried["jobs"]) == n
    assert [d["jobs"] for d in later if not d["rows"]] == [retried["jobs"]]


def test_sweep_rows_runs():
    """sweep='rows' is ported: the runner takes it (a case of the options
    test_torch_runner.py once held to NotImplementedError)."""
    named, pairs = _corpus("nw")
    al = WfaAligner(make_sequence_set(named), RunnerConfig(sweep="rows"), device="cpu")
    assert len(al.align_pairs(pairs[:2])) == 2 and al.stats["dispatches"][0]["rows"]
    with pytest.raises(ValueError, match="sweep"):
        WfaAligner(make_sequence_set(named), RunnerConfig(sweep="cols"), device="cpu")


@pytest.mark.parametrize("Wr,plan", [(95, (8, 32)), (1023, (8, 128)), (2049, (8, 288)),
                                     (3071, (8, 384)), (8191, (16, 512)), (10001, (16, 640))])
def test_rows_plan(Wr, plan):
    """Kernel C's launch shape: 8 lanes a thread up to 4,096 lanes (at most
    128 threads up to 1,024, five pairs an SM), 16 lanes on up to 1,024
    threads past that."""
    assert nw_cuda.rows_plan(Wr) == plan
    S, threads = plan
    assert threads % 32 == 0 and S * threads >= Wr
    with pytest.raises(ValueError):
        nw_cuda.rows_plan(16 * 1024 + 1)
