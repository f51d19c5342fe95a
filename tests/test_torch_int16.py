"""Kernel A's int16 mode (through its plain version on the CPU) against the
JAX package's int16 sweep, ``nw._sweep_v3(dtype=int16)``: the scores and the
whole traceback tensor bit-equal, with penalties whose int16 adds wrap past
32,767; and ``WfaAligner(RunnerConfig(dp_dtype='int16' | 'auto'))`` against
the JAX package's, results and counters equal, with ``INT16_CUTOFF`` lowered
on both sides so that pairs re-run in int32.  Tolerance 0: all integer."""

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
from test_anchored_wide import synth_family
from test_torch_anchored_runner import _family_pairs
from test_torch_runner import _nw_corpus
from torch_edge_corpora import INT16_EDGE_PENALTIES, int16_edge_corpus

SCORES = "0,5,8,2,24,1"
COUNTERS = ("int16_retries", "band_escalations", "run_overflows", "gap_overflows", "dropped",
            "anchored_pairs", "cells_padded", "cells_true")


def sweep_batch(seed=3, n=6, L=200, Lpad=256):
    """Seeded pairs of mixed lengths (SNPs, deletions, an insertion), a
    zero-length row and a one-base against two-base pair, padded to Lpad."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(n):
        q = rng.integers(0, 4, L - 13 * k).astype(np.uint8)
        t = q.copy()
        t[rng.integers(0, t.size, 6)] = rng.integers(0, 4, 6)
        if k % 2:
            p = int(rng.integers(10, t.size - 30))
            t = np.delete(t, np.arange(p, p + 3 + k))
        if k == 3:
            t = np.concatenate([t[:50], rng.integers(0, 4, 9).astype(np.uint8), t[50:]])
        qs.append(q)
        ts.append(t)
    qs += [np.zeros(0, np.uint8), np.array([1], np.uint8)]
    ts += [np.zeros(0, np.uint8), np.array([2, 3], np.uint8)]
    B = len(qs)
    Q = np.full((B, Lpad), nw.QPAD, np.uint8)
    T = np.full((B, Lpad), nw.TPAD, np.uint8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        Q[b, : q.size] = q
        T[b, : t.size] = t
    return (Q, T, np.array([q.size for q in qs], np.int32), np.array([t.size for t in ts], np.int32),
            qs, ts)


# penalties (mismatch, o1, e1, o2, e2): the headline's, one-piece, and two
# whose int16 adds wrap (30000 + 3001 and 30000 + 2800 pass 32,767)
PENALTIES = {"two_piece": (5, 8, 2, 24, 1), "one_piece": (5, 8, 2, -1, -1),
             "gap2_wraps": (5, 8, 2, 3000, 1), "mismatch_wraps": (2800, 8, 2, 24, 1)}


@pytest.mark.parametrize("band", [63, 127])
@pytest.mark.parametrize("case", sorted(PENALTIES))
def test_int16_sweep_equals_jax(case, band):
    """Scores (an empty pair scores 0, unreachable finals 30000 or a wrapped
    value) and the whole traceback tensor, rows 0..tmax."""
    Q, T, ql, tl, _qs, _ts = sweep_batch()
    tmax = 512
    pen = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), PENALTIES[case]))
    s_j, tb_j, _t = jnw._sweep_v3(jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql), jnp.asarray(tl),
                                  band=band, tmax=tmax, with_traceback=True, dtype=jnp.int16, **pen)
    s_p, tb_p = nw_cuda.nw_align(*(torch.from_numpy(a) for a in (Q, T, ql, tl)), band=band,
                                 tmax=tmax, int16=True, **pen)
    np.testing.assert_array_equal(np.asarray(s_j), s_p.numpy())
    tb_j = np.transpose(np.asarray(tb_j), (1, 0, 2))
    np.testing.assert_array_equal(tb_j[:, : tmax + 1], tb_p.numpy()[:, : tmax + 1])
    assert not tb_p.numpy()[:, tmax + 1 :].any()
    assert int(s_p[-2]) == 0
    if case.endswith("wraps"):
        assert (s_p.numpy()[:-2] < 0).all()  # the wrap reaches every score
    else:
        assert (s_p.numpy()[:-2] > 0).all()


@pytest.mark.parametrize("band", [127, 511])
@pytest.mark.parametrize("case", sorted(INT16_EDGE_PENALTIES))
def test_int16_edge_corpus_equals_jax(case, band):
    """The packed int16 sweep's edge corpus (adjacent twins of very
    different lengths, an odd B, an empty pair beside a full one, penalties
    at the register route's int16 limit, ties in H's choice): the plain
    version's scores and whole traceback, which the card holds the packed
    kernel to bit for bit (tests/test_torch_cuda.py), equal the JAX
    package's int16 sweep's."""
    Q, T, ql, tl, tmax = int16_edge_corpus()
    pen = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), INT16_EDGE_PENALTIES[case]))
    assert nw_cuda.register_route_penalties(*INT16_EDGE_PENALTIES[case], int16=True)
    s_j, tb_j, _t = jnw._sweep_v3(jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql), jnp.asarray(tl),
                                  band=band, tmax=tmax, with_traceback=True, dtype=jnp.int16, **pen)
    s_p, tb_p = nw_cuda.nw_align(*(torch.from_numpy(a) for a in (Q, T, ql, tl)), band=band,
                                 tmax=tmax, int16=True, **pen)
    np.testing.assert_array_equal(np.asarray(s_j), s_p.numpy())
    tb_j = np.transpose(np.asarray(tb_j), (1, 0, 2))
    np.testing.assert_array_equal(tb_j[:, : tmax + 1], tb_p.numpy()[:, : tmax + 1])
    assert int(s_p[2]) == 0 and (s_p.numpy()[[0, 1, 3]] > 0).all()
    # at the limit penalties no add wraps (every score non-negative), though
    # the unrelated pair's mismatches of 2,767 saturate its cells at INF16
    assert (s_p.numpy() >= 0).all()


@pytest.mark.parametrize("pen,regs", [((5, 8, 2, 24, 1), True), ((5, 8, 2, -1, -1), True),
                                      ((5, 2760, 7, 24, 1), True), ((5, 2760, 8, 24, 1), False),
                                      ((2768, 8, 2, 24, 1), False), ((5, 8, 2, 3000, 1), False)])
def test_int16_register_route_only_without_wraps(pen, regs):
    """The register route takes the int16 mode only where no add to 30000
    can pass 32,767 (its keys need values >= 0); int32 keeps its range."""
    assert nw_cuda.register_route_penalties(*pen, int16=True) == regs
    assert nw_cuda.register_route_penalties(*pen)


def _runners(named, pairs, **cfg):
    ref = JaxAligner(jax_seqs(named), JaxRunnerConfig(scores=JaxScores.parse(SCORES), **cfg))
    port = WfaAligner(make_sequence_set(named),
                      RunnerConfig(scores=AlignmentScores.parse(SCORES), **cfg), device="cpu")
    return _keys(ref.align_pairs(pairs)), ref.stats, _keys(port.align_pairs(pairs)), port.stats


def _keys(results):
    return [(r.query_idx, r.target_idx, r.is_reverse, r.score, r.cigar_string) for r in results]


def _corpus(name):
    if name == "nw":
        named = _nw_corpus()
        return named, np.array([(i, j) for i in range(4) for j in range(4) if i != j])
    named = synth_family()
    return named, _family_pairs(len(named))


@pytest.mark.parametrize("cutoff", [28000, 40])
@pytest.mark.parametrize("dp_dtype", ["int16", "auto"])
@pytest.mark.parametrize("corpus", ["nw", "family"])
def test_runner_int16_equals_jax(corpus, dp_dtype, cutoff, monkeypatch):
    """Results and counters equal the JAX runner's; with the cutoff lowered
    to 40 every pair scoring 40 or more re-runs in int32 (int16_retries),
    in chunks of its own."""
    monkeypatch.setattr(jnw, "INT16_CUTOFF", cutoff)
    monkeypatch.setattr(nw, "INT16_CUTOFF", cutoff)
    named, pairs = _corpus(corpus)
    ref, jst, got, pst = _runners(named, pairs, dp_dtype=dp_dtype)
    assert got == ref and len(got) == len(pairs)
    for k in COUNTERS:
        assert pst[k] == jst[k], k
    chunks = [d for d in pst["dispatches"] if d["kind"] == "chunk"]
    assert chunks[0]["int16"]
    if cutoff == 40:
        assert pst["int16_retries"] > 0 and not chunks[-1]["int16"]
        assert len(chunks[-1]["jobs"]) == pst["int16_retries"]
    else:
        assert pst["int16_retries"] == 0 and all(d["int16"] for d in chunks)


def test_dp_dtype_int16_runs():
    """dp_dtype='int16' is ported: the runner takes it (a case of the
    options test_torch_runner.py once held to NotImplementedError)."""
    named, pairs = _corpus("nw")
    al = WfaAligner(make_sequence_set(named), RunnerConfig(dp_dtype="int16"), device="cpu")
    res = al.align_pairs(pairs[:2])
    assert len(res) == 2 and al.stats["dispatches"][0]["int16"]
    with pytest.raises(ValueError, match="dp_dtype"):
        WfaAligner(make_sequence_set(named), RunnerConfig(dp_dtype="int8"), device="cpu")


def test_long_chunks_stay_int32():
    """A chunk on the long-pair route runs int32 whatever dp_dtype says, as
    the JAX package's long branch does (used_int16 False)."""
    named, pairs = _corpus("nw")
    cfg = dict(dp_dtype="int16", long_pair_threshold=512, wide_route="full")
    ref, jst, got, pst = _runners(named, pairs[:3], **cfg)
    assert got == ref
    longs = [d for d in pst["dispatches"] if d["kind"] == "long"]
    assert longs and not any(d["int16"] for d in longs)
