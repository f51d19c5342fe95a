"""Run-token emission in the port (kernel B's runs mode, through its plain
version on the CPU) against the JAX package's ``nw_align_with_runs``: the
tokens and counts bit-equal, with the run cap and the token budget shrunk so
that runs split and lists overflow; the port's ``decode_runs_batch`` equal to
the JAX package's; the runner, the anchored route's window chunks and the
sweepga backend's gap chunks equal to the JAX package's, results and
``run_overflows``, under every ``emit`` and with their budgets shrunk; the
``--no-sort`` GFA under the default ``emit`` byte-identical."""

import jax
import numpy as np
import pytest
import torch

import seqrush_tpu.align.anchored as jax_anchored
import seqrush_tpu.align.sweep as jax_sweep
import seqrush_tpu_torch.align.anchored as port_anchored
import seqrush_tpu_torch.align.sweep as port_sweep
from seqrush_tpu.align.runner import RunnerConfig as JaxRunnerConfig
from seqrush_tpu.align.runner import WfaAligner as JaxAligner
from seqrush_tpu.align.sweep import SweepAligner as JaxSweepAligner
from seqrush_tpu.ops import nw as jnw
from seqrush_tpu.scores import AlignmentScores as JaxScores
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch.align.pairs import all_ordered_pairs
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.align.sweep import SweepAligner
from seqrush_tpu_torch.ops import nw, nw_cuda
from seqrush_tpu_torch.scores import AlignmentScores
from seqrush_tpu_torch.sequences import make_sequence_set
from test_torch_pipeline import _graft_corpus, _jax_gfa, _mutator_cases, _port_gfa

KW = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1)
SCORES = "0,5,8,2,24,1"
BASES = np.frombuffer(b"ACGT", np.uint8)
BAND, TMAX = 127, 768

# case: (run_max, run-length cap); the smaller caps split runs, the smaller
# budgets cut the token lists (counts past run_max)
CASES = {"default": (128, (1 << 14) - 1), "overflow": (4, (1 << 14) - 1), "split": (128, 5),
         "split_overflow": (6, 3)}


def _batch():
    """Seeded pairs of mixed lengths: an identical pair, SNPs, indels of one
    and two gap pieces, length-different pairs, and a zero-length row."""
    rng = np.random.default_rng(17)
    base = rng.integers(0, 4, 320).astype(np.uint8)
    qs, ts = [base], [base.copy()]
    for k in range(5):
        t = base.copy()
        t[rng.integers(0, t.size, 4 + 2 * k)] = rng.integers(0, 4, 4 + 2 * k)
        for _ in range(k):
            p = int(rng.integers(10, t.size - 40))
            t = np.delete(t, np.arange(p, p + int(rng.integers(1, 4 + 10 * (k == 4)))))
        qs.append(base)
        ts.append(t)
    qs.append(base[:250])
    ts.append(base[20:])
    qs.append(np.zeros(0, np.uint8))
    ts.append(np.zeros(0, np.uint8))
    B = len(qs)
    Q = np.full((B, 384), nw.QPAD, np.uint8)
    T = np.full((B, 384), nw.TPAD, np.uint8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        Q[b, : q.size] = q
        T[b, : t.size] = t
    ql = np.array([q.size for q in qs], np.int32)
    tl = np.array([t.size for t in ts], np.int32)
    return Q, T, ql, tl, qs, ts


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's (scores, tokens, counts) of _batch() for each case
    (its run cap is read while tracing: caches are dropped around it)."""
    Q, T, ql, tl, _qs, _ts = _batch()
    out = {}
    saved = jnw._RUN_LEN_MAX
    try:
        for name, (run_max, cap) in CASES.items():
            jnw._RUN_LEN_MAX = cap
            jax.clear_caches()
            s, tok, cnt = jnw.nw_align_with_runs(Q, T, ql, tl, band=BAND, tmax=TMAX, run_max=run_max,
                                                 **KW)
            out[name] = (np.asarray(s), np.asarray(tok), np.asarray(cnt))
    finally:
        jnw._RUN_LEN_MAX = saved
        jax.clear_caches()
    return out


@pytest.fixture(scope="module")
def port_tb():
    Q, T, ql, tl, qs, ts = _batch()
    Qt, Tt, qt, tt = (torch.from_numpy(a) for a in (Q, T, ql, tl))
    scores, tb = nw_cuda.nw_align(Qt, Tt, qt, tt, band=BAND, tmax=TMAX, **KW)
    return scores, tb, qt, tt, qs, ts


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_tokens_equal_jax(case, jax_runs, port_tb, monkeypatch):
    run_max, cap = CASES[case]
    monkeypatch.setattr(nw, "_RUN_LEN_MAX", cap)
    scores, tb, qt, tt, qs, _ts = port_tb
    tok, cnt = nw_cuda.nw_walk_runs(tb, qt, tt, band=BAND, tmax=TMAX, run_max=run_max)
    j_s, j_tok, j_cnt = jax_runs[case]
    # the zero-length row has no final anti-diagonal in the port's sweep
    # (score -1, as nw_pallas gives it); its walk is empty either way
    assert np.array_equal(scores.numpy()[:-1], j_s[:-1])
    assert tok.dtype == torch.int32 and tuple(tok.shape) == (len(qs), run_max)
    assert np.array_equal(tok.numpy(), j_tok)
    assert np.array_equal(cnt.numpy(), j_cnt)
    lens = tok.numpy() >> 2
    assert lens.max() <= cap
    assert int(cnt[0]) == -(-qs[0].size // cap)  # the identical pair: one '=' run, split
    assert int(cnt[-1]) == 0  # the zero-length row
    if case in ("overflow", "split_overflow"):
        assert (cnt.numpy() > run_max).any()
    if case.startswith("split"):
        assert (lens == cap).any()
    # the kernel's argument overrides the module's cap
    tok2, cnt2 = nw_cuda.nw_walk_runs(tb, qt, tt, band=BAND, tmax=TMAX, run_max=run_max,
                                      run_len_max=cap)
    assert torch.equal(tok2, tok) and torch.equal(cnt2, cnt)


@pytest.mark.parametrize("case", ["default", "split"])
def test_decode_runs_batch_equals_jax_and_opcodes(case, jax_runs, port_tb):
    _s, j_tok, j_cnt = jax_runs[case]
    _scores, tb, qt, tt, qs, ts = port_tb
    got = nw.decode_runs_batch(j_tok, j_cnt, qs, ts)
    assert got == jnw.decode_runs_batch(j_tok, j_cnt, qs, ts)
    ops = nw_cuda.nw_walk(tb, qt, tt, band=BAND, tmax=TMAX)
    assert got == nw.decode_batch(ops.numpy(), qs, ts)


def test_runs_mode_checks():
    _Q, _T, ql, tl, *_ = _batch()
    tb = torch.zeros((ql.size, nw.tmax_pad_of(TMAX), BAND + 1), dtype=torch.uint8)
    qt, tt = torch.from_numpy(ql), torch.from_numpy(tl)
    with pytest.raises(ValueError, match="2\\^15"):
        nw_cuda.nw_walk_runs(torch.zeros((1, nw.tmax_pad_of(32764), 1), dtype=torch.uint8),
                             qt[:1], tt[:1], band=0, tmax=32764, run_max=8)
    with pytest.raises(ValueError, match="run_len_max"):
        nw_cuda.nw_walk_runs(tb, qt, tt, band=BAND, tmax=TMAX, run_max=8, run_len_max=1 << 14)
    with pytest.raises(ValueError, match="does not fit"):
        nw_cuda.nw_walk_runs(tb, qt, tt, band=BAND + 1, tmax=TMAX, run_max=8)


def _indel_corpus(n=4, length=300, seed=9):
    """A base and copies with eight short deletions and a few SNPs each: about
    17 runs a walk, so a budget of 4 tokens overflows."""
    rng = np.random.default_rng(seed)
    base = BASES[rng.integers(0, 4, length)]
    named = [("a", base.tobytes())]
    for k in range(n - 1):
        v = bytearray(base.tobytes())
        for _ in range(8):
            p = int(rng.integers(0, len(v) - 20))
            del v[p : p + int(rng.integers(1, 6))]
        for pos in rng.integers(0, len(v), 4):
            v[pos] = BASES[rng.integers(0, 4)]
        named.append((f"s{k}", bytes(v)))
    return named


def _keys(results):
    return [(r.query_idx, r.target_idx, r.is_reverse, r.score, r.cigar_string) for r in results]


@pytest.mark.parametrize("emit", ["auto", "runs", "ops"])
@pytest.mark.parametrize("run_max", [128, 4])
def test_runner_emit_modes_equal_jax(emit, run_max, monkeypatch):
    """Results and run_overflows equal the JAX runner's; an overflowing pair
    retries in a chunk of its own through the opcode walk."""
    monkeypatch.setattr(jnw, "RUN_MAX", run_max)
    monkeypatch.setattr(nw, "RUN_MAX", run_max)
    named = _indel_corpus()
    pairs = all_ordered_pairs(len(named))
    ref = JaxAligner(jax_seqs(named), JaxRunnerConfig(scores=JaxScores.parse(SCORES), emit=emit))
    port = WfaAligner(make_sequence_set(named),
                      RunnerConfig(scores=AlignmentScores.parse(SCORES), emit=emit), device="cpu")
    assert _keys(port.align_pairs(pairs)) == _keys(ref.align_pairs(pairs))
    assert port.stats["run_overflows"] == ref.stats["run_overflows"]
    emits = [d["emit"] for d in port.stats["dispatches"]]
    if emit == "ops":
        assert emits == ["ops"] and port.stats["run_overflows"] == 0
    elif run_max == 4:
        assert port.stats["run_overflows"] > 0 and emits == ["runs", "ops"]
        retried = port.stats["dispatches"][1]["jobs"]
        assert len(retried) == port.stats["run_overflows"]
        # a second call keeps the overflowed pairs on the opcode walk
        n = port.stats["run_overflows"]
        assert _keys(port.align_pairs(pairs)) == _keys(ref.align_pairs(pairs))
        again = port.stats["dispatches"][2:]
        assert port.stats["run_overflows"] == n
        assert [d["jobs"] for d in again if d["emit"] == "ops"] == [retried]
    else:
        assert emits == ["runs"] and port.stats["run_overflows"] == 0


def _divergent_pair():
    """A 700 bp pair with a 150 bp inverted block and SNPs around it: with
    the anchored route's thresholds lowered, its core window runs on the
    device."""
    rng = np.random.default_rng(4)
    base = BASES[rng.integers(0, 4, 700)].tobytes()
    s = bytearray(base)
    s[300:450] = bytes(s[300:450]).translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]
    for pos in rng.integers(0, len(s), 12):
        s[pos] = BASES[rng.integers(0, 4)]
    return [("a", base), ("b", bytes(s))]


@pytest.mark.parametrize("win_run_max", [32, 2])
def test_window_overflow_equals_jax(win_run_max, monkeypatch):
    """The anchored route's device window chunk fetches run tokens; windows
    that overflow WIN_RUN_MAX re-run through opcodes at the same band."""
    monkeypatch.setattr(jax_anchored, "WIN_RUN_MAX", win_run_max)
    monkeypatch.setattr(port_anchored, "WIN_RUN_MAX", win_run_max)
    named = _divergent_pair()
    pairs = np.array([[0, 1], [1, 0]])
    cfg = dict(wide_band_threshold=63, wide_min_len=256, wide_host_window_cells=0)
    ref = JaxAligner(jax_seqs(named), JaxRunnerConfig(scores=JaxScores.parse(SCORES), **cfg))
    port = WfaAligner(make_sequence_set(named),
                      RunnerConfig(scores=AlignmentScores.parse(SCORES), **cfg), device="cpu")
    assert _keys(port.align_pairs(pairs)) == _keys(ref.align_pairs(pairs))
    for k in ("run_overflows", "anchored_pairs", "anchored_windows", "host_windows"):
        assert port.stats[k] == ref.stats[k], k
    windows = [d for d in port.stats["dispatches"] if d["kind"] == "window"]
    assert port.stats["anchored_pairs"] > 0 and windows[0]["emit"] == "runs"
    if win_run_max == 2:
        assert port.stats["run_overflows"] > 0
        assert windows[-1]["emit"] == "ops" and windows[-1]["B"] == port.stats["run_overflows"]
    else:
        assert port.stats["run_overflows"] == 0


def _records(res):
    return [(r.query_idx, r.target_idx, r.is_reverse, r.score, r.query_start, r.target_start,
             r.cigar) for r in res]


@pytest.mark.parametrize("gap_run_max", [24, 2])
def test_gap_overflow_equals_jax(gap_run_max, monkeypatch):
    """The sweepga gap chunk fetches run tokens; windows that overflow
    GAP_RUN_MAX are repacked into a chunk of their own (its own band) and
    re-aligned through opcodes."""
    monkeypatch.setattr(jax_sweep, "GAP_RUN_MAX", gap_run_max)
    monkeypatch.setattr(port_sweep, "GAP_RUN_MAX", gap_run_max)
    rng = np.random.default_rng(90)
    base = BASES[rng.integers(0, 4, 900)].tobytes()
    alt = bytearray(base)
    for pos in rng.integers(0, len(alt), 14):
        alt[pos] = BASES[rng.integers(0, 4)]
    del alt[500:520]
    del alt[300:330]
    named = [("a", base), ("b", bytes(alt))]
    pairs = all_ordered_pairs(2)
    jal = JaxSweepAligner(jax_seqs(named), JaxRunnerConfig(wide_host_window_cells=0))
    pal = SweepAligner(make_sequence_set(named), RunnerConfig(wide_host_window_cells=0), device="cpu")
    assert _records(pal.align_pairs(pairs)) == _records(jal.align_pairs(pairs))
    assert pal.stats["run_overflows"] == jal.stats["run_overflows"]
    gaps = [d for d in pal.stats["dispatches"] if d["kind"] == "gap"]
    assert gaps[0]["emit"] == "runs"
    if gap_run_max == 2:
        assert pal.stats["run_overflows"] > 0
        assert gaps[-1]["emit"] == "ops" and len(gaps[-1]["jobs"]) == pal.stats["run_overflows"]
    else:
        assert pal.stats["run_overflows"] == 0 and len(gaps) == 1


@pytest.mark.parametrize("case", ["combination", "tandem_dup", "graft"])
def test_default_emit_gfa_byte_identical(case, tmp_path):
    """The pipeline corpora's --no-sort GFA under the default emit, which
    now fetches run tokens, equals the JAX package's byte for byte."""
    named = _graft_corpus() if case == "graft" else _mutator_cases()[case]
    ref, jsr = _jax_gfa(named, tmp_path)
    got, psr = _port_gfa(named, tmp_path)
    assert got == ref
    st = psr.stats["aligner"]
    assert st["run_overflows"] == jsr.stats["aligner"]["run_overflows"]
    assert {d["emit"] for d in st["dispatches"] if d["kind"] == "chunk"} == {"runs"}
