"""The port's wavefront aligner (``ops/wfa.py``, its plain version on the
CPU) against the JAX package's: the cases of tests/test_wfa.py; scores,
history rows 0..score and ``backtrace_pair`` items bit-equal to JAX
``wfa_align_device`` on the same packed batches; and the runner's
``kernel='wfa'`` route equal to the JAX runner's, with an escalation, a
dropped pair and forced orientations."""

import numpy as np
import pytest
import torch

from seqrush_tpu.align.runner import RunnerConfig as JaxRunnerConfig
from seqrush_tpu.align.runner import WfaAligner as JaxAligner
from seqrush_tpu.ops import wfa as jwfa
from seqrush_tpu.scores import AlignmentScores as JaxScores
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch.align.pairs import all_ordered_pairs
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.ops import nw_cuda, wfa
from seqrush_tpu_torch.ops.wfa import Penalties
from seqrush_tpu_torch.pos import encode_bases
from seqrush_tpu_torch.scores import AlignmentScores
from seqrush_tpu_torch.sequences import make_sequence_set

PEN = Penalties(mismatch=5, gap1_open=8, gap1_extend=2, gap2_open=24, gap2_extend=1)
PEN1 = Penalties(mismatch=1, gap1_open=1, gap1_extend=1)
SCORES = "0,5,8,2,24,1"
BASES = np.frombuffer(b"ACGT", np.uint8)


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def run_batch(pairs, pen, smax=200, band=32, keep_history=True, caps=None):
    qs = [encode_bases(q) for q, _ in pairs]
    ts = [encode_bases(t) for _, t in pairs]
    Q, T, qlens, tlens = wfa.pack_batch(qs, ts)
    caps = np.full(len(pairs), smax, dtype=np.int32) if caps is None else caps
    scores, hists = wfa.wfa_align_device(*_tensors(Q, T, qlens, tlens, caps), smax=smax, band=band,
                                         keep_history=keep_history, **pen.kernel_kwargs())
    return scores.numpy(), {k: v.numpy() for k, v in hists.items()}


def check_cigar(items, q, t):
    """The CIGAR consumes exactly both sequences; '=' runs match, 'X' do not."""
    qi = ti = 0
    for n, op in items:
        if op == "=":
            assert q[qi : qi + n] == t[ti : ti + n]
        elif op == "X":
            assert all(q[qi + i] != t[ti + i] for i in range(n))
        qi += n if op in "=XI" else 0
        ti += n if op in "=XD" else 0
    assert qi == len(q) and ti == len(t)


def cigar_score(items, pen):
    s = 0
    for n, op in items:
        if op == "X":
            s += n * pen.mismatch
        elif op in "ID":
            g1 = pen.gap1_open + n * pen.gap1_extend
            s += min(g1, pen.gap2_open + n * pen.gap2_extend) if pen.two_piece else g1
    return s


def test_identical():
    scores, _ = run_batch([(b"ACGTACGT", b"ACGTACGT")], PEN)
    assert scores[0] == 0


def test_single_mismatch():
    scores, _ = run_batch([(b"ACGTACGT", b"ACGAACGT")], PEN)
    assert scores[0] == PEN.mismatch


def test_single_insertion():
    scores, _ = run_batch([(b"ACGTTACG", b"ACGTACG")], PEN)
    assert scores[0] == PEN.gap1_open + PEN.gap1_extend


def test_long_gap_uses_gap2():
    q = b"ACGTACGTACGT" + b"T" * 24 + b"GGCCAATT"
    t = b"ACGTACGTACGT" + b"GGCCAATT"
    scores, _ = run_batch([(q, t)], PEN, smax=200, band=40)
    assert scores[0] == 48  # min(8 + 2 * 24, 24 + 1 * 24)


def _mutate(rng, s):
    s = bytearray(s)
    for _ in range(rng.integers(0, 6)):
        op = rng.integers(0, 3)
        pos = rng.integers(0, len(s))
        if op == 0:
            s[pos] = BASES[rng.integers(0, 4)]
        elif op == 1 and len(s) > 4:
            del s[pos : pos + int(rng.integers(1, 4))]
        else:
            s[pos:pos] = BASES[rng.integers(0, 4, size=int(rng.integers(1, 4)))].tobytes()
    return bytes(s)


@pytest.mark.parametrize("seed", range(3))
def test_random_vs_dp(seed):
    rng = np.random.default_rng(seed)
    base = BASES[rng.integers(0, 4, size=60)].tobytes()
    pairs = [(_mutate(rng, base), _mutate(rng, base)) for _ in range(4)]
    scores, hists = run_batch(pairs, PEN, smax=400, band=40)
    for b, (q, t) in enumerate(pairs):
        dp = wfa.affine2p_score_dp(np.frombuffer(q, np.uint8), np.frombuffer(t, np.uint8), PEN)
        assert scores[b] == dp
        items = wfa.backtrace_pair({k: v[b] for k, v in hists.items()}, int(scores[b]), len(q),
                                   len(t), 40, PEN)
        check_cigar(items, q, t)
        assert cigar_score(items, PEN) == dp


@pytest.mark.parametrize("seed", range(2))
def test_random_vs_dp_single_piece(seed):
    rng = np.random.default_rng(100 + seed)
    q = BASES[rng.integers(0, 4, size=40)].tobytes()
    t = BASES[rng.integers(0, 4, size=44)].tobytes()
    scores, hists = run_batch([(q, t)], PEN1, smax=100, band=48)
    dp = wfa.affine2p_score_dp(np.frombuffer(q, np.uint8), np.frombuffer(t, np.uint8), PEN1)
    assert scores[0] == dp
    assert set(hists) == {"M", "I1", "D1"}
    items = wfa.backtrace_pair({k: v[0] for k, v in hists.items()}, int(scores[0]), len(q), len(t),
                               48, PEN1)
    check_cigar(items, q, t)
    assert cigar_score(items, PEN1) == dp


def test_score_only_mode_matches():
    rng = np.random.default_rng(7)
    pairs = []
    for _ in range(3):
        q = BASES[rng.integers(0, 4, size=50)].tobytes()
        t = bytearray(q)
        t[10] = BASES[(q[10] + 1) % 4]
        pairs.append((q, bytes(t)))
    s_hist, hists = run_batch(pairs, PEN, keep_history=True)
    s_fast, none = run_batch(pairs, PEN, keep_history=False)
    assert (s_hist == s_fast).all() and hists and none == {}
    # the rolling window: the deepest lookback plus one row
    Q, T, ql, tl = wfa.pack_batch([encode_bases(q) for q, _ in pairs], [encode_bases(t) for _, t in pairs])
    s, rolling = wfa.wfa_run(*_tensors(Q, T, ql, tl, np.full(3, 200, np.int32)), smax=200, band=32,
                             keep_history=False, **PEN.kernel_kwargs())
    assert [tuple(h.shape) for h in rolling] == [(3, 26, 65)] * 5


def test_score_cap_rejects():
    scores, _ = run_batch([(b"AAAATTTTCCCCGGGG", b"TTTTAAAAGGGGCCCC")], PEN, smax=200, band=16,
                          keep_history=False, caps=np.array([3], np.int32))
    assert scores[0] == -1


def test_penalty_checks():
    Q, T, ql, tl = wfa.pack_batch([encode_bases(b"ACGT")], [encode_bases(b"ACGT")])
    args = _tensors(Q, T, ql, tl, np.array([9], np.int32))
    with pytest.raises(ValueError, match="extends"):
        wfa.wfa_align_device(*args, mismatch=5, o1=8, e1=0, o2=-1, e2=-1, smax=9, band=4,
                             keep_history=True)
    with pytest.raises(ValueError, match="int32"):
        wfa.wfa_align_device(*args[:4], args[4].to(torch.int64), mismatch=5, o1=8, e1=2, o2=-1,
                             e2=-1, smax=9, band=4, keep_history=True)


def _parity_batch():
    """Seeded pairs: SNPs, indels long enough for the second gap piece, an
    identical pair, a length-different pair and one beyond its cap."""
    rng = np.random.default_rng(23)
    base = rng.integers(0, 4, 180).astype(np.uint8)
    qs, ts = [], []
    for k in range(5):
        t = base.copy()
        t[rng.integers(0, t.size, 3 + k)] = rng.integers(0, 4, 3 + k)
        p = int(rng.integers(20, 140))
        t = np.delete(t, np.arange(p, p + 2 + 7 * k)) if k % 2 else np.insert(
            t, p, rng.integers(0, 4, 1 + 6 * k).astype(np.uint8))
        qs.append(base)
        ts.append(t)
    qs += [base, base[:150], base]
    ts += [base.copy(), base[10:], rng.integers(0, 4, 180).astype(np.uint8)]
    Q, T, ql, tl = wfa.pack_batch(qs, ts)
    caps = np.full(len(qs), 250, np.int32)
    caps[-1] = 60
    return Q, T, ql, tl, caps


@pytest.fixture(scope="module", params=[True, False], ids=["two_piece", "one_piece"])
def parity(request):
    two = request.param
    Q, T, ql, tl, caps = _parity_batch()
    kw = dict(mismatch=5, o1=8, e1=2, o2=24 if two else -1, e2=1 if two else -1, smax=250,
              band=48, keep_history=True)
    j_s, j_h = jwfa.wfa_align_device(Q, T, ql, tl, caps, **kw)
    p_s, p_h = wfa.wfa_align_device(*_tensors(Q, T, ql, tl, caps), **kw)
    pen = Penalties(5, 8, 2, 24 if two else None, 1 if two else None)
    return (np.asarray(j_s), {k: np.asarray(v) for k, v in j_h.items()}, p_s.numpy(),
            {k: v.numpy() for k, v in p_h.items()}, ql, tl, caps, pen)


def test_parity_scores_and_history_rows(parity):
    j_s, j_h, p_s, p_h, _ql, _tl, caps, pen = parity
    assert np.array_equal(p_s, j_s)
    assert (p_s >= 0).sum() >= 6 and p_s[-1] == -1
    assert set(p_h) == set(j_h) == ({"M", "I1", "D1", "I2", "D2"} if pen.two_piece else {"M", "I1", "D1"})
    for b, s in enumerate(p_s):
        last = int(s) if s >= 0 else int(caps[b])  # the steps the pair took
        for k in j_h:
            assert np.array_equal(p_h[k][b, : last + 1], j_h[k][b, : last + 1]), (k, b)
            # the port's rows past the pair's end stay null
            assert (p_h[k][b, last + 1 :] == wfa.NULL16).all()


def test_parity_backtrace(parity):
    j_s, j_h, p_s, p_h, ql, tl, _caps, pen = parity
    jpen = jwfa.Penalties(pen.mismatch, pen.gap1_open, pen.gap1_extend, pen.gap2_open,
                          pen.gap2_extend)
    for b, s in enumerate(p_s):
        if s < 0:
            continue
        ref = jwfa.backtrace_pair({k: v[b] for k, v in j_h.items()}, int(s), int(ql[b]), int(tl[b]),
                                  48, jpen)
        got = wfa.backtrace_pair({k: v[b, : int(s) + 1] for k, v in p_h.items()}, int(s), int(ql[b]),
                                 int(tl[b]), 48, pen)
        assert got == ref, b


def _corpus():
    """Four 300 bp haplotypes (SNPs and short indels) and one unrelated
    sequence, which the divergence cap drops."""
    rng = np.random.default_rng(31)
    base = BASES[rng.integers(0, 4, 300)]
    named = [("h0", base.tobytes())]
    for k in range(1, 4):
        v = bytearray(base.tobytes())
        for pos in rng.integers(0, len(v), 6):
            v[pos] = BASES[rng.integers(0, 4)]
        p = int(rng.integers(20, 260))
        del v[p : p + 3 * k]
        named.append((f"h{k}", bytes(v)))
    named.append(("rnd", BASES[rng.integers(0, 4, 290)].tobytes()))
    return named


def _keys(results):
    return [(r.query_idx, r.target_idx, r.is_reverse, r.score, r.cigar_string) for r in results]


def _wfa_runners(named, **cfg):
    ref = JaxAligner(jax_seqs(named), JaxRunnerConfig(scores=JaxScores.parse(SCORES), kernel="wfa",
                                                      **cfg))
    port = WfaAligner(make_sequence_set(named),
                      RunnerConfig(scores=AlignmentScores.parse(SCORES), kernel="wfa", **cfg),
                      device="cpu")
    return ref, port


def test_runner_wfa_equals_jax_with_escalation_and_drop():
    named = _corpus()
    pairs = all_ordered_pairs(len(named))
    ref, port = _wfa_runners(named, initial_smax=32, max_divergence=0.1)
    assert _keys(port.align_pairs(pairs)) == _keys(ref.align_pairs(pairs))
    for k in ("escalations", "dropped", "alignments"):
        assert port.stats[k] == ref.stats[k], k
    assert port.stats["escalations"] > 0 and port.stats["dropped"] > 0
    batches = [d for d in port.stats["dispatches"] if d["kind"] == "wfa"]
    assert [d["smax"] for d in batches][:2] == [32, 128]
    assert all(d["steps"] <= d["smax"] for d in batches)


def test_runner_wfa_oriented_equals_jax():
    named = _corpus()[:4]
    pairs = np.array([[0, 1], [1, 2], [3, 0], [2, 3]])
    rev = np.array([False, True, False, True])
    ref, port = _wfa_runners(named, band_slack=16)
    assert _keys(port.align_pairs_oriented(pairs, rev)) == _keys(ref.align_pairs_oriented(pairs, rev))
    jobs = [j for d in port.stats["dispatches"] if d["kind"] == "wfa" for j in d["jobs"]]
    assert sorted({tuple(j) for j in jobs}) == [(p, int(r)) for p, r in enumerate(rev)]


def test_take_batch_splits_at_the_budget_as_jax():
    """With a small memory budget the batches (and so each batch's band)
    are the JAX package's."""
    named = _corpus()
    pairs = all_ordered_pairs(len(named))
    ref, port = _wfa_runners(named, memory_budget_bytes=12_000_000)
    pending = [(int(p), 256) for p in range(len(pairs))]
    out_p, out_j = [], []
    rest_p, rest_j = pending, pending
    while rest_p:
        b_p, rest_p = port._take_batch(rest_p, pairs)
        b_j, rest_j = ref._take_batch(rest_j, pairs)
        out_p.append(b_p)
        out_j.append(b_j)
    assert out_p == out_j and len(out_p) > 1


HEADLINE = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1)


def test_wfa_launch_plan():
    """Threads cover the diagonals (at most 1,024, striding past that); the
    lookback rings and the sequences go to shared memory where they fit."""
    plan = wfa.wfa_plan(3648, 3648, 255, **HEADLINE)
    assert plan == wfa.WfaPlan("rings", True, 512, (26, 3, 2), 36944, 7328)
    assert plan.smem_bytes == 36944 + 7328
    assert wfa.wfa_plan(3648, 3648, 600, **HEADLINE).threads == 1024
    assert wfa.wfa_plan(120_064, 120_064, 31, **HEADLINE) == wfa.WfaPlan("rings", False, 64, (26, 3, 2),
                                                                           4688, 0)
    assert wfa.wfa_plan(100, 100, 0, **HEADLINE) == wfa.WfaPlan("rings", True, 32, (26, 3, 2), 224, 256)
    assert "wfa" in nw_cuda.LAUNCHES and "wfa_score_only" in nw_cuda.LAUNCHES


def _staged(row: np.ndarray, pad: int) -> bytes:
    """A row as the kernel stages it: rounded up to 16 bytes plus 16 of
    slack, the rest filled with pad."""
    n = -(-row.size // 16) * 16 + 16
    return row.tobytes() + bytes([pad]) * (n - row.size)


def _blocked_extend(h, k, q: bytes, t: bytes, ql, tl):
    """The kernel's greedy extension (csrc/wfa.cu::wfa_extend), modelled: 8
    bases a compare, each operand from two aligned 8-byte words and a shift,
    the first differing base from the xor's lowest set bit, the run capped
    at min(tl, h + (ql - v))."""

    def load8(buf, i):
        base, sh = i & ~7, (i & 7) * 8
        w0 = int.from_bytes(buf[base : base + 8], "little")
        if not sh:
            return w0
        w1 = int.from_bytes(buf[base + 8 : base + 16], "little")
        return ((w0 >> sh) | (w1 << (64 - sh))) & (2**64 - 1)

    v = h - k
    lim = min(tl - h, ql - v)
    n = 0
    while n < lim:
        diff = load8(t, h + n) ^ load8(q, v + n)
        if diff:
            n += ((diff & -diff).bit_length() - 1) >> 3
            break
        n += 8
    return h + min(n, lim)


def _extension_pairs(rng):
    """Seeded pairs with N codes, runs that end at either sequence's end (a
    prefix of the other, in both orders), identical sequences, a pair of
    nothing but N and one empty query."""
    base = rng.integers(0, 5, 700).astype(np.uint8)
    snp = base.copy()
    snp[rng.integers(0, 700, 9)] = rng.integers(0, 5, 9)
    return [(base, snp), (base[:450], base), (base, base[:333]), (base, base.copy()),
            (np.full(77, 4, np.uint8), np.full(91, 4, np.uint8)), (np.zeros(0, np.uint8), base[:40]),
            (rng.integers(0, 4, 500).astype(np.uint8), rng.integers(0, 4, 530).astype(np.uint8))]


@pytest.mark.parametrize("seed", range(3))
def test_blocked_extension_equals_byte_loop(seed):
    """The kernel's 8-byte extension, modelled in Python on staged copies
    of the rows, gives the port's byte loop (ops/wfa.py::_extend) offset for
    offset on every real cell of every diagonal, whatever the pads hold."""
    rng = np.random.default_rng(seed)
    pairs = _extension_pairs(rng)
    band = 40
    Q, T, ql, tl = wfa.pack_batch([q for q, _ in pairs], [t for _, t in pairs])
    ks = np.arange(-band, band + 1)
    M = np.full((len(pairs), ks.size), wfa.NULL, np.int64)
    for b in range(len(pairs)):
        for j, k in enumerate(ks):
            lo, hi = max(0, int(k)), min(int(tl[b]), int(ql[b]) + int(k))
            if lo <= hi:
                M[b, j] = rng.integers(lo, hi + 1) if rng.random() < 0.7 else lo
    ref = wfa._extend(torch.from_numpy(M), torch.from_numpy(ks)[None, :], torch.from_numpy(Q),
                      torch.from_numpy(T), torch.from_numpy(ql.astype(np.int64))[:, None],
                      torch.from_numpy(tl.astype(np.int64))[:, None]).numpy()
    runs = 0
    for b, (q, t) in enumerate(pairs):
        # the kernel's staged rows, the bare sequences with the packing's
        # pads, and with pads that match each other: the cap, not the pads,
        # ends a run at a sequence's end
        for staged_q, staged_t in ((_staged(Q[b], 0xFF), _staged(T[b], 0xFE)),
                                   (_staged(q, wfa.QPAD), _staged(t, wfa.TPAD)),
                                   (_staged(q, 0), _staged(t, 0))):
            for j, k in enumerate(ks):
                if M[b, j] == wfa.NULL:
                    continue
                got = _blocked_extend(int(M[b, j]), int(k), staged_q, staged_t, int(ql[b]), int(tl[b]))
                assert got == ref[b, j], (b, int(k))
                runs += got - M[b, j] >= 8
    assert runs > 0
