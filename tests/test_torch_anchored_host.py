"""The anchored wide route's host pieces in seqrush_tpu_torch against
seqrush_tpu's: the host library (chain_pairs, window_dp) bit for bit against
the JAX package's C++ and against the port's Python chain, the minimizer
anchors, the flank trim, the plan and chunk cuts, the CIGAR helpers, and
kernel A's score-only mode on the CPU.  Tolerance 0 throughout: every
quantity is an integer or a byte."""

import numpy as np
import pytest
import torch

from seqrush_tpu import native as jax_native
from seqrush_tpu.align import anchored as jax_anchored
from seqrush_tpu.align.runner import RunnerConfig as JaxRunnerConfig
from seqrush_tpu.align.runner import WfaAligner as JaxAligner
from seqrush_tpu.ops import anchors as jax_anchors
from seqrush_tpu.ops.wfa import Penalties
from seqrush_tpu.scores import AlignmentScores as JaxScores
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch import native
from seqrush_tpu_torch.align import anchored
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.ops import anchors, nw_cuda
from seqrush_tpu_torch.scores import AlignmentScores
from seqrush_tpu_torch.sequences import make_sequence_set
from test_anchored_wide import synth_family

SCORES = "0,5,8,2,24,1"
PEN = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1)
PEN_ONE = dict(mismatch=4, o1=6, e1=2, o2=-1, e2=-1)


def _jax_pen(pen):
    two = pen["o2"] >= 0
    return Penalties(pen["mismatch"], pen["o1"], pen["e1"],
                     pen["o2"] if two else None, pen["e2"] if two else None)


@pytest.fixture(scope="module")
def family():
    """The family of tests/test_anchored_wide.py with both runners' wide jobs
    (every carrier pair, both orientations)."""
    named = synth_family()
    n = len(named)
    pairs = np.array([[i, n - 1] for i in range(n - 1)] + [[n - 1, j] for j in range(n - 1)] + [[0, 1]])
    jax_al = JaxAligner(jax_seqs(named), JaxRunnerConfig(scores=JaxScores.parse(SCORES)))
    port_al = WfaAligner(make_sequence_set(named), RunnerConfig(scores=AlignmentScores.parse(SCORES)),
                         device="cpu")
    jobs = [(p, rc, 1279) for p in range(len(pairs)) for rc in (False, True)]
    return pairs, jax_al, port_al, jobs


def _flat_anchors(anchor_sets):
    """chain_jobs' packing: per-job blocks sorted by (q, t), offsets."""
    offs = np.zeros(len(anchor_sets) + 1, np.int64)
    for w, a in enumerate(anchor_sets):
        offs[w + 1] = offs[w] + a.shape[0]
    if not offs[-1]:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), offs
    flat = np.concatenate([a for a in anchor_sets if a.shape[0]], axis=0)
    pid = np.repeat(np.arange(len(anchor_sets), dtype=np.int64), np.diff(offs))
    flat = flat[np.lexsort((flat[:, 1], flat[:, 0], pid))]
    return flat[:, 0].copy(), flat[:, 1].copy(), offs


def _random_anchor_sets(seed):
    """Seeded anchor sets: a colinear diagonal with gaps and shifts, repeat
    copies off the diagonal, random noise, duplicated q positions."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(24):
        n = int(rng.integers(1, 180))
        q = np.sort(rng.choice(6000, size=n, replace=False))
        shift = np.cumsum(rng.integers(-3, 4, size=n) * (rng.random(n) < 0.1))
        t = q + 40 + shift
        noise = rng.random(n) < 0.2
        t = np.where(noise, rng.integers(0, 6000, size=n), t)
        a = np.stack([q, np.maximum(t, 0)], axis=1)
        if k % 3 == 0:  # repeat copies: the same q on a second diagonal
            a = np.concatenate([a, a[: n // 2] + np.array([0, 1500])])
        out.append(np.unique(a, axis=0).astype(np.int64))
    out.insert(5, np.zeros((0, 2), np.int64))  # a job without anchors
    return out


def _family_anchor_sets(family):
    pairs, _jax_al, al, jobs = family
    return [
        anchors.anchor_matches_from_minimizers(
            al._minimizers(int(pairs[p][0]), rc), al._minimizers(int(pairs[p][1]), False),
            t_sorted=al._minimizers_sorted(int(pairs[p][1]), False),
        )
        for p, rc, _b in jobs
    ]


@pytest.mark.parametrize("case", ["family", "random", "empty"])
def test_chain_pairs_matches_jax_library_and_python_chain(case, family):
    if case == "family":
        sets = _family_anchor_sets(family)
    elif case == "random":
        sets = _random_anchor_sets(3)
    else:
        sets = [np.zeros((0, 2), np.int64)] * 3
    qs, ts, offs = _flat_anchors(sets)
    kw = dict(max_gap=anchors.DEFAULT_MAX_GAP, max_skew=anchors.DEFAULT_MAX_SKEW,
              max_chains=1, min_matched=0)
    got = native.chain_pairs_native(qs, ts, offs, 15, **kw)
    ref = jax_native.chain_pairs_native(qs, ts, offs, 15, **kw)
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the plain version: chain_anchors + chain_to_runs per job
    chain_pair, chain_off, rq, rt, rl = got
    runs = {int(w): list(zip(rq[chain_off[c]:chain_off[c + 1]].tolist(),
                             rt[chain_off[c]:chain_off[c + 1]].tolist(),
                             rl[chain_off[c]:chain_off[c + 1]].tolist()))
            for c, w in enumerate(chain_pair)}
    for w, a in enumerate(sets):
        expect = anchors.chain_to_runs(anchors.chain_anchors(a), 15) if a.shape[0] else []
        assert runs.get(w, []) == expect, w
    if case != "empty":
        assert sum(len(r) for r in runs.values()) > 0


def test_chain_jobs_matches_jax(family):
    pairs, jax_al, al, jobs = family
    got = anchored.chain_jobs(al, jobs, pairs)
    ref = jax_anchored.chain_jobs(jax_al, [(p, rc, b, True) for p, rc, b in jobs], pairs)
    assert [list(map(tuple, r)) for r in got] == [list(map(tuple, r)) for r in ref]
    assert sum(map(len, got)) > 0


def _random_windows(seed):
    """Seeded windows: related pairs (SNPs, indels, a reversed block), an
    empty side each way, identical sequences, one window over 256 a side."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(40):
        n = int(rng.integers(1, 90))
        q = rng.integers(0, 4, n).astype(np.uint8)
        t = q.copy()
        t[rng.integers(0, n, max(1, n // 10))] = rng.integers(0, 4, max(1, n // 10))
        if k % 4 == 1:
            t = np.delete(t, np.arange(n // 3, min(n, n // 3 + int(rng.integers(1, 9)))))
        elif k % 4 == 2:
            t = np.insert(t, n // 2, rng.integers(0, 4, int(rng.integers(1, 12))).astype(np.uint8))
        elif k % 4 == 3:
            a, b = n // 4, 3 * n // 4
            t[a:b] = (3 - t[a:b])[::-1]
        qs.append(q)
        ts.append(t)
    qs += [np.zeros(0, np.uint8), rng.integers(0, 4, 7).astype(np.uint8)]
    ts += [rng.integers(0, 4, 5).astype(np.uint8), np.zeros(0, np.uint8)]
    same = rng.integers(0, 4, 64).astype(np.uint8)
    qs.append(same)
    ts.append(same.copy())
    big = rng.integers(0, 4, 300).astype(np.uint8)
    big_t = big.copy()
    big_t[100:220] = (3 - big_t[100:220])[::-1]
    qs.append(big)
    ts.append(np.insert(big_t, 150, rng.integers(0, 4, 17).astype(np.uint8)))
    return qs, ts


@pytest.mark.parametrize("pen", [PEN, PEN_ONE], ids=["two_piece", "one_piece"])
def test_window_dp_matches_jax_library(pen):
    qs, ts = _random_windows(7)
    assert max(max(q.size, t.size) for q, t in zip(qs, ts)) > 256
    s_got, items_got = native.window_dp_native(qs, ts, pen, threads=4)
    s_ref, items_ref = jax_native.window_dp_native(qs, ts, _jax_pen(pen), threads=4)
    assert np.array_equal(s_got, s_ref)
    assert items_got == items_ref
    for q, t, s, items in zip(qs, ts, s_got, items_got):
        assert sum(n for n, op in items if op != "D") == q.size
        assert sum(n for n, op in items if op != "I") == t.size
        assert anchored.cigar_cost(items, pen) == s


def _codes(seed):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 4, n).astype(np.uint8) for n in (5, 14, 15, 20, 500, 3000)]
    with_n = rng.integers(0, 4, 800).astype(np.uint8)
    with_n[rng.integers(0, 800, 12)] = 4  # non-ACGT codes break k-mers
    out.append(with_n)
    rep = np.tile(rng.integers(0, 4, 37).astype(np.uint8), 30)  # repeats: many equal values
    out.append(rep)
    return out


@pytest.mark.parametrize("rc", [False, True], ids=["forward", "reverse_complement"])
def test_minimizer_anchors_match_jax(rc):
    seqs = _codes(5)
    if rc:
        seqs = [np.where(s[::-1] < 4, 3 - s[::-1], s[::-1]).astype(np.uint8) for s in seqs]
    mins = [anchors.minimizers(s, 15, 10) for s in seqs]
    for s, m in zip(seqs, mins):
        ref = jax_anchors.minimizers(s, 15, 10)
        assert np.array_equal(m[0], ref[0]) and np.array_equal(m[1], ref[1])
        srt, srt_ref = anchors.sort_minimizers(m), jax_anchors.sort_minimizers(ref)
        assert np.array_equal(srt[0], srt_ref[0]) and np.array_equal(srt[1], srt_ref[1])
    found = 0
    for a in range(len(seqs)):
        for b in range(len(seqs)):
            for max_freq in (None, 2):
                got = anchors.anchor_matches_from_minimizers(
                    mins[a], mins[b], max_freq=max_freq, t_sorted=anchors.sort_minimizers(mins[b]))
                ref = jax_anchors.anchor_matches_from_minimizers(mins[a], mins[b], max_freq=max_freq)
                assert np.array_equal(got, ref)
                found += got.shape[0]
    assert found > 0


def test_flank_trim_matches_jax_and_sequential():
    """The port's copy of test_flank_trim_batch_matches_sequential, and the
    flanks equal the JAX package's."""
    named = synth_family(n_seqs=4, length=1500, seed=41)
    al = WfaAligner(make_sequence_set(named), RunnerConfig(scores=AlignmentScores.parse(SCORES)),
                    device="cpu")
    jax_al = JaxAligner(jax_seqs(named), JaxRunnerConfig(scores=JaxScores.parse(SCORES)))
    pairs = np.array([[0, 1], [1, 2], [2, 3], [0, 3]])
    jobs = [(p, bool(p % 2), 255) for p in range(len(pairs))]
    runs_per_job = anchored.chain_jobs(al, jobs, pairs)
    flanks = anchored.flank_trim_jobs(al, jobs, pairs, runs_per_job)
    ref = jax_anchored.flank_trim_jobs(jax_al, [(p, rc, b, False) for p, rc, b in jobs], pairs,
                                       runs_per_job)
    checked = 0
    for (p, rc, _b), runs, fl, fr in zip(jobs, runs_per_job, flanks, ref):
        if not runs:
            assert fl is None and fr is None
            continue
        assert np.array_equal(fl[0], fr[0]) and np.array_equal(fl[1], fr[1])
        qi, tj = pairs[p]
        q = al.rc_codes[qi] if rc else al.codes[qi]
        t = al.codes[tj]
        ra = np.asarray(runs, np.int64).reshape(-1, 3)
        gq0 = np.concatenate([[0], ra[:, 0] + ra[:, 2]])
        gt0 = np.concatenate([[0], ra[:, 1] + ra[:, 2]])
        gq1 = np.concatenate([ra[:, 0], [q.size]])
        gt1 = np.concatenate([ra[:, 1], [t.size]])
        for g in range(gq0.size):
            pre, suf = anchored._flank_match(q, t, int(gq0[g]), int(gq1[g]), int(gt0[g]), int(gt1[g]))
            assert (int(fl[0][g]), int(fl[1][g])) == (pre, suf), (p, rc, g)
            checked += 1
    assert checked > 0


def test_build_plan_matches_jax(family):
    """Every wide job's parts and divergence-core windows equal the JAX
    package's plan (which decides what is aligned where)."""
    pairs, jax_al, al, jobs = family
    jjobs = [(p, rc, b, True) for p, rc, b in jobs]
    runs = anchored.chain_jobs(al, jobs, pairs)
    flanks = anchored.flank_trim_jobs(al, jobs, pairs, runs)
    win, jwin = [], []
    for job, jjob, r, f in zip(jobs, jjobs, runs, flanks):
        plan = anchored.build_plan(al, job, pairs, win, r, f)
        jplan = jax_anchored.build_plan(jax_al, jjob, pairs, None, jwin, runs=r, flanks=f)
        assert (plan is None) == (jplan is None)
        if plan is not None:
            assert plan.parts == jplan.parts
    assert len(win) == len(jwin) > 0
    for (qw, tw, (p, rc, q0, t0)), (jq, jt) in zip(win, jwin):
        assert np.array_equal(qw, jq) and np.array_equal(tw, jt)
        q = al.rc_codes[pairs[p][0]] if rc else al.codes[pairs[p][0]]
        assert np.array_equal(q[q0 : q0 + qw.size], qw)
        assert np.array_equal(al.codes[pairs[p][1]][t0 : t0 + tw.size], tw)


def test_plan_chunks_and_window_packing_match_jax(family):
    """The device windows' chunk cuts equal _plan_chunks of the JAX package,
    and each chunk packs to its launch shape: B a power of two >= 8, Lq and
    Lt multiples of 128, tmax of 256, zero-length padding rows."""
    pairs, jax_al, al, _jobs = family
    rng = np.random.default_rng(2)
    sizes = [(int(a), int(b)) for a, b in rng.integers(1, 1400, size=(60, 2))]
    jobs = [(np.zeros(a, np.uint8), np.zeros(b, np.uint8), (0, False, 0, 0)) for a, b in sizes]
    pending = [(j, anchored._initial_window_band(q, t)) for j, (q, t, _s) in enumerate(jobs)]
    jpending = [(j, jax_anchored._initial_window_band(q, t)) for j, (q, t, _s) in enumerate(jobs)]
    assert pending == jpending
    got = anchored._plan_chunks(al, jobs, pending)
    ref = jax_anchored._plan_chunks(jax_al, [(q, t) for q, t, _s in jobs], jpending)
    assert got == ref and len(got) > 1
    for chunk, band in got:
        Q, T, ql, tl, band_k, tmax = anchored.pack_windows(jobs, chunk, band)
        B = Q.shape[0]
        assert B >= 8 and B & (B - 1) == 0 and B >= len(chunk)
        assert Q.shape[1] % 128 == 0 and T.shape[1] % 128 == 0 and tmax % 256 == 0
        assert band_k == min(band, max(Q.shape[1], T.shape[1]) + 1)
        assert tmax > int((ql + tl).max()) and (ql[len(chunk):] == 0).all()


def test_cigar_helpers_match_jax():
    rng = np.random.default_rng(9)
    ops = "=XID"
    for _ in range(50):
        items = [(int(rng.integers(1, 40)), ops[int(rng.integers(0, 4))]) for _ in range(12)]
        assert anchored.max_excursion(items) == jax_anchored.max_excursion(items)
        for pen in (PEN, PEN_ONE):
            assert anchored.cigar_cost(items, pen) == jax_anchored.cigar_cost(items, _jax_pen(pen))
    assert anchored.max_excursion([(10, "="), (3, "I"), (2, "X"), (5, "D"), (4, "=")]) == 3


@pytest.mark.parametrize("pen", [PEN, PEN_ONE], ids=["two_piece", "one_piece"])
def test_score_only_sweep_equals_full_sweep_on_cpu(pen):
    """nw_align(..., with_traceback=False) returns the full call's scores and
    no traceback, at a verify chunk's packing (a zero-length padding row)."""
    qs, ts = _random_windows(11)
    entries = [(q, t, 127, (k, False)) for k, (q, t) in enumerate(zip(qs[:6], ts[:6]))]
    Q, T, ql, tl, band, tmax = anchored.pack_verify(entries, np.arange(6))
    args = [torch.from_numpy(a) for a in (Q, T, ql, tl)]
    band = min(band, max(Q.shape[1], T.shape[1]) + 1)
    full, tb = nw_cuda.nw_align(*args, band=band, tmax=tmax, **pen)
    only, none = nw_cuda.nw_align(*args, band=band, tmax=tmax, with_traceback=False, **pen)
    assert tb is not None and none is None
    assert torch.equal(full, only)
    assert (full[:6] >= 0).all() and int(full[6]) == -1


def test_host_library_builds_into_build_dir_and_raises_on_failure(tmp_path, monkeypatch):
    path = native.build()
    assert path.parent.name == "seqrush_tpu_torch" and path.parent.parent.name == "build"
    assert path.name.startswith("libseqrush_native-") and path.exists()
    monkeypatch.setattr(native, "_build_dir", lambda: tmp_path)
    monkeypatch.setattr(native, "_CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build()
    monkeypatch.setattr(native, "_CXX", "g++")
    monkeypatch.setattr(native, "_CXX_FLAGS", native._CXX_FLAGS + ("-DSEQRUSH_NO_SUCH_HEADER", "-include", "no_such_header.h"))
    with pytest.raises(RuntimeError, match="failed to build"):
        native.build()
    assert not list(tmp_path.glob("*.so"))
