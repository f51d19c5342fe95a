"""The sweepga backend of seqrush_tpu_torch (device='cpu') against
seqrush_tpu's, case for case after tests/test_sweep.py: minimizers, anchors,
chaining (one and several chains, increasing or not), the 1:1 filter, the
frequency cutoff, the gap fill on the host and on the device path, the C++
record stitch against the Python one, the orientation probe, and the
pipeline's GFA.  Tolerance 0 throughout: records, scores, CIGARs and starts
must be equal."""

import numpy as np
import pytest

import chip_smoke
import seqrush_tpu.align.sweep as jax_sweep_mod
import seqrush_tpu_torch.align.sweep as sweep_mod
from seqrush_tpu import native as jax_native
from seqrush_tpu.align.base import create_aligner as jax_create_aligner
from seqrush_tpu.align.pairs import all_ordered_pairs
from seqrush_tpu.align.runner import RunnerConfig as JaxRunnerConfig
from seqrush_tpu.align.runner import WfaAligner as JaxWfaAligner
from seqrush_tpu.align.sweep import SweepAligner as JaxSweepAligner
from seqrush_tpu.config import Args as JaxArgs
from seqrush_tpu.ops import anchors as jax_anchors
from seqrush_tpu.ops.wfa import Penalties as JaxPenalties
from seqrush_tpu.pipeline import SeqRushTPU
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch import native
from seqrush_tpu_torch.align.base import AllwaveBackend, create_aligner, runner_class
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.align.sweep import SweepAligner, _Mapping, filter_one_to_one, pack_gap_chunk
from seqrush_tpu_torch.config import Args
from seqrush_tpu_torch.ops import anchors
from seqrush_tpu_torch.ops.wfa import Penalties, affine2p_score_dp
from seqrush_tpu_torch.pipeline import SeqRushTorch
from seqrush_tpu_torch.pos import encode_bases
from seqrush_tpu_torch.scores import AlignmentScores
from seqrush_tpu_torch.sequences import make_sequence_set

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def rand_seq(n, seed):
    rng = np.random.default_rng(seed)
    return BASES[rng.integers(0, 4, size=n)].tobytes()


def _records(res):
    return [(r.query_idx, r.target_idx, r.is_reverse, r.score, r.query_start, r.target_start, r.cigar)
            for r in res]


def _both(named, pairs=None, **cfg):
    """The JAX and the port SweepAligner's records of ``pairs`` (default all
    ordered pairs), with equal RunnerConfig values."""
    pairs = all_ordered_pairs(len(named)) if pairs is None else pairs
    jal = JaxSweepAligner(jax_seqs(named), JaxRunnerConfig(**cfg))
    pal = SweepAligner(make_sequence_set(named), RunnerConfig(**cfg), device="cpu")
    return _records(jal.align_pairs(pairs)), _records(pal.align_pairs(pairs)), jal, pal


def _gfas(named, tmp_path, **kw):
    """--no-sort GFA bytes of the JAX package and of the port."""
    jo, po = tmp_path / "jax.gfa", tmp_path / "port.gfa"
    jsr = SeqRushTPU(jax_seqs(named), JaxArgs(no_sort=True, output=str(jo), **kw))
    jsr.align_and_unite()
    jsr.write_gfa()
    psr = SeqRushTorch(make_sequence_set(named), Args(no_sort=True, output=str(po), device="cpu", **kw))
    psr.align_and_unite()
    g = psr.write_gfa()
    assert psr.validate_paths_match_sequences(g) == []
    return jo.read_bytes(), po.read_bytes(), psr, g


def test_packed_kmers_exact():
    codes = encode_bases(b"ACGTACGT")
    pos, vals = anchors.packed_kmers(codes, 4)
    assert pos.size == 5
    # ACGT packs to 0b00011011 = 27
    assert vals[0] == 0b00011011
    assert vals[4] == vals[0]  # periodic sequence
    jpos, jvals = jax_anchors.packed_kmers(codes, 4)
    assert (pos == jpos).all() and (vals == jvals).all()


def test_kmers_skip_n():
    codes = encode_bases(b"ACGTNACGT")
    pos, _vals = anchors.packed_kmers(codes, 4)
    # windows containing N (positions 1-4) are dropped
    assert 1 not in pos and 4 not in pos
    assert 0 in pos and 5 in pos
    assert (pos == jax_anchors.packed_kmers(codes, 4)[0]).all()


def test_minimizers_cover():
    codes = encode_bases(rand_seq(500, 0))
    pos, vals = anchors.minimizers(codes, 15, 10)
    assert pos.size >= 500 / 10 * 0.5  # roughly 2/(w+1) density
    assert np.diff(pos).max() <= 10 + 15  # windows guarantee coverage
    jpos, jvals = jax_anchors.minimizers(codes, 15, 10)
    assert (pos == jpos).all() and (vals == jvals).all()


def test_anchor_matches_identical():
    codes = encode_bases(rand_seq(300, 1))
    a = anchors.anchor_matches(codes, codes)
    assert a.shape[0] > 0
    assert (a[:, 0] == a[:, 1]).all()  # identical -> diagonal anchors
    assert (a == jax_anchors.anchor_matches(codes, codes)).all()


def test_chain_and_runs():
    codes = encode_bases(rand_seq(300, 2))
    a = anchors.anchor_matches(codes, codes)
    chain = anchors.chain_anchors(a)
    runs = anchors.chain_to_runs(chain, 15)
    # identical sequences should coalesce into few long runs
    assert sum(n for _, _, n in runs) >= 250
    assert (chain == jax_anchors.chain_anchors(a)).all()
    assert runs == jax_anchors.chain_to_runs(chain, 15)


def test_sweep_aligner_records():
    base = rand_seq(800, 3)
    alt = bytearray(base)
    for pos in np.random.default_rng(4).integers(0, len(alt), size=8):
        alt[pos] = BASES[np.random.default_rng(int(pos)).integers(0, 4)]
    del alt[400:420]
    named = [("a", base), ("b", bytes(alt))]
    ref, got, _jal, pal = _both(named)
    assert got == ref and len(got) == 2
    seqs = pal.seqs
    for qi, ti, _rev, _s, q0, t0, cigar in got:
        q, t = seqs[qi].data, seqs[ti].data
        for n, op in cigar:
            if op == "=":
                assert (q[q0 : q0 + n] == t[t0 : t0 + n]).all()
            q0 += n if op in "=XI" else 0
            t0 += n if op in "=XD" else 0
        assert q0 <= len(q) and t0 <= len(t)


def test_sweepga_pipeline_validates(tmp_path):
    base = rand_seq(600, 5)
    alt = bytearray(base)
    alt[100] = BASES[(alt[100] + 1) % 4]
    del alt[300:310]
    ref, got, _sr, g = _gfas([("a", base), ("b", bytes(alt))], tmp_path, aligner="sweepga")
    assert got == ref
    # most of the sequence united despite seed-and-extend sparsity
    assert g.node_count() < 1.2 * 600


def test_overlapping_anchor_runs_trimmed():
    """Different-diagonal anchor overlaps are trimmed so runs never overlap
    on either sequence."""
    chain = np.array([[10, 10], [20, 40], [25, 60]], dtype=np.int64)
    runs = anchors.chain_to_runs(chain, 15)
    for (q0, t0, n0), (q1, t1, _n1) in zip(runs[:-1], runs[1:]):
        assert q1 >= q0 + n0 and t1 >= t0 + n0
    assert all(n > 0 for _, _, n in runs)
    assert runs == jax_anchors.chain_to_runs(chain, 15)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_to_runs_non_increasing_chain_takes_the_spec(seed):
    """A chain that does not increase on both axes (duplicated or
    backward-stepping anchors) goes to chain_to_runs_spec, as in the JAX
    package; a strictly increasing one gives the spec's runs too."""
    rng = np.random.default_rng(seed)
    q = np.sort(rng.integers(0, 400, size=40))
    t = q + rng.integers(-6, 7, size=40)
    chain = np.stack([q, np.maximum(t, 0)], axis=1).astype(np.int64)
    assert not ((np.diff(chain[:, 0]) > 0).all() and (np.diff(chain[:, 1]) > 0).all())
    runs = anchors.chain_to_runs(chain, 15)
    assert runs == anchors.chain_to_runs_spec(chain, 15)
    assert runs == jax_anchors.chain_to_runs(chain, 15) == jax_anchors.chain_to_runs_spec(chain, 15)
    inc = anchors._keep_increasing(chain)
    assert (inc == jax_anchors._keep_increasing(chain)).all()
    assert anchors.chain_to_runs(inc, 15) == anchors.chain_to_runs_spec(inc, 15)


def test_filter_one_to_one_semantics():
    """min_block_length drops short records; the query-axis sweep keeps only
    the best-scoring mapping where two records shadow the same query span;
    different query sequences do not compete."""
    short = _Mapping(0, 0, 1, False, [(0, 0, 40)], qlen=500)
    assert filter_one_to_one([short]) == []
    better = _Mapping(0, 0, 1, False, [(0, 0, 200)], qlen=500)
    worse = _Mapping(0, 0, 1, False, [(0, 300, 80), (120, 420, 80)], qlen=500)
    assert filter_one_to_one([worse, better]) == [better]
    other_q = _Mapping(1, 2, 1, False, [(0, 600, 200)], qlen=500)
    assert len(filter_one_to_one([better, other_q])) == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_one_to_one_equals_jax_on_random_mappings(seed):
    """Seeded mappings over three sequence pairs, forward and reverse, with
    overlapping spans: the port keeps the same records in the same order."""
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(60):
        qi, tj = (int(x) for x in rng.integers(0, 3, size=2))
        n = int(rng.integers(1, 5))
        q0, t0 = int(rng.integers(0, 400)), int(rng.integers(0, 400))
        runs = []
        for _k in range(n):
            ln = int(rng.integers(20, 120))
            runs.append((q0, t0, ln))
            q0 += ln + int(rng.integers(0, 30))
            t0 += ln + int(rng.integers(0, 30))
        specs.append((int(rng.integers(0, 9)), qi, tj, bool(rng.random() < 0.3), runs, 1500))
    port = filter_one_to_one([_Mapping(*s) for s in specs])
    ref = jax_sweep_mod.filter_one_to_one([jax_sweep_mod._Mapping(*s) for s in specs])
    assert [(m.pair_idx, m.qi, m.tj, m.is_rev, m.runs.tolist()) for m in port] == [
        (m.pair_idx, m.qi, m.tj, m.is_rev, m.runs.tolist()) for m in ref]
    assert 0 < len(port) < len(specs)


def test_one_to_one_filter_changes_graph(tmp_path, monkeypatch):
    """A query block matching two target copies gives two chains; the 1:1
    filter keeps one.  Both packages, filtered and not."""
    R = rand_seq(200, 60)
    spacer = rand_seq(150, 61)
    q = rand_seq(120, 62) + R + rand_seq(120, 63)
    t = spacer + R + spacer + R + spacer  # two identical copies of R
    named = [("q", q), ("t", t)]
    pairs = np.array([[0, 1]])
    ref, got, _j, _p = _both(named, pairs)
    assert got == ref and len(got) == 1
    with monkeypatch.context() as m:
        m.setattr(sweep_mod, "filter_one_to_one",
                  lambda ms: [x for x in ms if x.block_len >= sweep_mod.MIN_BLOCK_LENGTH])
        m.setattr(jax_sweep_mod, "filter_one_to_one",
                  lambda ms: [x for x in ms if x.block_len >= jax_sweep_mod.MIN_BLOCK_LENGTH])
        ref_u, got_u, _j, _p = _both(named, pairs)
    assert got_u == ref_u and len(got_u) >= 2
    ref_g, got_g, _sr, _g = _gfas(named, tmp_path, aligner="sweepga")
    assert got_g == ref_g


def test_frequency_threshold_prunes_repeat_seeds(tmp_path):
    """The seed-frequency cutoff shrinks the anchor list on a repeat-rich
    pair, and Args.frequency reaches the backend through RunnerConfig."""
    unit = rand_seq(80, 70)
    q = unit + rand_seq(100, 71)
    t = unit * 6  # every unit k-mer occurs 6x in the target index
    qc, tc = encode_bases(q), encode_bases(t)
    a_all = anchors.anchor_matches(qc, tc, 15, 10)
    a_cut = anchors.anchor_matches(qc, tc, 15, 10, max_freq=2)
    assert a_cut.shape[0] < a_all.shape[0]
    assert (a_cut == jax_anchors.anchor_matches(qc, tc, 15, 10, max_freq=2)).all()
    named = [("a", q + t), ("b", t + q)]
    ref, got, _sr, _g = _gfas(named, tmp_path, aligner="sweepga", frequency=3)
    assert got == ref
    ref_r, got_r, _j, pal = _both(named, frequency=3)
    assert got_r == ref_r
    assert pal.cfg.frequency == 3


def test_multi_chain_covers_rearrangement():
    """A translocated block breaks colinearity: several chains cover both
    blocks.  The C++ chain_pairs at 16 chains equals chain_anchors_multi +
    chain_to_runs, in both packages."""
    A = rand_seq(300, 80)
    B = rand_seq(300, 81)
    spacer = rand_seq(40, 82)
    named = [("q", A + spacer + B), ("t", B + spacer + A)]
    ref, got, _j, pal = _both(named, np.array([[0, 1]]))
    assert got == ref and len(got) >= 2
    assert sum(sum(n for n, op in r[6] if op == "=") for r in got) >= 400
    a = anchors.anchor_matches(pal.codes[0], pal.codes[1])
    chains = anchors.chain_anchors_multi(a, 15)
    jchains = jax_anchors.chain_anchors_multi(a, 15)
    assert len(chains) == len(jchains) >= 2
    assert all((c == jc).all() for c, jc in zip(chains, jchains))
    flat = a[np.lexsort((a[:, 1], a[:, 0]))]
    cp, co, rq, rt, rl = native.chain_pairs_native(
        flat[:, 0], flat[:, 1], np.array([0, a.shape[0]]), 15, max_gap=anchors.DEFAULT_MAX_GAP,
        max_skew=anchors.DEFAULT_MAX_SKEW, max_chains=16, min_matched=50)
    runs = [list(zip(rq[co[c] : co[c + 1]].tolist(), rt[co[c] : co[c + 1]].tolist(),
                     rl[co[c] : co[c + 1]].tolist())) for c in range(len(cp))]
    assert runs == [anchors.chain_to_runs(c, 15) for c in chains]


def _indel_pair(seed, n=700, n_snp=10, cut=(300, 330)):
    base = rand_seq(n, seed)
    alt = bytearray(base)
    for pos in np.random.default_rng(seed + 1).integers(0, len(alt), size=n_snp):
        alt[pos] = BASES[np.random.default_rng(int(pos)).integers(0, 4)]
    del alt[cut[0] : cut[1]]
    return [("a", base), ("b", bytes(alt))]


@pytest.mark.parametrize("emit", ["auto", "ops"])
def test_gap_fill_device_path_matches_jax(emit):
    """With wide_host_window_cells=0 every gap window takes the device path
    (kernel A, kernel B, the run-token or opcode decode): the port's records
    equal the JAX package's under the same setting and emission, and equal
    the host-DP records in score."""
    named = _indel_pair(90)
    jal = JaxSweepAligner(jax_seqs(named), JaxRunnerConfig(emit=emit, wide_host_window_cells=0))
    pal = SweepAligner(make_sequence_set(named), RunnerConfig(emit=emit, wide_host_window_cells=0),
                       device="cpu")
    pairs = all_ordered_pairs(2)
    got, ref = _records(pal.align_pairs(pairs)), _records(jal.align_pairs(pairs))
    assert got == ref
    gaps = [d for d in pal.stats["dispatches"] if d["kind"] == "gap"]
    assert gaps and pal.stats["host_windows"] == 0
    assert sum(len(d["jobs"]) for d in gaps) >= 2
    host, _h, _hp, _ = _both(named)
    assert [r[3] for r in got] == [r[3] for r in host]


def test_gap_chunk_shapes_equal_jax(monkeypatch):
    """pack_gap_chunk reproduces the JAX gap chunk's padding, band and tmax
    (captured from the JAX package's opcode dispatch)."""
    named = _indel_pair(91, n=900, n_snp=14, cut=(200, 260))
    seen = []
    real = jax_sweep_mod.nw.nw_align_with_opcodes

    def spy(Q, T, qlens, tlens, **kw):
        seen.append((np.asarray(Q).copy(), np.asarray(T).copy(), np.asarray(qlens).copy(),
                     np.asarray(tlens).copy(), kw["band"], kw["tmax"]))
        return real(Q, T, qlens, tlens, **kw)

    monkeypatch.setattr(jax_sweep_mod.nw, "nw_align_with_opcodes", spy)
    JaxSweepAligner(jax_seqs(named), JaxRunnerConfig(emit="ops", wide_host_window_cells=0)
                    ).align_pairs(all_ordered_pairs(2))
    monkeypatch.undo()
    pal = SweepAligner(make_sequence_set(named), RunnerConfig(wide_host_window_cells=0), device="cpu")
    pal.align_pairs(all_ordered_pairs(2))
    gaps = [d for d in pal.stats["dispatches"] if d["kind"] == "gap"]
    assert len(gaps) == len(seen) == 1
    jobs = []
    for p, rc, q0, t0, nq, nt in gaps[0]["jobs"]:
        qi, tj = all_ordered_pairs(2)[p]
        q = pal.rc_codes[qi] if rc else pal.codes[qi]
        jobs.append((0, 0, q[q0 : q0 + nq], pal.codes[tj][t0 : t0 + nt]))
    mine = pack_gap_chunk(jobs)
    for a, b in zip(mine[:4], seen[0][:4]):
        assert a.shape == b.shape and (a == b).all()
    assert mine[4:] == seen[0][4:] == (gaps[0]["band"], gaps[0]["tmax"])


def test_sweep_repeat_heavy_sequences_validate(tmp_path):
    """Repeat-rich sequences (different-diagonal anchor overlaps) still give
    the JAX package's graph."""
    unit = rand_seq(60, 50)
    named = [("a", unit * 5), ("b", (unit * 2) + rand_seq(30, 51) + (unit * 3))]
    ref, got, _sr, _g = _gfas(named, tmp_path, aligner="sweepga")
    assert got == ref


def _fuzz_family(rng):
    L = int(rng.integers(400, 1600))
    base = rand_seq(L, int(rng.integers(1 << 30)))
    named = [("s0", base)]
    for k in range(1, int(rng.integers(3, 6))):
        s = bytearray(base)
        for pos in rng.integers(0, len(s), size=int(rng.uniform(0.005, 0.04) * len(s))):
            s[pos] = BASES[rng.integers(0, 4)]
        for _ in range(int(rng.integers(0, 4))):
            pos = int(rng.integers(0, max(len(s) - 80, 1)))
            ln = int(rng.integers(1, 60))
            if rng.random() < 0.5:
                del s[pos : pos + ln]
            else:
                s[pos:pos] = BASES[rng.integers(0, 4, size=ln)].tobytes()
        if rng.random() < 0.3:
            a, b = len(s) // 3, 2 * len(s) // 3
            s[a:b] = bytes(s[a:b]).translate(COMP)[::-1]
        named.append((f"s{k}", bytes(s)))
    return named


@pytest.mark.parametrize("trial", range(6))
def test_native_stitch_bit_equality_fuzz(trial):
    """The C++ stitch equals the Python stitch across randomized divergence
    (SNPs, indels, inversions): same records, scores, CIGARs, starts; and
    both equal the JAX package's records (the families of
    tests/test_sweep.py's fuzz, trial by trial)."""
    rng = np.random.default_rng(99)
    for _ in range(trial + 1):
        named = _fuzz_family(rng)
    seqs = make_sequence_set(named)
    pairs = all_ordered_pairs(len(seqs))
    res_n = _records(SweepAligner(seqs, RunnerConfig(), device="cpu").align_pairs(pairs))
    al_p = SweepAligner(seqs, RunnerConfig(), device="cpu")
    al_p.force_python_stitch = True
    res_p = _records(al_p.align_pairs(pairs))
    assert res_n == res_p
    assert res_n == _records(JaxSweepAligner(jax_seqs(named), JaxRunnerConfig()).align_pairs(pairs))


def test_stitch_records_native_equals_jax_library():
    """native.stitch_records_native against the JAX package's C++ on seeded
    flat runs and gap tables (ops 0..3, gaps present and absent)."""
    rng = np.random.default_rng(5)
    R = 12
    lens = rng.integers(1, 6, size=R)
    rec_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    n = int(rec_off[-1])
    runs_len = rng.integers(1, 40, size=n).astype(np.int64)
    runs_q = np.cumsum(runs_len + rng.integers(0, 9, size=n)).astype(np.int64)
    runs_t = np.cumsum(runs_len + rng.integers(0, 9, size=n)).astype(np.int64)
    gap_ids = np.sort(rng.choice(n, size=n // 2, replace=False)).astype(np.int64)
    counts = rng.integers(1, 5, size=gap_ids.size)
    gap_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    gap_ops = rng.integers(0, 4, size=int(gap_off[-1])).astype(np.uint8)
    gap_lens = rng.integers(1, 9, size=int(gap_off[-1])).astype(np.int32)
    for pen in (Penalties(5, 8, 2, 24, 1), Penalties(4, 6, 2)):
        args = (runs_q, runs_t, runs_len, rec_off, gap_ops, gap_lens, gap_off, gap_ids)
        got = native.stitch_records_native(*args, pen.kernel_kwargs())
        ref = jax_native.stitch_records_native(*args, JaxPenalties(pen.mismatch, pen.gap1_open,
                                                                   pen.gap1_extend, pen.gap2_open,
                                                                   pen.gap2_extend))
        assert all((a == b).all() for a, b in zip(got, ref))
        assert got[2][-1] == got[0].size and got[3].size == R


def test_window_dp_flat_equals_lists():
    """window_dp_native's flat output holds the same items as its lists."""
    rng = np.random.default_rng(8)
    qs = [rng.integers(0, 4, int(rng.integers(0, 40))).astype(np.uint8) for _ in range(20)]
    ts = [rng.integers(0, 4, int(rng.integers(0, 40))).astype(np.uint8) for _ in range(20)]
    pen = Penalties(5, 8, 2, 24, 1).kernel_kwargs()
    scores, items = native.window_dp_native(qs, ts, pen, threads=2)
    s2, ops, lens, counts, offs = native.window_dp_native(qs, ts, pen, threads=2, flat=True)
    assert (scores == s2).all()
    chars = "=XID"
    for w, it in enumerate(items):
        lo = int(offs[w])
        assert it == [(int(lens[lo + k]), chars[ops[lo + k]]) for k in range(int(counts[w]))]
    empty = native.window_dp_native([], [], pen, flat=True)
    assert [a.size for a in empty] == [0, 0, 0, 0, 1]


def test_penalties_one_conversion():
    """Penalties.kernel_kwargs is the runner's penalty dict; the exact DP
    oracle agrees with the host window DP."""
    for s in ("0,5,8,2,24,1", "0,4,6,2"):
        sc = AlignmentScores.parse(s)
        al = WfaAligner(make_sequence_set([("a", b"ACGT")]), RunnerConfig(scores=sc), device="cpu")
        assert Penalties.from_scores(sc).kernel_kwargs() == al._penalties()
    rng = np.random.default_rng(3)
    pen = Penalties(5, 8, 2, 24, 1)
    qs = [rng.integers(0, 4, 30).astype(np.uint8) for _ in range(4)]
    ts = [np.delete(q, [3, 4, 5]) for q in qs]
    scores, _ = native.window_dp_native(qs, ts, pen.kernel_kwargs(), threads=1)
    assert scores.tolist() == [affine2p_score_dp(q, t, pen) for q, t in zip(qs, ts)]


def test_choose_orientations_on_the_ambiguous_trio():
    """chip_smoke's probe trio: the sketch leaves every pair undecided, the
    score-only probe (one-piece orientation scores, band 127) decides, and
    the port's answer is the JAX package's, which chip_smoke holds as
    PROBE_ORIENTATIONS."""
    named = chip_smoke.probe_trio()
    pairs = np.array(chip_smoke.PROBE_PAIRS)
    pal = WfaAligner(make_sequence_set(named), RunnerConfig(), device="cpu")
    _rev, undecided, _d = pal._orient_and_estimate(pairs)
    assert undecided.all()
    got = pal.choose_orientations(pairs)
    ref = JaxWfaAligner(jax_seqs(named), JaxRunnerConfig()).choose_orientations(pairs)
    assert got.tolist() == ref.tolist() == chip_smoke.PROBE_ORIENTATIONS
    probes = [d for d in pal.stats["dispatches"] if d["kind"] == "probe"]
    assert [(d["B"], d["band"], d["tmax"]) for d in probes] == [(8, 127, 1536)]


def test_backend_table_and_factory():
    assert runner_class("allwave") is WfaAligner
    assert runner_class("sweepga") is SweepAligner
    with pytest.raises(ValueError, match="Unknown aligner"):
        runner_class("minimap2")
    named = _indel_pair(92, n=500, n_snp=5, cut=(100, 104))
    for backend in ("allwave", "sweepga"):
        got = create_aligner(backend, RunnerConfig(), device="cpu").align_sequences(make_sequence_set(named))
        ref = jax_create_aligner(backend, JaxRunnerConfig()).align_sequences(jax_seqs(named))
        assert got == [type(got[0])(**vars(r)) for r in ref] and len(got) == 2
    assert AllwaveBackend().device == "cuda"
