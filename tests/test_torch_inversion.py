"""The inversion-aware mode of seqrush_tpu_torch (device='cpu') against
seqrush_tpu's, case for case after tests/test_inversion.py: gap detection,
the inversion test, the patch's accept and reject branches, the window
batch's shapes, kernel B's opcodes against the JAX package's host
traceback_pair on that batch, and the pipeline's GFA.  Tolerance 0
throughout."""

import numpy as np
import pytest
import torch

from seqrush_tpu.align.inversion import find_potential_inversion_sites as jax_find_sites
from seqrush_tpu.align.inversion import inversion_patch_alignments as jax_patches
from seqrush_tpu.align.runner import RunnerConfig as JaxRunnerConfig
from seqrush_tpu.align.runner import WfaAligner as JaxWfaAligner
from seqrush_tpu.config import Args as JaxArgs
from seqrush_tpu.ops import nw as jax_nw
from seqrush_tpu.pipeline import SeqRushTPU
from seqrush_tpu.scores import AlignmentScores as JaxScores
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch.align.inversion import (
    Gap,
    find_potential_inversion_sites,
    inversion_jobs,
    inversion_patch_alignments,
    is_potential_inversion,
    pack_inversion_batch,
)
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.config import Args
from seqrush_tpu_torch.ops import nw, nw_cuda
from seqrush_tpu_torch.ops.wfa import Penalties
from seqrush_tpu_torch.pipeline import SeqRushTorch
from seqrush_tpu_torch.scores import AlignmentScores
from seqrush_tpu_torch.sequences import make_sequence_set

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
SCORES = "0,5,8,2,24,1"


def rand_seq(n, seed):
    rng = np.random.default_rng(seed)
    return BASES[rng.integers(0, 4, size=n)].tobytes()


def revcomp(seq: bytes) -> bytes:
    return seq.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]


def _gaps(items, k):
    return [vars(g) for g in find_potential_inversion_sites(items, k)]


def _jax_gaps(items, k):
    return [vars(g) for g in jax_find_sites(items, k)]


def test_find_divergent_gap():
    items = [(25, "="), (30, "X"), (25, "=")]
    gaps = find_potential_inversion_sites(items, 20)
    assert len(gaps) == 1
    g = gaps[0]
    assert g.gap_type == "divergent"
    assert (g.query_start, g.query_end) == (25, 55)
    assert (g.target_start, g.target_end) == (25, 55)
    assert is_potential_inversion(g, 20)
    assert _gaps(items, 20) == _jax_gaps(items, 20)


def test_short_matches_absorbed_into_gap():
    items = [(25, "="), (20, "I"), (5, "="), (1, "X"), (20, "D"), (25, "=")]
    gaps = find_potential_inversion_sites(items, 20)
    assert len(gaps) == 1 and gaps[0].gap_type == "divergent"
    assert is_potential_inversion(gaps[0], 20)
    assert _gaps(items, 20) == _jax_gaps(items, 20)


def test_indel_gap_classification():
    items = [(25, "="), (25, "I"), (25, "=")]
    gaps = find_potential_inversion_sites(items, 20)
    assert len(gaps) == 1 and gaps[0].gap_type == "query_only"
    assert not is_potential_inversion(gaps[0], 20)
    items2 = [(25, "="), (25, "D"), (25, "=")]
    assert find_potential_inversion_sites(items2, 20)[0].gap_type == "target_only"
    for it in (items, items2):
        assert _gaps(it, 20) == _jax_gaps(it, 20)


def test_size_ratio_rule():
    assert not is_potential_inversion(Gap(0, 100, 0, 30, "divergent"), 20)  # ratio > 1.5
    assert is_potential_inversion(Gap(0, 100, 0, 80, "divergent"), 20)
    assert not is_potential_inversion(Gap(0, 0, 0, 80, "divergent"), 20)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gap_detection_equals_jax_on_random_cigars(seed):
    rng = np.random.default_rng(seed)
    ops = np.array(["=", "X", "I", "D", "M"])
    items = [(int(rng.integers(1, 40)), str(ops[rng.integers(0, 5)])) for _ in range(80)]
    for k in (5, 20, 30):
        assert _gaps(items, k) == _jax_gaps(items, k)


def _forward(named):
    """Both packages' aligners and forward results of pair (0, 1)."""
    jal = JaxWfaAligner(jax_seqs(named), JaxRunnerConfig(scores=JaxScores.parse(SCORES)))
    pal = WfaAligner(make_sequence_set(named), RunnerConfig(scores=AlignmentScores.parse(SCORES)),
                     device="cpu")
    pairs = np.array([[0, 1]])
    res_j = jal.align_pairs_oriented(pairs, np.zeros(1, bool))
    res_p = pal.align_pairs_oriented(pairs, np.zeros(1, bool))
    assert [(r.score, r.cigar) for r in res_p] == [(r.score, r.cigar) for r in res_j]
    return jal, pal, res_j, res_p


@pytest.mark.parametrize("branch", ["accept", "reject"])
def test_patch_accept_and_reject_branches(branch):
    """The patch acceptance rule (completed AND inv_score < forward_score //
    2): a true inverted middle is accepted, an equally large random middle
    is rejected; the port's patch unites equal the JAX package's."""
    left, mid, right = rand_seq(150, 11), rand_seq(90, 12), rand_seq(150, 13)
    mid2 = revcomp(mid) if branch == "accept" else rand_seq(90, 14)
    named = [("a", left + mid + right), ("b", left + mid2 + right)]
    jal, pal, res_j, res_p = _forward(named)
    u, v = inversion_patch_alignments(res_p, pal, min_match_length=0)
    ju, jv = jax_patches(res_j, jal, min_match_length=0)
    assert (u == ju).all() and (v == jv).all()
    assert pal.stats["inversion_windows"] >= 1
    if branch == "accept":
        assert u.size > 0 and pal.stats["inversion_patches"] >= 1
        assert ((v & 1) == 1).all() and ((u & 1) == 0).all()
    else:
        assert u.size == 0 and pal.stats["inversion_patches"] == 0


def _inversion_results():
    """Forward results with several candidate windows of different sizes:
    a family of inverted middles, some partly random."""
    left, right = rand_seq(120, 21), rand_seq(120, 22)
    named = [("base", left + rand_seq(100, 23) + right)]
    for k, (n, kind) in enumerate([(100, "inv"), (140, "inv"), (80, "mix"), (117, "inv")]):
        mid = named[0][1][120:220]
        if n != 100:
            mid = rand_seq(n, 30 + k)
        if kind == "inv":
            mid = revcomp(mid)
        else:
            mid = revcomp(mid[: n // 2]) + rand_seq(n - n // 2, 40 + k)
        named.append((f"v{k}", left + mid + right))
    pairs = np.array([[0, j] for j in range(1, len(named))] + [[j, 0] for j in range(1, len(named))])
    jal = JaxWfaAligner(jax_seqs(named), JaxRunnerConfig(scores=JaxScores.parse(SCORES)))
    pal = WfaAligner(make_sequence_set(named), RunnerConfig(scores=AlignmentScores.parse(SCORES)),
                     device="cpu")
    res_j = jal.align_pairs_oriented(pairs, np.zeros(len(pairs), bool))
    res_p = pal.align_pairs_oriented(pairs, np.zeros(len(pairs), bool))
    return jal, pal, res_j, res_p


def test_inversion_batch_shapes_and_patches_equal_jax(monkeypatch):
    """pack_inversion_batch reproduces the JAX batch (captured from its
    nw_align_device call): unrounded Q/T widths, B, band and tmax; and the
    patch unites are equal."""
    jal, pal, res_j, res_p = _inversion_results()
    seen = []
    real = jax_nw.nw_align_device

    def spy(Q, T, qlens, tlens, **kw):
        seen.append((np.asarray(Q).copy(), np.asarray(T).copy(), np.asarray(qlens).copy(),
                     np.asarray(tlens).copy(), kw["band"], kw["tmax"]))
        return real(Q, T, qlens, tlens, **kw)

    monkeypatch.setattr(jax_nw, "nw_align_device", spy)
    ju, jv = jax_patches(res_j, jal, min_match_length=0)
    monkeypatch.undo()
    u, v = inversion_patch_alignments(res_p, pal, min_match_length=0)
    assert (u == ju).all() and (v == jv).all() and u.size
    jobs = inversion_jobs(res_p, pal, 0)
    assert len(seen) == 1 and len(jobs) >= 5
    mine = pack_inversion_batch(jobs)
    for a, b in zip(mine[:4], seen[0][:4]):
        assert a.shape == b.shape and (a == b).all()
    assert mine[4:] == seen[0][4:]
    Q = mine[0]
    assert Q.shape[1] == max(j[2].size for j in jobs) + 1  # not rounded
    (d,) = [d for d in pal.stats["dispatches"] if d["kind"] == "inversion"]
    assert (d["B"], d["band"], d["tmax"], d["Lq"]) == (Q.shape[0], mine[4], mine[5], Q.shape[1])
    assert d["emit"] == "ops"  # the JAX package walks this batch on the host, per step
    assert 0 < pal.stats["inversion_patches"] <= pal.stats["inversion_windows"] == len(jobs)


def test_walk_opcodes_equal_jax_traceback_pair():
    """On the inversion batch, kernel B's opcodes (plain version), decoded
    with decode_opcodes + resolve_matches and with decode_batch, equal the
    JAX package's host traceback_pair on the JAX sweep's traceback; kernel
    A's scores equal the JAX scores."""
    _jal, pal, _res_j, res_p = _inversion_results()
    jobs = inversion_jobs(res_p, pal, 0)
    Q, T, ql, tl, band, tmax = pack_inversion_batch(jobs)
    pen = Penalties.from_scores(pal.cfg.scores).kernel_kwargs()
    Qd, Td, qd, td = (torch.from_numpy(a) for a in (Q, T, ql, tl))
    scores, tb = nw_cuda.nw_align(Qd, Td, qd, td, band=band, tmax=tmax, **pen)
    ops = nw_cuda.nw_walk(tb, qd, td, band=band, tmax=tmax).numpy()
    j_scores, j_tb = jax_nw.nw_align_device(Q, T, ql, tl, band=band, tmax=tmax, with_traceback=True,
                                            **pen)
    j_tb = np.asarray(j_tb)
    assert (scores.numpy() == np.asarray(j_scores)).all()
    batch = nw.decode_batch(ops[: len(jobs)], [j[2] for j in jobs], [j[3] for j in jobs])
    for b, (_res, _gap, qw, rc_tw) in enumerate(jobs):
        ref = jax_nw.resolve_matches(jax_nw.traceback_pair(j_tb[b], int(ql[b]), int(tl[b]), band),
                                     qw, rc_tw)
        assert nw.resolve_matches(nw.decode_opcodes(ops[b]), qw, rc_tw) == ref
        assert batch[b] == ref


def _pipeline(named, tmp_path, **kw):
    jo, po = tmp_path / "jax.gfa", tmp_path / "port.gfa"
    jsr = SeqRushTPU(jax_seqs(named), JaxArgs(no_sort=True, output=str(jo), **kw))
    jsr.align_and_unite()
    jsr.write_gfa()
    psr = SeqRushTorch(make_sequence_set(named), Args(no_sort=True, output=str(po), device="cpu", **kw))
    psr.align_and_unite()
    g = psr.write_gfa()
    assert psr.validate_paths_match_sequences(g) == []
    assert po.read_bytes() == jo.read_bytes()
    return g, psr


def test_full_fwd_rev_pass_unites_whole_rc_pair(tmp_path):
    """Every pair also aligns fully reverse-complemented: a pair that is a
    complete reverse complement unites under --inversion-aware."""
    s1 = rand_seq(300, 15)
    g, sr = _pipeline([("f", s1), ("r", revcomp(s1))], tmp_path, no_compact=True,
                      inversion_aware=True, min_match_length=10)
    assert g.node_count() <= 320
    assert (g.paths[1].steps & 1).sum() >= 250
    assert sr.stats["aligner"]["alignments"] == 4


def test_inversion_aware_pipeline_shares_middle(tmp_path):
    """Middle-inverted pair: inversion-aware mode unites the inverted middle
    (reverse-orientation steps), plain mode leaves it separate; each GFA is
    the JAX package's."""
    left, mid, right = rand_seq(150, 1), rand_seq(90, 2), rand_seq(150, 3)
    named = [("plain", left + mid + right), ("inverted", left + revcomp(mid) + right)]
    g_plain, _sr = _pipeline(named, tmp_path, no_compact=True, inversion_aware=False)
    g_inv, sr = _pipeline(named, tmp_path, no_compact=True, inversion_aware=True)
    # the inverted middle collapses: ~90 fewer nodes
    assert g_inv.node_count() <= g_plain.node_count() - 60
    assert (g_inv.paths[1].steps & 1).sum() >= 60
    assert sr.stats["aligner"]["inversion_patches"] >= 1
    assert "inversion_patch" in sr.timer.phases


def test_inversion_window_batch_runs_kernels_a_and_b_once(monkeypatch):
    """The window batch goes through nw_cuda.nw_align (with traceback) and
    nw_cuda.nw_walk once each, and nothing else aligns it."""
    _jal, pal, _res_j, res_p = _inversion_results()
    calls = []
    real_align, real_walk = nw_cuda.nw_align, nw_cuda.nw_walk

    def align(*a, **kw):
        calls.append(("align", kw.get("with_traceback", True)))
        return real_align(*a, **kw)

    def walk(*a, **kw):
        calls.append(("walk",))
        return real_walk(*a, **kw)

    monkeypatch.setattr(nw_cuda, "nw_align", align)
    monkeypatch.setattr(nw_cuda, "nw_walk", walk)
    inversion_patch_alignments(res_p, pal, 0)
    assert calls == [("align", True), ("walk",)]
