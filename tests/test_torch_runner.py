"""seqrush_tpu_torch's WfaAligner (device='cpu': the kernels' plain
versions) against seqrush_tpu's with wide_route='full'.  Every pair's
(query, target, is_reverse, score, CIGAR) must be equal, exactly."""

import numpy as np
import pytest

from seqrush_tpu.align.runner import RunnerConfig as JaxRunnerConfig
from seqrush_tpu.align.runner import WfaAligner as JaxAligner
from seqrush_tpu.scores import AlignmentScores as JaxScores
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.scores import AlignmentScores
from seqrush_tpu_torch.sequences import make_sequence_set

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
SCORES = "0,5,8,2,24,1"


def _nw_corpus():
    """The SNP/deletion corpus of tests/test_nw.py (runner rows-vs-antidiag)."""
    rng = np.random.default_rng(11)
    base = BASES[rng.integers(0, 4, 400)]
    named = [("s0", base.tobytes())]
    for k in range(1, 4):
        v = bytearray(base.tobytes())
        for pos in rng.integers(0, len(v), 8):
            v[pos] = BASES[rng.integers(0, 4)]
        del v[100 + k : 108 + k]
        named.append((f"s{k}", bytes(v)))
    return named


def _inversion_pair():
    """Half of the sequence inverted: the sketch cannot call the
    orientation, so both orientations race at the probe band, and the
    winner's score fails the band certificate and escalates."""
    rng = np.random.default_rng(5)
    base = BASES[rng.integers(0, 4, 900)].tobytes()
    s = bytearray(base)
    s[220:680] = bytes(s[220:680]).translate(COMP)[::-1]
    for pos in rng.integers(0, len(s), 10):
        s[pos] = BASES[rng.integers(0, 4)]
    return [("a", base), ("inv", bytes(s))]


def _keys(results):
    return [
        (r.query_idx, r.target_idx, r.is_reverse, r.score, r.cigar_string) for r in results
    ]


def _both(named, pairs, **cfg):
    ref = JaxAligner(
        jax_seqs(named), JaxRunnerConfig(scores=JaxScores.parse(SCORES), wide_route="full", **cfg)
    ).align_pairs(pairs)
    port = WfaAligner(
        make_sequence_set(named),
        RunnerConfig(scores=AlignmentScores.parse(SCORES), wide_route="full", **cfg),
        device="cpu",
    )
    return _keys(ref), _keys(port.align_pairs(pairs)), port


def test_runner_matches_jax_on_nw_corpus():
    named = _nw_corpus()
    pairs = np.array([(i, j) for i in range(4) for j in range(4) if i != j])
    ref, got, port = _both(named, pairs)
    assert len(got) == 12
    assert got == ref
    assert port.stats["alignments"] == 12


@pytest.mark.parametrize("band_slack", [64, 8])
def test_runner_matches_jax_on_inversion_with_escalation(band_slack):
    named = _inversion_pair()
    pairs = np.array([(0, 1), (1, 0)])
    ref, got, port = _both(named, pairs, band_slack=band_slack)
    assert got == ref
    _rev, undecided, _d = port._orient_and_estimate(pairs)
    assert undecided.all()
    assert port.stats["band_escalations"] > 0
    bands = [d["band"] for d in port.stats["dispatches"]]
    assert bands[0] < bands[-1]


def test_runner_forced_orientation_and_divergence_cap():
    """align_pairs_oriented and max_divergence drops match the JAX runner."""
    named = _nw_corpus()[:3] + [("rnd", BASES[np.random.default_rng(2).integers(0, 4, 390)].tobytes())]
    pairs = np.array([(0, 1), (1, 2), (3, 0), (2, 3)])
    rev = np.array([False, True, False, True])
    ref = JaxAligner(jax_seqs(named), JaxRunnerConfig(scores=JaxScores.parse(SCORES), wide_route="full"))
    port = WfaAligner(
        make_sequence_set(named),
        RunnerConfig(scores=AlignmentScores.parse(SCORES), wide_route="full"),
        device="cpu",
    )
    assert _keys(port.align_pairs_oriented(pairs, rev)) == _keys(ref.align_pairs_oriented(pairs, rev))
    ref_res, got_res, port = _both(named, pairs, max_divergence=0.05)
    assert got_res == ref_res
    assert port.stats["dropped"] == 2


@pytest.mark.parametrize("value", ["off", "auto", "on"])
def test_band_tiling_values(value):
    """band_tiling takes 'off' and 'auto' (tests/test_torch_tiled.py runs it);
    anything else raises, as the port's other options do."""
    cfg = RunnerConfig(band_tiling=value)
    if value == "on":
        with pytest.raises(ValueError, match="band_tiling"):
            WfaAligner(make_sequence_set(_nw_corpus()), cfg, device="cpu")
    else:
        assert WfaAligner(make_sequence_set(_nw_corpus()), cfg, device="cpu").cfg.band_tiling == value
