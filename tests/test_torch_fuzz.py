"""The port's fuzzer (seqrush_tpu_torch/tools/fuzz.py) against seqrush_tpu's:
trial t draws the same family and the same mode options in both packages,
and two trials pass on the CPU (the plain versions of the kernels)."""

import numpy as np
import pytest

import seqrush_tpu.pipeline as jax_pipeline
from seqrush_tpu.tools import fuzz as jax_fuzz
from seqrush_tpu_torch.tools import fuzz


class _Captured(Exception):
    pass


@pytest.mark.parametrize("trial", [1, 5, 18])
def test_trial_draws_equal_jax(trial, monkeypatch, tmp_path):
    """The family and options of trial t (18 is a wide, inversion-aware,
    --wide-verify trial) equal what the JAX fuzzer hands its pipeline."""
    seen = {}

    class Recorder:
        def __init__(self, seqs, args):
            seen["named"] = [(s.id, bytes(s.data)) for s in seqs.sequences]
            seen["args"] = args
            raise _Captured

    monkeypatch.setattr(jax_pipeline, "SeqRushTPU", Recorder)
    with pytest.raises(_Captured):
        jax_fuzz.one_trial(trial, str(tmp_path))
    fam, opts = fuzz.trial_case(trial)
    assert fam == seen["named"]
    for k, v in opts.items():
        assert getattr(seen["args"], k) == v
    assert np.array_equal(np.frombuffer(fam[0][1], np.uint8),
                          np.frombuffer(seen["named"][0][1], np.uint8))


def test_two_trials_pass_on_cpu(capsys):
    assert fuzz.main(["--device", "cpu", "--trials", "2"]) == 0
    assert "fuzz: 2 trials, 0 failures" in capsys.readouterr().out
