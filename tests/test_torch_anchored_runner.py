"""seqrush_tpu_torch's anchored wide route (the default wide_route, on
device='cpu': the kernels' plain versions and the host library) against
seqrush_tpu's on the CPU, where its anchored route is active too.

Every pair's (query, target, is_reverse, score, CIGAR) and the route's
counters must equal the JAX package's, exactly; on the family of
tests/test_anchored_wide.py every score must also equal the port's own
full-route score, and the default pipeline's --no-sort GFA must be
byte-identical to the JAX package's."""

import re

import numpy as np
import pytest

from seqrush_tpu.align.runner import RunnerConfig as JaxRunnerConfig
from seqrush_tpu.align.runner import WfaAligner as JaxAligner
from seqrush_tpu.config import Args as JaxArgs
from seqrush_tpu.pipeline import SeqRushTPU
from seqrush_tpu.scores import AlignmentScores as JaxScores
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch.align import anchored
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.config import Args
from seqrush_tpu_torch.graph.bigraph import parse_gfa
from seqrush_tpu_torch.pipeline import SeqRushTorch
from seqrush_tpu_torch.scores import AlignmentScores
from seqrush_tpu_torch.sequences import make_sequence_set
from seqrush_tpu_torch.tools.isomorphic import isomorphic
from test_anchored_wide import synth_family

SCORES = "0,5,8,2,24,1"
BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
COUNTERS = ("anchored_pairs", "anchored_windows", "host_windows", "anchored_fallbacks",
            "wide_verified")


def _keys(results):
    return [(r.query_idx, r.target_idx, r.is_reverse, r.score, r.cigar_string) for r in results]


def _run(named, pairs, **cfg):
    """Both runners under one RunnerConfig: (JAX keys, JAX stats, port keys,
    port stats)."""
    jax_al = JaxAligner(jax_seqs(named), JaxRunnerConfig(scores=JaxScores.parse(SCORES), **cfg))
    ref = _keys(jax_al.align_pairs(pairs))
    port = WfaAligner(make_sequence_set(named),
                      RunnerConfig(scores=AlignmentScores.parse(SCORES), **cfg), device="cpu")
    got = _keys(port.align_pairs(pairs))
    return ref, jax_al.stats, got, port.stats


def _family_pairs(n):
    """The inversion carrier (the last haplotype) against every other
    haplotype, both ways (the wide pairs), and one narrow control pair."""
    return np.array([[i, n - 1] for i in range(n - 1)] + [[n - 1, j] for j in range(n - 1)] + [[0, 1]])


@pytest.fixture(scope="module")
def family():
    named = synth_family()
    pairs = _family_pairs(len(named))
    ref, jax_stats, got, port_stats = _run(named, pairs)
    return named, pairs, ref, jax_stats, got, port_stats


def _wide(family):
    """The family's wide pairs alone (the control pair left out, to keep the
    CPU runs short) and their fixture keys."""
    named, pairs, ref, *_ = family
    return named, pairs[:-1], ref[:-1]


def _inversion_2100():
    """A 2,100 bp pair with an 850 bp inverted block: wide enough after the
    orientation probe escalates it to take the anchored route."""
    rng = np.random.default_rng(3)
    base = BASES[rng.integers(0, 4, 2100)].tobytes()
    s = bytearray(base)
    s[600:1450] = bytes(s[600:1450]).translate(COMP)[::-1]
    return [("a", base), ("b", bytes(s))], np.array([(0, 1)])


def _rc_carrier():
    """The carrier fully reverse-complemented: its best orientation is RC and
    it still holds an inverted block (the rc=True route)."""
    fam = synth_family(n_seqs=3, length=2304, seed=23)
    fam[2] = ("h2rc", fam[2][1].translate(COMP)[::-1])
    return fam, np.array([[0, 2], [2, 1]])


def _chainless():
    """Unrelated random sequences: no usable chain, so the route falls back
    to the full wide route."""
    rng = np.random.default_rng(5)
    return [(f"r{k}", BASES[rng.integers(0, 4, 2048)].tobytes()) for k in range(2)], np.array([[0, 1]])


def _short():
    """Pairs under wide_min_len keep the direct wide-band semantics."""
    rng = np.random.default_rng(11)
    base = BASES[rng.integers(0, 4, 400)]
    nw = [("s0", base.tobytes())]
    v = bytearray(base.tobytes())
    for pos in rng.integers(0, len(v), 8):
        v[pos] = BASES[rng.integers(0, 4)]
    del v[101:109]
    nw.append(("s1", bytes(v)))
    fam = synth_family(n_seqs=2, length=900, seed=3)
    return fam + nw, np.array([[0, 1], [1, 0], [2, 3]])


# case: (input, RunnerConfig fields); "rc_carrier_all_host" sends every
# window, the inversion cores too, to the host DP (wide_host_total_cells)
CASES = {"inversion_2100": (_inversion_2100, {}), "rc_carrier": (_rc_carrier, {}),
         "rc_carrier_all_host": (_rc_carrier, {"wide_host_total_cells": 1 << 30}),
         "chainless": (_chainless, {}), "short": (_short, {})}


def test_family_matches_jax_and_full_route(family):
    named, pairs, ref, jax_stats, got, port_stats = family
    assert got == ref
    assert len(got) == len(pairs)
    for k in COUNTERS:
        assert port_stats[k] == jax_stats[k], k
    assert port_stats["anchored_pairs"] > 0 and port_stats["anchored_fallbacks"] == 0
    assert port_stats["host_windows"] < port_stats["anchored_windows"]  # some windows on the device
    assert any(d["kind"] == "window" for d in port_stats["dispatches"])
    # the wide pairs through the port's full route
    named, wide_pairs, wide_keys = _wide(family)
    full = WfaAligner(make_sequence_set(named),
                      RunnerConfig(scores=AlignmentScores.parse(SCORES), wide_route="full"),
                      device="cpu")
    full_keys = _keys(full.align_pairs(wide_pairs))
    assert [k[:4] for k in wide_keys] == [k[:4] for k in full_keys]


@pytest.mark.parametrize("case", sorted(CASES))
def test_runner_matches_jax(case):
    make, cfg = CASES[case]
    named, pairs = make()
    ref, jax_stats, got, port_stats = _run(named, pairs, **cfg)
    assert got == ref
    assert len(got) == len(pairs)
    for k in COUNTERS:
        assert port_stats[k] == jax_stats[k], k
    if case in ("inversion_2100", "rc_carrier", "rc_carrier_all_host"):
        assert port_stats["anchored_pairs"] > 0
    if case.startswith("rc_carrier"):
        assert any(r[2] for r in got)
    windows = [d for d in port_stats["dispatches"] if d["kind"] == "window"]
    if case == "rc_carrier":
        assert windows
    if case == "rc_carrier_all_host":
        assert not windows and port_stats["host_windows"] == port_stats["anchored_windows"] > 0
    if case in ("chainless", "short"):
        assert port_stats["anchored_pairs"] == 0
    if case == "chainless":
        assert port_stats["anchored_fallbacks"] >= 1


def test_anchored_job_cap_matches_jax(family):
    """Above anchored_max_jobs, moderately wide jobs go back to the banded
    chunks: the same results as the JAX package, the same scores as the
    uncapped route (the family fixture: 6 wide jobs, under the default cap),
    and fewer anchored pairs."""
    named, pairs, uncapped = _wide(family)
    port_stats = family[5]
    ref, jax_stats, got, capped = _run(named, pairs, anchored_max_jobs=2)
    assert got == ref
    for k in COUNTERS:
        assert capped[k] == jax_stats[k], k
    assert [k[:4] for k in got] == [k[:4] for k in uncapped]
    assert capped["anchored_pairs"] < port_stats["anchored_pairs"]


def test_wide_verify_certifies_every_stitch(family):
    named, pairs, uncapped = _wide(family)
    ref, jax_stats, got, stats = _run(named, pairs, wide_verify=True)
    assert got == ref == uncapped
    for k in COUNTERS:
        assert stats[k] == jax_stats[k], k
    assert stats["wide_verified"] == stats["anchored_pairs"] > 0
    assert any(d["kind"] == "verify" for d in stats["dispatches"])


def test_verify_falls_back_on_suboptimal_stitch(family, monkeypatch):
    """A stitch that fails the verify sweep re-runs the full wide route and
    still gives the optimal score."""
    named, pairs, ref = _wide(family)
    real_stitch = anchored.stitch

    def bad_stitch(plan, witems):
        items, nq, nt = real_stitch(plan, witems)
        # turn the first long match run into mismatches: same consumption,
        # a strictly worse score
        for i, (n, op) in enumerate(items):
            if op == "=" and n >= 20:
                items = items[:i] + [(n, "X")] + items[i + 1 :]
                break
        return items, nq, nt

    monkeypatch.setattr(anchored, "stitch", bad_stitch)
    al = WfaAligner(make_sequence_set(named),
                    RunnerConfig(scores=AlignmentScores.parse(SCORES), wide_verify=True), device="cpu")
    got = _keys(al.align_pairs(pairs))
    assert al.stats["wide_verified"] == 0 and al.stats["anchored_pairs"] == 0
    assert [k[:4] for k in got] == [k[:4] for k in ref]


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    """The default pipeline on the family, once in each package: the
    --no-sort GFA, then the sorted GFA of the same alignments; the port
    also writes --output-alignments and replays it with -p."""
    tmp = tmp_path_factory.mktemp("anchored_pipeline")
    named = synth_family()
    out = {}
    jsr = SeqRushTPU(jax_seqs(named), JaxArgs(no_sort=True, output=str(tmp / "jax_ns.gfa")))
    jsr.align_and_unite()
    jsr.write_gfa()
    jsr.args.no_sort, jsr.args.output = False, str(tmp / "jax.gfa")
    jsr.write_gfa()
    paf = tmp / "port.paf"
    psr = SeqRushTorch(make_sequence_set(named), Args(no_sort=True, output=str(tmp / "port_ns.gfa"),
                                                      output_alignments=str(paf), device="cpu"))
    psr.align_and_unite()
    psr.write_gfa()
    psr.args.no_sort, psr.args.output = False, str(tmp / "port.gfa")
    psr.write_gfa()
    replay = SeqRushTorch(make_sequence_set(named),
                          Args(paf=str(paf), no_sort=True, output=str(tmp / "replay_ns.gfa"), device="cpu"))
    replay.align_and_unite()
    replay.write_gfa()
    for name in ("jax_ns", "jax", "port_ns", "port", "replay_ns"):
        out[name] = (tmp / f"{name}.gfa").read_bytes()
    out["paf"] = paf.read_text()
    out["stats"] = psr.stats["aligner"]
    return out


def test_pipeline_default_no_sort_gfa_matches_jax(pipeline_runs):
    assert pipeline_runs["stats"]["anchored_pairs"] > 0
    assert pipeline_runs["port_ns"] == pipeline_runs["jax_ns"]


def test_pipeline_default_sorted_gfa_isomorphic_to_jax(pipeline_runs):
    got = parse_gfa(pipeline_runs["port"].decode())
    ref = parse_gfa(pipeline_runs["jax"].decode())
    same, why = isomorphic(got, ref)
    assert same, why
    assert sorted(got.nodes) == list(range(1, len(got.nodes) + 1))


def test_paf_round_trip_with_wide_pairs(pipeline_runs):
    """The PAF carries the route's gap-heavy CIGARs unchanged: its replay
    gives the same GFA bytes."""
    cigars = [line.split("cg:Z:")[1].split()[0] for line in pipeline_runs["paf"].splitlines()]
    assert len(cigars) == 12
    long_gaps = [c for c in cigars if any(int(n) >= 50 for n in re.findall(r"(\d+)[ID]", c))]
    assert long_gaps
    assert pipeline_runs["replay_ns"] == pipeline_runs["port_ns"] == pipeline_runs["jax_ns"]
