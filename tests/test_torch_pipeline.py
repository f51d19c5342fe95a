"""seqrush_tpu_torch's pipeline (device='cpu') against seqrush_tpu's, both
with --no-sort: the GFA files must be byte-identical, with compaction on and
off, under the sweepga backend and --inversion-aware, under the flags of the
default run and under -p replay; a JAX union-find checkpoint must load into
the port.  With the layout on, the two modes' graphs are isomorphic."""

import numpy as np
import pytest

from seqrush_tpu.config import Args as JaxArgs
from seqrush_tpu.pipeline import SeqRushTPU
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch import cli
from seqrush_tpu_torch.config import Args
from seqrush_tpu_torch.pipeline import SeqRushTorch, run_seqrush
from seqrush_tpu_torch.sequences import make_sequence_set

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random(length, seed):
    return BASES[np.random.default_rng(seed).integers(0, 4, size=length)].tobytes()


def _snp(seq, pos):
    s = bytearray(seq)
    s[pos] = ord("A") if s[pos] != ord("A") else ord("C")
    return bytes(s)


def _revcomp(seq):
    return seq.translate(bytes.maketrans(b"ACGTacgt", b"TGCAtgca"))[::-1]


def _mutator_cases():
    """The tests/test_end_to_end.py mutator cases."""
    b2, b3, b4 = _random(200, 2), _random(200, 3), _random(200, 4)
    b5, b9 = _random(120, 5), _random(200, 9)
    b6 = _random(300, 6)
    return {
        "snp": [("ref", b2), ("alt", _snp(b2, 100))],
        "deletion": [("ref", b3), ("del", b3[:100] + b3[110:])],
        "insertion": [("ref", b4), ("ins", b4[:80] + b"TTTGGCCA" + b4[80:])],
        "tandem_dup": [("ref", b5), ("dup", b5[:50] + b5[50:65] + b5[50:])],
        "reverse_complement": [("fwd", b9), ("rev", _revcomp(b9))],
        "combination": [
            ("a", b6), ("b", _snp(b6, 50)),
            ("c", _snp(b6, 200)[:100] + _snp(b6, 200)[108:]),
            ("d", b6[:250] + b"ACGTACGT" + b6[250:]),
        ],
    }


def _graft_corpus(n=6, length=1200):
    """A reduced copy of the __graft_entry__.py gene-scale corpus (1.2 kb
    haplotypes, ~1% SNPs, small deletions) with n of its 16 haplotypes."""
    rng = np.random.default_rng(0)
    base = BASES[rng.integers(0, 4, size=length)]
    named = [("s0", base.tobytes())]
    for k in range(1, n):
        v = bytearray(base.tobytes())
        for pos in rng.integers(0, len(v), size=12):
            v[pos] = BASES[rng.integers(0, 4)]
        if k % 3 == 0:
            p = int(rng.integers(0, len(v) - 40))
            del v[p : p + int(rng.integers(1, 12))]
        named.append((f"s{k}", bytes(v)))
    return named


def _jax_gfa(named, tmp_path, **kw):
    out = tmp_path / "jax.gfa"
    sr = SeqRushTPU(jax_seqs(named), JaxArgs(no_sort=True, output=str(out), **kw))
    sr.align_and_unite()
    sr.write_gfa()
    return out.read_bytes(), sr


def _port_gfa(named, tmp_path, **kw):
    out = tmp_path / "port.gfa"
    sr = SeqRushTorch(make_sequence_set(named), Args(no_sort=True, output=str(out), device="cpu", **kw))
    sr.align_and_unite()
    sr.write_gfa()
    return out.read_bytes(), sr


@pytest.mark.parametrize("no_compact", [False, True])
@pytest.mark.parametrize("case", sorted(_mutator_cases()))
def test_gfa_byte_identical_on_mutator_cases(case, no_compact, tmp_path):
    named = _mutator_cases()[case]
    ref, _ = _jax_gfa(named, tmp_path, no_compact=no_compact)
    got, sr = _port_gfa(named, tmp_path, no_compact=no_compact)
    assert got == ref
    assert sr.stats["aligner"]["alignments"] == len(named) * (len(named) - 1)


@pytest.mark.parametrize("no_compact", [False, True])
def test_gfa_byte_identical_on_graft_corpus(no_compact, tmp_path):
    named = _graft_corpus()
    ref, _ = _jax_gfa(named, tmp_path, no_compact=no_compact)
    got, _ = _port_gfa(named, tmp_path, no_compact=no_compact)
    assert got == ref


def test_jax_checkpoint_loads_into_port(tmp_path):
    """JAX save_checkpoint -> port load_checkpoint -> the same GFA; and the
    port's own checkpoint equals the JAX one."""
    named = _mutator_cases()["combination"]
    ref, jsr = _jax_gfa(named, tmp_path)
    ckpt = tmp_path / "uf.npy"
    jsr.save_checkpoint(str(ckpt))
    out = tmp_path / "resumed.gfa"
    sr = SeqRushTorch(make_sequence_set(named), Args(no_sort=True, output=str(out), device="cpu"))
    sr.load_checkpoint(str(ckpt))
    sr.write_gfa()
    assert out.read_bytes() == ref
    _got, psr = _port_gfa(named, tmp_path)
    psr.save_checkpoint(str(tmp_path / "port_uf.npy"))
    assert (np.load(tmp_path / "port_uf.npy") == np.load(ckpt)).all()


def test_cli_paf_round_trip(tmp_path):
    """The port's CLI writes --output-alignments and replays it with -p to
    the same GFA as the JAX pipeline's alignment run."""
    named = _mutator_cases()["combination"]
    fa = tmp_path / "in.fa"
    fa.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s) for n, s in named))
    ref, _ = _jax_gfa(named, tmp_path)
    gfa1, gfa2, paf = tmp_path / "a.gfa", tmp_path / "b.gfa", tmp_path / "a.paf"
    base = ["-s", str(fa), "--no-sort", "--device", "cpu"]
    assert cli.main(base + ["-o", str(gfa1), "--output-alignments", str(paf)]) == 0
    assert cli.main(base + ["-o", str(gfa2), "-p", str(paf)]) == 0
    assert gfa1.read_bytes() == ref
    assert gfa2.read_bytes() == ref
    assert len(paf.read_text().splitlines()) == 12


def _middle_inverted():
    """tests/test_inversion.py's middle-inverted pair."""
    left, mid, right = _random(150, 1), _random(90, 2), _random(150, 3)
    return [("plain", left + mid + right), ("inverted", left + _revcomp(mid) + right)]


def _backend_cases():
    return {**_mutator_cases(), "middle_inverted": _middle_inverted()}


BACKEND_MODES = {
    "sweepga": dict(aligner="sweepga"),
    "sweepga_f3": dict(aligner="sweepga", frequency=3),
    "sweepga_k5": dict(aligner="sweepga", min_match_length=5),
    "inversion_aware": dict(inversion_aware=True),
}


@pytest.mark.parametrize("case", sorted(_backend_cases()))
@pytest.mark.parametrize("mode", sorted(BACKEND_MODES))
def test_backend_gfa_byte_identical(mode, case, tmp_path):
    """--aligner sweepga (also with -f 3 and -k 5) and --inversion-aware:
    the port's --no-sort GFA is the JAX package's, byte for byte."""
    named = _backend_cases()[case]
    kw = BACKEND_MODES[mode]
    ref, jsr = _jax_gfa(named, tmp_path, **kw)
    got, sr = _port_gfa(named, tmp_path, **kw)
    assert got == ref
    st, jst = sr.stats["aligner"], jsr.stats["aligner"]
    keys = ("alignments", "chains", "filtered_1to1", "host_windows") if "aligner" in kw else (
        "alignments", "band_escalations")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    if "aligner" in kw:
        assert st["run_overflows"] == 0
    else:
        assert st["alignments"] == 2 * len(named) * (len(named) - 1)


FLAG_VARIANTS = {
    "k3": dict(min_match_length=3),
    "k8": dict(min_match_length=8),
    "seqwish_style": dict(seqwish_style=True),
    "seqwish_style_no_compact": dict(seqwish_style=True, no_compact=True),
    "max_divergence": dict(max_divergence=0.02),
    "orientation_scores": dict(orientation_scores="0,2,3,1"),
}


def _flag_cases():
    return {**_mutator_cases(), "graft": _graft_corpus()}


@pytest.mark.parametrize("case", sorted(_flag_cases()))
@pytest.mark.parametrize("flags", sorted(FLAG_VARIANTS))
def test_flag_gfa_byte_identical(flags, case, tmp_path):
    """Flags of the default run: -k 3 and -k 8, --seqwish-style with and
    without --no-compact, --max-divergence 0.02 and --orientation-scores
    0,2,3,1 each give the JAX package's --no-sort GFA."""
    named = _flag_cases()[case]
    ref, _ = _jax_gfa(named, tmp_path, **FLAG_VARIANTS[flags])
    got, _ = _port_gfa(named, tmp_path, **FLAG_VARIANTS[flags])
    assert got == ref


@pytest.mark.parametrize("backend", ["allwave", "sweepga"])
@pytest.mark.parametrize("k", [0, 5])
@pytest.mark.parametrize("convention", ["seqrush", "standard"])
def test_paf_replay_byte_identical(convention, k, backend, tmp_path):
    """-p replay of the JAX package's --output-alignments PAF (sweepga's
    records are local, with nonzero starts) under both strand conventions:
    the port's GFA is the JAX package's replay, and the port writes the same
    PAF bytes."""
    named = _mutator_cases()["combination"] + [("e", _revcomp(_mutator_cases()["combination"][0][1]))]
    jpaf, ppaf = tmp_path / "jax.paf", tmp_path / "port.paf"
    _jax_gfa(named, tmp_path, aligner=backend, output_alignments=str(jpaf))
    _port_gfa(named, tmp_path, aligner=backend, output_alignments=str(ppaf))
    assert ppaf.read_bytes() == jpaf.read_bytes()
    if backend == "sweepga":
        starts = [int(f) for line in jpaf.read_text().splitlines() for f in line.split("\t")[2:3]]
        assert any(starts)
    kw = dict(paf=str(jpaf), paf_convention=convention, min_match_length=k)
    ref, _ = _jax_gfa(named, tmp_path, **kw)
    got, _ = _port_gfa(named, tmp_path, **kw)
    assert got == ref


@pytest.mark.parametrize(
    "mode,case",
    [("sweepga", "combination"), ("inversion_aware", "middle_inverted")],
)
def test_backend_layout_isomorphic(mode, case, tmp_path):
    """With the layout on, each mode's graph is isomorphic to the JAX
    package's, with node ids 1..N."""
    from seqrush_tpu.tools.isomorphic import isomorphic_gfa as jax_isomorphic_gfa
    from seqrush_tpu_torch.tools.isomorphic import isomorphic_gfa

    named = _backend_cases()[case]
    jo, po = tmp_path / "jax_sorted.gfa", tmp_path / "port_sorted.gfa"
    jsr = SeqRushTPU(jax_seqs(named), JaxArgs(output=str(jo), **BACKEND_MODES[mode]))
    jsr.align_and_unite()
    jsr.write_gfa()
    sr = SeqRushTorch(make_sequence_set(named), Args(output=str(po), device="cpu",
                                                     **BACKEND_MODES[mode]))
    sr.align_and_unite()
    g = sr.write_gfa()
    assert isomorphic_gfa(jo.read_text(), po.read_text()) == (True, "isomorphic")
    assert jax_isomorphic_gfa(jo.read_text(), po.read_text()) == (True, "isomorphic")
    assert sorted(g.nodes) == list(range(1, g.node_count() + 1))


def test_cli_backend_modes(tmp_path):
    """The CLI runs --aligner sweepga -f N and --inversion-aware, each to
    the JAX package's GFA."""
    named = _mutator_cases()["combination"]
    fa = tmp_path / "in.fa"
    fa.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s) for n, s in named))
    for flags, kw in ((["--aligner", "sweepga", "-f", "4"], dict(aligner="sweepga", frequency=4)),
                      (["--inversion-aware"], dict(inversion_aware=True))):
        out = tmp_path / "cli.gfa"
        assert cli.main(["-s", str(fa), "-o", str(out), "--no-sort", "--device", "cpu", *flags]) == 0
        ref, _ = _jax_gfa(named, tmp_path, **kw)
        assert out.read_bytes() == ref


def test_frequency_reaches_runner_config(tmp_path, monkeypatch):
    import seqrush_tpu_torch.align.sweep as sweep_mod

    cfgs = []
    real_init = sweep_mod.SweepAligner.__init__

    def init(self, seqs, config=None, **kw):
        cfgs.append(config)
        real_init(self, seqs, config, **kw)

    monkeypatch.setattr(sweep_mod.SweepAligner, "__init__", init)
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">a\n%s\n>b\n%s\n" % (_random(300, 1), _snp(_random(300, 1), 40)))
    assert cli.main(["-s", str(fa), "-o", str(tmp_path / "o.gfa"), "--no-sort", "--device", "cpu",
                     "--aligner", "sweepga", "-f", "7", "--orientation-scores", "0,2,3,1"]) == 0
    assert cfgs[0].frequency == 7
    assert cfgs[0].orientation_scores.mismatch_penalty == 2
    assert not cfgs[0].orientation_scores.has_two_piece


@pytest.mark.parametrize(
    "flags,item",
    [
        (dict(mesh_devices=2), "item 12"),
    ],
)
def test_unported_modes_raise(flags, item, tmp_path):
    """The modes the port once raised NotImplementedError for (their ROADMAP
    item) now run: the call writes the GFA the run without the flag writes."""
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">a\nACGTACGTAC\n>b\nACGTACGAAC\n")
    kw = dict(sequences=str(fa), no_sort=True, device="cpu")
    run_seqrush(Args(output=str(tmp_path / "plain.gfa"), **kw))
    run_seqrush(Args(output=str(tmp_path / "o.gfa"), **flags, **kw))
    assert (tmp_path / "o.gfa").read_bytes() == (tmp_path / "plain.gfa").read_bytes(), item
