"""seqrush_tpu_torch's pipeline (device='cpu') against seqrush_tpu's, both
with --no-sort: the GFA files must be byte-identical, with compaction on and
off, and a JAX union-find checkpoint must load into the port."""

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


@pytest.mark.parametrize(
    "flags,item",
    [
        (dict(no_sort=False), "item 7"),
        (dict(sparsification="tree:2"), "item 8"),
        (dict(iterative=True), "item 8"),
        (dict(inversion_aware=True), "item 11"),
        (dict(aligner="sweepga"), "item 11"),
        (dict(mesh_devices=2), "item 12"),
    ],
)
def test_unported_modes_raise(flags, item, tmp_path):
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">a\nACGTACGTAC\n>b\nACGTACGAAC\n")
    kw = dict(sequences=str(fa), output=str(tmp_path / "o.gfa"), no_sort=True, device="cpu")
    kw.update(flags)
    with pytest.raises(NotImplementedError, match=item):
        run_seqrush(Args(**kw))
    assert not (tmp_path / "o.gfa").exists()
