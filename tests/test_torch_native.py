"""The port's host library (seqrush_tpu_torch/csrc/seqrush_native.cpp through
native.py) against the JAX package's, on the CPU, tolerance 0 (everything is
integer or bytes): the FASTA parser and load_fasta (the three inputs that a
Python loop reads differently, the pipeline tests' corpora, load_fasta_str),
the bulk unite against the pipeline's device flush, the WFA backtrace, the
banded traceback walk and the chaining DP, each against the port's Python
specification and the JAX package's function; cigar_to_string; and a failed
build, which must raise rather than parse differently."""

import numpy as np
import pytest
import torch

import chip_smoke
from seqrush_tpu import native as jax_native
from seqrush_tpu.align.cigar import cigar_to_string as jax_cigar_to_string
from seqrush_tpu.ops import anchors as jax_anchors
from seqrush_tpu.ops import nw as jax_nw
from seqrush_tpu.ops import unionfind as juf
from seqrush_tpu.ops import wfa as jwfa
from seqrush_tpu.sequences import load_fasta as jax_load_fasta
from seqrush_tpu.sequences import load_fasta_str as jax_load_fasta_str
from seqrush_tpu_torch import cli, native, pipeline, sequences
from seqrush_tpu_torch.align.cigar import cigar_to_string
from seqrush_tpu_torch.ops import anchors, nw, nw_cuda, wfa
from seqrush_tpu_torch.ops import unionfind as uf
from seqrush_tpu_torch.ops.wfa import Penalties
from seqrush_tpu_torch.pos import encode_bases
from seqrush_tpu_torch.sequences import load_fasta, load_fasta_python, load_fasta_str
from test_torch_pipeline import _graft_corpus, _jax_gfa, _mutator_cases, _port_gfa

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
PEN = Penalties(5, 8, 2, 24, 1)


def _records(seqs):
    return [(s.id, s.data.tobytes(), s.offset) for s in seqs.sequences]


def test_fasta_parse(tmp_path):
    p = tmp_path / "t.fa"
    p.write_text(">seq1 some description\nACGT\nTTAA\n>seq2\nGG\n\n>seq3\nC\n")
    out = native.parse_fasta_native(str(p))
    assert out == [("seq1", b"ACGTTTAA"), ("seq2", b"GG"), ("seq3", b"C")]
    assert out == jax_native.parse_fasta_native(str(p))


def test_fasta_matches_python(tmp_path):
    p = tmp_path / "t.fa"
    p.write_text(">a x\nACGTAC\nGT\n>b\nTTTT\n")
    seqs = load_fasta(str(p))
    assert [s.id for s in seqs.sequences] == ["a", "b"]
    assert seqs[0].data.tobytes() == b"ACGTACGT"
    assert seqs[1].data.tobytes() == b"TTTT"
    assert _records(seqs) == _records(load_fasta_python(p)) == _records(jax_load_fasta(str(p)))


@pytest.mark.parametrize("tag", sorted(chip_smoke.fasta_faults()))
def test_fasta_fault_inputs_load_as_jax(tag, tmp_path):
    """Blanks after '>', a vertical tab / form feed on sequence lines and
    70,000-byte headers: the port reads each exactly as the JAX package (its
    C++ parser), where the Python loop does not; the blank names fail the
    golden check in both packages' --no-sort runs with the same message."""
    fa = tmp_path / f"{tag}.fa"
    fa.write_bytes(chip_smoke.fasta_faults()[tag])
    got, ref = _records(load_fasta(fa)), _records(jax_load_fasta(fa))
    assert got == ref
    assert _records(load_fasta_python(fa)) != ref
    if tag == "long_header":
        assert [len(name) for name, _, _ in got] == [65_534] * 3
        assert [len(data) for _, data, _ in got] == [4_466 + 300] * 3
    elif tag == "vertical_tab":
        assert [len(data) for _, data, _ in got] == [301, 301, 300]
        assert b"\x0b" in got[0][1] and got[1][1].startswith(b"\x0c")
    else:
        assert [name for name, _, _ in got] == ["", "", ""]
        from seqrush_tpu import cli as jax_cli

        with pytest.raises(RuntimeError) as jax_err:
            jax_cli.main(["-s", str(fa), "-o", str(tmp_path / "jax.gfa"), "--no-sort"])
        with pytest.raises(RuntimeError) as port_err:
            cli.main(["-s", str(fa), "-o", str(tmp_path / "port.gfa"), "--no-sort", "--device", "cpu"])
        assert str(port_err.value) == str(jax_err.value)
        assert str(port_err.value).startswith("Path validation failed!")


@pytest.mark.parametrize("case", sorted(_mutator_cases()) + ["graft", "graft_wrapped"])
def test_load_fasta_equals_jax_on_pipeline_corpora(case, tmp_path):
    named = _graft_corpus() if case.startswith("graft") else _mutator_cases()[case]
    width = 60 if case == "graft_wrapped" else None
    fa = tmp_path / "c.fa"
    fa.write_bytes(b"".join(
        b">%s desc\n" % n.encode() + b"\n".join(s[i : i + (width or len(s))] for i in range(0, len(s), width or len(s)))
        + b"\n" for n, s in named))
    got = _records(load_fasta(fa))
    assert got == _records(jax_load_fasta(fa)) == _records(load_fasta_python(fa))
    assert [(n, s) for n, s, _ in got] == [(n, s) for n, s in named]


def test_load_fasta_str_equals_jax():
    text = ">a first\nACGT\n  TTAA \n\n>b\tx\nGG\n>c\nC\n"
    got = load_fasta_str(text)
    assert _records(got) == _records(jax_load_fasta_str(text))
    assert [s.id for s in got.sequences] == ["a", "b", "c"]
    assert got.concat.tobytes() == b"ACGTTTAAGGC"


def test_load_fasta_unreadable_path_falls_back_and_raises(tmp_path):
    """The C++ call's OSError sends load_fasta to the Python loop, which
    raises the missing file's own error (as in the JAX package)."""
    with pytest.raises(FileNotFoundError):
        load_fasta(tmp_path / "missing.fa")
    with pytest.raises(FileNotFoundError):
        jax_load_fasta(str(tmp_path / "missing.fa"))


def test_load_fasta_non_utf8_name_falls_back_as_jax(tmp_path):
    """A name that is not UTF-8 sends both packages from the C++ parser to
    the Python loop, which raises the same decode error."""
    fa = tmp_path / "bad.fa"
    fa.write_bytes(b">\xffname\nACGT\n")
    with pytest.raises(UnicodeDecodeError):
        native.parse_fasta_native(str(fa))
    with pytest.raises(UnicodeDecodeError):
        load_fasta(fa)
    with pytest.raises(UnicodeDecodeError):
        jax_load_fasta(str(fa))


def test_load_fasta_other_parser_errors_propagate(monkeypatch, tmp_path):
    """Only an unreadable path or an undecodable name falls back to the
    loop; any other error of the C++ parser propagates."""
    fa = tmp_path / "v.fa"
    fa.write_bytes(chip_smoke.fasta_faults()["vertical_tab"])

    def inconsistent(path):
        raise RuntimeError("fasta parse inconsistency")

    monkeypatch.setattr(sequences, "parse_fasta_native", inconsistent)
    with pytest.raises(RuntimeError, match="inconsistency"):
        load_fasta(fa)


def test_failed_build_raises_instead_of_parsing_differently(monkeypatch, tmp_path):
    fa = tmp_path / "v.fa"
    fa.write_bytes(chip_smoke.fasta_faults()["vertical_tab"])

    def broken_build():
        raise RuntimeError("g++ failed to build seqrush_native.cpp")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", broken_build)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        load_fasta(fa)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        nw.traceback_pair(np.zeros((4, 2), np.uint8), 1, 1, 1)


@pytest.mark.parametrize("n,m", [(300, 150), (5000, 4000)])
def test_uf_unite_bulk_native_matches_device_and_jax(n, m):
    rng = np.random.default_rng(n)
    edges = rng.integers(0, n, size=(m, 2))
    host = np.arange(n, dtype=np.int32)
    native.uf_unite_bulk_native(host, edges[:, 0], edges[:, 1])  # in place: int32, contiguous
    dev = uf.unite_edges(uf.create(n, "cpu"), edges[:, 0], edges[:, 1])
    ref = np.asarray(juf.unite_edges(juf.create(n), edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32)))
    assert (host == dev.numpy()).all()
    assert (host == ref).all()
    assert (host <= np.arange(n)).all() and (host[host] == host).all()  # min roots, compressed
    kept = np.arange(n, dtype=np.int64)
    native.uf_unite_bulk_native(kept, edges[:, 0], edges[:, 1])
    assert (kept == np.arange(n)).all()  # another dtype: the caller's array is left as it was


def test_pipeline_flush_parent_equals_host_unite(monkeypatch, tmp_path):
    """The pipeline's flush unites on the run's device; the host library's
    unite of the same parent and edges gives the same parent, and the
    --no-sort GFA of a small corpus is byte-identical to the JAX package's."""
    equal = []
    real = pipeline.SeqRushTorch._flush_unites

    def checking(self):
        if not self._edge_u:
            return real(self)
        u, v = np.concatenate(self._edge_u), np.concatenate(self._edge_v)
        host = self.parent.to("cpu", torch.int32, copy=True).numpy()
        real(self)
        native.uf_unite_bulk_native(host, u, v)
        equal.append(bool((host == self.parent.numpy()).all()))

    monkeypatch.setattr(pipeline.SeqRushTorch, "_flush_unites", checking)
    named = _graft_corpus()
    ref, _ = _jax_gfa(named, tmp_path)
    got, sr = _port_gfa(named, tmp_path)
    assert got == ref
    assert equal and all(equal)
    assert sr.parent.device.type == "cpu"


def _wfa_inputs():
    rng = np.random.default_rng(11)
    base = BASES[rng.integers(0, 4, size=80)].tobytes()
    alt = bytearray(base)
    alt[20] = BASES[(alt[20] + 1) % 4]
    del alt[50:55]
    return [(base, bytes(alt)), (bytes(alt), base)]


def test_backtrace_native_matches_python_and_jax(monkeypatch):
    pairs = _wfa_inputs()
    qs = [encode_bases(q) for q, _ in pairs]
    ts = [encode_bases(t) for _, t in pairs]
    Q, T, qlens, tlens = wfa.pack_batch(qs, ts)
    caps = np.full(2, 500, np.int32)
    kw = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1, smax=500, band=32)
    scores, hists = wfa.wfa_align_device(*(torch.from_numpy(a) for a in (Q, T, qlens, tlens, caps)),
                                         keep_history=True, **kw)
    scores = scores.numpy()
    hists = {k: v.numpy() for k, v in hists.items()}
    j_scores, j_hists = jwfa.wfa_align_device(Q, T, qlens, tlens, caps, keep_history=True, **kw)
    j_hists = {k: np.asarray(v) for k, v in j_hists.items()}
    assert (scores == np.asarray(j_scores)).all()
    jpen = jwfa.Penalties(5, 8, 2, 24, 1)
    for b in range(2):
        h = {k: v[b] for k, v in hists.items()}
        args = (int(scores[b]), int(qlens[b]), int(tlens[b]), 32)
        nat = native.backtrace_native(h, *args, 5, 8, 2, 24, 1)
        assert nat is not None
        assert wfa.backtrace_pair(h, *args, PEN) == nat
        with monkeypatch.context() as m:
            m.setattr(native, "backtrace_native", lambda *a, **k: None)
            assert wfa.backtrace_pair(h, *args, PEN) == nat  # the Python specification
        assert jwfa.backtrace_pair({k: v[b] for k, v in j_hists.items()}, *args, jpen) == nat
        assert jax_native.backtrace_native(h, *args, 5, 8, 2, 24, 1) == nat


def test_backtrace_native_reports_inconsistent_history():
    pairs = _wfa_inputs()
    Q, T, qlens, tlens = wfa.pack_batch([encode_bases(pairs[0][0])], [encode_bases(pairs[0][1])])
    _s, hists = wfa.wfa_align_device(*(torch.from_numpy(a) for a in (Q, T, qlens, tlens, np.full(1, 500, np.int32))),
                                     mismatch=5, o1=8, e1=2, o2=24, e2=1, smax=500, band=32, keep_history=True)
    h = {k: np.full_like(v[0].numpy(), wfa.NULL16) for k, v in hists.items()}
    args = (15, int(qlens[0]), int(tlens[0]), 32, 5, 8, 2, 24, 1)
    assert native.backtrace_native(h, *args) is None
    assert jax_native.backtrace_native(h, *args) is None


def test_backtrace_native_rejects_mismatched_histories():
    """The C++ indexes every history with M's shape, so the wrapper checks
    the shapes before it passes the pointers."""
    h = {k: np.full((8, 65), wfa.NULL16, np.int16) for k in ("M", "I1", "D1", "I2", "D2")}
    h["D2"] = h["D2"][:4]
    with pytest.raises(ValueError, match="share one"):
        native.backtrace_native(h, 0, 10, 10, 32, 5, 8, 2, 24, 1)


def _nw_batch(band, rng):
    qs, ts = [], []
    for k in range(6):
        q = BASES[rng.integers(0, 4, 120 + 7 * k)].copy()
        t = q.copy()
        t[rng.integers(0, t.size, 4)] = BASES[rng.integers(0, 4, 4)]
        if k % 2:
            p = int(rng.integers(10, 100))
            t = np.delete(t, np.arange(p, p + 1 + k))
        else:
            t = np.insert(t, int(rng.integers(10, 100)), BASES[rng.integers(0, 4, k + 2)])
        qs.append(encode_bases(q))
        ts.append(encode_bases(t))
    L = max(max(x.size for x in qs), max(x.size for x in ts))
    Q = np.full((len(qs) + 1, L), nw.QPAD, np.uint8)
    T = np.full((len(qs) + 1, L), nw.TPAD, np.uint8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        Q[b, : q.size], T[b, : t.size] = q, t
    ql = np.array([q.size for q in qs] + [0], np.int32)
    tl = np.array([t.size for t in ts] + [0], np.int32)
    return Q, T, ql, tl, qs, ts


@pytest.mark.parametrize("band", [15, 63, 127])
def test_nw_traceback_native_matches_python_and_jax(band, monkeypatch):
    Q, T, ql, tl, qs, ts = _nw_batch(band, np.random.default_rng(band))
    tmax = 2 * Q.shape[1]
    pen = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1)
    _s, tb = nw_cuda.nw_align_reference(*(torch.from_numpy(a) for a in (Q, T, ql, tl)), band=band, tmax=tmax, **pen)
    tb = tb.numpy()
    for b in range(len(qs) + 1):
        nat = native.nw_traceback_native(tb[b], int(ql[b]), int(tl[b]), band)
        assert nat is not None
        assert nw.traceback_pair(tb[b], int(ql[b]), int(tl[b]), band) == nat
        with monkeypatch.context() as m:
            m.setattr(native, "nw_traceback_native", lambda *a, **k: None)
            assert nw.traceback_pair(tb[b], int(ql[b]), int(tl[b]), band) == nat
        assert jax_nw.traceback_pair(tb[b], int(ql[b]), int(tl[b]), band) == nat
        if b < len(qs):
            items = nw.resolve_matches(nat, qs[b], ts[b])
            assert sum(n for n, op in items if op in "=XI") == qs[b].size
            assert sum(n for n, op in items if op in "=XD") == ts[b].size


def test_nw_traceback_out_of_band_raises_in_both():
    """A walk that leaves the band: the C++ reports it, and the Python
    specification then raises, in both packages."""
    tb = np.zeros((64, 4), np.uint8)
    assert native.nw_traceback_native(tb, 30, 2, 3) is None
    with pytest.raises(AssertionError, match="escaped the band"):
        nw.traceback_pair(tb, 30, 2, 3)
    with pytest.raises(AssertionError, match="escaped the band"):
        jax_nw.traceback_pair(tb, 30, 2, 3)


def test_chain_anchors_native_matches_python():
    """The C++ chaining DP is bit-identical to the Python lookback (the same
    arithmetic, first-max ties) across random anchor sets, repeat-like
    multi-diagonal anchors among them; chain_anchors equals the JAX
    package's."""
    rng = np.random.default_rng(4)
    for trial in range(8):
        n = int(rng.integers(1, 300))
        qs = np.sort(rng.integers(0, 3000, size=n))
        ts = qs + rng.integers(-50, 50, size=n)
        noise = rng.integers(0, 3000, size=(max(n // 4, 1), 2))
        a = np.concatenate([np.stack([qs, np.abs(ts)], axis=1), noise])
        a = a[np.lexsort((a[:, 1], a[:, 0]))].astype(np.int64)
        idx = native.chain_anchors_native(a, 15, 5000, 2000)
        assert list(idx) == anchors._chain_indices_python(a, 15, 5000, 2000), f"trial {trial}"
        assert list(idx) == list(jax_native.chain_anchors_native(a, 15, 5000, 2000))
        assert (anchors.chain_anchors(a) == jax_anchors.chain_anchors(a)).all()
    assert native.chain_anchors_native(np.zeros((0, 2), np.int64), 15, 5000, 2000).size == 0


def test_cigar_to_string():
    items = [(12, "="), (1, "X"), (3, "I"), (40, "="), (2, "D"), (5, "M")]
    assert cigar_to_string(items) == jax_cigar_to_string(items) == "12=1X3I40=2D5M"
    assert cigar_to_string([]) == ""
