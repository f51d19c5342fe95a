"""The port's layout phase (layout/ygs.py and pipeline.write_gfa, device='cpu')
against seqrush_tpu's.

The port's SGD draws from its own generator, so sorted graphs are held to:
isomorphic GFAs (tools/isomorphic.py), the golden invariant (write_gfa raises
unless every path rebuilds its input), node ids 1..N, and the canonical zoo's
mean RMSE <= 24.86 bp.  Where no SGD runs (skip_sgd) the layout is host code
alone and the GFAs must be byte-identical.  Two runs with one seed are
byte-identical.
"""

import numpy as np
import pytest

from seqrush_tpu.config import Args as JaxArgs
from seqrush_tpu.graph.bigraph import parse_gfa as jax_parse_gfa
from seqrush_tpu.layout import ygs as jygs
from seqrush_tpu.pipeline import SeqRushTPU
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu.tools.isomorphic import isomorphic_gfa as jax_isomorphic_gfa
from seqrush_tpu.tools.validate_zoo import RMSE_GATES, synth_gene
from seqrush_tpu_torch import cli
from seqrush_tpu_torch.config import Args
from seqrush_tpu_torch.graph.bigraph import parse_gfa
from seqrush_tpu_torch.layout import ygs as pygs
from seqrush_tpu_torch.pipeline import SeqRushTorch
from seqrush_tpu_torch.sequences import make_sequence_set
from seqrush_tpu_torch.tools.isomorphic import isomorphic_gfa
from seqrush_tpu_torch.tools.measure_layout_quality import layout_quality
from seqrush_tpu_torch.tools import sort_gfa

from test_torch_graph_order import variation_gfa
from test_torch_pipeline import _graft_corpus, _mutator_cases


def _jax_sorted(named, tmp_path, **kw):
    out = tmp_path / "jax.gfa"
    sr = SeqRushTPU(jax_seqs(named), JaxArgs(output=str(out), **kw))
    sr.align_and_unite()
    sr.write_gfa()
    return out.read_text()


def _port_sorted(named, tmp_path, name="port.gfa", **kw):
    out = tmp_path / name
    sr = SeqRushTorch(make_sequence_set(named), Args(output=str(out), device="cpu", **kw))
    sr.align_and_unite()
    sr.write_gfa()
    return out.read_text(), sr


def _ids_are_1_to_n(text):
    g = parse_gfa(text)
    return sorted(g.nodes) == list(range(1, g.node_count() + 1))


@pytest.mark.parametrize("case", sorted(_mutator_cases()))
def test_sorted_gfa_isomorphic_on_mutator_cases(case, tmp_path):
    named = _mutator_cases()[case]
    ref = _jax_sorted(named, tmp_path)
    got, sr = _port_sorted(named, tmp_path)
    assert isomorphic_gfa(ref, got) == (True, "isomorphic")
    assert jax_isomorphic_gfa(ref, got) == (True, "isomorphic")
    assert _ids_are_1_to_n(got) and _ids_are_1_to_n(ref)
    for key in ("layout", "layout_sgd", "layout_groom", "layout_final_order"):
        assert sr.timer.phases[key] >= 0.0
    assert sr.timer.phases["layout"] >= sr.timer.phases["layout_sgd"]


def test_sorted_gfa_isomorphic_and_reproducible_on_graft_corpus(tmp_path):
    named = _graft_corpus()
    ref = _jax_sorted(named, tmp_path)
    got, _ = _port_sorted(named, tmp_path)
    again, _ = _port_sorted(named, tmp_path, name="again.gfa")
    assert isomorphic_gfa(ref, got) == (True, "isomorphic")
    assert _ids_are_1_to_n(got)
    assert again == got
    unsorted, _ = _port_sorted(named, tmp_path, name="unsorted.gfa", no_sort=True)
    assert isomorphic_gfa(unsorted, got) == (True, "isomorphic")
    assert layout_quality(parse_gfa(got))["rmse"] <= layout_quality(parse_gfa(unsorted))["rmse"]


def test_cli_default_run_sorts(tmp_path):
    """`-s in.fa -o out.gfa` with no further flags but the device."""
    named = _mutator_cases()["combination"]
    fa = tmp_path / "in.fa"
    fa.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s) for n, s in named))
    out = tmp_path / "out.gfa"
    assert cli.main(["-s", str(fa), "-o", str(out), "--device", "cpu"]) == 0
    ref = _jax_sorted(named, tmp_path)
    assert isomorphic_gfa(ref, out.read_text()) == (True, "isomorphic")
    assert _ids_are_1_to_n(out.read_text())


# -- flags, on one alignment shared through a union-find checkpoint ---------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The graft corpus aligned once by the JAX package; both pipelines
    resume from its union-find checkpoint, so each case costs no alignment."""
    tmp_dir = tmp_path_factory.mktemp("ckpt")
    named = _graft_corpus()
    sr = SeqRushTPU(jax_seqs(named), JaxArgs(no_sort=True, output=str(tmp_dir / "unsorted.gfa")))
    sr.align_and_unite()
    sr.save_checkpoint(str(tmp_dir / "uf.npy"))
    return named, str(tmp_dir / "uf.npy")


def _resume(checkpoint, tmp_path, **kw):
    named, ckpt = checkpoint
    jout, pout = tmp_path / "jax.gfa", tmp_path / "port.gfa"
    jsr = SeqRushTPU(jax_seqs(named), JaxArgs(output=str(jout), **kw))
    jsr.load_checkpoint(ckpt)
    jsr.write_gfa()
    psr = SeqRushTorch(make_sequence_set(named), Args(output=str(pout), device="cpu", **kw))
    psr.load_checkpoint(ckpt)
    psr.write_gfa()
    return jout.read_text(), pout.read_text(), psr


@pytest.mark.parametrize("topo_mode", ["best", "stable", "bubble", "odgi"])
def test_without_sgd_the_gfa_is_byte_identical(checkpoint, topo_mode, tmp_path):
    ref, got, sr = _resume(checkpoint, tmp_path, skip_sgd=True, topo_mode=topo_mode)
    assert got == ref
    assert "layout_sgd" not in sr.timer.phases
    assert "layout_final_order" in sr.timer.phases


@pytest.mark.parametrize(
    "flags",
    [
        dict(skip_sgd=True, skip_groom=True),
        dict(skip_sgd=True, skip_topo=True),
        dict(skip_sgd=True, skip_groom=True, skip_topo=True),
        dict(no_sort=True),
        dict(skip_sgd=True, no_compact=True),
    ],
    ids=lambda f: "+".join(sorted(f)),
)
def test_skip_flags_without_sgd_byte_identical(checkpoint, flags, tmp_path):
    ref, got, sr = _resume(checkpoint, tmp_path, **flags)
    assert got == ref
    assert ("layout_groom" in sr.timer.phases) == (
        not flags.get("skip_groom") and not flags.get("no_sort")
    )


@pytest.mark.parametrize("topo_mode", ["best", "stable", "bubble", "odgi"])
def test_each_topo_mode_with_sgd(checkpoint, topo_mode, tmp_path):
    ref, got, _ = _resume(checkpoint, tmp_path, topo_mode=topo_mode)
    assert isomorphic_gfa(ref, got) == (True, "isomorphic")
    assert _ids_are_1_to_n(got)


@pytest.mark.parametrize(
    "flags",
    [dict(skip_groom=True), dict(skip_topo=True), dict(skip_groom=True, skip_topo=True),
     dict(sgd_iter_max=30, sgd_theta=0.9, sgd_eps=0.05, sgd_cooling_start=0.8, sgd_eta_max=500.0)],
    ids=lambda f: "+".join(sorted(f)),
)
def test_sgd_with_other_flags(checkpoint, flags, tmp_path):
    ref, got, sr = _resume(checkpoint, tmp_path, **flags)
    assert isomorphic_gfa(ref, got) == (True, "isomorphic")
    assert _ids_are_1_to_n(got)
    assert "layout_sgd" in sr.timer.phases


# -- ygs_sort itself on the seeded variation graphs ---------------------------


@pytest.mark.parametrize("topo_mode", ["best", "stable", "bubble", "odgi"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ygs_sort_without_sgd_equals_jax(seed, topo_mode):
    """Groom, every final ordering, _best_final_order, the rank-refinement
    polish and rmse_for_order: exact against the JAX package."""
    text = variation_gfa(seed)
    jg, g = jax_parse_gfa(text), parse_gfa(text)
    jp, pp = jygs.YgsParams.from_graph(jg), pygs.YgsParams.from_graph(g)
    assert vars(pp) == vars(jp)
    assert vars(pp.to_sgd()) == vars(jp.to_sgd())
    jp.topo_mode = pp.topo_mode = topo_mode
    order = [n << 1 for n in sorted(g.nodes, reverse=True)]
    assert pygs.rmse_for_order(g, order) == jygs.rmse_for_order(jg, order)
    jygs.ygs_sort(jg, jp, use_sgd=False)
    timings = {}
    pygs.ygs_sort(g, pp, use_sgd=False, timings=timings, device="cpu")
    assert g.to_gfa_string() == jg.to_gfa_string()
    assert sorted(timings) == ["final_order", "groom"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_only_helpers(seed):
    text = variation_gfa(seed)
    jg, g = jax_parse_gfa(text), parse_gfa(text)
    jygs.groom_only(jg)
    pygs.groom_only(g)
    assert g.to_gfa_string() == jg.to_gfa_string()
    jygs.topological_sort_only(jg)
    pygs.topological_sort_only(g)
    assert g.to_gfa_string() == jg.to_gfa_string()
    before = g.all_path_hashes()
    pygs.sgd_sort_only(g, pygs.YgsParams.from_graph(g), device="cpu")
    assert sorted(g.nodes) == list(range(1, g.node_count() + 1))
    assert g.all_path_hashes() == before
    assert isomorphic_gfa(text, g.to_gfa_string()) == (True, "isomorphic")


def test_refine_rounds_zero_and_verbose(capsys):
    text = variation_gfa(3)
    jg, g = jax_parse_gfa(text), parse_gfa(text)
    jp = jygs.YgsParams.from_graph(jg, verbose=True)
    pp = pygs.YgsParams.from_graph(g, verbose=True)
    jp.refine_rounds = pp.refine_rounds = 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0] == lines[1]
    jygs.ygs_sort(jg, jp, use_sgd=False)
    jax_out = capsys.readouterr().out
    pygs.ygs_sort(g, pp, use_sgd=False, device="cpu")
    assert capsys.readouterr().out == jax_out
    assert "final-order candidates" in jax_out
    assert g.to_gfa_string() == jg.to_gfa_string()


def test_sort_gfa_tool(tmp_path):
    text = variation_gfa(1)
    src, a, b = tmp_path / "in.gfa", tmp_path / "a.gfa", tmp_path / "b.gfa"
    src.write_text(text)
    assert sort_gfa.main([str(src), str(a), "--device", "cpu", "--sgd-iter-max", "30"]) == 0
    assert sort_gfa.main([str(src), str(b), "--device", "cpu", "--sgd-iter-max", "30"]) == 0
    assert a.read_text() == b.read_text()
    assert isomorphic_gfa(text, a.read_text()) == (True, "isomorphic")
    assert layout_quality(parse_gfa(a.read_text()))["rmse"] < layout_quality(parse_gfa(text))["rmse"]
    # host-only sorting equals the JAX package's tool
    from seqrush_tpu.tools import sort_gfa as jax_sort_gfa

    assert sort_gfa.main([str(src), str(a), "--skip-sgd", "--device", "cpu"]) == 0
    assert jax_sort_gfa.main([str(src), str(b), "--skip-sgd"]) == 0
    assert a.read_text() == b.read_text()


# -- the zoo gate -------------------------------------------------------------


def test_hla_zoo_mean_rmse_gate(tmp_path):
    """The canonical six-gene zoo, seed 1234 (tests/test_zoo_rmse_gate.py):
    each gene's unsorted graph is built once by the JAX package, read with
    the port's parse_gfa and sorted by the port's ygs_sort; the mean layout
    RMSE must be <= 24.86 bp, with ids 1..N and every path intact."""
    rng = np.random.default_rng(1234)
    rmses = []
    for i in range(6):
        named = synth_gene(i, rng)
        out = tmp_path / f"g{i}.gfa"
        sr = SeqRushTPU(jax_seqs(named), JaxArgs(no_sort=True, output=str(out)))
        sr.align_and_unite()
        sr.write_gfa()
        g = parse_gfa(out.read_text())
        params = pygs.YgsParams.from_graph(g)
        pygs.ygs_sort(g, params, device="cpu")
        assert sorted(g.nodes) == list(range(1, g.node_count() + 1))
        assert g.comprehensive_verify(dict(named)) == []
        rmses.append(layout_quality(g)["rmse"])
    mean = float(np.mean(rmses))
    assert mean <= RMSE_GATES["hla"] == 24.86, (mean, rmses)
