"""The rest of the JAX package's surface in the port, each module against
its JAX original on the inputs of that module's JAX tests: the union-find's
``find``, ``count_components``, ``BidirectedUnionFind`` and
``match_region_pairs`` (tests/test_unionfind.py), ``mash_distance``
(against the JAX one and the port's batch form), ``graph/embedded.py`` and
``layout/variants.py`` (tests/test_embedded.py), ``graph/range_builder.py``
(tests/test_range_builder.py), and the tools ``simple_align``,
``sgd_diagnostics`` (tests/test_aux.py) and ``validate_zoo --synthetic 2
--device cpu``.  All exact: integer state, numpy with the same seeds, and
files compared byte for byte."""

import jax
import numpy as np
import pytest
import torch

from seqrush_tpu.align.runner import RunnerConfig as JaxRunnerConfig
from seqrush_tpu.align.runner import WfaAligner as JaxAligner
from seqrush_tpu.config import Args as JaxArgs
from seqrush_tpu.graph import embedded as jemb
from seqrush_tpu.graph import range_builder as jrb
from seqrush_tpu.graph.bigraph import BidirectedGraph as JaxGraph
from seqrush_tpu.layout import variants as jvar
from seqrush_tpu.ops import kmer as jkmer
from seqrush_tpu.ops import unionfind as juf
from seqrush_tpu.pipeline import SeqRushTPU
from seqrush_tpu.pos import make_pos
from seqrush_tpu.scores import AlignmentScores as JaxScores
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu.tools import sgd_diagnostics as jdiag
from seqrush_tpu.tools import simple_align as jsimple
from seqrush_tpu.tools import validate_zoo as jzoo
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.graph import embedded as temb
from seqrush_tpu_torch.graph import range_builder as trb
from seqrush_tpu_torch.graph.bigraph import BidirectedGraph, parse_gfa
from seqrush_tpu_torch.layout import variants as tvar
from seqrush_tpu_torch.ops import kmer as tkmer
from seqrush_tpu_torch.ops import unionfind as tuf
from seqrush_tpu_torch.scores import AlignmentScores
from seqrush_tpu_torch.sequences import make_sequence_set
from seqrush_tpu_torch.tools import sgd_diagnostics as tdiag
from seqrush_tpu_torch.tools import simple_align as tsimple
from seqrush_tpu_torch.tools import validate_zoo as tzoo

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
SCORES = "0,5,8,2,24,1"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these shapes gain nothing from more, and the
    suite's workers share the machine's cores (torch's spinning thread
    pools in several workers at once slow every test on it)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def H(n, r=False):
    return (n << 1) | int(r)


def rand_seq(n, seed):
    return BASES[np.random.default_rng(seed).integers(0, 4, size=n)].tobytes()


# -- union-find ----------------------------------------------------------------


def _uf_script(u):
    """tests/test_unionfind.py's operations in order, recording same()."""
    seen = []
    p1, p2, p3 = make_pos(100, False), make_pos(200, False), make_pos(100, True)
    seen.append(u.same(p1, p2))
    u.unite(p1, p2)
    u.unite(p1, p3)
    seen += [u.same(p1, p3), u.same(p2, p3), u.same(p1, p1)]
    u.unite(make_pos(139, True), make_pos(215, False))
    seen.append(u.find(make_pos(139, True)) == u.find(make_pos(215, False)))
    u.unite_matching_region(100, 200, 10, 15, 5, False, 100)
    u.unite_matching_region(100, 200, 10, 15, 3, True, 50)
    u.unite_matching_region_seq2_rc(300, 600, 4, 9, 7, True, 60)
    u.unite_matching_region_seq2_rc(300, 600, 4, 9, 7, False, 60)
    seen += [u.same(make_pos(114, False), make_pos(219, False)), u.same(make_pos(137, True), make_pos(217, False))]
    return seen


def test_bidirected_union_find_equals_jax():
    ref = juf.BidirectedUnionFind(1000)
    got = tuf.BidirectedUnionFind(1000, device="cpu")
    assert _uf_script(got) == _uf_script(ref)
    assert (got.roots() == ref.roots()).all()
    ref.pre_unite_orientations(1000)
    got.pre_unite_orientations(1000)
    assert (got.roots() == ref.roots()).all()
    assert tuf.count_components(got.parent, 1000) == juf.count_components(ref.parent, 1000)
    assert tuf.count_components(got.parent) == juf.count_components(ref.parent)


@pytest.mark.parametrize("seq1_is_rc", [False, True])
def test_match_region_pairs_equal_jax(seq1_is_rc):
    args = (100, 200, 10, 15, 5, seq1_is_rc, 50)
    for a, b in zip(tuf.match_region_pairs(*args), juf.match_region_pairs(*args)):
        assert a.dtype == b.dtype and (a == b).all()


def test_find_and_count_on_uncompressed_parents():
    """find on a JAX parent array given as numpy, uncompressed (chains of
    parents), and count_components on it: the JAX package's answers."""
    rng = np.random.default_rng(3)
    n = 400
    parent = np.arange(n, dtype=np.int32)
    for x in rng.permutation(n)[: n // 2]:
        parent[x] = rng.integers(0, x + 1)  # a pointer to a smaller slot: a forest
    pos = rng.integers(0, n, size=64)
    want = np.asarray(juf.find(jax.numpy.asarray(parent), pos))
    par_t = torch.from_numpy(parent.copy())
    assert (tuf.find(par_t, pos).numpy() == want).all()
    assert tuf.count_components(par_t) == juf.count_components(parent)
    assert tuf.count_components(par_t, 150) == juf.count_components(parent, 150)


# -- mash distance ---------------------------------------------------------------


def test_mash_distance_equals_jax_and_batch():
    rng = np.random.default_rng(9)
    base = rng.integers(0, 4, 3000).astype(np.uint8)
    seqs = [base]
    for div in (0.01, 0.05, 0.2):
        s = base.copy()
        s[rng.integers(0, s.size, int(div * s.size))] = rng.integers(0, 4, int(div * s.size))
        seqs.append(s)
    seqs += [rng.integers(0, 4, 3000).astype(np.uint8), base[:10], np.zeros(0, np.uint8)]
    sk_t = tkmer.mash_sketches(seqs)
    sk_j = jkmer.mash_sketches(seqs)
    ia, ib = np.meshgrid(np.arange(len(seqs)), np.arange(len(seqs)), indexing="ij")
    batch = tkmer.mash_distance_batch(sk_t, ia.ravel(), ib.ravel())
    for k, (a, b) in enumerate(zip(ia.ravel(), ib.ravel())):
        d = tkmer.mash_distance(sk_t[a], sk_t[b])
        assert d == jkmer.mash_distance(sk_j[a], sk_j[b])
        assert d == pytest.approx(batch[k], abs=1e-12)


# -- embedded graph and layout variants --------------------------------------------


def _build_linear(mod):
    e = mod.EmbeddedGraph()
    for i, s in enumerate([b"AC", b"GT", b"CA"], start=1):
        e.add_node(i, s)
    p = e.add_path("p")
    for i in (1, 2, 3):
        e.extend_path(p, i)
    return e


def _build_branching(mod):
    e = mod.EmbeddedGraph()
    for i, s in enumerate([b"A", b"C", b"G"], start=1):
        e.add_node(i, s)
    for name, ids in (("p1", (1, 2)), ("p2", (3, 2))):
        p = e.add_path(name)
        for i in ids:
            e.extend_path(p, i)
    return e


def _embedded_trace(mod, build):
    e = build(mod)
    out = [e.get_next_steps(h) for h in range(2, 8)] + [e.get_prev_steps(h) for h in range(2, 8)]
    out += [e.are_perfect_neighbors(a, b) for a in range(2, 8) for b in range(2, 8)]
    out.append(e.find_perfect_pairs())
    seqs = [e.get_path_sequence(k) for k in range(len(e.path_names))]
    e.compact()
    out += [seqs, [e.get_path_sequence(k) for k in range(len(e.path_names))],
            sorted((k, v.tobytes()) for k, v in e.node_seqs.items()), [s.tolist() for s in e.path_steps]]
    e2 = mod.from_bidirected(e.to_bidirected())
    out.append([e2.get_path_sequence(k) for k in range(len(e2.path_names))])
    return out


@pytest.mark.parametrize("build", [_build_linear, _build_branching])
def test_embedded_graph_equals_jax(build):
    assert _embedded_trace(temb, build) == _embedded_trace(jemb, build)


def test_layout_variants_equal_jax():
    rng = np.random.default_rng(1)
    perm = rng.permutation(12) + 1
    graphs = []
    for cls in (BidirectedGraph, JaxGraph):
        g = cls()
        for nid in perm:
            g.add_node(int(nid), b"ACGT")
        g.add_path("p", np.array([H(int(x)) for x in perm], dtype=np.int64))
        graphs.append(g)
    for name, iters in (("linear_sgd_order", 100), ("simple_sgd_order", 200)):
        got = getattr(tvar, name)(graphs[0], iterations=iters)
        assert got == getattr(jvar, name)(graphs[1], iterations=iters)
        ids = [h >> 1 for h in got]
        assert ids in ([int(x) for x in perm], [int(x) for x in perm][::-1]), name


# -- range builder ---------------------------------------------------------------


def _graph_key(g):
    return (sorted((k, bytes(v)) for k, v in g.nodes.items()), [(p.name, p.steps.tolist()) for p in g.paths],
            sorted(map(tuple, np.asarray(sorted(g.edges)).tolist())) if g.edges else [])


CASES = [
    ([("s1", b"ACGTACGT"), ("s2", b"TTGG")], []),
    ([("s1", b"ACGTACGT")], [(2, 6, 2, 6, False)]),
    ([("a", b"ACGTACGTAC"), ("b", b"ACGTTCGTAC")], [(0, 5, 10, 15, False), (10, 15, 0, 5, False)]),
]


@pytest.mark.parametrize("named,ranges", CASES)
def test_range_builder_equals_jax(named, ranges):
    graphs = []
    for mod in (trb, jrb):
        b = mod.RangeBasedGraphBuilder()
        for name, s in named:
            b.add_sequence(name, s)
        for r in ranges:
            b.add_alignment_range(mod.AlignmentRange(*r))
        graphs.append(b.build_graph())
    assert _graph_key(graphs[0]) == _graph_key(graphs[1])


def test_ranges_from_runner_alignments_equal_jax():
    named = [("a", b"ACGTACGTACGTACGT"), ("b", b"ACGTACGAACGTACGT")]
    pairs = np.array([[0, 1], [1, 0]])
    seqs_t = make_sequence_set(named)
    res_t = WfaAligner(seqs_t, RunnerConfig(scores=AlignmentScores.parse(SCORES)), device="cpu").align_pairs(pairs)
    seqs_j = jax_seqs(named)
    res_j = JaxAligner(seqs_j, JaxRunnerConfig(scores=JaxScores.parse(SCORES))).align_pairs(pairs)
    got = trb.ranges_from_alignments(res_t, seqs_t)
    want = jrb.ranges_from_alignments(res_j, seqs_j)
    assert got and [tuple(vars(r).values()) for r in got] == [tuple(vars(r).values()) for r in want]


# -- tools ------------------------------------------------------------------------


def test_simple_align_equals_jax(tmp_path):
    fa = tmp_path / "in.fa"
    fam = [("x", rand_seq(80, 3)), ("y", rand_seq(80, 3)), ("z", rand_seq(120, 4))]
    fa.write_text("".join(f">{n}\n{s.decode()}\n" for n, s in fam))
    out_t, out_j = tmp_path / "t.paf", tmp_path / "j.paf"
    assert tsimple.main([str(fa), str(out_t), "--device", "cpu"]) == 0
    assert jsimple.main([str(fa), str(out_j), "--device", "cpu"]) == 0
    assert out_t.read_bytes() == out_j.read_bytes()
    assert "cg:Z:80=" in out_t.read_text().splitlines()[0]


def test_sgd_diagnostics_equals_jax(tmp_path, capsys):
    fam = [("a", rand_seq(100, 4)), ("b", rand_seq(100, 4)), ("c", rand_seq(140, 5))]
    gfa = tmp_path / "g.gfa"
    sr = SeqRushTPU(jax_seqs(fam), JaxArgs(output=str(gfa)))
    sr.align_and_unite()
    sr.write_gfa()
    text = gfa.read_text()
    top_t, rows_t = tdiag.diagnostics(parse_gfa(text), 5)
    from seqrush_tpu.graph.bigraph import parse_gfa as jax_parse_gfa

    top_j, rows_j = jdiag.diagnostics(jax_parse_gfa(text), 5)
    assert top_t == top_j and rows_t == rows_j
    assert tdiag.main([str(gfa)]) == 0
    out_t = capsys.readouterr().out
    assert jdiag.main([str(gfa)]) == 0
    assert out_t == capsys.readouterr().out and "step transitions" in out_t


def test_validate_zoo_synthetic_on_cpu(capsys):
    """validate_zoo --synthetic 2 --device cpu (seed 142, two small genes):
    both graphs pass; the genes are the JAX tool's."""
    rng_t, rng_j = np.random.default_rng(142), np.random.default_rng(142)
    for i in range(2):
        assert tzoo.synth_gene(i, rng_t) == jzoo.synth_gene(i, rng_j)
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    assert tzoo.synth_gene_extended(0, rng_t) == jzoo.synth_gene_extended(0, rng_j)
    assert tzoo.main(["--synthetic", "2", "--device", "cpu", "--seed", "142"]) == 0
    out = capsys.readouterr().out
    assert "2/2 graphs pass" in out
