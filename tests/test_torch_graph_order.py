"""The port's host-numpy graph modules against their seqrush_tpu originals,
exactly: the completed BidirectedGraph, parse_gfa, groom, the topological
sorts, the bubble-chain order, layout_quality, isomorphic and graph_stats.
The same seeded variation graph goes into both packages as GFA text; every
order, flip set, renumbered graph and metric must be equal."""

import io

import numpy as np
import pytest

from seqrush_tpu.graph import bigraph as jbig
from seqrush_tpu.graph import groom as jgroom
from seqrush_tpu.graph import toposort as jtopo
from seqrush_tpu.layout import bubbles as jbub
from seqrush_tpu.tools import isomorphic as jiso
from seqrush_tpu.tools import measure_layout_quality as jmlq
from seqrush_tpu.tools import stats as jstats
from seqrush_tpu_torch.graph import bigraph as pbig
from seqrush_tpu_torch.graph import groom as pgroom
from seqrush_tpu_torch.graph import toposort as ptopo
from seqrush_tpu_torch.layout import bubbles as pbub
from seqrush_tpu_torch.tools import isomorphic as piso
from seqrush_tpu_torch.tools import measure_layout_quality as pmlq
from seqrush_tpu_torch.tools import stats as pstats

SEEDS = [0, 1, 2, 3]


def variation_gfa(seed: int, n_nodes: int = 120, n_paths: int = 5) -> str:
    """GFA text of a seeded variation graph: a backbone of ``n_nodes`` short
    segments under shuffled ids; every path walks it with its own skipped
    segments (deletions), alternative segments (SNP bubbles), one block
    walked backwards on the reverse strand (an inversion) for some paths,
    and a repeated block (a cycle); a tenth of the segments are stored
    reverse-complemented, so every path visits them as ``-``."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(1, 2 * n_nodes + 1))
    main, alt = ids[:n_nodes], ids[n_nodes:]
    has_alt = rng.random(n_nodes) < 0.2
    stored_rev = rng.random(n_nodes) < 0.1
    g = jbig.BidirectedGraph()
    for k in range(n_nodes):
        seq = bytes(rng.choice(list(b"ACGT"), size=int(rng.integers(1, 7))).astype(np.uint8))
        g.add_node(int(main[k]), seq)
        if has_alt[k]:
            g.add_node(int(alt[k]), bytes(rng.choice(list(b"ACGT"), size=1).astype(np.uint8)))
    for p in range(n_paths):
        steps = []
        for k in range(n_nodes):
            if 0 < k < n_nodes - 1 and rng.random() < 0.05:
                continue  # deletion
            if has_alt[k] and rng.random() < 0.5:
                steps.append((int(alt[k]), False))
            else:
                steps.append((int(main[k]), bool(stored_rev[k])))
        if p % 2 == 1:  # inversion of a middle block
            a, b = len(steps) // 3, len(steps) // 3 + int(rng.integers(4, 12))
            steps[a:b] = [(n, not r) for n, r in reversed(steps[a:b])]
        if p == 0:  # tandem repeat
            a = 2 * len(steps) // 3
            steps[a:a] = steps[a : a + 5]
        g.build_path(f"path{p}", steps)
    visited = {int(h) >> 1 for path in g.paths for h in path.steps}
    g.nodes = {n: seq for n, seq in g.nodes.items() if n in visited}
    g.verify_path_edges()
    return g.to_gfa_string()


def _both(seed, **kw):
    text = variation_gfa(seed, **kw)
    return jbig.parse_gfa(text), pbig.parse_gfa(text)


def _same_graph(jg, g):
    assert list(jg.nodes) == list(g.nodes)
    assert all((jg.nodes[n] == g.nodes[n]).all() for n in g.nodes)
    assert list(jg.edges) == list(g.edges)
    assert [p.name for p in jg.paths] == [p.name for p in g.paths]
    assert all((a.steps == b.steps).all() for a, b in zip(jg.paths, g.paths))
    assert jg.to_gfa_string() == g.to_gfa_string()


@pytest.mark.parametrize("seed", SEEDS)
def test_parse_gfa_and_queries_equal(seed):
    text = variation_gfa(seed)
    jg, g = jbig.parse_gfa(text), pbig.parse_gfa(io.StringIO(text))
    _same_graph(jg, g)
    assert g.to_gfa_string() == text
    assert jg.node_ids() == g.node_ids()
    assert (jg.edge_array() == g.edge_array()).all()
    assert jg.node_lengths() == g.node_lengths()
    assert jg.all_path_hashes() == g.all_path_hashes()
    assert jg.find_head_nodes() == g.find_head_nodes()
    assert jg.find_tail_nodes() == g.find_tail_nodes()
    assert jg.build_path_position_map() == g.build_path_position_map()
    assert jg.validate_consistency() == g.validate_consistency() == []
    originals = {p.name: g.path_sequence(p).tobytes() for p in g.paths}
    assert jg.comprehensive_verify(originals) == g.comprehensive_verify(originals) == []
    for h in list(g.paths[0].steps[:20]) + [int(g.paths[1].steps[3]) ^ 1]:
        assert jg.edges_from(h) == g.edges_from(h)
        assert jg.edges_to(h) == g.edges_to(h)
    a, b = (int(h) for h in g.paths[0].steps[:2])
    assert g.has_edge(a, b) and g.has_edge(b ^ 1, a ^ 1)
    assert jg.has_edge(a, a ^ 1) == g.has_edge(a, a ^ 1)


def test_comprehensive_verify_reports_the_same_faults():
    jg, g = _both(0)
    for graph in (jg, g):
        f, t = next(iter(graph.edges))
        del graph.edges[(f, t)]  # a path step loses its edge
        graph.add_node(9999, b"ACGT")  # an orphan
        graph.edges[(9999 << 1, 9999 << 1)] = None  # a spurious self-loop
        graph.edges[(1 << 20, 9999 << 1)] = None  # an edge from nowhere
    want = jg.comprehensive_verify({"path0": b"not it"})
    assert g.comprehensive_verify({"path0": b"not it"}) == want
    assert len(want) >= 5


@pytest.mark.parametrize("seed", SEEDS)
def test_apply_ordering_and_flip_nodes_equal(seed):
    jg, g = _both(seed)
    rng = np.random.default_rng(seed)
    order = [int(n) << 1 for n in rng.permutation(sorted(g.nodes))]
    flips = {int(n) for n in rng.choice(np.arange(1, g.node_count() + 1), size=15, replace=False)}
    before = g.all_path_hashes()
    for graph in (jg, g):
        graph.apply_ordering(order)
        graph.flip_nodes(flips)
        graph.apply_ordering([])
        graph.flip_nodes(set())
    _same_graph(jg, g)
    assert sorted(g.nodes) == list(range(1, g.node_count() + 1))
    assert g.all_path_hashes() == before


def test_build_path_equal():
    jg, g = jbig.BidirectedGraph(), pbig.BidirectedGraph()
    for graph in (jg, g):
        graph.add_node(1, b"AC")
        graph.add_node(2, bytearray(b"G"))
        graph.build_path("p", [(1, False), (2, True), (1, True)])
    _same_graph(jg, g)
    assert g.path_sequence(g.paths[0]).tobytes() == b"ACCGT"


@pytest.mark.parametrize("seed", SEEDS)
def test_groom_equal(seed):
    jg, g = _both(seed)
    want = jgroom.groom_order(jg)
    got = pgroom.groom_order(g)
    assert got == want
    assert any(h & 1 for h in got)  # the generator stores some nodes reversed
    jgroom.apply_grooming(jg, want)
    pgroom.apply_grooming(g, got)
    _same_graph(jg, g)
    for use_coverage in (False, True):
        assert pgroom.groom_order_dfs(g, use_coverage) == jgroom.groom_order_dfs(jg, use_coverage)
    assert pgroom.iterative_groom(g) == jgroom.iterative_groom(jg)
    _same_graph(jg, g)


@pytest.mark.parametrize("seed", SEEDS)
def test_groom_and_sort_groom_sort_equal(seed):
    jg, g = _both(seed)
    jgroom.groom(jg)
    pgroom.groom(g)
    _same_graph(jg, g)
    jg, g = _both(seed)
    jgroom.sort_groom_sort(jg)
    pgroom.sort_groom_sort(g)
    _same_graph(jg, g)


@pytest.mark.parametrize("seed", SEEDS)
def test_topological_orders_equal(seed):
    jg, g = _both(seed)
    for heads, tails in [(True, False), (False, False), (True, True)]:
        assert ptopo.exact_odgi_topological_order(g, heads, tails) == \
            jtopo.exact_odgi_topological_order(jg, heads, tails)
    for stall in (0, 2, 8, 64):
        assert ptopo.sgd_stable_topological_order(g, stall) == \
            jtopo.sgd_stable_topological_order(jg, stall)
    assert ptopo.strongly_connected_components(g) == jtopo.strongly_connected_components(jg)
    assert ptopo.cycle_tolerant_topological_order(g) == jtopo.cycle_tolerant_topological_order(jg)
    jtopo.apply_exact_odgi_ordering(jg)
    ptopo.apply_exact_odgi_ordering(g)
    _same_graph(jg, g)


@pytest.mark.parametrize("seed", SEEDS)
def test_bubble_chain_order_equal(seed):
    jg, g = _both(seed)
    assert pbub.bubble_chain_order(g) == jbub.bubble_chain_order(jg)
    # after groom and a topological renumbering, where ygs_sort calls it
    for graph, groom, topo in ((jg, jgroom, jtopo), (g, pgroom, ptopo)):
        groom.groom(graph)
        topo.apply_exact_odgi_ordering(graph)
    want = jbub.bubble_chain_order(jg)
    assert pbub.bubble_chain_order(g) == want
    assert want is not None


def test_bubble_chain_order_none_without_anchors():
    for mod, big in ((jbub, jbig), (pbub, pbig)):
        g = big.BidirectedGraph()
        g.add_node(1, b"A")
        g.add_node(2, b"C")
        g.add_path("a", np.array([2, 4, 2]))
        g.add_path("b", np.array([4, 2, 4]))
        g.verify_path_edges()
        assert mod.bubble_chain_order(g) is None


@pytest.mark.parametrize("seed", SEEDS)
def test_layout_quality_equal(seed):
    jg, g = _both(seed)
    want = jmlq.layout_quality(jg)
    assert pmlq.layout_quality(g) == want
    assert want["rmse"] > 0
    order = ptopo.exact_odgi_topological_order(g, True, False)
    assert pmlq.layout_quality(g, order) == jmlq.layout_quality(jg, order)
    g.apply_ordering(order)
    assert pmlq.layout_quality(g)["rmse"] == jmlq.layout_quality(jg, order)["rmse"]


@pytest.mark.parametrize("seed", SEEDS)
def test_isomorphic_equal(seed):
    jg, g = _both(seed)
    assert piso.canonical_form(g) == jiso.canonical_form(jg)
    text = g.to_gfa_string()
    rng = np.random.default_rng(seed)
    g.apply_ordering([int(n) << 1 for n in rng.permutation(sorted(g.nodes))])
    g.flip_nodes({3, 5, 8})
    moved = g.to_gfa_string()
    assert moved != text
    assert piso.isomorphic_gfa(text, moved) == jiso.isomorphic_gfa(text, moved) == (True, "isomorphic")
    # break one path step, one node's sequence, one edge: the same first difference
    p0 = g.paths[0].steps.copy()
    g.paths[0].steps = np.concatenate([p0[:7], p0[8:]])
    broken = g.to_gfa_string()
    assert piso.isomorphic_gfa(text, broken) == jiso.isomorphic_gfa(text, broken)
    assert not piso.isomorphic_gfa(text, broken)[0]
    g.paths[0].steps = p0
    nid = int(p0[0]) >> 1
    g.nodes[nid] = np.frombuffer(b"N" + g.nodes[nid].tobytes(), dtype=np.uint8)
    broken = g.to_gfa_string()
    assert piso.isomorphic_gfa(text, broken) == jiso.isomorphic_gfa(text, broken)
    assert "sequences differ" in piso.isomorphic_gfa(text, broken)[1]


def test_isomorphic_cli(tmp_path, capsys):
    text = variation_gfa(1)
    a, b = tmp_path / "a.gfa", tmp_path / "b.gfa"
    a.write_text(text)
    g = pbig.parse_gfa(text)
    g.flip_nodes({int(g.paths[0].steps[0]) >> 1})
    b.write_text(g.to_gfa_string())
    assert piso.main([str(a), str(b)]) == 0
    g.add_node(99999, b"A")
    b.write_text(g.to_gfa_string())
    assert piso.main([str(a), str(b)]) == 1
    assert piso.main([str(a)]) == 2
    capsys.readouterr()


@pytest.mark.parametrize("seed", SEEDS)
def test_graph_stats_equal(seed):
    jg, g = _both(seed)
    assert pstats.graph_stats(g) == jstats.graph_stats(jg)


def test_stats_and_quality_clis(tmp_path, capsys):
    import json

    path = tmp_path / "g.gfa"
    path.write_text(variation_gfa(2))
    assert pstats.main([str(path), "--json"]) == 0
    port_out = capsys.readouterr().out
    assert jstats.main([str(path), "--json"]) == 0
    assert json.loads(port_out) == json.loads(capsys.readouterr().out)
    assert pmlq.main([str(path), "--json"]) == 0
    port_out = capsys.readouterr().out
    assert jmlq.main([str(path), "--json"]) == 0
    assert json.loads(port_out) == json.loads(capsys.readouterr().out)
