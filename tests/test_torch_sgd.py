"""seqrush_tpu_torch/layout/sgd.py against seqrush_tpu/layout/sgd.py.

The port draws from a torch generator, the JAX package from threefry keys,
so whole runs with their own draws differ.  What must agree:

* the host parts (PathIndex, the schedule, the tick shape, refine_positions,
  the ordering from given positions): exactly;
* the tick: ``sgd_tick`` fed the JAX package's own draws, re-derived here
  with ``jax.random`` as ``_sgd_run`` derives them, against ``_sgd_run``
  called with exact (unpadded) shapes.  Tolerances, in bp:
  after one iteration (n_sub ticks at the largest learning rate)
  max |x_port - x_jax| <= 1e-3; after all 100 iterations the node order by
  (position, id) is equal;
* a run with one seed twice on one device: bit-equal positions;
* the plain tick fed the JAX package's draws, run on the CPU: the JAX
  package's positions bit for bit, after 1 and after 100 iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrush_tpu.graph.bigraph import parse_gfa as jax_parse_gfa
from seqrush_tpu.layout import sgd as jsgd
from seqrush_tpu_torch.graph.bigraph import parse_gfa
from seqrush_tpu_torch.layout import sgd as psgd

from test_torch_graph_order import variation_gfa

ONE_ITERATION_TOL_BP = 1e-3
GRAPH_SEEDS = [0, 1, 2]


def _graphs(seed, **kw):
    text = variation_gfa(seed, **kw)
    return jax_parse_gfa(text), parse_gfa(text)


def _jax_draws(seed, n_ticks, width, n_steps):
    """The draws of seqrush_tpu/layout/sgd.py::_sgd_run.block for every
    tick, as numpy [n_ticks, width] arrays."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_ticks)
    ks = jax.vmap(lambda k: jax.random.split(k, 5))(keys)
    S = jnp.asarray(n_steps, dtype=jnp.int32)
    shape = (width,)
    step_idx = jax.vmap(lambda k: jax.random.randint(k, shape, 0, S))(ks[:, 0])
    coin_z = jax.vmap(lambda k: jax.random.randint(k, shape, 0, 2) == 1)(ks[:, 1])
    coin_b = jax.vmap(lambda k: jax.random.randint(k, shape, 0, 2) == 1)(ks[:, 2])
    u01 = jax.vmap(lambda k: jax.random.uniform(k, shape, dtype=jnp.float32))(ks[:, 3])
    u02 = jax.vmap(lambda k: jax.random.uniform(k, shape, dtype=jnp.float32))(ks[:, 4])
    return tuple(np.asarray(a) for a in (step_idx, coin_z, coin_b, u01, u02))


def _jax_setup(jgraph, params):
    """(x0, node ids, tick width, the other _sgd_run inputs) as
    seqrush_tpu/layout/sgd.py::path_linear_sgd derives them with bucket=False."""
    index = jsgd.PathIndex.from_graph(jgraph)
    node_ids = sorted(jgraph.nodes)
    id_to_idx = {nid: k for k, nid in enumerate(node_ids)}
    node_of_step = np.array([id_to_idx[int(h) >> 1] for h in index.step_handle], dtype=np.int32)
    sums = np.zeros(len(node_ids))
    cnts = np.zeros(len(node_ids))
    np.add.at(sums, node_of_step, index.step_pos.astype(np.float64))
    np.add.at(cnts, node_of_step, 1.0)
    x0 = (sums / np.maximum(cnts, 1.0)).astype(np.float32)
    mtu = int(index.path_count.sum())
    eta_max = float(int(index.path_count.max()) ** 2)
    space = max(int(index.path_len.max()), 1)
    etas = jsgd.sgd_schedule(1.0 / eta_max, 1.0, params.iter_max, 0, params.eps)
    i_arr = np.arange(1, space + 1, dtype=np.float64)
    Hmain = np.concatenate([[0.0], np.cumsum(i_arr ** (-params.theta))]).astype(np.float32)
    Hcool = np.concatenate([[0.0], np.cumsum(i_arr ** (-0.001))]).astype(np.float32)
    n_sub = params.n_sub
    u_per_sub = 1 << max(0, (max(1, -(-mtu // n_sub)) - 1).bit_length())
    tables = (
        jnp.asarray(node_of_step), jnp.asarray(index.step_pos),
        jnp.asarray(index.step_path), jnp.asarray(index.step_rank),
        jnp.asarray(index.path_first), jnp.asarray(index.path_count),
        jnp.asarray(Hmain), jnp.asarray(Hcool),
    )
    scalars = (
        jnp.asarray(int(np.floor(params.cooling_start * params.iter_max)), dtype=jnp.int32),
        params.seed, jnp.asarray(index.total_steps, dtype=jnp.int32),
        jnp.asarray(space, dtype=jnp.int32),
    )
    return x0, node_ids, u_per_sub, tables, etas.astype(np.float32), scalars


def _jax_run(jgraph, params, n_iters):
    """_sgd_run on exact shapes for the first ``n_iters`` iterations."""
    x0, node_ids, u_per_sub, tables, etas, scalars = _jax_setup(jgraph, params)
    x = jsgd._sgd_run(
        jnp.asarray(x0), *tables, jnp.asarray(etas[: n_iters + 1]), *scalars,
        n_sub=params.n_sub, u_per_sub=u_per_sub, block_ticks=0,
    )
    return np.asarray(x), node_ids, u_per_sub


def _port_run_with_jax_draws(graph, params, n_iters):
    plan = psgd.sgd_setup(graph, params, device="cpu")
    draws = _jax_draws(params.seed, n_iters * plan.n_sub, plan.u_per_sub, plan.n_steps)
    x = plan.x0
    for tick in range(n_iters * plan.n_sub):
        step_idx, coin_z, coin_b, u01, u02 = (torch.from_numpy(d[tick].copy()) for d in draws)
        x = psgd.sgd_tick(
            x, tick // plan.n_sub, step_idx.long(), coin_z, coin_b, u01, u02, plan.tables
        )
    return x.numpy(), [int(n) for n in plan.node_ids], plan.u_per_sub


@pytest.mark.parametrize("seed", GRAPH_SEEDS)
def test_path_index_and_setup_equal(seed):
    jg, g = _graphs(seed)
    ji, pi = jsgd.PathIndex.from_graph(jg), psgd.PathIndex.from_graph(g)
    for name in ("step_handle", "step_pos", "step_path", "step_rank",
                 "path_first", "path_count", "path_len"):
        a, b = getattr(ji, name), getattr(pi, name)
        assert a.dtype == b.dtype and (a == b).all(), name
    plan = psgd.sgd_setup(g, psgd.PathSGDParams(bucket=False), device="cpu")
    x0, node_ids, width, jtables, etas, _ = _jax_setup(jg, jsgd.PathSGDParams(bucket=False))
    assert [int(n) for n in plan.node_ids] == node_ids
    assert plan.u_per_sub == width and plan.n_ticks == 800
    assert (plan.x0.numpy() == x0).all()
    assert (plan.tables.etas == etas).all()
    for ours, theirs in zip(plan.tables[:8], jtables):
        assert (ours.numpy() == np.asarray(theirs)).all()


def test_schedule_and_ladder_equal():
    for args in [(1 / 400.0, 1.0, 100, 0, 0.01), (1 / 9.0, 1.0, 30, 3, 0.05)]:
        assert (jsgd.sgd_schedule(*args) == psgd.sgd_schedule(*args)).all()
    for n in (1, 15, 16, 17, 255, 1024, 1025, 5000, 16384, 16385, 100000):
        assert jsgd._bucket_pow2(n) == psgd._bucket_pow2(n)
        assert jsgd._tier(n, 1024, 16384) == psgd._tier(n, 1024, 16384)


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("n_steps,mtu", [(40, 40), (900, 900), (3000, 2000), (20000, 20000), (70000, 9)])
def test_tick_plan_matches_jax_formula(n_steps, mtu, bucket):
    """tick_plan against the arithmetic of seqrush_tpu/layout/sgd.py:361-381."""
    params = psgd.PathSGDParams(bucket=bucket)
    n_sub = 8
    u = 1 << max(0, (max(1, -(-mtu // n_sub)) - 1).bit_length())
    if bucket:
        u = max(u, jsgd._tier(n_steps, 1024, 16384) // n_sub)
    T = params.iter_max * n_sub
    block = T
    while block > 1 and block * u > (4 << 20):
        block = max(d for d in range(1, block) if T % d == 0)
    assert psgd.tick_plan(n_steps, mtu, params) == (n_sub, u, block)


@pytest.mark.parametrize("seed", GRAPH_SEEDS)
def test_tick_with_jax_draws_one_iteration(seed):
    jg, g = _graphs(seed)
    x_jax, ids_j, _ = _jax_run(jg, jsgd.PathSGDParams(bucket=False), 1)
    x_port, ids_p, _ = _port_run_with_jax_draws(g, psgd.PathSGDParams(bucket=False), 1)
    assert ids_j == ids_p
    assert np.isfinite(x_port).all()
    assert np.abs(x_port - x_jax).max() <= ONE_ITERATION_TOL_BP


@pytest.mark.parametrize("n_iters", [1, 100])
@pytest.mark.parametrize("seed", GRAPH_SEEDS)
def test_tick_with_jax_draws_bit_equal(seed, n_iters):
    """Fed the JAX package's draws, the plain tick on the CPU gives the JAX
    package's positions bit for bit, after one iteration and after all 100
    (800 ticks): both sum each node's terms in the order of cat([i, j]),
    with the same float32 operations.  The tick kernel is held to this
    plain tick bit for bit on the card (tests/test_torch_cuda.py)."""
    jg, g = _graphs(seed)
    x_jax, ids_j, _ = _jax_run(jg, jsgd.PathSGDParams(bucket=False), n_iters)
    x_port, ids_p, _ = _port_run_with_jax_draws(g, psgd.PathSGDParams(bucket=False), n_iters)
    assert ids_j == ids_p
    assert x_port.dtype == x_jax.dtype == np.float32
    assert (x_port.view(np.int32) == x_jax.view(np.int32)).all()


@pytest.mark.parametrize("seed", GRAPH_SEEDS)
def test_tick_with_jax_draws_full_run_same_order(seed):
    jg, g = _graphs(seed)
    x_jax, ids, _ = _jax_run(jg, jsgd.PathSGDParams(bucket=False), 100)
    x_port, _, _ = _port_run_with_jax_draws(g, psgd.PathSGDParams(bucket=False), 100)
    order_jax = sorted(range(len(ids)), key=lambda k: (x_jax[k], ids[k]))
    order_port = sorted(range(len(ids)), key=lambda k: (x_port[k], ids[k]))
    assert order_port == order_jax


def test_jax_package_run_equals_exact_shape_rerun():
    """The harness above is the JAX package's own run: path_linear_sgd with
    bucket=False gives the positions _jax_run gives."""
    jg, _ = _graphs(0)
    x_jax, ids, _ = _jax_run(jg, jsgd.PathSGDParams(bucket=False), 100)
    pos = jsgd.path_linear_sgd(jg, jsgd.PathSGDParams(bucket=False))
    assert [pos[n] for n in ids] == [float(v) for v in x_jax]


def test_bucket_changes_only_the_tick_width():
    """With an equal tick width, bucket on and off give bit-equal positions
    (the counterpart of tests/test_ygs.py::test_sgd_bucketing_bit_parity)."""
    _, g = _graphs(1, n_nodes=97)
    mtu = 1024
    on = psgd.path_linear_sgd(g, psgd.PathSGDParams(min_term_updates=mtu, bucket=True), "cpu")
    off = psgd.path_linear_sgd(g, psgd.PathSGDParams(min_term_updates=mtu, bucket=False), "cpu")
    assert on == off and len(on) == g.node_count()


def test_same_seed_same_positions_other_seed_other_positions():
    _, g = _graphs(2)
    a = psgd.path_linear_sgd(g, psgd.PathSGDParams(seed=7), "cpu")
    b = psgd.path_linear_sgd(g, psgd.PathSGDParams(seed=7), "cpu")
    c = psgd.path_linear_sgd(g, psgd.PathSGDParams(seed=8), "cpu")
    assert a == b
    assert a != c
    assert all(np.isfinite(v) for v in a.values())


def test_run_in_blocks_of_draws(monkeypatch):
    """A run whose draws are made 8 ticks at a time takes every tick once,
    in order, and is as reproducible as a run in one block."""
    _, g = _graphs(0)
    plan = psgd.sgd_setup(g, psgd.PathSGDParams(iter_max=6), device="cpu")
    seen = []
    tick = psgd.sgd_tick
    monkeypatch.setattr(psgd, "sgd_tick", lambda x, it, *a: (seen.append(it), tick(x, it, *a))[1])
    run = lambda block: psgd._sgd_run(
        plan.x0, plan.tables, 11, plan.n_steps, plan.n_sub, plan.u_per_sub, block
    )
    a, b = run(8), run(8)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert seen == 2 * [it for it in range(6) for _ in range(plan.n_sub)]
    assert run(0).shape == a.shape


def test_degenerate_graphs_give_no_positions():
    from seqrush_tpu_torch.graph.bigraph import BidirectedGraph

    g = BidirectedGraph()
    assert psgd.path_linear_sgd(g, psgd.PathSGDParams(), "cpu") == {}
    g.add_node(5, b"ACG")
    g.add_node(2, b"T")
    g.add_path("p", np.array([10]))
    assert psgd.path_linear_sgd(g, psgd.PathSGDParams(), "cpu") == {}
    assert psgd.path_sgd_sort(g, psgd.PathSGDParams(), device="cpu") == [4, 10]


def test_sgd_asks_for_cuda_by_default():
    _, g = _graphs(0)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psgd.path_linear_sgd(g, psgd.PathSGDParams())


@pytest.mark.parametrize("rounds", [0, 1, 4])
@pytest.mark.parametrize("seed", GRAPH_SEEDS)
def test_refine_positions_exact(seed, rounds):
    jg, g = _graphs(seed)
    rng = np.random.default_rng(seed)
    ids = sorted(g.nodes)
    # cumulative positions with a tenth of the nodes thrown far away
    pos, cum = {}, 0.0
    for n in ids:
        pos[n] = cum + (float(rng.integers(500, 5000)) if rng.random() < 0.1 else 0.0)
        cum += len(g.nodes[n])
    want = jsgd.refine_positions(jg, dict(pos), rounds)
    got = psgd.refine_positions(g, dict(pos), rounds)
    assert got == want
    if rounds:
        assert got != pos


@pytest.mark.parametrize("seed", GRAPH_SEEDS)
def test_sort_from_jax_positions_gives_jax_order(seed, monkeypatch):
    """path_sgd_sort's host half (refine, then order by (position, id)):
    given the JAX package's positions it returns the JAX package's order."""
    jg, g = _graphs(seed)
    jparams = jsgd.PathSGDParams()
    positions = jsgd.path_linear_sgd(jg, jparams)
    want = jsgd.path_sgd_sort(jg, jparams, refine_rounds=4)
    monkeypatch.setattr(psgd, "path_linear_sgd", lambda graph, params, device: dict(positions))
    got = psgd.path_sgd_sort(g, psgd.PathSGDParams(), refine_rounds=4, device="cpu")
    assert got == want
