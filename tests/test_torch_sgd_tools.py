"""The SGD timing tool's bound and the synthetic 1,000-haplotype graph, on
the CPU (their card runs are in chip_smoke.py phase 3d and
tests/test_torch_cuda.py)."""

import numpy as np
import pytest

from seqrush_tpu_torch.layout import sgd
from seqrush_tpu_torch.tools.headline import synth_variation_graph
from seqrush_tpu_torch.tools.sgd_timing import FIELD_BYTES, TERM_DRAW_BYTES, _setup, tick_bytes


def _plan(n_paths, loop_visits=0):
    g = synth_variation_graph(n_paths=n_paths, length=600, n_sites=120, loop_visits=loop_visits)
    return g, _setup(g, "cpu")[1]


@pytest.mark.parametrize("width", [64, 1 << 20])
def test_tick_bytes_charges_each_table_at_most_its_size(width):
    """Each table the terms gather from costs its reads a term times the
    terms, or its size where that is less, at 4 B a field (the tick
    kernel's int32 and float32 records); the draws are read once a term and
    the positions once each way."""
    _g, plan = _plan(30)
    plan = plan._replace(u_per_sub=width)
    t = plan.tables
    probes = int(t.space + 1).bit_length() + 1
    reads = ((t.node_of_step, 2), (t.step_pos, 2), (t.step_path, 1), (t.step_rank, 1),
             (t.path_first, 1), (t.path_count, 1), (t.Hmain, probes))
    want = width * TERM_DRAW_BYTES + 2 * 4 * plan.x0.numel()
    assert FIELD_BYTES == 4
    want += sum(min(r * width, a.numel()) * 4 for a, r in reads)
    assert tick_bytes(plan) == want
    if width > t.node_of_step.numel():
        tables = sum(a.numel() * 4 for a, _r in reads)
        assert tick_bytes(plan) - width * TERM_DRAW_BYTES - 8 * plan.x0.numel() == tables


def test_synth_variation_graph_loop():
    """loop_visits adds one node that every path visits K times in a row,
    after the middle backbone segment, and nothing else."""
    g0 = synth_variation_graph(n_paths=12, length=600, n_sites=120)
    g = synth_variation_graph(n_paths=12, length=600, n_sites=120, loop_visits=7)
    assert len(g.nodes) == len(g0.nodes) + 1
    loop = max(g.nodes)
    for p, p0 in zip(g.paths, g0.paths):
        ids = p.steps >> 1
        at = np.flatnonzero(ids == loop)
        assert at.size == 7 and np.all(np.diff(at) == 1)
        assert np.array_equal(np.delete(p.steps, at), p0.steps)
    steps = np.bincount(np.concatenate([p.steps >> 1 for p in g.paths]))
    assert steps.max() == steps[loop] == 7 * 12


def test_long_node_plan_on_cpu_runs_plain():
    """The looped graph lays out on the CPU (the plain tick) with finite
    positions."""
    g, plan = _plan(8, loop_visits=40)
    x = sgd._sgd_run(plan.x0, plan.tables, 7, plan.n_steps, plan.n_sub, plan.u_per_sub, plan.block_ticks)
    assert x.shape == plan.x0.shape and bool(x.isfinite().all())
