"""The host half of the SGD tick kernel's launch (seqrush_tpu_torch/layout/
sgd.py::ticks_plan, tick_blocks), on the CPU: the chunk size and the count
matrix's bytes, the digit passes of the counting sort, whether H is staged in
shared memory, the grid from an occupancy figure, and one launch a block of
tick_plan's ticks.  The kernel itself runs on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3d)."""

import pytest
import torch

from seqrush_tpu_torch.layout import sgd
from seqrush_tpu_torch.tools.headline import synth_hla, synth_variation_graph
from seqrush_tpu_torch.tools.sgd_timing import _setup

# the headline graph's SGD (chip_smoke.py phase 3): 2,904 nodes and 45,623
# path steps; its paths spell synth_hla()'s sequences, so the space is the
# longest of them
HEADLINE_NODES, HEADLINE_STEPS = 2904, 45623


def _shapes(kind):
    """(nodes, tick width, space, block ticks) of a graph's SGD."""
    if kind == "headline":
        params = sgd.PathSGDParams()
        _n_sub, width, block = sgd.tick_plan(HEADLINE_STEPS, HEADLINE_STEPS, params)
        return HEADLINE_NODES, width, max(len(s) for _n, s in synth_hla()), block
    g = synth_variation_graph(loop_visits=20 if kind == "looped" else 0)
    plan = _setup(g, "cpu")[1]
    return plan.x0.shape[0], plan.u_per_sub, plan.tables.space, plan.block_ticks


@pytest.mark.parametrize("kind", ["headline", "paths_1000", "looped"])
def test_count_matrix_fits_its_budget(kind):
    """One pass by node id; the smallest chunk (256 terms, doubled) whose
    count matrix [bins][chunks] fits the budget; H staged, and the positions
    where a chunk has more terms than a block has threads."""
    n, width, space, block = _shapes(kind)
    p = sgd.ticks_plan(n, width, space, block)
    assert (p.passes, p.digit_bits, p.bins) == (1, 0, n)
    assert p.chunks * p.chunk == 2 * width and p.count_bytes == p.chunks * p.bins * 4
    assert p.count_bytes <= sgd.COUNT_BUDGET_BYTES
    assert p.chunk == sgd.TICK_THREADS or 2 * width // (p.chunk // 2) * p.bins * 4 > sgd.COUNT_BUDGET_BYTES
    assert p.stage_h and p.stage_x == (kind != "headline")
    assert p.smem_bytes == sgd.FOLD_SMEM_BYTES + 2 * n * 4 + (space + 1) * 4 + (n * 4 if p.stage_x else 0)
    want = {"headline": (8192, 256, 743424), "paths_1000": (262144, 1024, 5404672),
            "looped": (262144, 1024, 5406720)}[kind]
    assert (width, p.chunk, p.count_bytes) == want


@pytest.mark.parametrize("n_nodes, passes", [(sgd.MAX_BINS, 1), (sgd.MAX_BINS + 1, 2), (100_000, 2),
                                             ((1 << 24) + 1, 3)])
def test_large_graph_takes_digit_passes(n_nodes, passes):
    """More nodes than one pass's bins: passes by digits of the node id, as
    many bits a digit as fit the bins, enough passes for the largest id."""
    p = sgd.ticks_plan(n_nodes, 8192, 3300, 400)
    assert p.passes == passes
    if passes > 1:
        assert p.digit_bits == 12 and p.bins == 4096 and 1 << p.digit_bits <= sgd.MAX_BINS
        assert p.digit_bits * p.passes >= (n_nodes - 1).bit_length() > p.digit_bits * (p.passes - 1)
    assert p.count_bytes <= sgd.COUNT_BUDGET_BYTES and not p.stage_x  # one term a thread
    assert p.smem_bytes == sgd.FOLD_SMEM_BYTES + 2 * p.bins * 4 + 3301 * 4 + (n_nodes * 4 if p.stage_x else 0)


def test_small_budgets_force_passes_and_chunks(monkeypatch):
    """The card tests' plans, the module's budgets read at each call: 4 bins
    take digits of 2 bits; a count budget of 0 leaves the chunk at the
    tick's width, one chunk a side."""
    monkeypatch.setattr(sgd, "MAX_BINS", 4)
    p = sgd.ticks_plan(40, 1024, 50, 800)
    assert (p.passes, p.digit_bits, p.bins, p.chunk, p.chunks) == (3, 2, 4, 256, 8)
    p = sgd.ticks_plan(10, 128, 50, 800)
    assert (p.passes, p.digit_bits, p.bins, p.chunk, p.chunks) == (2, 2, 4, 128, 2)
    monkeypatch.setattr(sgd, "COUNT_BUDGET_BYTES", 0)
    p = sgd.ticks_plan(2640, 262144, 3365, 16)
    assert (p.passes, p.chunk, p.chunks) == (6, 262144, 2)
    monkeypatch.setattr(sgd, "MAX_BINS", 6144)
    p = sgd.ticks_plan(2640, 262144, 3365, 16)
    assert (p.passes, p.bins, p.chunk, p.chunks, p.count_bytes) == (1, 2640, 262144, 2, 21120)


@pytest.mark.parametrize("width", [1, 32, 128])
def test_narrow_ticks_take_one_chunk_a_side(width):
    p = sgd.ticks_plan(10, width, 20, 800)
    assert (p.chunk, p.chunks, p.count_bytes) == (width, 2, 80)


def test_h_staged_where_it_fits():
    words = sgd.H_SMEM_BYTES // 4
    fit = sgd.ticks_plan(100, 1024, words - 1, 1)
    over = sgd.ticks_plan(100, 1024, words, 1)
    assert fit.stage_h and fit.smem_bytes == sgd.FOLD_SMEM_BYTES + 800 + sgd.H_SMEM_BYTES
    assert not over.stage_h and over.smem_bytes == sgd.FOLD_SMEM_BYTES + 800


@pytest.mark.parametrize("width, budget, staged", [(1024, sgd.COUNT_BUDGET_BYTES, False), (1024, 0, True),
                                                    (256, 0, False), (1 << 20, sgd.COUNT_BUDGET_BYTES, True)])
def test_positions_staged_where_they_fit_and_pay(monkeypatch, width, budget, staged):
    """The positions are staged where a chunk has more terms than a block has
    threads (width 1,024 at the default budget has chunks of 256; a budget of
    0 makes one chunk of the width) and they fit their share."""
    monkeypatch.setattr(sgd, "COUNT_BUDGET_BYTES", budget)
    nodes = sgd.X_SMEM_BYTES // 4
    fit = sgd.ticks_plan(nodes, width, 100, 1)
    over = sgd.ticks_plan(nodes + 1, width, 100, 1)
    assert fit.stage_x == staged and not over.stage_x
    assert fit.smem_bytes == sgd.FOLD_SMEM_BYTES + 2 * fit.bins * 4 + 404 + (nodes * 4 if staged else 0)
    assert over.smem_bytes == sgd.FOLD_SMEM_BYTES + 2 * over.bins * 4 + 404


@pytest.mark.parametrize("blocks_per_sm, sms", [(0, 0), (1, 132), (3, 132), (2, 114)])
def test_grid_from_the_occupancy_figure(blocks_per_sm, sms):
    p = sgd.ticks_plan(2904, 8192, 3300, 400, blocks_per_sm, sms)
    assert (p.blocks_per_sm, p.grid) == (blocks_per_sm, blocks_per_sm * sms)
    assert p._replace(blocks_per_sm=0, grid=0) == sgd.ticks_plan(2904, 8192, 3300, 400)


@pytest.mark.parametrize("kind", ["headline", "paths_1000"])
def test_one_launch_a_block_of_tick_plans_ticks(kind):
    """The run's blocks of draws, one launch each, are tick_plan's
    block_ticks ticks, in order, covering every tick once: 2 of 400 on the
    headline, 50 of 16 at 1,000 paths."""
    n, width, space, block = _shapes(kind)
    n_ticks = sgd.PathSGDParams().iter_max * sgd.PathSGDParams().n_sub
    blocks = sgd.tick_blocks(n_ticks, block)
    assert len(blocks) == {"headline": 2, "paths_1000": 50}[kind]
    assert all(b == block for _lo, b in blocks) and [lo for lo, _b in blocks] == list(range(0, n_ticks, block))
    assert sgd.ticks_plan(n, width, space, block).block_ticks == block
    assert sgd.tick_blocks(n_ticks, 0) == [(0, n_ticks)]
    assert sgd.tick_blocks(10, 4) == [(0, 4), (4, 4), (8, 2)]


@pytest.mark.parametrize("args", [(0, 8, 10), (5, 0, 10), (5, 8, 0)])
def test_plan_refuses_what_the_kernel_cannot_run(args):
    """No nodes, no terms or no space."""
    with pytest.raises(ValueError):
        sgd.ticks_plan(*args, 1)


@pytest.mark.parametrize("width, budget, chunk", [(24, sgd.COUNT_BUDGET_BYTES, 24), (341, sgd.COUNT_BUDGET_BYTES, 256),
                                                  (341, 0, 512), (5461, sgd.COUNT_BUDGET_BYTES, 256),
                                                  (5461, 0, 8192), (21845, sgd.COUNT_BUDGET_BYTES, 256)])
def test_any_width_pads_each_sides_last_chunk(monkeypatch, width, budget, chunk):
    """A width that is no power of two (n_sub = 3 makes tick_plan's 341 on a
    small graph and 21,845 on the headline) is planned, not refused: each
    side of cat([i, j]) takes ceil(width / C) chunks, its last one part
    padding, and a budget of 0 takes the first chunk that covers the
    width."""
    monkeypatch.setattr(sgd, "COUNT_BUDGET_BYTES", budget)
    p = sgd.ticks_plan(120, width, 500, 1)
    assert (p.chunk, p.chunks) == (chunk, 2 * -(-width // chunk))
    assert p.count_bytes == p.chunks * p.bins * 4 and 0 <= p.chunks * p.chunk - 2 * width < 2 * chunk
    if width == 21845:
        n_sub, u, _block = sgd.tick_plan(HEADLINE_STEPS, HEADLINE_STEPS, sgd.PathSGDParams(n_sub=3))
        assert (n_sub, u) == (3, width)


def test_kernel_records_hold_the_plain_tables():
    """The tick kernel reads a step's node, path, rank and position as one
    int32 record and a path's first step and count as another
    (sgd.kernel_tables, made by make_tables on a GPU only): the same values
    as the plain tick's tables, the position bit for bit, and the learning
    rates."""
    plan = _setup(synth_variation_graph(n_paths=12, length=600, n_sites=120, loop_visits=3), "cpu")[1]
    assert plan.tables.kernel is None
    t, k = plan.tables, sgd.kernel_tables(plan.tables)
    assert torch.equal(k.etas, torch.from_numpy(t.etas)) and k.etas.dtype == torch.float32
    assert k.step_rec.dtype == k.path_rec.dtype == torch.int32 and k.step_rec.is_contiguous()
    assert k.step_rec.shape == (plan.n_steps, 4) and k.path_rec.shape == (t.path_first.shape[0], 2)
    for col, table in enumerate((t.node_of_step, t.step_path, t.step_rank)):
        assert torch.equal(k.step_rec[:, col].long(), table)
    assert torch.equal(k.step_rec[:, 3], t.step_pos.view(torch.int32))
    assert torch.equal(k.path_rec[:, 0].long(), t.path_first) and torch.equal(k.path_rec[:, 1].long(), t.path_count)
