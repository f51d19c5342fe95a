"""seqrush_tpu_torch.ops.unionfind (torch, on the CPU here) against
seqrush_tpu.ops.unionfind on random edge lists: equal parent arrays (exact:
roots are component minima whatever the edge order) and equal counts."""

import numpy as np
import pytest
import torch

from seqrush_tpu.ops import unionfind as juf
from seqrush_tpu_torch.ops import unionfind as tuf


def _random_edges(seed, n, m):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, size=m).astype(np.int64), rng.integers(0, n, size=m).astype(np.int64)


@pytest.mark.parametrize("seed,n,m", [(0, 50, 20), (1, 500, 300), (2, 2000, 1900), (3, 4000, 60)])
def test_unite_edges_matches_jax(seed, n, m):
    u, v = _random_edges(seed, n, m)
    ref = np.asarray(juf.unite_edges(juf.create(n), u, v))
    got = tuf.unite_edges(tuf.create(n, "cpu"), u, v)
    assert got.dtype == torch.int32
    assert (got.numpy() == ref).all()
    # roots are component minima and the array is fully compressed
    assert (got.numpy() <= np.arange(n)).all()
    assert (got.numpy()[got.numpy()] == got.numpy()).all()
    assert tuf.count_components_fast(got, n) == juf.count_components_fast(ref, n)
    assert tuf.count_components_fast(got.numpy(), n) == tuf.count_components_fast(got, n)


def test_unite_edges_incremental_and_empty():
    """Two flushes equal one flush of the concatenated edges; an empty edge
    list compresses and changes nothing else."""
    n = 1000
    u, v = _random_edges(5, n, 700)
    once = tuf.unite_edges(tuf.create(n, "cpu"), u, v)
    p = tuf.unite_edges(tuf.create(n, "cpu"), u[:350], v[:350])
    twice = tuf.unite_edges(p, torch.from_numpy(u[350:]), torch.from_numpy(v[350:]))
    assert torch.equal(once, twice)
    empty = np.zeros(0, np.int64)
    assert torch.equal(tuf.unite_edges(once, empty, empty), once)
    chain = torch.tensor([0, 0, 1, 2, 3], dtype=torch.int32)
    assert tuf.compress(chain).tolist() == [0, 0, 0, 0, 0]


def test_orientation_pre_unite_matches_jax():
    """The pipeline's F/R pre-unite of every offset, then a match run."""
    L = 300
    i = np.arange(L, dtype=np.int64)
    ref = juf.unite_edges(juf.create(2 * L + 2), i << 1, (i << 1) | 1)
    u, v = juf.match_region_pairs(0, 150, 10, 0, 40, True, 150)
    ref = np.asarray(juf.unite_edges(ref, u, v))
    got = tuf.unite_edges(tuf.create(2 * L + 2, "cpu"), i << 1, (i << 1) | 1)
    got = tuf.unite_edges(got, u, v)
    assert (got.numpy() == ref).all()
    assert tuf.count_components_fast(got, 2 * L) == juf.count_components_fast(ref, 2 * L)
