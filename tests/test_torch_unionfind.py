"""seqrush_tpu_torch.ops.unionfind (torch, on the CPU here) against
seqrush_tpu.ops.unionfind on random edge lists and on the shaped cases of
tests/torch_uf_cases.py: equal parent arrays (exact: every component's root
is its smallest input root whatever the edge order) and equal counts.  The
plain versions (unite_edges_reference, compress_reference, find_reference)
are the yardsticks of the kernels in ops/csrc/unionfind.cu, which
tests/test_torch_cuda.py holds to them on the card."""

import jax
import numpy as np
import pytest
import torch

from seqrush_tpu.ops import unionfind as juf
from seqrush_tpu_torch.ops import nw_cuda
from seqrush_tpu_torch.ops import unionfind as tuf
from torch_uf_cases import random_forest, uf_cases


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


# -- the plain versions (the kernels' yardsticks) on shaped inputs --------------

CASES = uf_cases()


def _jax_parent(parent):
    return jax.numpy.asarray(parent)


@pytest.mark.parametrize("name", sorted(CASES))
def test_unite_cases_match_jax(name):
    """unite_edges_reference and the CPU dispatch of unite_edges against the
    JAX package's unite_edges, bit for bit (int32, tolerance 0): input
    forests that are not compressed and whose roots are not minima,
    self-loops and duplicates, a chain given in reverse order, a star, match
    runs on both strands after the F/R pre-unite, no edges."""
    parent, u, v = CASES[name]
    ref = np.asarray(juf.unite_edges(_jax_parent(parent), u, v))
    plain = tuf.unite_edges_reference(torch.from_numpy(parent.copy()), u, v)
    got = tuf.unite_edges(torch.from_numpy(parent.copy()), u, v)
    assert plain.dtype == got.dtype == torch.int32
    assert (plain.numpy() == ref).all()
    assert torch.equal(got, plain)
    assert (ref[ref] == ref).all()  # fully compressed


def test_forest_case_has_roots_that_are_not_minima():
    """The forest case holds what it is for: trees deeper than one hop, and
    a root above its tree's smallest slot."""
    parent = CASES["forest"][0]
    roots = np.asarray(juf.compress(_jax_parent(parent)))
    assert (parent[parent] != parent).any()
    smallest = {}
    for i, r in enumerate(roots):
        smallest.setdefault(int(r), i)
    assert any(r != m for r, m in smallest.items())


@pytest.mark.parametrize("name", sorted(CASES))
def test_compress_cases_match_jax(name):
    parent = CASES[name][0]
    ref = np.asarray(juf.compress(_jax_parent(parent)))
    plain = tuf.compress_reference(torch.from_numpy(parent.copy()))
    assert plain.dtype == torch.int32 and (plain.numpy() == ref).all()
    assert torch.equal(tuf.compress(torch.from_numpy(parent.copy())), plain)


@pytest.mark.parametrize("name", sorted(CASES))
def test_find_cases_match_jax(name):
    """find on each case's input forest, uncompressed, at every slot and at
    random positions given as a [2, k] array."""
    parent = CASES[name][0]
    n = parent.size
    rng = np.random.default_rng(n)
    for pos in (np.arange(n), rng.integers(0, n, (2, 37))):
        ref = np.asarray(juf.find(_jax_parent(parent), pos))
        plain = tuf.find_reference(torch.from_numpy(parent.copy()), pos)
        assert plain.dtype == torch.int32 and plain.shape == pos.shape
        assert (plain.numpy() == ref).all()
        assert torch.equal(tuf.find(torch.from_numpy(parent.copy()), pos), plain)


@pytest.mark.parametrize("name", sorted(CASES))
def test_shuffled_edges_give_the_same_parent(name):
    """The same edges in another order, each with its ends swapped at
    random: the same parent array, in the plain version and in JAX."""
    parent, u, v = CASES[name]
    rng = np.random.default_rng(7)
    perm = rng.permutation(u.size)
    swap = rng.integers(0, 2, u.size).astype(bool)
    u2 = np.where(swap, v, u)[perm]
    v2 = np.where(swap, u, v)[perm]
    once = tuf.unite_edges_reference(torch.from_numpy(parent.copy()), u, v)
    again = tuf.unite_edges_reference(torch.from_numpy(parent.copy()), u2, v2)
    assert torch.equal(once, again)
    assert (np.asarray(juf.unite_edges(_jax_parent(parent), u2, v2)) == once.numpy()).all()


def test_load_checkpoint_matches_jax(tmp_path):
    """pipeline.load_checkpoint (a unite of every slot with its saved parent
    from an identity start) on a saved parent that is an uncompressed forest
    with roots that are not minima: the JAX package's parent."""
    from seqrush_tpu.config import Args as JaxArgs
    from seqrush_tpu.pipeline import SeqRushTPU
    from seqrush_tpu.sequences import make_sequence_set as jax_seqs
    from seqrush_tpu_torch.config import Args
    from seqrush_tpu_torch.pipeline import SeqRushTorch
    from seqrush_tpu_torch.sequences import make_sequence_set

    rng = np.random.default_rng(11)
    named = [(f"s{k}", bytes(rng.choice(list(b"ACGT"), 40 + 7 * k).tolist())) for k in range(3)]
    n = 2 * sum(len(s) for _, s in named) + 2
    path = tmp_path / "uf.npy"
    np.save(path, random_forest(rng, n))
    jsr = SeqRushTPU(jax_seqs(named), JaxArgs(no_sort=True))
    jsr.load_checkpoint(str(path))
    psr = SeqRushTorch(make_sequence_set(named), Args(no_sort=True, device="cpu"))
    psr.load_checkpoint(str(path))
    assert psr.parent.dtype == torch.int32
    assert (psr.parent.numpy() == np.asarray(jsr.parent)).all()


def test_cpu_runs_no_kernel():
    """On the CPU every entry point takes the plain version: no launch is
    counted."""
    parent, u, v = CASES["forest"]
    before = dict(nw_cuda.LAUNCHES)
    p = tuf.unite_edges(torch.from_numpy(parent.copy()), u, v)
    tuf.compress(torch.from_numpy(parent.copy()))
    tuf.find(torch.from_numpy(parent.copy()), u)
    tuf.count_components(p)
    b = tuf.BidirectedUnionFind(20, device="cpu")
    b.pre_unite_orientations(20)
    b.unite(4, 9)
    assert b.same(4, 9)
    assert nw_cuda.LAUNCHES == before


@pytest.mark.parametrize("n_edges,n_slots,bps,sms,want", [
    (1_840_217, 164_952, 8, 132, 1056),  # the headline flush: the whole card, the grid strides
    (0, 164_952, 8, 132, 645),  # no edges: a thread a slot
    (1000, 50, 8, 132, 4),  # fewer slots than edges: a thread an edge
    (0, 1, 8, 132, 1),
    (50_000_000, 6_600_002, 6, 132, 792),  # fewer blocks an SM than the launch bound's
])
def test_unite_grid(n_edges, n_slots, bps, sms, want):
    """The unite's cooperative grid: a thread an edge or a slot, whichever
    are more, never more blocks than the card holds at once."""
    assert tuf.unite_grid(n_edges, n_slots, bps, sms) == want


def test_unite_grid_refuses_a_card_that_holds_no_block():
    with pytest.raises(ValueError):
        tuf.unite_grid(10, 10, 0, 132)


def test_uf_constants_equal_the_kernel():
    """UF_THREADS and the timer's count names (UF_COUNTS) are the ones
    csrc/unionfind.cu defines, in its order."""
    import re
    from pathlib import Path

    src = (Path(tuf.__file__).parent / "csrc" / "unionfind.cu").read_text()
    assert int(re.search(r"constexpr int UF_THREADS = (\d+);", src).group(1)) == tuf.UF_THREADS
    counts = dict((int(k), name) for name, k in re.findall(r"#define UF_COUNT_(\w+) (\d+)", src))
    assert int(re.search(r"#define UF_COUNTS (\d+)", src).group(1)) == len(tuf.UF_COUNTS) == len(counts)
    names = [counts[k].lower() for k in range(len(counts))]
    assert names == list(tuf.UF_COUNTS)
