"""The port's sparsified and iterative pair schedules against seqrush_tpu's.

* ``kmer_sketches`` is exact; ``kmer_distance_matrix`` (one float32 matrix
  product, torch against XLA) is within 1e-6 of the JAX package's on the
  220 bp corpus and within 4e-6 on the 1,200 bp one.  Both libraries sum
  1,024 float32 products per entry in their own order; on the longer
  corpus, where most buckets are occupied, the JAX matrix is itself up to
  1.2e-6 from the float64 value, so 1e-6 between the two cannot hold there.
  The port is also held to the float64 value, within 2e-6.
* ``mst_pairs``, ``tree_sampling_pairs`` and ``schedule_pairs`` are exact
  given the same distance matrix.
* On the seeded corpora the whole schedule, the pipeline's pair counts, its
  ``--no-sort`` GFA, the iterative mode's counters and the PAF pre-pass are
  equal.
"""

import numpy as np
import pytest

from seqrush_tpu.align import pairs as jpairs
from seqrush_tpu.config import Args as JaxArgs
from seqrush_tpu.ops import kmer as jkmer
from seqrush_tpu.pipeline import SeqRushTPU
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch import pipeline as ppipeline
from seqrush_tpu_torch.align import pairs as ppairs
from seqrush_tpu_torch.config import Args
from seqrush_tpu_torch.ops import kmer as pkmer
from seqrush_tpu_torch.pos import encode_bases
from seqrush_tpu_torch.pipeline import SeqRushTorch
from seqrush_tpu_torch.sequences import make_sequence_set

from test_torch_pipeline import _graft_corpus

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
DISTANCE_TOL = {"family": 1e-6, "graft": 4e-6}  # against the JAX package
EXACT_TOL = 2e-6  # against the float64 product
SPECS = ["none", "auto", "random:0.4", "connectivity:0.15", "0.3",
         "tree:2", "tree:2,1", "tree:2,1,0.2", "tree:1,0,0.5,11", "tree:0,0,0"]


def _family_corpus(n=14, length=220, seed=5):
    """Two families of short haplotypes (so that sketch distances have
    structure), each a few SNPs and a small indel away from its founder."""
    rng = np.random.default_rng(seed)
    founders = [BASES[rng.integers(0, 4, size=length)] for _ in range(2)]
    named = []
    for k in range(n):
        s = bytearray(founders[k % 2].tobytes())
        for pos in rng.integers(0, len(s), size=int(rng.integers(1, 6))):
            s[pos] = BASES[rng.integers(0, 4)]
        if k % 4 == 3:
            p = int(rng.integers(10, len(s) - 20))
            del s[p : p + int(rng.integers(1, 6))]
        named.append((f"h{k}", bytes(s)))
    return named


def _codes(named):
    return [encode_bases(np.frombuffer(s, dtype=np.uint8)) for _, s in named]


def _random_distances(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.random((n, n)).astype(np.float32)
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    return d


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("corpus", ["family", "graft"])
def test_distance_matrix(corpus, k):
    named = _family_corpus() if corpus == "family" else _graft_corpus()
    codes = _codes(named)
    assert (pkmer.kmer_sketches(codes, k) == jkmer.kmer_sketches(codes, k)).all()
    want = jkmer.kmer_distance_matrix(codes, k)
    got = pkmer.kmer_distance_matrix(codes, k, device="cpu")
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(named),) * 2
    assert np.abs(got - want).max() <= DISTANCE_TOL[corpus]
    sk = pkmer.kmer_sketches(codes, k).astype(np.float64)
    assert np.abs(got - (1.0 - sk @ sk.T)).max() <= EXACT_TOL
    # a sequence shorter than k has an empty sketch: distance 1 to everything
    short = codes + [codes[0][: k - 1]]
    got = pkmer.kmer_distance_matrix(short, k, device="cpu")
    assert np.abs(got - jkmer.kmer_distance_matrix(short, k)).max() <= DISTANCE_TOL[corpus]
    assert (got[-1] == 1.0).all()


@pytest.mark.parametrize("n", [1, 2, 9, 40])
def test_mst_pairs_exact(n):
    d = _random_distances(n, n)
    assert (pkmer.mst_pairs(d) == jkmer.mst_pairs(d)).all()
    assert pkmer.mst_pairs(d).shape == (max(n - 1, 0), 2)


@pytest.mark.parametrize("k_near,k_far,frac", [(2, 0, 0.0), (3, 1, 0.25), (0, 2, 1.0), (1, 1, 0.01)])
@pytest.mark.parametrize("n", [1, 7, 30])
def test_tree_sampling_pairs_exact(n, k_near, k_far, frac):
    d = _random_distances(n, 100 + n)
    want = jkmer.tree_sampling_pairs(d, k_near, k_far, frac, seed=9)
    got = pkmer.tree_sampling_pairs(d, k_near, k_far, frac, seed=9)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all()


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("n", [5, 80])
def test_schedule_pairs_exact_given_the_matrix(n, spec):
    """n = 80 is past the size up to which 'auto' keeps every pair."""
    d = _random_distances(n, n)
    jspars, pspars = jpairs.parse_sparsification(spec), ppairs.parse_sparsification(spec)
    assert vars(jspars) == vars(pspars)
    for kd in (d, None) if pspars.kind != "tree" else (d,):
        want = jpairs.schedule_pairs(n, jspars, seed=3, kmer_distances=kd)
        got = ppairs.schedule_pairs(n, pspars, seed=3, kmer_distances=kd)
        assert got.dtype == want.dtype and got.shape == want.shape and (got == want).all()
    if spec in ("auto", "connectivity:0.15", "tree:2") and n == 80:
        assert 0 < len(got) < n * (n - 1)


def test_ensure_connected_exact():
    d = _random_distances(12, 1)
    kept = np.array([[0, 1], [5, 4], [7, 2]], dtype=np.int32)
    empty = np.zeros((0, 2), dtype=np.int32)
    for pairs in (kept, empty):
        for kd in (d, None, d[:5, :5]):
            assert (ppairs._ensure_connected(pairs, 12, kd) == jpairs._ensure_connected(pairs, 12, kd)).all()


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown sparsification kind"):
        ppairs.schedule_pairs(4, ppairs.Sparsification("nearest"))


@pytest.mark.parametrize("spec", [s for s in SPECS if s != "none"])
def test_whole_schedule_equal_on_seeded_corpus(spec):
    """Each package's own distance matrix, then its own schedule."""
    named = _family_corpus()
    codes, n = _codes(named), len(named)
    spars = ppairs.parse_sparsification(spec)
    want = jpairs.schedule_pairs(
        n, jpairs.parse_sparsification(spec), seed=42,
        kmer_distances=jkmer.kmer_distance_matrix(codes, spars.kmer_size),
    )
    got = ppairs.schedule_pairs(
        n, spars, seed=42,
        kmer_distances=pkmer.kmer_distance_matrix(codes, spars.kmer_size, device="cpu"),
    )
    assert got.shape == want.shape and (got == want).all()


def _run_both(named, tmp_path, **kw):
    jout, pout = tmp_path / "jax.gfa", tmp_path / "port.gfa"
    jsr = SeqRushTPU(jax_seqs(named), JaxArgs(no_sort=True, output=str(jout), **kw))
    jsr.align_and_unite()
    jsr.write_gfa()
    psr = SeqRushTorch(make_sequence_set(named), Args(no_sort=True, output=str(pout), device="cpu", **kw))
    psr.align_and_unite()
    psr.write_gfa()
    return jsr, psr, jout.read_bytes(), pout.read_bytes()


@pytest.mark.parametrize("spec", ["tree:2,1,0.2", "random:0.5", "connectivity:0.2", "auto"])
def test_pipeline_sparsified_matches_jax(spec, tmp_path):
    named = _family_corpus(n=8)
    jsr, psr, ref, got = _run_both(named, tmp_path, sparsification=spec)
    assert psr.stats["aligner"]["alignments"] == jsr.stats["aligner"]["alignments"]
    assert psr.timer.counters == jsr.timer.counters
    assert got == ref
    if spec != "auto":
        assert psr.stats["aligner"]["alignments"] < len(named) * (len(named) - 1)


@pytest.mark.parametrize("spec", ["none", "tree:3,1,0.5"])
def test_iterative_counters_match_jax(spec, tmp_path):
    """14 near-identical haplotypes in two families: the tree phase connects
    each family, and the random phase stops once ten checks in a row (100
    pairs) leave the component count unchanged."""
    named = _family_corpus()
    jsr, psr, ref, got = _run_both(named, tmp_path, iterative=True, sparsification=spec)
    keys = ("iterative_random_pairs", "iterative_tree_pairs", "iterative_stabilized",
            "iterative_dispatches")
    assert {k: psr.stats[k] for k in keys} == {k: jsr.stats[k] for k in keys}
    assert psr.stats["iterative_tree_pairs"] > 0
    assert psr.stats["aligner"]["alignments"] == jsr.stats["aligner"]["alignments"]
    assert psr.count_components() == jsr.count_components()
    assert got == ref
    if spec == "none":
        assert psr.stats["iterative_stabilized"]
        assert psr.stats["iterative_random_pairs"] % ppipeline.CHECK_INTERVAL == 0
        assert psr.stats["iterative_random_pairs"] < len(named) * (len(named) - 1)


def test_iterative_constants():
    from seqrush_tpu import pipeline as jpipeline

    for name in ("CHECK_INTERVAL", "STABILITY_THRESHOLD", "ITER_DISPATCH"):
        assert getattr(ppipeline, name) == getattr(jpipeline, name)
    assert (ppipeline.CHECK_INTERVAL, ppipeline.STABILITY_THRESHOLD) == (10, 10)


@pytest.mark.parametrize("kw", [dict(sparsification="tree:1"), dict(iterative=True)],
                         ids=["tree", "iterative"])
def test_paf_prepass_records_all_pairs(kw, tmp_path):
    named = _family_corpus(n=6)
    jpaf, ppaf = tmp_path / "jax.paf", tmp_path / "port.paf"
    jsr = SeqRushTPU(jax_seqs(named), JaxArgs(no_sort=True, output_alignments=str(jpaf), **kw))
    jsr.align_and_unite()
    psr = SeqRushTorch(make_sequence_set(named),
                       Args(no_sort=True, device="cpu", output_alignments=str(ppaf), **kw))
    psr.align_and_unite()
    assert ppaf.read_text() == jpaf.read_text()
    assert len(ppaf.read_text().splitlines()) == len(named) * (len(named) - 1)
    assert "paf_prepass" in psr.timer.phases
    assert psr.stats["aligner"]["alignments"] == jsr.stats["aligner"]["alignments"]


def test_distance_matrix_asks_for_cuda_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pkmer.kmer_distance_matrix(_codes(_family_corpus(n=3)), 16)
