"""seqrush_tpu_torch's batch sharding over a mesh (device='cpu', the
kernels' plain versions) against seqrush_tpu's on the virtual 8-CPU mesh of
tests/conftest.py: the sharded align + unite step, the runner and the
pipeline's --no-sort GFA must equal the JAX package's exactly, and must not
depend on the mesh's size."""

import numpy as np
import pytest
import torch

from seqrush_tpu.align.runner import RunnerConfig as JaxRunnerConfig
from seqrush_tpu.align.runner import WfaAligner as JaxAligner
from seqrush_tpu.config import Args as JaxArgs
from seqrush_tpu.ops import unionfind as jax_uf
from seqrush_tpu.ops.wfa import Penalties as JaxPenalties
from seqrush_tpu.parallel.mesh import distributed_align_unite as jax_align_unite
from seqrush_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seqrush_tpu.pipeline import SeqRushTPU
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch.align.pairs import all_ordered_pairs
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.config import Args
from seqrush_tpu_torch.ops import unionfind as uf
from seqrush_tpu_torch.ops import wfa
from seqrush_tpu_torch.ops.wfa import Penalties
from seqrush_tpu_torch.parallel.mesh import Mesh, distributed_align_unite, make_mesh, replicate, shard_batch
from seqrush_tpu_torch.pipeline import SeqRushTorch
from seqrush_tpu_torch.sequences import make_sequence_set

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
PEN = (5, 8, 2, 24, 1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these shapes gain nothing from more, and the
    suite's workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def make_workload(B=8, L=96, seed=0):
    """tests/test_multidevice.py's workload: B copies of one random sequence,
    each pair one SNP apart."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    qs, ts = [], []
    for k in range(B):
        q = base.copy()
        t = base.copy()
        t[(13 * k + 7) % L] = (t[(13 * k + 7) % L] + 1) % 4
        qs.append(q)
        ts.append(t)
    Q, T, qlens, tlens = wfa.pack_batch(qs, ts)
    caps = np.full(B, 256, dtype=np.int32)
    qoffs = np.arange(B, dtype=np.int64) * L
    toffs = np.arange(B, dtype=np.int64) * L + B * L
    return Q, T, qlens, tlens, caps, qoffs, toffs


def _port_step(n, work):
    Q, T, qlens, tlens, caps, qoffs, toffs = work
    parent = uf.create(2 * 2 * Q.shape[0] * 96 + 2, "cpu")
    scores, parent = distributed_align_unite(make_mesh(n, "cpu"), parent, Q, T, qlens, tlens, caps, qoffs,
                                             toffs, Penalties(*PEN), smax=256, band=32)
    return scores.numpy(), parent.numpy()


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_sharded_step_matches_jax(n_devices):
    work = make_workload()
    scores, parent = _port_step(n_devices, work)
    Q, T, qlens, tlens, caps, qoffs, toffs = work
    s_j, p_j = jax_align_unite(jax_make_mesh(n_devices), jax_uf.create(2 * 2 * 8 * 96 + 2), Q, T, qlens, tlens,
                               caps, qoffs, toffs, JaxPenalties(*PEN), smax=256, band=32)
    assert (scores == 5).all()  # each pair differs by one SNP
    np.testing.assert_array_equal(scores, np.asarray(s_j))
    np.testing.assert_array_equal(parent, np.asarray(p_j))


def test_shard_count_invariance():
    """Equal scores and parent arrays for 1, 2, 4 and 8 shards."""
    work = make_workload(B=16, seed=3)
    results = [_port_step(n, work) for n in (1, 2, 4, 8)]
    for s, p in results[1:]:
        np.testing.assert_array_equal(s, results[0][0])
        np.testing.assert_array_equal(p, results[0][1])


def test_mesh_shapes():
    """make_mesh on the CPU repeats the CPU device; shard_batch pads a batch
    that does not divide with zero rows and places slice i on device i."""
    mesh = make_mesh(3, "cpu")
    assert mesh.size == 3 and all(d.type == "cpu" for d in mesh.devices)
    assert Mesh(["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2
    x = np.arange(10, dtype=np.int32).reshape(5, 2)
    parts = shard_batch(mesh, x)
    assert [p[0].shape[0] for p in parts] == [2, 2, 2]
    np.testing.assert_array_equal(torch.cat([p[0] for p in parts]).numpy()[:5], x)
    assert int(parts[2][0][1].abs().sum()) == 0
    copies = replicate(mesh, x)
    assert len(copies) == 3 and all(torch.equal(c[0], torch.from_numpy(x)) for c in copies)
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")


def _family(seed, n, length, n_snp):
    rng = np.random.default_rng(seed)
    base = BASES[rng.integers(0, 4, size=length)].tobytes()
    fam = [("s0", base)]
    for k in range(1, n):
        alt = bytearray(base)
        for pos in rng.integers(0, len(alt), size=n_snp):
            alt[pos] = BASES[rng.integers(0, 4)]
        fam.append((f"s{k}", bytes(alt)))
    return fam


def _records(results):
    return [(r.query_idx, r.target_idx, r.is_reverse, r.score, r.cigar_string) for r in results]


def test_runner_mesh_matches_single_device_and_jax():
    """WfaAligner's records under a 4-shard mesh equal the no-mesh records
    and the JAX runner's under make_mesh(4)."""
    fam = _family(5, 5, 200, 4)
    pairs = all_ordered_pairs(5)
    plain = WfaAligner(make_sequence_set(fam), RunnerConfig(), device="cpu").align_pairs(pairs)
    al = WfaAligner(make_sequence_set(fam), RunnerConfig(mesh=make_mesh(4, "cpu")), device="cpu")
    sharded = al.align_pairs(pairs)
    jax = JaxAligner(jax_seqs(fam), JaxRunnerConfig(mesh=jax_make_mesh(4))).align_pairs(pairs)
    assert _records(sharded) == _records(plain) == _records(jax)
    chunks = [d for d in al.stats["dispatches"] if d["kind"] == "chunk"]
    assert chunks and all(d["mesh"] == 4 for d in chunks)


def test_pipeline_gfa_mesh_invariance(tmp_path):
    """The --no-sort GFA is byte-identical for mesh_devices None, 2 and 8,
    and to the JAX package's under a 2-device mesh."""
    fam = _family(9, 4, 250, 5)
    outputs = []
    for n in (None, 2, 8):
        out = tmp_path / f"m{n}.gfa"
        sr = SeqRushTorch(make_sequence_set(fam), Args(output=str(out), mesh_devices=n, no_sort=True,
                                                       device="cpu"))
        sr.align_and_unite()
        sr.write_gfa()
        outputs.append(out.read_bytes())
    out = tmp_path / "jax.gfa"
    sr = SeqRushTPU(jax_seqs(fam), JaxArgs(output=str(out), mesh_devices=2, no_sort=True))
    sr.align_and_unite()
    sr.write_gfa()
    assert outputs[0] == outputs[1] == outputs[2] == out.read_bytes()
