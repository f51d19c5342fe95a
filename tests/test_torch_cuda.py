"""Kernels A and B on the card against their plain versions, and the
pipeline on cuda against cpu.  Marked ``cuda``; each test skips without a
CUDA device.  This file imports nothing of JAX, so it runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from seqrush_tpu_torch import cli
from seqrush_tpu_torch.ops import nw_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(rng, B, L, inv_frac, device):
    """B-1 variant pairs of length ~L plus one zero-length padding row,
    packed as the runner packs them (lengths rounded up to 256, tmax to 512)."""
    qs, ts = [], []
    for k in range(B - 1):
        q = rng.integers(0, 4, L).astype(np.uint8)
        t = q.copy()
        t[rng.integers(0, L, L // 50)] = rng.integers(0, 4, L // 50)
        if k % 3 == 1:
            t = np.delete(t, np.arange(L // 3, L // 3 + 17))
        if k % 3 == 2:
            t = np.insert(t, L // 2, rng.integers(0, 4, 11).astype(np.uint8))
        if inv_frac and k % 2:
            a, b = int(L * 0.3), int(L * (0.3 + inv_frac))
            t[a:b] = (3 - t[a:b])[::-1]
        qs.append(q)
        ts.append(t)
    qs.append(np.zeros(0, np.uint8))
    ts.append(np.zeros(0, np.uint8))
    lq = -(-max(q.size for q in qs) // 256) * 256
    lt = -(-max(t.size for t in ts) // 256) * 256
    Q = np.full((B, lq), 6, np.uint8)
    T = np.full((B, lt), 7, np.uint8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        Q[b, : q.size] = q
        T[b, : t.size] = t
    ql = np.array([q.size for q in qs], np.int32)
    tl = np.array([t.size for t in ts], np.int32)
    tmax = -(-int((ql + tl).max()) // 512) * 512
    return [torch.from_numpy(a).to(device) for a in (Q, T, ql, tl)], tmax


@pytest.mark.parametrize(
    "B,L,band,two_piece,inv",
    [
        (8, 300, 127, True, 0.0),
        (8, 300, 63, False, 0.0),
        (16, 1200, 383, True, 0.2),
        (8, 1500, 1535, True, 0.4),
        (4, 700, 5375, True, 0.3),  # rows in global scratch, not shared memory
    ],
)
def test_kernels_equal_plain_versions(cuda, B, L, band, two_piece, inv):
    """Exact equality (integers): scores, the whole traceback tensor, opcodes."""
    rng = np.random.default_rng(band + B)
    (Q, T, ql, tl), tmax = _batch(rng, B, L, inv, cuda)
    kw = dict(mismatch=5, o1=8, e1=2, o2=24 if two_piece else -1,
              e2=1 if two_piece else -1, band=band, tmax=tmax)
    before = dict(nw_cuda.LAUNCHES)
    s_k, tb_k = nw_cuda.nw_align(Q, T, ql, tl, **kw)
    ops_k = nw_cuda.nw_walk(tb_k, ql, tl, band=band, tmax=tmax)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_sweep"] == before["nw_sweep"] + 1
    assert nw_cuda.LAUNCHES["nw_walk"] == before["nw_walk"] + 1
    s_p, tb_p = nw_cuda.nw_align_reference(Q, T, ql, tl, **kw)
    ops_p = nw_cuda.nw_walk_reference(tb_k, ql, tl, band=band, tmax=tmax)
    assert torch.equal(s_k, s_p)
    assert int(s_k[-1]) == -1
    assert torch.equal(tb_k, tb_p)
    assert torch.equal(ops_k, ops_p)


def test_pipeline_cuda_equals_cpu(cuda, tmp_path):
    """The same FASTA gives byte-identical GFA on cuda and on cpu."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, 900)
    fa = tmp_path / "in.fa"
    recs = []
    for k in range(4):
        v = base.copy()
        v[rng.integers(0, v.size, 15)] = rng.integers(0, 4, 15)
        if k == 3:
            v = np.delete(v, np.arange(300, 320))
        recs.append(b">s%d\n%s\n" % (k, np.frombuffer(b"ACGT", np.uint8)[v].tobytes()))
    fa.write_bytes(b"".join(recs))
    out = {}
    for dev in ("cuda", "cpu"):
        gfa = tmp_path / f"{dev}.gfa"
        assert cli.main(["-s", str(fa), "-o", str(gfa), "--no-sort", "--device", dev]) == 0
        out[dev] = gfa.read_bytes()
    assert out["cuda"] == out["cpu"]
