"""The order in which the SGD tick sums a node's terms, and the CPU paths'
independence from the CUDA library.

The tick kernel (seqrush_tpu_torch/ops/csrc/sgd_tick.cu) is held on the card
to the plain tick run on the CPU, bit for bit.  That yardstick holds only
while ``sgd._scatter_terms`` on the CPU is a left fold from +0.0 over each
node's terms in the order of ``cat([i, j])`` (the JAX tick's
``.at[i].add(-r_x).at[j].add(r_x)``), at every size: here it is held to a
numpy float32 fold in that order, bit for bit, on hand-made ticks.  And the
CPU runs of the SGD and of the fold must never load the CUDA library.
"""

import numpy as np
import pytest
import torch

from seqrush_tpu_torch.graph.bigraph import parse_gfa
from seqrush_tpu_torch.layout import sgd
from seqrush_tpu_torch.ops import nw_cuda

from test_torch_graph_order import variation_gfa


def _left_fold(n_nodes, i, j, r_x, valid):
    """numpy float32: per node, +0.0 then -r_x of each term naming it as i,
    in term order, then +r_x of each naming it as j; and the valid counts."""
    idx = np.concatenate([i, j])
    vals = np.concatenate([-r_x, r_x]).astype(np.float32)
    acc = np.zeros(n_nodes, np.float32)
    for k in range(idx.size):
        acc[idx[k]] = np.float32(acc[idx[k]] + vals[k])
    cnt = np.zeros(n_nodes, np.float32)
    np.add.at(cnt, idx, np.concatenate([valid, valid]).astype(np.float32))
    return acc, cnt


def _tick(kind, seed):
    """(n_nodes, i, j, r_x, valid) of a hand-made tick."""
    rng = np.random.default_rng(seed)
    if kind == "hub":
        # node 0 named dozens of times from both sides, node 6 by no term,
        # a term from a node to itself, invalid terms (r_x = 0)
        n, w = 7, 64
        i = rng.choice([0, 1, 2, 3], size=w, p=[0.5, 0.2, 0.2, 0.1])
        j = rng.choice([0, 4, 5], size=w, p=[0.5, 0.3, 0.2])
        i[5], j[5] = 2, 2
    else:
        # 40,000 terms: 80,000 entries, past the 32,768 from which the CPU's
        # index_put_(accumulate=True) adds with parallel float atomics
        n, w = 500, 40_000
        i = rng.integers(0, n - 1, w)
        j = rng.integers(0, n - 1, w)
    r_x = (rng.standard_normal(w) * 10.0 ** rng.integers(-3, 4, w)).astype(np.float32)
    valid = rng.random(w) > 0.2
    r_x[~valid] = 0.0
    return n, i, j, r_x, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["hub", "wide"])
def test_scatter_terms_is_a_left_fold_in_cat_order(kind, seed):
    n, i, j, r_x, valid = _tick(kind, seed)
    want_upd, want_cnt = _left_fold(n, i, j, r_x, valid)
    x = torch.zeros(n, dtype=torch.float32)
    upd, cnt = sgd._scatter_terms(x, torch.from_numpy(i), torch.from_numpy(j), torch.from_numpy(r_x),
                                  torch.from_numpy(valid.astype(np.float32)))
    assert (upd.numpy().view(np.int32) == want_upd.view(np.int32)).all()
    assert (cnt.numpy() == want_cnt).all()
    if kind == "hub":
        assert want_cnt[0] >= 24 and want_cnt[6] == 0 and upd[6].item() == 0.0


def test_scatter_terms_same_bits_every_call():
    n, i, j, r_x, valid = _tick("wide", 3)
    args = [torch.from_numpy(a) for a in (i, j, r_x, valid.astype(np.float32))]
    x = torch.zeros(n, dtype=torch.float32)
    first = sgd._scatter_terms(x, *args)[0]
    for _ in range(3):
        assert torch.equal(sgd._scatter_terms(x, *args)[0].view(torch.int32), first.view(torch.int32))


def _no_library(monkeypatch):
    def refuse():
        raise AssertionError("a CPU run loaded the CUDA library")

    monkeypatch.setattr(nw_cuda, "_library", refuse)


def test_sgd_on_cpu_never_loads_the_cuda_library(monkeypatch):
    _no_library(monkeypatch)
    g = parse_gfa(variation_gfa(0))
    pos = sgd.path_linear_sgd(g, sgd.PathSGDParams(iter_max=4), "cpu")
    assert len(pos) == len(g.nodes) and all(np.isfinite(v) for v in pos.values())
    order = sgd.path_sgd_sort(g, sgd.PathSGDParams(iter_max=4), refine_rounds=1, device="cpu")
    assert sorted(order) == sorted(n << 1 for n in g.nodes)


def test_fold_on_cpu_never_loads_the_cuda_library(monkeypatch):
    _no_library(monkeypatch)
    rng = np.random.default_rng(7)
    B, L, band = 3, 200, 31
    qs = [rng.integers(0, 4, L).astype(np.uint8) for _ in range(B)]
    ts = [np.delete(q, np.arange(50, 53)) for q in qs]
    lq, lt = 256, 256
    Q = np.full((B, lq), 6, np.uint8)
    T = np.full((B, lt), 7, np.uint8)
    Qr, Tr = Q.copy(), T.copy()
    for b, (q, t) in enumerate(zip(qs, ts)):
        Q[b, : q.size], T[b, : t.size] = q, t
        Qr[b, : q.size], Tr[b, : t.size] = q[::-1], t[::-1]
    ql = torch.tensor([q.size for q in qs], dtype=torch.int32)
    tl = torch.tensor([t.size for t in ts], dtype=torch.int32)
    tmax_half = 256
    scores, ops, cross_m = nw_cuda.nw_align_fold(
        *(torch.from_numpy(a) for a in (Q, T, Qr, Tr)), ql, tl, mismatch=5, o1=8, e1=2, o2=24, e2=1,
        band=band + 3, tmax_half=tmax_half)
    assert scores.shape == (B,) and (scores > 0).all() and ops.shape == (2 * B, tmax_half + 1)
