"""The bidirectional fold in the port (kernel A's snapshot mode, the combine
on the tensors' device, kernel B's start mode; their plain versions on the
CPU) against the JAX package's ``nw._sweep_v3(t_snap=...)`` and
``nw.nw_align_fold``: SNAP, DIAGA and DIAGB, the fold's scores, half-walk
opcodes and crossings bit-equal, for both parities of qlen + tlen, tiny
pairs and zero-length rows; ``merge_fold_ops`` and the start-mode walk equal
the JAX package's; and ``WfaAligner(RunnerConfig(fold=True | 'auto'))``
against the JAX package's, results and counters equal.  Tolerance 0.

The int32 snapshots: the port's kernel A clamps every state at INF (INF off
the matrix), as the Pallas kernel it replaces does, where the JAX package's
int32 _sweep_v3 leaves them unclamped (its int16 mode clamps).  So in int32
the port's SNAP, DIAGA and DIAGB equal the JAX package's with that clamp
applied (``_clamped``): every value at a cell off the matrix or at INF or
above becomes INF, and every other one is the same.  The fold's results,
which read only the finite values, are equal without it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrush_tpu.ops import nw as jnw
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.ops import nw, nw_cuda
from seqrush_tpu_torch.sequences import make_sequence_set
from test_torch_int16 import COUNTERS, PENALTIES, _corpus, _runners, sweep_batch


def _clamped(X, t, ql, tl, band):
    """The JAX int32 snapshot X [.., B, W] of anti-diagonals t [B] with the
    int16 mode's clamp at INF: INF off the matrix and at or above INF."""
    W = band + 1
    i = np.maximum((t - band + 1) // 2, 0)[:, None] + np.arange(W)[None]
    j = t[:, None] - i
    valid = (i <= ql[:, None]) & (j >= 0) & (j <= tl[:, None])
    return np.where(valid & (X < nw.INF), X, nw.INF)


def _t_snap(ql, tl, tmax, seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, tmax - 1, len(ql)).astype(np.int32)
    t[0], t[1], t[2] = 0, (ql[1] + tl[1]) // 2, ql[2] + tl[2] + 3  # origin, middle, past the end
    return t


@pytest.mark.parametrize("int16", [False, True])
@pytest.mark.parametrize("case", ["two_piece", "one_piece", "gap2_wraps"])
def test_snapshots_equal_jax(case, int16):
    """SNAP (the carry at t_snap), DIAGA and DIAGB (the clamped diagonal
    candidate at t_snap and t_snap + 1), the scores and the traceback."""
    Q, T, ql, tl, _qs, _ts = sweep_batch()
    band, tmax = 63, 512
    pen = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), PENALTIES[case]))
    t_snap = _t_snap(ql, tl, tmax, band)
    _s, tb_j, (SN, DA, DB), _t = jnw._sweep_v3(
        *(jnp.asarray(a) for a in (Q, T, ql, tl)), band=band, tmax=tmax, with_traceback=True,
        dtype=jnp.int16 if int16 else jnp.int32, t_snap=jnp.asarray(t_snap), **pen)
    _sp, tb_p, (SNp, DAp, DBp) = nw_cuda.nw_align(
        *(torch.from_numpy(a) for a in (Q, T, ql, tl)), band=band, tmax=tmax, int16=int16,
        t_snap=torch.from_numpy(t_snap), **pen)
    SN, DA, DB = (np.asarray(x).astype(np.int64) for x in (SN, DA, DB))
    t = t_snap.astype(np.int64)
    if not int16:
        SN = np.stack([_clamped(SN[k], t - (k == 1), ql, tl, band) for k in range(6)])
        DA = _clamped(DA, t, ql, tl, band)
        DB = _clamped(DB, t + 1, ql, tl, band)
    np.testing.assert_array_equal(SN, SNp.numpy())
    np.testing.assert_array_equal(DA, DAp.numpy())
    np.testing.assert_array_equal(DB, DBp.numpy())
    if int16:
        tb_j = np.transpose(np.asarray(tb_j), (1, 0, 2))
        np.testing.assert_array_equal(tb_j[:, : tmax + 1], tb_p.numpy()[:, : tmax + 1])


def _fold_batch(seed, odd):
    """sweep_batch's pairs with their reversed rows: every qlen + tlen odd,
    or every one even, but the zero-length and the tiny rows."""
    Q, T, ql, tl, qs, ts = sweep_batch(seed=seed)
    for b in range(len(qs) - 2):
        if (qs[b].size + ts[b].size) % 2 != odd:
            ts[b] = ts[b][:-1]
            T[b, ts[b].size] = nw.TPAD
            tl[b] -= 1
    Qr, Tr = Q.copy(), T.copy()
    for b, (q, t) in enumerate(zip(qs, ts)):
        Qr[b, : q.size] = q[::-1]
        Tr[b, : t.size] = t[::-1]
    return Q, T, Qr, Tr, ql, tl


@pytest.mark.parametrize("int16", [False, True])
@pytest.mark.parametrize("odd", [0, 1])
@pytest.mark.parametrize("case", ["two_piece", "one_piece"])
def test_fold_equals_jax(case, odd, int16):
    """Scores, both half-walks' opcodes and the crossing flags."""
    args = _fold_batch(5 + odd, odd)
    band, tmax_half = 95, 512
    pen = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), PENALTIES[case]))
    s_j, packed, cm_j = jnw.nw_align_fold(*(jnp.asarray(a) for a in args), band=band,
                                          tmax_half=tmax_half, use_int16=int16, **pen)
    s_p, ops_p, cm_p = nw_cuda.nw_align_fold(*(torch.from_numpy(a) for a in args), band=band,
                                             tmax_half=tmax_half, int16=int16, **pen)
    ops_j = jnw.unpack_opcodes(np.asarray(packed), np.asarray(packed).shape[1] * 4)
    L = ops_p.shape[1]
    np.testing.assert_array_equal(np.asarray(s_j), s_p.numpy())
    np.testing.assert_array_equal(ops_j[:, :L], ops_p.numpy())
    assert not ops_j[:, L:].any()
    np.testing.assert_array_equal(np.asarray(cm_j), cm_p.numpy())
    assert int(s_p[-2]) == 0 and (s_p.numpy()[:-2] > 0).all()
    merged = nw.merge_fold_ops(ops_p.numpy(), cm_p.numpy())
    np.testing.assert_array_equal(merged, jnw.merge_fold_ops(ops_p.numpy(), cm_p.numpy()))


@pytest.mark.parametrize("int16", [False, True])
@pytest.mark.parametrize("odd", [0, 1])
def test_fold_reads_no_row_past_t_snap_plus_one(odd, int16):
    """The snapshot mode's traceback is promised only in each row's rows 0 ..
    t_snap + 1 (nw_cuda.snapshot_rows; the card leaves the rest unwritten):
    with every row past them overwritten by random bytes, the combine's and
    the start walk's plain versions give the untouched run's scores,
    opcodes and crossings (and the JAX package's fold's)."""
    Q, T, Qr, Tr, ql, tl = (torch.from_numpy(a) for a in _fold_batch(11 + odd, odd))
    band, tmax_half = 95, 512
    pen = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), PENALTIES["two_piece"]))
    fin = ql + tl
    tm = torch.div(fin + 1, 2, rounding_mode="floor")
    t_snap = torch.cat([tm, fin - tm]).to(torch.int32)
    _s, tb, (SNAP, DIAGA, DIAGB) = nw_cuda.nw_align(torch.cat([Q, Qr]), torch.cat([T, Tr]), torch.cat([ql, ql]),
                                                    torch.cat([tl, tl]), band=band, tmax=tmax_half, int16=int16,
                                                    t_snap=t_snap, **pen)
    rows = nw_cuda.snapshot_rows(t_snap, tmax_half, tb.shape[1])
    assert not rows.all()
    noise = torch.from_numpy(np.random.default_rng(odd).integers(0, 256, tuple(tb.shape), dtype=np.uint8))
    scrambled = torch.where(rows[:, :, None], tb, noise)
    comb = dict(o1=pen["o1"], o2=pen["o2"], band=band)
    got = []
    for t in (tb, scrambled):
        scores, state, cross_m = nw_cuda.fold_combine_reference(SNAP, DIAGA, DIAGB, ql, tl, **comb)
        got.append((scores, nw_cuda.nw_walk_start_reference(t, state, band=band, tmax=tmax_half), cross_m))
    for a, b in zip(*got):
        assert torch.equal(a, b)
    s_j, packed, cm_j = jnw.nw_align_fold(*(jnp.asarray(a.numpy()) for a in (Q, T, Qr, Tr, ql, tl)), band=band,
                                          tmax_half=tmax_half, use_int16=int16, **pen)
    ops_j = jnw.unpack_opcodes(np.asarray(packed), np.asarray(packed).shape[1] * 4)
    np.testing.assert_array_equal(np.asarray(s_j), got[1][0].numpy())
    np.testing.assert_array_equal(ops_j[:, : got[1][1].shape[1]], got[1][1].numpy())
    np.testing.assert_array_equal(np.asarray(cm_j), got[1][2].numpy())


def test_walk_start_equals_jax():
    """Kernel B's start mode against _tb_scan_tbw(start=...) from arbitrary
    cursors: every material, the band's edge lanes, anti-diagonal 0."""
    Q, T, ql, tl, _qs, _ts = sweep_batch(seed=4)
    band, tmax = 63, 512
    pen = dict(zip(("mismatch", "o1", "e1", "o2", "e2"), PENALTIES["two_piece"]))
    _s, tb, _t = jnw._sweep_v3(*(jnp.asarray(a) for a in (Q, T, ql, tl)), band=band, tmax=tmax,
                               with_traceback=True, **pen)
    rng = np.random.default_rng(8)
    B = len(ql)
    cur = rng.integers(1, tmax + 1, B).astype(np.int32)
    cur[0] = 0
    lane = rng.integers(0, band + 1, B).astype(np.int32)
    lane[1], lane[2] = 0, band
    mat = (np.arange(B) % 5).astype(np.int32)
    ops_j = np.asarray(jnw._tb_scan_tbw(tb, jnp.asarray(ql), jnp.asarray(tl), band=band,
                                        t_total=tmax, start=tuple(jnp.asarray(a) for a in (cur, lane, mat))))
    tb_p = torch.zeros((B, nw.tmax_pad_of(tmax), band + 1), dtype=torch.uint8)
    tb_p[:, : tmax + 1] = torch.from_numpy(np.transpose(np.asarray(tb), (1, 0, 2))[:, : tmax + 1].copy())
    state = torch.from_numpy(np.stack([cur, lane, mat, (cur <= 0).astype(np.int32)]))
    ops_p = nw_cuda.nw_walk_start(tb_p, state, band=band, tmax=tmax)
    np.testing.assert_array_equal(ops_j, ops_p.numpy())
    assert (ops_p.numpy()[1:] != 0).any(axis=1).all()


@pytest.mark.parametrize("cfg", [dict(fold=True), dict(fold="auto"), dict(fold=True, dp_dtype="int16"),
                                 dict(fold=True, wide_route="full"),
                                 dict(fold="auto", fold_max_batch=4, wide_route="full")])
@pytest.mark.parametrize("corpus", ["nw", "family"])
def test_runner_fold_equals_jax(corpus, cfg):
    """Results and counters equal the JAX runner's; the folded chunks emit
    opcodes; fold='auto' folds only chunks of at most fold_max_batch rows;
    with wide_route='full' the family's wide chunk folds."""
    named, pairs = _corpus(corpus)
    ref, jst, got, pst = _runners(named, pairs, **cfg)
    assert got == ref and len(got) == len(pairs)
    for k in COUNTERS:
        assert pst[k] == jst[k], k
    chunks = [d for d in pst["dispatches"] if d["kind"] == "chunk"]
    for d in chunks:
        assert d["fold"] == (cfg["fold"] is True or d["B"] <= cfg.get("fold_max_batch", 128))
        assert d["emit"] == ("ops" if d["fold"] else "runs")
        assert not d["fold"] or d["band_eff"] >= d["band"]
    if corpus == "family" and cfg.get("wide_route") == "full":
        assert any(d["fold"] and d["band"] > 767 for d in chunks) == (cfg["fold"] is True)


def test_fold_runs():
    """fold is ported: the runner takes True and 'auto' (a case of the
    options test_torch_runner.py once held to NotImplementedError)."""
    named, pairs = _corpus("nw")
    for fold in (True, "auto"):
        al = WfaAligner(make_sequence_set(named), RunnerConfig(fold=fold), device="cpu")
        assert len(al.align_pairs(pairs[:2])) == 2 and al.stats["dispatches"][0]["fold"]
    with pytest.raises(ValueError, match="fold"):
        WfaAligner(make_sequence_set(named), RunnerConfig(fold="yes"), device="cpu")
