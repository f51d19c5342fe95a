"""Kernels A and B of seqrush_tpu_torch (their plain PyTorch versions, which
the wrappers run on CPU tensors) against the JAX package's sweep and walk.

Everything here is integer, so every comparison is exact equality: scores,
traceback bytes of rows 1..tmax (including cells outside each pair's matrix),
opcodes and decoded CIGAR items.
"""

import numpy as np
import pytest
import torch

from seqrush_tpu.ops import nw as jnw
from seqrush_tpu.ops import nw_pallas
from seqrush_tpu.pos import encode_bases
from seqrush_tpu_torch.ops import nw as tnw
from seqrush_tpu_torch.ops import nw_cuda

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _variant_pairs(rng, n=7, L=170):
    """SNP/indel/inversion-bearing pairs (the variant families of
    tests/test_nw_pallas.py)."""
    pairs = []
    for k in range(n):
        base = BASES[rng.integers(0, 4, size=L)].tobytes()
        alt = bytearray(base)
        for pos in rng.integers(0, len(alt), size=5):
            alt[pos] = BASES[rng.integers(0, 4)]
        if k % 4 == 1:
            del alt[60:71]
        if k % 4 == 2:
            alt[90:90] = BASES[rng.integers(0, 4, size=9)].tobytes()
        if k % 4 == 3:
            alt[40:80] = bytes(alt[40:80]).translate(COMP)[::-1]
        pairs.append((base, bytes(alt)))
    return pairs


def _pack(pairs):
    """Host-packed batch plus one zero-length padding row at the end."""
    qs = [encode_bases(q) for q, _ in pairs] + [np.zeros(0, np.uint8)]
    ts = [encode_bases(t) for _, t in pairs] + [np.zeros(0, np.uint8)]
    lq = max(q.size for q in qs)
    lt = max(t.size for t in ts)
    Q = np.stack([np.concatenate([q, np.full(lq - q.size, jnw.QPAD, np.uint8)]) for q in qs])
    T = np.stack([np.concatenate([t, np.full(lt - t.size, jnw.TPAD, np.uint8)]) for t in ts])
    qlens = np.array([q.size for q in qs], np.int32)
    tlens = np.array([t.size for t in ts], np.int32)
    return Q, T, qlens, tlens, qs, ts


def _kw(band, two_piece, tmax):
    return dict(
        mismatch=5, o1=8, e1=2,
        o2=24 if two_piece else -1, e2=1 if two_piece else -1,
        band=band, tmax=tmax,
    )


def _port_sweep(Q, T, qlens, tlens, **kw):
    scores, tb = nw_cuda.nw_align(
        torch.from_numpy(Q), torch.from_numpy(T),
        torch.from_numpy(qlens), torch.from_numpy(tlens), **kw,
    )
    return scores.numpy(), tb


_CASES = [
    (63, True), (127, True), (255, True), (127, False), (63, False),
]


@pytest.mark.parametrize("band,two_piece", _CASES)
def test_plain_sweep_matches_xla_sweep(band, two_piece):
    """Scores and traceback rows 1..tmax equal nw_align_device's (exact);
    the zero-length padding row scores -1; row 0 and the rows past tmax
    are zero."""
    rng = np.random.default_rng(band + 1000 * two_piece)
    Q, T, qlens, tlens, _qs, _ts = _pack(_variant_pairs(rng))
    tmax = int((qlens + tlens).max()) + 1
    kw = _kw(band, two_piece, tmax)
    s_ref, tb_ref = jnw.nw_align_device(Q, T, qlens, tlens, with_traceback=True, **kw)
    scores, tb = _port_sweep(Q, T, qlens, tlens, **kw)
    tb = tb.numpy()
    assert tb.shape == (Q.shape[0], tnw.tmax_pad_of(tmax), band + 1)
    assert (np.asarray(s_ref) == scores).all()
    assert scores[-1] == -1
    assert (np.asarray(tb_ref)[:, 1:] == tb[:, 1 : tmax + 1]).all()
    assert not tb[:, 0].any() and not tb[:, tmax + 1 :].any()


def test_plain_sweep_matches_pallas_interpret():
    """One case against the Pallas kernel itself (interpret mode)."""
    rng = np.random.default_rng(17)
    Q, T, qlens, tlens, _qs, _ts = _pack(_variant_pairs(rng, n=7, L=120))
    tmax = int((qlens + tlens).max()) + 1
    kw = _kw(63, True, tmax)
    s_pal, tb_pal = nw_pallas.nw_align_pallas(Q, T, qlens, tlens, interpret=True, **kw)
    scores, tb = _port_sweep(Q, T, qlens, tlens, **kw)
    tb_pal = np.asarray(tb_pal)
    assert tb_pal.shape == tuple(tb.shape)
    assert (np.asarray(s_pal) == scores).all()
    assert (tb_pal[:, 1 : tmax + 1] == tb.numpy()[:, 1 : tmax + 1]).all()


def _port_walk(tb, qlens, tlens, band, tmax):
    return nw_cuda.nw_walk(
        tb, torch.from_numpy(qlens), torch.from_numpy(tlens), band=band, tmax=tmax
    ).numpy()


def test_plain_walk_matches_pallas_walk():
    """Opcodes equal nw_walk_pallas(interpret=True) over the same traceback."""
    rng = np.random.default_rng(29)
    Q, T, qlens, tlens, _qs, _ts = _pack(_variant_pairs(rng, n=7, L=120))
    tmax = int((qlens + tlens).max()) + 1
    kw = _kw(63, True, tmax)
    _s, tb = _port_sweep(Q, T, qlens, tlens, **kw)
    ops_pal = np.asarray(
        nw_pallas.nw_walk_pallas(tb.numpy(), qlens, tlens, band=63, tmax=tmax, interpret=True)
    )
    ops = _port_walk(tb, qlens, tlens, 63, tmax)
    assert ops.shape == (Q.shape[0], tmax + 1)
    assert (ops == ops_pal).all()


@pytest.mark.parametrize("band,two_piece", _CASES[:4])
def test_plain_walk_matches_xla_walk(band, two_piece):
    """Opcodes equal unpack_opcodes(traceback_scan_device(...)); the port's
    decode_batch equals the JAX package's on them."""
    rng = np.random.default_rng(7 + band + two_piece)
    Q, T, qlens, tlens, qs, ts = _pack(_variant_pairs(rng))
    tmax = int((qlens + tlens).max()) + 1
    kw = _kw(band, two_piece, tmax)
    _s, tb = _port_sweep(Q, T, qlens, tlens, **kw)
    opc = np.asarray(jnw.traceback_scan_device(tb.numpy(), qlens, tlens, band=band, tmax=tmax))
    ops_ref = jnw.unpack_opcodes(opc, opc.shape[1] * 4)[:, : tmax + 1]
    assert (tnw.unpack_opcodes(opc, opc.shape[1] * 4)[:, : tmax + 1] == ops_ref).all()
    ops = _port_walk(tb, qlens, tlens, band, tmax)
    assert (ops == ops_ref).all()
    assert not ops[-1].any()  # padding row walks nowhere
    assert tnw.decode_batch(ops, qs, ts) == jnw.decode_batch(ops_ref, qs, ts)


@pytest.mark.parametrize("seed", range(2))
def test_decode_helpers_match(seed):
    """decode_batch, decode_opcodes and resolve_matches equal the JAX
    package's on random opcode rows (including invalid walks)."""
    rng = np.random.default_rng(seed)
    B, L = 6, 80
    ops = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    qs = [rng.integers(0, 4, size=rng.integers(0, 60)).astype(np.uint8) for _ in range(B)]
    ts = [rng.integers(0, 4, size=rng.integers(0, 60)).astype(np.uint8) for _ in range(B)]
    assert tnw.decode_batch(ops, qs, ts) == jnw.decode_batch(ops, qs, ts)
    for b in range(B):
        items = jnw.decode_opcodes(ops[b])
        assert tnw.decode_opcodes(ops[b]) == items
        q = rng.integers(0, 4, size=400).astype(np.uint8)
        t = rng.integers(0, 4, size=400).astype(np.uint8)
        assert tnw.resolve_matches(items, q, t) == jnw.resolve_matches(items, q, t)


def test_wrappers_check_arguments():
    """The wrappers reject wrong dtypes and shapes, and a CPU call runs the
    plain version without counting a kernel launch."""
    Q = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.full((2,), 8, dtype=torch.int32)
    kw = _kw(15, True, 16)
    before = dict(nw_cuda.LAUNCHES)
    scores, tb = nw_cuda.nw_align(Q, Q, lens, lens, **kw)
    assert scores.tolist() == [0, 0]
    ops = nw_cuda.nw_walk(tb, lens, lens, band=15, tmax=16)
    assert (ops[:, 2::2] == tnw.OP_M).all() and not ops[:, 1::2].any()
    assert nw_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        nw_cuda.nw_align(Q.to(torch.int32), Q, lens, lens, **kw)
    with pytest.raises(ValueError):
        nw_cuda.nw_align(Q, Q, lens.to(torch.int64), lens, **kw)
    with pytest.raises(ValueError):
        nw_cuda.nw_walk(tb[:, :, :8].contiguous(), lens, lens, band=15, tmax=16)


@pytest.mark.parametrize("int16", [False, True])
def test_plain_sweep_matches_sweep_v3_above_reg_max_w(int16):
    """At W = 4,161, a band the register route does not take (kernel A's
    wide route on the card), on pairs whose path runs out to lane ~4,000 (a
    4 kb insertion), a SNP pair, an empty row and a 1 x 2 pair: the plain
    sweep's scores equal the JAX package's _sweep_v3 (but the empty pair's
    in int32, which _sweep_v3 reads at the origin where the Pallas kernel
    leaves -1, as test_plain_sweep_matches_xla_sweep holds).  In int16 (which
    clamps at INF16, as kernel A does) the whole traceback is equal; the
    int32 _sweep_v3 leaves off-matrix states unclamped where kernel A clamps
    at INF (ROADMAP §3), so there the two tracebacks are held on what they
    decide: each walked from its final cell gives the same opcodes."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4161)
    base = rng.integers(0, 4, 300).astype(np.uint8)
    snp = base.copy()
    snp[rng.integers(0, 300, 9)] = rng.integers(0, 4, 9)
    ins = np.concatenate([base[:80], rng.integers(0, 4, 4000).astype(np.uint8), base[80:150]])
    qs = [base[:150], base, np.zeros(0, np.uint8), np.array([1], np.uint8)]
    ts = [ins, snp, np.zeros(0, np.uint8), np.array([2, 3], np.uint8)]
    B, L = len(qs), max(t.size for t in ts)
    Q = np.full((B, L), jnw.QPAD, np.uint8)
    T = np.full((B, L), jnw.TPAD, np.uint8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        Q[b, : q.size], T[b, : t.size] = q, t
    ql = np.array([q.size for q in qs], np.int32)
    tl = np.array([t.size for t in ts], np.int32)
    band, tmax = 4160, 4352
    assert nw_cuda.plan_sweep(B, band + 1, L, L).route == "wide"
    pen = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1)
    s_j, tb_j, _t = jnw._sweep_v3(*(jnp.asarray(a) for a in (Q, T, ql, tl)), band=band, tmax=tmax,
                                  with_traceback=True, dtype=jnp.int16 if int16 else jnp.int32, **pen)
    args = [torch.from_numpy(a) for a in (Q, T, ql, tl)]
    s_p, tb_p = nw_cuda.nw_align(*args, band=band, tmax=tmax, int16=int16, **pen)
    s_j = np.asarray(s_j).copy()
    if not int16:
        # _sweep_v3 reads an empty pair's score at the origin (0); the Pallas
        # kernel that kernel A replaces, and so the port, leave it -1
        assert s_j[2] == 0
        s_j[2] = -1
    np.testing.assert_array_equal(s_j, s_p.numpy())
    assert int(s_p[0]) == 24 + 4000 and int(s_p[2]) == (0 if int16 else -1)
    if int16:
        tb_j = np.transpose(np.asarray(tb_j), (1, 0, 2))
        np.testing.assert_array_equal(tb_j[:, : tmax + 1], tb_p.numpy()[:, : tmax + 1])
    else:
        ops_j = np.asarray(jnw._tb_scan_tbw(tb_j, jnp.asarray(ql), jnp.asarray(tl), band=band, t_total=tmax))
        ops_p = nw_cuda.nw_walk(tb_p, args[2], args[3], band=band, tmax=tmax).numpy()
        np.testing.assert_array_equal(ops_j, ops_p)
        assert (ops_p[0] != 0).sum() == 150 + 4000  # 150 matched columns and the 4 kb insertion
