"""Band tiling in the port (kernels A and B's tiled modes through their plain
versions on the CPU, and the runner's planner and dispatch) against the JAX
package's ``nw_align_with_runs_tiled`` and its runner with
``band_tiling='auto'``, tolerance 0 (all integer).

The kernel cases are the geometries of ``tests/test_tiled.py`` plus a band
whose W is not a multiple of 32: each pair's first-row score, run tokens and
count equal the JAX package's.  The traceback is held to ``_sweep_tiled``'s,
transposed to the port's [rows, tmax_pad, W] layout, on each row's valid
cells (the cells of its pair's matrix): the whole byte in int16, where the
JAX sweep clamps as kernel A does, and the choice bits in int32, where the
JAX sweep keeps unclamped values off the matrix, so an opened bit whose two
candidates both come from off the matrix can differ (as the fold's int32
snapshots do, tests/test_torch_fold.py).  The whole tensor is held to the
port's untiled sweep of each pair at its own band."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrush_tpu.align.runner import RunnerConfig as JaxRunnerConfig
from seqrush_tpu.align.runner import WfaAligner as JaxAligner
from seqrush_tpu.ops import nw as jnw
from seqrush_tpu.scores import AlignmentScores as JaxScores
from seqrush_tpu.sequences import make_sequence_set as jax_seqs
from seqrush_tpu_torch.align.pairs import all_ordered_pairs
from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner
from seqrush_tpu_torch.ops import nw, nw_cuda
from seqrush_tpu_torch.scores import AlignmentScores
from seqrush_tpu_torch.sequences import make_sequence_set
from test_tiled import PEN, _bench_like_seqs, _mutate

SCORES = "0,5,8,2,24,1"
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these shapes gain nothing from more, and the
    suite's workers share the machine's cores (torch's spinning thread
    pools in several workers at once slow every test on it)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _layout(narrow, wide, band, R, Lq=None, Lt=None, B=None):
    """The row layout of tests/test_tiled.py (narrow rows, then R rows per
    wide pair), padded to B rows of zero-length narrow pairs and to Lq / Lt
    columns when given: (Q, T, qlens, tlens, tile, wide)."""
    rows = [(k, 0, False) for k in range(len(narrow))]
    for k in range(len(wide)):
        rows += [(len(narrow) + k, r, True) for r in range(R)]
    allp = narrow + wide
    B = B or len(rows)
    Lq = Lq or max(len(q) for q, _ in allp)
    Lt = Lt or max(len(t) for _, t in allp)
    Q = np.full((B, Lq), jnw.QPAD, np.uint8)
    T = np.full((B, Lt), jnw.TPAD, np.uint8)
    ql, tl, tile = (np.zeros(B, np.int32) for _ in range(3))
    is_wide = np.zeros(B, bool)
    for b, (pk, r, w) in enumerate(rows):
        q, t = allp[pk]
        Q[b, : len(q)] = q
        T[b, : len(t)] = t
        ql[b], tl[b], tile[b], is_wide[b] = len(q), len(t), r, w
    return Q, T, ql, tl, tile, is_wide


@functools.partial(jax.jit, static_argnames=("band", "R", "tmax", "use_int16"))
def _jax_tiled(Q, T, ql, tl, tile, is_wide, *, band, R, tmax, use_int16):
    """The JAX package's nw_align_with_runs_tiled and, from the same
    pre-shifted operands, _sweep_tiled's traceback [rows, T_total + 1, W]."""
    W = band + 1
    o_off = tile * W
    hl = is_wide & (tile > 0)
    hr = is_wide & (tile < R - 1)
    sibf = jnp.stack([is_wide & (tile + k < R) for k in range(1, R)])
    kw = dict(band=band, band_wide=R * W - 1, tmax=tmax, **PEN)
    sc, tok, cnt = jnw.nw_align_with_runs_tiled(Q, T, ql, tl, o_off, is_wide, hl, hr, sibf, n_tiles=R,
                                                use_int16=use_int16, **kw)
    # the wrapper's per-tile pre-shift (query left, target right by o_off)
    Qp1 = jnp.pad(Q, ((0, 0), (1, 0)), constant_values=jnw.QPAD)
    Tp = jnp.pad(T, ((0, 0), (0, (R - 1) * W)), constant_values=jnw.TPAD)
    Qs, Ts = Qp1, Tp
    for r in range(1, R):
        m = (o_off == r * W)[:, None]
        Qs = jnp.where(m, jnp.roll(Qp1, -r * W, axis=1), Qs)
        Ts = jnp.where(m, jnp.roll(Tp, r * W, axis=1), Ts)
    _s, tb, _t = jnw._sweep_tiled(Qs, Ts, ql, tl, o_off, is_wide, hl, hr,
                                  dtype=jnp.int16 if use_int16 else jnp.int32, **kw)
    return sc, tok, cnt, tb.transpose(1, 0, 2)


def _valid_cells(ql, tl, tile, is_wide, band, R, n):
    """[rows, n, W] bool: the cells of anti-diagonals 1..n-1 that lie in each
    row's pair's matrix (lane tile * W + c of the pair's own band)."""
    W = band + 1
    t = np.arange(n)[None, :, None]
    K = np.where(is_wide, R * W - 1, band)[:, None, None]
    i = np.maximum((t - K + 1) // 2, 0) + tile[:, None, None] * W + np.arange(W)[None, None, :]
    j = t - i
    return (t >= 1) & (i <= ql[:, None, None]) & (j >= 0) & (j <= tl[:, None, None])


def _untiled_tb(Q, T, ql, tl, tile, is_wide, band, R, tmax, int16):
    """The port's untiled sweep of each pair at its own band, laid into the
    tile rows: what the tiled traceback must equal, whole."""
    W = band + 1
    out = torch.zeros((Q.shape[0], nw.tmax_pad_of(tmax), W), dtype=torch.uint8)
    for rows, k in ((np.flatnonzero(~is_wide), band), (np.flatnonzero(is_wide & (tile == 0)), R * W - 1)):
        if rows.size:
            sel = torch.from_numpy(rows)
            _s, tb = nw_cuda.nw_align_reference(torch.from_numpy(Q[rows]), torch.from_numpy(T[rows]),
                                                torch.from_numpy(ql[rows]), torch.from_numpy(tl[rows]),
                                                band=k, tmax=tmax, int16=int16, **PEN)
            if k == band:
                out[sel] = tb
            else:
                for r in range(R):
                    out[sel + r] = tb[:, :, r * W : (r + 1) * W]
    return out


def _assert_parity(narrow, wide, band, R, use_int16=False, **pad):
    Q, T, ql, tl, tile, is_wide = _layout(narrow, wide, band, R, **pad)
    tmax = -(-max(len(q) + len(t) for q, t in narrow + wide) // 512) * 512
    sc, tok, cnt, tb_j = (np.asarray(a) for a in _jax_tiled(Q, T, ql, tl, tile, is_wide, band=band, R=R,
                                                             tmax=tmax, use_int16=use_int16))
    Qt, Tt, qt, tt = (torch.from_numpy(a) for a in (Q, T, ql, tl))
    lay = dict(band=band, n_tiles=R, tmax=tmax)
    s_p, tb_p = nw_cuda.nw_align_tiled(Qt, Tt, qt, tt, tile, is_wide, int16=use_int16, **lay, **PEN)
    tok_p, cnt_p = nw_cuda.nw_walk_runs_tiled(tb_p, qt, tt, tile, is_wide, run_max=jnw.RUN_MAX, **lay)
    first = (tile == 0) & (np.arange(len(ql)) < len(narrow) + R * len(wide))
    np.testing.assert_array_equal(s_p.numpy()[first], sc[first])
    np.testing.assert_array_equal(tok_p.numpy()[first], tok[first])
    np.testing.assert_array_equal(cnt_p.numpy()[first], cnt[first])
    assert (s_p.numpy()[tile > 0] == -1).all() and not tok_p.numpy()[tile > 0].any()
    n = min(tmax + 1, tb_j.shape[1])
    valid = _valid_cells(ql, tl, tile, is_wide, band, R, n)
    mask = 0xFF if use_int16 else 0x07
    got = tb_p.numpy()[:, :n]
    np.testing.assert_array_equal(got[valid] & mask, tb_j[:, :n][valid] & mask)
    assert torch.equal(tb_p, _untiled_tb(Q, T, ql, tl, tile, is_wide, band, R, tmax, use_int16))
    return s_p.numpy()[first], tok_p.numpy()[first], cnt_p.numpy()[first]


def _pairs(rng, n, length, **mut):
    out = []
    for _ in range(n):
        q = rng.integers(0, 4, length).astype(np.uint8)
        out.append((q, _mutate(rng, q, **mut)))
    return out


def test_tiled_mixed_r3():
    rng = np.random.default_rng(7)
    _assert_parity(_pairs(rng, 6, 240), _pairs(rng, 3, 240, inv_frac=0.3), band=63, R=3)


@pytest.mark.parametrize("R", [2, 4])
def test_tiled_r2_and_r4(R):
    rng = np.random.default_rng(11)
    _assert_parity(_pairs(rng, 4, 200), _pairs(rng, 2, 200, inv_frac=0.25), band=63, R=R)


def test_tiled_fuzz_small_bands():
    """Band 7 / 23 over heavily indeled pairs of random lengths, every trial
    at one padded shape (one JAX compile)."""
    rng = np.random.default_rng(23)
    for _trial in range(6):
        narrow, wide = [], []
        for _ in range(3):
            q = rng.integers(0, 4, int(rng.integers(4, 40))).astype(np.uint8)
            narrow.append((q, _mutate(rng, q, div=0.1, indels=1, max_indel=3)))
        for _ in range(3):
            q = rng.integers(0, 4, int(rng.integers(12, 48))).astype(np.uint8)
            wide.append((q, _mutate(rng, q, div=0.1, indels=2, max_indel=8)))
        _assert_parity(narrow, wide, band=7, R=3, Lq=64, Lt=80, B=16)


def test_tiled_final_lane_on_tile_boundary():
    """Lengths whose final cell's lane sits at the first or last lane of a
    tile row (tests/test_tiled.py's geometry, wide pairs only)."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, 120).astype(np.uint8)
    wide = []
    for d in range(-34, 35, 4):
        t = base[: 120 - abs(d)] if d >= 0 else np.concatenate([base, rng.integers(0, 4, -d).astype(np.uint8)])
        wide.append((base, t))
    _assert_parity([], wide, band=15, R=3)


def test_tiled_short_pair_inside_wide_chunk():
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, 9).astype(np.uint8)
    n = rng.integers(0, 4, 30).astype(np.uint8)
    _assert_parity([(n, _mutate(rng, n, div=0.1, indels=1, max_indel=2))],
                   [(q, _mutate(rng, q, div=0.2, indels=1, max_indel=2))], band=15, R=4)


def test_tiled_w_not_a_multiple_of_32():
    """W 102 (wide pairs at 306 lanes): the walk's 32-lane windows and the
    sweep's strips cross tile rows."""
    rng = np.random.default_rng(29)
    _assert_parity(_pairs(rng, 3, 300, indels=3), _pairs(rng, 2, 300, inv_frac=0.3), band=101, R=3)


def test_tiled_int16():
    rng = np.random.default_rng(13)
    narrow = _pairs(rng, 2, 150)
    wide = _pairs(rng, 1, 150, inv_frac=0.3)
    got16 = _assert_parity(narrow, wide, band=63, R=3, use_int16=True)
    got32 = _assert_parity(narrow, wide, band=63, R=3)
    for a, b in zip(got16, got32):
        np.testing.assert_array_equal(a, b)


def test_tiled_rejects_bad_geometry():
    """W odd (band 8) is refused by both packages; so is one tile."""
    rng = np.random.default_rng(1)
    q = rng.integers(0, 4, 20).astype(np.uint8)
    Q, T, ql, tl, tile, is_wide = _layout([(q, q)], [(q, q)], 8, 3)
    with pytest.raises(ValueError):
        _jax_tiled(Q, T, ql, tl, tile, is_wide, band=8, R=3, tmax=64, use_int16=False)
    Qt, Tt, qt, tt = (torch.from_numpy(a) for a in (Q, T, ql, tl))
    for band, R in ((8, 3), (9, 1)):
        with pytest.raises(ValueError):
            nw_cuda.nw_align_tiled(Qt, Tt, qt, tt, tile, is_wide, band=band, n_tiles=R, tmax=64, **PEN)
    with pytest.raises(ValueError):  # a wide pair cut short
        nw_cuda.tiled_rows(tile, is_wide, 4, 9, len(tile))


def _runner_pair(budget=int(70e6), **cfg):
    codes = _bench_like_seqs()
    named = [(f"s{k}", BASES[c].tobytes()) for k, c in enumerate(codes)]
    pairs = all_ordered_pairs(len(codes))
    kw = dict(threads=2, band_tiling="auto", memory_budget_bytes=budget, **cfg)
    ref = JaxAligner(jax_seqs(named), JaxRunnerConfig(scores=JaxScores.parse(SCORES), **kw))
    port = WfaAligner(make_sequence_set(named), RunnerConfig(scores=AlignmentScores.parse(SCORES), **kw),
                      device="cpu")
    return ref, ref.align_pairs(pairs), port, port.align_pairs(pairs)


def _records(res):
    return [(r.query_idx, r.target_idx, r.is_reverse, r.score, r.cigar_string) for r in res]


def test_runner_band_tiling_equals_jax():
    """WfaAligner(band_tiling='auto') on the JAX test's corpus and budget:
    the JAX runner's records, tiled chunks, tile rows and padded cells, and
    the records of the port's untiled run."""
    ref, ref_res, port, res = _runner_pair()
    assert port.stats["tiled_chunks"] >= 1
    for k in ("tiled_chunks", "tiled_rows", "cells_padded", "run_overflows", "band_escalations"):
        assert port.stats[k] == ref.stats[k], k
    assert _records(res) == _records(ref_res)
    kinds = [d["kind"] for d in port.stats["dispatches"]]
    assert "tiled" in kinds
    off = WfaAligner(port.seqs, RunnerConfig(scores=AlignmentScores.parse(SCORES), threads=2,
                                             memory_budget_bytes=int(70e6)), device="cpu")
    assert _records(off.align_pairs(all_ordered_pairs(len(port.codes)))) == _records(res)
    assert off.stats["tiled_chunks"] == 0


def test_runner_band_tiling_run_overflow_retries(monkeypatch):
    """With RUN_MAX shrunk in both packages, tiled pairs whose walk overflows
    join _runs_off_set and re-run through the opcode walk, as in the JAX
    runner: equal records and counters."""
    monkeypatch.setattr(jnw, "RUN_MAX", 6)
    monkeypatch.setattr(nw, "RUN_MAX", 6)
    ref, ref_res, port, res = _runner_pair()
    assert port.stats["run_overflows"] > 0 and port.stats["tiled_chunks"] >= 1
    for k in ("tiled_chunks", "tiled_rows", "cells_padded", "run_overflows"):
        assert port.stats[k] == ref.stats[k], k
    assert _records(res) == _records(ref_res)


@pytest.mark.parametrize("case", ["mixed_r3", "w102", "int16"])
def test_tiled_walk_reads_no_row_past_t_final_plus_2(case):
    """Kernel A's tiled mode promises each pair's rows 0 .. min(tmax,
    t_final + 2) only (nw_cuda.tiled_promised_rows; the card leaves the
    rest unwritten): with every other row of every tile row overwritten by
    random bytes, the plain tiled walk gives the untouched run's tokens and
    counts, and the JAX package's nw_align_with_runs_tiled's."""
    rng = np.random.default_rng({"mixed_r3": 7, "w102": 29, "int16": 13}[case])
    band, R, int16 = {"mixed_r3": (63, 3, False), "w102": (101, 3, False), "int16": (63, 3, True)}[case]
    narrow = _pairs(rng, 4, 180 if band < 100 else 300, indels=3)
    wide = _pairs(rng, 2, 180 if band < 100 else 300, inv_frac=0.3)
    Q, T, ql, tl, tile, is_wide = _layout(narrow, wide, band, R, B=len(narrow) + R * len(wide) + 2)
    tmax = -(-max(len(q) + len(t) for q, t in narrow + wide) // 512) * 512
    sc, tok, cnt, _tb_j = (np.asarray(a) for a in _jax_tiled(Q, T, ql, tl, tile, is_wide, band=band, R=R,
                                                              tmax=tmax, use_int16=int16))
    Qt, Tt, qt, tt = (torch.from_numpy(a) for a in (Q, T, ql, tl))
    lay = dict(band=band, n_tiles=R, tmax=tmax)
    _s, tb = nw_cuda.nw_align_tiled(Qt, Tt, qt, tt, tile, is_wide, int16=int16, **lay, **PEN)
    rows = nw_cuda.tiled_promised_rows(qt, tt, tile, is_wide, R, tmax, tb.shape[1])
    assert not rows.all() and rows[:, 0].all()
    noise = torch.from_numpy(rng.integers(0, 256, tuple(tb.shape), dtype=np.uint8))
    scrambled = torch.where(rows[:, :, None], tb, noise)
    got = [nw_cuda.nw_walk_runs_tiled(t, qt, tt, tile, is_wide, run_max=jnw.RUN_MAX, **lay) for t in (tb, scrambled)]
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])
    first = tile == 0
    np.testing.assert_array_equal(got[1][0].numpy()[first], tok[first])
    np.testing.assert_array_equal(got[1][1].numpy()[first], cnt[first])
