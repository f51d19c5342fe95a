"""Kernel B's runs walk on gap runs (the walk gap corpus,
``tools/headline.py::walk_gap_corpus``), through its plain versions on the CPU,
against the JAX package's ``nw_align_with_runs`` and
``nw_align_with_runs_tiled``: scores, run tokens and counts bit-equal, with
the run cap at 1, 5, 31, 32 and 33 steps, one- and two-piece penalties and
a token budget that overflows.  Then the lane arithmetic the kernel uses to
look k gap steps ahead (``nw_cuda.gap_lane_shift``) and the path its tiles
follow (``nw_cuda.walk_path_lane``) against the plain walk's cursor stepped
one anti-diagonal at a time, tolerance 0 (all integer)."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from seqrush_tpu.ops import nw as jnw
from seqrush_tpu_torch.ops import nw, nw_cuda
from test_torch_tiled import _jax_tiled, _layout
from torch_edge_corpora import walk_gap_corpus, walk_gap_pairs

TWO = dict(mismatch=5, o1=8, e1=2, o2=24, e2=1)
ONE = dict(mismatch=5, o1=8, e1=2, o2=-1, e2=-1)
# case: (penalties, run_max, run-length cap)
CASES = {
    "cap1": (TWO, 128, 1),
    "cap5": (TWO, 128, 5),
    "cap31": (TWO, 128, 31),
    "cap32": (TWO, 128, 32),
    "cap33": (TWO, 128, 33),
    "one_piece": (ONE, 128, (1 << 14) - 1),
    "overflow": (TWO, 3, (1 << 14) - 1),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's (scores, tokens, counts) of the corpus for each case
    (its run cap is read while tracing: caches are dropped around it)."""
    Q, T, ql, tl, band, tmax = walk_gap_corpus()
    out = {}
    saved = jnw._RUN_LEN_MAX
    try:
        for name, (pen, run_max, cap) in CASES.items():
            jnw._RUN_LEN_MAX = cap
            jax.clear_caches()
            s, tok, cnt = jnw.nw_align_with_runs(Q, T, ql, tl, band=band, tmax=tmax, run_max=run_max, **pen)
            out[name] = (np.asarray(s), np.asarray(tok), np.asarray(cnt))
    finally:
        jnw._RUN_LEN_MAX = saved
        jax.clear_caches()
    return out


@pytest.fixture(scope="module")
def port_tb():
    """The port's sweep of the corpus under each penalty set (plain version)."""
    Q, T, ql, tl, band, tmax = walk_gap_corpus()
    Qt, Tt, qt, tt = (torch.from_numpy(a) for a in (Q, T, ql, tl))
    out = {}
    for key, pen in (("two", TWO), ("one", ONE)):
        out[key] = nw_cuda.nw_align(Qt, Tt, qt, tt, band=band, tmax=tmax, **pen)
    return out, qt, tt, band, tmax


@pytest.mark.parametrize("case", list(CASES))
def test_gap_corpus_run_tokens_equal_jax(case, jax_runs, port_tb):
    pen, run_max, cap = CASES[case]
    sweeps, qt, tt, band, tmax = port_tb
    scores, tb = sweeps["two" if pen is TWO else "one"]
    tok, cnt = nw_cuda.nw_walk_runs(tb, qt, tt, band=band, tmax=tmax, run_max=run_max, run_len_max=cap)
    j_s, j_tok, j_cnt = jax_runs[case]
    # the zero-length row has no final anti-diagonal in the port's sweep
    assert np.array_equal(scores.numpy()[:-1], j_s[:-1])
    assert np.array_equal(tok.numpy(), j_tok)
    assert np.array_equal(cnt.numpy(), j_cnt)
    # the runs cross the ballots' 32 steps and the tiles' 64 rows, and split at the cap
    lens = tok.numpy() >> 2
    ops = tok.numpy() & 3
    assert lens.max() <= cap
    if cap > 64:
        assert lens[ops == nw.OP_D].max() >= 150 and lens[ops == nw.OP_I].max() >= 65
    else:
        assert (lens == cap).any()
    if run_max < 16:
        assert (cnt.numpy() > run_max).any()
    assert int(cnt[-1]) == 0


def test_gap_corpus_tiled_run_tokens_equal_jax():
    """The tiled runs walk's plain version on the corpus laid out as a tiled
    chunk (the gappiest pairs wide, across two tile rows of W 200, whose
    path runs near lane 200, where a 32-lane window straddles the tile rows;
    the rest narrow): scores, tokens and counts of each pair's first row
    equal nw_align_with_runs_tiled's."""
    pairs = walk_gap_pairs()[:-1]
    gappy = {6, 7, 8, 11, 12}
    narrow = [p for k, p in enumerate(pairs) if k not in gappy]
    wide = [p for k, p in enumerate(pairs) if k in gappy]
    band, R = 199, 2
    Q, T, ql, tl, tile, is_wide = _layout(narrow, wide, band, R)
    tmax = -(-int((ql + tl).max()) // 512) * 512
    sc, tok, cnt, _tb = (np.asarray(a) for a in _jax_tiled(Q, T, ql, tl, tile, is_wide, band=band, R=R,
                                                           tmax=tmax, use_int16=False))
    Qt, Tt, qt, tt = (torch.from_numpy(a) for a in (Q, T, ql, tl))
    lay = dict(band=band, n_tiles=R, tmax=tmax)
    s_p, tb_p = nw_cuda.nw_align_tiled(Qt, Tt, qt, tt, tile, is_wide, **lay, **TWO)
    tok_p, cnt_p = nw_cuda.nw_walk_runs_tiled(tb_p, qt, tt, tile, is_wide, run_max=jnw.RUN_MAX, **lay)
    first = tile == 0
    np.testing.assert_array_equal(s_p.numpy()[first], sc[first])
    np.testing.assert_array_equal(tok_p.numpy()[first], tok[first])
    np.testing.assert_array_equal(cnt_p.numpy()[first], cnt[first])
    lens, ops = tok_p.numpy() >> 2, tok_p.numpy() & 3
    assert lens[is_wide[:, None] & (ops == nw.OP_D)].max() >= 190


def _stepped_lanes(K, td0, lane0, byte, mat, n):
    """The plain walk's cursor (nw_cuda._walk_rows) stepped one anti-diagonal
    at a time, n times, from (td0, lane0) in state mat over a traceback whose
    every in-band byte is `byte`: [(anti-diagonal, lane)] after each step."""
    W = K + 1
    tmax = td0 + 2
    tb = torch.full((1, nw.tmax_pad_of(tmax), W), byte, dtype=torch.uint8)
    ops = torch.zeros((1, tmax + 1), dtype=torch.uint8)
    state = torch.tensor([[td0], [lane0], [mat], [0]], dtype=torch.int64)
    out = []
    for _ in range(n):
        t = int(state[0, 0])
        nw_cuda._walk_rows(tb, 0, state, ops, t, t, K)
        out.append((int(state[0, 0]), int(state[1, 0])))
    return out


@pytest.mark.parametrize("K", [15, 16])
@pytest.mark.parametrize("g", [nw.H_D1, nw.H_I1, nw.H_D2, nw.H_I2])
def test_gap_lane_shift_equals_single_steps(K, g):
    """Every parity of td - K, each gap state, cursors above and below K and
    across it, in the gap from its first step (the H choice g) and inside it
    (state g): the lane after k steps is lane + gap_lane_shift(td, K, k)."""
    delete = bool(g & 1)
    for td0 in range(2, 3 * K + 4):
        for lane0 in (0, 1, K // 2, K):
            i0 = nw._i0_of(td0, K) + lane0
            j0 = td0 - i0
            if i0 < 0 or j0 < 0:
                continue
            n = min(j0 if delete else i0, 40)  # steps before the walk ends or leaves the pair
            for mat in (0, g):
                cells = _stepped_lanes(K, td0, lane0, g, mat, n)
                for k, (t, lane) in enumerate(cells, start=1):
                    assert t == td0 - k
                    assert lane == lane0 + nw_cuda.gap_lane_shift(td0, K, k, delete), (td0, lane0, mat, k)
                    assert lane == nw_cuda.walk_path_lane(lane0, td0, g, td0 - k, K)


@pytest.mark.parametrize("K", [15, 16])
def test_diagonal_path_lane_equals_single_steps(K):
    """The path the walk's tiles follow in state H (walk_path_lane, m 0) is
    where diagonal steps take the cursor, at every parity, above and below
    K."""
    for td0 in range(2, 3 * K + 4):
        for lane0 in (0, 1, K // 2, K):
            i0 = nw._i0_of(td0, K) + lane0
            j0 = td0 - i0
            if i0 < 0 or j0 < 0:
                continue
            for k, (t, lane) in enumerate(_stepped_lanes(K, td0, lane0, 0, 0, min(i0, j0)), start=1):
                assert t == td0 - 2 * k
                assert lane == nw_cuda.walk_path_lane(lane0, td0, 0, t, K), (td0, lane0, k)


@pytest.mark.parametrize("lo_lane,hi_lane", [(0, 512), (0, 200), (400, 600), (0, 40), (16, 32), (48, 56)])
def test_walk_row_window_holds_the_lane(lo_lane, hi_lane):
    """A tile row's window (walk_row_window) is the 32-byte sector that holds
    the path's lane: it holds the lane and only lanes of its row, lane c0 at
    a 32-byte boundary; a tiled row narrower than a sector (16 and 8 lanes)
    gives a window of its own lanes."""
    for lane in range(lo_lane, hi_lane):
        for base in (0, 5, 16, 31):
            addr = base + lane - lo_lane
            c0, s, e = nw_cuda.walk_row_window(lane, addr, lo_lane, hi_lane)
            assert c0 + s <= lane < c0 + e and lo_lane <= c0 + s and c0 + e <= hi_lane
            assert (addr - (lane - c0)) % 32 == 0 and 0 <= s < e <= 32
            assert (addr - (lane - c0 - s)) // 32 == addr // 32 == (addr - (lane - c0 - e + 1)) // 32


@pytest.mark.parametrize("name,value", [("WALK_R", nw_cuda.WALK_ROWS), ("WALK_DEPTH", nw_cuda.WALK_DEPTH),
                                        ("WALK_PAIRS_PER_BLOCK", nw_cuda.WALK_PAIRS_PER_BLOCK)])
def test_walk_constants_equal_the_kernel(name, value):
    """nw_cuda's copies of the walk's design constants (read by
    walk_occupancy and by the tile ring's model in test_torch_kernel_plan)
    equal the one #define of each in csrc/nw_walk.cu."""
    src = (Path(nw_cuda.__file__).parent / "csrc" / "nw_walk.cu").read_text()
    lines = re.findall(rf"^#\s*(?:define|ifdef|ifndef|undef)\s+{name}\b(.*)$", src, re.M)
    assert [v.split("//")[0].strip() for v in lines] == [str(value)]
