// Kernel A: banded two-piece-affine global Gotoh sweep by anti-diagonals.
//
// Replaces the Pallas kernel seqrush_tpu/ops/nw_pallas.py::_kernel (wrapped
// by nw_align_pallas).  Same DP, same operand framing, same tie order and the
// same packed traceback byte at every cell, valid or not, so the traceback
// tensor matches the plain PyTorch version (ops/nw_cuda.py::
// nw_align_reference) byte for byte.
//
// This header holds the device code; nw_sweep.cu instantiates the
// single-shot kernels (anti-diagonals 1..tmax) and nw_sweep_seg.cu the
// segment mode (below), so nvcc builds the two in parallel.
//
// What bounds it on an H100: integer instructions.  Every needed cell costs a few
// dozen int32 instructions (the recurrence, the tie-ordered choice, the
// clamps and the byte packing) against one traceback byte written, so the
// SMs' integer pipes, not memory, set the floor.  The anti-diagonal
// recurrence is a serial chain per pair, so the other costs are whatever
// stalls that chain: barriers, shared-memory round trips, register moves,
// and SM sub-partitions left with fewer pairs than others.
//
// Design (register route, nw_sweep_regs):
//   * the DP lanes live in registers.  Thread r of a pair owns the S
//     contiguous lanes [r*S, r*S + S); a cell reads only lanes l + dp - 1 and
//     l + dp of the previous rows (i0 moves by 0 or 1 per anti-diagonal), so
//     the only values that cross threads are the strip edges, by
//     __shfl_up_sync / __shfl_down_sync inside a warp.  Where one pair spans
//     several warps, the warp-edge values go through a double-buffered
//     shared-memory slot with one named barrier over that pair's warps
//     (bar.sync id, count; a block holds at most two such pairs), never
//     over the whole block;
//   * dp and dpp (the lane shifts to the previous two rows) are uniform over
//     the pair: (0, 0) up to t = K, then (1, 1) and (0, 1) in turn.  The
//     sweep runs in those phases, two anti-diagonals per iteration in the
//     second, so each step is compiled for its shifts with the lane loop
//     unrolled and the rows rotate without register moves;
//   * the recurrence is Hopper DPX: each gap state and its opened bit is one
//     __vibmin_s32 (min and the '<=' predicate); H and its choice are two
//     unsigned 3-way mins over keys value * 8 + tag, whose ties pick the
//     smaller tag, i.e. the earlier candidate, as the reference's strict '<'
//     in the order D1, I1, D2, I2 does; validity and the INF clamp of each
//     state are one __viaddmin_s32(x, valid ? 0 : INF, INF).  The keys and
//     that clamp need every value in [0, 2^31 / 8): the planner gives this
//     route only penalties in [0, 2^16), under which every value is at most
//     INF + 2^17;
//   * the pair's query and reversed, padded target are staged once in shared
//     memory; each thread keeps its S bases of each in a register window that
//     slides by one base when the clamped window start moves;
//   * a thread's S traceback bytes are packed into 32-bit words and stored as
//     one 16-, 8- or 4-byte store where W allows it (byte stores at a ragged
//     edge);
//   * anti-diagonals from t_final + 3 on see only INF inputs, so their byte
//     is one of two constants chosen by the base comparison; those rows skip
//     the recurrence and the exchanges;
//   * S is 4, 8, 12 or 16; the planner (ops/nw_cuda.py::plan_sweep) picks
//     S, warps per pair and pairs per block by the work on the busiest SM
//     sub-partition.
// Score-only mode (TB = false; the wrapper passes a null traceback pointer):
// the same sweep with every traceback store left out and the rows past
// t_final not visited, for the anchored route's verify sweep, which needs
// the scores alone.  Its instantiations are separate, so the full mode's
// code and register budget do not change.
// Segment mode (SEG = true; replaces seqrush_tpu/ops/nw.py::_nw_segment, the
// step of nw_align_long): a run of n_run segments of seg anti-diagonals in
// turn, starting from a carry of the six DP rows [6, B, W] int32 (H at
// t_lo - 1 and t_lo - 2, I1, D1, I2, D2 at t_lo - 1) and storing the carry
// after each segment as the step loop passes it, with the traceback rows in
// a [B, tb_rows, W] tensor (none in score-only mode).  A thread loads its
// strip and its edge neighbours straight from the carry and enters the step
// loop in the phase of t_lo.  Only one segment's windows of the query and
// the reversed target are staged (at most seg / 2 + 1 + L and seg + L
// bytes), restaged between two segments of a run behind a barrier over the
// pair's warps, so the shared memory of a pair does not grow with its
// length and a pair of any length stays on the register route.  The grid's
// second dimension is the group: grid row y sweeps its own run from the
// carry y * n_run segments on, into its own rows of the traceback, so one
// launch recomputes a group of segments from their checkpoints at once (the
// long route's reverse pass: pair x segment blocks, whose serial chains hide
// each other's latency where one segment's pairs leave most SMs idle).  The
// forward pass is one grid row whose run crosses the segment boundaries.
// Both modes run the recurrence to t_final + 2, where every state is INF, so
// the strips then hold the carry of any later row.  Its instantiations are
// separate kernels (nw_sweep_regs_seg).
// Bands too wide for registers, penalties outside [0, 2^16), int16 adds
// that can wrap and pairs whose sequences do not fit in shared memory take
// the wide route (nw_sweep_wide.cuh: nw_sweep_wide in nw_sweep_wide.cu,
// nw_sweep_wide_seg in nw_sweep_wide_seg.cu): one pair a thread-block
// cluster, its lanes in registers, plain compares.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NW_INF (1 << 28)
#define NW_INF16 30000
#define NW_QPAD 6
#define NW_TPAD 7
#define NW_ROWS 11
#define FULL_MASK 0xffffffffu

// neg: the DP's +infinity, NW_INF or, in the int16 mode, NW_INF16; i16: the
// int16 mode (see the design note).
struct Pen {
  int mis, oe1, e1, oe2, e2;
  int neg = NW_INF;
  bool i16 = false;
};

// The fold's snapshot mode (nw_align's t_snap): per pair the anti-diagonal
// t_snap[b] and the outputs SNAP [6, B, W] and DIAGA, DIAGB [B, W] int32,
// which the wrapper fills with neg; snap is null when the mode is off.  On
// the register route the mode is a template flag (nw_sweep_snap.cu), so the
// other instantiations carry none of it.
struct SnapArgs {
  const int* t_snap;
  int* snap;
  int* diaga;
  int* diagb;
};

// Segment mode's arguments.  Grid row y sweeps the n_run segments of seg
// anti-diagonals from t_lo + y * n_run * seg on, from the carry at carry_in
// + y * n_run * cstride ([6, B, W] int32), storing the carry after its k-th
// segment at carry_out + (y * n_run + k) * cstride while k < n_out
// (carry_out may be null), and its rows from traceback row y * n_run * seg
// on (tb_rows rows a pair).  scores_in: the scores before the run, or null
// where the caller has filled the scores with -1.
struct SegArgs {
  const int* carry_in;
  int* carry_out;
  const int* scores_in;
  int t_lo, seg, n_run, n_out, tb_rows;
  size_t cstride;
};

__device__ __forceinline__ int i0_of(int t, int K) {
  // max(floor((t - K + 1) / 2), 0): negative numerators clamp to 0 anyway
  const int x = t - K + 1;
  return x > 0 ? (x >> 1) : 0;
}

__device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// One cell from its framed neighbours, where every input is in [0, neg] and
// every penalty in [0, 2^16) (see the design note).  `off` is 0 on a valid
// cell and neg on an invalid one; the new states come back clamped and neg
// off the matrix, ready to store.  __vibmin_s32(a, b, &pred) returns
// min(a, b) and sets pred = (a <= b): the opened bits are that predicate
// ('<=' keeps the opening on a tie).  With one-piece penalties I2/D2 are INF
// and still take part in the choice, as in the reference.
template <bool TWO>
__device__ __forceinline__ uint32_t cell_keyed(int h_up, int h_left, int h_diag, int i1_up,
                                               int d1_left, int i2_up, int d2_left, int sub,
                                               int off, const Pen& p, int& Hn, int& I1n,
                                               int& D1n, int& I2n, int& D2n) {
  bool op;
  const int i1 = __vibmin_s32(h_up + p.oe1, i1_up + p.e1, &op);
  uint32_t byte = op ? 8u : 0u;
  const int d1 = __vibmin_s32(h_left + p.oe1, d1_left + p.e1, &op);
  byte |= op ? 32u : 0u;
  int i2 = p.neg, d2 = p.neg;
  if (TWO) {
    i2 = __vibmin_s32(h_up + p.oe2, i2_up + p.e2, &op);
    byte |= op ? 16u : 0u;
    d2 = __vibmin_s32(h_left + p.oe2, d2_left + p.e2, &op);
    byte |= op ? 64u : 0u;
  }
  // candidates in the reference's order carry tags 0..4 (the choice codes)
  const uint32_t k01 = __vimin3_u32((uint32_t)(h_diag + sub) << 3, ((uint32_t)d1 << 3) | 1u,
                                    ((uint32_t)i1 << 3) | 2u);
  const uint32_t key = __vimin3_u32(k01, ((uint32_t)d2 << 3) | 3u, ((uint32_t)i2 << 3) | 4u);
  Hn = __viaddmin_s32((int)(key >> 3), off, p.neg);
  I1n = __viaddmin_s32(i1, off, p.neg);
  D1n = __viaddmin_s32(d1, off, p.neg);
  if (TWO) {
    I2n = __viaddmin_s32(i2, off, p.neg);
    D2n = __viaddmin_s32(d2, off, p.neg);
  }
  return byte | (key & 7u);
}

// values of the neighbouring strips: H(t-1), H(t-2), I1/I2(t-1) at lane
// s0 - 1, and H(t-1), D1/D2(t-1) at lane s0 + S
struct Edges {
  int hl1, hl2, i1l, i2l, hr1, d1r, d2r;
};

template <int S>
struct Strip {
  int h1[S], h2[S], i1[S], d1[S], i2[S], d2[S];
  int qw[S], tw[S];  // query / reversed-target bases under the lanes
};

// What a thread needs beside its strip: the pair's operands and geometry.
struct Pair {
  const uint8_t* Qs;  // staged query, shared memory
  const uint8_t* Ts;  // staged reversed target, shared memory
  uint8_t* tbb;       // the pair's traceback [tmax_pad, W] ([seg, W] in segment mode)
  int* score;
  int* slots;         // warp-edge slots [2][wpp][6]
  int s0, K, W, Lq, Lt, qlen, tlen, t_final, walign, lane, wip, wpp, pib;
  int neg;            // the DP's +infinity (Pen::neg)
  // snapshot mode: the pair's SNAP row 0 (planes `plane` apart), DIAGA and
  // DIAGB rows, and its t_snap
  int* snap;
  int* diaga;
  int* diagb;
  size_t plane;
  int t_snap;
  // segment mode only: the padded-operand index of Qs[0] and Ts[0], and
  // the anti-diagonal of tbb's row 0
  int qb, tb0, row0;
  // tiled mode only (nw_sweep_tiled.cu): the tile-row width tw (W is the
  // pair's lanes, n_tiles * tw for a wide pair), the bytes from one tile
  // row to the next (tmax_pad * tw), the offset of the tile row that holds
  // the strip's first lane and that lane in it, and whether the strip
  // crosses a tile row's end
  int tw, tc0;
  size_t tstride, trow;
  bool split;
};

// Barrier over the warps of pair `pib` of the block (at most NPAIRS
// multi-warp pairs a block: two, or four in the tiled mode).  The ids are
// immediates so that a block reserves NPAIRS + 1 barriers (0 for
// __syncthreads), not all sixteen: the SM's barriers would otherwise cap its
// resident blocks at four.
template <int NPAIRS = 2>
__device__ __forceinline__ void bar_pair(int pib, int count) {
  if (pib == 0)
    asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
  else if (NPAIRS <= 2 || pib == 1)
    asm volatile("bar.sync 2, %0;" ::"r"(count) : "memory");
  else if (NPAIRS <= 3 || pib == 2)
    asm volatile("bar.sync 3, %0;" ::"r"(count) : "memory");
  else
    asm volatile("bar.sync 4, %0;" ::"r"(count) : "memory");
}

// One anti-diagonal of the recurrence over the thread's S lanes.  DP/DPP:
// the lane shift to rows t-1 and t-2.  Lane k is valid iff
// (unsigned)(k - vlo) <= vspan, or, with ALL (the caller knows every lane
// is), always.  Packs the bytes into words[].
template <int S, bool TWO, int DP, int DPP, bool ALL = false>
__device__ __forceinline__ void sweep_step(Strip<S>& s, const Edges& e, const Pen& p, int vlo,
                                           uint32_t vspan, uint32_t (&words)[(S + 3) / 4]) {
  int nh[S], ni1[S], nd1[S], ni2[S], nd2[S];
#pragma unroll
  for (int w = 0; w < (S + 3) / 4; ++w) words[w] = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int h_up = DP ? s.h1[k] : (k ? s.h1[k - 1] : e.hl1);
    const int h_left = DP ? (k < S - 1 ? s.h1[k + 1] : e.hr1) : s.h1[k];
    const int h_diag = DPP ? s.h2[k] : (k ? s.h2[k - 1] : e.hl2);
    const int i1_up = DP ? s.i1[k] : (k ? s.i1[k - 1] : e.i1l);
    const int d1_left = DP ? (k < S - 1 ? s.d1[k + 1] : e.d1r) : s.d1[k];
    int i2_up = p.neg, d2_left = p.neg;
    if (TWO) {
      i2_up = DP ? s.i2[k] : (k ? s.i2[k - 1] : e.i2l);
      d2_left = DP ? (k < S - 1 ? s.d2[k + 1] : e.d2r) : s.d2[k];
    }
    const int sub = s.qw[k] == s.tw[k] ? 0 : p.mis;
    const int off = (ALL || (uint32_t)(k - vlo) <= vspan) ? 0 : p.neg;
    const uint32_t byte = cell_keyed<TWO>(h_up, h_left, h_diag, i1_up, d1_left, i2_up, d2_left,
                                          sub, off, p, nh[k], ni1[k], nd1[k], ni2[k], nd2[k]);
    words[k >> 2] |= byte << (8 * (k & 3));
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    s.h2[k] = s.h1[k];
    s.h1[k] = nh[k];
    s.i1[k] = ni1[k];
    s.d1[k] = nd1[k];
    if (TWO) {
      s.i2[k] = ni2[k];
      s.d2[k] = nd2[k];
    }
  }
}

// Exchange the strip edges of the rows just computed (and of the initial
// rows) with the neighbouring threads.
template <int S, bool TWO, int NPAIRS = 2>
__device__ __forceinline__ void exchange(const Strip<S>& s, Edges& e, const Pair& pr, int parity) {
  e.hl2 = e.hl1;
  int hl = __shfl_up_sync(FULL_MASK, s.h1[S - 1], 1);
  int il = __shfl_up_sync(FULL_MASK, s.i1[S - 1], 1);
  int hr = __shfl_down_sync(FULL_MASK, s.h1[0], 1);
  int dr = __shfl_down_sync(FULL_MASK, s.d1[0], 1);
  int i2l = pr.neg, d2r = pr.neg;
  if (TWO) {
    i2l = __shfl_up_sync(FULL_MASK, s.i2[S - 1], 1);
    d2r = __shfl_down_sync(FULL_MASK, s.d2[0], 1);
  }
  if (pr.lane == 0) hl = il = i2l = pr.neg;
  if (pr.lane == 31) hr = dr = d2r = pr.neg;
  if (pr.wpp > 1) {
    int* sl = pr.slots + (parity * pr.wpp + pr.wip) * 6;
    if (pr.lane == 31) {
      sl[0] = s.h1[S - 1];
      sl[1] = s.i1[S - 1];
      sl[2] = TWO ? s.i2[S - 1] : pr.neg;
    }
    if (pr.lane == 0) {
      sl[3] = s.h1[0];
      sl[4] = s.d1[0];
      sl[5] = TWO ? s.d2[0] : pr.neg;
    }
    bar_pair<NPAIRS>(pr.pib, pr.wpp * 32);
    if (pr.lane == 0 && pr.wip > 0) {
      hl = sl[-6 + 0];
      il = sl[-6 + 1];
      i2l = sl[-6 + 2];
    }
    if (pr.lane == 31 && pr.wip < pr.wpp - 1) {
      hr = sl[6 + 3];
      dr = sl[6 + 4];
      d2r = sl[6 + 5];
    }
  }
  e.hl1 = hl;
  e.i1l = il;
  e.i2l = i2l;
  e.hr1 = hr;
  e.d1r = dr;
  e.d2r = d2r;
}

// Store the thread's S bytes of one traceback row: the widest aligned
// store W allows when the strip lies inside the band, else byte by byte.
template <int S>
__device__ __forceinline__ void store_row(uint8_t* row, int s0, int W, int walign,
                                          const uint32_t (&words)[(S + 3) / 4]) {
  if (s0 >= W) return;
  if (s0 + S <= W) {
    if (S % 16 == 0 && walign >= 16) {
#pragma unroll
      for (int w = 0; w < S / 4; w += 4)
        *reinterpret_cast<uint4*>(row + s0 + 4 * w) =
            make_uint4(words[w], words[w + 1], words[w + 2], words[w + 3]);
      return;
    }
    if (S % 8 == 0 && walign >= 8) {
#pragma unroll
      for (int w = 0; w < S / 4; w += 2)
        *reinterpret_cast<uint2*>(row + s0 + 4 * w) = make_uint2(words[w], words[w + 1]);
      return;
    }
    if (S % 4 == 0 && walign >= 4) {
#pragma unroll
      for (int w = 0; w < S / 4; ++w) *reinterpret_cast<uint32_t*>(row + s0 + 4 * w) = words[w];
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (s0 + k < W) row[s0 + k] = (uint8_t)(words[k >> 2] >> (8 * (k & 3)));
}

// shared-memory layout of one pair: padded query, padded reversed target,
// edge slots.  Mirrored by ops/nw_cuda.py::pair_smem_bytes.
__device__ __forceinline__ int pair_q_bytes(int Lq, int L) { return round16(Lq + 1 + L); }
__device__ __forceinline__ int pair_t_bytes(int Lt, int W, int L) { return round16(Lt + W + L); }
// In segment mode, the windows of seg anti-diagonals: the query start moves
// by at most seg / 2 over them, the target start by at most seg - 1.
__device__ __forceinline__ int seg_q_bytes(int seg, int L) { return round16(seg / 2 + 1 + L); }
__device__ __forceinline__ int seg_t_bytes(int seg, int L) { return round16(seg + L); }

// Segment mode: stage the windows of the pair's query q and reversed target
// tg that anti-diagonals [a, a + seg - 1] read, thread r of tpp; qb and tb0
// get their first bytes' padded-operand indices (the window starts at a and
// at a + seg - 1, clamped as a dynamic slice is).
__device__ __forceinline__ void stage_windows(const uint8_t* q, const uint8_t* tg, int Lq, int Lt,
                                              int W, int L, int a, int seg, int r, int tpp,
                                              uint8_t* Qs, uint8_t* Ts, int& qb, int& tb0) {
  const int e = a + seg - 1;
  qb = min(i0_of(a, W - 1), Lq + 1);
  tb0 = max(0, min(Lt - e + i0_of(e, W - 1) + W, Lt + W));
  const int qn = min(i0_of(e, W - 1), Lq + 1) - qb + L;
  const int tn = max(0, min(Lt - a + i0_of(a, W - 1) + W, Lt + W)) - tb0 + L;
  for (int x = r; x < qn; x += tpp) {
    const int xa = qb + x;
    Qs[x] = (xa >= 1 && xa <= Lq) ? q[xa - 1] : NW_QPAD;
  }
  for (int y = r; y < tn; y += tpp) {
    const int ya = tb0 + y;
    Ts[y] = (ya >= W && ya < W + Lt) ? tg[Lt - 1 - (ya - W)] : NW_TPAD;
  }
}

template <int S, bool SEG>
__device__ __forceinline__ void load_windows(Strip<S>& s, const Pair& pr, int qs, int ts) {
  const int qo = SEG ? qs - pr.qb : qs;
  const int to = SEG ? ts - pr.tb0 : ts;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    s.qw[k] = pr.Qs[qo + pr.s0 + k];
    s.tw[k] = pr.Ts[to + pr.s0 + k];
  }
}

// Slide the base windows to anti-diagonal t: the query start moves by 0 or
// +1, the target start by 0 or -1, except where the clamps hold them.
template <int S, bool SEG>
__device__ __forceinline__ void slide_windows(Strip<S>& s, const Pair& pr, int t, int& qs,
                                              int& ts) {
  const int i0 = i0_of(t, pr.K);
  const int nqs = min(i0, pr.Lq + 1);
  const int nts = max(0, min(pr.Lt - t + i0 + pr.W, pr.Lt + pr.W));
  if (nqs == qs + 1) {
#pragma unroll
    for (int k = 0; k < S - 1; ++k) s.qw[k] = s.qw[k + 1];
    s.qw[S - 1] = pr.Qs[(SEG ? nqs - pr.qb : nqs) + pr.s0 + S - 1];
  } else if (nqs != qs) {
    load_windows<S, SEG>(s, pr, nqs, ts);
  }
  if (nts == ts - 1) {
#pragma unroll
    for (int k = S - 1; k > 0; --k) s.tw[k] = s.tw[k - 1];
    s.tw[0] = pr.Ts[(SEG ? nts - pr.tb0 : nts) + pr.s0];
  } else if (nts != ts) {
    load_windows<S, SEG>(s, pr, nqs, nts);
  }
  qs = nqs;
  ts = nts;
}

// Snapshot mode: the clamped diagonal candidate h_diag + sub of anti-
// diagonal t's lanes (before its step) into row `out` of DIAGA or DIAGB.
template <int S, int DPP>
__device__ __forceinline__ void snap_diag(const Strip<S>& s, const Edges& e, const Pair& pr,
                                          const Pen& p, int vlo, uint32_t vspan, int* out) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int h_diag = DPP ? s.h2[k] : (k ? s.h2[k - 1] : e.hl2);
    const int sub = s.qw[k] == s.tw[k] ? 0 : p.mis;
    const int off = (uint32_t)(k - vlo) <= vspan ? 0 : p.neg;
    if (pr.s0 + k < pr.W) out[pr.s0 + k] = __viaddmin_s32(h_diag + sub, off, p.neg);
  }
}

// Snapshot mode: the strip's carry after anti-diagonal t_snap into SNAP.
template <int S, bool TWO>
__device__ __forceinline__ void snap_carry(const Strip<S>& s, const Pair& pr) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int l = pr.s0 + k;
    if (l < pr.W) {
      pr.snap[l] = s.h1[k];
      pr.snap[pr.plane + l] = s.h2[k];
      pr.snap[2 * pr.plane + l] = s.i1[k];
      pr.snap[3 * pr.plane + l] = s.d1[k];
      pr.snap[4 * pr.plane + l] = TWO ? s.i2[k] : pr.neg;
      pr.snap[5 * pr.plane + l] = TWO ? s.d2[k] : pr.neg;
    }
  }
}

// Anti-diagonal t (>= 2) of the recurrence: slide the windows, step, store
// the traceback row (TB), take the score at t_final, exchange the edges.
// In segment mode the score is taken only where none was before.  In the
// snapshot mode the captures of t_snap and t_snap + 1 are predicated stores.
template <int S, bool TWO, bool TB, bool SEG, bool SNAP, int DP, int DPP>
__device__ __forceinline__ void advance(Strip<S>& s, Edges& e, const Pair& pr, const Pen& p,
                                        int t, int& qs, int& ts) {
  if (t > 1) slide_windows<S, SEG>(s, pr, t, qs, ts);
  const int i0 = i0_of(t, pr.K);
  // valid lanes: t - tlen - i0 <= l <= min(qlen, t) - i0, and l < W
  const int lo = t - pr.tlen - i0;
  const int hi = min(min(pr.qlen, t) - i0, pr.W - 1);
  int vlo = lo - pr.s0;
  uint32_t vspan = (uint32_t)(hi - lo);
  if (hi < lo) {
    vlo = -(1 << 30);
    vspan = 0;
  }
  if (SNAP && (unsigned)(t - pr.t_snap) <= 1u)
    snap_diag<S, DPP>(s, e, pr, p, vlo, vspan, t == pr.t_snap ? pr.diaga : pr.diagb);
  uint32_t words[(S + 3) / 4];
  sweep_step<S, TWO, DP, DPP>(s, e, p, vlo, vspan, words);
  if (TB) store_row<S>(pr.tbb + (size_t)(SEG ? t - pr.row0 : t) * pr.W, pr.s0, pr.W, pr.walign, words);
  if (SNAP && t == pr.t_snap) snap_carry<S, TWO>(s, pr);
  if (t == pr.t_final) {
    const int fl = pr.qlen - i0 - pr.s0;
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (k == fl && pr.s0 + k < pr.W && s.h1[k] < NW_INF && (!SEG || *pr.score < 0))
        *pr.score = s.h1[k];
  }
  exchange<S, TWO>(s, e, pr, t & 1);
}

// Anti-diagonals [a, hi] of the recurrence in the phases of the shifts: up
// to K (0, 0), then (1, 1) and (0, 1) in turn, two an iteration.  Returns
// the anti-diagonal after the last one swept (a when hi < a).  ANY_START: a
// may lie past K where (a - K) is even (a segment's start, or the snapshot
// mode's spans).
template <int S, bool TWO, bool TB, bool SEG, bool SNAP, bool ANY_START = SEG>
__device__ __forceinline__ int sweep_span(Strip<S>& s, Edges& e, const Pair& pr, const Pen& p, int a,
                                          int hi, int& qs, int& ts) {
  const int K = pr.K;
  int t = a;
  for (; t <= hi && t <= K; ++t) advance<S, TWO, TB, SEG, SNAP, 0, 0>(s, e, pr, p, t, qs, ts);
  if (ANY_START && t <= hi && ((t - K) & 1) == 0)
    advance<S, TWO, TB, SEG, SNAP, 0, 1>(s, e, pr, p, t++, qs, ts);
  for (; t + 1 <= hi; t += 2) {  // (t - K) is odd here
    advance<S, TWO, TB, SEG, SNAP, 1, 1>(s, e, pr, p, t, qs, ts);
    advance<S, TWO, TB, SEG, SNAP, 0, 1>(s, e, pr, p, t + 1, qs, ts);
  }
  if (t <= hi) advance<S, TWO, TB, SEG, SNAP, 1, 1>(s, e, pr, p, t++, qs, ts);
  return t;
}

// Traceback rows [t, t_end] past t_final + 2, where every input is INF: each
// byte is one of two constants chosen by the base comparison.
template <int S, bool TWO, bool SEG>
__device__ __forceinline__ void cheap_rows(Strip<S>& s, const Pair& pr, const Pen& p, int t,
                                           int t_end, int& qs, int& ts) {
  uint32_t cheap_eq, cheap_ne;
  {
    int a, c, d, f, g;
    const int n = p.neg;
    cheap_eq = cell_keyed<TWO>(n, n, n, n, n, n, n, 0, n, p, a, c, d, f, g);
    cheap_ne = cell_keyed<TWO>(n, n, n, n, n, n, n, p.mis, n, p, a, c, d, f, g);
  }
  constexpr int NWORD = (S + 3) / 4;
  for (; t <= t_end; ++t) {
    if (t > 1) slide_windows<S, SEG>(s, pr, t, qs, ts);
    uint32_t words[NWORD];
#pragma unroll
    for (int w = 0; w < NWORD; ++w) words[w] = 0;
#pragma unroll
    for (int k = 0; k < S; ++k)
      words[k >> 2] |= (s.qw[k] == s.tw[k] ? cheap_eq : cheap_ne) << (8 * (k & 3));
    store_row<S>(pr.tbb + (size_t)(SEG ? t - pr.row0 : t) * pr.W, pr.s0, pr.W, pr.walign, words);
  }
}

// Barrier over the warps of one pair (segment mode's restaging).
__device__ __forceinline__ void pair_sync(const Pair& pr) {
  if (pr.wpp == 1)
    __syncwarp();
  else
    bar_pair<2>(pr.pib, pr.wpp * 32);
}

// The register route's kernel body: anti-diagonals 1..tmax of every pair
// from the initial rows, or in segment mode grid row blockIdx.y's run of
// segments from its carry (see the design note).
template <int S, bool TWO, bool TB, bool SEG, bool SNAP = false>
__device__ __forceinline__ void sweep_regs_body(
    const uint8_t* __restrict__ Q,  // [B, Lq] query codes, QPAD-padded
    const uint8_t* __restrict__ T,  // [B, Lt] target codes, TPAD-padded
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    int* __restrict__ scores,        // [B] out
    uint8_t* __restrict__ tb,        // [B, tmax_pad, W] ([B, tb_rows, W] in segment mode) out (TB only)
    int B, int Lq, int Lt, int W, int tmax, int tmax_pad, const Pen& p, int wpp, int ppb,
    int pair_bytes, const SegArgs sa, const SnapArgs sn = SnapArgs{}) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pib = warp / wpp;  // pair in block
  const int wip = warp - pib * wpp;  // warp in pair
  const int b = blockIdx.x * ppb + pib;
  const int tpp = wpp * 32;
  const int r = wip * 32 + lane;
  const int L = S * tpp;  // lanes covered, >= W
  const int seg = SEG ? sa.seg : 0;
  // segment mode: grid row gy's first anti-diagonal and the carries, rows
  // and segments before it
  const int gy = SEG ? (int)blockIdx.y : 0;
  const int before = SEG ? gy * sa.n_run : 0;
  const int t_first = SEG ? sa.t_lo + before * seg : 1;

  uint8_t* Qs = smem + (size_t)pib * pair_bytes;
  uint8_t* Ts = Qs + (SEG ? seg_q_bytes(seg, L) : pair_q_bytes(Lq, L));
  const uint8_t* q = Q + (size_t)b * Lq;
  const uint8_t* tg = T + (size_t)b * Lt;

  // stage [QPAD] + q + [QPAD]* and [TPAD]*W + reverse(t) + [TPAD]* (in
  // segment mode the first segment's windows of them); the score starts at
  // -1 (in segment mode at its value before the run, or as the caller filled
  // it) before the barrier orders it ahead of the final write
  int qb = 0, tb0 = 0;
  if (b < B) {
    if (SEG) {
      stage_windows(q, tg, Lq, Lt, W, L, t_first, seg, r, tpp, Qs, Ts, qb, tb0);
      if (r == 0 && sa.scores_in) scores[b] = sa.scores_in[b];
    } else {
      for (int x = r; x < Lq + 1 + L; x += tpp) Qs[x] = (x >= 1 && x <= Lq) ? q[x - 1] : NW_QPAD;
      for (int y = r; y < Lt + W + L; y += tpp)
        Ts[y] = (y >= W && y < W + Lt) ? tg[Lt - 1 - (y - W)] : NW_TPAD;
      // the int16 mode reads an empty pair's score at the origin, as the
      // JAX package's int16 sweep does
      if (r == 0) scores[b] = (p.i16 && qlens[b] + tlens[b] == 0) ? 0 : -1;
    }
  }
  __syncthreads();
  if (b >= B) return;

  Pair pr;
  pr.Qs = Qs;
  pr.Ts = Ts;
  pr.tbb = TB ? tb + ((size_t)b * (SEG ? sa.tb_rows : tmax_pad) + (size_t)before * seg) * W
              : nullptr;
  pr.score = scores + b;
  pr.slots = reinterpret_cast<int*>(Ts + (SEG ? seg_t_bytes(seg, L) : pair_t_bytes(Lt, W, L)));
  pr.s0 = r * S;
  pr.K = W - 1;
  pr.W = W;
  pr.Lq = Lq;
  pr.Lt = Lt;
  pr.qlen = qlens[b];
  pr.tlen = tlens[b];
  pr.t_final = pr.qlen + pr.tlen;
  pr.walign = (W & 15) == 0 ? 16 : (W & 7) == 0 ? 8 : (W & 3) == 0 ? 4 : 1;
  pr.lane = lane;
  pr.wip = wip;
  pr.wpp = wpp;
  pr.pib = pib;
  pr.neg = p.neg;
  if (SNAP) pr.t_snap = sn.t_snap[b];
  if (SEG) {
    pr.qb = qb;
    pr.tb0 = tb0;
    pr.row0 = t_first;
  }
  const int K = pr.K;
  constexpr int NWORD = (S + 3) / 4;

  // traceback row 0 and the padding rows past tmax are zero
  if (TB && !SEG) {
    uint32_t zero[NWORD];
#pragma unroll
    for (int w = 0; w < NWORD; ++w) zero[w] = 0;
    store_row<S>(pr.tbb, pr.s0, W, pr.walign, zero);
    for (int t = tmax + 1; t < tmax_pad; ++t)
      store_row<S>(pr.tbb + (size_t)t * W, pr.s0, W, pr.walign, zero);
  }

  Strip<S> s;
  Edges e;
  const size_t plane = (size_t)B * W;  // one row of the carry
  if (SEG) {
    // the strip and its edge neighbours from the carry (lanes >= W are INF)
    const int* c = sa.carry_in + (size_t)before * sa.cstride + (size_t)b * W;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int l = pr.s0 + k;
      const bool in = l < W;
      s.h1[k] = in ? c[l] : NW_INF;
      s.h2[k] = in ? c[plane + l] : NW_INF;
      s.i1[k] = in ? c[2 * plane + l] : NW_INF;
      s.d1[k] = in ? c[3 * plane + l] : NW_INF;
      s.i2[k] = (TWO && in) ? c[4 * plane + l] : NW_INF;
      s.d2[k] = (TWO && in) ? c[5 * plane + l] : NW_INF;
    }
    const int lf = pr.s0 - 1, rt = pr.s0 + S;
    const bool lin = lf >= 0 && lf < W, rin = rt < W;
    e.hl1 = lin ? c[lf] : NW_INF;
    e.hl2 = lin ? c[plane + lf] : NW_INF;
    e.i1l = lin ? c[2 * plane + lf] : NW_INF;
    e.i2l = (TWO && lin) ? c[4 * plane + lf] : NW_INF;
    e.hr1 = rin ? c[rt] : NW_INF;
    e.d1r = rin ? c[3 * plane + rt] : NW_INF;
    e.d2r = (TWO && rin) ? c[5 * plane + rt] : NW_INF;
  } else {
    // state at t = 0 (H row 0 is 0 at lane 0) and t = -1
#pragma unroll
    for (int k = 0; k < S; ++k) {
      s.h1[k] = (pr.s0 + k == 0) ? 0 : p.neg;
      s.h2[k] = p.neg;
      s.i1[k] = s.d1[k] = s.i2[k] = s.d2[k] = p.neg;
    }
    e.hl1 = p.neg;
    exchange<S, TWO>(s, e, pr, 0);
    e.hl2 = p.neg;  // H(-1)
    // t_snap == 0 snapshots the initial state: neg but H's origin
    if (SNAP && pr.t_snap == 0 && pr.s0 == 0) sn.snap[(size_t)b * W] = 0;
  }

  // from t_final + 3 on every input is INF (the states are INF past t_final);
  // without a traceback nothing past t_final is needed, except in segment
  // mode, whose carries then equal the strips
  const int last = (TB || SEG) ? pr.t_final + 2 : pr.t_final;

  if (SEG) {
    for (int k = 0; k < sa.n_run; ++k) {
      const int a = t_first + k * seg;
      const int t_end = a + seg - 1;
      // the segment's windows, into the last one's buffers once every
      // thread of the pair is done with them (a pair past its end reads
      // them only for the traceback's constant rows)
      const bool reads = TB || a <= last;
      if (k > 0 && reads) {
        pair_sync(pr);
        stage_windows(q, tg, Lq, Lt, W, L, a, seg, r, tpp, Qs, Ts, pr.qb, pr.tb0);
        pair_sync(pr);
      }
      int qs = min(i0_of(a, K), Lq + 1);
      int ts = max(0, min(Lt - a + i0_of(a, K) + W, Lt + W));
      if (reads) load_windows<S, SEG>(s, pr, qs, ts);
      const int t = sweep_span<S, TWO, TB, SEG, SNAP>(s, e, pr, p, a, min(t_end, last), qs, ts);
      if (TB) cheap_rows<S, TWO, SEG>(s, pr, p, t, t_end, qs, ts);
      if (k < sa.n_out) {
        int* c = sa.carry_out + (size_t)(before + k) * sa.cstride + (size_t)b * W;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int l = pr.s0 + j;
          if (l < W) {
            c[l] = s.h1[j];
            c[plane + l] = s.h2[j];
            c[2 * plane + l] = s.i1[j];
            c[3 * plane + l] = s.d1[j];
            c[4 * plane + l] = TWO ? s.i2[j] : NW_INF;
            c[5 * plane + l] = TWO ? s.d2[j] : NW_INF;
          }
        }
      }
    }
    return;
  }

  // window starts into the padded operands, clamped as a dynamic slice is
  int qs = min(i0_of(1, K), Lq + 1);
  int ts = max(0, min(Lt - 1 + i0_of(1, K) + W, Lt + W));
  load_windows<S, SEG>(s, pr, qs, ts);
  if (SNAP) {
    // The snapshot mode's rows end at t_snap + 1, or at t_final where the
    // score falls within tmax and later: anti-diagonals up to t_snap - 1
    // with no capture, the two captured ones, the rest to the score, and
    // the constant rows up to t_snap + 1 past t_final + 2.  The traceback
    // rows past that end are left unwritten.
    const int score_end = pr.t_final <= tmax ? pr.t_final : 0;
    const int end = min(min(tmax, last), max(pr.t_snap + 1, score_end));
    int t = sweep_span<S, TWO, TB, SEG, false, true>(s, e, pr, p, 1, min(end, pr.t_snap - 1), qs, ts);
    pr.snap = sn.snap + (size_t)b * W;
    pr.diaga = sn.diaga + (size_t)b * W;
    pr.diagb = sn.diagb + (size_t)b * W;
    pr.plane = (size_t)B * W;
    t = sweep_span<S, TWO, TB, SEG, true, true>(s, e, pr, p, t, min(end, pr.t_snap + 1), qs, ts);
    t = sweep_span<S, TWO, TB, SEG, false, true>(s, e, pr, p, t, end, qs, ts);
    if (TB) cheap_rows<S, TWO, SEG>(s, pr, p, t, min(tmax, pr.t_snap + 1), qs, ts);
    return;
  }
  const int t = sweep_span<S, TWO, TB, SEG, SNAP>(s, e, pr, p, 1, min(tmax, last), qs, ts);
  if (TB) cheap_rows<S, TWO, SEG>(s, pr, p, t, tmax, qs, ts);
}

// ---------------------------------------------------------------------------
// What the tiled mode's wide route (nw_sweep_tiled.cu) keeps of the port's
// first design: one block a pair, DP rows in shared memory or a global
// scratch.

// lane l of a row framed by a lane shift delta in {-1, 0, 1}, neg outside
__device__ __forceinline__ int framed(const int* row, int l, int delta, int W, int neg = NW_INF) {
  const int k = l + delta;
  return (k >= 0 && k < W) ? row[k] : neg;
}

// an add of the int16 mode there: the low 16 bits, sign-extended
// (the JAX package's int16 adds wrap)
__device__ __forceinline__ int add16(int a, int b, bool i16) {
  const int x = a + b;
  return i16 ? (int)(int16_t)x : x;
}

// ---------------------------------------------------------------------------

// Dynamic shared memory of a register-route launch: ppb pairs of pair_bytes.
static size_t dynamic_smem(int ppb, int pair_bytes) { return (size_t)ppb * pair_bytes; }

static cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The register route's snapshot-mode launch (nw_sweep_snap.cu), called by
// nw_sweep_launch: lanes S, the traceback always.
cudaError_t nw_sweep_snap_regs_launch(const void* Q, const void* T, const void* qlens,
                                      const void* tlens, void* scores, void* tb, int B, int Lq,
                                      int Lt, int W, int tmax, int tmax_pad, Pen p, bool two,
                                      int lanes, int wpp, int ppb, int pair_bytes, SnapArgs sn,
                                      cudaStream_t stream);

// The register route's snapshot-mode kernel for lanes and two-piece, or null
// (nw_sweep_snap.cu), for nw_sweep_occupancy.
const void* nw_sweep_snap_kernel(int lanes, bool two);
