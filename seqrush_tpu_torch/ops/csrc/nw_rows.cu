// Kernels C and D: the row-major banded Gotoh sweep and its walk.
//
// Kernel C (nw_rows_sweep_kernel) replaces the XLA program
// seqrush_tpu/ops/nw.py::_sweep_rows: one step per query row r over the
// Wr = 2K + 1 lanes of the columns j = r - K + l, so a pair takes qlen steps
// instead of the anti-diagonal sweep's qlen + tlen.  Per row, with the
// previous row's H, I1, I2:
//   I1, I2  from the lane to the right in the previous row (the same column);
//   Ht      = min(H(diagonal) + sub, I1, I2), the gap-free choice tagged 0, 1, 2;
//   D1, D2  in closed form: D[l] = o + min_{k<l} (Ht[k] + (l - k) e), i.e.
//           o + l e + P[l] with P the exclusive prefix minimum of
//           A[k] = Ht[k] - k e; the opened bit is A[l-1] <= P[l-1], which is
//           P[l] == A[l-1] (A[-1] = P[0] = 2^30);
//   H       = min(Ht, D1, D2), the D override tagged 0, 1, 2.
// The byte layout, the saturation at the DP's +infinity (2^28; 30000 in the
// int16 mode, whose adds wrap to 16 bits as the JAX package's do, and which
// clamps Ht, I1 and I2 too) and every tie follow nw._sweep_rows, so the
// traceback tensor [B, R + 1, Wr] equals the plain version's
// (ops/nw_cuda.py::nw_align_rows_reference) byte for byte.
//
// What bounds it on an H100: the instructions a cell takes, issued by the
// pairs resident on each SM (the rows of a pair are serial, and its whole
// traceback, R + 1 rows of every pair, is written).  A row needs two
// prefix-minimum scans across its Wr lanes, so the pair's warps meet once a
// row.  The design (ops/nw_cuda.py::rows_plan picks the strip):
//   * one block a pair; thread r owns the S lanes [r * S, r * S + S) in
//     registers: 8 lanes on 4 warps at Wr <= 1,024 under
//     __launch_bounds__(128, 5), so five pairs fit an SM and the largest
//     dispatch (576 pairs on 132 SMs) runs in one wave, one warp a pair on
//     each SM sub-partition; wider bands take 8 or 16 lanes on up to 1,024
//     threads.  16 lanes on 2 warps and 4 on 8 were slower (PERF.md);
//   * one block barrier a row.  A scan is serial inside the strip, five
//     __shfl_up_sync rounds inside the warp, and one pass over the warps
//     before this one (each in a lane, one __reduce_min_sync).  The warps
//     publish, double-buffered by the row's parity, their scan total without
//     their last lane, that lane's diagonal candidate, and after the row
//     their first lane's H, I1, I2.  The last lane of a warp needs the next
//     warp's first lane of the previous row, so it is computed after the
//     barrier, by its own thread and by every later warp from the published
//     values (the same instructions, so the same value);
//   * few registers a lane, so the strip needs no packing at the 96 the
//     launch bound leaves: the lanes' ramps k e and k e + o are kernel
//     parameters (read from the constant bank), the scans inside a strip run
//     on A relative to its first lane, Ht is A + k e again, I1 and I2 update
//     in place;
//   * no global load on a row's chain: the pair's query and target are
//     staged in shared memory at the start, 16 bytes at a time where the
//     rows are aligned, each target row padded with TPAD; a lane reads its
//     target base there each row, and a row's query base is read a row
//     ahead.  Where a pair's rows do not fit the share of shared memory
//     that keeps the launch bound's pairs resident (past about 21,500 rows
//     at Wr <= 1,024), they are staged a window of rows at a time, the next
//     window behind one more barrier (ops/nw_cuda.py::rows_smem), in
//     instantiations of their own: the windows' loop in the same kernel
//     cost 3-4% at the main shape, even on a branch of its own;
//   * the int16 mode and the one-piece penalties are template flags, so the
//     int32 path carries none of the wraps and clamps.
// What is left is issue: five warps on each sub-partition, each issuing a
// cell's instructions (its choices and six traceback bits) for its 8 lanes
// and, once a row, the scans, the warps' last lanes and the exchange.
//
// Kernel D (nw_rows_walk_kernel) replaces the XLA program
// seqrush_tpu/ops/nw.py::_tb_rows_scan: one warp a pair walks from row qlen
// down, one query row a step: the M or I step of the row, and a D-run ending
// in the row resolved at once as the nearest lane at or left of the cursor
// whose D opened bit is set.  Its outputs are the step opcodes [B, R + 1],
// and the D-runs' rows and lengths at the G lowest rows, ascending
// (nw._tb_rows_scan's top_k), plus their count: the walk meets the lowest
// rows last, so it keeps the last G in a ring in shared memory and writes
// them out rotated at the end.
// What bounds it on an H100: the chain of a pair's rows, each step's byte
// picking the next cell, with about one pair per SM sub-partition (576 pairs
// on 132 SMs), so nothing hides a step's latency.  The first design read two
// or three bytes a row from device memory, each waiting on the last.  This
// one, as kernel B does (nw_walk.cu):
//   * the warp walks over a tile of its pair's traceback in shared memory,
//     64 rows x 32 lanes, the cursor 16 lanes from its left edge; a tile
//     row is copied as the three 16-byte blocks that cover its 32 lanes at
//     any alignment (rows are Wr bytes apart, an odd number), by cp.async
//     straight into shared memory, 6 copies a thread a tile; while the warp
//     walks one tile, the next two below it (around the cursor's lane) are
//     in flight.  A cursor that leaves a tile sideways (an I drift past its
//     right edge, a D-run past its left) loads a tile around itself; a
//     D-run search past the tile's left edge reads device memory, 32 lanes
//     a ballot;
//   * in state H, thread x reads the byte x rows down at the cursor's lane:
//     a byte with neither a D override nor an I choice is an M step that
//     keeps the lane, so one ballot takes the run of such rows before the
//     first other one (up to 32 rows: matches and mismatches, most of a
//     path), and its opcodes go out as one coalesced store;
//   * in I1 or I2, thread x reads the byte x rows down and x lanes right,
//     and one ballot takes the I steps up to the row whose opened bit closes
//     the gap;
//   * the rest (a D-run, an I step from H, row 0) is one row as before, read
//     from the tile.
// Its chain is then about one shared-memory round trip a 32 rows, plus one
// device-memory round trip a 64-row tile where the copies have not landed.
// (Tiles loaded a byte a row and thread into registers, as kernel B's are,
// ran as fast at [576, R 3,584, Wr 1,023] on 96 registers against 46.)

#include <cuda_runtime.h>
#include <stdint.h>

#define RW_INF (1 << 28)
#define RW_INF16 30000
#define RW_BIG (1 << 30)
#define RW_QPAD 6
#define RW_TPAD 7
#define RW_OP_M 1
#define RW_OP_I 2
#define RW_FULL 0xffffffffu
#define RW_MAX_WARPS 32
#define RW_WALK_PAIRS 4  // kernel D: one warp a pair

#define RW_MAX_LANES 16  // lanes a thread, at most

// The penalties, and per lane k of a strip k * e and k * e + o: kernel
// parameters, which the instructions read from the constant bank, so the
// lanes' ramps take no registers.
struct RowPen {
  int mis, o1, e1, oe1, o2, e2, oe2;
  int neg;  // the DP's +infinity
  int ke1[RW_MAX_LANES], ke2[RW_MAX_LANES], ko1[RW_MAX_LANES], ko2[RW_MAX_LANES];
};

// an add of the sweep: in the int16 mode the low 16 bits, sign-extended
template <bool I16>
__device__ __forceinline__ int radd(int a, int b) {
  const int x = a + b;
  return I16 ? (int)(int16_t)x : x;
}

// Shared memory of kernel C, by the row's parity: each warp's scan totals
// over its lanes but its last, that lane's diagonal candidate H + sub, and
// its first lane's H, I1, I2 after the row.
struct RowShared {
  int tot1[2][RW_MAX_WARPS], tot2[2][RW_MAX_WARPS], dg[2][RW_MAX_WARPS];
  int eh[2][RW_MAX_WARPS], ei1[2][RW_MAX_WARPS], ei2[2][RW_MAX_WARPS];
};

// Warp-inclusive prefix minimum of v (lane order): a lane below d gets its
// own v back from the shuffle, so the rounds need no predicate.
__device__ __forceinline__ int warp_incl_min(int v) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) v = min(v, __shfl_up_sync(RW_FULL, v, d));
  return v;
}

// The gap-free choice of a lane from its diagonal candidate diag = H + sub
// and the previous row's H, I1, I2 one lane to the right: Ht, the new I1 and
// I2, and the byte's bits 0-1 and 4-5.
template <bool TWO, bool I16>
__device__ __forceinline__ int rows_ht(int diag, int hu, int i1u, int i2u, const RowPen& p,
                                       int& I1n, int& I2n, uint32_t& low) {
  int a = radd<I16>(hu, p.oe1);
  int c = radd<I16>(i1u, p.e1);
  I1n = min(a, c);
  uint32_t by = (uint32_t)(a <= c) << 4;
  I2n = p.neg;
  if (TWO) {
    a = radd<I16>(hu, p.oe2);
    c = radd<I16>(i2u, p.e2);
    I2n = min(a, c);
    by |= (uint32_t)(a <= c) << 5;
  }
  int ht = diag;
  if (I16) {
    ht = min(ht, p.neg);
    I1n = min(I1n, p.neg);
    I2n = min(I2n, p.neg);
  }
  if (I1n < ht) {
    ht = I1n;
    by |= 1u;
  }
  if (I2n < ht) {
    ht = I2n;
    by = (by & ~3u) | 2u;
  }
  low = by;
  return ht;
}

// Copy n bytes of a row to shared memory, 16 bytes at a time: dst[j] =
// src[j + base] where 0 <= j + base < len, pad elsewhere (dst 16-aligned,
// base a multiple of 16, n a multiple of 16).
__device__ __forceinline__ void rows_stage(uint8_t* dst, const uint8_t* __restrict__ src, int len,
                                           int base, int n, uint8_t pad, int tid, int nth) {
  const bool aligned = ((uintptr_t)src & 15) == 0;
  for (int c = tid; c < n / 16; c += nth) {
    const int i0 = c * 16 + base;
    uint4 v;
    if (aligned && i0 >= 0 && i0 + 16 <= len) {
      v = __ldg((const uint4*)(src + i0));
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = i0 + j;
        const uint32_t byte = (i >= 0 && i < len) ? src[i] : pad;
        if ((j & 3) == 0) w[j >> 2] = 0;
        w[j >> 2] |= byte << (8 * (j & 3));
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    ((uint4*)dst)[c] = v;
  }
}

// The previous row's values at a strip's lanes.
template <int S>
struct RowState {
  int H[S], I1[S], I2[S];
};

// One row of kernel C for the strip at lanes s0..s0+S-1 (FIRST: row 0, the
// leading gap, whose Ht is 0 at lane K and +infinity elsewhere).  tr: the
// strip's target bases at this row (tr[k] under lane s0 + k).  Writes the
// row's bytes at out (lanes < Wr) and leaves the row's H, I1, I2 in st.
// Inside a strip the scans run on A relative to the strip's first lane,
// A[k] + s0 e = Ht[k] - k e, whose ramps come from the constant bank.
template <int S, bool TWO, bool I16, bool FIRST>
__device__ __forceinline__ void rows_row(RowState<S>& st, const uint8_t* tr, int qc, int par,
                                         const RowPen& p, RowShared& sh, int s0, int s0e1,
                                         int s0e2, int lane, int warp, int nwarps, int Wr, int K,
                                         uint8_t* __restrict__ out) {
  const bool last = lane == 31;  // owns the warp's last lane, done after the barrier
  // the previous row's values one lane to the right, from the next thread
  const int hu = __shfl_down_sync(RW_FULL, st.H[0], 1);
  const int iu1 = __shfl_down_sync(RW_FULL, st.I1[0], 1);
  const int iu2 = TWO ? __shfl_down_sync(RW_FULL, st.I2[0], 1) : p.neg;
  int diag_last = 0;
  int ar1[S], ar2[S];
  uint32_t by[S];
  int m1 = RW_BIG, m2 = RW_BIG;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    int ht;
    if (FIRST) {
      ht = s0 + k == K ? 0 : p.neg;
      by[k] = 0;
      st.I1[k] = st.I2[k] = p.neg;
    } else {
      // lane k reads lane k + 1 of the previous row before this loop
      // overwrites it (ascending k), so I1 and I2 update in place
      const int diag = radd<I16>(st.H[k], (int)tr[k] == qc ? 0 : p.mis);
      if (k == S - 1) diag_last = diag;
      ht = rows_ht<TWO, I16>(diag, k < S - 1 ? st.H[k + 1] : hu, k < S - 1 ? st.I1[k + 1] : iu1,
                             k < S - 1 ? st.I2[k + 1] : iu2, p, st.I1[k], st.I2[k], by[k]);
    }
    if (FIRST && k == S - 1) diag_last = ht;
    ar1[k] = ht - p.ke1[k];
    ar2[k] = TWO ? ht - p.ke2[k] : RW_BIG;
    if (k < S - 1 || !last) {
      m1 = min(m1, ar1[k]);
      m2 = min(m2, ar2[k]);
    }
  }
  // the warp's scan over its lanes but its last, on absolute A
  const int inc1 = warp_incl_min(m1 - s0e1);
  const int inc2 = TWO ? warp_incl_min(m2 - s0e2) : RW_BIG;
  int ex1 = __shfl_up_sync(RW_FULL, inc1, 1);
  int ex2 = TWO ? __shfl_up_sync(RW_FULL, inc2, 1) : RW_BIG;
  int prev1 = __shfl_up_sync(RW_FULL, ar1[S - 1] - s0e1, 1);
  int prev2 = TWO ? __shfl_up_sync(RW_FULL, ar2[S - 1] - s0e2, 1) : RW_BIG;
  if (last) {
    sh.tot1[par][warp] = inc1;
    sh.tot2[par][warp] = inc2;
    sh.dg[par][warp] = diag_last;  // row 0: the lane's Ht
  }
  __syncthreads();
  const int pp = par ^ 1;
  if (!FIRST && last) {
    // the warp's last lane, with the next warp's first lane of the previous row
    const bool next = warp + 1 < nwarps;
    const int ht = rows_ht<TWO, I16>(diag_last, next ? sh.eh[pp][warp + 1] : p.neg,
                                     next ? sh.ei1[pp][warp + 1] : p.neg,
                                     next ? sh.ei2[pp][warp + 1] : p.neg, p, st.I1[S - 1],
                                     st.I2[S - 1], by[S - 1]);
    ar1[S - 1] = ht - p.ke1[S - 1];
    ar2[S - 1] = TWO ? ht - p.ke2[S - 1] : RW_BIG;
  }
  // the warps before this one: lane v takes warp v's total and last lane
  int w1 = RW_BIG, w2 = RW_BIG;
  if (warp > 0) {
    int t1 = RW_BIG, t2 = RW_BIG, al1 = RW_BIG, al2 = RW_BIG;
    if (lane < warp) {
      const int L = (lane + 1) * 32 * S - 1;
      int htl = sh.dg[par][lane];
      if (!FIRST) {
        int x1, x2;
        uint32_t xb;
        htl = rows_ht<TWO, I16>(htl, sh.eh[pp][lane + 1], sh.ei1[pp][lane + 1], sh.ei2[pp][lane + 1],
                                p, x1, x2, xb);
      }
      al1 = htl - L * p.e1;
      t1 = min(sh.tot1[par][lane], al1);
      if (TWO) {
        al2 = htl - L * p.e2;
        t2 = min(sh.tot2[par][lane], al2);
      }
    }
    w1 = __reduce_min_sync(RW_FULL, t1);
    const int pl1 = __shfl_sync(RW_FULL, al1, warp - 1);
    if (lane == 0) prev1 = pl1;
    if (TWO) {
      w2 = __reduce_min_sync(RW_FULL, t2);
      const int pl2 = __shfl_sync(RW_FULL, al2, warp - 1);
      if (lane == 0) prev2 = pl2;
    }
  } else if (lane == 0) {
    prev1 = prev2 = RW_BIG;
  }
  if (lane == 0) ex1 = ex2 = RW_BIG;
  // back to the strip's relative A: P[l] + s0 e and A[l - 1] + s0 e
  int run1 = min(w1, ex1) + s0e1, run2 = min(w2, ex2) + s0e2;
  prev1 += s0e1;
  prev2 += s0e2;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    // lane l = s0 + k: P[l] = run, opened iff P[l] == A[l - 1]
    const int d1 = min(run1 + p.ko1[k], p.neg);
    const bool d1o = run1 == prev1;
    prev1 = ar1[k];
    run1 = min(run1, ar1[k]);
    int d2 = p.neg;
    bool d2o = false;
    if (TWO) {
      d2 = min(run2 + p.ko2[k], p.neg);
      d2o = run2 == prev2;
      prev2 = ar2[k];
      run2 = min(run2, ar2[k]);
    }
    int h = ar1[k] + p.ke1[k];  // Ht
    uint32_t b = by[k] | ((uint32_t)d1o << 6) | ((uint32_t)d2o << 7);
    if (d1 < h) {
      h = d1;
      b |= 1u << 2;
    }
    if (d2 < h) {
      h = d2;
      b = (b & ~(3u << 2)) | (2u << 2);
    }
    st.H[k] = h;
    by[k] = b;
  }
  if (s0 + S <= Wr) {
#pragma unroll
    for (int k = 0; k < S; ++k) out[s0 + k] = (uint8_t)by[k];
  } else {
    // lanes past Wr stay +infinity: the last real lane's right neighbour
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (s0 + k < Wr) {
        out[s0 + k] = (uint8_t)by[k];
      } else {
        st.H[k] = st.I1[k] = st.I2[k] = p.neg;
      }
    }
  }
  if (lane == 0) {
    sh.eh[par][warp] = st.H[0];
    sh.ei1[par][warp] = st.I1[0];
    sh.ei2[par][warp] = st.I2[0];
  }
}

// Rows 1..n of a window (row r = w0 + j at j, w0 even, so j's parity is
// r's): qs[j] the query base of row j + 1 (qn carries row j's, read a row
// ahead), tcol + j lane s0's target bases, tbw + j * Wr the row's bytes; the
// score captured at row jfin (the pair's qlen).
template <int S, bool TWO, bool I16>
__device__ __forceinline__ void rows_run(RowState<S>& st, int& qn, const uint8_t* qs,
                                         const uint8_t* tcol, int n, int jfin, bool fin_here,
                                         int fin_lane, const RowPen& p, RowShared& sh, int s0,
                                         int s0e1, int s0e2, int lane, int warp, int nwarps, int Wr,
                                         int K, uint8_t* __restrict__ tbw, int* score) {
  for (int j = 1; j <= n; ++j) {
    const int qc = qn;
    qn = qs[j];
    rows_row<S, TWO, I16, false>(st, tcol + j, qc, j & 1, p, sh, s0, s0e1, s0e2, lane, warp, nwarps,
                                 Wr, K, tbw + (size_t)j * Wr);
    if (j == jfin && fin_here && fin_lane >= 0) {
#pragma unroll
      for (int k = 0; k < S; ++k)
        if (s0 + k == fin_lane) *score = st.H[k] < RW_INF ? st.H[k] : -1;
    }
  }
}

template <int S, bool TWO, bool I16, bool WIN, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) nw_rows_sweep_kernel(
    const uint8_t* __restrict__ Q,   // [B, R] query codes, QPAD-padded
    const uint8_t* __restrict__ T,   // [B, Lt] target codes, TPAD-padded
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    int* __restrict__ scores,        // [B] out
    uint8_t* __restrict__ tb,        // [B, R + 1, Wr] out
    int R, int Lt, int K, RowPen p, int win, int nq, int t_off, int nt) {
  extern __shared__ __align__(16) uint8_t rw_smem[];
  __shared__ RowShared sh;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int Wr = 2 * K + 1;
  const int s0 = tid * S;
  const int qlen = qlens[b];
  const int tlen = tlens[b];
  const int fin_lane = tlen - qlen + K;
  const bool fin_here = (unsigned)(fin_lane - s0) < (unsigned)S && fin_lane < Wr;
  uint8_t* tbb = tb + (size_t)b * (R + 1) * Wr;
  const uint8_t* Qb = Q + (size_t)b * R;
  const uint8_t* Tb = T + (size_t)b * Lt;
  if (tid == 0) scores[b] = -1;  // ordered before the capture by the row barriers

  // A window of the rows (w0, w0 + win] (all R where it fits): the query at
  // qs[i] = Q[w0 + i], and the target base under lane l at row r at
  // ts[t_off - K - 1 + (r - w0) + l] = T[r - K - 1 + l], TPAD off the target
  uint8_t* qs = rw_smem;
  uint8_t* ts = rw_smem + nq;
  rows_stage(qs, Qb, R, 0, nq, RW_QPAD, tid, blockDim.x);
  rows_stage(ts, Tb, Lt, -t_off, nt, RW_TPAD, tid, blockDim.x);
  __syncthreads();
  const uint8_t* tcol = ts + t_off - K - 1 + s0;  // lane s0 at the window's first row
  const int s0e1 = s0 * p.e1, s0e2 = s0 * p.e2;

  RowState<S> st;
#pragma unroll
  for (int k = 0; k < S; ++k) st.H[k] = st.I1[k] = st.I2[k] = p.neg;
  rows_row<S, TWO, I16, true>(st, tcol, 0, 0, p, sh, s0, s0e1, s0e2, lane, warp, nwarps, Wr, K, tbb);
  if (qlen == 0 && fin_here) {
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (s0 + k == fin_lane) scores[b] = st.H[k] < RW_INF ? st.H[k] : -1;
  }
  int qn = qs[0];  // row r's query base, read a row ahead
  if (!WIN) {
    rows_run<S, TWO, I16>(st, qn, qs, tcol, R, qlen, fin_here, fin_lane, p, sh, s0, s0e1, s0e2, lane,
                          warp, nwarps, Wr, K, tbb, scores + b);
    return;
  }
  // the same rows a window at a time (an instantiation of its own)
  for (int w0 = 0; w0 < R; w0 += win) {
    if (w0 > 0) {
      // every thread has passed row w0's barrier, after which no thread
      // reads the staged rows, so the next window overwrites them at once
      rows_stage(qs, Qb, R, w0, nq, RW_QPAD, tid, blockDim.x);
      rows_stage(ts, Tb, Lt, w0 - t_off, nt, RW_TPAD, tid, blockDim.x);
      __syncthreads();
    }
    rows_run<S, TWO, I16>(st, qn, qs, tcol, min(win, R - w0), qlen - w0, fin_here, fin_lane, p, sh, s0,
                          s0e1, s0e2, lane, warp, nwarps, Wr, K, tbb + (size_t)w0 * Wr, scores + b);
  }
}

// Kernel D's tiles: rows top - RW_TILE_R + 1 .. top x lanes c0 .. c0 + 31 of
// a pair's traceback.  A tile row holds the three 16-byte blocks that cover
// its 32 lanes at any alignment (RW_TILE_W bytes), copied by cp.async; lane
// c0 + cc of row top - rr sits at byte rw_tile_off + cc of the tile row.  A
// warp has RW_TILES of them: the one it walks and up to RW_TILES - 1 loading
// below it.  A loaded tile puts the cursor's lane RW_TILE_LEFT lanes from its
// left edge.
#define RW_TILE_R 64
#define RW_TILE_C 32
#define RW_TILE_W 48
#define RW_TILES 3
#define RW_TILE_LEFT 16

__device__ __forceinline__ void rw_cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void rw_cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most n of this thread's copy groups are pending (n < RW_TILES).
__device__ __forceinline__ void rw_cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// The byte of lane c0 + cc of a tile row within its 16-byte blocks: the
// row's address (pair base tb_lo, row `row`) plus c0, modulo 16.
__device__ __forceinline__ int rw_tile_off(unsigned tb_lo, int row, int c0, int Wr) {
  return (int)((tb_lo + (unsigned)row * (unsigned)Wr + (unsigned)c0) & 15u);
}

// Start copying the tile whose top row is `top` at lanes c0 .. into `tile`
// (one commit group a thread, empty where it has no block): rows below 0
// and blocks wholly outside the traceback [tb, tb_end) are not read.  A
// block that straddles tb (a view that starts off a 16-byte boundary) is
// copied whole: its aligned address still lies in the same allocation.
__device__ __forceinline__ void rw_load_tile(uint8_t* tile, const uint8_t* tbb, const uint8_t* tb,
                                             const uint8_t* tb_end, int top, int c0, int x, int Wr) {
  for (int i = x; i < RW_TILE_R * 3; i += 32) {
    const int rr = i / 3, blk = i - 3 * (i / 3);
    const int row = top - rr;
    if (row < 0) continue;
    const uint8_t* g = tbb + (ptrdiff_t)row * Wr + c0;
    const uint8_t* a = reinterpret_cast<const uint8_t*>(((uintptr_t)g & ~(uintptr_t)15) + 16 * blk);
    if (a + 16 > tb && a < tb_end) rw_cp_async16(tile + rr * RW_TILE_W + 16 * blk, a);
  }
  rw_cp_async_commit();
}

// Kernel D: the walk of pair b (one warp).  Its tiles and its ring of G
// (row, length) slots in dynamic shared memory (rows_walk_smem).  Every
// value the control flow reads is the same in every thread (a ballot's, or
// a broadcast read), so the warp never diverges.
__global__ void __launch_bounds__(32 * RW_WALK_PAIRS) nw_rows_walk_kernel(
    const uint8_t* __restrict__ tb,  // [B, R + 1, Wr]
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    uint8_t* __restrict__ steps,     // [B, R + 1] out, zero-filled
    int16_t* __restrict__ grows,     // [B, G] out
    int16_t* __restrict__ gvals,     // [B, G] out
    int* __restrict__ gcount,        // [B] out
    int B, int R, int K, int G) {
  extern __shared__ __align__(16) uint8_t rw_walk_smem[];
  const int warp = threadIdx.x >> 5;
  const int x = threadIdx.x & 31;
  const int b = blockIdx.x * RW_WALK_PAIRS + warp;
  if (b >= B) return;
  constexpr int TILE_BYTES = RW_TILE_R * RW_TILE_W;
  uint8_t* tiles = rw_walk_smem + (size_t)warp * RW_TILES * TILE_BYTES;
  int* ring_r = reinterpret_cast<int*>(rw_walk_smem + (size_t)RW_WALK_PAIRS * RW_TILES * TILE_BYTES) +
                (size_t)warp * 2 * G;
  int* ring_n = ring_r + G;
  const int Wr = 2 * K + 1;
  const uint8_t* tbb = tb + (size_t)b * (R + 1) * Wr;
  const uint8_t* tb_end = tb + (size_t)B * (R + 1) * Wr;
  const unsigned tb_lo = (unsigned)(uintptr_t)tbb;
  uint8_t* st_out = steps + (size_t)b * (R + 1);
  const int qlen = qlens[b];
  const int tlen = tlens[b];
  int r = qlen;                                  // the cursor's row
  int cl = min(max(tlen - qlen + K, 0), Wr - 1);  // and lane
  int st = 0;  // 0 H, 1 I1, 2 I2
  int n = 0;   // D-runs found
  // the tile walked: slot cs, rows top - R + 1 .. top, lanes c0 ..; nq more
  // loading in the next slots, rows below it in turn, lanes pc0 ..
  int cs = 0, top = -RW_TILE_R - 1, c0 = 0;
  int nq = 0, pc0 = 0;
  // lane c0 + cc of tile row rr, 0 off the band or below row 0
  auto tile_byte = [&](int rr, int cc) -> int {
    const int row = top - rr, l = c0 + cc;
    if (row < 0 || l < 0 || l >= Wr) return 0;
    return tiles[cs * TILE_BYTES + rr * RW_TILE_W + rw_tile_off(tb_lo, row, c0, Wr) + cc];
  };
  bool walking = !(qlen == 0 && tlen == 0);
  while (walking) {
    int ur = top - r, uc = cl - c0;
    if ((unsigned)ur >= RW_TILE_R || (unsigned)uc >= RW_TILE_C) {
      if (nq > 0 && (unsigned)(top - RW_TILE_R - r) < RW_TILE_R && (unsigned)(cl - pc0) < RW_TILE_C) {
        // the next tile holds the cursor: wait for its copies
        rw_cp_async_wait(nq - 1);
        --nq;
        cs = cs + 1 == RW_TILES ? 0 : cs + 1;
        top -= RW_TILE_R;
        c0 = pc0;
      } else {
        // load a tile around the cursor, once every copy in flight has landed
        rw_cp_async_wait(0);
        __syncwarp();
        nq = 0;
        top = r;
        c0 = cl - RW_TILE_LEFT;
        rw_load_tile(tiles + cs * TILE_BYTES, tbb, tb, tb_end, top, c0, x, Wr);
        rw_cp_async_wait(0);
        pc0 = c0;
      }
      __syncwarp();
      ur = top - r;
      uc = cl - c0;
      // keep RW_TILES - 1 tiles loading below it, around this lane
      if (nq == 0) pc0 = cl - RW_TILE_LEFT;
      while (nq < RW_TILES - 1 && top - RW_TILE_R * (nq + 1) >= 0) {
        const int s = (cs + nq + 1) % RW_TILES;
        rw_load_tile(tiles + s * TILE_BYTES, tbb, tb, tb_end, top - RW_TILE_R * (nq + 1), pc0, x, Wr);
        ++nq;
      }
    }
    if (r > 0) {
      if (st == 0) {
        // thread x looks x rows down at the cursor's lane.  A row whose
        // byte has no D override and the diagonal choice is an M step that
        // keeps the lane; a run of them, up to the tile's last row and row
        // 1, is taken at once, one opcode a thread.
        const int rr = ur + x;
        const bool reach = rr < RW_TILE_R && r - x >= 1;
        const unsigned run = __ballot_sync(RW_FULL, reach && (tile_byte(rr, uc) & 15) == 0);
        const int k = run == RW_FULL ? 32 : __ffs(~run) - 1;
        if (k > 0) {
          if (x < k) st_out[r - x] = RW_OP_M;
          r -= k;
          // the walk ends after row 1 where its step leaves the cursor at lane K
          if (r == 0 && cl == K) break;
          // the row that stopped the run is decided below if it is in reach
          if (k == 32 || !((__ballot_sync(RW_FULL, reach) >> k) & 1)) continue;
          ur += k;
        }
      } else {
        // in I1 or I2 each row is an I step one lane right, up to the row
        // whose opened bit closes the gap: thread x looks x rows down and x
        // lanes right, and the steps up to the first closing row inside the
        // tile (and above row 0) are taken at once
        const int rr = ur + x, cc = uc + x;
        const bool reach = rr < RW_TILE_R && cc < RW_TILE_C && r - x >= 1;
        const unsigned in = __ballot_sync(RW_FULL, reach);
        const unsigned closes = __ballot_sync(RW_FULL, reach && ((tile_byte(rr, cc) >> (3 + st)) & 1));
        const int k_in = in == RW_FULL ? 32 : __ffs(~in) - 1;
        const int k_close = closes ? __ffs(closes) - 1 : 32;
        const int k = k_close < k_in ? k_close + 1 : k_in;
        if (x < k) st_out[r - x] = RW_OP_I;
        if (k_close < k_in) st = 0;
        r -= k;
        cl += k;
        if (r == 0 && cl == K) break;
        continue;
      }
    }
    // one row: the cursor's byte, and a D-run ending in it resolved at once
    const int b1 = tile_byte(ur, uc);
    const bool in_h = st == 0;
    const int dtag = in_h ? (b1 >> 2) & 3 : 0;
    int l0 = -1;
    if (dtag > 0) {
      // the nearest lane at or left of the cursor whose D opened bit is set:
      // the tile's lanes first, then 32 lanes a ballot from device memory
      const int bit = 5 + dtag;
      const unsigned m = __ballot_sync(RW_FULL, uc - x >= 0 && ((tile_byte(ur, uc - x) >> bit) & 1));
      if (m) {
        l0 = cl - (__ffs(m) - 1);
      } else {
        const uint8_t* row = tbb + (size_t)r * Wr;
        for (int base = min(c0 - 1, Wr - 1); base >= 0; base -= 32) {
          const int l = base - x;
          const unsigned h = __ballot_sync(RW_FULL, l >= 0 && ((row[l] >> bit) & 1));
          if (h) {
            l0 = base - (__ffs(h) - 1);
            break;
          }
        }
      }
    }
    const int glen = (dtag > 0 && l0 >= 0) ? cl - l0 + 1 : 0;
    const int sl = dtag > 0 ? l0 - 1 : cl;
    int b2 = 0;
    if ((unsigned)(sl - c0) < RW_TILE_C) {
      b2 = tile_byte(ur, sl - c0);
    } else if (sl >= 0 && sl < Wr) {
      b2 = tbb[(size_t)r * Wr + sl];
    }
    const int ht = in_h ? (b2 & 3) : st;
    const bool is_i = ht > 0;
    const int iopen = ((in_h ? b2 : b1) >> (3 + ht)) & 1;
    if (x == 0) {
      if (r > 0) st_out[r] = is_i ? RW_OP_I : RW_OP_M;
      if (glen > 0) {
        ring_r[n % G] = r;
        ring_n[n % G] = glen;
      }
    }
    if (glen > 0) ++n;
    const int nl = sl + (is_i ? 1 : 0);
    st = (is_i && !iopen) ? ht : 0;
    cl = nl;
    if (r == 0 || (r == 1 && nl == K)) break;
    --r;
  }
  rw_cp_async_wait(0);  // no copy outlives the block's shared memory
  __syncwarp();
  // the gaps of the lowest rows, ascending: the last min(n, G) found, newest first
  const int kept = min(n, G);
  for (int pos = x; pos < G; pos += 32) {
    if (pos < kept) {
      const int k = (n - 1 - pos) % G;
      grows[(size_t)b * G + pos] = (int16_t)ring_r[k];
      gvals[(size_t)b * G + pos] = (int16_t)ring_n[k];
    } else {
      grows[(size_t)b * G + pos] = -1;
      gvals[(size_t)b * G + pos] = 0;
    }
  }
  if (x == 0) gcount[b] = n;
}

template <bool TWO, bool I16, bool WIN>
static const void* rows_fn_t(int S, int threads) {
  if (S == 8 && threads <= 128) return (const void*)nw_rows_sweep_kernel<8, TWO, I16, WIN, 128, 5>;
  if (S == 8 && threads <= 512) return (const void*)nw_rows_sweep_kernel<8, TWO, I16, WIN, 512, 1>;
  if (S == 16 && threads <= 512) return (const void*)nw_rows_sweep_kernel<16, TWO, I16, WIN, 512, 1>;
  if (S == 16 && threads <= 1024) return (const void*)nw_rows_sweep_kernel<16, TWO, I16, WIN, 1024, 1>;
  return nullptr;
}

// kernel C's instantiation for S lanes on `threads` threads (the launch
// bounds ops/nw_cuda.py::ROWS_BOUNDS lists), staging the rows whole or a
// window at a time, or null
static const void* rows_fn(int S, int threads, bool two, bool i16, bool win) {
  using Fn = const void* (*)(int, int);
  static const Fn fns[8] = {rows_fn_t<false, false, false>, rows_fn_t<false, false, true>,
                            rows_fn_t<false, true, false>,  rows_fn_t<false, true, true>,
                            rows_fn_t<true, false, false>,  rows_fn_t<true, false, true>,
                            rows_fn_t<true, true, false>,   rows_fn_t<true, true, true>};
  return fns[4 * two + 2 * i16 + win](S, threads);
}

// Kernel C: one block of `threads` threads a pair, S lanes a thread
// (threads * S >= 2K + 1, threads a multiple of 32); the rows staged win at
// a time (win >= R, or a multiple of 16), in shared memory nq bytes of
// query and nt of target, the target row at offset t_off
// (ops/nw_cuda.py::rows_smem).  Returns the CUDA error code.
extern "C" int nw_rows_sweep_launch(const void* Q, const void* T, const void* qlens,
                                    const void* tlens, void* scores, void* tb, int B, int R,
                                    int Lt, int K, int mismatch, int o1, int e1, int o2, int e2,
                                    int int16, int S, int threads, int win, int nq, int t_off,
                                    int nt, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const bool i16 = int16 != 0;
  const void* fn = rows_fn(S, threads, o2 >= 0, i16, win < R);
  const int wn = min(win, R);
  if (fn == nullptr || threads < 32 || threads % 32 || (long)threads * S < 2L * K + 1 ||
      (win < R && (win < 16 || win % 16)) || nq < wn + 1 || nq % 16 || t_off < K + 1 ||
      t_off % 16 || nt % 16 || (long)nt < (long)t_off - K + (long)threads * S + wn)
    return (int)cudaErrorInvalidValue;
  RowPen p;
  p.mis = i16 ? (int)(int16_t)mismatch : mismatch;
  p.o1 = o1;
  p.e1 = e1;
  p.oe1 = o1 + e1;
  p.o2 = o2;
  p.e2 = e2;
  p.oe2 = o2 + e2;
  p.neg = i16 ? RW_INF16 : RW_INF;
  for (int k = 0; k < RW_MAX_LANES; ++k) {
    p.ke1[k] = k * e1;
    p.ke2[k] = k * e2;
    p.ko1[k] = k * e1 + o1;
    p.ko2[k] = k * e2 + o2;
  }
  const int smem = nq + nt;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  void* args[] = {&Q, &T, &qlens, &tlens, &scores, &tb, &R, &Lt, &K, &p, &win, &nq, &t_off, &nt};
  return (int)cudaLaunchKernel(fn, dim3(B), dim3(threads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

// Registers per thread and resident blocks (pairs) per SM of kernel C at one
// launch shape (smem: its dynamic shared memory; win: rows staged a window
// at a time).
extern "C" int nw_rows_occupancy(int S, int threads, int two, int int16, int win, int smem,
                                 int* regs, int* blocks_per_sm) {
  const void* fn = rows_fn(S, threads, two != 0, int16 != 0, win != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, smem);
}

// Dynamic shared memory of a block of kernel D: each warp's RW_TILES tiles
// and its gap ring of G (row, length) slots (ops/nw_cuda.py::rows_walk_smem).
static size_t rw_walk_smem_bytes(int G) {
  return (size_t)RW_WALK_PAIRS * (RW_TILES * RW_TILE_R * RW_TILE_W + 2 * G * sizeof(int));
}

// Kernel D: four pairs a block, a ring of `ring` >= G slots a warp.  Returns
// the CUDA error code.
extern "C" int nw_rows_walk_launch(const void* tb, const void* qlens, const void* tlens,
                                   void* steps, void* grows, void* gvals, void* gcount, int B,
                                   int R, int K, int G, int ring, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (G < 1 || G > ring) return (int)cudaErrorInvalidValue;
  const int blocks = (B + RW_WALK_PAIRS - 1) / RW_WALK_PAIRS;
  const size_t smem = rw_walk_smem_bytes(G);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute((const void*)nw_rows_walk_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nw_rows_walk_kernel<<<blocks, 32 * RW_WALK_PAIRS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)tb, (const int*)qlens, (const int*)tlens, (uint8_t*)steps,
      (int16_t*)grows, (int16_t*)gvals, (int*)gcount, B, R, K, G);
  return (int)cudaGetLastError();
}

// Registers per thread, local (spilled) bytes per thread and resident
// blocks (four pairs each) per SM of kernel D with a gap ring of `ring`
// slots a warp.
extern "C" int nw_rows_walk_occupancy(int ring, int* regs, int* local_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)nw_rows_walk_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  const size_t smem = rw_walk_smem_bytes(ring);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute((const void*)nw_rows_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, (const void*)nw_rows_walk_kernel,
                                                            32 * RW_WALK_PAIRS, smem);
}
