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
// What bounds it on an H100: the chain of rows.  Each row of a pair needs two
// prefix-minimum scans across its Wr lanes, so the pair's threads meet twice
// a row; a row costs a few dozen instructions a lane plus the scans'
// shuffles and two block barriers.  Design: one block a pair; thread r owns
// the S lanes [r * S, r * S + S) in registers (S = 4, 8 or 16, the fewest
// that keep the block at 512 threads, ops/nw_cuda.py::rows_plan); a scan is
// serial inside the strip, five __shfl_up_sync rounds inside the warp and
// one pass over the warps' totals in shared memory; D1 and D2 share the
// rounds and the barrier.  The lane to the right in the previous row comes
// from the next thread by __shfl_down_sync, and across warps through shared
// memory behind the second barrier.  The query base of a row is one
// broadcast load; each thread slides its S target bases by one a row.
//
// Kernel D (nw_rows_walk_kernel) replaces the XLA program
// seqrush_tpu/ops/nw.py::_tb_rows_scan: one warp a pair walks from row qlen
// down, one row a step: the M or I step of the row (a byte), and a D-run
// ending in the row resolved at once as the nearest lane at or left of the
// cursor whose D opened bit is set, found 32 lanes a ballot.  Its outputs are
// the step opcodes [B, R + 1], and the D-runs' rows and lengths at the G
// lowest rows, ascending (nw._tb_rows_scan's top_k), plus their count: the
// walk meets the lowest rows last, so it keeps the last G in a ring in shared
// memory and writes them out rotated at the end.  What bounds it is the chain
// of dependent byte loads, two or three a row.

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

struct RowPen {
  int mis, o1, e1, oe1, o2, e2, oe2;
  int neg;   // the DP's +infinity
  bool i16;  // the int16 mode
};

// an add of the sweep: in the int16 mode the low 16 bits, sign-extended
__device__ __forceinline__ int radd(int a, int b, bool i16) {
  const int x = a + b;
  return i16 ? (int)(int16_t)x : x;
}

// Shared memory of kernel C: the warps' scan totals, their last lanes' A
// values, and their first lanes' new H, I1, I2.
struct RowShared {
  int tot1[RW_MAX_WARPS], tot2[RW_MAX_WARPS];
  int last1[RW_MAX_WARPS], last2[RW_MAX_WARPS];
  int eh[RW_MAX_WARPS], ei1[RW_MAX_WARPS], ei2[RW_MAX_WARPS];
};

// Warp-inclusive prefix minimum of v (lane order).
__device__ __forceinline__ int warp_incl_min(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(RW_FULL, v, d);
    if (lane >= d) v = min(v, u);
  }
  return v;
}

// The closed-form D states of one row from Ht: D1 (and D2 when TWO), their
// opened bits and the H override, for the strip at lanes s0..s0+S-1.
// Returns each lane's byte bits 2-3 and 6-7; updates Hn.  One barrier.
template <int S, bool TWO>
__device__ __forceinline__ void d_pass(const int (&Ht)[S], int (&Hn)[S], uint32_t (&bits)[S],
                                       const RowPen& p, int s0, int lane, int warp,
                                       RowShared& sh) {
  int a1[S], a2[S];
  int m1 = RW_BIG, m2 = RW_BIG;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    a1[k] = Ht[k] - (s0 + k) * p.e1;
    m1 = min(m1, a1[k]);
    if (TWO) {
      a2[k] = Ht[k] - (s0 + k) * p.e2;
      m2 = min(m2, a2[k]);
    }
  }
  // strip totals -> warp-inclusive -> exclusive before the strip
  const int inc1 = warp_incl_min(m1, lane);
  const int inc2 = TWO ? warp_incl_min(m2, lane) : RW_BIG;
  int ex1 = __shfl_up_sync(RW_FULL, inc1, 1);
  int ex2 = __shfl_up_sync(RW_FULL, inc2, 1);
  int prev1 = __shfl_up_sync(RW_FULL, a1[S - 1], 1);
  int prev2 = TWO ? __shfl_up_sync(RW_FULL, a2[S - 1], 1) : RW_BIG;
  if (lane == 31) {
    sh.tot1[warp] = inc1;
    sh.tot2[warp] = inc2;
    sh.last1[warp] = a1[S - 1];
    sh.last2[warp] = TWO ? a2[S - 1] : RW_BIG;
  }
  __syncthreads();
  int w1 = RW_BIG, w2 = RW_BIG;
  for (int w = 0; w < warp; ++w) {
    w1 = min(w1, sh.tot1[w]);
    if (TWO) w2 = min(w2, sh.tot2[w]);
  }
  if (lane == 0) {
    ex1 = RW_BIG;
    ex2 = RW_BIG;
    prev1 = warp ? sh.last1[warp - 1] : RW_BIG;
    prev2 = warp ? sh.last2[warp - 1] : RW_BIG;
  }
  int run1 = min(w1, ex1), run2 = min(w2, ex2);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int l = s0 + k;
    // lane l: P[l] = run, opened iff P[l] == A[l - 1]
    const int d1 = min(run1 + l * p.e1 + p.o1, p.neg);
    const bool d1o = run1 == prev1;
    prev1 = a1[k];
    run1 = min(run1, a1[k]);
    int d2 = p.neg;
    bool d2o = false;
    if (TWO) {
      d2 = min(run2 + l * p.e2 + p.o2, p.neg);
      d2o = run2 == prev2;
      prev2 = a2[k];
      run2 = min(run2, a2[k]);
    }
    int h = Ht[k];
    uint32_t dtag = 0;
    if (d1 < h) {
      h = d1;
      dtag = 1;
    }
    if (d2 < h) {
      h = d2;
      dtag = 2;
    }
    Hn[k] = h;
    bits[k] = (dtag << 2) | ((uint32_t)d1o << 6) | ((uint32_t)d2o << 7);
  }
}

template <int S, bool TWO, int MAXT>
__global__ void __launch_bounds__(MAXT) nw_rows_sweep_kernel(
    const uint8_t* __restrict__ Q,   // [B, R] query codes, QPAD-padded
    const uint8_t* __restrict__ T,   // [B, Lt] target codes, TPAD-padded
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    int* __restrict__ scores,        // [B] out
    uint8_t* __restrict__ tb,        // [B, R + 1, Wr] out
    int R, int Lt, int K, RowPen p) {
  __shared__ RowShared sh;
  const int b = blockIdx.x;
  const int r_t = threadIdx.x;
  const int lane = r_t & 31;
  const int warp = r_t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int Wr = 2 * K + 1;
  const int s0 = r_t * S;
  const int qlen = qlens[b];
  const int tlen = tlens[b];
  const int fin_lane = tlen - qlen + K;
  const uint8_t* q = Q + (size_t)b * R;
  const uint8_t* tg = T + (size_t)b * Lt;
  uint8_t* tbb = tb + (size_t)b * (R + 1) * Wr;
  if (r_t == 0) scores[b] = -1;  // ordered before the capture by the row barriers

  // the target base under lane l of row r: T[r - K + l - 1] (TPAD off it)
  int tw[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int x = s0 + k - K - 1;  // row 0
    tw[k] = (x >= 0 && x < Lt) ? (int)__ldg(tg + x) : RW_TPAD;
  }

  int H[S], I1[S], I2[S], Ht[S], Hn[S];
  uint32_t bits[S];
  // row 0: Ht is 0 at lane K, neg elsewhere; the row is the leading gap
#pragma unroll
  for (int k = 0; k < S; ++k) Ht[k] = (s0 + k == K) ? 0 : p.neg;
  d_pass<S, TWO>(Ht, Hn, bits, p, s0, lane, warp, sh);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const bool real = s0 + k < Wr;
    H[k] = real ? Hn[k] : p.neg;
    I1[k] = I2[k] = p.neg;
    if (real) tbb[s0 + k] = (uint8_t)bits[k];
  }
  if (qlen == 0 && (unsigned)(fin_lane - s0) < (unsigned)S && fin_lane < Wr) {
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (s0 + k == fin_lane) scores[b] = H[k] < RW_INF ? H[k] : -1;
  }

  for (int r = 1; r <= R; ++r) {
    // the previous row's values one lane to the right (the same column)
    int hu = __shfl_down_sync(RW_FULL, H[0], 1);
    int iu1 = __shfl_down_sync(RW_FULL, I1[0], 1);
    int iu2 = __shfl_down_sync(RW_FULL, I2[0], 1);
    if (lane == 0) {
      sh.eh[warp] = H[0];
      sh.ei1[warp] = I1[0];
      sh.ei2[warp] = I2[0];
    }
    __syncthreads();
    if (lane == 31) {
      const bool next = warp + 1 < nwarps;
      hu = next ? sh.eh[warp + 1] : p.neg;
      iu1 = next ? sh.ei1[warp + 1] : p.neg;
      iu2 = next ? sh.ei2[warp + 1] : p.neg;
    }
    // slide the target window one base to the right
#pragma unroll
    for (int k = 0; k < S - 1; ++k) tw[k] = tw[k + 1];
    {
      const int x = r + s0 + S - 1 - K - 1;
      tw[S - 1] = (x >= 0 && x < Lt) ? (int)__ldg(tg + x) : RW_TPAD;
    }
    const int qc = (int)__ldg(q + r - 1);
    int I1n[S], I2n[S];
    uint32_t low[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int h_up = k < S - 1 ? H[k + 1] : hu;
      const int i1_up = k < S - 1 ? I1[k + 1] : iu1;
      const int i2_up = k < S - 1 ? I2[k + 1] : iu2;
      int a = radd(h_up, p.oe1, p.i16);
      int c = radd(i1_up, p.e1, p.i16);
      I1n[k] = min(a, c);
      uint32_t by = (uint32_t)(a <= c) << 4;
      I2n[k] = p.neg;
      if (TWO) {
        a = radd(h_up, p.oe2, p.i16);
        c = radd(i2_up, p.e2, p.i16);
        I2n[k] = min(a, c);
        by |= (uint32_t)(a <= c) << 5;
      }
      int ht = radd(H[k], qc == tw[k] ? 0 : p.mis, p.i16);
      if (p.i16) {
        ht = min(ht, p.neg);
        I1n[k] = min(I1n[k], p.neg);
        I2n[k] = min(I2n[k], p.neg);
      }
      if (I1n[k] < ht) {
        ht = I1n[k];
        by |= 1u;
      }
      if (I2n[k] < ht) {
        ht = I2n[k];
        by = (by & ~3u) | 2u;
      }
      Ht[k] = ht;
      low[k] = by;
    }
    d_pass<S, TWO>(Ht, Hn, bits, p, s0, lane, warp, sh);
    uint8_t* row = tbb + (size_t)r * Wr;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const bool real = s0 + k < Wr;
      if (real) row[s0 + k] = (uint8_t)(low[k] | bits[k]);
      // lanes past Wr stay +infinity: the last real lane's right neighbour
      H[k] = real ? Hn[k] : p.neg;
      I1[k] = real ? I1n[k] : p.neg;
      I2[k] = real ? I2n[k] : p.neg;
    }
    if (r == qlen && (unsigned)(fin_lane - s0) < (unsigned)S && fin_lane < Wr && fin_lane >= 0) {
#pragma unroll
      for (int k = 0; k < S; ++k)
        if (s0 + k == fin_lane) scores[b] = H[k] < RW_INF ? H[k] : -1;
    }
  }
}

// Kernel D: the walk of pair b (one warp).  ring: this warp's G slots of
// (row, length) in shared memory.
__global__ void __launch_bounds__(32 * RW_WALK_PAIRS) nw_rows_walk_kernel(
    const uint8_t* __restrict__ tb,  // [B, R + 1, Wr]
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    uint8_t* __restrict__ steps,     // [B, R + 1] out, zero-filled
    int16_t* __restrict__ grows,     // [B, G] out
    int16_t* __restrict__ gvals,     // [B, G] out
    int* __restrict__ gcount,        // [B] out
    int B, int R, int K, int G) {
  extern __shared__ int ring_smem[];
  const int warp = threadIdx.x >> 5;
  const int x = threadIdx.x & 31;
  const int b = blockIdx.x * RW_WALK_PAIRS + warp;
  if (b >= B) return;
  int* ring_r = ring_smem + (size_t)warp * 2 * G;
  int* ring_n = ring_r + G;
  const int Wr = 2 * K + 1;
  const uint8_t* tbb = tb + (size_t)b * (R + 1) * Wr;
  uint8_t* st_out = steps + (size_t)b * (R + 1);
  const int qlen = qlens[b];
  const int tlen = tlens[b];
  int cur_l = min(max(tlen - qlen + K, 0), Wr - 1);
  int st = 0;  // 0 H, 1 I1, 2 I2
  int n = 0;   // D-runs found
  if (!(qlen == 0 && tlen == 0)) {
    for (int r = qlen; r >= 0; --r) {
      const uint8_t* row = tbb + (size_t)r * Wr;
      const int b1 = (cur_l >= 0 && cur_l < Wr) ? (int)row[cur_l] : 0;
      const bool in_h = st == 0;
      const int dtag = in_h ? (b1 >> 2) & 3 : 0;
      int l0 = -1;
      if (dtag > 0) {
        // the nearest lane at or left of the cursor whose D opened bit is set
        const int bit = 5 + dtag;
        for (int base = min(cur_l, Wr - 1); base >= 0; base -= 32) {
          const int l = base - x;
          const bool hit = l >= 0 && ((row[l] >> bit) & 1);
          const unsigned m = __ballot_sync(RW_FULL, hit);
          if (m) {
            l0 = base - (__ffs(m) - 1);
            break;
          }
        }
      }
      const int glen = (dtag > 0 && l0 >= 0) ? cur_l - l0 + 1 : 0;
      const int step_lane = dtag > 0 ? l0 - 1 : cur_l;
      const int b2 = (step_lane >= 0 && step_lane < Wr) ? (int)row[step_lane] : 0;
      const int ht = in_h ? (b2 & 3) : st;
      const bool is_i = ht > 0;
      const int iopen = ((in_h ? b2 : b1) >> (3 + ht)) & 1;
      const bool terminal = r == 0;
      if (x == 0) {
        if (!terminal) st_out[r] = is_i ? RW_OP_I : RW_OP_M;
        if (glen > 0) {
          ring_r[n % G] = r;
          ring_n[n % G] = glen;
        }
      }
      if (glen > 0) ++n;
      const int nl = step_lane + (is_i ? 1 : 0);
      st = (is_i && !iopen) ? ht : 0;
      cur_l = nl;
      if (terminal || (r - 1 == 0 && nl == K)) break;
    }
  }
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

template <int S, bool TWO, int MAXT>
static cudaError_t launch_rows(const void* Q, const void* T, const void* qlens, const void* tlens,
                               void* scores, void* tb, int B, int R, int Lt, int K, RowPen p,
                               int threads, cudaStream_t st) {
  nw_rows_sweep_kernel<S, TWO, MAXT><<<B, threads, 0, st>>>(
      (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens, (int*)scores,
      (uint8_t*)tb, R, Lt, K, p);
  return cudaGetLastError();
}

// Kernel C: one block of `threads` threads a pair, S lanes a thread
// (threads * S >= 2K + 1, threads a multiple of 32, at most 512, or 1024
// with S = 16 for the widest bands).  Returns the CUDA error code.
extern "C" int nw_rows_sweep_launch(const void* Q, const void* T, const void* qlens,
                                    const void* tlens, void* scores, void* tb, int B, int R,
                                    int Lt, int K, int mismatch, int o1, int e1, int o2, int e2,
                                    int int16, int S, int threads, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (threads < 32 || threads > 1024 || threads % 32 || (long)threads * S < 2L * K + 1)
    return (int)cudaErrorInvalidValue;
  RowPen p;
  p.i16 = int16 != 0;
  p.mis = p.i16 ? (int)(int16_t)mismatch : mismatch;
  p.o1 = o1;
  p.e1 = e1;
  p.oe1 = o1 + e1;
  p.o2 = o2;
  p.e2 = e2;
  p.oe2 = o2 + e2;
  p.neg = p.i16 ? RW_INF16 : RW_INF;
  const bool two = o2 >= 0;
  cudaStream_t st = (cudaStream_t)stream;
#define RW_LAUNCH(SV, MT)                                                                        \
  return (int)(two ? launch_rows<SV, true, MT>(Q, T, qlens, tlens, scores, tb, B, R, Lt, K, p,   \
                                               threads, st)                                      \
                   : launch_rows<SV, false, MT>(Q, T, qlens, tlens, scores, tb, B, R, Lt, K, p,  \
                                                threads, st));
  if (threads > 512) {
    if (S != 16) return (int)cudaErrorInvalidValue;
    RW_LAUNCH(16, 1024)
  }
  switch (S) {
    case 4: RW_LAUNCH(4, 512)
    case 8: RW_LAUNCH(8, 512)
    case 16: RW_LAUNCH(16, 512)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RW_LAUNCH
}

// Kernel D: four pairs a block, a ring of `ring` >= G slots a warp.  Returns
// the CUDA error code.
extern "C" int nw_rows_walk_launch(const void* tb, const void* qlens, const void* tlens,
                                   void* steps, void* grows, void* gvals, void* gcount, int B,
                                   int R, int K, int G, int ring, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (G < 1 || G > ring) return (int)cudaErrorInvalidValue;
  const int blocks = (B + RW_WALK_PAIRS - 1) / RW_WALK_PAIRS;
  const size_t smem = (size_t)RW_WALK_PAIRS * 2 * G * sizeof(int);
  nw_rows_walk_kernel<<<blocks, 32 * RW_WALK_PAIRS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)tb, (const int*)qlens, (const int*)tlens, (uint8_t*)steps,
      (int16_t*)grows, (int16_t*)gvals, (int*)gcount, B, R, K, G);
  return (int)cudaGetLastError();
}
