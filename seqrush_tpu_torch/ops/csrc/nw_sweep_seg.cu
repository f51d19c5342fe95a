// Kernel A, segment mode: anti-diagonals [t0 + 1, t0 + seg] of every pair
// from a carry of the six DP rows, for the long-pair route
// (ops/nw_cuda.py::nw_align_long; replaces seqrush_tpu/ops/nw.py::
// _nw_segment).  The device code and the design note are in nw_sweep.cuh.

#include "nw_sweep.cuh"

template <int S, bool TWO, bool TB>
__global__ void __launch_bounds__(S <= 4 ? 128 : S <= 8 ? 384 : 256, S == 4 ? 5 : 1)
nw_sweep_regs_seg(const uint8_t* __restrict__ Q, const uint8_t* __restrict__ T,
                  const int* __restrict__ qlens, const int* __restrict__ tlens,
                  int* __restrict__ scores,  // [B] out
                  uint8_t* __restrict__ tb,  // [B, seg, W] out (TB only)
                  int B, int Lq, int Lt, int W, Pen p, int wpp, int ppb, int pair_bytes,
                  SegArgs sa) {
  sweep_regs_body<S, TWO, TB, true>(Q, T, qlens, tlens, scores, tb, B, Lq, Lt, W, 0, 0, p, wpp,
                                     ppb, pair_bytes, sa);
}

// Wide route, segment mode: the single-shot wide kernel's recurrence
// (nw_sweep.cu) over [t_lo, t_hi], its rows loaded from the carry before
// and stored to it after.
template <bool TB>
__global__ void __launch_bounds__(1024) nw_sweep_wide_seg(
    const uint8_t* __restrict__ Q,      // [B, Lq] query codes, QPAD-padded
    const uint8_t* __restrict__ T,      // [B, Lt] target codes, TPAD-padded
    const int* __restrict__ qlens,      // [B]
    const int* __restrict__ tlens,      // [B]
    int* __restrict__ scores,           // [B] out
    uint8_t* __restrict__ tb,           // [B, seg, W] out (TB only)
    int* __restrict__ gscratch,         // [B, 11, W] or null (shared memory)
    int Lq, int Lt, int W, int mismatch, int o1, int e1, int o2, int e2, SegArgs sa) {
  extern __shared__ int rows_smem[];
  const int b = blockIdx.x;
  int* rows = gscratch ? gscratch + (size_t)b * NW_ROWS * W : rows_smem;
  int* H[3] = {rows, rows + W, rows + 2 * W};
  int* I1[2] = {rows + 3 * W, rows + 4 * W};
  int* D1[2] = {rows + 5 * W, rows + 6 * W};
  int* I2[2] = {rows + 7 * W, rows + 8 * W};
  int* D2[2] = {rows + 9 * W, rows + 10 * W};

  const int K = W - 1;
  const bool two = o2 >= 0;
  const int qlen = qlens[b];
  const int tlen = tlens[b];
  const int t_final = qlen + tlen;
  const uint8_t* q = Q + (size_t)b * Lq;
  const uint8_t* tg = T + (size_t)b * Lt;
  uint8_t* tbb = TB ? tb + (size_t)b * (sa.t_hi - sa.t_lo + 1) * W : nullptr;
  const size_t plane = (size_t)gridDim.x * W;  // one row of the carry

  // rows t_lo - 1 (H and the gap states) and t_lo - 2 (H) from the carry
  {
    const int* c = sa.carry_in + (size_t)b * W;
    int* hc = H[(sa.t_lo - 1) % 3];
    int* hp = H[(sa.t_lo + 1) % 3];
    const int gs = (sa.t_lo - 1) & 1;
    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      hc[l] = c[l];
      hp[l] = c[plane + l];
      I1[gs][l] = c[2 * plane + l];
      D1[gs][l] = c[3 * plane + l];
      I2[gs][l] = c[4 * plane + l];
      D2[gs][l] = c[5 * plane + l];
    }
  }
  if (threadIdx.x == 0) scores[b] = sa.scores_in[b];
  __syncthreads();

  for (int t = sa.t_lo; t <= sa.t_hi; ++t) {
    const int* h1 = H[(t - 1) % 3];
    const int* h2 = H[(t + 1) % 3];  // (t - 2) mod 3
    int* hw = H[t % 3];
    const int rs = (t - 1) & 1;
    const int ws = t & 1;
    const int i0 = i0_of(t, K);
    const int dp = i0 - i0_of(t - 1, K);
    const int dpp = i0 - i0_of(t - 2, K);
    const int qs = min(i0, Lq + 1);
    const int ts = max(0, min(Lt - t + i0 + W, Lt + W));
    uint8_t* tbrow = TB ? tbb + (size_t)(t - sa.t_lo) * W : nullptr;

    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      const int h_up = framed(h1, l, dp - 1, W);
      const int h_left = framed(h1, l, dp, W);
      const int h_diag = framed(h2, l, dpp - 1, W);
      const int i1_up = framed(I1[rs], l, dp - 1, W);
      const int d1_left = framed(D1[rs], l, dp, W);

      const int x = qs + l;
      const int qc = (x >= 1 && x <= Lq) ? (int)q[x - 1] : NW_QPAD;
      const int y = ts + l;
      const int tc = (y >= W && y < W + Lt) ? (int)tg[Lt - 1 - (y - W)] : NW_TPAD;
      const int sub = qc == tc ? 0 : mismatch;

      int a = h_up + (o1 + e1);
      int c = i1_up + e1;
      int I1n = min(a, c);
      const bool i1o = a <= c;
      a = h_left + (o1 + e1);
      c = d1_left + e1;
      int D1n = min(a, c);
      const bool d1o = a <= c;
      int I2n = NW_INF, D2n = NW_INF;
      bool i2o = false, d2o = false;
      if (two) {
        const int i2_up = framed(I2[rs], l, dp - 1, W);
        const int d2_left = framed(D2[rs], l, dp, W);
        a = h_up + (o2 + e2);
        c = i2_up + e2;
        I2n = min(a, c);
        i2o = a <= c;
        a = h_left + (o2 + e2);
        c = d2_left + e2;
        D2n = min(a, c);
        d2o = a <= c;
      }

      // strict '<' in the order D1, I1, D2, I2: ties keep the earlier choice
      int Hn = h_diag + sub;
      int choice = 0;
      if (D1n < Hn) { Hn = D1n; choice = 1; }
      if (I1n < Hn) { Hn = I1n; choice = 2; }
      if (D2n < Hn) { Hn = D2n; choice = 3; }
      if (I2n < Hn) { Hn = I2n; choice = 4; }

      const int i = i0 + l;
      const int j = t - i;
      const bool valid = i >= 0 && i <= qlen && j >= 0 && j <= tlen;
      Hn = valid ? min(Hn, NW_INF) : NW_INF;
      hw[l] = Hn;
      I1[ws][l] = valid ? min(I1n, NW_INF) : NW_INF;
      D1[ws][l] = valid ? min(D1n, NW_INF) : NW_INF;
      if (two) {
        I2[ws][l] = valid ? min(I2n, NW_INF) : NW_INF;
        D2[ws][l] = valid ? min(D2n, NW_INF) : NW_INF;
      }
      // the score only where the pair has none yet
      if (t == t_final && l == qlen - i0 && Hn < NW_INF && scores[b] < 0) scores[b] = Hn;

      if (TB)
        tbrow[l] = (uint8_t)(choice | ((int)i1o << 3) | ((int)i2o << 4) |
                             ((int)d1o << 5) | ((int)d2o << 6));
    }
    __syncthreads();
  }

  // the carry at t_hi; with one-piece penalties I2/D2 are INF rows
  int* c = sa.carry_out + (size_t)b * W;
  const int* hc = H[sa.t_hi % 3];
  const int* hp = H[(sa.t_hi + 2) % 3];
  const int gs = sa.t_hi & 1;
  for (int l = threadIdx.x; l < W; l += blockDim.x) {
    c[l] = hc[l];
    c[plane + l] = hp[l];
    c[2 * plane + l] = I1[gs][l];
    c[3 * plane + l] = D1[gs][l];
    c[4 * plane + l] = two ? I2[gs][l] : NW_INF;
    c[5 * plane + l] = two ? D2[gs][l] : NW_INF;
  }
}

template <int S, bool TWO, bool TB>
static cudaError_t launch_regs_seg(const void* Q, const void* T, const void* qlens,
                                   const void* tlens, void* scores, void* tb, int B, int Lq, int Lt,
                                   int W, Pen p, int wpp, int ppb, int pair_bytes, SegArgs sa,
                                   cudaStream_t stream) {
  const int threads = ppb * wpp * 32;
  const size_t smem = dynamic_smem(S, W, ppb, pair_bytes, false);
  const cudaError_t err = allow_smem((const void*)nw_sweep_regs_seg<S, TWO, TB>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + ppb - 1) / ppb;
  nw_sweep_regs_seg<S, TWO, TB><<<blocks, threads, smem, stream>>>(
      (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens, (int*)scores,
      (uint8_t*)tb, B, Lq, Lt, W, p, wpp, ppb, pair_bytes, sa);
  return cudaGetLastError();
}

// One segment, anti-diagonals [t_lo, t_hi]: carry_in / carry_out [6, B, W]
// int32 (distinct buffers), scores_in / scores_out [B] int32, tb [B, t_hi -
// t_lo + 1, W] uint8 or null (score-only).  lanes 0 is the wide route (its
// rows in scratch, [B, 11, W] int32, or in shared memory where scratch is
// null).  Returns the CUDA error code.
extern "C" int nw_sweep_segment_launch(const void* Q, const void* T, const void* qlens,
                                       const void* tlens, const void* carry_in, void* carry_out,
                                       const void* scores_in, void* scores_out, void* tb,
                                       void* scratch, int B, int Lq, int Lt, int W, int t_lo,
                                       int t_hi, int mismatch, int o1, int e1, int o2, int e2,
                                       int lanes, int wpp, int ppb, int pair_bytes,
                                       int wide_threads, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (t_hi < t_lo || t_lo < 1) return (int)cudaErrorInvalidValue;
  const bool two = o2 >= 0;
  const bool with_tb = tb != nullptr;
  const Pen p{mismatch, o1 + e1, e1, o2 + e2, e2};
  const SegArgs sa{(const int*)carry_in, (int*)carry_out, (const int*)scores_in, t_lo, t_hi};
  cudaStream_t st = (cudaStream_t)stream;
  if (lanes == 0) {
    const size_t smem = dynamic_smem(0, W, 1, 0, scratch != nullptr);
    const void* fn =
        with_tb ? (const void*)nw_sweep_wide_seg<true> : (const void*)nw_sweep_wide_seg<false>;
    const cudaError_t err = allow_smem(fn, smem);
    if (err != cudaSuccess) return (int)err;
    if (with_tb)
      nw_sweep_wide_seg<true><<<B, wide_threads, smem, st>>>(
          (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens,
          (int*)scores_out, (uint8_t*)tb, (int*)scratch, Lq, Lt, W, mismatch, o1, e1, o2, e2, sa);
    else
      nw_sweep_wide_seg<false><<<B, wide_threads, smem, st>>>(
          (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens,
          (int*)scores_out, nullptr, (int*)scratch, Lq, Lt, W, mismatch, o1, e1, o2, e2, sa);
    return (int)cudaGetLastError();
  }
#define NW_LAUNCH_TB(SV, TWOV)                                                              \
  (with_tb ? launch_regs_seg<SV, TWOV, true>(Q, T, qlens, tlens, scores_out, tb, B, Lq, Lt, \
                                             W, p, wpp, ppb, pair_bytes, sa, st)           \
           : launch_regs_seg<SV, TWOV, false>(Q, T, qlens, tlens, scores_out, tb, B, Lq, Lt, \
                                              W, p, wpp, ppb, pair_bytes, sa, st))
#define NW_LAUNCH(SV) \
  case SV:            \
    return (int)(two ? NW_LAUNCH_TB(SV, true) : NW_LAUNCH_TB(SV, false));
  switch (lanes) {
    NW_LAUNCH(4)
    NW_LAUNCH(8)
    NW_LAUNCH(12)
    NW_LAUNCH(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef NW_LAUNCH
#undef NW_LAUNCH_TB
}
