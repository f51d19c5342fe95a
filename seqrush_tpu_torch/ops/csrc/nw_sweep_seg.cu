// Kernel A, segment mode: runs of segments of seg anti-diagonals from a
// carry of the six DP rows, one run a grid row, for the long-pair route
// (ops/nw_cuda.py::nw_align_long: the forward pass's runs and the grouped
// recompute of the reverse pass; replaces seqrush_tpu/ops/nw.py::
// _nw_segment).  The device code and the design note are in nw_sweep.cuh.

#include "nw_sweep.cuh"

template <int S, bool TWO, bool TB>
__global__ void __launch_bounds__(S <= 4 ? 128 : S <= 8 ? 384 : 256, S == 4 ? 5 : 1)
nw_sweep_regs_seg(const uint8_t* __restrict__ Q, const uint8_t* __restrict__ T,
                  const int* __restrict__ qlens, const int* __restrict__ tlens,
                  int* __restrict__ scores,  // [B] out
                  uint8_t* __restrict__ tb,  // [B, tb_rows, W] out (TB only)
                  int B, int Lq, int Lt, int W, Pen p, int wpp, int ppb, int pair_bytes,
                  SegArgs sa) {
  sweep_regs_body<S, TWO, TB, true>(Q, T, qlens, tlens, scores, tb, B, Lq, Lt, W, 0, 0, p, wpp,
                                     ppb, pair_bytes, sa);
}

// Wide route, segment mode: the single-shot wide kernel's recurrence
// (nw_sweep.cu) over grid row blockIdx.y's run, its rows loaded from the
// carry before it and stored to the carries after each of its segments.
template <bool TB>
__global__ void __launch_bounds__(1024) nw_sweep_wide_seg(
    const uint8_t* __restrict__ Q,      // [B, Lq] query codes, QPAD-padded
    const uint8_t* __restrict__ T,      // [B, Lt] target codes, TPAD-padded
    const int* __restrict__ qlens,      // [B]
    const int* __restrict__ tlens,      // [B]
    int* __restrict__ scores,           // [B] out
    uint8_t* __restrict__ tb,           // [B, tb_rows, W] out (TB only)
    int* __restrict__ gscratch,         // [groups, B, 11, W] or null (shared memory)
    int Lq, int Lt, int W, int mismatch, int o1, int e1, int o2, int e2, SegArgs sa) {
  extern __shared__ int rows_smem[];
  const int b = blockIdx.x;
  const int before = blockIdx.y * sa.n_run;  // segments before the grid row's run
  int* rows = gscratch ? gscratch + ((size_t)blockIdx.y * gridDim.x + b) * NW_ROWS * W : rows_smem;
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
  const int t_lo = sa.t_lo + before * sa.seg;
  const int t_hi = t_lo + sa.n_run * sa.seg - 1;
  const uint8_t* q = Q + (size_t)b * Lq;
  const uint8_t* tg = T + (size_t)b * Lt;
  uint8_t* tbb = TB ? tb + ((size_t)b * sa.tb_rows + (size_t)before * sa.seg) * W : nullptr;
  const size_t plane = (size_t)gridDim.x * W;  // one row of the carry

  // rows t_lo - 1 (H and the gap states) and t_lo - 2 (H) from the carry
  {
    const int* c = sa.carry_in + (size_t)before * sa.cstride + (size_t)b * W;
    int* hc = H[(t_lo - 1) % 3];
    int* hp = H[(t_lo + 1) % 3];
    const int gs = (t_lo - 1) & 1;
    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      hc[l] = c[l];
      hp[l] = c[plane + l];
      I1[gs][l] = c[2 * plane + l];
      D1[gs][l] = c[3 * plane + l];
      I2[gs][l] = c[4 * plane + l];
      D2[gs][l] = c[5 * plane + l];
    }
  }
  if (threadIdx.x == 0 && sa.scores_in) scores[b] = sa.scores_in[b];
  __syncthreads();

  for (int t = t_lo; t <= t_hi; ++t) {
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
    uint8_t* tbrow = TB ? tbb + (size_t)(t - t_lo) * W : nullptr;

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
    // the carry after each segment of the run: the next step writes other
    // rows, and the barrier after it orders these reads ahead of the step
    // that reuses them
    const int k = (t - t_lo + 1) / sa.seg - 1;
    if ((t - t_lo + 1) % sa.seg == 0 && k < sa.n_out) {
      int* c = sa.carry_out + (size_t)(before + k) * sa.cstride + (size_t)b * W;
      const int* hc = H[t % 3];
      const int* hp = H[(t + 2) % 3];
      const int gs = t & 1;
      for (int l = threadIdx.x; l < W; l += blockDim.x) {
        c[l] = hc[l];
        c[plane + l] = hp[l];
        c[2 * plane + l] = I1[gs][l];
        c[3 * plane + l] = D1[gs][l];
        // with one-piece penalties I2/D2 are INF rows
        c[4 * plane + l] = two ? I2[gs][l] : NW_INF;
        c[5 * plane + l] = two ? D2[gs][l] : NW_INF;
      }
    }
  }
}

template <int S, bool TWO, bool TB>
static cudaError_t launch_regs_seg(const void* Q, const void* T, const void* qlens,
                                   const void* tlens, void* scores, void* tb, int B, int Lq, int Lt,
                                   int W, Pen p, int wpp, int ppb, int pair_bytes, SegArgs sa,
                                   int groups, cudaStream_t stream) {
  const int threads = ppb * wpp * 32;
  const size_t smem = dynamic_smem(S, W, ppb, pair_bytes, false);
  const cudaError_t err = allow_smem((const void*)nw_sweep_regs_seg<S, TWO, TB>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + ppb - 1) / ppb, groups);
  nw_sweep_regs_seg<S, TWO, TB><<<grid, threads, smem, stream>>>(
      (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens, (int*)scores,
      (uint8_t*)tb, B, Lq, Lt, W, p, wpp, ppb, pair_bytes, sa);
  return cudaGetLastError();
}

// Runs of n_run segments of seg anti-diagonals, one a grid row, `groups`
// rows: grid row y sweeps anti-diagonals t_lo + y * n_run * seg on from
// the carry ckpt_in + y * n_run carries on (each [6, B, W] int32, carries
// 6 * B * W ints apart), and stores the carry after its k-th segment
// (k < n_out) at ckpt_out + (y * n_run + k) carries; ckpt_out may be null
// (then n_out is 0) and must not overlap a carry the launch reads.  scores
// [B] int32: from scores_in, or, where scores_in is null, as the caller
// filled them (-1), each pair's score set in the segment of its final cell.
// tb [B, tb_rows, W] uint8 or null (score-only): grid row y's rows from row
// y * n_run * seg on.  lanes 0 is the wide route (its rows in scratch,
// [groups, B, 11, W] int32, or in shared memory where scratch is null).
// Returns the CUDA error code.
extern "C" int nw_sweep_segment_launch(const void* Q, const void* T, const void* qlens,
                                       const void* tlens, const void* ckpt_in, void* ckpt_out,
                                       const void* scores_in, void* scores, void* tb,
                                       void* scratch, int B, int Lq, int Lt, int W, int t_lo,
                                       int seg, int n_run, int n_out, int groups, int tb_rows,
                                       int mismatch, int o1, int e1, int o2, int e2, int lanes,
                                       int wpp, int ppb, int pair_bytes, int wide_threads,
                                       void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (t_lo < 1 || seg < 1 || n_run < 1 || groups < 1 || groups > 65535 || n_out < 0 ||
      n_out > n_run || (tb && tb_rows < groups * n_run * seg))
    return (int)cudaErrorInvalidValue;
  const bool two = o2 >= 0;
  const bool with_tb = tb != nullptr;
  const Pen p{mismatch, o1 + e1, e1, o2 + e2, e2};
  const SegArgs sa{(const int*)ckpt_in, (int*)ckpt_out, (const int*)scores_in, t_lo, seg, n_run,
                   ckpt_out ? n_out : 0, tb_rows, (size_t)6 * B * W};
  cudaStream_t st = (cudaStream_t)stream;
  if (lanes == 0) {
    const size_t smem = dynamic_smem(0, W, 1, 0, scratch != nullptr);
    const void* fn =
        with_tb ? (const void*)nw_sweep_wide_seg<true> : (const void*)nw_sweep_wide_seg<false>;
    const cudaError_t err = allow_smem(fn, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B, groups);
    if (with_tb)
      nw_sweep_wide_seg<true><<<grid, wide_threads, smem, st>>>(
          (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens,
          (int*)scores, (uint8_t*)tb, (int*)scratch, Lq, Lt, W, mismatch, o1, e1, o2, e2, sa);
    else
      nw_sweep_wide_seg<false><<<grid, wide_threads, smem, st>>>(
          (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens,
          (int*)scores, nullptr, (int*)scratch, Lq, Lt, W, mismatch, o1, e1, o2, e2, sa);
    return (int)cudaGetLastError();
  }
#define NW_LAUNCH_TB(SV, TWOV)                                                                 \
  (with_tb ? launch_regs_seg<SV, TWOV, true>(Q, T, qlens, tlens, scores, tb, B, Lq, Lt, W, p,  \
                                             wpp, ppb, pair_bytes, sa, groups, st)             \
           : launch_regs_seg<SV, TWOV, false>(Q, T, qlens, tlens, scores, tb, B, Lq, Lt, W, p, \
                                              wpp, ppb, pair_bytes, sa, groups, st))
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
