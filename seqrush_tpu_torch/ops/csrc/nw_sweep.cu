// Kernel A: banded two-piece-affine global Gotoh sweep by anti-diagonals.
//
// Replaces the Pallas kernel seqrush_tpu/ops/nw_pallas.py::_kernel (wrapped
// by nw_align_pallas).  Same DP, same operand framing, same tie order and the
// same packed traceback byte at every cell, valid or not, so the traceback
// tensor matches the reference row for row (see ops/nw_cuda.py for the plain
// PyTorch version of this arithmetic).
//
// Design (first version, right and simple):
//   * one thread block per pair; thread x owns lanes x, x + blockDim, ...
//     so the traceback row written at each step is coalesced;
//   * the DP state rows live in dynamic shared memory: H rotates through
//     three rows (t-2, t-1, t), I1/D1/I2/D2 through two each -- 11 rows of
//     W int32, one __syncthreads() per anti-diagonal; bands too wide for
//     shared memory get the same rows in a global scratch the wrapper
//     allocates;
//   * the query window and the reversed, padded target window are computed
//     from indices, never materialised.
//
// Bound on H100: about 58 int32 operations per needed cell against the
// traceback bytes written (one per cell), so the kernel is operation-bound
// well before it is memory-bound; the serial anti-diagonal chain and the
// per-step barrier are what this first design pays for.

#include <cuda_runtime.h>
#include <stdint.h>

#define NW_INF (1 << 28)
#define NW_QPAD 6
#define NW_TPAD 7
#define NW_ROWS 11

__device__ __forceinline__ int i0_of(int t, int K) {
  // max(floor((t - K + 1) / 2), 0): negative numerators clamp to 0 anyway
  const int x = t - K + 1;
  return x > 0 ? (x >> 1) : 0;
}

// lane l of a row framed by a lane shift delta in {-1, 0, 1}, INF outside
__device__ __forceinline__ int framed(const int* row, int l, int delta, int W) {
  const int k = l + delta;
  return (k >= 0 && k < W) ? row[k] : NW_INF;
}

__global__ void __launch_bounds__(1024) nw_sweep_kernel(
    const uint8_t* __restrict__ Q,      // [B, Lq] query codes, QPAD-padded
    const uint8_t* __restrict__ T,      // [B, Lt] target codes, TPAD-padded
    const int* __restrict__ qlens,      // [B]
    const int* __restrict__ tlens,      // [B]
    int* __restrict__ scores,           // [B] out
    uint8_t* __restrict__ tb,           // [B, tmax_pad, W] out
    int* __restrict__ gscratch,         // [B, 11, W] or null (shared memory)
    int Lq, int Lt, int W, int tmax, int tmax_pad,
    int mismatch, int o1, int e1, int o2, int e2) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  int* rows = gscratch ? gscratch + (size_t)b * NW_ROWS * W : smem;
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
  uint8_t* tbb = tb + (size_t)b * tmax_pad * W;

  // state at t = 0 (H[0], gap slot 0) and t = -1 (H[2]); traceback row 0
  // and the padding rows past tmax are never computed: they are zero
  for (int l = threadIdx.x; l < W; l += blockDim.x) {
    H[0][l] = l == 0 ? 0 : NW_INF;
    H[2][l] = NW_INF;
    I1[0][l] = NW_INF;
    D1[0][l] = NW_INF;
    I2[0][l] = NW_INF;
    D2[0][l] = NW_INF;
    tbb[l] = 0;
    for (int t = tmax + 1; t < tmax_pad; ++t) tbb[(size_t)t * W + l] = 0;
  }
  if (threadIdx.x == 0) scores[b] = -1;
  __syncthreads();

  for (int t = 1; t <= tmax; ++t) {
    const int* h1 = H[(t - 1) % 3];
    const int* h2 = H[(t + 1) % 3];  // (t - 2) mod 3
    int* hw = H[t % 3];
    const int rs = (t - 1) & 1;
    const int ws = t & 1;
    const int i0 = i0_of(t, K);
    const int dp = i0 - i0_of(t - 1, K);
    const int dpp = i0 - i0_of(t - 2, K);
    // window starts into the padded operands [QPAD] + q + [QPAD]*W and
    // [TPAD]*W + reverse(tg) + [TPAD]*W, clamped as a dynamic slice is
    const int qs = min(i0, Lq + 1);
    const int ts = max(0, min(Lt - t + i0 + W, Lt + W));
    uint8_t* tbrow = tbb + (size_t)t * W;

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
      if (t == t_final && l == qlen - i0 && Hn < NW_INF) scores[b] = Hn;

      tbrow[l] = (uint8_t)(choice | ((int)i1o << 3) | ((int)i2o << 4) |
                           ((int)d1o << 5) | ((int)d2o << 6));
    }
    __syncthreads();
  }
}

extern "C" int nw_sweep_launch(
    const void* Q, const void* T, const void* qlens, const void* tlens,
    void* scores, void* tb, void* scratch,
    int B, int Lq, int Lt, int W, int tmax, int tmax_pad,
    int mismatch, int o1, int e1, int o2, int e2, int threads, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const size_t smem = scratch ? 0 : (size_t)NW_ROWS * W * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nw_sweep_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens,
      (int*)scores, (uint8_t*)tb, (int*)scratch, Lq, Lt, W, tmax, tmax_pad,
      mismatch, o1, e1, o2, e2);
  return (int)cudaGetLastError();
}
