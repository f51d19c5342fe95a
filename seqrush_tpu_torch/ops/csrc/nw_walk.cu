// Kernel B: reverse traceback walk over the sweep's packed traceback bytes.
//
// Replaces the Pallas kernel seqrush_tpu/ops/nw_pallas.py::_walk_kernel
// (wrapped by nw_walk_pallas).  Per pair the walk starts at t = qlen + tlen,
// lane qlen - i0(t), visits at most one cell per anti-diagonal, reads its
// packed byte and steps the 5-state machine (H, D1, I1, D2, I2).  Gap-state
// switches consume the same byte as the gap op.  The opcode (0 none, 1 M,
// 2 I, 3 D) lands at column td of a zero-filled [B, tmax + 1] row.
//
// Design (first version): one thread per pair.  The reference scans every
// anti-diagonal and acts only where the pair's cursor sits; here the thread
// jumps from cursor to cursor, which visits the same cells in the same order
// and leaves the skipped columns at zero.  A cell outside [0, W) reads byte
// 0, as in the reference.
//
// Bound on H100: one dependent byte load per step, so the walk is latency-
// bound (qlen + tlen - #diagonal steps loads in a chain per pair); the bytes
// it must move are tiny next to that.

#include <cuda_runtime.h>
#include <stdint.h>

#define H_DIAG 0
#define H_D1 1
#define H_I1 2
#define H_D2 3
#define H_I2 4
#define OP_NONE 0
#define OP_M 1
#define OP_I 2
#define OP_D 3

__device__ __forceinline__ int walk_i0_of(int t, int K) {
  const int x = t - K + 1;
  return x > 0 ? (x >> 1) : 0;
}

__global__ void nw_walk_kernel(
    const uint8_t* __restrict__ tb,   // [B, tmax_pad, W]
    const int* __restrict__ qlens,    // [B]
    const int* __restrict__ tlens,    // [B]
    uint8_t* __restrict__ ops,        // [B, tmax + 1] out, zero-filled
    int B, int W, int tmax, int tmax_pad) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int K = W - 1;
  const uint8_t* tbb = tb + (size_t)b * tmax_pad * W;
  uint8_t* out = ops + (size_t)b * (tmax + 1);

  const int qlen = qlens[b];
  const int tlen = tlens[b];
  int cur_t = qlen + tlen;
  int lane = qlen - walk_i0_of(cur_t, K);
  int mat = 0;  // 0 H, 1 D1, 2 I1, 3 D2, 4 I2

  while (cur_t >= 1 && cur_t <= tmax) {
    const int td = cur_t;
    const int bb = (lane >= 0 && lane < W) ? (int)tbb[(size_t)td * W + lane] : 0;
    const int i = walk_i0_of(td, K) + lane;
    const int j = td - i;

    const int choice = bb & 7;
    const bool is_h = mat == 0;
    const bool go_d1 = (is_h && choice == H_D1) || mat == 1;
    const bool go_i1 = (is_h && choice == H_I1) || mat == 2;
    const bool go_d2 = (is_h && choice == H_D2) || mat == 3;
    const bool go_i2 = (is_h && choice == H_I2) || mat == 4;
    const bool diag = is_h && choice == H_DIAG;
    const bool opened =
        (go_d1 ? (bb >> 5) : go_i1 ? (bb >> 3) : go_d2 ? (bb >> 6) : (bb >> 4)) & 1;

    const bool gap_d = go_d1 || go_d2;
    const bool gap_i = go_i1 || go_i2;
    const int op = diag ? OP_M : gap_i ? OP_I : gap_d ? OP_D : OP_NONE;
    const int ni = (diag || gap_i) ? i - 1 : i;
    const int nj = (diag || gap_d) ? j - 1 : j;
    const int nmat = (diag || opened) ? 0 : go_d1 ? 1 : go_i1 ? 2 : go_d2 ? 3 : 4;

    out[td] = (uint8_t)op;
    const int nt = ni + nj;
    // a step that consumes nothing leaves the cursor where the reference's
    // scan has already passed it: the walk ends there
    if ((ni == 0 && nj == 0) || nt >= td) break;
    cur_t = nt;
    lane = ni - walk_i0_of(nt, K);
    mat = nmat;
  }
}

extern "C" int nw_walk_launch(
    const void* tb, const void* qlens, const void* tlens, void* ops,
    int B, int W, int tmax, int tmax_pad, int threads, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int blocks = (B + threads - 1) / threads;
  nw_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tb, (const int*)qlens, (const int*)tlens, (uint8_t*)ops,
      B, W, tmax, tmax_pad);
  return (int)cudaGetLastError();
}
