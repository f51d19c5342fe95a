// The batched wavefront aligner (WFA) with two-piece or one-piece gap-affine
// penalties.
//
// The counterpart of the XLA program seqrush_tpu/ops/wfa.py::wfa_align_device
// (an XLA while-loop over scores with the batch in lockstep).  Scores are
// penalties (match 0); diagonal k = h - v, offset h (target bases consumed);
// five wavefronts M, I1, D1, I2, D2 (three one-piece) over NDIAG = 2 * band
// + 1 diagonals:
//   I1[s,k] = max(M[s-o1-e1, k+1], I1[s-e1, k+1])          (consume query)
//   D1[s,k] = max(M[s-o1-e1, k-1], D1[s-e1, k-1]) + 1      (consume target)
//   (I2, D2 with o2, e2)
//   M[s,k]  = max(M[s-x, k] + 1, I1, D1, I2, D2), then the greedy extension
// Each wavefront cell is NULL unless 0 <= h <= tlen and 0 <= h - k <= qlen.
// A pair ends at the first score s with M[s, tlen - qlen] == tlen and
// s <= cap; it stops unfinished (score -1) at s >= cap or past smax.  The
// history holds every score's wavefronts as int16 [B, rows, NDIAG] per
// wavefront, clipped to [-2^15, 2^15 - 1] as the reference's store16 does;
// row s lives at s % rows (rows = smax + 1 keeps them all; the score-only
// mode keeps max(x, o1 + e1, o2 + e2) + 1 rolling rows).
//
// What bounds it on an H100: the chain of score steps.  Step s needs the
// wavefronts of steps s - x, s - o - e and s - e, so the steps of a pair
// are serial; a step's work is NDIAG cells.  The design:
//   * one block per pair, threads striding over the diagonals; the score
//     loop runs inside the kernel with one __syncthreads() per step, so a
//     pair costs no launch per score and leaves the loop when it ends,
//     whatever the rest of the batch does;
//   * the pair's query and target staged in shared memory when they fit,
//     read from device memory otherwise; the greedy extension compares one
//     base at a time and stops at either sequence's end;
//   * the history rows in device memory, written once a step and read back
//     by the block (they stay in L2 across the few steps of a lookback);
//   * the end of a pair is signalled through one of two shared flags, by
//     the parity of the step, so a thread that has seen one step's flag
//     cannot race with the next step's writer.

#include <cuda_runtime.h>
#include <stdint.h>

#define WFA_NULL (-(1 << 30))
#define WFA_NULL16 (-32768)

__device__ __forceinline__ int16_t wfa_store16(int x) {
  return (int16_t)max(WFA_NULL16, min(32767, x));
}

// History row of score sb at diagonal d, NULL before score 0 or off the band
// (the reference's _hist_row and its shifts).
__device__ __forceinline__ int wfa_hist(const int16_t* H, int sb, int rows, int nd, int d) {
  if (sb < 0 || d < 0 || d >= nd) return WFA_NULL;
  const int v = H[(size_t)(sb % rows) * nd + d];
  return v <= WFA_NULL16 ? WFA_NULL : v;
}

__device__ __forceinline__ int wfa_valid(int off, int k, int ql, int tl) {
  const int v = off - k;
  return (off >= 0 && off <= tl && v >= 0 && v <= ql) ? off : WFA_NULL;
}

__device__ __forceinline__ int wfa_extend(int h, int k, const uint8_t* q, const uint8_t* t, int ql,
                                          int tl) {
  int v = h - k;
  while (h < tl && v < ql && t[h] == q[v]) {
    ++h;
    ++v;
  }
  return h;
}

template <bool TWO>
__global__ void __launch_bounds__(1024) wfa_kernel(
    const uint8_t* __restrict__ Q,   // [B, Lq]
    const uint8_t* __restrict__ T,   // [B, Lt]
    const int* __restrict__ qlens,   // [B]
    const int* __restrict__ tlens,   // [B]
    const int* __restrict__ caps,    // [B] score caps
    int* __restrict__ scores,        // [B] out
    int16_t* HM, int16_t* HI1, int16_t* HD1, int16_t* HI2, int16_t* HD2,  // [B, rows, nd]
    int Lq, int Lt, int band, int rows, int smax, int x, int o1, int e1, int o2, int e2,
    int stage) {
  extern __shared__ __align__(16) uint8_t wfa_smem[];
  __shared__ int s_done[2];  // the pair ended at a step of this parity
  __shared__ int s_score;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int nd = 2 * band + 1;
  const int ql = qlens[b], tl = tlens[b], cap = caps[b];
  const uint8_t* q = Q + (size_t)b * Lq;
  const uint8_t* t = T + (size_t)b * Lt;
  if (stage) {
    uint8_t* sq = wfa_smem;
    uint8_t* st = wfa_smem + ((Lq + 15) & ~15);
    for (int i = tid; i < Lq; i += nth) sq[i] = q[i];
    for (int i = tid; i < Lt; i += nth) st[i] = t[i];
    q = sq;
    t = st;
  }
  const size_t base = (size_t)b * rows * nd;
  HM += base;
  HI1 += base;
  HD1 += base;
  if (TWO) {
    HI2 += base;
    HD2 += base;
  }
  const int dfin = tl - ql + band;
  if (tid == 0) {
    s_done[0] = s_done[1] = 0;
    s_score = -1;
  }
  __syncthreads();
  // s = 0: M on diagonal 0 from offset 0, extended
  for (int d = tid; d < nd; d += nth) {
    const int k = d - band;
    int m = wfa_valid(k == 0 ? 0 : WFA_NULL, k, ql, tl);
    if (m > WFA_NULL) m = wfa_extend(m, k, q, t, ql, tl);
    HM[d] = wfa_store16(m);
    if (d == dfin && m == tl) {
      s_done[0] = 1;
      s_score = 0;
    }
  }
  __syncthreads();
  bool done = s_done[0];
  for (int s = 1; s <= smax && !done; ++s) {
    const size_t r = (size_t)(s % rows) * nd;
    const int so1 = s - o1 - e1, se1 = s - e1;
    const int so2 = s - o2 - e2, se2 = s - e2;
    for (int d = tid; d < nd; d += nth) {
      const int k = d - band;
      const int m_x = wfa_hist(HM, s - x, rows, nd, d);
      int i1 = max(wfa_hist(HM, so1, rows, nd, d + 1), wfa_hist(HI1, se1, rows, nd, d + 1));
      int d1 = max(wfa_hist(HM, so1, rows, nd, d - 1), wfa_hist(HD1, se1, rows, nd, d - 1));
      d1 = d1 > WFA_NULL ? d1 + 1 : WFA_NULL;
      i1 = wfa_valid(i1, k, ql, tl);
      d1 = wfa_valid(d1, k, ql, tl);
      int i2 = WFA_NULL, d2 = WFA_NULL;
      if (TWO) {
        i2 = max(wfa_hist(HM, so2, rows, nd, d + 1), wfa_hist(HI2, se2, rows, nd, d + 1));
        d2 = max(wfa_hist(HM, so2, rows, nd, d - 1), wfa_hist(HD2, se2, rows, nd, d - 1));
        d2 = d2 > WFA_NULL ? d2 + 1 : WFA_NULL;
        i2 = wfa_valid(i2, k, ql, tl);
        d2 = wfa_valid(d2, k, ql, tl);
      }
      int m = m_x > WFA_NULL ? m_x + 1 : WFA_NULL;
      m = max(max(m, max(i1, d1)), max(i2, d2));
      m = wfa_valid(m, k, ql, tl);
      if (m > WFA_NULL) m = wfa_extend(m, k, q, t, ql, tl);
      HM[r + d] = wfa_store16(m);
      HI1[r + d] = wfa_store16(i1);
      HD1[r + d] = wfa_store16(d1);
      if (TWO) {
        HI2[r + d] = wfa_store16(i2);
        HD2[r + d] = wfa_store16(d2);
      }
      if (d == dfin && m == tl && s <= cap) {
        s_done[s & 1] = 1;
        s_score = s;
      }
    }
    __syncthreads();
    done = s_done[s & 1] || s >= cap;
  }
  if (tid == 0) scores[b] = s_score;
}

template <bool TWO>
static cudaError_t wfa_launch_t(const void* Q, const void* T, const void* qlens, const void* tlens,
                                const void* caps, void* scores, void* HM, void* HI1, void* HD1,
                                void* HI2, void* HD2, int B, int Lq, int Lt, int band, int rows,
                                int smax, int x, int o1, int e1, int o2, int e2, int threads,
                                int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(wfa_kernel<TWO>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  wfa_kernel<TWO><<<B, threads, smem_bytes, stream>>>(
      (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens, (const int*)caps,
      (int*)scores, (int16_t*)HM, (int16_t*)HI1, (int16_t*)HD1, (int16_t*)HI2, (int16_t*)HD2, Lq,
      Lt, band, rows, smax, x, o1, e1, o2, e2, smem_bytes > 0);
  return cudaGetLastError();
}

// One launch over B pairs: scores [B] int32 out; the history tensors
// [B, rows, 2 * band + 1] int16, filled with NULL16 by the caller (HI2, HD2
// unused when o2 < 0); the pair's query and target staged in smem_bytes of
// shared memory (0: read from device memory).  Returns the CUDA error code.
extern "C" int wfa_launch(const void* Q, const void* T, const void* qlens, const void* tlens,
                          const void* caps, void* scores, void* HM, void* HI1, void* HD1,
                          void* HI2, void* HD2, int B, int Lq, int Lt, int band, int rows,
                          int smax, int x, int o1, int e1, int o2, int e2, int threads,
                          int smem_bytes, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (threads < 32 || threads > 1024 || rows < 1 || band < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (o2 >= 0)
    return (int)wfa_launch_t<true>(Q, T, qlens, tlens, caps, scores, HM, HI1, HD1, HI2, HD2, B,
                                   Lq, Lt, band, rows, smax, x, o1, e1, o2, e2, threads,
                                   smem_bytes, s);
  return (int)wfa_launch_t<false>(Q, T, qlens, tlens, caps, scores, HM, HI1, HD1, HI2, HD2, B,
                                  Lq, Lt, band, rows, smax, x, o1, e1, o2, e2, threads, smem_bytes,
                                  s);
}

// Registers per thread, static shared memory and resident blocks (pairs) per
// SM of one launch shape.
extern "C" int wfa_occupancy(int two, int threads, int smem_bytes, int* regs, int* blocks_per_sm,
                             int* static_smem) {
  cudaFuncAttributes attr;
  const void* fn = two ? (const void*)wfa_kernel<true> : (const void*)wfa_kernel<false>;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *static_smem = (int)attr.sharedSizeBytes;
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, smem_bytes);
}
