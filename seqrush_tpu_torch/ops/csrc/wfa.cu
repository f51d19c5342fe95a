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
// are serial; a step's work is NDIAG cells, one thread each.  A step's
// chain is its lookback reads, the cell's maxima, the greedy extension and
// one barrier.  The design:
//   * one block per pair, threads striding over the diagonals; the score
//     loop runs inside the kernel with one __syncthreads() per step, so a
//     pair costs no launch per score and leaves the loop when it ends,
//     whatever the rest of the batch does;
//   * lookback rings in shared memory (the "rings" route): each wavefront
//     keeps only the rows its recurrences read back, as the same clipped
//     int16 values the history holds (M max(x, o1 + e1, o2 + e2) + 1 rows,
//     I and D e + 1 rows each), one NULL16 column on either side of a row
//     so the neighbouring diagonals need no bounds test; a step reads only
//     its rings, and the history in device memory (or the score-only mode's
//     rolling rows) is written with streaming stores and never read back.
//     Where the rings do not fit shared memory (very wide bands or very
//     long lookbacks) the "global" route reads the history rows back from
//     device memory, as the first design did;
//   * the pair's query and target staged in shared memory when they fit
//     beside the rings, read from device memory otherwise;
//   * a blocked greedy extension: 8 bases a compare, each operand as two
//     aligned 8-byte loads and a shift, the first differing base from the
//     xor's lowest set bit, the run capped at either sequence's end (so the
//     pad columns' values do not matter; reads past a row's end stay inside
//     the staged copy's slack, or fall back to byte loads at the edges of
//     the tensors in device memory);
//   * the end of a pair is signalled through one of two shared flags, by
//     the parity of the step, so a thread that has seen one step's flag
//     cannot race with the next step's writer;
//   * the mismatch 0 reads M's own row (NULL in the history), which no ring
//     holds, so it takes the global route (ops/wfa.py::wfa_plan).
// What is left: a step's chain of ring reads, maxima, extension and barrier
// where a batch leaves an SM one pair (about 1 us a step); where two or more
// pairs share an SM, their 16 warps each issue every diagonal's work, and
// the step takes 2 to 2.5 us.

#include <cuda_runtime.h>
#include <stdint.h>

#define WFA_NULL (-(1 << 30))
#define WFA_NULL16 (-32768)

__device__ __forceinline__ int16_t wfa_store16(int x) {
  return (int16_t)max(WFA_NULL16, min(32767, x));
}

// History row of score sb at diagonal d, NULL before score 0 or off the band
// (the reference's _hist_row and its shifts): the global route's read.
__device__ __forceinline__ int wfa_hist(const int16_t* H, int sb, int rows, int nd, int d) {
  if (sb < 0 || d < 0 || d >= nd) return WFA_NULL;
  const int v = H[(size_t)(sb % rows) * nd + d];
  return v <= WFA_NULL16 ? WFA_NULL : v;
}

__device__ __forceinline__ int wfa_valid(int off, int k, int ql, int tl) {
  const int v = off - k;
  return (off >= 0 && off <= tl && v >= 0 && v <= ql) ? off : WFA_NULL;
}

// The 8 bytes at p..p+7 (any alignment), little-endian, from two aligned
// 8-byte words.  GUARD: p may lie near the ends [lo, hi) of a tensor in
// device memory, where an aligned word could leave it; those reads go byte
// by byte, and bytes outside it read as 0xff.
template <bool GUARD>
__device__ __forceinline__ uint64_t wfa_load8(const uint8_t* p, const uint8_t* lo,
                                              const uint8_t* hi) {
  const uintptr_t a = (uintptr_t)p;
  const uint64_t* w = (const uint64_t*)(a & ~(uintptr_t)7);
  const unsigned sh = (unsigned)(a & 7) * 8;
  if (GUARD && ((const uint8_t*)w < lo || (const uint8_t*)(w + 2) > hi)) {
    uint64_t out = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint8_t* b = p + j;
      const uint64_t v = (b >= lo && b < hi) ? *b : 0xffu;
      out |= v << (8 * j);
    }
    return out;
  }
  const uint64_t w0 = w[0];
  if (sh == 0) return w0;
  return (w0 >> sh) | (w[1] << (64 - sh));
}

// The greedy extension of offset h on diagonal k: the matching run from
// (h, h - k), 8 bases a compare, capped at min(tl, h + (ql - v)).
template <bool GUARD>
__device__ __forceinline__ int wfa_extend(int h, int k, const uint8_t* q, const uint8_t* t, int ql,
                                          int tl, const uint8_t* qlo, const uint8_t* qhi,
                                          const uint8_t* tlo, const uint8_t* thi) {
  const int v = h - k;
  const int lim = min(tl - h, ql - v);
  int n = 0;
  while (n < lim) {
    const uint64_t diff = wfa_load8<GUARD>(t + h + n, tlo, thi) ^ wfa_load8<GUARD>(q + v + n, qlo, qhi);
    if (diff) {
      n += (__ffsll((long long)diff) - 1) >> 3;
      break;
    }
    n += 8;
  }
  return h + min(n, lim);
}

// ring slot of score s - back, c = s % R, 0 <= back < R; the slot of a
// negative score is one not yet written (NULL16 since the start)
__device__ __forceinline__ int wfa_slot(int c, int back, int R) {
  const int r = c - back;
  return r < 0 ? r + R : r;
}

// RINGS: the lookback rows in shared memory (else read back from the
// history in device memory).  STAGED: the sequences in shared memory.
template <bool TWO, bool RINGS, bool STAGED>
__global__ void __launch_bounds__(1024) wfa_kernel(
    const uint8_t* __restrict__ Q,   // [B, Lq]
    const uint8_t* __restrict__ T,   // [B, Lt]
    const int* __restrict__ qlens,   // [B]
    const int* __restrict__ tlens,   // [B]
    const int* __restrict__ caps,    // [B] score caps
    int* __restrict__ scores,        // [B] out
    int16_t* HM, int16_t* HI1, int16_t* HD1, int16_t* HI2, int16_t* HD2,  // [B, rows, nd]
    int B, int Lq, int Lt, int band, int rows, int smax, int x, int o1, int e1, int o2, int e2,
    int ring_bytes) {
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
  // the tensors' extents, for the guarded 8-byte reads of the unstaged route
  const uint8_t* qlo = Q;
  const uint8_t* qhi = Q + (size_t)B * Lq;
  const uint8_t* tlo = T;
  const uint8_t* thi = T + (size_t)B * Lt;
  if (STAGED) {
    // each copy keeps 16 bytes of slack past the row for the 8-byte reads
    const int sq_bytes = ((Lq + 15) & ~15) + 16;
    const int st_bytes = ((Lt + 15) & ~15) + 16;
    uint8_t* sq = wfa_smem + ring_bytes;
    uint8_t* st = sq + sq_bytes;
    for (int i = tid; i < sq_bytes; i += nth) sq[i] = i < Lq ? q[i] : 0xffu;
    for (int i = tid; i < st_bytes; i += nth) st[i] = i < Lt ? t[i] : 0xfeu;
    q = sq;
    t = st;
  }
  const int stride = nd + 2;  // a ring row: NULL16, diagonals 0..nd-1, NULL16
  const int RM = max(max(x, o1 + e1), TWO ? o2 + e2 : 0) + 1;
  const int R1 = e1 + 1;
  const int R2 = TWO ? e2 + 1 : 0;
  int16_t* rM = (int16_t*)wfa_smem;
  int16_t* rI1 = rM + RM * stride;
  int16_t* rD1 = rI1 + R1 * stride;
  int16_t* rI2 = rD1 + R1 * stride;
  int16_t* rD2 = rI2 + R2 * stride;
  if (RINGS) {
    const int n = (RM + 2 * R1 + 2 * R2) * stride;
    for (int i = tid; i < n; i += nth) rM[i] = (int16_t)WFA_NULL16;
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
    if (m > WFA_NULL) m = wfa_extend<!STAGED>(m, k, q, t, ql, tl, qlo, qhi, tlo, thi);
    const int16_t m16 = wfa_store16(m);
    if (RINGS) rM[d + 1] = m16;
    __stcs(HM + d, m16);
    if (d == dfin && m == tl) {
      s_done[0] = 1;
      s_score = 0;
    }
  }
  __syncthreads();
  bool done = s_done[0];
  int cM = 0, c1 = 0, c2 = 0, ch = 0;  // s % RM, s % R1, s % R2, s % rows
  for (int s = 1; s <= smax && !done; ++s) {
    cM = cM + 1 == RM ? 0 : cM + 1;
    c1 = c1 + 1 == R1 ? 0 : c1 + 1;
    if (TWO) c2 = c2 + 1 == R2 ? 0 : c2 + 1;
    ch = ch + 1 == rows ? 0 : ch + 1;
    const size_t r = (size_t)ch * nd;
    const int so1 = s - o1 - e1, se1 = s - e1;
    const int so2 = s - o2 - e2, se2 = s - e2;
    // this step's ring rows, offset by the pad column
    const int16_t* pMx = rM + wfa_slot(cM, x, RM) * stride + 1;
    const int16_t* pMo1 = rM + wfa_slot(cM, o1 + e1, RM) * stride + 1;
    const int16_t* pI1 = rI1 + wfa_slot(c1, e1, R1) * stride + 1;
    const int16_t* pD1 = rD1 + wfa_slot(c1, e1, R1) * stride + 1;
    const int16_t* pMo2 = rM + (TWO ? wfa_slot(cM, o2 + e2, RM) : 0) * stride + 1;
    const int16_t* pI2 = rI2 + (TWO ? wfa_slot(c2, e2, R2) : 0) * stride + 1;
    const int16_t* pD2 = rD2 + (TWO ? wfa_slot(c2, e2, R2) : 0) * stride + 1;
    for (int d = tid; d < nd; d += nth) {
      const int k = d - band;
      // the lookback values; a NULL16 read stays negative (-32768) through
      // the +1s below, and every negative offset is NULL after validity
      int m_x, mo1u, mo1l, i1u, d1l, mo2u = WFA_NULL, mo2l = WFA_NULL, i2u = WFA_NULL,
                                      d2l = WFA_NULL;
      if (RINGS) {
        m_x = pMx[d];
        mo1u = pMo1[d + 1];
        mo1l = pMo1[d - 1];
        i1u = pI1[d + 1];
        d1l = pD1[d - 1];
        if (TWO) {
          mo2u = pMo2[d + 1];
          mo2l = pMo2[d - 1];
          i2u = pI2[d + 1];
          d2l = pD2[d - 1];
        }
      } else {
        m_x = wfa_hist(HM, s - x, rows, nd, d);
        mo1u = wfa_hist(HM, so1, rows, nd, d + 1);
        mo1l = wfa_hist(HM, so1, rows, nd, d - 1);
        i1u = wfa_hist(HI1, se1, rows, nd, d + 1);
        d1l = wfa_hist(HD1, se1, rows, nd, d - 1);
        if (TWO) {
          mo2u = wfa_hist(HM, so2, rows, nd, d + 1);
          mo2l = wfa_hist(HM, so2, rows, nd, d - 1);
          i2u = wfa_hist(HI2, se2, rows, nd, d + 1);
          d2l = wfa_hist(HD2, se2, rows, nd, d - 1);
        }
      }
      const int i1 = wfa_valid(max(mo1u, i1u), k, ql, tl);
      const int d1 = wfa_valid(max(mo1l, d1l) + 1, k, ql, tl);
      int i2 = WFA_NULL, d2 = WFA_NULL;
      if (TWO) {
        i2 = wfa_valid(max(mo2u, i2u), k, ql, tl);
        d2 = wfa_valid(max(mo2l, d2l) + 1, k, ql, tl);
      }
      int m = max(max(m_x + 1, max(i1, d1)), max(i2, d2));
      m = wfa_valid(m, k, ql, tl);
      if (m > WFA_NULL) m = wfa_extend<!STAGED>(m, k, q, t, ql, tl, qlo, qhi, tlo, thi);
      const int16_t m16 = wfa_store16(m), i116 = wfa_store16(i1), d116 = wfa_store16(d1);
      if (RINGS) {
        rM[cM * stride + 1 + d] = m16;
        rI1[c1 * stride + 1 + d] = i116;
        rD1[c1 * stride + 1 + d] = d116;
      }
      __stcs(HM + r + d, m16);
      __stcs(HI1 + r + d, i116);
      __stcs(HD1 + r + d, d116);
      if (TWO) {
        const int16_t i216 = wfa_store16(i2), d216 = wfa_store16(d2);
        if (RINGS) {
          rI2[c2 * stride + 1 + d] = i216;
          rD2[c2 * stride + 1 + d] = d216;
        }
        __stcs(HI2 + r + d, i216);
        __stcs(HD2 + r + d, d216);
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

static const void* wfa_fn(bool two, bool rings, bool staged) {
  const void* fns[8] = {
      (const void*)wfa_kernel<false, false, false>, (const void*)wfa_kernel<false, false, true>,
      (const void*)wfa_kernel<false, true, false>,  (const void*)wfa_kernel<false, true, true>,
      (const void*)wfa_kernel<true, false, false>,  (const void*)wfa_kernel<true, false, true>,
      (const void*)wfa_kernel<true, true, false>,   (const void*)wfa_kernel<true, true, true>};
  return fns[(two ? 4 : 0) + (rings ? 2 : 0) + (staged ? 1 : 0)];
}

// One launch over B pairs: scores [B] int32 out; the history tensors
// [B, rows, 2 * band + 1] int16, filled with NULL16 by the caller (HI2, HD2
// unused when o2 < 0).  Shared memory: ring_bytes of lookback rings (0: the
// global route, which reads the history back), then, when staged, the
// pair's query and target (ops/wfa.py::wfa_plan sizes both).  Returns the
// CUDA error code.
extern "C" int wfa_launch(const void* Q, const void* T, const void* qlens, const void* tlens,
                          const void* caps, void* scores, void* HM, void* HI1, void* HD1,
                          void* HI2, void* HD2, int B, int Lq, int Lt, int band, int rows,
                          int smax, int x, int o1, int e1, int o2, int e2, int threads,
                          int ring_bytes, int staged, int smem_bytes, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (threads < 32 || threads > 1024 || rows < 1 || band < 0 || ring_bytes < 0 ||
      ring_bytes > smem_bytes)
    return (int)cudaErrorInvalidValue;
  const void* fn = wfa_fn(o2 >= 0, ring_bytes > 0, staged != 0);
  if (smem_bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  void* args[] = {&Q,  &T,  &qlens, &tlens, &caps, &scores, &HM, &HI1, &HD1, &HI2, &HD2, &B,
                  &Lq, &Lt, &band,  &rows,  &smax, &x,      &o1, &e1,  &o2,  &e2,  &ring_bytes};
  return (int)cudaLaunchKernel(fn, dim3(B), dim3(threads), args, (size_t)smem_bytes,
                               (cudaStream_t)stream);
}

// Registers per thread, static shared memory and resident blocks (pairs) per
// SM of one launch shape.
extern "C" int wfa_occupancy(int two, int rings, int staged, int threads, int smem_bytes, int* regs,
                             int* blocks_per_sm, int* static_smem) {
  cudaFuncAttributes attr;
  const void* fn = wfa_fn(two, rings, staged);
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
