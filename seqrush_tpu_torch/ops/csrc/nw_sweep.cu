// Kernel A, single-shot: anti-diagonals 1..tmax of every pair of a dispatch.
// The device code and the design note are in nw_sweep.cuh; the segment mode
// is instantiated in nw_sweep_seg.cu.
//
// Two more modes:
//   * int16 (Pen::i16 on the register route, the I16 flag of the wide one;
//     replaces the int16 path of the XLA program
//     seqrush_tpu/ops/nw.py::_sweep_v3(dtype=int16)): every state saturates
//     at NW_INF16 = 30000 (NW_INF16 off the matrix) and an empty pair scores
//     0.  The values stay in int32 registers.  The JAX package adds in
//     int16, so an add past 32,767 wraps there: the register route takes
//     only penalties whose adds to 30000 cannot wrap (its keys need values
//     >= 0), and the wide route sign-extends the low 16 bits of every add,
//     which is the JAX arithmetic whatever the penalties.  Where the
//     planner gives a dispatch twins (ops/nw_cuda.py::plan_sweep_i16), the
//     register route's int16 mode is the packed s16x2 sweep of
//     nw_sweep_i16.cu instead; this body keeps it for dispatches of few
//     pairs and for the snapshot and tiled modes;
//   * snapshot (SnapArgs; _sweep_v3(t_snap=...), the bidirectional fold):
//     at t == t_snap[b] the carry (H(t), H(t-1), I1, D1, I2, D2) goes to
//     SNAP and the clamped diagonal candidate h_diag + sub at t_snap and
//     t_snap + 1 to DIAGA and DIAGB, as stores predicated on the step.  Its
//     register-route kernels are instantiated in nw_sweep_snap.cu, the wide
//     route's below (its SNAP flag).
// The wide route takes both as template flags, so its int32 kernels without
// snapshots carry none of either mode's code or registers.
// The bound is the sweep's.

#include "nw_sweep.cuh"

template <int S, bool TWO, bool TB>
__global__ void __launch_bounds__(S <= 4 ? 128 : S <= 8 ? 384 : 256, S == 4 ? 5 : 1)
nw_sweep_regs(const uint8_t* __restrict__ Q,  // [B, Lq] query codes, QPAD-padded
              const uint8_t* __restrict__ T,  // [B, Lt] target codes, TPAD-padded
              const int* __restrict__ qlens, const int* __restrict__ tlens,
              int* __restrict__ scores,        // [B] out
              uint8_t* __restrict__ tb,        // [B, tmax_pad, W] out (TB only)
              int B, int Lq, int Lt, int W, int tmax, int tmax_pad, Pen p, int wpp, int ppb,
              int pair_bytes) {
  const SegArgs none{};
  sweep_regs_body<S, TWO, TB, false>(Q, T, qlens, tlens, scores, tb, B, Lq, Lt, W, tmax, tmax_pad,
                                      p, wpp, ppb, pair_bytes, none);
}

// Wide route, single-shot (see the header's design note).  I16: the int16
// mode; SNAP: the snapshot mode (TB only).
template <bool TB, bool I16, bool SNAP>
__global__ void __launch_bounds__(1024) nw_sweep_wide(
    const uint8_t* __restrict__ Q,      // [B, Lq] query codes, QPAD-padded
    const uint8_t* __restrict__ T,      // [B, Lt] target codes, TPAD-padded
    const int* __restrict__ qlens,      // [B]
    const int* __restrict__ tlens,      // [B]
    int* __restrict__ scores,           // [B] out
    uint8_t* __restrict__ tb,           // [B, tmax_pad, W] out (TB only)
    int* __restrict__ gscratch,         // [B, 11, W] or null (shared memory)
    int Lq, int Lt, int W, int tmax, int tmax_pad,
    int mismatch, int o1, int e1, int o2, int e2, SnapArgs sn) {
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
  uint8_t* tbb = TB ? tb + (size_t)b * tmax_pad * W : nullptr;
  const int neg = I16 ? NW_INF16 : NW_INF;
  const int mis = I16 ? (int)(int16_t)mismatch : mismatch;
  const size_t plane = (size_t)gridDim.x * W;
  const int t_snap = SNAP ? sn.t_snap[b] : -2;
  int* snap = SNAP ? sn.snap + (size_t)b * W : nullptr;

  // state at t = 0 (H[0], gap slot 0) and t = -1 (H[2]); traceback row 0
  // and the padding rows past tmax are never computed: they are zero
  for (int l = threadIdx.x; l < W; l += blockDim.x) {
    H[0][l] = l == 0 ? 0 : neg;
    H[2][l] = neg;
    I1[0][l] = neg;
    D1[0][l] = neg;
    I2[0][l] = neg;
    D2[0][l] = neg;
    if (TB) {
      tbb[l] = 0;
      for (int t = tmax + 1; t < tmax_pad; ++t) tbb[(size_t)t * W + l] = 0;
    }
  }
  if (threadIdx.x == 0) {
    scores[b] = (I16 && t_final == 0) ? 0 : -1;
    if (SNAP && t_snap == 0) snap[0] = 0;  // the initial state: neg but H's origin
  }
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
    uint8_t* tbrow = TB ? tbb + (size_t)t * W : nullptr;

    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      const int h_up = framed(h1, l, dp - 1, W, neg);
      const int h_left = framed(h1, l, dp, W, neg);
      const int h_diag = framed(h2, l, dpp - 1, W, neg);
      const int i1_up = framed(I1[rs], l, dp - 1, W, neg);
      const int d1_left = framed(D1[rs], l, dp, W, neg);

      const int x = qs + l;
      const int qc = (x >= 1 && x <= Lq) ? (int)q[x - 1] : NW_QPAD;
      const int y = ts + l;
      const int tc = (y >= W && y < W + Lt) ? (int)tg[Lt - 1 - (y - W)] : NW_TPAD;
      const int sub = qc == tc ? 0 : mis;

      int a = add16(h_up, o1 + e1, I16);
      int c = add16(i1_up, e1, I16);
      int I1n = min(a, c);
      const bool i1o = a <= c;
      a = add16(h_left, o1 + e1, I16);
      c = add16(d1_left, e1, I16);
      int D1n = min(a, c);
      const bool d1o = a <= c;
      int I2n = neg, D2n = neg;
      bool i2o = false, d2o = false;
      if (two) {
        const int i2_up = framed(I2[rs], l, dp - 1, W, neg);
        const int d2_left = framed(D2[rs], l, dp, W, neg);
        a = add16(h_up, o2 + e2, I16);
        c = add16(i2_up, e2, I16);
        I2n = min(a, c);
        i2o = a <= c;
        a = add16(h_left, o2 + e2, I16);
        c = add16(d2_left, e2, I16);
        D2n = min(a, c);
        d2o = a <= c;
      }

      // strict '<' in the order D1, I1, D2, I2: ties keep the earlier choice
      int Hn = add16(h_diag, sub, I16);
      int choice = 0;
      if (D1n < Hn) { Hn = D1n; choice = 1; }
      if (I1n < Hn) { Hn = I1n; choice = 2; }
      if (D2n < Hn) { Hn = D2n; choice = 3; }
      if (I2n < Hn) { Hn = I2n; choice = 4; }

      const int i = i0 + l;
      const int j = t - i;
      const bool valid = i >= 0 && i <= qlen && j >= 0 && j <= tlen;
      Hn = valid ? min(Hn, neg) : neg;
      hw[l] = Hn;
      I1[ws][l] = valid ? min(I1n, neg) : neg;
      D1[ws][l] = valid ? min(D1n, neg) : neg;
      if (two) {
        I2[ws][l] = valid ? min(I2n, neg) : neg;
        D2[ws][l] = valid ? min(D2n, neg) : neg;
      }
      if (t == t_final && l == qlen - i0 && Hn < NW_INF) scores[b] = Hn;
      if (SNAP) {
        // the fold's captures: the carry at t_snap, the clamped diagonal
        // candidate at t_snap and t_snap + 1
        const int hd = valid ? min(add16(h_diag, sub, I16), neg) : neg;
        if (t == t_snap) {
          snap[l] = Hn;
          snap[plane + l] = h1[l];
          snap[2 * plane + l] = valid ? min(I1n, neg) : neg;
          snap[3 * plane + l] = valid ? min(D1n, neg) : neg;
          snap[4 * plane + l] = valid ? min(I2n, neg) : neg;
          snap[5 * plane + l] = valid ? min(D2n, neg) : neg;
          sn.diaga[(size_t)b * W + l] = hd;
        } else if (t == t_snap + 1) {
          sn.diagb[(size_t)b * W + l] = hd;
        }
      }

      if (TB)
        tbrow[l] = (uint8_t)(choice | ((int)i1o << 3) | ((int)i2o << 4) |
                             ((int)d1o << 5) | ((int)d2o << 6));
    }
    __syncthreads();
  }
}

template <int S, bool TWO, bool TB>
static cudaError_t launch_regs(const void* Q, const void* T, const void* qlens, const void* tlens,
                               void* scores, void* tb, int B, int Lq, int Lt, int W, int tmax,
                               int tmax_pad, Pen p, int wpp, int ppb, int pair_bytes,
                               cudaStream_t stream) {
  const int threads = ppb * wpp * 32;
  const size_t smem = dynamic_smem(S, W, ppb, pair_bytes, false);
  const cudaError_t err = allow_smem((const void*)nw_sweep_regs<S, TWO, TB>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + ppb - 1) / ppb;
  nw_sweep_regs<S, TWO, TB><<<blocks, threads, smem, stream>>>(
      (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens, (int*)scores,
      (uint8_t*)tb, B, Lq, Lt, W, tmax, tmax_pad, p, wpp, ppb, pair_bytes);
  return cudaGetLastError();
}

template <bool TB, bool I16, bool SNAP>
static cudaError_t launch_wide(const void* Q, const void* T, const void* qlens, const void* tlens,
                               void* scores, void* tb, void* scratch, int B, int Lq, int Lt, int W,
                               int tmax, int tmax_pad, int mismatch, int o1, int e1, int o2, int e2,
                               SnapArgs sn, int threads, cudaStream_t stream) {
  const size_t smem = dynamic_smem(0, W, 1, 0, scratch != nullptr);
  const cudaError_t err = allow_smem((const void*)nw_sweep_wide<TB, I16, SNAP>, smem);
  if (err != cudaSuccess) return err;
  nw_sweep_wide<TB, I16, SNAP><<<B, threads, smem, stream>>>(
      (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens, (int*)scores,
      (uint8_t*)tb, (int*)scratch, Lq, Lt, W, tmax, tmax_pad, mismatch, o1, e1, o2, e2, sn);
  return cudaGetLastError();
}

template <bool TWO, bool TB>
static const void* regs_kernel(int S) {
  switch (S) {
    case 4: return (const void*)nw_sweep_regs<4, TWO, TB>;
    case 8: return (const void*)nw_sweep_regs<8, TWO, TB>;
    case 12: return (const void*)nw_sweep_regs<12, TWO, TB>;
    case 16: return (const void*)nw_sweep_regs<16, TWO, TB>;
    default: return nullptr;
  }
}

// lanes: S of the register route, or 0 for the wide route (its rows then go
// to scratch, a [B, 11, W] int32 buffer, or to shared memory where scratch is
// null).  A null tb selects the score-only mode.  A non-null snap selects the
// snapshot mode (t_snap [B], snap [6, B, W], diaga and diagb [B, W], filled
// with the DP's +infinity by the caller); int16 the int16 mode.  Returns the
// CUDA error code.
extern "C" int nw_sweep_launch(const void* Q, const void* T, const void* qlens, const void* tlens,
                               void* scores, void* tb, void* scratch, const void* t_snap,
                               void* snap, void* diaga, void* diagb, int B, int Lq, int Lt, int W,
                               int tmax, int tmax_pad, int mismatch, int o1, int e1, int o2,
                               int e2, int int16, int lanes, int wpp, int ppb, int pair_bytes,
                               int wide_threads, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const bool two = o2 >= 0;
  const bool with_tb = tb != nullptr;
  if (snap != nullptr && !with_tb) return (int)cudaErrorInvalidValue;
  Pen p{mismatch, o1 + e1, e1, o2 + e2, e2};
  p.neg = int16 ? NW_INF16 : NW_INF;
  p.i16 = int16 != 0;
  const SnapArgs sn{(const int*)t_snap, (int*)snap, (int*)diaga, (int*)diagb};
  cudaStream_t st = (cudaStream_t)stream;
  if (lanes == 0) {
#define NW_WIDE(TBV, I16V, SNAPV)                                                                 \
  launch_wide<TBV, I16V, SNAPV>(Q, T, qlens, tlens, scores, tb, scratch, B, Lq, Lt, W, tmax,      \
                                tmax_pad, mismatch, o1, e1, o2, e2, sn, wide_threads, st)
    const cudaError_t err = snap != nullptr ? (int16 ? NW_WIDE(true, true, true)
                                                     : NW_WIDE(true, false, true))
                            : with_tb       ? (int16 ? NW_WIDE(true, true, false)
                                                     : NW_WIDE(true, false, false))
                                            : (int16 ? NW_WIDE(false, true, false)
                                                     : NW_WIDE(false, false, false));
#undef NW_WIDE
    return (int)err;
  }
  if (snap != nullptr)
    return (int)nw_sweep_snap_regs_launch(Q, T, qlens, tlens, scores, tb, B, Lq, Lt, W, tmax,
                                          tmax_pad, p, two, lanes, wpp, ppb, pair_bytes, sn, st);
#define NW_LAUNCH_TB(SV, TWOV)                                                                    \
  (with_tb ? launch_regs<SV, TWOV, true>(Q, T, qlens, tlens, scores, tb, B, Lq, Lt, W, tmax,      \
                                         tmax_pad, p, wpp, ppb, pair_bytes, st)                  \
           : launch_regs<SV, TWOV, false>(Q, T, qlens, tlens, scores, tb, B, Lq, Lt, W, tmax,     \
                                          tmax_pad, p, wpp, ppb, pair_bytes, st))
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

// Registers per thread, resident blocks per SM and shared memory per block
// (static, from the runtime, plus the dynamic bytes the launch asks for) of
// one launch shape in the full mode (with_tb), the score-only mode or the
// snapshot mode (snap, the register route's own kernel); lanes 0 is the wide
// route.
extern "C" int nw_sweep_occupancy(int lanes, int two, int with_tb, int snap, int W, int ppb,
                                  int pair_bytes, int scratch, int threads, int* regs,
                                  int* blocks_per_sm, int* smem_bytes) {
  const void* fn;
  if (snap)
    fn = lanes == 0 ? nullptr : nw_sweep_snap_kernel(lanes, two != 0);
  else if (lanes == 0)
    fn = with_tb ? (const void*)nw_sweep_wide<true, false, false>
                 : (const void*)nw_sweep_wide<false, false, false>;
  else if (two)
    fn = with_tb ? regs_kernel<true, true>(lanes) : regs_kernel<true, false>(lanes);
  else
    fn = with_tb ? regs_kernel<false, true>(lanes) : regs_kernel<false, false>(lanes);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = dynamic_smem(lanes, W, ppb, pair_bytes, scratch != 0);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem_bytes = (int)(attr.sharedSizeBytes + smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, smem);
}
