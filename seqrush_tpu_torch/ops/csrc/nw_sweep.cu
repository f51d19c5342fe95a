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
//     >= 0), and the wide route (nw_sweep_wide.cu) sign-extends the low 16
//     bits of every add, which is the JAX arithmetic whatever the
//     penalties.  Where the
//     planner gives a dispatch twins (ops/nw_cuda.py::plan_sweep_i16), the
//     register route's int16 mode is the packed s16x2 sweep of
//     nw_sweep_i16.cu instead; this body keeps it for dispatches of few
//     pairs and for the snapshot and tiled modes;
//   * snapshot (SnapArgs; _sweep_v3(t_snap=...), the bidirectional fold):
//     at t == t_snap[b] the carry (H(t), H(t-1), I1, D1, I2, D2) goes to
//     SNAP and the clamped diagonal candidate h_diag + sub at t_snap and
//     t_snap + 1 to DIAGA and DIAGB, as stores predicated on the step.  Its
//     register-route kernels are instantiated in nw_sweep_snap.cu, the wide
//     route's in nw_sweep_wide.cu.
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

template <int S, bool TWO, bool TB>
static cudaError_t launch_regs(const void* Q, const void* T, const void* qlens, const void* tlens,
                               void* scores, void* tb, int B, int Lq, int Lt, int W, int tmax,
                               int tmax_pad, Pen p, int wpp, int ppb, int pair_bytes,
                               cudaStream_t stream) {
  const int threads = ppb * wpp * 32;
  const size_t smem = dynamic_smem(ppb, pair_bytes);
  const cudaError_t err = allow_smem((const void*)nw_sweep_regs<S, TWO, TB>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + ppb - 1) / ppb;
  nw_sweep_regs<S, TWO, TB><<<blocks, threads, smem, stream>>>(
      (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens, (int*)scores,
      (uint8_t*)tb, B, Lq, Lt, W, tmax, tmax_pad, p, wpp, ppb, pair_bytes);
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

// The register route's launch at lanes S (4, 8, 12, 16), wpp warps a pair,
// ppb pairs a block of pair_bytes each (ops/nw_cuda.py::plan_sweep; the
// wide route is nw_sweep_wide.cu's).  A null tb selects the score-only
// mode.  A non-null snap selects the snapshot mode (t_snap [B], snap [6, B,
// W], diaga and diagb [B, W], filled with the DP's +infinity by the
// caller); int16 the int16 mode.  Returns the CUDA error code.
extern "C" int nw_sweep_launch(const void* Q, const void* T, const void* qlens, const void* tlens,
                               void* scores, void* tb, const void* t_snap, void* snap, void* diaga,
                               void* diagb, int B, int Lq, int Lt, int W, int tmax, int tmax_pad,
                               int mismatch, int o1, int e1, int o2, int e2, int int16, int lanes,
                               int wpp, int ppb, int pair_bytes, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const bool two = o2 >= 0;
  const bool with_tb = tb != nullptr;
  if (snap != nullptr && !with_tb) return (int)cudaErrorInvalidValue;
  Pen p{mismatch, o1 + e1, e1, o2 + e2, e2};
  p.neg = int16 ? NW_INF16 : NW_INF;
  p.i16 = int16 != 0;
  const SnapArgs sn{(const int*)t_snap, (int*)snap, (int*)diaga, (int*)diagb};
  cudaStream_t st = (cudaStream_t)stream;
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
// one register-route launch shape in the full mode (with_tb), the
// score-only mode or the snapshot mode (snap, its own kernel).
extern "C" int nw_sweep_occupancy(int lanes, int two, int with_tb, int snap, int ppb, int pair_bytes,
                                  int threads, int* regs, int* blocks_per_sm, int* smem_bytes) {
  const void* fn;
  if (snap)
    fn = nw_sweep_snap_kernel(lanes, two != 0);
  else if (two)
    fn = with_tb ? regs_kernel<true, true>(lanes) : regs_kernel<true, false>(lanes);
  else
    fn = with_tb ? regs_kernel<false, true>(lanes) : regs_kernel<false, false>(lanes);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = dynamic_smem(ppb, pair_bytes);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem_bytes = (int)(attr.sharedSizeBytes + smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, smem);
}
