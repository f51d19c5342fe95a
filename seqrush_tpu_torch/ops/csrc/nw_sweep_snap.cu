// Kernel A's snapshot mode on the register route (the fold's half sweeps;
// see nw_sweep.cu's note on the modes and nw_sweep.cuh's design note): the
// single-shot kernel with the traceback and the captures of t_snap and
// t_snap + 1 compiled in.  Its instantiations live in this file so that the
// other single-shot kernels carry none of its code or registers, and nvcc
// builds it beside them.

#include "nw_sweep.cuh"

template <int S, bool TWO>
__global__ void __launch_bounds__(S <= 4 ? 128 : S <= 8 ? 384 : 256, S == 4 ? 5 : 1)
nw_sweep_regs_snap(const uint8_t* __restrict__ Q,  // [B, Lq] query codes, QPAD-padded
                   const uint8_t* __restrict__ T,  // [B, Lt] target codes, TPAD-padded
                   const int* __restrict__ qlens, const int* __restrict__ tlens,
                   int* __restrict__ scores,        // [B] out
                   uint8_t* __restrict__ tb,        // [B, tmax_pad, W] out
                   int B, int Lq, int Lt, int W, int tmax, int tmax_pad, Pen p, int wpp, int ppb,
                   int pair_bytes, SnapArgs sn) {
  const SegArgs none{};
  sweep_regs_body<S, TWO, true, false, true>(Q, T, qlens, tlens, scores, tb, B, Lq, Lt, W, tmax,
                                             tmax_pad, p, wpp, ppb, pair_bytes, none, sn);
}

template <int S, bool TWO>
static cudaError_t launch_snap(const void* Q, const void* T, const void* qlens, const void* tlens,
                               void* scores, void* tb, int B, int Lq, int Lt, int W, int tmax,
                               int tmax_pad, Pen p, int wpp, int ppb, int pair_bytes, SnapArgs sn,
                               cudaStream_t stream) {
  const int threads = ppb * wpp * 32;
  const size_t smem = dynamic_smem(S, W, ppb, pair_bytes, false);
  const cudaError_t err = allow_smem((const void*)nw_sweep_regs_snap<S, TWO>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + ppb - 1) / ppb;
  nw_sweep_regs_snap<S, TWO><<<blocks, threads, smem, stream>>>(
      (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens, (int*)scores,
      (uint8_t*)tb, B, Lq, Lt, W, tmax, tmax_pad, p, wpp, ppb, pair_bytes, sn);
  return cudaGetLastError();
}

cudaError_t nw_sweep_snap_regs_launch(const void* Q, const void* T, const void* qlens,
                                      const void* tlens, void* scores, void* tb, int B, int Lq,
                                      int Lt, int W, int tmax, int tmax_pad, Pen p, bool two,
                                      int lanes, int wpp, int ppb, int pair_bytes, SnapArgs sn,
                                      cudaStream_t stream) {
#define NW_SNAP(SV)                                                                              \
  case SV:                                                                                       \
    return two ? launch_snap<SV, true>(Q, T, qlens, tlens, scores, tb, B, Lq, Lt, W, tmax,       \
                                       tmax_pad, p, wpp, ppb, pair_bytes, sn, stream)            \
               : launch_snap<SV, false>(Q, T, qlens, tlens, scores, tb, B, Lq, Lt, W, tmax,      \
                                        tmax_pad, p, wpp, ppb, pair_bytes, sn, stream);
  switch (lanes) {
    NW_SNAP(4)
    NW_SNAP(8)
    NW_SNAP(12)
    NW_SNAP(16)
    default: return cudaErrorInvalidValue;
  }
#undef NW_SNAP
}
