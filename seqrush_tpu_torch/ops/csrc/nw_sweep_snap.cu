// Kernel A's snapshot mode on the register route (the fold's half sweeps;
// see nw_sweep.cu's note on the modes and nw_sweep.cuh's design note): the
// single-shot kernel with the traceback and the captures of t_snap and
// t_snap + 1 compiled in.  Its instantiations live in this file so that the
// other single-shot kernels carry none of its code or registers, and nvcc
// builds it beside them.
//
// Replaces seqrush_tpu/ops/nw.py:275 _sweep_v3(t_snap=...), run by
// nw_align_fold (:1678).  What bounds it on an H100: integer instructions,
// as kernel A, over the cells the fold reads: each row's anti-diagonals up
// to t_snap + 1, about half of qlen + tlen (the combine reads SNAP and
// DIAGA at t_snap and DIAGB at t_snap + 1; the start walk walks back from
// t_snap or t_snap + 1).  The design spends nothing past them: each row's
// sweep ends at t_snap + 1 (or at t_final, where the score falls within
// tmax and later), its warps leaving the step loop while the block's other
// pairs go on (their barriers are per pair), and the traceback rows past
// that end are left unwritten (nw_cuda.snapshot_rows names the rows the mode
// promises).  The step loop up to t_snap - 1 carries no capture: the two
// captured anti-diagonals run apart, after it, so no predicate is tested a
// step and the capture pointers are live only there (sweep_regs_body's SNAP
// branch in nw_sweep.cuh).

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

template <bool TWO>
static const void* snap_kernel(int lanes) {
  switch (lanes) {
    case 4: return (const void*)nw_sweep_regs_snap<4, TWO>;
    case 8: return (const void*)nw_sweep_regs_snap<8, TWO>;
    case 12: return (const void*)nw_sweep_regs_snap<12, TWO>;
    case 16: return (const void*)nw_sweep_regs_snap<16, TWO>;
    default: return nullptr;
  }
}

const void* nw_sweep_snap_kernel(int lanes, bool two) {
  return two ? snap_kernel<true>(lanes) : snap_kernel<false>(lanes);
}

cudaError_t nw_sweep_snap_regs_launch(const void* Q, const void* T, const void* qlens,
                                      const void* tlens, void* scores, void* tb, int B, int Lq,
                                      int Lt, int W, int tmax, int tmax_pad, Pen p, bool two,
                                      int lanes, int wpp, int ppb, int pair_bytes, SnapArgs sn,
                                      cudaStream_t stream) {
  const void* fn = nw_sweep_snap_kernel(lanes, two);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const size_t smem = dynamic_smem(ppb, pair_bytes);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  const uint8_t* q = (const uint8_t*)Q;
  const uint8_t* t = (const uint8_t*)T;
  const int* ql = (const int*)qlens;
  const int* tl = (const int*)tlens;
  int* sc = (int*)scores;
  uint8_t* tbb = (uint8_t*)tb;
  void* args[] = {&q, &t, &ql, &tl, &sc, &tbb, &B, &Lq, &Lt, &W, &tmax, &tmax_pad, &p, &wpp, &ppb, &pair_bytes, &sn};
  err = cudaLaunchKernel(fn, dim3((B + ppb - 1) / ppb), dim3(ppb * wpp * 32), args, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}
