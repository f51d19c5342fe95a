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

template <int S, bool TWO, bool TB>
static cudaError_t launch_regs_seg(const void* Q, const void* T, const void* qlens,
                                   const void* tlens, void* scores, void* tb, int B, int Lq, int Lt,
                                   int W, Pen p, int wpp, int ppb, int pair_bytes, SegArgs sa,
                                   int groups, cudaStream_t stream) {
  const int threads = ppb * wpp * 32;
  const size_t smem = dynamic_smem(ppb, pair_bytes);
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
// y * n_run * seg on.  The register route's lanes S (4, 8, 12, 16), wpp
// warps a pair, ppb pairs a block of pair_bytes each; the wide route is
// nw_sweep_wide_seg.cu's.  Returns the CUDA error code.
extern "C" int nw_sweep_segment_launch(const void* Q, const void* T, const void* qlens,
                                       const void* tlens, const void* ckpt_in, void* ckpt_out,
                                       const void* scores_in, void* scores, void* tb, int B,
                                       int Lq, int Lt, int W, int t_lo, int seg, int n_run,
                                       int n_out, int groups, int tb_rows, int mismatch, int o1,
                                       int e1, int o2, int e2, int lanes, int wpp, int ppb,
                                       int pair_bytes, void* stream) {
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
