// Kernel A's wide route, segment mode: runs of segments of seg
// anti-diagonals from a carry of the six DP rows, one run a grid row, each
// pair on a thread-block cluster (or a chain of clusters), for the long-pair
// route at bands above REG_MAX_W or penalties outside [0, 2^16)
// (ops/nw_cuda.py::nw_align_long; replaces seqrush_tpu/ops/nw.py::
// _nw_segment there).  The device code and the design note are in
// nw_sweep_wide.cuh.

#include "nw_sweep_wide.cuh"

template <int S, bool TWO, bool TB, int AR>
__global__ void __launch_bounds__(kWideMaxThreads) nw_sweep_wide_seg(const WideArgs a) {
  wide_body<S, TWO, TB, AR, true, false>(a);
}

// a pair on one CTA, a lane a thread (the narrow bands' plan)
template <bool TWO, bool TB, int AR>
__global__ void __launch_bounds__(kWideMaxThreads) nw_sweep_wide_seg_solo(const WideArgs a) {
  wide_body<1, TWO, TB, AR, true, true>(a);
}

template <bool TWO, bool TB, int AR>
static const void* seg_kernel(int lanes) {
  switch (lanes) {
    case 4: return (const void*)nw_sweep_wide_seg<4, TWO, TB, AR>;
    case 2: return (const void*)nw_sweep_wide_seg<2, TWO, TB, AR>;
    case 1: return (const void*)nw_sweep_wide_seg<1, TWO, TB, AR>;
    default: return nullptr;
  }
}

template <bool TWO, bool TB>
static const void* seg_kernel_ar(int lanes, int ar) {
  if (ar == kKeyed) return seg_kernel<TWO, TB, kKeyed>(lanes);
  return ar == kPlain ? seg_kernel<TWO, TB, kPlain>(lanes) : nullptr;
}

template <bool TWO, bool TB>
static const void* seg_solo_kernel(int ar) {
  if (ar == kKeyed) return (const void*)nw_sweep_wide_seg_solo<TWO, TB, kKeyed>;
  return ar == kPlain ? (const void*)nw_sweep_wide_seg_solo<TWO, TB, kPlain> : nullptr;
}

const void* nw_sweep_wide_seg_kernel(int lanes, bool two, bool tb, int ar, bool solo) {
  if (solo) {
    if (lanes != 1) return nullptr;
    if (two) return tb ? seg_solo_kernel<true, true>(ar) : seg_solo_kernel<true, false>(ar);
    return tb ? seg_solo_kernel<false, true>(ar) : seg_solo_kernel<false, false>(ar);
  }
  if (two) return tb ? seg_kernel_ar<true, true>(lanes, ar) : seg_kernel_ar<true, false>(lanes, ar);
  return tb ? seg_kernel_ar<false, true>(lanes, ar) : seg_kernel_ar<false, false>(lanes, ar);
}

// Runs of n_run segments of seg anti-diagonals on the wide route, one a
// grid row, `groups` rows, of which the launch takes pairs [b0, b0 + nb)
// of rows [y0, y0 + ny) (the wrapper slices a chain's dispatch into
// launches whose clusters are all resident): grid row y sweeps anti-diagonals t_lo + y *
// n_run * seg on from the carry ckpt_in + y * n_run carries on (each [6, B,
// W] int32, 6 * B * W ints apart), and stores the carry after its k-th
// segment (k < n_out) at ckpt_out + (y * n_run + k) carries; ckpt_out may
// be null (then n_out is 0).  scores [B] int32: filled by the caller (the
// scores before the run, or -1); a pair's score is set in the segment of
// its final cell where it is below 0.  tb [B, tb_rows, W] uint8 or null
// (score-only): grid row y's rows from row y * n_run * seg on.  recs
// [groups, B, clusters, 2, 8] int32 zeroed where clusters > 1, else null.
// ar the cell's arithmetic (kPlain or kKeyed; nw_sweep_wide.cuh).  The
// plan's arguments and solo as nw_sweep_wide_launch's.  Returns the CUDA error
// code.
extern "C" int nw_sweep_wide_seg_launch(const void* Q, const void* T, const void* qlens, const void* tlens,
                                        const void* ckpt_in, void* ckpt_out, void* scores, void* tb, void* recs,
                                        int B, int Lq, int Lt, int W, int t_lo, int seg, int n_run, int n_out,
                                        int groups, int tb_rows, int mismatch, int o1, int e1, int o2, int e2,
                                        int ar, int lanes, int ctas, int cluster, int clusters, int threads, int smem,
                                        int qring, int tring, int b0, int nb, int y0, int ny, int solo,
                                        void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (t_lo < 1 || seg < 1 || n_run < 1 || groups < 1 || groups > 65535 || n_out < 0 || n_out > n_run ||
      (tb && tb_rows < groups * n_run * seg) || y0 + ny > groups || cluster < 1 || ctas != cluster * clusters ||
      (clusters > 1 && recs == nullptr) || (solo && ctas != 1))
    return (int)cudaErrorInvalidValue;
  const void* fn = nw_sweep_wide_seg_kernel(lanes, o2 >= 0, tb != nullptr, ar, solo != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  WideArgs a{};
  a.Q = (const uint8_t*)Q;
  a.T = (const uint8_t*)T;
  a.qlens = (const int*)qlens;
  a.tlens = (const int*)tlens;
  a.scores = (int*)scores;
  a.tb = (uint8_t*)tb;
  a.recs = (int*)recs;
  a.B = B;
  a.b0 = b0;
  a.y0 = y0;
  a.Lq = Lq;
  a.Lt = Lt;
  a.W = W;
  a.ctas = ctas;
  a.clusters = clusters;
  a.qring = qring;
  a.tring = tring;
  a.mismatch = mismatch;
  a.o1 = o1;
  a.e1 = e1;
  a.o2 = o2;
  a.e2 = e2;
  a.sa = SegArgs{(const int*)ckpt_in, (int*)ckpt_out, nullptr, t_lo, seg, n_run, ckpt_out ? n_out : 0, tb_rows,
                 (size_t)6 * B * W};
  return (int)launch_wide(fn, a, nb, ny, cluster, threads, smem, (cudaStream_t)stream);
}
