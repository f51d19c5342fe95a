// Kernel A's wide route, single-shot: anti-diagonals 1..tmax of every pair
// of a dispatch, one pair a thread-block cluster (or a chain of clusters),
// with the traceback (TB) or score-only, int32 or int16 (AR), and the
// snapshot mode (the traceback instantiations' span of two capturing
// steps, taken where the caller passes the snapshot's outputs): the
// launch, the kernels' query, the chain floor's probe, and the kernels of
// the keyed int32 arithmetic (those of plain compares and of the int16
// mode are nw_sweep_wide_plain.cu's and nw_sweep_wide_i16.cu's, built in
// parallel).  The device code and the design note are in nw_sweep_wide.cuh;
// the segment mode is nw_sweep_wide_seg.cu.  The bound is the sweep's.

#include "nw_sweep_wide.cuh"

template <int S>
__global__ void __launch_bounds__(kWideMaxThreads) nw_sweep_wide_floor(const WideArgs a) {
  wide_floor_body<S, false>(a);
}

__global__ void __launch_bounds__(kWideMaxThreads) nw_sweep_wide_floor_solo(const WideArgs a) {
  wide_floor_body<1, true>(a);
}

// solo: the pair's one CTA at a lane a thread (the solo kernels); each
// arithmetic's kernels come from their own source
static const void* pick_wide(int lanes, bool two, bool tb, int ar, bool solo) {
  switch (ar) {
    case kKeyed: return wide_kernel_of<kKeyed>(lanes, two, tb, solo);
    case kPlain: return nw_sweep_wide_plain_kernel(lanes, two, tb, solo);
    case kKeyed16: return nw_sweep_wide_i16_kernel(lanes, two, tb, solo);
    default: return nullptr;
  }
}

// Anti-diagonals 1..tmax of pairs [b0, b0 + nb) of a dispatch of B on the
// wide route (the wrapper slices a chain's dispatch into launches whose
// clusters are all resident; every array is the dispatch's).  tb [B, tmax_pad, W]
// or null (score-only); scores [B] filled with -1 by the caller; recs
// [B, clusters, 2, 8] int32 zeroed where clusters > 1, else null; t_snap
// [B], snap [6, B, W], diaga and diagb [B, W] (filled with the DP's
// +infinity by the caller) or null; ar the cell's arithmetic (kPlain,
// kKeyed, or kKeyed16 for the int16 mode; nw_sweep_wide.cuh).  lanes S (4, 2,
// 1), ctas a pair in clusters of `cluster` (clusters a pair), threads and
// smem bytes a CTA, the rings' qring and tring bytes (ops/nw_cuda.py::
// wide_plan); solo: one CTA a pair at a lane a thread, on the solo kernels.
// Returns the CUDA error code.
extern "C" int nw_sweep_wide_launch(const void* Q, const void* T, const void* qlens, const void* tlens,
                                    void* scores, void* tb, void* recs, const void* t_snap, void* snap,
                                    void* diaga, void* diagb, int B, int Lq, int Lt, int W, int tmax,
                                    int tmax_pad, int mismatch, int o1, int e1, int o2, int e2, int ar,
                                    int lanes, int ctas, int cluster, int clusters, int threads, int smem,
                                    int qring, int tring, int b0, int nb, int solo, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (snap != nullptr && tb == nullptr) return (int)cudaErrorInvalidValue;
  if (cluster < 1 || ctas != cluster * clusters || (clusters > 1 && recs == nullptr) || (solo && ctas != 1))
    return (int)cudaErrorInvalidValue;
  const void* fn = pick_wide(lanes, o2 >= 0, tb != nullptr, ar, solo != 0);
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
  a.Lq = Lq;
  a.Lt = Lt;
  a.W = W;
  a.tmax = tmax;
  a.tmax_pad = tmax_pad;
  a.ctas = ctas;
  a.clusters = clusters;
  a.qring = qring;
  a.tring = tring;
  a.mismatch = mismatch;
  a.o1 = o1;
  a.e1 = e1;
  a.o2 = o2;
  a.e2 = e2;
  a.sn = SnapArgs{(const int*)t_snap, (int*)snap, (int*)diaga, (int*)diagb};
  return (int)launch_wide(fn, a, nb, 1, cluster, threads, smem, (cudaStream_t)stream);
}

// The chain floor's probe (nw_sweep_wide.cuh::wide_floor_body): `steps`
// steps of one pair at W lanes and the plan's lanes, CTAs, clusters,
// threads, shared memory and rings (solo: the solo kernels' step); recs
// [1, 1, clusters, 2, 8] int32 zeroed where clusters > 1, else null; out
// [1] int32 (written only to keep the chain's adds).  Returns the CUDA error code.
extern "C" int nw_sweep_wide_floor_launch(void* recs, void* out, int W, int steps, int lanes, int ctas,
                                          int cluster, int clusters, int threads, int smem, int qring,
                                          int tring, int solo, void* stream) {
  if (steps < 1 || W < 1 || cluster < 1 || ctas != cluster * clusters || (clusters > 1 && recs == nullptr) ||
      (solo && (ctas != 1 || lanes != 1)))
    return (int)cudaErrorInvalidValue;
  const void* fn = solo          ? (const void*)nw_sweep_wide_floor_solo
                   : lanes == 4 ? (const void*)nw_sweep_wide_floor<4>
                   : lanes == 2 ? (const void*)nw_sweep_wide_floor<2>
                   : lanes == 1 ? (const void*)nw_sweep_wide_floor<1>
                                : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  WideArgs a{};
  a.scores = (int*)out;
  a.recs = (int*)recs;
  a.B = 1;
  a.W = W;
  a.tmax = steps;
  a.ctas = ctas;
  a.clusters = clusters;
  a.qring = qring;
  a.tring = tring;
  return (int)launch_wide(fn, a, 1, 1, cluster, threads, smem, (cudaStream_t)stream);
}

// One kernel of the wide route (seg: the segment mode's; ar and solo as the
// launch's, kKeyed16 only single-shot): its registers and local (spilled) bytes a thread, its
// CTAs resident an SM at `threads` and `smem`, and the clusters of
// `cluster` such CTAs resident on the card at once
// (cudaOccupancyMaxActiveClusters).  Returns the CUDA error code.
extern "C" int nw_sweep_wide_query(int seg, int lanes, int two, int tb, int ar, int solo, int cluster,
                                   int threads, int smem, int* regs, int* local_bytes, int* ctas_per_sm,
                                   int* clusters) {
  const void* fn = seg ? nw_sweep_wide_seg_kernel(lanes, two != 0, tb != 0, ar, solo != 0)
                       : pick_wide(lanes, two != 0, tb != 0, ar, solo != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_cluster(fn, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn, threads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at;
  cluster_config(cfg, at, dim3(cluster), cluster, threads, smem, 0);
  *clusters = 0;
  return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
}
