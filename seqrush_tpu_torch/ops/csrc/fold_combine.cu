// The fold's combine: the join of the bidirectional fold's two half sweeps.
//
// Replaces the XLA code of seqrush_tpu/ops/nw.py::nw_align_fold (:1720-1806)
// between its snapshot sweep and its half-walks (the port's plain version is
// ops/nw_cuda.py::fold_combine_reference).  Pair b's forward row b stopped
// at anti-diagonal tm = ceil(fin / 2), its backward row B + b (the reversed
// sequences) at tmb = fin - tm, fin = qlen + tlen.  Every edge across the
// seam is priced from the snapshots: forward lane l meets backward lane
// sh - l (sh1 for the edges from anti-diagonal tm, sh2 for the diagonal edge
// from tm - 1), a backward lane outside [0, W) as INF.  Six terms a lane:
//   E2  Sf[H at tm - 1] + DIAGB        E3  Sf[H] + DIAGA
//   D1  min(Sf[H], Sf[D1] - o1) + D1b  I1  min(Sf[H], Sf[I1] - o1) + I1b
//   D2  min(Sf[H], Sf[D2] - o2) + D2b  I2  min(Sf[H], Sf[I2] - o2) + I2b
// (2 INF for D2 and I2 with one-piece penalties, o2 < 0).  Each term's best
// is its first minimum over the lanes, the pair's best the first minimum
// over the terms: the JAX package's tie order.  From the best term and lane
// come the score (0 for an empty pair, -1 where the best is not below INF),
// where each half-walk starts (anti-diagonal, lane, gap material, done) and
// whether an M joins the halves; unfinished and empty pairs get inert
// starts.  All of it is int32 arithmetic, so the result equals the plain
// version's bit for bit.
//
// What bounds it on an H100: bytes, 12 [B, W] int32 planes read once (the
// forward rows' six snapshot planes, the backward rows' four gap planes,
// DIAGA and DIAGB); its outputs are 7 words a pair.  The design: one block
// of 128 threads a pair, in one launch for the whole fold chunk (the plain
// version takes about 145 launches).  A thread takes lanes tid, tid + 128,
// ... and keeps each term's first minimum (value, lane) as it goes; the
// block reduces them, lowest value and then lowest lane, with shuffles and
// one pass through shared memory; thread 0 derives the starts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COMBINE_THREADS = 128;
constexpr int INF = 1 << 28;  // the DP's +infinity (ops/nw.py::INF)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int floor_div2(int a) { return a >= 0 ? a / 2 : -((1 - a) / 2); }

// Band anchor: first query index on anti-diagonal t (ops/nw.py::_i0_of).
__device__ __forceinline__ int i0_of(int t, int K) {
  const int v = floor_div2(t - K + 1);
  return v > 0 ? v : 0;
}

// (value, lane) pairs: the lower value, then the lower lane.
__device__ __forceinline__ void take_min(int& v, int& l, int v2, int l2) {
  if (v2 < v || (v2 == v && l2 < l)) {
    v = v2;
    l = l2;
  }
}

}  // namespace

__global__ void __launch_bounds__(COMBINE_THREADS)
fold_combine_kernel(const int* __restrict__ SNAP, const int* __restrict__ DIAGA,
                    const int* __restrict__ DIAGB, const int* __restrict__ qlens,
                    const int* __restrict__ tlens, int* __restrict__ scores, int* __restrict__ state,
                    uint8_t* __restrict__ cross_m, int B, int W, int K, int o1, int o2) {
  __shared__ int sv[6][COMBINE_THREADS / 32];
  __shared__ int sl[6][COMBINE_THREADS / 32];
  const int b = blockIdx.x;
  const int ql = qlens[b];
  const int fin = ql + tlens[b];
  const int tm = floor_div2(fin + 1);
  const int tmb = fin - tm;
  const int i0_tm = i0_of(tm, K), i0_tm1 = i0_of(tm - 1, K);
  const int i0_b = i0_of(tmb, K), i0_b1 = i0_of(tmb + 1, K);
  const int sh1 = ql - i0_tm - i0_b;
  const int sh2 = ql - i0_tm1 - i0_b1;
  const bool two = o2 >= 0;
  const size_t plane = (size_t)2 * B * W;
  // Sf[c] is channel c of forward row b; the backward row is B + b
  const int* Sf = SNAP + (size_t)b * W;
  const int* Gb = SNAP + (size_t)(B + b) * W;
  const int* DA = DIAGA + (size_t)(B + b) * W;
  const int* DB = DIAGB + (size_t)(B + b) * W;

  int bv[6], bl[6];
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    bv[t] = 0x7fffffff;
    bl[t] = W;
  }
  for (int l = threadIdx.x; l < W; l += COMBINE_THREADS) {
    const int lb1 = sh1 - l, lb2 = sh2 - l;
    const bool in1 = lb1 >= 0 && lb1 < W, in2 = lb2 >= 0 && lb2 < W;
    const int I1b = in1 ? Gb[2 * plane + lb1] : INF;
    const int D1b = in1 ? Gb[3 * plane + lb1] : INF;
    const int I2b = in1 ? Gb[4 * plane + lb1] : INF;
    const int D2b = in1 ? Gb[5 * plane + lb1] : INF;
    const int DAb = in1 ? DA[lb1] : INF;
    const int DBb = in2 ? DB[lb2] : INF;
    const int h = Sf[l];
    int tv[6];
    tv[0] = Sf[plane + l] + DBb;
    tv[1] = h + DAb;
    tv[2] = min(h, Sf[3 * plane + l] - o1) + D1b;
    tv[3] = min(h, Sf[2 * plane + l] - o1) + I1b;
    tv[4] = two ? min(h, Sf[5 * plane + l] - o2) + D2b : 2 * INF;
    tv[5] = two ? min(h, Sf[4 * plane + l] - o2) + I2b : 2 * INF;
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      if (tv[t] < bv[t]) {  // lanes rise, so the first minimum stays
        bv[t] = tv[t];
        bl[t] = l;
      }
    }
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    for (int o = 16; o > 0; o >>= 1) {
      const int v2 = __shfl_down_sync(FULL, bv[t], o), l2 = __shfl_down_sync(FULL, bl[t], o);
      take_min(bv[t], bl[t], v2, l2);
    }
    if (lane == 0) {
      sv[t][wid] = bv[t];
      sl[t][wid] = bl[t];
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int vb[6], lbst[6];
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    vb[t] = sv[t][0];
    lbst[t] = sl[t][0];
    for (int k = 1; k < COMBINE_THREADS / 32; ++k) take_min(vb[t], lbst[t], sv[t][k], sl[t][k]);
  }
  int term = 0, total = vb[0], ln = lbst[0];
#pragma unroll
  for (int t = 1; t < 6; ++t) {
    if (vb[t] < total) {
      total = vb[t];
      term = t;
      ln = lbst[t];
    }
  }
  const bool finished = total < INF;
  scores[b] = fin == 0 ? 0 : (finished ? total : -1);

  // the start of each half-walk (nw.py's gap materials: 1 D1, 2 I1, 3 D2, 4 I2)
  const int h_u = Sf[ln];
  const bool is_e1 = term >= 2;
  const int g_idx = min(max(term - 2, 0), 3);
  const int g_code = g_idx + 1;
  // the gap value at the lane: D1, I1, D2, I2 in g_idx order
  const int g_val = g_idx == 0   ? Sf[3 * plane + ln] - o1
                    : g_idx == 1 ? Sf[2 * plane + ln] - o1
                    : g_idx == 2 ? Sf[5 * plane + ln] - o2
                                 : Sf[4 * plane + ln] - o2;
  const bool e2 = term == 0;
  const int fwd_mat = is_e1 && g_val < h_u ? g_code : 0;
  int fwd_t0 = e2 ? tm - 1 : tm;
  const int ip_u = ql - ((e2 ? i0_tm1 : i0_tm) + ln);
  int bwd_t0 = is_e1 ? tmb : (e2 ? tmb - 1 : tmb - 2);
  const int bwd_l0 = is_e1 ? ip_u - i0_b : (ip_u - 1) - i0_of(max(bwd_t0, 0), K);
  const int bwd_mat = is_e1 ? g_code : 0;
  const bool live = finished && fin > 0;
  cross_m[b] = !is_e1 && live;
  fwd_t0 = live ? fwd_t0 : 0;
  bwd_t0 = live ? max(bwd_t0, 0) : 0;
  const int n2 = 2 * B;
  state[b] = fwd_t0;
  state[B + b] = bwd_t0;
  state[n2 + b] = min(max(ln, 0), W - 1);
  state[n2 + B + b] = min(max(bwd_l0, 0), W - 1);
  state[2 * n2 + b] = fwd_mat;
  state[2 * n2 + B + b] = bwd_mat;
  state[3 * n2 + b] = fwd_t0 <= 0;
  state[3 * n2 + B + b] = bwd_t0 <= 0;
}

// The combine of B pairs: SNAP [6, 2B, W], DIAGA, DIAGB [2B, W], qlens,
// tlens [B] int32 in; scores [B] int32, state [4, 2B] int32 and cross_m [B]
// bool out, one block a pair.  Returns the CUDA error code.
extern "C" int fold_combine_launch(const void* SNAP, const void* DIAGA, const void* DIAGB,
                                   const void* qlens, const void* tlens, void* scores, void* state,
                                   void* cross_m, int B, int W, int o1, int o2, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (W < 1) return (int)cudaErrorInvalidValue;
  fold_combine_kernel<<<B, COMBINE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)SNAP, (const int*)DIAGA, (const int*)DIAGB, (const int*)qlens,
      (const int*)tlens, (int*)scores, (int*)state, (uint8_t*)cross_m, B, W, W - 1, o1, o2);
  return (int)cudaGetLastError();
}
