// Kernel A, tiled mode: one launch over a chunk that mixes narrow pairs at
// band K and wide pairs at K_w = n_tiles * (K + 1) - 1, each pair swept
// exactly as the untiled kernel sweeps it at its own band, the traceback
// written straight into the tile-row layout.
//
// Replaces the XLA program seqrush_tpu/ops/nw.py::_sweep_tiled (fused into
// nw_align_with_runs_tiled).  There a wide pair is n_tiles batch rows of the
// narrow width W = K + 1, coupled by one boundary lane per anti-diagonal that
// a roll along the batch axis injects: a layout forced by a sweep whose lanes
// are one vector per batch row.  On this card the coupling of a pair's lanes
// is what the register route already does between the warps of one pair
// (strip edges by warp shuffles, warp edges through shared memory with one
// named barrier a step), so the Hopper design is kernel A with a per-pair
// band in one launch:
//   * a block holds n_tiles * wpp warps: the first n_wide blocks one wide
//     pair each (W_w = n_tiles * W lanes over all the warps), the others
//     n_tiles narrow pairs of wpp warps each.  Both kinds run the same lanes
//     per thread, so a wide pair rides the narrow launch instead of leaving
//     SMs idle in a launch of its own;
//   * each pair has its own K, i0(t) = max((t - K + 1) / 2, 0), window
//     schedule and phase loop, from the register route's device code
//     (nw_sweep.cuh: sweep_step, slide_windows, exchange with a block's four
//     pair barriers);
//   * one step for both kinds of pair, as lean as kernel A's: a thread's
//     strip lies in one tile row, so it stores into that row at a column
//     fixed per thread (the tile row's base and column set once); only
//     where W is not a multiple of the strip (SPLIT instantiations) can a
//     wide pair's strip cross a tile row's end, and that strip stores byte
//     by byte.  A warp whose every lane is on the matrix skips the lanes'
//     validity test.  The integer pipes and the step's latency chain bound
//     the sweep (a warp alone takes ~1,700 SM cycles a step); a wide pair
//     rides the narrow launch, its six warps at one barrier a step;
//   * a pair ends at min(tmax, t_final + 2): the rows past it, which hold
//     constants that no walk reads (the tiled walk starts at t_final), are
//     left unwritten, as are tmax_pad's padding rows; a zero-length padding
//     row sweeps two anti-diagonals;
//   * lane l of a wide pair's anti-diagonal t is written to row first + l / W,
//     lane l % W: tb [B, tmax_pad, W] is the narrow chunk's layout with the
//     wide pairs' extra rows, the footprint the planner charges.
// Every pair's score and bytes up to its end equal the untiled kernel's at
// its band, so tb equals the plain version (ops/nw_cuda.py::
// nw_align_tiled_reference) on every row nw_cuda.tiled_promised_rows names.
// A wide pair's score lands on its first row, -1 on the others.
// The wide route (n_tiles * W > REG_MAX_W, or penalties the register route
// does not take) is kernel A's wide route with a per-block pair and width:
// one block a pair, the DP rows in shared memory or a global scratch, one
// block barrier per anti-diagonal, every row written; I16 its int16 mode.

#include "nw_sweep.cuh"

// The register route's own timer (TIMED, a timing tool's launch; every
// other launch runs the untimed instantiation): lane 0 of each warp writes
// TILED_TIMER_SLOTS values at timer[(block * warps + warp) * slots]: the
// %globaltimer nanoseconds at entry, after the staging barrier and at the
// end of the recurrence (its exit); the SM cycles of the recurrence; %smid;
// the pair's first row (-1 for a slot with no pair); the anti-diagonals of
// the recurrence.
#define TILED_TIMER_SLOTS 7

__device__ __forceinline__ unsigned long long tiled_global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned tiled_smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}

// A strip that crosses a tile row's end (W not a multiple of S): its S bytes
// of traceback row t byte by byte, lane l at tile row l / tw, lane l % tw.
template <int S>
__device__ __forceinline__ void store_split(const Pair& pr, int t, const uint32_t (&words)[(S + 3) / 4]) {
  uint8_t* base = pr.tbb - pr.trow;  // the pair's first tile row
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int l = pr.s0 + k;
    if (l < pr.W) {
      const int tile = l / pr.tw;
      base[tile * pr.tstride + (size_t)t * pr.tw + (l - tile * pr.tw)] = (uint8_t)(words[k >> 2] >> (8 * (k & 3)));
    }
  }
}

// The recurrence of anti-diagonal t over the thread's lanes, valid lanes
// [lo, hi] of the pair: a warp whose every lane is valid takes the step
// without the lanes' validity test.
template <int S, bool TWO, int DP, int DPP>
__device__ __forceinline__ void tiled_recurrence(Strip<S>& s, const Edges& e, const Pair& pr, const Pen& p,
                                                 int lo, int hi, uint32_t (&words)[(S + 3) / 4]) {
  const int w0 = pr.wip * 32 * S;
  if (lo <= w0 && hi >= w0 + 32 * S - 1) {
    sweep_step<S, TWO, DP, DPP, true>(s, e, p, 0, 0u, words);
    return;
  }
  int vlo = lo - pr.s0;
  uint32_t vspan = (uint32_t)(hi - lo);
  if (hi < lo) {
    vlo = -(1 << 30);
    vspan = 0;
  }
  sweep_step<S, TWO, DP, DPP>(s, e, p, vlo, vspan, words);
}

// Anti-diagonal t (>= 1) of one warp of a pair, wide or narrow alike: slide
// the windows, step, store the thread's bytes into its tile row (SPLIT: byte
// by byte where its strip crosses one's end), take the score at t_final,
// exchange the edges.
template <int S, bool TWO, int DP, int DPP, bool SPLIT>
__device__ __forceinline__ void tiled_step(Strip<S>& s, Edges& e, const Pair& pr, const Pen& p, int t,
                                           int& qs, int& ts) {
  if (t > 1) slide_windows<S, false>(s, pr, t, qs, ts);
  const int i0 = i0_of(t, pr.K);
  // valid lanes: t - tlen - i0 <= l <= min(qlen, t) - i0, and l < W
  const int lo = t - pr.tlen - i0;
  const int hi = min(min(pr.qlen, t) - i0, pr.W - 1);
  uint32_t words[(S + 3) / 4];
  tiled_recurrence<S, TWO, DP, DPP>(s, e, pr, p, lo, hi, words);
  if (SPLIT && pr.split)
    store_split<S>(pr, t, words);
  else
    store_row<S>(pr.tbb + (size_t)t * pr.tw, pr.tc0, pr.tw, pr.walign, words);
  if (t == pr.t_final) {
    const int fl = pr.qlen - i0 - pr.s0;
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (k == fl && pr.s0 + k < pr.W && s.h1[k] < NW_INF) *pr.score = s.h1[k];
  }
  exchange<S, TWO, 4>(s, e, pr, t & 1);
}

// The register route: a block of n_tiles * wpp_n warps holds one wide pair
// (the first n_wide blocks) or n_tiles narrow pairs.  Each pair is swept to
// min(tmax, t_final + 2) and no further: rows 0 .. that end of each of its
// tile rows are written, the rows past it (constants no walk reads: the
// tiled walk starts at t_final) and tmax_pad's padding are left unwritten.
// SPLIT: W is not a multiple of S, so a wide pair's strip can cross a tile
// row's end.
template <int S, bool TWO, bool TIMED, bool SPLIT>
__global__ void __launch_bounds__(S <= 4 ? 128 : S <= 8 ? 384 : 256, S == 4 ? 5 : 1)
nw_sweep_tiled_regs(const uint8_t* __restrict__ Q,  // [B, Lq] query codes, QPAD-padded
                    const uint8_t* __restrict__ T,  // [B, Lt] target codes, TPAD-padded
                    const int* __restrict__ qlens, const int* __restrict__ tlens,
                    int* __restrict__ scores,        // [B] out
                    uint8_t* __restrict__ tb,        // [B, tmax_pad, W] out, tile rows
                    const int* __restrict__ order,   // [n_pairs] first rows: wide, then narrow
                    int n_pairs, int n_wide, int R, int Lq, int Lt, int W, int tmax, int tmax_pad,
                    Pen p, int wpp_n, int pair_bytes, unsigned long long* timer) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned long long* tm = nullptr;
  if (TIMED) {
    tm = timer + ((size_t)blockIdx.x * (blockDim.x >> 5) + warp) * TILED_TIMER_SLOTS;
    if (lane == 0) tm[0] = tiled_global_ns();
  }
  const bool wide = (int)blockIdx.x < n_wide;
  const int wpp = wide ? R * wpp_n : wpp_n;
  const int pib = wide ? 0 : warp / wpp_n;  // pair in block
  const int wip = warp - pib * wpp;          // warp in pair
  const int slot = wide ? blockIdx.x : n_wide + (blockIdx.x - n_wide) * R + pib;
  const int b = slot < n_pairs ? order[slot] : -1;  // the pair's first row
  const int Wp = wide ? R * W : W;                  // the pair's lanes
  const int tpp = wpp * 32;
  const int r = wip * 32 + lane;
  const int L = S * tpp;  // lanes covered, >= Wp

  uint8_t* Qs = smem + (size_t)pib * pair_bytes;
  uint8_t* Ts = Qs + pair_q_bytes(Lq, L);
  if (b >= 0) {
    const uint8_t* q = Q + (size_t)b * Lq;
    const uint8_t* tg = T + (size_t)b * Lt;
    for (int x = r; x < Lq + 1 + L; x += tpp) Qs[x] = (x >= 1 && x <= Lq) ? q[x - 1] : NW_QPAD;
    for (int y = r; y < Lt + Wp + L; y += tpp)
      Ts[y] = (y >= Wp && y < Wp + Lt) ? tg[Lt - 1 - (y - Wp)] : NW_TPAD;
    if (r == 0) {
      scores[b] = (p.i16 && qlens[b] + tlens[b] == 0) ? 0 : -1;
      for (int k = 1; k < (wide ? R : 1); ++k) scores[b + k] = -1;
    }
  }
  __syncthreads();
  if (TIMED && lane == 0) {
    tm[1] = tiled_global_ns();
    tm[4] = tiled_smid();
    tm[5] = (unsigned long long)(long long)b;
  }
  if (b < 0) return;

  Pair pr;
  pr.Qs = Qs;
  pr.Ts = Ts;
  pr.score = scores + b;
  pr.slots = reinterpret_cast<int*>(Ts + pair_t_bytes(Lt, Wp, L));
  pr.s0 = r * S;
  pr.K = Wp - 1;
  pr.W = Wp;
  pr.Lq = Lq;
  pr.Lt = Lt;
  pr.qlen = qlens[b];
  pr.tlen = tlens[b];
  pr.t_final = pr.qlen + pr.tlen;
  pr.walign = (W & 15) == 0 ? 16 : (W & 7) == 0 ? 8 : (W & 3) == 0 ? 4 : 1;
  pr.lane = lane;
  pr.wip = wip;
  pr.wpp = wpp;
  pr.pib = pib;
  pr.neg = p.neg;
  // the strip's tile row and its first lane there (W for lanes past the
  // pair's, which store nothing)
  pr.tw = W;
  pr.tstride = (size_t)tmax_pad * W;
  {
    const int tile = pr.s0 < Wp ? pr.s0 / W : 0;
    pr.tc0 = pr.s0 < Wp ? pr.s0 - tile * W : W;
    pr.trow = (size_t)tile * pr.tstride;
    pr.split = SPLIT && pr.s0 < Wp && pr.s0 + S > (tile + 1) * W && (tile + 1) * W < Wp;
  }
  pr.tbb = tb + (size_t)b * pr.tstride + pr.trow;
  const int K = pr.K;
  constexpr int NWORD = (S + 3) / 4;

  // traceback row 0 is zero
  uint32_t zero[NWORD];
#pragma unroll
  for (int w = 0; w < NWORD; ++w) zero[w] = 0;
  if (SPLIT && pr.split)
    store_split<S>(pr, 0, zero);
  else
    store_row<S>(pr.tbb, pr.tc0, W, pr.walign, zero);

  // state at t = 0 (H row 0 is 0 at lane 0) and t = -1
  Strip<S> s;
  Edges e;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    s.h1[k] = (pr.s0 + k == 0) ? 0 : p.neg;
    s.h2[k] = p.neg;
    s.i1[k] = s.d1[k] = s.i2[k] = s.d2[k] = p.neg;
  }
  e.hl1 = p.neg;
  exchange<S, TWO, 4>(s, e, pr, 0);
  e.hl2 = p.neg;  // H(-1)

  int qs = min(i0_of(1, K), Lq + 1);
  int ts = max(0, min(Lt - 1 + i0_of(1, K) + Wp, Lt + Wp));
  load_windows<S, false>(s, pr, qs, ts);

  // the phases of the pair's own band, as in sweep_regs_body
  const int last = min(tmax, pr.t_final + 2);
  long long c0 = 0;
  if (TIMED) c0 = clock64();
  int t = 1;
  for (; t <= last && t <= K; ++t) tiled_step<S, TWO, 0, 0, SPLIT>(s, e, pr, p, t, qs, ts);
  for (; t + 1 <= last; t += 2) {  // (t - K) is odd here
    tiled_step<S, TWO, 1, 1, SPLIT>(s, e, pr, p, t, qs, ts);
    tiled_step<S, TWO, 0, 1, SPLIT>(s, e, pr, p, t + 1, qs, ts);
  }
  if (t <= last) tiled_step<S, TWO, 1, 1, SPLIT>(s, e, pr, p, t++, qs, ts);
  if (TIMED && lane == 0) {
    tm[2] = tiled_global_ns();
    tm[3] = (unsigned long long)(clock64() - c0);
    tm[6] = (unsigned long long)max(last, 0);
  }
}

// Wide route, tiled: kernel A's wide route (nw_sweep.cu) with the pair and
// its width per block and the traceback in tile rows.
template <bool I16>
__global__ void __launch_bounds__(1024) nw_sweep_tiled_wide(
    const uint8_t* __restrict__ Q, const uint8_t* __restrict__ T,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    int* __restrict__ scores,          // [B] out
    uint8_t* __restrict__ tb,          // [B, tmax_pad, W] out, tile rows
    const int* __restrict__ order,     // [n_pairs] first rows: wide, then narrow
    int* __restrict__ gscratch,        // [n_pairs, 11, R * W] or null (shared memory)
    int n_wide, int R, int Lq, int Lt, int W, int tmax, int tmax_pad,
    int mismatch, int o1, int e1, int o2, int e2) {
  extern __shared__ int rows_smem[];
  const bool wide = (int)blockIdx.x < n_wide;
  const int b = order[blockIdx.x];
  const int Wp = wide ? R * W : W;
  int* rows = gscratch ? gscratch + (size_t)blockIdx.x * NW_ROWS * R * W : rows_smem;
  int* H[3] = {rows, rows + Wp, rows + 2 * Wp};
  int* I1[2] = {rows + 3 * Wp, rows + 4 * Wp};
  int* D1[2] = {rows + 5 * Wp, rows + 6 * Wp};
  int* I2[2] = {rows + 7 * Wp, rows + 8 * Wp};
  int* D2[2] = {rows + 9 * Wp, rows + 10 * Wp};

  const int K = Wp - 1;
  const bool two = o2 >= 0;
  const int qlen = qlens[b];
  const int tlen = tlens[b];
  const int t_final = qlen + tlen;
  const uint8_t* q = Q + (size_t)b * Lq;
  const uint8_t* tg = T + (size_t)b * Lt;
  uint8_t* tbb = tb + (size_t)b * tmax_pad * W;
  const size_t tstride = (size_t)tmax_pad * W;
  const int neg = I16 ? NW_INF16 : NW_INF;
  const int mis = I16 ? (int)(int16_t)mismatch : mismatch;

  for (int l = threadIdx.x; l < Wp; l += blockDim.x) {
    H[0][l] = l == 0 ? 0 : neg;
    H[2][l] = neg;
    I1[0][l] = neg;
    D1[0][l] = neg;
    I2[0][l] = neg;
    D2[0][l] = neg;
    uint8_t* col = tbb + (l / W) * tstride + l % W;
    col[0] = 0;
    for (int t = tmax + 1; t < tmax_pad; ++t) col[(size_t)t * W] = 0;
  }
  if (threadIdx.x == 0) {
    scores[b] = (I16 && t_final == 0) ? 0 : -1;
    for (int k = 1; k < (wide ? R : 1); ++k) scores[b + k] = -1;
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
    const int qs = min(i0, Lq + 1);
    const int ts = max(0, min(Lt - t + i0 + Wp, Lt + Wp));

    for (int l = threadIdx.x; l < Wp; l += blockDim.x) {
      const int h_up = framed(h1, l, dp - 1, Wp, neg);
      const int h_left = framed(h1, l, dp, Wp, neg);
      const int h_diag = framed(h2, l, dpp - 1, Wp, neg);
      const int i1_up = framed(I1[rs], l, dp - 1, Wp, neg);
      const int d1_left = framed(D1[rs], l, dp, Wp, neg);

      const int x = qs + l;
      const int qc = (x >= 1 && x <= Lq) ? (int)q[x - 1] : NW_QPAD;
      const int y = ts + l;
      const int tc = (y >= Wp && y < Wp + Lt) ? (int)tg[Lt - 1 - (y - Wp)] : NW_TPAD;
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
        const int i2_up = framed(I2[rs], l, dp - 1, Wp, neg);
        const int d2_left = framed(D2[rs], l, dp, Wp, neg);
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
      tbb[(l / W) * tstride + (size_t)t * W + l % W] =
          (uint8_t)(choice | ((int)i1o << 3) | ((int)i2o << 4) | ((int)d1o << 5) | ((int)d2o << 6));
    }
    __syncthreads();
  }
}

template <int S, bool TWO, bool TIMED, bool SPLIT>
static cudaError_t launch_tiled_regs_t(const void* Q, const void* T, const void* qlens,
                                       const void* tlens, void* scores, void* tb, const void* order,
                                       int n_pairs, int n_wide, int R, int Lq, int Lt, int W, int tmax,
                                       int tmax_pad, Pen p, int wpp, int pair_bytes, int threads,
                                       size_t smem, void* timer, cudaStream_t stream) {
  const void* fn = (const void*)nw_sweep_tiled_regs<S, TWO, TIMED, SPLIT>;
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  const int blocks = n_wide + (n_pairs - n_wide + R - 1) / R;
  nw_sweep_tiled_regs<S, TWO, TIMED, SPLIT><<<blocks, threads, smem, stream>>>(
      (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens, (int*)scores,
      (uint8_t*)tb, (const int*)order, n_pairs, n_wide, R, Lq, Lt, W, tmax, tmax_pad, p, wpp,
      pair_bytes, (unsigned long long*)timer);
  return cudaGetLastError();
}

// The timed instantiation exists for W a multiple of S (no strip crosses a
// tile row's end) only.
template <int S, bool TWO>
static cudaError_t launch_tiled_regs(const void* Q, const void* T, const void* qlens,
                                     const void* tlens, void* scores, void* tb, const void* order,
                                     int n_pairs, int n_wide, int R, int Lq, int Lt, int W, int tmax,
                                     int tmax_pad, Pen p, int wpp, int pair_bytes, int threads,
                                     size_t smem, void* timer, cudaStream_t stream) {
  if (W % S != 0) {
    if (timer) return cudaErrorInvalidValue;
    return launch_tiled_regs_t<S, TWO, false, true>(Q, T, qlens, tlens, scores, tb, order, n_pairs, n_wide,
                                                    R, Lq, Lt, W, tmax, tmax_pad, p, wpp, pair_bytes,
                                                    threads, smem, nullptr, stream);
  }
  return timer ? launch_tiled_regs_t<S, TWO, true, false>(Q, T, qlens, tlens, scores, tb, order, n_pairs,
                                                          n_wide, R, Lq, Lt, W, tmax, tmax_pad, p, wpp,
                                                          pair_bytes, threads, smem, timer, stream)
               : launch_tiled_regs_t<S, TWO, false, false>(Q, T, qlens, tlens, scores, tb, order, n_pairs,
                                                           n_wide, R, Lq, Lt, W, tmax, tmax_pad, p, wpp,
                                                           pair_bytes, threads, smem, nullptr, stream);
}

template <bool I16>
static cudaError_t launch_tiled_wide(const void* Q, const void* T, const void* qlens,
                                     const void* tlens, void* scores, void* tb, const void* order,
                                     void* scratch, int n_pairs, int n_wide, int R, int Lq, int Lt,
                                     int W, int tmax, int tmax_pad, int mismatch, int o1, int e1,
                                     int o2, int e2, int threads, size_t smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem((const void*)nw_sweep_tiled_wide<I16>, smem);
  if (err != cudaSuccess) return err;
  nw_sweep_tiled_wide<I16><<<n_pairs, threads, smem, stream>>>(
      (const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens, (int*)scores,
      (uint8_t*)tb, (const int*)order, (int*)scratch, n_wide, R, Lq, Lt, W, tmax, tmax_pad,
      mismatch, o1, e1, o2, e2);
  return cudaGetLastError();
}

// order: [n_pairs] int32 first rows, the n_wide wide pairs first (each takes
// rows first .. first + R - 1), then the narrow ones.  lanes: S of the
// register route (blocks of `threads` = R * wpp * 32 threads, a narrow
// pair's shared memory pair_bytes, the block's smem_bytes), or 0 for the
// wide route (a block of `threads` a pair; its rows in smem_bytes of shared
// memory, or in scratch, [n_pairs, 11, R * W] int32, where smem_bytes is 0).
// int16 selects the int16 mode; timer, where not null, the register route's
// timed instantiation (TILED_TIMER_SLOTS uint64 a warp of the launch).
// Returns the CUDA error code.
extern "C" int nw_sweep_tiled_launch(const void* Q, const void* T, const void* qlens,
                                     const void* tlens, void* scores, void* tb, const void* order,
                                     void* scratch, int n_pairs, int n_wide, int R, int Lq, int Lt,
                                     int W, int tmax, int tmax_pad, int mismatch, int o1, int e1,
                                     int o2, int e2, int int16, int lanes, int wpp, int pair_bytes,
                                     int threads, int smem_bytes, void* timer, void* stream) {
  if (n_pairs <= 0) return (int)cudaSuccess;
  if (R < 2 || n_wide < 0 || n_wide > n_pairs) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
  if (lanes == 0) {
    if ((smem == 0 && scratch == nullptr) || timer != nullptr) return (int)cudaErrorInvalidValue;
    return (int)(int16 ? launch_tiled_wide<true>(Q, T, qlens, tlens, scores, tb, order, scratch,
                                                 n_pairs, n_wide, R, Lq, Lt, W, tmax, tmax_pad,
                                                 mismatch, o1, e1, o2, e2, threads, smem, st)
                       : launch_tiled_wide<false>(Q, T, qlens, tlens, scores, tb, order, scratch,
                                                  n_pairs, n_wide, R, Lq, Lt, W, tmax, tmax_pad,
                                                  mismatch, o1, e1, o2, e2, threads, smem, st));
  }
  if (threads != R * wpp * 32) return (int)cudaErrorInvalidValue;
  Pen p{mismatch, o1 + e1, e1, o2 + e2, e2};
  p.neg = int16 ? NW_INF16 : NW_INF;
  p.i16 = int16 != 0;
  const bool two = o2 >= 0;
#define NW_TILED(SV)                                                                              \
  case SV:                                                                                        \
    return (int)(two ? launch_tiled_regs<SV, true>(Q, T, qlens, tlens, scores, tb, order, n_pairs, \
                                                   n_wide, R, Lq, Lt, W, tmax, tmax_pad, p, wpp,  \
                                                   pair_bytes, threads, smem, timer, st)          \
                     : launch_tiled_regs<SV, false>(Q, T, qlens, tlens, scores, tb, order,        \
                                                    n_pairs, n_wide, R, Lq, Lt, W, tmax,          \
                                                    tmax_pad, p, wpp, pair_bytes, threads, smem,  \
                                                    timer, st));
  switch (lanes) {
    NW_TILED(4)
    NW_TILED(8)
    NW_TILED(12)
    NW_TILED(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef NW_TILED
}

// The register route's untimed kernel at `lanes` (one- or two-piece) for
// tile rows of W lanes: its registers, local (spill) bytes a thread, and
// resident blocks an SM for blocks of `threads` threads and smem_bytes of
// dynamic shared memory.
extern "C" int nw_sweep_tiled_occupancy(int lanes, int two, int W, int threads, int smem_bytes, int* regs,
                                        int* local_bytes, int* blocks_per_sm) {
  const void* fn = nullptr;
#define NW_TILED_FN(SV)                                                                       \
  case SV:                                                                                    \
    if (W % SV)                                                                               \
      fn = two ? (const void*)nw_sweep_tiled_regs<SV, true, false, true>                      \
               : (const void*)nw_sweep_tiled_regs<SV, false, false, true>;                    \
    else                                                                                      \
      fn = two ? (const void*)nw_sweep_tiled_regs<SV, true, false, false>                     \
               : (const void*)nw_sweep_tiled_regs<SV, false, false, false>;                   \
    break;
  switch (lanes) {
    NW_TILED_FN(4)
    NW_TILED_FN(8)
    NW_TILED_FN(12)
    NW_TILED_FN(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef NW_TILED_FN
  cudaError_t err = allow_smem(fn, (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, (size_t)smem_bytes);
}
