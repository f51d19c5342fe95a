// Kernel A's wide route: one pair's band on a thread-block cluster (or a
// chain of clusters), its lanes in registers.
//
// Replaces, like the register route, seqrush_tpu/ops/nw_pallas.py::_kernel
// and nw.py::_sweep_v3 (single-shot, with the int16 and snapshot modes) and
// nw.py::_nw_segment (the segment mode) for the dispatches the register
// route does not take: bands above REG_MAX_W lanes, penalties outside
// [0, 2^16), int16 adds that can wrap, and pairs whose sequences do not fit
// the register route's shared memory.  It computes what the plain version
// (ops/nw_cuda.py::nw_align_reference, _sweep_reference) computes, byte for
// byte: the clamped Gotoh recurrence with INF framing at the band's edges,
// every traceback row, the scores, the snapshot mode's captures and the
// segment mode's carries.
//
// What bounds it on an H100: the anti-diagonal chain.  One pair's band is a
// serial chain of anti-diagonals, and no lane can take step t before both
// its neighbours hold step t - 1, so a step costs its own latency: a
// thread's S lanes, the edge lane's dependent minima, one column exchanged
// and one barrier over the CTAs that hold the band.  The bound of bytes or
// instructions sees none of it; the floor that a pair can reach is its
// anti-diagonals times the step's latency.  The design (the sharded mode's,
// nw_sweep_shard.cu, through the machinery of nw_cluster.cuh):
//   * a pair's lanes on `ctas` CTAs of at most kWideMaxThreads threads, in
//     clusters of up to 16 (non-portable above 8).  CTA c of the pair owns
//     units [c * U / ctas, (c + 1) * U / ctas) of the U = ceil(W / S) units
//     of S lanes; thread r of the CTA the r-th unit, threads past the CTA's
//     units are ghosts, lanes at or past W are ghost lanes, off the matrix
//     (so INF) at every step, which is the INF framing at the band's right
//     edge;
//   * thread r's S lanes live in registers; dp and dpp are uniform over the
//     pair, so each step is compiled for its phase: (0, 0) up to t = K, then
//     (1, 1) and (0, 1) in turn, and a step needs one neighbour column (three
//     values), by shuffles, warp slots, st.async into the neighbour CTA and,
//     between the clusters of a chain, the ring-and-flag protocol through
//     global memory;
//   * one split cluster barrier a step: the lanes that need no neighbour
//     are computed while it completes (a cluster of one CTA waits at a CTA
//     barrier instead); a pair on one CTA with a lane a thread, a narrow
//     band's plan, runs kernels of its own (SOLO) whose step has no test
//     for a neighbour CTA or cluster: shuffles, predicated warp slots and
//     the CTA barrier alone;
//   * the cell's arithmetic (AR) is chosen by the penalties: where each is in
//     [0, 2^16) H and its choice are two 3-way minima of unsigned keys value
//     * 8 + tag (the register route's cell); other int32 penalties take plain
//     compares, so the one kernel takes any; in the int16 mode every add
//     wraps to the low 16 bits, sign-extended, as the JAX package's int16
//     adds do, and the keys are signed;
//     validity is a per-lane range test and each state's clamp min(x, INF)
//     or INF off the matrix; a warp whose lanes are all on the matrix (a
//     vote a step, above a lane a thread) takes the cells without the test;
//   * the query and reversed-target bases come from shared-memory rings
//     filled a tile ahead, so the sequences' length does not bound the route;
//   * each thread writes its S traceback bytes of a row in one store (byte
//     stores where W is not a multiple of S);
//   * the rows past t_final + 2 see only INF inputs: their bytes are one of
//     two constants chosen by the base comparison, so the barrier loop ends
//     there and each thread writes the rest of its rows alone, its bases
//     read from global memory (the score-only mode ends at t_final);
//   * the row, the score and the carries are stored after the step's
//     arrive, off the barrier's path;
//   * the snapshot mode's captures are made by the steps t_snap and t_snap
//     + 1, swept as a span of their own (SNAPS), so no other step tests for
//     them (past t_final + 2 the captures are the INF the caller filled in);
//   * segment mode (SEG): grid row blockIdx.y sweeps its run of n_run
//     segments from its carry, storing the carry after each segment as the
//     step loop passes it; the caller fills the scores (those before the run,
//     or -1) and a pair's score is set only where it has none.
// The wrapper pads a CTA's shared memory so that one CTA holds an SM where
// the launch's CTAs fit the card at once; a chain of clusters spins on its
// neighbours, so a launch's clusters must all be resident together: the
// wrapper launches a chain's dispatch in slices of pairs and grid rows
// that the card holds at once (cudaOccupancyMaxActiveClusters;
// ops/nw_cuda.py::wide_slices).

#pragma once

#include "nw_cluster.cuh"

// threads a CTA at most: 384 leave each thread 168 registers
constexpr int kWideMaxThreads = 384;

struct WideArgs {
  const uint8_t* Q;  // [B, Lq] query codes, QPAD-padded
  const uint8_t* T;  // [B, Lt] target codes, TPAD-padded
  const int* qlens;
  const int* tlens;
  int* scores;  // [B], filled by the caller: -1, or in segment mode the scores before the run
  uint8_t* tb;  // single-shot [B, tmax_pad, W]; segment mode [B, tb_rows, W] from row 0 of the launch's rows; null: score-only
  int* recs;    // [groups, B, clusters, 2, kRecInts] zeroed (a chain of clusters), or null
  int B, Lq, Lt, W;
  int b0, y0;                         // the launch's first pair and grid row (a slice of the dispatch)
  int tmax, tmax_pad;                 // single-shot
  int ctas, clusters;                 // CTAs a pair, clusters a pair
  int qring, tring;                   // ring buffer bytes (powers of two)
  int mismatch, o1, e1, o2, e2;
  SnapArgs sn;                        // the snapshot mode (sn.snap null: off)
  SegArgs sa;                         // segment mode
};

// What a thread knows of its place; the first block of fields is what
// nw_cluster.cuh's functions read.
struct WideCtx {
  const uint8_t* q;
  const uint8_t* tg;
  int Lq, Lt, W, K;
  int a0, span;   // the CTA's first lane and its lanes
  int t1, t_total;  // the first and the last anti-diagonal of the barrier loop
  int r, lane, warp, nw, nreal;
  bool has_left_cta, has_right_cta, left_end, right_end, sys;
  bool solo;  // a cluster of one CTA: the step's barrier is the CTA's
  int* lw;
  int* rw;
  const int* slot_l;
  const int* slot_r;
  uint32_t bar_l, bar_r, to_r, to_r_bar, to_l, to_l_bar;
  int* my_left;
  int* my_right;
  const int* peer_left;
  const int* peer_right;
  uint8_t* Qr;
  uint8_t* Tr;
  int qmask, tmask;
  int neg;
  // the pair
  int g0;  // the band's lane of the thread's first lane
  int qlen, tlen, t_final;
  int* score;
  uint8_t* tb;  // the pair's traceback row of anti-diagonal row0 (null: score-only)
  int row0;
  bool vec;     // the S bytes of a real strip go in one store
  // snapshot mode
  int t_snap;
  int* snap;
  int* diaga;
  int* diagb;
  size_t plane;
  // segment mode: the carries after the run's segments
  int seg, n_out;
  int* carry;  // the carry after the run's first segment, this pair's row
  size_t cstride;
};

struct WidePen {
  int mis, oe1, e1, oe2, e2;
};

// The cell's arithmetic (the kernels' AR): kPlain, plain compares, for any
// int32 penalties; kKeyed, H and its choice as the 3-way mins of keys value *
// 8 + tag, unsigned, where every penalty is in [0, 2^16), so every value
// lies in [0, INF + 2^17] (the register route's rule,
// ops/nw_cuda.py::register_route_penalties); kKeyed16, the int16 mode, whose
// values (wrapped to 16 bits) take signed keys.
constexpr int kPlain = 0, kKeyed = 1, kKeyed16 = 2;

template <bool I16>
__device__ __forceinline__ int wadd(int a, int b) {
  const int x = a + b;
  return I16 ? (int)(int16_t)x : x;
}

// One cell of the reference's arithmetic from its neighbours: the new
// states before the validity clamp and the packed traceback byte
// choice | i1o<<3 | i2o<<4 | d1o<<5 | d2o<<6.  A gap state is min(open,
// extend), its opened bit open <= extend (one __vibmin_s32); H's strict '<'
// in the order D1, I1, D2, I2 keeps the earlier choice, which the keys'
// minima keep as the smaller tag; one-piece scoring still offers I2 = D2 =
// neg, as the reference does.
template <bool TWO, int AR>
__device__ __forceinline__ uint32_t wide_core(int h_up, int h_left, int h_diag, int i1_up, int d1_left,
                                              int i2_up, int d2_left, int sub, int neg, const WidePen& p,
                                              int& H, int& i1, int& d1, int& i2, int& d2) {
  constexpr bool I16 = AR == kKeyed16;
  bool op;
  i1 = __vibmin_s32(wadd<I16>(h_up, p.oe1), wadd<I16>(i1_up, p.e1), &op);
  uint32_t b = op ? 8u : 0u;
  d1 = __vibmin_s32(wadd<I16>(h_left, p.oe1), wadd<I16>(d1_left, p.e1), &op);
  b |= op ? 32u : 0u;
  i2 = neg;
  d2 = neg;
  if (TWO) {
    i2 = __vibmin_s32(wadd<I16>(h_up, p.oe2), wadd<I16>(i2_up, p.e2), &op);
    b |= op ? 16u : 0u;
    d2 = __vibmin_s32(wadd<I16>(h_left, p.oe2), wadd<I16>(d2_left, p.e2), &op);
    b |= op ? 64u : 0u;
  }
  const int hd = wadd<I16>(h_diag, sub);
  if constexpr (AR == kKeyed) {
    const uint32_t k01 = __vimin3_u32((uint32_t)hd << 3, ((uint32_t)d1 << 3) | 1u, ((uint32_t)i1 << 3) | 2u);
    const uint32_t key = __vimin3_u32(k01, ((uint32_t)d2 << 3) | 3u, ((uint32_t)i2 << 3) | 4u);
    H = (int)(key >> 3);
    return b | (key & 7u);
  } else if constexpr (AR == kKeyed16) {
    const int k01 = __vimin3_s32(hd * 8, d1 * 8 + 1, i1 * 8 + 2);
    const int key = __vimin3_s32(k01, d2 * 8 + 3, i2 * 8 + 4);
    H = key >> 3;
    return b | (uint32_t)(key & 7);
  } else {
    H = hd;
    uint32_t ch = 0;
    if (d1 < H) { H = d1; ch = 1; }
    if (i1 < H) { H = i1; ch = 2; }
    if (d2 < H) { H = d2; ch = 3; }
    if (i2 < H) { H = i2; ch = 4; }
    return b | ch;
  }
}

template <int S, int DPP>
__device__ __forceinline__ int h_diag_of(const Lanes<S>& L, const Edge& e, int k) {
  return DPP ? L.h2[k] : (k ? L.h2[k - 1] : e.hl2);
}

// Lane k of the step: its neighbours at the step's shifts, the cell, and
// the states clamped (INF off the matrix).
template <int S, bool TWO, int AR, int DP, int DPP>
__device__ __forceinline__ uint32_t wide_cell(const Lanes<S>& L, const Edge& e, const WidePen& p, int neg, int k,
                                              bool valid, int& Hn, int& I1n, int& D1n, int& I2n, int& D2n) {
  const int h_up = DP ? L.h1[k] : (k ? L.h1[k - 1] : e.hl1);
  const int h_left = DP ? (k < S - 1 ? L.h1[k + 1] : e.hr1) : L.h1[k];
  const int i1_up = DP ? L.i1[k] : (k ? L.i1[k - 1] : e.i1l);
  const int d1_left = DP ? (k < S - 1 ? L.d1[k + 1] : e.d1r) : L.d1[k];
  int i2_up = neg, d2_left = neg;
  if (TWO) {
    i2_up = DP ? L.i2[k] : (k ? L.i2[k - 1] : e.i2l);
    d2_left = DP ? (k < S - 1 ? L.d2[k + 1] : e.d2r) : L.d2[k];
  }
  const int sub = L.qw[k] == L.tw[k] ? 0 : p.mis;
  int H, i1, d1, i2, d2;
  const uint32_t byte = wide_core<TWO, AR>(h_up, h_left, h_diag_of<S, DPP>(L, e, k), i1_up, d1_left, i2_up,
                                            d2_left, sub, neg, p, H, i1, d1, i2, d2);
  if constexpr (AR == kKeyed) {
    // every value is >= 0 here: the clamp and the validity are one
    // min(x + off, INF), off 0 on the matrix and INF off it
    const int off = valid ? 0 : neg;
    Hn = __viaddmin_s32(H, off, neg);
    I1n = __viaddmin_s32(i1, off, neg);
    D1n = __viaddmin_s32(d1, off, neg);
    if (TWO) {
      I2n = __viaddmin_s32(i2, off, neg);
      D2n = __viaddmin_s32(d2, off, neg);
    }
  } else {
    Hn = valid ? min(H, neg) : neg;
    I1n = valid ? min(i1, neg) : neg;
    D1n = valid ? min(d1, neg) : neg;
    if (TWO) {
      I2n = valid ? min(i2, neg) : neg;
      D2n = valid ? min(d2, neg) : neg;
    }
  }
  return byte;
}

// The thread's S bytes of the traceback row of anti-diagonal t.
template <int S>
__device__ __forceinline__ void wide_store(const WideCtx& c, int t, uint32_t w) {
  uint8_t* row = c.tb + (size_t)(t - c.row0) * c.W + c.g0;
  if (c.vec && c.g0 + S <= c.W) {
    if constexpr (S == 4)
      *reinterpret_cast<uint32_t*>(row) = w;
    else if constexpr (S == 2)
      *reinterpret_cast<uint16_t*>(row) = (uint16_t)w;
    else
      *row = (uint8_t)w;
    return;
  }
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (c.g0 + k < c.W) row[k] = (uint8_t)(w >> (8 * k));
}

// the segment mode's carry after the segment that ends at anti-diagonal t
template <int S, bool TWO>
__device__ __forceinline__ void wide_carry(const Lanes<S>& L, const WideCtx& c, int t) {
  const int k = (t - c.t1 + 1) / c.seg - 1;
  if (k >= c.n_out || c.r >= c.nreal) return;
  int* out = c.carry + (size_t)k * c.cstride;
  const size_t pl = c.plane;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int l = c.g0 + j;
    if (l < c.W) {
      out[l] = L.h1[j];
      out[pl + l] = L.h2[j];
      out[2 * pl + l] = L.i1[j];
      out[3 * pl + l] = L.d1[j];
      out[4 * pl + l] = TWO ? L.i2[j] : NW_INF;
      out[5 * pl + l] = TWO ? L.d2[j] : NW_INF;
    }
  }
}

// A step's split barrier: the cluster's, or for a cluster of one CTA a
// CTA barrier at the wait (which orders the warp slots itself), for a CTA
// of one warp the warp's.
__device__ __forceinline__ void step_arrive(const WideCtx& c) {
  if (!c.solo) cluster_arrive();
}

__device__ __forceinline__ void step_wait(const WideCtx& c) {
  if (!c.solo)
    cluster_wait();
  else if (c.nw > 1)
    __syncthreads();
  else
    __syncwarp();
}

// A pair on one CTA with a lane a thread (SOLO, the narrow bands' plan):
// the step's column crosses threads by shuffles and warps by the warp slots
// alone, with no test for a neighbour CTA or cluster, the slots' stores and
// loads predicated rather than branched around, and a CTA barrier (a warp's
// for one warp) in place of the split one.  Threads past the band's lanes
// hold INF, so the last lane's right neighbour is INF without a test.
template <int S, bool TWO, int DPN>
__device__ __forceinline__ void solo_publish(const Lanes<S>& L, Edge& e, const WideCtx& c, int t) {
  const int par = t & 1;
  if (DPN == 0) {  // the next step reads the left neighbour's last lane
    const int h = L.h1[S - 1], i1 = L.i1[S - 1], i2 = TWO ? L.i2[S - 1] : c.neg;
    e.hl2 = e.hl1;
    e.hl1 = __shfl_up_sync(FULL_MASK, h, 1);
    e.i1l = __shfl_up_sync(FULL_MASK, i1, 1);
    if (TWO) e.i2l = __shfl_up_sync(FULL_MASK, i2, 1);
    if (c.lane == 31 && c.warp + 1 < c.nw) {
      int* s = c.lw + (par * c.nw + c.warp + 1) * 3;
      s[0] = h;
      s[1] = i1;
      s[2] = i2;
    }
  } else {  // the next step reads the right neighbour's first lane
    const int h = L.h1[0], d1 = L.d1[0], d2 = TWO ? L.d2[0] : c.neg;
    e.hr1 = __shfl_down_sync(FULL_MASK, h, 1);
    e.d1r = __shfl_down_sync(FULL_MASK, d1, 1);
    if (TWO) e.d2r = __shfl_down_sync(FULL_MASK, d2, 1);
    if (c.lane == 0 && c.warp > 0) {
      int* s = c.rw + (par * c.nw + c.warp - 1) * 3;
      s[0] = h;
      s[1] = d1;
      s[2] = d2;
    }
  }
}

template <bool TWO, int DP>
__device__ __forceinline__ void solo_read_edges(Edge& e, const WideCtx& c, int t) {
  const int par = (t - 1) & 1;
  if (DP == 0) {
    if (c.lane == 0) {
      const int* s = c.lw + (par * c.nw + c.warp) * 3;
      const bool in = c.warp > 0;
      e.hl1 = in ? s[0] : c.neg;
      e.i1l = in ? s[1] : c.neg;
      if (TWO) e.i2l = in ? s[2] : c.neg;
    }
  } else if (c.lane == 31) {
    const int* s = c.rw + (par * c.nw + c.warp) * 3;
    const bool in = c.warp + 1 < c.nw;
    e.hr1 = in ? s[0] : c.neg;
    e.d1r = in ? s[1] : c.neg;
    if (TWO) e.d2r = in ? s[2] : c.neg;
  }
}

// The step's exchange and barrier: nw_cluster.cuh's publish and read_edges
// around the split barrier, or with SOLO the one CTA's.
template <int S, bool TWO, int DPN, bool SOLO>
__device__ __forceinline__ void ex_publish(const Lanes<S>& L, Edge& e, const WideCtx& c, int t) {
  if constexpr (SOLO)
    solo_publish<S, TWO, DPN>(L, e, c, t);
  else
    publish<S, TWO, DPN>(L, e, c, t);
}

template <bool TWO, int DP, bool SOLO>
__device__ __forceinline__ void ex_read_edges(Edge& e, const WideCtx& c, int t) {
  if constexpr (SOLO)
    solo_read_edges<TWO, DP>(e, c, t);
  else
    read_edges<TWO, DP>(e, c, t);
}

template <bool SOLO>
__device__ __forceinline__ void ex_arrive(const WideCtx& c) {
  if constexpr (!SOLO) step_arrive(c);
}

template <bool SOLO>
__device__ __forceinline__ void ex_wait(const WideCtx& c) {
  if constexpr (SOLO) {
    if (c.nw > 1)
      __syncthreads();
    else
      __syncwarp();
  } else {
    step_wait(c);
  }
}

// The cells of lanes k in [k0, k1) of the step (ALL: the caller knows
// every lane of the thread is on the matrix).
template <int S, bool TWO, int AR, bool ALL, int DP, int DPP>
__device__ __forceinline__ void wide_cells(const Lanes<S>& L, const Edge& e, const WidePen& p, int k0, int k1,
                                           int vlo, uint32_t vspan, int (&nh)[S], int (&ni1)[S], int (&nd1)[S],
                                           int (&ni2)[S], int (&nd2)[S], uint32_t (&byte)[S]) {
  constexpr bool I16 = AR == kKeyed16;
  constexpr int neg = I16 ? NW_INF16 : NW_INF;
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (k >= k0 && k < k1)
      byte[k] = wide_cell<S, TWO, AR, DP, DPP>(L, e, p, neg, k, ALL || (uint32_t)(k - vlo) <= vspan, nh[k],
                                                 ni1[k], nd1[k], ni2[k], nd2[k]);
}

// Anti-diagonal t (the tau-th step of the barrier loop): slide the bases,
// compute the lanes that need no neighbour column while the barrier of the
// step before completes, then the edge lane (a warp whose lanes are all on
// the matrix without the per-lane validity test); publish for step t + 1
// (dp DPN) and arrive; then the row, the score, the segment's carry and,
// on the snapshot mode's two steps (SNAPS), its captures.
template <int S, bool TWO, bool TB, int AR, bool SEG, bool SOLO, bool SNAPS, int DP, int DPP, int DPN>
__device__ __forceinline__ void wide_step(Lanes<S>& L, Edge& e, const WideCtx& c, const WidePen& p, int t,
                                          int& qs, int& ts, int (&pre)[kStage]) {
  constexpr bool I16 = AR == kKeyed16;
  constexpr int neg = I16 ? NW_INF16 : NW_INF;
  const int tau = t - c.t1 + 1;
  const int i0 = i0_of(t, c.K);
  if (t > c.t1) {
    const int nqs = min(i0, c.Lq + 1);
    const int nts = max(0, min(c.Lt - t + i0 + c.W, c.Lt + c.W));
    if (nqs != qs) {  // +1
#pragma unroll
      for (int k = 0; k < S - 1; ++k) L.qw[k] = L.qw[k + 1];
      L.qw[S - 1] = c.Qr[(nqs + c.g0 + S - 1) & c.qmask];
    }
    if (nts != ts) {  // -1
#pragma unroll
      for (int k = S - 1; k > 0; --k) L.tw[k] = L.tw[k - 1];
      L.tw[0] = c.Tr[(nts + c.g0) & c.tmask];
    }
    qs = nqs;
    ts = nts;
  }
  stage_step(t, c, pre);
  // valid lanes: t - tlen - i0 <= l <= min(qlen, t) - i0, and l < W
  const int lo = t - c.tlen - i0;
  const int hi = min(min(c.qlen, t) - i0, c.W - 1);
  int vlo = lo - c.g0;
  uint32_t vspan = (uint32_t)(hi - lo);
  if (hi < lo) {
    vlo = -(1 << 30);
    vspan = 0;
  }
  // a lane a thread tests its one lane: the vote would cost more than it saves
  const bool all = S > 1 && __all_sync(FULL_MASK, vlo <= 0 && (uint32_t)(S - 1 - vlo) <= vspan);
  constexpr int KE = DP ? S - 1 : 0;  // the lane that reads the neighbour column
  constexpr int K0 = DP ? 0 : 1;      // the other lanes: [K0, K0 + S - 1)
  int nh[S], ni1[S], nd1[S], ni2[S], nd2[S];
  uint32_t byte[S];
  if (all)
    wide_cells<S, TWO, AR, true, DP, DPP>(L, e, p, K0, K0 + S - 1, vlo, vspan, nh, ni1, nd1, ni2, nd2, byte);
  else
    wide_cells<S, TWO, AR, false, DP, DPP>(L, e, p, K0, K0 + S - 1, vlo, vspan, nh, ni1, nd1, ni2, nd2, byte);
  ex_wait<SOLO>(c);
  ex_read_edges<TWO, DP, SOLO>(e, c, tau);
  if (all)
    wide_cells<S, TWO, AR, true, DP, DPP>(L, e, p, KE, KE + 1, vlo, vspan, nh, ni1, nd1, ni2, nd2, byte);
  else
    wide_cells<S, TWO, AR, false, DP, DPP>(L, e, p, KE, KE + 1, vlo, vspan, nh, ni1, nd1, ni2, nd2, byte);
  if (SNAPS && c.r < c.nreal) {
    // the clamped diagonal candidate h_diag + sub of t_snap and t_snap + 1
    int* out = t == c.t_snap ? c.diaga : c.diagb;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int sub = L.qw[k] == L.tw[k] ? 0 : p.mis;
      const int hd = wadd<I16>(h_diag_of<S, DPP>(L, e, k), sub);
      if (c.g0 + k < c.W) out[c.g0 + k] = (uint32_t)(k - vlo) <= vspan ? min(hd, neg) : neg;
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    L.h2[k] = L.h1[k];
    L.h1[k] = nh[k];
    L.i1[k] = ni1[k];
    L.d1[k] = nd1[k];
    if (TWO) {
      L.i2[k] = ni2[k];
      L.d2[k] = nd2[k];
    }
  }
  if (t < c.t_total) ex_publish<S, TWO, DPN, SOLO>(L, e, c, tau);  // nobody reads the last step's column
  ex_arrive<SOLO>(c);
  // the step's global stores after the arrive, whose CTA-scope fence would
  // otherwise order them ahead of the barrier
  if (c.r < c.nreal) {
    if (SNAPS && t == c.t_snap) {  // the carry after t_snap
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int l = c.g0 + k;
        if (l < c.W) {
          c.snap[l] = L.h1[k];
          c.snap[c.plane + l] = L.h2[k];
          c.snap[2 * c.plane + l] = L.i1[k];
          c.snap[3 * c.plane + l] = L.d1[k];
          c.snap[4 * c.plane + l] = TWO ? L.i2[k] : neg;
          c.snap[5 * c.plane + l] = TWO ? L.d2[k] : neg;
        }
      }
    }
    if (TB) {
      uint32_t w = 0;
#pragma unroll
      for (int k = 0; k < S; ++k) w |= byte[k] << (8 * k);
      wide_store<S>(c, t, w);
    }
    if (t == c.t_final) {
      const int fl = c.qlen - i0 - c.g0;
#pragma unroll
      for (int k = 0; k < S; ++k)
        if (k == fl && c.g0 + k < c.W && nh[k] < NW_INF && (!SEG || *c.score < 0)) *c.score = nh[k];
    }
  }
  if (SEG && tau % c.seg == 0) wide_carry<S, TWO>(L, c, t);
}

// dp of anti-diagonal t: 0 up to K, then 1 and 0 in turn
__device__ __forceinline__ bool dp_of(int t, int K) { return t > K && ((t - K) & 1); }

// Anti-diagonals [a, hi] of the barrier loop in the phases of the shifts:
// up to K (0, 0), then (1, 1) and (0, 1) in turn (a may lie anywhere: a
// segment's start, or a snapshot span's).  Returns the anti-diagonal after
// the last one swept (a where hi < a).
template <int S, bool TWO, bool TB, int AR, bool SEG, bool SOLO, bool SNAPS>
__device__ __forceinline__ int wide_span(Lanes<S>& L, Edge& e, const WideCtx& c, const WidePen& p, int a, int hi,
                                         int& qs, int& ts, int (&pre)[kStage]) {
  const int K = c.K;
  int t = a;
  for (; t <= hi && t < K; ++t) wide_step<S, TWO, TB, AR, SEG, SOLO, SNAPS, 0, 0, 0>(L, e, c, p, t, qs, ts, pre);
  if (t <= hi && t == K) wide_step<S, TWO, TB, AR, SEG, SOLO, SNAPS, 0, 0, 1>(L, e, c, p, t++, qs, ts, pre);
  if (t <= hi && t > K && !dp_of(t, K))
    wide_step<S, TWO, TB, AR, SEG, SOLO, SNAPS, 0, 1, 1>(L, e, c, p, t++, qs, ts, pre);
  for (; t + 1 <= hi; t += 2) {  // (t - K) is odd here
    wide_step<S, TWO, TB, AR, SEG, SOLO, SNAPS, 1, 1, 0>(L, e, c, p, t, qs, ts, pre);
    wide_step<S, TWO, TB, AR, SEG, SOLO, SNAPS, 0, 1, 1>(L, e, c, p, t + 1, qs, ts, pre);
  }
  if (t <= hi) wide_step<S, TWO, TB, AR, SEG, SOLO, SNAPS, 1, 1, 0>(L, e, c, p, t++, qs, ts, pre);
  return t;
}

// Rows (c.t_total, t_end] past t_final + 2, where every input is INF: each
// byte is one of two constants chosen by the base comparison; the bases
// come from global memory (no barrier orders the rings any more), and in
// segment mode the carries after the segments that end there (all INF).
template <int S, bool TWO, bool TB, int AR, bool SEG>
__device__ __forceinline__ void wide_tail(const Lanes<S>& L, const WideCtx& c, const WidePen& p, int t_end) {
  constexpr bool I16 = AR == kKeyed16;
  constexpr int neg = I16 ? NW_INF16 : NW_INF;
  uint32_t eq, ne;
  {
    int a, b, d, f, g;
    eq = wide_core<TWO, AR>(neg, neg, neg, neg, neg, neg, neg, 0, neg, p, a, b, d, f, g);
    ne = wide_core<TWO, AR>(neg, neg, neg, neg, neg, neg, neg, p.mis, neg, p, a, b, d, f, g);
  }
  int qw[S], tw[S];
  int qs = -(1 << 30), ts = -(1 << 30);  // the first row loads its windows whole
  for (int t = max(c.t_total + 1, c.t1); t <= t_end; ++t) {
    if (TB && c.r < c.nreal) {
      const int i0 = i0_of(t, c.K);
      const int nqs = min(i0, c.Lq + 1);
      const int nts = max(0, min(c.Lt - t + i0 + c.W, c.Lt + c.W));
      if (nqs == qs + 1) {
#pragma unroll
        for (int k = 0; k < S - 1; ++k) qw[k] = qw[k + 1];
        qw[S - 1] = qbase(nqs + c.g0 + S - 1, c);
      } else if (nqs != qs) {
#pragma unroll
        for (int k = 0; k < S; ++k) qw[k] = qbase(nqs + c.g0 + k, c);
      }
      if (nts == ts - 1) {
#pragma unroll
        for (int k = S - 1; k > 0; --k) tw[k] = tw[k - 1];
        tw[0] = tbase(nts + c.g0, c);
      } else if (nts != ts) {
#pragma unroll
        for (int k = 0; k < S; ++k) tw[k] = tbase(nts + c.g0 + k, c);
      }
      qs = nqs;
      ts = nts;
      uint32_t w = 0;
#pragma unroll
      for (int k = 0; k < S; ++k) w |= (qw[k] == tw[k] ? eq : ne) << (8 * k);
      wide_store<S>(c, t, w);
    }
    if (SEG && (t - c.t1 + 1) % c.seg == 0) wide_carry<S, TWO>(L, c, t);
  }
}

// The thread's place in a launch: its pair (returned) and grid row gy, its
// CTA's lanes, its neighbours, the shared memory's layout and the chain's
// ring records; what the kernel body and the chain floor's probe share.
template <int S>
__device__ __forceinline__ int wide_place(const WideArgs& a, WideCtx& c, int* wide_smem, int neg, bool seg,
                                          int& gy) {
  const int CS = (int)cluster_ctas();
  const int rank = (int)cluster_rank();
  const int cl = blockIdx.x / CS;
  const int b = a.b0 + cl / a.clusters;
  const int m = cl % a.clusters;  // the cluster's place in the pair's chain
  const int ci = m * CS + rank;   // the CTA's place among the pair's CTAs
  gy = seg ? a.y0 + (int)blockIdx.y : 0;
  const int U = (a.W + S - 1) / S;
  const int u0 = (int)((long long)ci * U / a.ctas);
  const int u1 = (int)((long long)(ci + 1) * U / a.ctas);

  c.Lq = a.Lq;
  c.Lt = a.Lt;
  c.W = a.W;
  c.K = a.W - 1;
  c.nreal = u1 - u0;
  c.span = c.nreal * S;
  c.a0 = u0 * S;
  c.r = threadIdx.x;
  c.lane = threadIdx.x & 31;
  c.warp = threadIdx.x >> 5;
  c.nw = blockDim.x >> 5;
  c.g0 = c.a0 + c.r * S;
  c.has_left_cta = rank > 0;
  c.has_right_cta = rank < CS - 1;
  c.left_end = rank == 0 && m > 0 && c.r == 0;
  c.right_end = rank == CS - 1 && m < a.clusters - 1 && c.r == c.nreal - 1;
  c.sys = false;
  c.solo = CS == 1;
  c.neg = neg;
  // shared memory: the mbarriers of the columns from the left and the right
  // CTA [2] each, their slots [2][4] each, the warp slots, the base rings
  uint64_t* bars = reinterpret_cast<uint64_t*>(wide_smem);
  c.bar_l = smem_addr(bars);
  c.bar_r = smem_addr(bars + 2);
  c.slot_l = wide_smem + 8;
  c.slot_r = wide_smem + 16;
  c.lw = wide_smem + 24;
  c.rw = c.lw + 6 * c.nw;
  c.Qr = reinterpret_cast<uint8_t*>(c.rw + 6 * c.nw);
  c.Tr = c.Qr + a.qring;
  c.qmask = a.qring - 1;
  c.tmask = a.tring - 1;
  c.to_r = c.has_right_cta ? map_rank(smem_addr(c.slot_l), rank + 1) : 0u;
  c.to_r_bar = c.has_right_cta ? map_rank(c.bar_l, rank + 1) : 0u;
  c.to_l = c.has_left_cta ? map_rank(smem_addr(c.slot_r), rank - 1) : 0u;
  c.to_l_bar = c.has_left_cta ? map_rank(c.bar_r, rank - 1) : 0u;
  int* rec = a.recs ? a.recs + (size_t)(gy * a.B + b) * a.clusters * 2 * kRecInts : nullptr;
  c.my_left = c.left_end ? rec + (2 * m) * kRecInts : nullptr;
  c.peer_left = c.left_end ? rec + (2 * m - 1) * kRecInts : nullptr;
  c.my_right = c.right_end ? rec + (2 * m + 1) * kRecInts : nullptr;
  c.peer_right = c.right_end ? rec + (2 * m + 2) * kRecInts : nullptr;
  c.score = a.scores + b;
  c.vec = a.W % S == 0;
  c.plane = (size_t)a.B * a.W;
  c.snap = nullptr;
  return b;
}

// The kernel body: single-shot (anti-diagonals 1..tmax from the initial
// rows) or, with SEG, grid row blockIdx.y's run of segments from its carry.
template <int S, bool TWO, bool TB, int AR, bool SEG, bool SOLO>
__device__ __forceinline__ void wide_body(const WideArgs& a) {
  extern __shared__ __align__(16) int wide_smem[];
  constexpr bool I16 = AR == kKeyed16;
  constexpr int neg = I16 ? NW_INF16 : NW_INF;
  WideCtx c;
  int gy;
  const int b = wide_place<S>(a, c, wide_smem, neg, SEG, gy);
  c.q = a.Q + (size_t)b * a.Lq;
  c.tg = a.T + (size_t)b * a.Lt;
  c.qlen = a.qlens[b];
  c.tlen = a.tlens[b];
  c.t_final = c.qlen + c.tlen;
  int t_end;  // the last anti-diagonal of the launch's rows
  if (SEG) {
    const int before = gy * a.sa.n_run;  // segments before the grid row's run
    c.t1 = a.sa.t_lo + before * a.sa.seg;
    c.seg = a.sa.seg;
    c.n_out = a.sa.n_out;
    c.cstride = a.sa.cstride;
    c.carry = a.sa.carry_out ? a.sa.carry_out + (size_t)before * a.sa.cstride + (size_t)b * a.W : nullptr;
    c.tb = TB ? a.tb + ((size_t)b * a.sa.tb_rows + (size_t)before * a.sa.seg) * a.W : nullptr;
    c.row0 = c.t1;
    t_end = c.t1 + a.sa.n_run * a.sa.seg - 1;
  } else {
    c.t1 = 1;
    c.tb = TB ? a.tb + (size_t)b * a.tmax_pad * a.W : nullptr;
    c.row0 = 0;
    t_end = a.tmax;
    if (TB && a.sn.snap) {
      c.t_snap = a.sn.t_snap[b];
      c.snap = a.sn.snap + (size_t)b * a.W;
      c.diaga = a.sn.diaga + (size_t)b * a.W;
      c.diagb = a.sn.diagb + (size_t)b * a.W;
    }
  }
  // from t_final + 3 on every input is INF; without a traceback nothing
  // past t_final is needed, except in segment mode, whose carries then
  // equal the strips
  const int last = (TB || SEG) ? c.t_final + 2 : c.t_final;
  c.t_total = min(t_end, last);
  const WidePen p{I16 ? (int)(int16_t)a.mismatch : a.mismatch, a.o1 + a.e1, a.e1, a.o2 + a.e2, a.e2};

  if (!SEG && c.r < c.nreal) {
    // the int16 mode reads an empty pair's score at the origin; traceback
    // row 0 and the padding rows past tmax are zero; t_snap == 0
    // snapshots the initial state, neg but H's origin
    if (I16 && c.t_final == 0 && c.g0 == 0) *c.score = 0;
    if (TB) {
      wide_store<S>(c, 0, 0u);
      for (int t = a.tmax + 1; t < a.tmax_pad; ++t) wide_store<S>(c, t, 0u);
      if (c.snap && c.t_snap == 0 && c.g0 == 0) c.snap[0] = 0;
    }
  }

  Lanes<S> L;
  Edge e{neg, neg, neg, neg, neg, neg, neg, 0, 0, 0, 0};
  if (SEG) {
    // the strip and its left neighbour's H(t1 - 2) from the carry (lanes
    // at or past W are INF)
    const size_t pl = c.plane;
    const int* cin = a.sa.carry_in + (size_t)(gy * a.sa.n_run) * a.sa.cstride + (size_t)b * a.W;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int l = c.g0 + k;
      const bool in = l < a.W;
      L.h1[k] = in ? cin[l] : neg;
      L.h2[k] = in ? cin[pl + l] : neg;
      L.i1[k] = in ? cin[2 * pl + l] : neg;
      L.d1[k] = in ? cin[3 * pl + l] : neg;
      L.i2[k] = (TWO && in) ? cin[4 * pl + l] : neg;
      L.d2[k] = (TWO && in) ? cin[5 * pl + l] : neg;
    }
    const int lf = c.g0 - 1;
    e.hl1 = (lf >= 0 && lf < a.W) ? cin[pl + lf] : neg;  // shifted into hl2 by the first publish
  } else {
    // the state at t = 0 (H 0 at the band's lane 0) and t = -1
#pragma unroll
    for (int k = 0; k < S; ++k) {
      L.h1[k] = c.g0 + k == 0 ? 0 : neg;
      L.h2[k] = neg;
      L.i1[k] = L.d1[k] = L.i2[k] = L.d2[k] = neg;
    }
  }

  if (c.t_total >= c.t1) {
    int pre[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) pre[i] = 0;
    if (c.r == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) mbar_init(c.bar_l + 8 * k, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    stage_first(c);
    cluster_sync();  // every CTA of the cluster runs, its mbarriers are set, tile 0 is staged
    int qs = qs_of(c.t1, c), ts = ts_of(c.t1, c);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      L.qw[k] = c.Qr[(qs + c.g0 + k) & c.qmask];
      L.tw[k] = c.Tr[(ts + c.g0 + k) & c.tmask];
    }
    if (dp_of(c.t1, c.K))
      ex_publish<S, TWO, 1, SOLO>(L, e, c, 0);
    else
      ex_publish<S, TWO, 0, SOLO>(L, e, c, 0);
    ex_arrive<SOLO>(c);
    if constexpr (TB && !SEG) {
      if (c.snap) {  // the captures only on the snapshot's two steps
        int t = wide_span<S, TWO, TB, AR, SEG, SOLO, false>(L, e, c, p, c.t1, min(c.t_total, c.t_snap - 1), qs, ts, pre);
        t = wide_span<S, TWO, TB, AR, SEG, SOLO, true>(L, e, c, p, t, min(c.t_total, c.t_snap + 1), qs, ts, pre);
        wide_span<S, TWO, TB, AR, SEG, SOLO, false>(L, e, c, p, t, c.t_total, qs, ts, pre);
      } else {
        wide_span<S, TWO, TB, AR, SEG, SOLO, false>(L, e, c, p, c.t1, c.t_total, qs, ts, pre);
      }
    } else {
      wide_span<S, TWO, TB, AR, SEG, SOLO, false>(L, e, c, p, c.t1, c.t_total, qs, ts, pre);
    }
    ex_wait<SOLO>(c);  // no CTA leaves while a neighbour may still write its slots
  }
  if (TB || SEG) wide_tail<S, TWO, TB, AR, SEG>(L, c, p, t_end);
}

// The chain floor's probe: one pair's a.tmax steps at a plan with the
// step's exchange and barrier alone, no cell, bases, validity or store.
// Each step waits, reads its edge columns, adds them into its lanes (so the
// column it sends depends on the one it read), publishes and arrives, as
// wide_step does around its cells.  Its time over the steps is the step
// latency the cluster's machinery alone allows at the plan: the floor a
// pair's chain of anti-diagonals can reach (ops/nw_cuda.py::wide_floor).
template <int S, bool SOLO, int DP, int DPN>
__device__ __forceinline__ void floor_step(Lanes<S>& L, Edge& e, const WideCtx& c, int t) {
  ex_wait<SOLO>(c);
  ex_read_edges<true, DP, SOLO>(e, c, t);
  const int v = DP ? e.hr1 + e.d1r + e.d2r : e.hl1 + e.i1l + e.i2l;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    L.h1[k] += v;
    L.i1[k] += v;
    L.d1[k] += v;
    L.i2[k] += v;
    L.d2[k] += v;
  }
  if (t < c.t_total) ex_publish<S, true, DPN, SOLO>(L, e, c, t);
  ex_arrive<SOLO>(c);
}

template <int S, bool SOLO>
__device__ __forceinline__ void wide_floor_body(const WideArgs& a) {
  extern __shared__ __align__(16) int wide_smem[];
  WideCtx c;
  int gy;
  wide_place<S>(a, c, wide_smem, NW_INF, false, gy);
  c.t1 = 1;
  c.t_total = a.tmax;
  Lanes<S> L;
#pragma unroll
  for (int k = 0; k < S; ++k) L.h1[k] = L.h2[k] = L.i1[k] = L.d1[k] = L.i2[k] = L.d2[k] = c.g0 + k;
  Edge e{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (c.r == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) mbar_init(c.bar_l + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
  const int K = c.K, T = c.t_total;
  if (dp_of(1, K))
    ex_publish<S, true, 1, SOLO>(L, e, c, 0);
  else
    ex_publish<S, true, 0, SOLO>(L, e, c, 0);
  ex_arrive<SOLO>(c);
  int t = 1;
  for (; t <= T && t < K; ++t) floor_step<S, SOLO, 0, 0>(L, e, c, t);
  if (t <= T && t == K) floor_step<S, SOLO, 0, 1>(L, e, c, t++);
  if (t <= T && t > K && !dp_of(t, K)) floor_step<S, SOLO, 0, 1>(L, e, c, t++);
  for (; t + 1 <= T; t += 2) {
    floor_step<S, SOLO, 1, 0>(L, e, c, t);
    floor_step<S, SOLO, 0, 1>(L, e, c, t + 1);
  }
  if (t <= T) floor_step<S, SOLO, 1, 0>(L, e, c, t);
  ex_wait<SOLO>(c);  // no CTA leaves while a neighbour may still write its slots
  if (c.r == 0 && L.h1[0] == 0x7fffffff) *c.score = L.h1[0];  // keeps the chain's adds
}

// The single-shot kernels: a pair on its CTAs and clusters, and (solo) a
// pair on one CTA at a lane a thread, the narrow bands' plan.
template <int S, bool TWO, bool TB, int AR>
__global__ void __launch_bounds__(kWideMaxThreads) nw_sweep_wide(const WideArgs a) {
  wide_body<S, TWO, TB, AR, false, false>(a);
}

template <bool TWO, bool TB, int AR>
__global__ void __launch_bounds__(kWideMaxThreads) nw_sweep_wide_solo(const WideArgs a) {
  wide_body<1, TWO, TB, AR, false, true>(a);
}

template <bool TWO, bool TB, int AR>
static const void* wide_kernel_s(int lanes, bool solo) {
  if (solo) return lanes == 1 ? (const void*)nw_sweep_wide_solo<TWO, TB, AR> : nullptr;
  switch (lanes) {
    case 4: return (const void*)nw_sweep_wide<4, TWO, TB, AR>;
    case 2: return (const void*)nw_sweep_wide<2, TWO, TB, AR>;
    case 1: return (const void*)nw_sweep_wide<1, TWO, TB, AR>;
    default: return nullptr;
  }
}

// The single-shot kernel of arithmetic AR for lanes, two-piece, traceback
// and solo, or null.  Each AR's kernels are instantiated in a source of
// their own (kKeyed nw_sweep_wide.cu, kPlain nw_sweep_wide_plain.cu,
// kKeyed16 nw_sweep_wide_i16.cu), so that nvcc builds them in parallel.
template <int AR>
static const void* wide_kernel_of(int lanes, bool two, bool tb, bool solo) {
  if (two) return tb ? wide_kernel_s<true, true, AR>(lanes, solo) : wide_kernel_s<true, false, AR>(lanes, solo);
  return tb ? wide_kernel_s<false, true, AR>(lanes, solo) : wide_kernel_s<false, false, AR>(lanes, solo);
}

const void* nw_sweep_wide_plain_kernel(int lanes, bool two, bool tb, bool solo);
const void* nw_sweep_wide_i16_kernel(int lanes, bool two, bool tb, bool solo);

// One launch of the wide route: pairs [a.b0, a.b0 + nb) of grid rows
// [a.y0, a.y0 + ny) (segment mode; single-shot has one row), ctas CTAs a
// pair, of `threads` threads and `smem` bytes of dynamic shared memory, in
// clusters of `cluster`.  Returns the CUDA error code.
static cudaError_t launch_wide(const void* fn, WideArgs a, int nb, int ny, int cluster, int threads, int smem,
                               cudaStream_t stream) {
  if (nb < 1 || ny < 1 || ny > 65535 || a.b0 < 0 || a.b0 + nb > a.B || a.y0 < 0) return cudaErrorInvalidValue;
  cudaError_t err = prepare_cluster(fn, cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, dim3(nb * a.ctas, ny), cluster, threads, smem, stream);
  void* args[] = {&a};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// The segment mode's kernel for lanes, two-piece, traceback, the cell's
// arithmetic and solo (one CTA a pair at a lane a thread), or null
// (nw_sweep_wide_seg.cu), for the query of nw_sweep_wide.cu.
const void* nw_sweep_wide_seg_kernel(int lanes, bool two, bool tb, int ar, bool solo);
