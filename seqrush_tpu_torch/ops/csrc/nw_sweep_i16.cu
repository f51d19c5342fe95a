// Kernel A's int16 mode on the register route: a packed s16x2 sweep.
//
// Replaces the int16 path of the XLA program seqrush_tpu/ops/nw.py::
// _sweep_v3(dtype=int16), as the int32 body's int16 mode (Pen::i16 in
// nw_sweep.cuh) did before it: every state saturates at NW_INF16 = 30000
// (NW_INF16 off the matrix), an empty pair scores 0, and the traceback bytes
// are the int32 body's, so the scores and the whole traceback tensor equal
// the plain version's (ops/nw_cuda.py::nw_align_reference(int16=True)) byte
// for byte.  It takes only the penalties ops/nw_cuda.py::
// register_route_penalties(..., int16=True) accepts: every add to a state is
// then at most 32,767 - 30000, so no add wraps and every value the sweep
// holds lies in [0, 32,767].  Other penalties keep the wide route's
// wrapping adds (nw_sweep_wide<I16> in nw_sweep.cu).
//
// What bounds it on an H100: integer instructions, as the int32 sweep.
// Hopper's DPX has packed forms that do two 16-bit lanes an instruction at
// the int32 rate (__viaddmin_u16x2, __vimin3_u16x2), so a cell costs half
// the instructions where its values fit 16 bits.  The design:
//   * twins: each 32-bit DP register holds lane l of two adjacent pairs of
//     the dispatch, pairs 2i (low half) and 2i + 1 (high half).  The lane
//     shifts dp and dpp depend only on t and the band, so both halves step in
//     lock-step: one shuffle, one warp-edge slot, one window slide serve
//     both.  The runner's chunks are length-bucketed, so twins end close
//     together; the step loop runs to the larger t_final + 2 of the two, and
//     the shorter twin's extra rows come out as the constant rows they are
//     (every input of a row past t_final + 2 is +infinity).  An odd B leaves
//     the last twin's high half an empty pair that stores nothing;
//   * each half keeps its own validity, substitution, score capture at its
//     own t_final and traceback row: the two pairs' bases are staged
//     interleaved (query and reversed target, one 16-bit word a position,
//     pair 2i's base in the low byte), a lane's pair of bases spread to the
//     two halves once, when the window slides in a new one;
//   * where the int32 body's tricks do not carry over to 16-bit halves:
//       - the validity clamp.  The int32 body adds 0 or INF and takes the
//         minimum with INF (__viaddmin_s32); in a signed 16-bit half x +
//         30000 wraps negative.  Here the unsigned form adds 0x8000 to an
//         invalid half (every value is below 0x8000, so the sum does not
//         wrap and is above 30000) and takes the minimum with 30000:
//         __viaddmin_u16x2(x, off, NEG2), one instruction a state.  Lane l
//         is valid in a half where bit 15 of both (l - lo) + 0x8000 and
//         (hi - l) + 0x8000 is set, the half's [lo, hi] clamped into range;
//       - H's choice.  The int32 body takes it as two unsigned 3-way minima
//         over keys value * 8 + tag, which need 19 bits.  Here H is a packed
//         3-way minimum of the five candidates twice over, and each of the
//         first four candidates x gets the key 8 * min(x - H, 1) + tag (x >=
//         H in each half, so the 32-bit x - H borrows nothing across
//         halves): the least key is the first candidate equal to H
//         in the reference's order (diagonal, D1, I1, D2, then I2 as the
//         key 4), which is the reference's strict '<' tie order in each
//         half;
//       - the opened bits.  open <= extend is bit 15 of (extend + 0x8000) -
//         open in each half (one 3-input add; both terms lie in [0,
//         32,767], so no borrow crosses halves), the int32 body's '<=' on
//         ties; a shift puts it at its place in the byte;
//       - the traceback bytes: each half's byte is assembled at bits 0-7
//         and 16-23 of a word; byte permutes split four lanes' words into
//         the two pairs' 4-byte words, each stored into its own pair's row;
//   * the step's chain: with half as many warps as the int32 body (at the
//     int16 run's [576, W 512], 288 twins of 4 warps, 2 or 3 a sub-
//     partition), little hides a step's latency, so a step computes the
//     new states first, sends its strip edges (the shuffles and the
//     warp-edge slots), then forms and stores the bytes while those are in
//     flight, and only then waits at the barrier; the window slide is
//     compiled for the step's phase (only the query window moves on a (1,
//     1) step, only the target's on the others), and a strip inside the
//     band stores each row with one aligned store;
//   * the rest is the int32 body's register route: S lanes a thread, edges
//     by shuffles and, where a twin spans several warps, double-buffered
//     shared-memory slots behind one named barrier over the twin's warps;
//     the phases of the shifts compiled apart; the rows past the last
//     twin's t_final + 2 written as constants without the recurrence.
// The planner (ops/nw_cuda.py::plan_sweep_i16) takes 4 lanes a thread
// wherever they cover W, 8 or 16 where they do not (4 x 128 threads under a
// launch bound of 3 blocks an SM, which leaves the step's kept values their
// registers), and gives a dispatch of few pairs, where twins would leave
// each SM a warp or two, to the int32 body's int16 mode instead.  What is
// left at [576, W 512] is issue on the SMs that hold three twins: 288 twins
// on 132 SMs put 3 on 24 of them, 2 on the rest.  Its own source, so the
// int32 kernels' code, registers and times do not change.

#include "nw_sweep.cuh"

#define I16_FLAG 0x80008000u  // bit 15 of each half
#define I16_ONES 0x00010001u

// The penalties in both halves; k1 = FLAG - OE1 and k2 = FLAG - OE2 for the
// opened bits; neg = NW_INF16 in both halves; mis the scalar mismatch.
struct Pen16 {
  uint32_t oe1, e1, oe2, e2, k1, k2, neg;
  int mis;
  uint32_t cheap_eq, cheap_ne;  // the byte of a row past t_final + 2, bases equal or not
};

template <int S>
struct Strip16 {
  uint32_t h1[S], h2[S], i1[S], d1[S], i2[S], d2[S];
  uint32_t qw[S], tw[S];  // the twins' query / reversed-target bases under the lanes
};

struct Edges16 {
  uint32_t hl1, hl2, i1l, i2l, hr1, d1r, d2r;
};

// What a thread needs beside its strip: the twins' operands and geometry.
struct Twin {
  const uint16_t* Qs;  // staged query pairs, shared memory
  const uint16_t* Ts;  // staged reversed target pairs, shared memory
  uint8_t* tbA;        // pair 2i's traceback [tmax_pad, W]
  uint8_t* tbB;        // pair 2i + 1's, or null (an empty twin)
  int* scoreA;
  int* scoreB;
  uint32_t* slots;     // warp-edge slots [2][wpp][6]
  int s0, K, W, Lq, Lt, walign, lane, wip, wpp, pib;
  int qlenA, tlenA, qlenB, tlenB, tfA, tfB;
  bool fast;  // the strip's rows take one aligned store each (store_twin_rows)
};

// A staged base pair spread to the two halves.
__device__ __forceinline__ uint32_t spread(uint16_t v) { return __byte_perm(v, 0, 0x4140); }

// Lane l's validity bases of one half at anti-diagonal t: bit 15 of
// vlo + l - s0 is set iff l >= lo, of vhi - (l - s0) iff l <= hi.
__device__ __forceinline__ void half_bounds(int t, int i0, int qlen, int tlen, int W, int s0, int& vlo,
                                            int& vhi) {
  const int lo = min(max(t - tlen - i0, 0), 0x7FFF);
  const int hi = max(min(min(qlen, t) - i0, W - 1), -1);
  vlo = s0 - lo + 0x8000;
  vhi = hi - s0 + 0x8000;
}

// What a lane's traceback byte needs beyond its new states, kept from the
// step for bytes16: the raw candidates of H's choice, H, the opened bits.
template <int S>
struct Cand16 {
  uint32_t hd[S], d1[S], i1[S], d2[S], H[S], bits[S];
};

// One anti-diagonal's recurrence over the thread's S lanes of both twins
// (see the design note): the new states into the strip, what the bytes
// need into c.
template <int S, bool TWO, int DP, int DPP>
__device__ __forceinline__ void step16(Strip16<S>& s, const Edges16& e, const Pen16& p, uint32_t vlo,
                                       uint32_t vhi, Cand16<S>& c) {
  uint32_t nh[S], ni1[S], nd1[S], ni2[S], nd2[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const uint32_t h_up = DP ? s.h1[k] : (k ? s.h1[k - 1] : e.hl1);
    const uint32_t h_left = DP ? (k < S - 1 ? s.h1[k + 1] : e.hr1) : s.h1[k];
    const uint32_t h_diag = DPP ? s.h2[k] : (k ? s.h2[k - 1] : e.hl2);
    const uint32_t i1_up = DP ? s.i1[k] : (k ? s.i1[k - 1] : e.i1l);
    const uint32_t d1_left = DP ? (k < S - 1 ? s.d1[k + 1] : e.d1r) : s.d1[k];
    // the diagonal candidate: 1 in a half whose bases differ, times mis
    const uint32_t ne = __vminu2(s.qw[k] ^ s.tw[k], I16_ONES);
    const uint32_t hd = h_diag + ne * (uint32_t)p.mis;
    // each gap state min(open, extend), and open <= extend at bit 15
    uint32_t x = i1_up + p.e1;
    const uint32_t i1 = __viaddmin_u16x2(h_up, p.oe1, x);
    uint32_t bits = ((x + p.k1 - h_up) >> 12) & 0x00080008u;  // I1 opened: bit 3
    x = d1_left + p.e1;
    const uint32_t d1 = __viaddmin_u16x2(h_left, p.oe1, x);
    bits |= ((x + p.k1 - h_left) >> 10) & 0x00200020u;  // D1 opened: bit 5
    uint32_t i2 = p.neg, d2 = p.neg;
    if (TWO) {
      const uint32_t i2_up = DP ? s.i2[k] : (k ? s.i2[k - 1] : e.i2l);
      const uint32_t d2_left = DP ? (k < S - 1 ? s.d2[k + 1] : e.d2r) : s.d2[k];
      x = i2_up + p.e2;
      i2 = __viaddmin_u16x2(h_up, p.oe2, x);
      bits |= ((x + p.k2 - h_up) >> 11) & 0x00100010u;  // I2 opened: bit 4
      x = d2_left + p.e2;
      d2 = __viaddmin_u16x2(h_left, p.oe2, x);
      bits |= ((x + p.k2 - h_left) >> 9) & 0x00400040u;  // D2 opened: bit 6
    }
    const uint32_t H = __vimin3_u16x2(__vimin3_u16x2(hd, d1, i1), d2, i2);
    // validity: 0x8000 added to an invalid half, then the clamp at INF16
    const uint32_t off = ~((vlo + k * I16_ONES) & (vhi - k * I16_ONES)) & I16_FLAG;
    nh[k] = __viaddmin_u16x2(H, off, p.neg);
    ni1[k] = __viaddmin_u16x2(i1, off, p.neg);
    nd1[k] = __viaddmin_u16x2(d1, off, p.neg);
    if (TWO) {
      ni2[k] = __viaddmin_u16x2(i2, off, p.neg);
      nd2[k] = __viaddmin_u16x2(d2, off, p.neg);
    }
    c.hd[k] = hd;
    c.d1[k] = d1;
    c.i1[k] = i1;
    c.d2[k] = d2;
    c.H[k] = H;
    c.bits[k] = bits;
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    s.h2[k] = s.h1[k];
    s.h1[k] = nh[k];
    s.i1[k] = ni1[k];
    s.d1[k] = nd1[k];
    if (TWO) {
      s.i2[k] = ni2[k];
      s.d2[k] = nd2[k];
    }
  }
}

// The lanes' two bytes, at bits 0-7 and 16-23: the first candidate equal
// to H by the key 8 * min(x - H, 1) + tag (x >= H in each half, so the
// 32-bit x - H borrows nothing across halves), and the opened bits.
template <int S>
__device__ __forceinline__ void bytes16(const Cand16<S>& c, uint32_t (&cw)[S]) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const uint32_t H = c.H[k];
    const uint32_t key = __vimin3_u16x2(
        __vimin3_u16x2(__vminu2(c.hd[k] - H, I16_ONES) * 8u,
                       __vminu2(c.d1[k] - H, I16_ONES) * 8u + I16_ONES,
                       __vminu2(c.i1[k] - H, I16_ONES) * 8u + 2 * I16_ONES),
        __vminu2(c.d2[k] - H, I16_ONES) * 8u + 3 * I16_ONES, 4 * I16_ONES);
    cw[k] = key + c.bits[k];
  }
}

// The edge exchange of the rows just computed (nw_sweep.cuh::exchange on
// packed values) in two halves, so that a step's bytes and stores go
// between them: the shuffles and the warp-edge slots' stores, then the
// barrier over the twin's warps and the slots' loads.
struct Sent16 {
  uint32_t hl, il, i2l, hr, dr, d2r;
};

template <int S, bool TWO>
__device__ __forceinline__ Sent16 exchange_send(const Strip16<S>& s, const Twin& tw, uint32_t neg,
                                                int parity) {
  Sent16 x;
  x.hl = __shfl_up_sync(FULL_MASK, s.h1[S - 1], 1);
  x.il = __shfl_up_sync(FULL_MASK, s.i1[S - 1], 1);
  x.hr = __shfl_down_sync(FULL_MASK, s.h1[0], 1);
  x.dr = __shfl_down_sync(FULL_MASK, s.d1[0], 1);
  x.i2l = neg;
  x.d2r = neg;
  if (TWO) {
    x.i2l = __shfl_up_sync(FULL_MASK, s.i2[S - 1], 1);
    x.d2r = __shfl_down_sync(FULL_MASK, s.d2[0], 1);
  }
  if (tw.wpp > 1) {
    uint32_t* sl = tw.slots + (parity * tw.wpp + tw.wip) * 6;
    if (tw.lane == 31) {
      sl[0] = s.h1[S - 1];
      sl[1] = s.i1[S - 1];
      sl[2] = TWO ? s.i2[S - 1] : neg;
    }
    if (tw.lane == 0) {
      sl[3] = s.h1[0];
      sl[4] = s.d1[0];
      sl[5] = TWO ? s.d2[0] : neg;
    }
  }
  return x;
}

__device__ __forceinline__ void exchange_recv(Edges16& e, Sent16 x, const Twin& tw, uint32_t neg,
                                              int parity) {
  if (tw.lane == 0) x.hl = x.il = x.i2l = neg;
  if (tw.lane == 31) x.hr = x.dr = x.d2r = neg;
  if (tw.wpp > 1) {
    const uint32_t* sl = tw.slots + (parity * tw.wpp + tw.wip) * 6;
    bar_pair<2>(tw.pib, tw.wpp * 32);
    if (tw.lane == 0 && tw.wip > 0) {
      x.hl = sl[-6 + 0];
      x.il = sl[-6 + 1];
      x.i2l = sl[-6 + 2];
    }
    if (tw.lane == 31 && tw.wip < tw.wpp - 1) {
      x.hr = sl[6 + 3];
      x.dr = sl[6 + 4];
      x.d2r = sl[6 + 5];
    }
  }
  e.hl2 = e.hl1;
  e.hl1 = x.hl;
  e.i1l = x.il;
  e.i2l = x.i2l;
  e.hr1 = x.hr;
  e.d1r = x.dr;
  e.d2r = x.d2r;
}

template <int S, bool TWO>
__device__ __forceinline__ void exchange16(const Strip16<S>& s, Edges16& e, const Twin& tw, uint32_t neg,
                                           int parity) {
  exchange_recv(e, exchange_send<S, TWO>(s, tw, neg, parity), tw, neg, parity);
}

// Split S lanes' twin words into each pair's bytes, and store both rows t:
// one 4-, 8- or 16-byte store a row where the strip lies inside the band and
// W is a multiple of S (tw.fast), else nw_sweep.cuh::store_row.
template <int S>
__device__ __forceinline__ void store_twin_rows(const Twin& tw, int t, const uint32_t (&cw)[S]) {
  constexpr int NW = S / 4;
  uint32_t wa[NW], wb[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    // lanes 4w, 4w + 1 and 4w + 2, 4w + 3: [A, A, B, B] each
    const uint32_t p01 = __byte_perm(cw[4 * w], cw[4 * w + 1], 0x6240);
    const uint32_t p23 = __byte_perm(cw[4 * w + 2], cw[4 * w + 3], 0x6240);
    wa[w] = __byte_perm(p01, p23, 0x5410);
    wb[w] = __byte_perm(p01, p23, 0x7632);
  }
  uint8_t* ra = tw.tbA + (size_t)t * tw.W;
  uint8_t* rb = tw.tbB + (size_t)t * tw.W;
  if (!tw.fast) {
    store_row<S>(ra, tw.s0, tw.W, tw.walign, wa);
    if (tw.tbB) store_row<S>(rb, tw.s0, tw.W, tw.walign, wb);
  } else if (S == 4) {
    *reinterpret_cast<uint32_t*>(ra + tw.s0) = wa[0];
    if (tw.tbB) *reinterpret_cast<uint32_t*>(rb + tw.s0) = wb[0];
  } else if (S == 8) {
    *reinterpret_cast<uint2*>(ra + tw.s0) = make_uint2(wa[0], wa[1 % NW]);
    if (tw.tbB) *reinterpret_cast<uint2*>(rb + tw.s0) = make_uint2(wb[0], wb[1 % NW]);
  } else {
    *reinterpret_cast<uint4*>(ra + tw.s0) = make_uint4(wa[0], wa[1 % NW], wa[2 % NW], wa[3 % NW]);
    if (tw.tbB) *reinterpret_cast<uint4*>(rb + tw.s0) = make_uint4(wb[0], wb[1 % NW], wb[2 % NW], wb[3 % NW]);
  }
}

template <int S>
__device__ __forceinline__ void load_windows16(Strip16<S>& s, const Twin& tw, int qs, int ts) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    s.qw[k] = spread(tw.Qs[qs + tw.s0 + k]);
    s.tw[k] = spread(tw.Ts[ts + tw.s0 + k]);
  }
}

// Slide the base windows from anti-diagonal t - 1 to t (t >= 2;
// nw_sweep.cuh::slide_windows with the step's phase known): on a step of
// shifts (1, 1), where i0 grows (dp), only the query window moves, by one,
// until its clamp at Lq + 1; on every other step only the target window, by
// one back, until its clamp at 0.
template <int S>
__device__ __forceinline__ void slide16(Strip16<S>& s, const Twin& tw, bool dp, int& qs, int& ts) {
  if (dp) {
    if (qs < tw.Lq + 1) {
      ++qs;
#pragma unroll
      for (int k = 0; k < S - 1; ++k) s.qw[k] = s.qw[k + 1];
      s.qw[S - 1] = spread(tw.Qs[qs + tw.s0 + S - 1]);
    }
  } else if (ts > 0) {
    --ts;
#pragma unroll
    for (int k = S - 1; k > 0; --k) s.tw[k] = s.tw[k - 1];
    s.tw[0] = spread(tw.Ts[ts + tw.s0]);
  }
}

// Anti-diagonal t of the recurrence for both twins: slide the windows, step,
// send the edges, store both rows (TB), take each score at its t_final,
// receive the edges.
template <int S, bool TWO, bool TB, int DP, int DPP>
__device__ __forceinline__ void advance16(Strip16<S>& s, Edges16& e, const Twin& tw, const Pen16& p,
                                          int t, int& qs, int& ts) {
  if (t > 1) slide16<S>(s, tw, DP, qs, ts);
  const int i0 = i0_of(t, tw.K);
  int loA, hiA, loB, hiB;
  half_bounds(t, i0, tw.qlenA, tw.tlenA, tw.W, tw.s0, loA, hiA);
  half_bounds(t, i0, tw.qlenB, tw.tlenB, tw.W, tw.s0, loB, hiB);
  Cand16<S> c;
  step16<S, TWO, DP, DPP>(s, e, p, (uint32_t)loA | ((uint32_t)loB << 16),
                          (uint32_t)hiA | ((uint32_t)hiB << 16), c);
  const Sent16 x = exchange_send<S, TWO>(s, tw, p.neg, t & 1);
  if (TB) {
    uint32_t cw[S];
    bytes16<S>(c, cw);
    store_twin_rows<S>(tw, t, cw);
  }
  if (t == tw.tfA || t == tw.tfB) {
    const int fa = t == tw.tfA ? tw.qlenA - i0 - tw.s0 : -1;
    const int fb = t == tw.tfB ? tw.qlenB - i0 - tw.s0 : -1;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (tw.s0 + k < tw.W) {
        if (k == fa) *tw.scoreA = (int)(s.h1[k] & 0xFFFFu);
        if (k == fb) *tw.scoreB = (int)(s.h1[k] >> 16);
      }
    }
  }
  exchange_recv(e, x, tw, p.neg, t & 1);
}

template <int S>
struct I16Bounds;  // (threads, blocks an SM) of each instantiation, as ops/nw_cuda.py::_I16_MAX_THREADS
template <> struct I16Bounds<4> { static constexpr int threads = 128, blocks = 3; };
template <> struct I16Bounds<8> { static constexpr int threads = 384, blocks = 1; };
template <> struct I16Bounds<16> { static constexpr int threads = 256, blocks = 1; };

// Twin i of the dispatch is pairs 2i and 2i + 1; block x holds twins
// [x * ppb, x * ppb + ppb), wpp warps each, S lanes a thread.
template <int S, bool TWO, bool TB>
__global__ void __launch_bounds__(I16Bounds<S>::threads, I16Bounds<S>::blocks)
nw_sweep_i16(const uint8_t* __restrict__ Q,  // [B, Lq] query codes, QPAD-padded
             const uint8_t* __restrict__ T,  // [B, Lt] target codes, TPAD-padded
             const int* __restrict__ qlens, const int* __restrict__ tlens,
             int* __restrict__ scores,        // [B] out
             uint8_t* __restrict__ tb,        // [B, tmax_pad, W] out (TB only)
             int B, int Lq, int Lt, int W, int tmax, int tmax_pad, Pen16 p, int wpp, int ppb,
             int twin_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pib = warp / wpp;        // twin in block
  const int wip = warp - pib * wpp;  // warp in twin
  const int bA = 2 * (blockIdx.x * ppb + pib);
  const int bB = bA + 1;
  const bool hasB = bB < B;
  const int tpp = wpp * 32;
  const int r = wip * 32 + lane;
  const int L = S * tpp;  // lanes covered, >= W

  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem + (size_t)pib * twin_bytes);
  uint16_t* Ts = Qs + round16(2 * (Lq + 1 + L)) / 2;
  if (bA < B) {
    // stage [QPAD] + q + [QPAD]* and [TPAD]*W + reverse(t) + [TPAD]*, the
    // two pairs' bases interleaved (an empty twin's are the pads); the
    // scores start at -1 (an empty pair's at 0) before the barrier orders
    // them ahead of the final writes
    const uint8_t* qa = Q + (size_t)bA * Lq;
    const uint8_t* ta = T + (size_t)bA * Lt;
    const uint8_t* qb = hasB ? qa + Lq : qa;
    const uint8_t* tgb = hasB ? ta + Lt : ta;
    for (int x = r; x < Lq + 1 + L; x += tpp) {
      const bool in = x >= 1 && x <= Lq;
      Qs[x] = in ? (uint16_t)(qa[x - 1] | ((hasB ? qb[x - 1] : NW_QPAD) << 8)) : (uint16_t)(NW_QPAD * 0x101);
    }
    for (int y = r; y < Lt + W + L; y += tpp) {
      const bool in = y >= W && y < W + Lt;
      const int yy = Lt - 1 - (y - W);
      Ts[y] = in ? (uint16_t)(ta[yy] | ((hasB ? tgb[yy] : NW_TPAD) << 8)) : (uint16_t)(NW_TPAD * 0x101);
    }
    if (r == 0) {
      scores[bA] = qlens[bA] + tlens[bA] == 0 ? 0 : -1;
      if (hasB) scores[bB] = qlens[bB] + tlens[bB] == 0 ? 0 : -1;
    }
  }
  __syncthreads();
  if (bA >= B) return;

  Twin tw;
  tw.Qs = Qs;
  tw.Ts = Ts;
  tw.tbA = TB ? tb + (size_t)bA * tmax_pad * W : nullptr;
  tw.tbB = (TB && hasB) ? tb + (size_t)bB * tmax_pad * W : nullptr;
  tw.scoreA = scores + bA;
  tw.scoreB = hasB ? scores + bB : nullptr;
  tw.slots = reinterpret_cast<uint32_t*>(Ts + round16(2 * (Lt + W + L)) / 2);
  tw.s0 = r * S;
  tw.K = W - 1;
  tw.W = W;
  tw.Lq = Lq;
  tw.Lt = Lt;
  tw.walign = (W & 15) == 0 ? 16 : (W & 7) == 0 ? 8 : (W & 3) == 0 ? 4 : 1;
  tw.fast = tw.s0 + S <= W && W % S == 0;
  tw.lane = lane;
  tw.wip = wip;
  tw.wpp = wpp;
  tw.pib = pib;
  tw.qlenA = qlens[bA];
  tw.tlenA = tlens[bA];
  tw.qlenB = hasB ? qlens[bB] : 0;
  tw.tlenB = hasB ? tlens[bB] : 0;
  tw.tfA = tw.qlenA + tw.tlenA;
  tw.tfB = hasB ? tw.qlenB + tw.tlenB : -1;  // an empty twin takes no score
  const int K = tw.K;

  // traceback row 0 and the padding rows past tmax are zero
  if (TB) {
    constexpr int NWORD = S / 4;
    uint32_t zero[NWORD];
#pragma unroll
    for (int w = 0; w < NWORD; ++w) zero[w] = 0;
    for (int t = 0; t < tmax_pad; t = t == 0 ? tmax + 1 : t + 1) {
      store_row<S>(tw.tbA + (size_t)t * W, tw.s0, W, tw.walign, zero);
      if (tw.tbB) store_row<S>(tw.tbB + (size_t)t * W, tw.s0, W, tw.walign, zero);
    }
  }

  // state at t = 0 (H row 0 is 0 at lane 0 in both halves) and t = -1
  Strip16<S> s;
  Edges16 e;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    s.h1[k] = (tw.s0 + k == 0) ? 0u : p.neg;
    s.h2[k] = p.neg;
    s.i1[k] = s.d1[k] = s.i2[k] = s.d2[k] = p.neg;
  }
  e.hl1 = p.neg;
  exchange16<S, TWO>(s, e, tw, p.neg, 0);
  e.hl2 = p.neg;  // H(-1)

  // from t_final + 3 on every input of a twin is INF; without a traceback
  // nothing past t_final is needed
  const int tf = max(tw.tfA, tw.tfB);
  const int last = min(tmax, TB ? tf + 2 : tf);
  int qs = min(i0_of(1, K), Lq + 1);
  int ts = max(0, min(Lt - 1 + i0_of(1, K) + W, Lt + W));
  load_windows16<S>(s, tw, qs, ts);
  int t = 1;
  for (; t <= last && t <= K; ++t) advance16<S, TWO, TB, 0, 0>(s, e, tw, p, t, qs, ts);
  for (; t + 1 <= last; t += 2) {  // (t - K) is odd here
    advance16<S, TWO, TB, 1, 1>(s, e, tw, p, t, qs, ts);
    advance16<S, TWO, TB, 0, 1>(s, e, tw, p, t + 1, qs, ts);
  }
  if (t <= last) advance16<S, TWO, TB, 1, 1>(s, e, tw, p, t++, qs, ts);
  if (!TB) return;
  // the constant rows: each half's byte chosen by its bases
  const uint32_t eq2 = p.cheap_eq * I16_ONES;
  const uint32_t diff = p.cheap_ne - p.cheap_eq;  // mod 2^32: each half's sum stays in [0, 255]
  for (; t <= tmax; ++t) {
    if (t > 1) slide16<S>(s, tw, t > K && ((t - K) & 1), qs, ts);
    uint32_t cw[S];
#pragma unroll
    for (int k = 0; k < S; ++k) cw[k] = eq2 + __vminu2(s.qw[k] ^ s.tw[k], I16_ONES) * diff;
    store_twin_rows<S>(tw, t, cw);
  }
}

// ---------------------------------------------------------------------------

template <bool TWO, bool TB>
static const void* i16_kernel(int S) {
  switch (S) {
    case 4: return (const void*)nw_sweep_i16<4, TWO, TB>;
    case 8: return (const void*)nw_sweep_i16<8, TWO, TB>;
    case 16: return (const void*)nw_sweep_i16<16, TWO, TB>;
    default: return nullptr;
  }
}

static const void* i16_fn(int S, bool two, bool tb) {
  return two ? (tb ? i16_kernel<true, true>(S) : i16_kernel<true, false>(S))
             : (tb ? i16_kernel<false, true>(S) : i16_kernel<false, false>(S));
}

// The packed int16 sweep: lanes S in {4, 8, 16} a thread, wpp warps a
// twin, ppb twins a block of twin_bytes of shared memory each
// (ops/nw_cuda.py::twin_smem_bytes); a null tb selects the score-only mode.
// The penalties must be register_route_penalties(..., int16=True)'s.
// Returns the CUDA error code.
extern "C" int nw_sweep_i16_launch(const void* Q, const void* T, const void* qlens, const void* tlens,
                                   void* scores, void* tb, int B, int Lq, int Lt, int W, int tmax,
                                   int tmax_pad, int mismatch, int o1, int e1, int o2, int e2, int lanes,
                                   int wpp, int ppb, int twin_bytes, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const bool two = o2 >= 0;
  const void* fn = i16_fn(lanes, two, tb != nullptr);
  if (fn == nullptr || wpp < 1 || ppb < 1 || (wpp > 1 && ppb > 2) || lanes * 32 * wpp < W)
    return (int)cudaErrorInvalidValue;
  Pen16 p;
  const uint32_t oe1 = o1 + e1, oe2 = two ? o2 + e2 : 0;
  p.oe1 = oe1 * I16_ONES;
  p.e1 = (uint32_t)e1 * I16_ONES;
  p.oe2 = oe2 * I16_ONES;
  p.e2 = two ? (uint32_t)e2 * I16_ONES : 0u;
  p.k1 = I16_FLAG - p.oe1;
  p.k2 = I16_FLAG - p.oe2;
  p.neg = NW_INF16 * I16_ONES;
  p.mis = mismatch;
  {
    // the constant bytes of a cell whose inputs are all INF16 (n), as
    // nw_sweep.cuh::cell_keyed gives them: both gap pairs opened where open
    // <= extend, the choice the first least candidate
    const int n = NW_INF16;
    const int g1 = min(n + (int)oe1, n + e1), g2 = two ? min(n + (int)oe2, n + e2) : n;
    const uint32_t opened = ((int)oe1 <= e1 ? 8u | 32u : 0u) | (two && (int)oe2 <= e2 ? 16u | 64u : 0u);
    auto byte = [&](int sub) {
      const int cand[5] = {n + sub, g1, g1, g2, g2};
      int best = 0;
      for (int c = 1; c < 5; ++c)
        if (cand[c] < cand[best]) best = c;
      return opened | (uint32_t)best;
    };
    p.cheap_eq = byte(0);
    p.cheap_ne = byte(mismatch);
  }
  const int threads = ppb * wpp * 32;
  const size_t smem = (size_t)ppb * twin_bytes;
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_twins = (B + 1) / 2;
  const int blocks = (n_twins + ppb - 1) / ppb;
  void* args[] = {&Q, &T, &qlens, &tlens, &scores, &tb, &B, &Lq, &Lt, &W, &tmax, &tmax_pad, &p, &wpp, &ppb,
                  &twin_bytes};
  return (int)cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, smem, (cudaStream_t)stream);
}

// Registers per thread, spilled bytes (local memory per thread), resident
// blocks per SM and shared memory per block of one launch shape of the
// packed int16 sweep.
extern "C" int nw_sweep_i16_occupancy(int lanes, int two, int with_tb, int ppb, int twin_bytes, int threads,
                                      int* regs, int* local_bytes, int* blocks_per_sm, int* smem_bytes) {
  const void* fn = i16_fn(lanes, two != 0, with_tb != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ppb * twin_bytes;
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)(attr.sharedSizeBytes + smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, smem);
}
