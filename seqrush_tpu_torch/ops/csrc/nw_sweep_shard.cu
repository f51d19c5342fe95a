// Kernel A's sharded mode: one pair's band split by lanes over D shards.
//
// The counterpart of the XLA program seqrush_tpu/parallel/bandshard.py::
// _build_sharded_sweep (its per-shard function local_fn under shard_map, one
// shard a device, a one-lane halo exchange by ppermute per anti-diagonal).
// Shard d holds lanes [d * Wl, (d + 1) * Wl) of the band's W = D * Wl; an
// anti-diagonal's cell reads lanes l + dp - 1 and l + dp of the previous
// rows, so each step needs one column of the DP rows from one neighbour:
// the left one's last lane where dp = 0, the right one's first lane where
// dp = 1, INF at the band's edges.  The arithmetic is that program's, the
// int32 recurrence of _sweep_v3 without clamps and without validity masks
// (off-matrix cells hold whatever the recurrence computes there), so the
// strips equal its traceback byte for byte; the plain version is
// ops/nw_cuda.py::nw_align_sharded_reference.
//
// What bounds it on an H100: the anti-diagonal chain.  No lane can take
// step t before both its neighbours hold step t - 1, so a step costs the
// latency of its own chain: a thread's lanes issued one after another (a
// few dozen integer instructions each, on warps that share an SM's four
// schedulers), the edge lane's dependent minima, one column exchanged and
// one synchronisation of every CTA that holds the band.  A bound of bytes or
// instructions sees none of that latency; the design keeps the chain short:
//   * a pair's band runs on thread-block clusters.  The CTAs of a device
//     hold its shards' lanes in order, ctas_per_shard CTAs a shard (CTA c of
//     a shard owns units [c * U / C, (c + 1) * U / C) of its U = Wl / S
//     units of S lanes), and `cluster` consecutive CTAs form one cluster, so
//     where the planner can, all of a device's shards of a pair sit in one
//     cluster and an edge between two shards is an edge between two CTAs;
//   * the lanes live in registers, as on kernel A's register route
//     (nw_sweep.cuh): thread r owns S contiguous lanes (S divides Wl, so a
//     thread's lanes never straddle a shard; 4 unless Wl is not a multiple
//     of 4).  dp and dpp are uniform over the pair, so each step is compiled
//     for its phase: (0, 0) up to t = K, then (1, 1) and (0, 1) in turn;
//   * a step needs the neighbour column in one direction only (the left one
//     where the next step's dp is 0, the right one where it is 1), three
//     values (H, and I1 and I2 from the left or D1 and D2 from the right).
//     They cross threads by __shfl_up_sync / __shfl_down_sync, warps through
//     a double-buffered shared-memory slot, and CTAs by st.async into a
//     double-buffered slot in the neighbour CTA's shared memory (distributed
//     shared memory, mapa), which completes 16 bytes of that slot's mbarrier;
//     the receiving thread arms the mbarrier and waits on it;
//   * one split cluster barrier a step, which paces the slots' reuse: a
//     thread publishes its column, arrives (barrier.cluster.arrive.relaxed
//     after a CTA-scope fence), computes the S - 1 lanes of the next step
//     that need no neighbour, waits (barrier.cluster.wait, acquire), reads
//     its column and computes the last lane.  A release arrive (or a
//     cluster-scope fence) would wait on every step for all the stores in
//     flight, the traceback rows among them; the st.async columns need no
//     release, their mbarriers carry their completion;
//   * between clusters (shards on distinct devices, or a device whose CTAs
//     need more than one cluster) the cluster's end threads (thread 0 of
//     rank 0, the last real thread of the last rank) keep the ring-and-flag
//     protocol through global memory: each end owns a record (two slots of
//     three values and a flag, the count of steps it has finished); before
//     it overwrites slot t & 1 it waits until its peer has finished step t -
//     1, and a reader waits until the writer has finished step t.  Flags are
//     read with volatile loads and raised after a fence of the device's
//     scope (the system's across devices); a wait longer than 20 s traps, so
//     a lost neighbour fails the launch instead of hanging it;
//   * the query and reversed-target bases a CTA reads sit in two ring
//     buffers in shared memory, filled a tile of kTile anti-diagonals ahead:
//     at a tile's first step each thread loads its share of the next tile's
//     new bases from global memory into registers, and stores them into the
//     rings half a tile later, so no step waits on a global load; each
//     thread slides a register window of S bases of each by one base a step;
//   * each thread stores its S traceback bytes of a row in one store;
//   * the DP's H choice compares plainly: the values are unclamped and drift
//     above INF off the matrix, so kernel A's keys value * 8 + tag do not
//     fit.  A gap state and its opened bit is one __vibmin_s32;
//   * the wrapper pads each CTA's shared memory so that one CTA holds an SM,
//     and launches every cluster at once (cudaLaunchKernelEx with a cluster
//     dimension), after cudaOccupancyMaxActiveClusters has said that all of
//     the launch's clusters are resident together: every cluster of a pair
//     spins on its neighbours.
// The exchange, the barrier, the ring-and-flag protocol and the rings are
// nw_cluster.cuh's, shared with kernel A's wide route (nw_sweep_wide.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "nw_cluster.cuh"

// threads a CTA at most: 512 leave each thread 128 registers (at 1,024 the
// 1- and 2-lane builds spill)
constexpr int kMaxThreads = 512;

struct ShardArgs {
  const uint8_t* Q;  // [B, Lq] query codes, QPAD-padded
  const uint8_t* T;  // [B, Lt] target codes, TPAD-padded
  const int* qlens;
  const int* tlens;
  int* scores;                         // [B], -1 where no lane of this launch sets it
  uint8_t* strips;                     // [n_local, B, t_total + 1, Wl]
  const unsigned long long* table;     // 2 record pointers a cluster of the band
  int B, Lq, Lt, W, Wl, d_lo, t_total;
  int ctas_per_shard, clusters_per_pair, gc_base, gc_total;
  int qring, tring;                    // ring buffer bytes (powers of two)
  int sys;
  int mismatch, o1, e1, o2, e2;
};

// What a thread knows of its place: uniform over the CTA but for g0, r and
// the lane bits.
struct Ctx {
  const uint8_t* q;
  const uint8_t* tg;
  int Lq, Lt, W, K, qlen, tlen, t_final, t_total;
  int g0;         // the band's lane of the thread's first lane
  int a0, span;   // the CTA's first lane and its real lanes
  int r, lane, warp, nw, nreal;
  bool has_left_cta, has_right_cta;  // a neighbour CTA in the cluster
  bool left_end, right_end;          // this thread is a cluster end with a peer cluster
  bool sys;
  int* lw;   // [2][nw][3]: warp w's left column, for its lane 0 (w > 0)
  int* rw;   // [2][nw][3]: warp w's right column, for its lane 31
  const int* slot_l;  // [2][4]: thread 0's column from the left CTA
  const int* slot_r;  // [2][4]: the last real thread's column from the right CTA
  uint32_t bar_l, bar_r;  // their mbarriers [2] (shared::cta addresses)
  uint32_t to_r, to_r_bar;  // the right CTA's slot_l and its mbarriers
  uint32_t to_l, to_l_bar;  // the left CTA's slot_r and its mbarriers
  int* my_left;        // records this thread publishes into (left / right end)
  int* my_right;
  const int* peer_left;   // the left cluster's right-end record
  const int* peer_right;  // the right cluster's left-end record
  uint8_t* tb;   // the thread's first byte of row 0 of its strip
  int Wl;
  int* score;
  uint8_t* Qr;
  uint8_t* Tr;
  int qmask, tmask;
  int t1;   // the first anti-diagonal (1)
  int neg;  // beyond the band's edges: INF
};

struct Pen32 {
  int mis, oe1, e1, oe2, e2;
};

// One cell of lane k, from its neighbours at the step's shifts: the new
// states and the packed traceback byte choice | i1o<<3 | i2o<<4 | d1o<<5 |
// d2o<<6.  Unclamped: ties in the gap states keep the opening (a <= c),
// H's strict '<' in the order D1, I1, D2, I2 keeps the earlier choice, and
// one-piece scoring still offers I2 = D2 = INF, as the reference does.
template <int S, bool TWO, int DP, int DPP>
__device__ __forceinline__ void shard_cell(const Lanes<S>& L, const Edge& e, const Pen32& p, int k, int& Hn,
                                     int& I1n, int& D1n, int& I2n, int& D2n, uint32_t& byte) {
  const int h_up = DP ? L.h1[k] : (k ? L.h1[k - 1] : e.hl1);
  const int h_left = DP ? (k < S - 1 ? L.h1[k + 1] : e.hr1) : L.h1[k];
  const int h_diag = DPP ? L.h2[k] : (k ? L.h2[k - 1] : e.hl2);
  const int i1_up = DP ? L.i1[k] : (k ? L.i1[k - 1] : e.i1l);
  const int d1_left = DP ? (k < S - 1 ? L.d1[k + 1] : e.d1r) : L.d1[k];
  const int sub = L.qw[k] == L.tw[k] ? 0 : p.mis;
  bool op;
  I1n = __vibmin_s32(h_up + p.oe1, i1_up + p.e1, &op);
  uint32_t b = op ? 8u : 0u;
  D1n = __vibmin_s32(h_left + p.oe1, d1_left + p.e1, &op);
  b |= op ? 32u : 0u;
  I2n = NW_INF;
  D2n = NW_INF;
  if (TWO) {
    const int i2_up = DP ? L.i2[k] : (k ? L.i2[k - 1] : e.i2l);
    const int d2_left = DP ? (k < S - 1 ? L.d2[k + 1] : e.d2r) : L.d2[k];
    I2n = __vibmin_s32(h_up + p.oe2, i2_up + p.e2, &op);
    b |= op ? 16u : 0u;
    D2n = __vibmin_s32(h_left + p.oe2, d2_left + p.e2, &op);
    b |= op ? 64u : 0u;
  }
  int H = h_diag + sub;
  uint32_t ch = 0;
  if (D1n < H) { H = D1n; ch = 1; }
  if (I1n < H) { H = I1n; ch = 2; }
  if (D2n < H) { H = D2n; ch = 3; }
  if (I2n < H) { H = I2n; ch = 4; }
  Hn = H;
  byte = b | ch;
}

// Anti-diagonal t: slide the bases, compute the lanes that need no
// neighbour column while the barrier of step t - 1 completes, then the edge
// lane; store the row, take the score, publish for step t + 1 and arrive.
template <int S, bool TWO, int DP, int DPP, int DPN>
__device__ __forceinline__ void shard_step(Lanes<S>& L, Edge& e, const Ctx& c, const Pen32& p, int t,
                                        int& qs, int& ts, int (&pre)[kStage]) {
  const int i0 = i0_of(t, c.K);
  if (t > 1) {
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
  constexpr int KE = DP ? S - 1 : 0;  // the lane that reads the neighbour column
  int nh[S], ni1[S], nd1[S], ni2[S], nd2[S];
  uint32_t byte[S];
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (k != KE) shard_cell<S, TWO, DP, DPP>(L, e, p, k, nh[k], ni1[k], nd1[k], ni2[k], nd2[k], byte[k]);
  cluster_wait();
  read_edges<TWO, DP>(e, c, t);
  shard_cell<S, TWO, DP, DPP>(L, e, p, KE, nh[KE], ni1[KE], nd1[KE], ni2[KE], nd2[KE], byte[KE]);
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
  if (c.r < c.nreal) {
    uint32_t w = 0;  // S <= 4 bytes
#pragma unroll
    for (int k = 0; k < S; ++k) w |= byte[k] << (8 * k);
    uint8_t* row = c.tb + (size_t)t * c.Wl;
    if constexpr (S == 4)
      *reinterpret_cast<uint32_t*>(row) = w;
    else if constexpr (S == 2)
      *reinterpret_cast<uint16_t*>(row) = (uint16_t)w;
    else
      *row = (uint8_t)w;
    if (t == c.t_final) {
      const int fl = c.qlen - i0 - c.g0;
#pragma unroll
      for (int k = 0; k < S; ++k)
        if (k == fl && nh[k] < NW_INF) *c.score = nh[k];
    }
  }
  if (t < c.t_total) publish<S, TWO, DPN>(L, e, c, t);  // nobody reads the last step's column
  cluster_arrive();
}

template <int S, bool TWO>
__global__ void __launch_bounds__(kMaxThreads) nw_sweep_cluster(const ShardArgs a) {
  extern __shared__ __align__(16) int shard_smem[];
  const int CS = (int)cluster_ctas();
  const int rank = (int)cluster_rank();
  const int cl = blockIdx.x / CS;
  const int b = cl / a.clusters_per_pair;
  const int m = cl % a.clusters_per_pair;
  const int ci = m * CS + rank;  // the CTA's place among the device's CTAs of the pair
  const int C = a.ctas_per_shard;
  const int ls = ci / C;
  const int cc = ci % C;
  const int U = a.Wl / S;
  const int u0 = (int)((long long)cc * U / C);
  const int u1 = (int)((long long)(cc + 1) * U / C);
  const int gc = a.gc_base + m;

  Ctx c;
  c.Lq = a.Lq;
  c.Lt = a.Lt;
  c.W = a.W;
  c.K = a.W - 1;
  c.qlen = a.qlens[b];
  c.tlen = a.tlens[b];
  c.t_final = c.qlen + c.tlen;
  c.t_total = a.t_total;
  c.t1 = 1;
  c.neg = NW_INF;
  c.q = a.Q + (size_t)b * a.Lq;
  c.tg = a.T + (size_t)b * a.Lt;
  c.nreal = u1 - u0;
  c.span = c.nreal * S;
  c.a0 = (a.d_lo + ls) * a.Wl + u0 * S;
  c.r = threadIdx.x;
  c.lane = threadIdx.x & 31;
  c.warp = threadIdx.x >> 5;
  c.nw = blockDim.x >> 5;
  c.g0 = c.a0 + c.r * S;
  c.has_left_cta = rank > 0;
  c.has_right_cta = rank < CS - 1;
  c.left_end = rank == 0 && gc > 0 && c.r == 0;
  c.right_end = rank == CS - 1 && gc < a.gc_total - 1 && c.r == c.nreal - 1;
  c.sys = a.sys != 0;
  // shared memory: the mbarriers of the columns from the left and the right
  // CTA [2] each, their slots [2][4] each, the warp slots, the base rings
  uint64_t* bars = reinterpret_cast<uint64_t*>(shard_smem);
  c.bar_l = smem_addr(bars);
  c.bar_r = smem_addr(bars + 2);
  c.slot_l = shard_smem + 8;
  c.slot_r = shard_smem + 16;
  c.lw = shard_smem + 24;
  c.rw = c.lw + 6 * c.nw;
  c.Qr = reinterpret_cast<uint8_t*>(c.rw + 6 * c.nw);
  c.Tr = c.Qr + a.qring;
  c.qmask = a.qring - 1;
  c.tmask = a.tring - 1;
  c.to_r = c.has_right_cta ? map_rank(smem_addr(c.slot_l), rank + 1) : 0u;
  c.to_r_bar = c.has_right_cta ? map_rank(c.bar_l, rank + 1) : 0u;
  c.to_l = c.has_left_cta ? map_rank(smem_addr(c.slot_r), rank - 1) : 0u;
  c.to_l_bar = c.has_left_cta ? map_rank(c.bar_r, rank - 1) : 0u;
  const unsigned long long* tab = a.table;
  c.my_left = c.left_end ? (int*)tab[2 * gc] + b * kRecInts : nullptr;
  c.peer_left = c.left_end ? (const int*)tab[2 * (gc - 1) + 1] + b * kRecInts : nullptr;
  c.my_right = c.right_end ? (int*)tab[2 * gc + 1] + b * kRecInts : nullptr;
  c.peer_right = c.right_end ? (const int*)tab[2 * (gc + 1)] + b * kRecInts : nullptr;
  c.Wl = a.Wl;
  c.tb = a.strips + (size_t)(ls * a.B + b) * (a.t_total + 1) * a.Wl + u0 * S + c.r * S;
  c.score = a.scores + b;
  const Pen32 p{a.mismatch, a.o1 + a.e1, a.e1, a.o2 + a.e2, a.e2};

  if (c.r < c.nreal) {  // row 0 is zero; the origin is the final cell of an empty pair
#pragma unroll
    for (int k = 0; k < S; ++k) c.tb[k] = 0;
    if (c.t_final == 0 && c.g0 == 0) *c.score = 0;
  }
  if (a.t_total == 0) return;

  // the state at t = 0 (H 0 at the band's lane 0) and t = -1
  Lanes<S> L;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    L.h1[k] = c.g0 + k == 0 ? 0 : NW_INF;
    L.h2[k] = NW_INF;
    L.i1[k] = L.d1[k] = L.i2[k] = L.d2[k] = NW_INF;
  }
  Edge e{NW_INF, NW_INF, NW_INF, NW_INF, NW_INF, NW_INF, NW_INF, 0, 0, 0, 0};
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
  int qs = qs_of(1, c), ts = ts_of(1, c);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    L.qw[k] = c.Qr[(qs + c.g0 + k) & c.qmask];
    L.tw[k] = c.Tr[(ts + c.g0 + k) & c.tmask];
  }

  const int ta = min(c.K, a.t_total);  // phase A: t in [1, ta], shifts (0, 0)
  if (ta >= 1)
    publish<S, TWO, 0>(L, e, c, 0);
  else
    publish<S, TWO, 1>(L, e, c, 0);
  cluster_arrive();
  int t = 1;
  for (; t < ta; ++t) shard_step<S, TWO, 0, 0, 0>(L, e, c, p, t, qs, ts, pre);
  if (t == ta) shard_step<S, TWO, 0, 0, 1>(L, e, c, p, t++, qs, ts, pre);
  // phase B: macro-steps of a (1, 1) and a (0, 1) anti-diagonal up to t_total
  for (; t + 1 <= a.t_total; t += 2) {
    shard_step<S, TWO, 1, 1, 0>(L, e, c, p, t, qs, ts, pre);
    shard_step<S, TWO, 0, 1, 1>(L, e, c, p, t + 1, qs, ts, pre);
  }
  cluster_wait();  // no CTA leaves while a neighbour may still write its slots
}

static const void* pick_kernel(int lanes, bool two) {
  switch (lanes) {
    case 4:
      return two ? (const void*)nw_sweep_cluster<4, true> : (const void*)nw_sweep_cluster<4, false>;
    case 2:
      return two ? (const void*)nw_sweep_cluster<2, true> : (const void*)nw_sweep_cluster<2, false>;
    case 1:
      return two ? (const void*)nw_sweep_cluster<1, true> : (const void*)nw_sweep_cluster<1, false>;
    default:
      return nullptr;
  }
}

// Clusters of the sharded mode that can be resident at once on `device` at
// this shape (cudaOccupancyMaxActiveClusters).  Returns the CUDA error code
// (cudaErrorInvalidValue for lanes the library does not build).
extern "C" int nw_sweep_shard_capacity(int device, int two, int lanes, int cluster, int threads, int smem,
                                       int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = pick_kernel(lanes, two != 0);
  if (!fn) return (int)cudaErrorInvalidValue;
  err = prepare_cluster(fn, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, cluster, cluster, threads, smem, 0);
  *clusters = 0;
  return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
}

// Let `device` read and write `peer`'s memory (already enabled is fine).
extern "C" int nw_sweep_shard_peer(int device, int peer) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return (int)cudaSuccess;
  }
  return (int)err;
}

// One launch of shards [d_lo, d_lo + n_local) of a D-shard sweep on
// `device`: B x clusters_per_pair clusters of `cluster` CTAs of `threads`
// threads and `smem` bytes of dynamic shared memory, ctas_per_shard CTAs a
// shard, lanes S a thread.  table: 2 x gc_total record pointers (the left
// and the right end of each cluster of the band, [B, 8] int32 each,
// zeroed), as int64, readable from `device`; this device's clusters are
// gc_base .. gc_base + clusters_per_pair - 1.  multi selects system-scope
// fences (shards on several devices).  Returns the CUDA error code.
extern "C" int nw_sweep_shard_launch(const void* Q, const void* T, const void* qlens, const void* tlens,
                                     void* scores, void* strips, const void* table, int device, int multi,
                                     int B, int Lq, int Lt, int W, int D, int d_lo, int t_total, int mismatch,
                                     int o1, int e1, int o2, int e2, int lanes, int ctas_per_shard,
                                     int cluster, int clusters_per_pair, int gc_base, int gc_total,
                                     int threads, int smem, int qring, int tring, void* stream) {
  if (B <= 0 || clusters_per_pair <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = pick_kernel(lanes, o2 >= 0);
  if (!fn) return (int)cudaErrorInvalidValue;
  err = prepare_cluster(fn, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  ShardArgs a{(const uint8_t*)Q, (const uint8_t*)T, (const int*)qlens, (const int*)tlens,
              (int*)scores, (uint8_t*)strips, (const unsigned long long*)table,
              B, Lq, Lt, W, W / D, d_lo, t_total, ctas_per_shard, clusters_per_pair, gc_base, gc_total,
              qring, tring, multi, mismatch, o1, e1, o2, e2};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, B * clusters_per_pair * cluster, cluster, threads, smem, (cudaStream_t)stream);
  void* args[] = {&a};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}