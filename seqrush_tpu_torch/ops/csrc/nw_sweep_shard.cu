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

#include <cuda_runtime.h>
#include <stdint.h>

#include "nw_sweep.cuh"

constexpr int kRecInts = 8;  // a record: slot[2][3], the flag, a pad
constexpr int kFlag = 6;
constexpr int kTile = 128;   // anti-diagonals a tile of staged bases
constexpr int kStage = 7;    // a thread's share of a tile's new bases, at most

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

static __device__ __forceinline__ int load_volatile(const int* p) {
  return *(const volatile int*)p;
}

static __device__ __forceinline__ void store_volatile(int* p, int v) { *(volatile int*)p = v; }

static __device__ __forceinline__ void fence(bool sys) {
  if (sys)
    __threadfence_system();
  else
    __threadfence();
}

static __device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// spin until a peer's flag reaches `want`; what it wrote before raising the
// flag is visible afterwards.  A peer that never gets there (a cluster that
// is not resident, a fault elsewhere) ends the kernel with a trap after
// kSpinLimitNs instead of hanging the card
constexpr unsigned long long kSpinLimitNs = 20ull * 1000 * 1000 * 1000;

static __device__ __forceinline__ void wait_flag(const int* flag, int want, bool sys) {
  if (load_volatile(flag) < want) {
    const unsigned long long t0 = global_ns();
    while (load_volatile(flag) < want) {
      if (global_ns() - t0 > kSpinLimitNs) __trap();
    }
  }
  fence(sys);
}

static __device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

static __device__ __forceinline__ unsigned cluster_ctas() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// A step's arrive.  What a thread wrote into its own CTA's shared memory
// (a warp's edge slot, staged bases) is ordered before it by a CTA-scope
// fence; the columns that cross CTAs travel by st.async, whose arrival the
// receiver's mbarrier tracks, so the arrive itself is relaxed: a release at
// cluster scope would wait for every store in flight (the traceback rows
// too) on every anti-diagonal.
static __device__ __forceinline__ void cluster_arrive() {
  __threadfence_block();
  __syncwarp();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

static __device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// the start: every CTA of the cluster runs and sees the others' mbarriers
static __device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the address of this CTA's shared-memory word `local` in CTA `rank`'s
static __device__ __forceinline__ uint32_t map_rank(uint32_t local, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

static __device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// the receiver's arrive for one column: its own arrival and the 16 bytes
// the sender's st.async completes
static __device__ __forceinline__ void mbar_arm(uint32_t bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], 16;\n}" ::"r"(bar)
      : "memory");
}

static __device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the column of phase `parity`; a column that never comes traps
// after kSpinLimitNs, as a lost flag does
static __device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > kSpinLimitNs) __trap();
  }
}

// three values into a neighbour CTA's slot, completing 16 bytes of its mbarrier
static __device__ __forceinline__ void st_async3(uint32_t slot, uint32_t bar, int a, int b, int c) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(
          slot),
      "r"(a), "r"(b), "r"(c), "r"(0), "r"(bar)
      : "memory");
}

template <int S>
struct Lanes {
  int h1[S], h2[S], i1[S], d1[S], i2[S], d2[S];  // H at t - 1 and t - 2, the gap states at t - 1
  int qw[S], tw[S];                              // bases under the lanes
};

// the neighbour columns: H(t-1), H(t-2), I1, I2 (t-1) at lane g0 - 1, and
// H(t-1), D1, D2 (t-1) at lane g0 + S; and the columns a CTA edge thread
// has received from the left and the right CTA and sent to each (the k-th
// column of a direction travels in slot k & 1, in phase k >> 1 of its
// mbarrier)
struct Edge {
  int hl1, hl2, i1l, i2l, hr1, d1r, d2r;
  int in_l, in_r, out_r, out_l;
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
};

static __device__ __forceinline__ int qs_of(int t, const Ctx& c) {
  return min(i0_of(t, c.K), c.Lq + 1);
}

static __device__ __forceinline__ int ts_of(int t, const Ctx& c) {
  return max(0, min(c.Lt - t + i0_of(t, c.K) + c.W, c.Lt + c.W));
}

// the bases at padded-operand positions: [QPAD] + q + [QPAD]*W and
// [TPAD]*W + reverse(tg) + [TPAD]*W
static __device__ __forceinline__ int qbase(int x, const Ctx& c) {
  return (x >= 1 && x <= c.Lq) ? (int)c.q[x - 1] : NW_QPAD;
}

static __device__ __forceinline__ int tbase(int y, const Ctx& c) {
  return (y >= c.W && y < c.W + c.Lt) ? (int)c.tg[c.Lt - 1 - (y - c.W)] : NW_TPAD;
}

// The new bases of tile k + 1 (anti-diagonals from 1 + (k + 1) * kTile):
// query positions (hq, hq + nq] past what tile k staged and target
// positions [lt, lt + nt) below it.
struct TileNew {
  int hq, nq, lt, nt;
};

static __device__ __forceinline__ TileNew tile_new(int k, const Ctx& c) {
  const int e0 = (k + 1) * kTile;
  const int e1 = min(e0 + kTile, c.t_total);
  TileNew n;
  n.hq = qs_of(e0, c) + c.a0 + c.span - 1;
  n.nq = qs_of(e1, c) + c.a0 + c.span - 1 - n.hq;
  const int lt0 = ts_of(e0, c) + c.a0;
  n.lt = ts_of(e1, c) + c.a0;
  n.nt = lt0 - n.lt;
  return n;
}

// A tile's first step loads the next tile's new bases (thread r takes
// entries r, r + threads, ...) into registers; half a tile later they go
// into the rings.  The rings hold a tile and a half of bases beyond a CTA's
// span, so nothing tile k still reads is overwritten.
static __device__ __forceinline__ void stage_step(int t, const Ctx& c, int (&pre)[kStage]) {
  const int k = (t - 1) / kTile;
  const int o = (t - 1) - k * kTile;
  if (o != 0 && o != kTile / 2) return;
  if (1 + (k + 1) * kTile > c.t_total) return;  // no next tile
  const TileNew n = tile_new(k, c);
  const int threads = c.nw * 32;
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
    const int j = c.r + i * threads;
    if (o == 0) {
      if (j < n.nq)
        pre[i] = qbase(n.hq + 1 + j, c);
      else if (j < n.nq + n.nt)
        pre[i] = tbase(n.lt + j - n.nq, c);
    } else {
      if (j < n.nq)
        c.Qr[(n.hq + 1 + j) & c.qmask] = (uint8_t)pre[i];
      else if (j < n.nq + n.nt)
        c.Tr[(n.lt + j - n.nq) & c.tmask] = (uint8_t)pre[i];
    }
  }
}

// tile 0's bases, staged by every thread before the sweep starts
static __device__ __forceinline__ void stage_first(const Ctx& c) {
  const int e = min(kTile, c.t_total);
  const int q0 = qs_of(1, c) + c.a0;
  const int nq = qs_of(e, c) + c.a0 + c.span - q0;
  const int t0 = ts_of(e, c) + c.a0;
  const int nt = ts_of(1, c) + c.a0 + c.span - t0;
  for (int j = c.r; j < nq + nt; j += c.nw * 32) {
    if (j < nq)
      c.Qr[(q0 + j) & c.qmask] = (uint8_t)qbase(q0 + j, c);
    else
      c.Tr[(t0 + j - nq) & c.tmask] = (uint8_t)tbase(t0 + j - nq, c);
  }
}

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

// Ring end: wait until the peer has finished step t - 1 (so it has read
// slot t & 1's step t - 2), put the column (if any) into slot t & 1, raise
// the flag to t + 1.
static __device__ __forceinline__ void ring_publish(int* rec, const int* peer, int t, bool col, int v0,
                                                    int v1, int v2, bool sys) {
  wait_flag(peer + kFlag, t, sys);
  if (col) {
    int* s = rec + (t & 1) * 3;
    store_volatile(s, v0);
    store_volatile(s + 1, v1);
    store_volatile(s + 2, v2);
  }
  fence(sys);
  store_volatile(rec + kFlag, t + 1);
}

// the peer's column of step t - 1
static __device__ __forceinline__ void ring_read(const int* peer, int t, bool sys, int& v0, int& v1,
                                                 int& v2) {
  wait_flag(peer + kFlag, t, sys);
  const int* s = peer + ((t - 1) & 1) * 3;
  v0 = load_volatile(s);
  v1 = load_volatile(s + 1);
  v2 = load_volatile(s + 2);
}

// After step t: hand the column the next step needs (DPN: its dp) to the
// neighbour threads, warps, CTAs and clusters, each into slot t & 1.
template <int S, bool TWO, int DPN>
__device__ __forceinline__ void publish(const Lanes<S>& L, Edge& e, const Ctx& c, int t) {
  const int par = t & 1;
  if (DPN == 0) {  // the next step reads the left neighbour's last lane
    const int h = L.h1[S - 1], i1 = L.i1[S - 1], i2 = TWO ? L.i2[S - 1] : NW_INF;
    e.hl2 = e.hl1;
    e.hl1 = __shfl_up_sync(FULL_MASK, h, 1);
    e.i1l = __shfl_up_sync(FULL_MASK, i1, 1);
    if (TWO) e.i2l = __shfl_up_sync(FULL_MASK, i2, 1);
    if (c.r == c.nreal - 1) {
      if (c.has_right_cta) {
        const int k = e.out_r++ & 1;
        st_async3(c.to_r + 16 * k, c.to_r_bar + 8 * k, h, i1, i2);
      }
    } else if (c.lane == 31 && c.r < c.nreal) {
      int* s = c.lw + (par * c.nw + c.warp + 1) * 3;
      s[0] = h;
      s[1] = i1;
      s[2] = i2;
    }
  } else {  // the next step reads the right neighbour's first lane
    const int h = L.h1[0], d1 = L.d1[0], d2 = TWO ? L.d2[0] : NW_INF;
    e.hr1 = __shfl_down_sync(FULL_MASK, h, 1);
    e.d1r = __shfl_down_sync(FULL_MASK, d1, 1);
    if (TWO) e.d2r = __shfl_down_sync(FULL_MASK, d2, 1);
    if (c.r == 0) {
      if (c.has_left_cta) {
        const int k = e.out_l++ & 1;
        st_async3(c.to_l + 16 * k, c.to_l_bar + 8 * k, h, d1, d2);
      }
    } else if (c.lane == 0 && c.r < c.nreal) {
      int* s = c.rw + (par * c.nw + c.warp - 1) * 3;
      s[0] = h;
      s[1] = d1;
      s[2] = d2;
    }
  }
  // the cluster's ends raise their flags every step, with a column or not
  if (c.left_end)
    ring_publish(c.my_left, c.peer_left, t, DPN == 1, L.h1[0], L.d1[0], TWO ? L.d2[0] : NW_INF, c.sys);
  if (c.right_end)
    ring_publish(c.my_right, c.peer_right, t, DPN == 0, L.h1[S - 1], L.i1[S - 1],
                 TWO ? L.i2[S - 1] : NW_INF, c.sys);
}

// Before step t (after the barrier): the column from outside the warp, for
// the threads at a warp's, a CTA's or a cluster's edge.
template <bool TWO, int DP>
__device__ __forceinline__ void read_edges(Edge& e, const Ctx& c, int t) {
  const int par = (t - 1) & 1;
  int v0 = NW_INF, v1 = NW_INF, v2 = NW_INF;
  if (DP == 0) {
    if (c.lane != 0) return;
    if (c.r == 0) {
      if (c.has_left_cta) {
        const int k = e.in_l++;
        mbar_arm(c.bar_l + 8 * (k & 1));
        mbar_wait(c.bar_l + 8 * (k & 1), (k >> 1) & 1);
        const int* s = c.slot_l + 4 * (k & 1);
        v0 = s[0], v1 = s[1], v2 = s[2];
      } else if (c.left_end) {
        ring_read(c.peer_left, t, c.sys, v0, v1, v2);
      }
    } else {
      const int* s = c.lw + (par * c.nw + c.warp) * 3;
      v0 = s[0], v1 = s[1], v2 = s[2];
    }
    e.hl1 = v0;
    e.i1l = v1;
    if (TWO) e.i2l = v2;
  } else {
    if (c.r == c.nreal - 1) {
      if (c.has_right_cta) {
        const int k = e.in_r++;
        mbar_arm(c.bar_r + 8 * (k & 1));
        mbar_wait(c.bar_r + 8 * (k & 1), (k >> 1) & 1);
        const int* s = c.slot_r + 4 * (k & 1);
        v0 = s[0], v1 = s[1], v2 = s[2];
      } else if (c.right_end) {
        ring_read(c.peer_right, t, c.sys, v0, v1, v2);
      }
    } else if (c.lane == 31) {
      const int* s = c.rw + (par * c.nw + c.warp) * 3;
      v0 = s[0], v1 = s[1], v2 = s[2];
    } else {
      return;
    }
    e.hr1 = v0;
    e.d1r = v1;
    if (TWO) e.d2r = v2;
  }
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

static cudaError_t prepare(const void* fn, int cluster, int smem) {
  cudaError_t err = allow_smem(fn, (size_t)smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

static void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int blocks, int cluster,
                           int threads, int smem, cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr = cudaLaunchAttribute{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
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
  err = prepare(fn, cluster, smem);
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
  err = prepare(fn, cluster, smem);
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
