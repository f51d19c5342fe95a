// Kernel A's cluster machinery: what the sharded mode (nw_sweep_shard.cu)
// and the wide route (nw_sweep_wide.cuh) share to run one pair's band on
// thread-block clusters with its lanes in registers.
//
//   * the neighbour column of a step crosses threads by __shfl_up_sync /
//     __shfl_down_sync, warps through a double-buffered shared-memory slot,
//     CTAs by st.async into a double-buffered slot in the neighbour CTA's
//     shared memory (distributed shared memory, mapa), which completes 16
//     bytes of that slot's mbarrier; the receiving thread arms the mbarrier
//     and waits on it (publish, read_edges);
//   * one split cluster barrier a step (cluster_arrive, cluster_wait): a
//     thread publishes its column, arrives relaxed after a CTA-scope fence,
//     computes the lanes that need no neighbour, waits, reads its column
//     and computes the last lane;
//   * between clusters the cluster's end threads keep a ring-and-flag
//     protocol through global memory (ring_publish, ring_read): each end
//     owns a record (two slots of three values and a flag, the count of
//     steps it has finished); a wait longer than 20 s traps;
//   * the query and reversed-target bases a CTA reads sit in two ring
//     buffers in shared memory, filled a tile of kTile anti-diagonals ahead
//     (stage_first, stage_step).
// The design notes are in nw_sweep_shard.cu and nw_sweep_wide.cuh.  The
// functions over a context take any struct with the fields they name, so
// each kernel keeps its own (Ctx, WideCtx).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "nw_sweep.cuh"

constexpr int kRecInts = 8;  // a record: slot[2][3], the flag, a pad
constexpr int kFlag = 6;
constexpr int kTile = 128;   // anti-diagonals a tile of staged bases
constexpr int kStage = 7;    // a thread's share of a tile's new bases, at most

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

// -- staged bases --------------------------------------------------------------
// A context C names: q, tg (the pair's query and target), Lq, Lt, W, K,
// a0 and span (the CTA's first lane and its real lanes), t1 (the first
// anti-diagonal the sweep steps), t_total (the last one), r, nw (the
// thread and the CTA's warps), Qr, Tr, qmask, tmask (the rings).

template <class C>
static __device__ __forceinline__ int qs_of(int t, const C& c) {
  return min(i0_of(t, c.K), c.Lq + 1);
}

template <class C>
static __device__ __forceinline__ int ts_of(int t, const C& c) {
  return max(0, min(c.Lt - t + i0_of(t, c.K) + c.W, c.Lt + c.W));
}

// the bases at padded-operand positions: [QPAD] + q + [QPAD]*W and
// [TPAD]*W + reverse(tg) + [TPAD]*W
template <class C>
static __device__ __forceinline__ int qbase(int x, const C& c) {
  return (x >= 1 && x <= c.Lq) ? (int)c.q[x - 1] : NW_QPAD;
}

template <class C>
static __device__ __forceinline__ int tbase(int y, const C& c) {
  return (y >= c.W && y < c.W + c.Lt) ? (int)c.tg[c.Lt - 1 - (y - c.W)] : NW_TPAD;
}

// The new bases of tile k + 1 (anti-diagonals from t1 + (k + 1) * kTile):
// query positions (hq, hq + nq] past what tile k staged and target
// positions [lt, lt + nt) below it.
struct TileNew {
  int hq, nq, lt, nt;
};

template <class C>
static __device__ __forceinline__ TileNew tile_new(int k, const C& c) {
  const int e0 = c.t1 - 1 + (k + 1) * kTile;
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
template <class C>
static __device__ __forceinline__ void stage_step(int t, const C& c, int (&pre)[kStage]) {
  const int k = (t - c.t1) / kTile;
  const int o = (t - c.t1) - k * kTile;
  if (o != 0 && o != kTile / 2) return;
  if (c.t1 + (k + 1) * kTile > c.t_total) return;  // no next tile
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
template <class C>
static __device__ __forceinline__ void stage_first(const C& c) {
  const int e = min(c.t1 - 1 + kTile, c.t_total);
  const int q0 = qs_of(c.t1, c) + c.a0;
  const int nq = qs_of(e, c) + c.a0 + c.span - q0;
  const int t0 = ts_of(e, c) + c.a0;
  const int nt = ts_of(c.t1, c) + c.a0 + c.span - t0;
  for (int j = c.r; j < nq + nt; j += c.nw * 32) {
    if (j < nq)
      c.Qr[(q0 + j) & c.qmask] = (uint8_t)qbase(q0 + j, c);
    else
      c.Tr[(t0 + j - nq) & c.tmask] = (uint8_t)tbase(t0 + j - nq, c);
  }
}

// -- the neighbour columns -----------------------------------------------------
// A context C names: r, lane, warp, nw, nreal (the CTA's real threads),
// has_left_cta, has_right_cta, left_end, right_end, sys, lw, rw (the warp
// slots), slot_l, slot_r, bar_l, bar_r, to_r, to_r_bar, to_l, to_l_bar (the
// CTA slots and their mbarriers), my_left, my_right, peer_left, peer_right
// (the ring records), and neg (the value beyond the band's edges).

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

// After step t (the count of steps since the sweep's start, 0 for its
// initial state): hand the column the next step needs (DPN: its dp) to the
// neighbour threads, warps, CTAs and clusters, each into slot t & 1.
template <int S, bool TWO, int DPN, class C>
__device__ __forceinline__ void publish(const Lanes<S>& L, Edge& e, const C& c, int t) {
  const int par = t & 1;
  if (DPN == 0) {  // the next step reads the left neighbour's last lane
    const int h = L.h1[S - 1], i1 = L.i1[S - 1], i2 = TWO ? L.i2[S - 1] : c.neg;
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
    const int h = L.h1[0], d1 = L.d1[0], d2 = TWO ? L.d2[0] : c.neg;
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
    ring_publish(c.my_left, c.peer_left, t, DPN == 1, L.h1[0], L.d1[0], TWO ? L.d2[0] : c.neg, c.sys);
  if (c.right_end)
    ring_publish(c.my_right, c.peer_right, t, DPN == 0, L.h1[S - 1], L.i1[S - 1],
                 TWO ? L.i2[S - 1] : c.neg, c.sys);
}

// Before step t (after the barrier): the column from outside the warp, for
// the threads at a warp's, a CTA's or a cluster's edge (c.neg beyond the
// band's edges).
template <bool TWO, int DP, class C>
__device__ __forceinline__ void read_edges(Edge& e, const C& c, int t) {
  const int par = (t - 1) & 1;
  int v0 = c.neg, v1 = c.neg, v2 = c.neg;
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

// -- launch ----------------------------------------------------------------------

// shared memory above the default and, above 8 CTAs, a non-portable cluster
static cudaError_t prepare_cluster(const void* fn, int cluster, int smem) {
  cudaError_t err = allow_smem(fn, (size_t)smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

static void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, dim3 blocks, int cluster,
                           int threads, int smem, cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = blocks;
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
