// The bidirected union-find: a lock-free bulk unite, its compression and
// root lookup over a parent array int32 [n] on the card.
//
// Replaces the XLA programs seqrush_tpu/ops/unionfind.py::unite_edges,
// compress and find (each a jitted lax.while_loop of scatter-min rounds or
// pointer jumps; the port's plain versions are unite_edges_reference,
// compress_reference and find_reference in ops/unionfind.py).  The design
// is the reference's own (uf_rush's CAS unite) with the JAX package's
// deterministic representative:
//
//   uf_unite_kernel     one cooperative launch a unite: the first quarter
//                       of the edges hooked (a grid-stride loop), every slot
//                       compressed, the other edges hooked, every slot
//                       compressed, a grid barrier between each two.  The
//                       first pass joins most of the components' slots
//                       (every pair with the first sequences, in the
//                       pipeline's edge order), and its compress points
//                       every slot at its root, so most of the second
//                       pass's edges end at their first hop.
//     the hook of an edge: both ends' parents are read at once (the first
//                       hop; the warp's lanes hold consecutive edges, so 32
//                       edges of a match run read 8 sectors a side), the
//                       next edge's ends loaded one edge ahead.  Equal
//                       parents put both ends in one tree: the edge is
//                       done, with no chain, store or CAS.  Otherwise both
//                       ends climb to their roots together by path halving,
//                       the loads of both in flight at once, and stop as
//                       soon as their paths meet (one parent); where they
//                       end at two roots, the larger is hooked onto the
//                       smaller with atomicCAS(&parent[hi], hi, lo), and
//                       where the CAS finds hi hooked meanwhile the climb
//                       goes on from the parent it returned.  An edge that
//                       climbed writes where it ended into both its ends'
//                       slots, so later edges at those slots end at their
//                       first hop.  The hook reads the parent through L1
//                       (the only phase that does): the root of a large
//                       component, which every climb that reaches it reads,
//                       is then served by each SM instead of one L2 slice.
//     the compress:     each slot chases to its root and writes it where its
//                       parent was not that root already, so afterwards
//                       parent[i] is the root of i (the JAX compress's
//                       fixpoint).
//   uf_compress_kernel  the compress alone (compress()).
//   uf_find_kernel      the same chase for given positions, into an output;
//                       the parent is only read.
//
// Why it is exact.  A slot that is not a root never becomes one again, and
// only roots are hooked, each onto a slot smaller than itself that was a
// root when it was found (whose root can then only have become smaller), so
// every root at any time is a root of the input forest and the forest stays
// acyclic.  An edge is done only once both its ends are seen in one tree (a
// common ancestor) or its CAS joined their two trees, and later hooks only
// merge trees, so after the hook the trees are the components.  The
// smallest input root of a component is never hooked (that would need a
// smaller slot in it), so it is the component's root: the representative
// the JAX package converges to (from an identity start, the component's
// minimum Pos), whatever order the atomics land in.  Path halving writes
// parent[x] = parent[parent[x]] only at an x it read as no root, and an
// edge's end slots get where the edge ended only where they are no root
// (a root that is not that slot was climbed from or just hooked): each
// write puts an ancestor of x, then or earlier, in place of another, so it
// never undoes a hook, changes a root or closes a cycle.  The hook's reads
// through L1 may return a value another SM has since replaced; it was a
// parent then, so every argument above, which already reads values that
// others may change before they are used, holds: equal ancestors still mean
// one tree, a root so read was a root once (its root only smaller since),
// and the CAS, at L2, hooks only what is a root when it lands.  Each failed
// CAS returns the slot's value from L2, so a climb never loops on a stale
// read.  Each compress starts behind a grid barrier, when no hook runs; a
// slot's own thread writes its root last: the other threads halve through
// that slot with a CAS from the parent they read, which fails once the root
// is written, so no stale ancestor lands after it.  Outside the hook's reads
// parent is read and written through relaxed device-scope atomics (never
// the read-only path: other threads write it during the launch); the edges
// and positions are read-only.  An edge or position outside the parent traps the launch,
// which the next synchronisation reports, as torch's own index checks on
// the card do.
//
// What bounds it on an H100: bytes, the edges read once (8 B an edge, int32
// ends) and the parent read and written once (8 B a slot): 16.0 MB, 0.0048
// ms at the data sheet's 3.35 TB/s, on the headline's flush (NVIDIA H100
// 80GB HBM3, 700.00 W; measured times in PERF.md).  The parent fits in the
// 50 MB L2 up to 6.6 M slots (1,000 haplotypes x 3.3 kb, 26 MB), so its
// traffic is L2 sectors: a scattered 4-byte load or store costs a whole
// 32-byte sector, and each hop of a find is one more sector and one more
// L2 round trip of a few hundred cycles.  The design spends few of both on
// the edges that need no hook, most of a flush's (each end's first hop
// coalesced, the two ends' loads overlapped, no chain past a common
// parent, every slot at its root before the last three quarters of the
// edges), keeps every resident thread busy with its own edges (a grid of
// eight 256-thread blocks an SM), and makes a unite one launch that reads
// nothing back to the host.  Measured, it stays far above that bound
// (PERF.md): its finds' round trips and the grid barriers set its time.
//
// Its own timer (UfTally, compiled in only where UF_TIMED is defined, by the
// timing tool tools/uf_timing.py) counts the hook's finds, hops, halving
// stores and CAS attempts and failures, and records when each warp started
// and ended its edges.

#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int UF_THREADS = 256;
constexpr int UF_BLOCKS_PER_SM = 8;
// the unite hooks the first 1 / UF_FIRST_SHARE of the edges and compresses
// every slot before it hooks the rest (1/8 and 1/16 ran slower at 50 M
// edges, PERF.md)
constexpr long long UF_FIRST_SHARE = 4;

using slot_ref = cuda::atomic_ref<int, cuda::thread_scope_device>;

__device__ __forceinline__ int load(int* parent, int x) {
  return slot_ref(parent[x]).load(cuda::std::memory_order_relaxed);
}

// A parent read of the hook through the SM's L1, which may return a value
// written before another SM's later write: any value it returns was x's
// parent at some time, an ancestor of x then (see the design note).
__device__ __forceinline__ int load_cached(const int* parent, int x) {
  int v;
  asm volatile("ld.global.ca.s32 %0, [%1];" : "=r"(v) : "l"(parent + x));
  return v;
}

__device__ __forceinline__ void store(int* parent, int x, int v) {
  slot_ref(parent[x]).store(v, cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ void check_slot(int x, int n_slots) {
  if ((unsigned)x >= (unsigned)n_slots) __trap();  // an index outside the parent
}

// The hook's own timer: counts summed over the launch in the order of
// UF_COUNT_* (ops/unionfind.py::UF_COUNTS names them).  A find is one end's
// climb; its hops are the parent loads it made, its first hop included.
#define UF_COUNT_EDGES 0
#define UF_COUNT_FIRST_HOP_EQUAL 1
#define UF_COUNT_NO_CAS 2
#define UF_COUNT_FINDS 3
#define UF_COUNT_HOPS 4
#define UF_COUNT_FIND_CYCLES 5
#define UF_COUNT_HALVING_STORES 6
#define UF_COUNT_CAS 7
#define UF_COUNT_CAS_FAILED 8
#define UF_COUNT_MAX_HOPS 9
#define UF_COUNT_COMPRESS_HOPS 10
#define UF_COUNTS 11

__device__ __forceinline__ unsigned long long uf_global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool ON>
struct UfTally {
  __device__ __forceinline__ void add(int, long long = 1) {}
  __device__ __forceinline__ void hops(int) {}
  __device__ __forceinline__ long long clock() { return 0; }
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

template <>
struct UfTally<true> {
  long long c[UF_COUNTS] = {};
  __device__ __forceinline__ void add(int k, long long n = 1) { c[k] += n; }
  // one find of n hops
  __device__ __forceinline__ void hops(int n) {
    c[UF_COUNT_FINDS] += 1;
    c[UF_COUNT_HOPS] += n;
    c[UF_COUNT_MAX_HOPS] = n > c[UF_COUNT_MAX_HOPS] ? n : c[UF_COUNT_MAX_HOPS];
  }
  __device__ __forceinline__ long long clock() { return clock64(); }
  // the warp's sums (and maximum) added to counts by lane 0
  __device__ __forceinline__ void flush(unsigned long long* counts) {
#pragma unroll
    for (int k = 0; k < UF_COUNTS; ++k) {
      long long x = c[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const long long y = __shfl_xor_sync(0xffffffffu, x, o);
        x = k == UF_COUNT_MAX_HOPS ? (y > x ? y : x) : x + y;
      }
      c[k] = x;
    }
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < UF_COUNTS; ++k) {
        if (k == UF_COUNT_MAX_HOPS)
          atomicMax(counts + k, (unsigned long long)c[k]);
        else
          atomicAdd(counts + k, (unsigned long long)c[k]);
      }
    }
  }
};

// One edge (sa, sb) of the hook (see the design note): both first hops at
// once; equal parents end it there; otherwise both ends climb together,
// halving, to a common parent or two roots, the larger root hooked onto the
// smaller by CAS; an edge that climbed writes where it ended into both its
// ends' slots.
template <bool TIMED>
__device__ __forceinline__ void hook_edge(int* parent, int sa, int sb, UfTally<TIMED>& tally) {
  const int fa = load_cached(parent, sa), fb = load_cached(parent, sb);
  tally.add(UF_COUNT_EDGES);
  if (fa == fb) {  // one tree: done with no chain, store or CAS
    tally.add(UF_COUNT_FIRST_HOP_EQUAL);
    tally.add(UF_COUNT_NO_CAS);
    tally.hops(1);
    tally.hops(1);
    return;
  }
  int a = sa, b = sb, pa = fa, pb = fb;  // each end and its parent as last read: a root where pa == a
  int na = 1, nb = 1;                    // hops of each end's find (timer)
  bool cas = false;
  const long long c0 = tally.clock();
  int end;  // where the edge ended: a common ancestor of both ends
  while (true) {
    if (pa == pb) {
      end = pa;
      break;
    }
    if (pa == a && pb == b) {
      // two roots: hook the larger onto the smaller
      const int hi = a > b ? a : b;
      const int lo = a > b ? b : a;
      int expected = hi;
      cas = true;
      tally.add(UF_COUNT_CAS);
      if (slot_ref(parent[hi]).compare_exchange_strong(expected, lo, cuda::std::memory_order_relaxed)) {
        end = lo;
        break;
      }
      tally.add(UF_COUNT_CAS_FAILED);
      // hi was hooked onto `expected` meanwhile: climb on from there, and
      // from lo, a root when it was found (its root can only be smaller)
      a = hi;
      pa = expected;
      b = lo;
      pb = lo;
      continue;
    }
    // one climb step of both ends, halving, their loads in flight together
    const bool ma = pa != a, mb = pb != b;
    const int ga = ma ? load_cached(parent, pa) : pa;
    const int gb = mb ? load_cached(parent, pb) : pb;
    bool la = false, lb = false;  // the end moved past its parent: load the next one
    if (ma) {
      if (ga == pa) {
        a = pa;  // pa is a's root
      } else {
        store(parent, a, ga);  // a is no root: the write never touches one
        tally.add(UF_COUNT_HALVING_STORES);
        a = ga;
        la = true;
      }
    }
    if (mb) {
      if (gb == pb) {
        b = pb;
      } else {
        store(parent, b, gb);
        tally.add(UF_COUNT_HALVING_STORES);
        b = gb;
        lb = true;
      }
    }
    if (la) pa = load_cached(parent, a);
    if (lb) pb = load_cached(parent, b);
    if (TIMED) {
      na += ma + la;
      nb += mb + lb;
    }
  }
  // both ends' slots to where the edge ended: an ancestor of each (no slot
  // written is a root: a root that is not `end` was climbed from or hooked)
  if (sa != end && fa != end) store(parent, sa, end);
  if (sb != end && fb != end) store(parent, sb, end);
  tally.add(UF_COUNT_FIND_CYCLES, tally.clock() - c0);
  tally.hops(na);
  tally.hops(nb);
  tally.add(UF_COUNT_NO_CAS, !cas);
}

// The hook over edges [lo, hi), a thread's e = lo + first, + stride, ...:
// a warp's lanes on consecutive edges, so their ends' first hops read few
// sectors; each edge's ends loaded one edge ahead.
template <bool TIMED>
__device__ __forceinline__ void hook_range(int* parent, const int* __restrict__ u, const int* __restrict__ v,
                                           long long lo, long long hi, int n_slots, long long first,
                                           long long stride, UfTally<TIMED>& tally) {
  long long e = lo + first;
  int nu = 0, nv = 0;  // the next edge's ends
  if (e < hi) {
    nu = __ldg(u + e);
    nv = __ldg(v + e);
  }
  for (; e < hi; e += stride) {
    const int sa = nu, sb = nv;
    if (e + stride < hi) {
      nu = __ldg(u + e + stride);
      nv = __ldg(v + e + stride);
    }
    check_slot(sa, n_slots);
    check_slot(sb, n_slots);
    hook_edge<TIMED>(parent, sa, sb, tally);
  }
}

// Slot i to its root (see the design note on the compress's CAS halving).
template <bool TIMED>
__device__ __forceinline__ void compress_slot(int* parent, int i, UfTally<TIMED>& tally) {
  const int p0 = load(parent, i);
  tally.add(UF_COUNT_COMPRESS_HOPS);
  if (p0 == i) return;
  int x = i, p = p0;
  while (true) {
    const int gp = load(parent, p);
    tally.add(UF_COUNT_COMPRESS_HOPS);
    if (gp == p) {
      x = p;
      break;
    }
    // halve through x only if nobody (x's own thread) wrote its root first
    int expected = p;
    slot_ref(parent[x]).compare_exchange_strong(expected, gp, cuda::std::memory_order_relaxed);
    x = gp;
    p = load(parent, x);
    tally.add(UF_COUNT_COMPRESS_HOPS);
    if (p == x) break;
  }
  if (x != p0) store(parent, i, x);
}

}  // namespace

// The unite (see the design note): the first share of the edges hooked, a
// grid barrier, every slot compressed, a barrier, the other edges hooked, a
// barrier, every slot compressed.  A cooperative launch of at most the grid
// the card holds at once.  Timed: counts (UF_COUNTS slots) and warp_ns (each
// warp's start and the end of its last edge, two slots a warp of the grid).
template <bool TIMED>
__global__ void __launch_bounds__(UF_THREADS, UF_BLOCKS_PER_SM)
uf_unite_kernel(int* parent, const int* __restrict__ u, const int* __restrict__ v, long long n_edges,
                int n_slots, unsigned long long* counts, unsigned long long* warp_ns) {
  UfTally<TIMED> tally;
  const unsigned long long ns0 = TIMED ? uf_global_ns() : 0;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  cg::grid_group grid = cg::this_grid();
  // the hooks' and the compress's writes are relaxed atomics at device
  // scope: each barrier orders them before the next phase's reads
  const long long n_first = n_edges / UF_FIRST_SHARE;
  if (n_first > 0) {
    hook_range<TIMED>(parent, u, v, 0, n_first, n_slots, first, stride, tally);
    grid.sync();
    for (long long k = first; k < n_slots; k += stride) compress_slot<TIMED>(parent, (int)k, tally);
    grid.sync();
  }
  hook_range<TIMED>(parent, u, v, n_first, n_edges, n_slots, first, stride, tally);
  if constexpr (TIMED) {
    const unsigned long long ns1 = uf_global_ns();
    if ((threadIdx.x & 31) == 0) {
      warp_ns[2 * (first >> 5)] = ns0;
      warp_ns[2 * (first >> 5) + 1] = ns1;
    }
  }
  grid.sync();
  for (long long k = first; k < n_slots; k += stride) compress_slot<TIMED>(parent, (int)k, tally);
  if constexpr (TIMED) tally.flush(counts);
}

__global__ void __launch_bounds__(UF_THREADS) uf_compress_kernel(int* parent, int n_slots) {
  UfTally<false> tally;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n_slots; k += stride)
    compress_slot<false>(parent, (int)k, tally);
}

__global__ void __launch_bounds__(UF_THREADS)
uf_find_kernel(const int* parent, const int* __restrict__ pos, int* __restrict__ out, long long n_pos,
               int n_slots) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n_pos; k += stride) {
    int x = __ldg(pos + k);
    check_slot(x, n_slots);
    int p = parent[x];
    while (p != x) {
      x = p;
      p = parent[x];
    }
    out[k] = x;
  }
}

namespace {

int grid_for(long long n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (n + UF_THREADS - 1) / UF_THREADS;
  const long long cap = (long long)sms * UF_BLOCKS_PER_SM;
  return (int)(blocks < cap ? blocks : cap);
}

cudaError_t unite_launch(const void* kernel, void* parent, const void* u, const void* v, long long n_edges,
                         int n_slots, int grid, void* counts, void* warp_ns, void* stream) {
  if (n_slots <= 0 || n_edges < 0 || grid <= 0) return cudaErrorInvalidValue;
  void* params[] = {&parent, &u, &v, &n_edges, &n_slots, &counts, &warp_ns};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(UF_THREADS), params, 0, (cudaStream_t)stream);
  // a refused launch leaves its error for the next cudaGetLastError: take it
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// Blocks of uf_unite_kernel an SM holds at once, and the SMs: the grid of a
// cooperative launch is at most their product (ops/unionfind.py::unite_grid
// picks it).  Returns a CUDA error code (cudaErrorNotSupported where the
// card has no cooperative launch).
extern "C" int uf_unite_occupancy(int* blocks_per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, uf_unite_kernel<false>, UF_THREADS, 0);
  return (int)err;
}

// A unite of parent (n_slots) with the edges (u[e], v[e]): one cooperative
// launch of `grid` blocks.  A grid the card cannot hold at once is refused
// (cudaErrorCooperativeLaunchTooLarge), never run another way.
extern "C" int uf_unite_launch(void* parent, const void* u, const void* v, long long n_edges, int n_slots, int grid,
                               void* stream) {
  return (int)unite_launch((const void*)uf_unite_kernel<false>, parent, u, v, n_edges, n_slots, grid, nullptr,
                           nullptr, stream);
}

extern "C" int uf_compress_launch(void* parent, int n_slots, void* stream) {
  if (n_slots <= 0) return (int)cudaSuccess;
  uf_compress_kernel<<<grid_for(n_slots), UF_THREADS, 0, (cudaStream_t)stream>>>((int*)parent, n_slots);
  return (int)cudaGetLastError();
}

extern "C" int uf_find_launch(const void* parent, const void* pos, void* out, long long n_pos, int n_slots,
                              void* stream) {
  if (n_pos <= 0) return (int)cudaSuccess;
  uf_find_kernel<<<grid_for(n_pos), UF_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)parent, (const int*)pos, (int*)out, n_pos, n_slots);
  return (int)cudaGetLastError();
}

#ifdef UF_TIMED
// The timing tool's unite: the launch above with the timer, at the grid the
// card holds at once.  counts: UF_COUNTS zeroed slots; warp_ns: two slots a
// warp of that grid (uf_timed_warps of them).
namespace {

int timed_grid() {
  int dev = 0, bps = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, uf_unite_kernel<true>, UF_THREADS, 0);
  return bps * sms;
}

}  // namespace

extern "C" int uf_timed_warps(long long, int) { return timed_grid() * (UF_THREADS / 32); }

extern "C" int uf_timed_launch(void* parent, const void* u, const void* v, long long n_edges, int n_slots,
                               void* counts, void* warp_ns, void* stream) {
  return (int)unite_launch((const void*)uf_unite_kernel<true>, parent, u, v, n_edges, n_slots, timed_grid(),
                           counts, warp_ns, stream);
}

// The card's rate for the union-find's kind of traffic: `per_thread`
// relaxed device-scope loads a thread of 4 bytes each from hashed, so
// scattered, slots of data[n] (n ints resident in L2), each load its own
// 32-byte sector.  The sum goes to sink so that no load is dropped.
__global__ void __launch_bounds__(UF_THREADS) uf_l2_probe_kernel(int* data, int n, int per_thread, int* sink) {
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  int acc = 0;
  for (int k = 0; k < per_thread; ++k) {
    unsigned h = (tid * 0x9E3779B1u) ^ (k * 0x85EBCA77u);
    h ^= h >> 15;
    h *= 0x2C1B3C6Du;
    h ^= h >> 12;
    acc += load(data, (int)(h % (unsigned)n));
  }
  if (acc == 0x7fffffff) *sink = acc;
}

extern "C" int uf_l2_probe_launch(void* data, int n, int per_thread, void* sink, void* stream) {
  uf_l2_probe_kernel<<<grid_for(1ll << 40), UF_THREADS, 0, (cudaStream_t)stream>>>((int*)data, n, per_thread,
                                                                                    (int*)sink);
  return (int)cudaGetLastError();
}

extern "C" int uf_l2_probe_threads() { return grid_for(1ll << 40) * UF_THREADS; }
#endif
