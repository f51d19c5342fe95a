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
//   uf_hook_kernel      a grid-stride loop over the edges.  Per edge, both
//                       roots by path halving; where they differ, the larger
//                       root is hooked onto the smaller with
//                       atomicCAS(&parent[hi], hi, lo); where the CAS finds hi
//                       hooked meanwhile, the search goes on from the value it
//                       returned, until both ends share a root.
//   uf_compress_kernel  a grid-stride loop over the slots: each chases to its
//                       root and writes it, so afterwards parent[i] is the
//                       root of i (the JAX compress's fixpoint).
//   uf_find_kernel      the same chase for given positions, into an output;
//                       the parent is only read.
//
// Why it is exact.  A slot that is not a root never becomes one again, and
// only roots are hooked, each onto a smaller root, so every root at any
// time is a root of the input forest and the forest stays acyclic.  An edge
// is done only once both its ends share a root, and later hooks only merge
// trees, so after the hook launch the trees are the components.  The
// smallest input root of a component is never hooked (that would need a
// smaller root in it), so it is the component's root: the representative
// the JAX package converges to (from an identity start, the component's
// minimum Pos), whatever order the atomics land in.  Path halving writes
// parent[x] = parent[parent[x]] only at an x it read as no root, an
// ancestor of x in place of another, so it never undoes a hook or changes a
// root.  In the compress launch a slot's own thread writes its root last:
// the other threads halve through that slot with a CAS from the parent they
// read, which fails once the root is written, so no stale ancestor lands
// after it.  parent is read and written through relaxed device-scope
// atomics (never the read-only path: other threads write it during the
// launch); the edges and positions are read-only.  An edge or position
// outside the parent traps the launch, which the next synchronisation
// reports, as torch's own index checks on the card do.
//
// What bounds it on an H100: bytes, the edges read once (8 B an edge, int32
// ends) and the parent read and written once (8 B a slot): 16.0 MB, 0.0048
// ms at the data sheet's 3.35 TB/s, on the headline's flush (NVIDIA H100
// 80GB HBM3, 700.00 W; measured times in PERF.md).  The parent fits in the
// 50 MB L2 up to 6.6 M slots (1,000 haplotypes x 3.3 kb, 26 MB), so the
// finds' dependent reads mostly hit L2; their latency, a few hundred cycles
// a hop, sets the real floor.  The design keeps every resident thread busy with its own
// edge (a grid of eight 256-thread blocks an SM striding over the edges)
// and reads nothing back to the host: a unite is two launches.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UF_THREADS = 256;
constexpr int UF_BLOCKS_PER_SM = 8;

using slot_ref = cuda::atomic_ref<int, cuda::thread_scope_device>;

__device__ __forceinline__ int load(int* parent, int x) {
  return slot_ref(parent[x]).load(cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ void store(int* parent, int x, int v) {
  slot_ref(parent[x]).store(v, cuda::std::memory_order_relaxed);
}

// The root of x, halving the path on the way (hook launch only).
__device__ __forceinline__ int find_halving(int* parent, int x) {
  while (true) {
    const int p = load(parent, x);
    if (p == x) return x;
    const int gp = load(parent, p);
    if (gp == p) return p;
    store(parent, x, gp);  // x is no root: the write never touches one
    x = gp;
  }
}

__device__ __forceinline__ void check_slot(int x, int n_slots) {
  if ((unsigned)x >= (unsigned)n_slots) __trap();  // an index outside the parent
}

}  // namespace

__global__ void __launch_bounds__(UF_THREADS)
uf_hook_kernel(int* parent, const int* __restrict__ u, const int* __restrict__ v, long long n_edges,
               int n_slots) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n_edges; e += stride) {
    int a = __ldg(u + e), b = __ldg(v + e);
    check_slot(a, n_slots);
    check_slot(b, n_slots);
    while (true) {
      a = find_halving(parent, a);
      b = find_halving(parent, b);
      if (a == b) break;
      const int hi = a > b ? a : b;
      const int lo = a > b ? b : a;
      int expected = hi;
      if (slot_ref(parent[hi]).compare_exchange_strong(expected, lo, cuda::std::memory_order_relaxed)) break;
      // hi was hooked onto `expected` meanwhile: go on from there
      a = expected;
      b = lo;
    }
  }
}

__global__ void __launch_bounds__(UF_THREADS) uf_compress_kernel(int* parent, int n_slots) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n_slots; k += stride) {
    const int i = (int)k;
    int x = i;
    while (true) {
      const int p = load(parent, x);
      if (p == x) break;
      const int gp = load(parent, p);
      if (gp == p) {
        x = p;
        break;
      }
      // halve through x only if nobody (x's own thread) wrote its root first
      int expected = p;
      slot_ref(parent[x]).compare_exchange_strong(expected, gp, cuda::std::memory_order_relaxed);
      x = gp;
    }
    if (x != i) store(parent, i, x);
  }
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

}  // namespace

extern "C" int uf_hook_launch(void* parent, const void* u, const void* v, long long n_edges, int n_slots,
                              void* stream) {
  if (n_edges <= 0) return (int)cudaSuccess;
  uf_hook_kernel<<<grid_for(n_edges), UF_THREADS, 0, (cudaStream_t)stream>>>(
      (int*)parent, (const int*)u, (const int*)v, n_edges, n_slots);
  return (int)cudaGetLastError();
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
