// The path-guided SGD tick: one tick of PG-SGD over `w` term pairs, from one
// snapshot of the node positions x [N] float32 into a second buffer.
//
// Replaces the XLA program seqrush_tpu/layout/sgd.py::_sgd_run's `tick`
// (the port's plain version is seqrush_tpu_torch/layout/sgd.py::sgd_tick).
// Per term k, from its draws (step_idx, coin_zipf, coin_back, u01, u02):
// the first step's path, count and rank; the jump direction and space; the
// second step by an inverse-CDF Zipf search over the partial harmonic sums H
// (or, before cooling and when the Zipf coin is false, uniformly along the
// path); the validity rules (a path of one step, the same step, a zero
// distance); and the displacement r = mu * (|dx| - d) / 2 / |dx| * dx.  Each
// node then moves by the mean of its terms' displacements: -r for every term
// that names it first, +r for every term that names it second.
//
// The result equals the plain version run on the CPU bit for bit:
//   * every float operation is the plain version's, in its order, with the
//     _rn intrinsics, so nvcc contracts no product and sum into an FMA and
//     every division is IEEE;
//   * a node's displacement is a left fold from +0.0 over its terms in the
//     order of their position p in cat([i, j]) (p = k for its first-step
//     terms, w + k for its second-step ones), the order in which the CPU's
//     index_add_ adds them.  Terms that are not valid add exactly 0.0 there
//     and change no sum that starts from +0.0, so they take no slot here;
//   * the count of a node's valid terms is an integer, exact in any order.
//
// Three launches a tick:
//   1. sgd_terms_kernel, a thread a term: the term's nodes and displacement,
//      and an integer atomic count of each node's valid terms.  The last
//      block to finish (a device-scope counter) takes the exclusive scan of
//      the counts, each node's first slot;
//   2. sgd_slots_kernel, a thread a term: each valid term writes its
//      positions p into the slots of its two nodes, at places an atomic
//      cursor hands out (in no fixed order);
//   3. sgd_nodes_kernel, a warp a node of at most long_min terms: the rank
//      of each of the node's positions among them (compares in registers,
//      the node's slots read 32 at a time), each displacement stored at its
//      rank, then the warp folds them in rank order (32 at a time through
//      shuffles) and writes x + sum / max(count, 1).  A node of more terms (a node that many paths visit
//      many times: a collapsed repeat, a loop) is ranked by the whole block
//      instead, through a bitmap of its positions a window of 65,536 at a
//      time and a scan of the bitmap's popcounts, O(n + span / 32) where the
//      compares are O(n^2).  Every node is written, also one that no term
//      names.  It sets the node's count and cursor back to 0 for the next
//      tick, so no launch clears them.
//
// What bounds it on an H100: latency.  The bytes a tick must move
// (tools/sgd_timing.py::tick_bytes): each term's draws (18 B); its gathers
// from the step tables (two of node_of_step and step_pos, one of step_path
// and step_rank), from the path tables (path_count, path_first) and from H
// (H[js] and up to bit_length(space + 1) probes), each table charged at
// most its size, since the small ones (H, the path tables) are read by
// every term from cache; the positions read once and written once (the
// terms' reads of x are reads of that table too).  0.51 MB for the
// headline's 8,192 terms, 0.15 us at 3.35 TB/s.  A term is a chain of
// about 25 dependent reads (the gathers, about 12 of the search, then the
// positions), and the tick has two grid-wide dependencies (every term's
// count before the scan, every slot before a node's fold), so each launch
// waits on device-memory round trips; a node's fold is a chain of n
// dependent adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TERM_THREADS = 256;
constexpr int NODE_WARPS = 8;  // nodes a block of sgd_nodes_kernel
constexpr int NODE_THREADS = 32 * NODE_WARPS;
constexpr int WIN_WORDS = 2048;  // a long node's bitmap window: 65,536 positions
constexpr int WIN_BITS = 32 * WIN_WORDS;
constexpr int WORDS_PER_THREAD = WIN_WORDS / NODE_THREADS;
constexpr unsigned FULL = 0xffffffffu;

// Inclusive scan of v over the block (blockDim.x a multiple of 32, at most
// 1,024); `part` holds 32 ints of shared memory.
__device__ int block_scan_inclusive(int v, int* part) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) part[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int s = lane < nw ? part[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += t;
    }
    part[lane] = s;
  }
  __syncthreads();
  return wid ? v + part[wid - 1] : v;
}

// First index i in [0, n) with H[i] >= v, or n (torch.searchsorted, side
// "left", on a non-decreasing H).
__device__ long long lower_bound(const float* H, long long n, float v) {
  long long lo = 0;
  while (n > 0) {
    const long long half = n >> 1;
    if (H[lo + half] < v) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

}  // namespace

__global__ void __launch_bounds__(TERM_THREADS)
sgd_terms_kernel(const float* __restrict__ x, const long long* __restrict__ step_idx,
                 const uint8_t* __restrict__ coin_zipf, const uint8_t* __restrict__ coin_back,
                 const float* __restrict__ u01, const float* __restrict__ u02,
                 const long long* __restrict__ node_of_step, const float* __restrict__ step_pos,
                 const long long* __restrict__ step_path, const long long* __restrict__ step_rank,
                 const long long* __restrict__ path_first, const long long* __restrict__ path_count,
                 const float* __restrict__ H, long long space, int cooling, float eta, int w, int N,
                 int* __restrict__ ti, int* __restrict__ tj, float* __restrict__ tr,
                 int* cnt, int* __restrict__ off, unsigned* done) {
  __shared__ int part[32];
  __shared__ bool last;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < w) {
    const long long s = step_idx[k];
    const long long pid = step_path[s];
    const long long c = path_count[pid];
    const long long ra = step_rank[s];
    const bool back = ra > 0 && (coin_back[k] != 0 || ra == c - 1);
    const long long space_back = ra < space ? ra : space;
    const long long fwd = c - ra - 1;
    const long long space_fwd = fwd < space ? fwd : space;
    long long js = back ? space_back : space_fwd;
    js = js < 1 ? 1 : js;
    // inverse-CDF Zipf over 1..js: the first H[z] >= u01 * H[js]
    long long z = lower_bound(H, space + 1, __fmul_rn(u01[k], H[js]));
    z = z < 1 ? 1 : z;
    z = z < js ? z : js;
    long long rb;
    if (back) {
      rb = ra - z < 0 ? 0 : ra - z;
    } else {
      rb = ra + z < c - 1 ? ra + z : c - 1;
    }
    if (!cooling && coin_zipf[k] == 0) {
      const long long u = (long long)__fmul_rn(u02[k], (float)c);  // truncation toward zero
      const long long top = c - 1 < 0 ? 0 : c - 1;
      rb = u < top ? u : top;
    }
    const long long sb = path_first[pid] + rb;
    bool valid = c > 1 && ra != rb;
    float td = fabsf(__fsub_rn(step_pos[s], step_pos[sb]));
    valid = valid && td > 0.0f;  // taken before the clamp: a zero distance is no term
    td = td < 1e-9f ? 1e-9f : td;
    const float wt = __fdiv_rn(1.0f, td);
    float mu = __fmul_rn(eta, wt);
    mu = mu > 1.0f ? 1.0f : mu;
    const int i = (int)node_of_step[s];
    const int j = (int)node_of_step[sb];
    float dx = __fsub_rn(x[i], x[j]);
    dx = dx == 0.0f ? 1e-9f : dx;
    const float mag = fabsf(dx);
    const float du = __fdiv_rn(__fmul_rn(mu, __fsub_rn(mag, td)), 2.0f);
    const float r = __fmul_rn(__fdiv_rn(du, mag), dx);
    ti[k] = valid ? i : -1;
    tj[k] = j;
    tr[k] = valid ? r : 0.0f;
    if (valid) {
      atomicAdd(&cnt[i], 1);
      atomicAdd(&cnt[j], 1);
    }
  }
  // the last block to finish scans the counts into each node's first slot
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  const int per = (N + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, N), hi = min(lo + per, N);
  int sum = 0;
  for (int v = lo; v < hi; ++v) sum += __ldcg(&cnt[v]);
  int run = block_scan_inclusive(sum, part) - sum;
  for (int v = lo; v < hi; ++v) {
    off[v] = run;
    run += __ldcg(&cnt[v]);
  }
  if (threadIdx.x == 0) *done = 0u;
}

__global__ void __launch_bounds__(TERM_THREADS)
sgd_slots_kernel(const int* __restrict__ ti, const int* __restrict__ tj, const int* __restrict__ off,
                 int* cur, int* __restrict__ slots, int w) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= w) return;
  const int i = ti[k];
  if (i < 0) return;
  const int j = tj[k];
  slots[off[i] + atomicAdd(&cur[i], 1)] = k;
  slots[off[j] + atomicAdd(&cur[j], 1)] = w + k;
}

// The fold of a node's displacements is a left fold from +0.0 with the plain
// tick's float32 adds, in rank order.  A warp folds 32 at a time: each lane
// loads one and every lane adds all 32 from the shuffles, so the loads are
// coalesced and the chain is the adds alone.  Past the node's last term the
// lanes add +0.0, which changes no sum: a sum that starts from +0.0 is never
// -0.0, and x + (+0.0) is x for every other x.
__device__ float fold32(float acc, float t) {
#pragma unroll
  for (int s = 0; s < 32; ++s) acc = __fadd_rn(acc, __shfl_sync(FULL, t, s));
  return acc;
}

// Node v's new position from its sum of n terms; its count and cursor back
// to 0 for the next tick.
__device__ void write_node(int v, int n, float acc, const float* __restrict__ x, float* __restrict__ xn,
                           int* cnt, int* cur) {
  xn[v] = __fadd_rn(x[v], __fdiv_rn(acc, (float)(n > 1 ? n : 1)));
  cnt[v] = 0;
  cur[v] = 0;
}

// Node v's n positions ranked by the whole block, for a node named by more
// than long_min terms: the positions' span is cut into windows of WIN_BITS;
// in each, a bitmap of the positions present and an exclusive scan of its
// words' popcounts give each position its rank (the positions of earlier
// windows, the set bits of earlier words, then the set bits below it in its
// word).  O(n + span / 32) a window, where ranking by compares is O(n^2).
// Then it folds them; the sum is warp 0's.
__device__ float rank_long(int v, int n, const float* __restrict__ tr, const int* __restrict__ off,
                          const int* __restrict__ slots, float* vals, int w, unsigned* bits, int* pre,
                          int* part, int* red) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int base = off[v];
  const int* sl = slots + base;
  int pmin = 0x7fffffff, pmax = -1;
#pragma unroll 4
  for (int e = tid; e < n; e += nt) {
    const int p = sl[e];
    pmin = min(pmin, p);
    pmax = max(pmax, p);
  }
  for (int o = 16; o > 0; o >>= 1) {
    pmin = min(pmin, __shfl_xor_sync(FULL, pmin, o));
    pmax = max(pmax, __shfl_xor_sync(FULL, pmax, o));
  }
  if (tid == 0) {
    red[0] = 0x7fffffff;
    red[1] = -1;
  }
  __syncthreads();
  if ((tid & 31) == 0) {
    atomicMin(&red[0], pmin);
    atomicMax(&red[1], pmax);
  }
  __syncthreads();
  const long long lo = red[0] & ~31, hi = red[1];
  int run = 0;  // the positions of earlier windows
  for (long long ws = lo; ws <= hi; ws += WIN_BITS) {
    for (int k = tid; k < WIN_WORDS; k += nt) bits[k] = 0u;
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < n; e += nt) {
      const long long d = sl[e] - ws;
      if (d >= 0 && d < WIN_BITS) atomicOr(&bits[d >> 5], 1u << (d & 31));
    }
    __syncthreads();
    int c[WORDS_PER_THREAD], s = 0;
#pragma unroll
    for (int q = 0; q < WORDS_PER_THREAD; ++q) {
      c[q] = __popc(bits[tid * WORDS_PER_THREAD + q]);
      s += c[q];
    }
    int ex = block_scan_inclusive(s, part) - s;
#pragma unroll
    for (int q = 0; q < WORDS_PER_THREAD; ++q) {
      pre[tid * WORDS_PER_THREAD + q] = ex;
      ex += c[q];
    }
    if (tid == nt - 1) red[2] = ex;
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < n; e += nt) {
      const int p = sl[e];
      const long long d = p - ws;
      if (d >= 0 && d < WIN_BITS) {
        const int k = (int)(d >> 5);
        const int r = run + pre[k] + __popc(bits[k] & ((1u << (d & 31)) - 1u));
        vals[base + r] = p < w ? -tr[p] : tr[p - w];
      }
    }
    run += red[2];
    __syncthreads();
  }
  // the fold, WIN_WORDS values at a time staged in shared memory (pre's
  // words, free again), padded with +0.0 to a multiple of 32; warp 0 adds
  float* buf = reinterpret_cast<float*>(pre);
  float acc = 0.0f;
  for (int c = 0; c < n; c += WIN_WORDS) {
    const int m = min(WIN_WORDS, n - c);
    for (int k = tid; k < WIN_WORDS; k += nt) buf[k] = k < m ? vals[base + c + k] : 0.0f;
    __syncthreads();
    if (tid < 32)
      for (int q = 0; q < m; q += 32) acc = fold32(acc, buf[q + tid]);
    __syncthreads();
  }
  return acc;
}

__global__ void __launch_bounds__(NODE_THREADS)
sgd_nodes_kernel(const float* __restrict__ x, const float* __restrict__ tr, const int* __restrict__ off,
                 const int* __restrict__ slots, int* cnt, int* cur, float* vals,
                 float* __restrict__ xn, int w, int N, int long_min) {
  __shared__ unsigned bits[WIN_WORDS];
  __shared__ int pre[WIN_WORDS];
  __shared__ int part[32];
  __shared__ int red[3];
  __shared__ int ns[NODE_WARPS];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int v = blockIdx.x * NODE_WARPS + wid;
  const int n = v < N ? cnt[v] : -1;
  if (lane == 0) ns[wid] = n;
  __syncthreads();
  if (v < N && n <= long_min) {
    // a warp a node: each position goes to its rank among the node's
    // positions, by compares in registers (the slots read 32 at a time)
    const int base = n ? off[v] : 0;
    const int* sl = slots + base;
    for (int e0 = 0; e0 < n; e0 += 32) {
      const int e = e0 + lane;
      const int p = e < n ? sl[e] : 0x7fffffff;
      int rank = 0;
      for (int t = 0; t < n; t += 32) {
        const int q = t + lane < n ? sl[t + lane] : 0x7fffffff;
#pragma unroll
        for (int s = 0; s < 32; ++s) rank += __shfl_sync(FULL, q, s) < p;
      }
      if (e < n) vals[base + rank] = p < w ? -tr[p] : tr[p - w];
    }
    __syncwarp();
    float acc = 0.0f;
    for (int c = 0; c < n; c += 32) acc = fold32(acc, c + lane < n ? vals[base + c + lane] : 0.0f);
    if (lane == 0) write_node(v, n, acc, x, xn, cnt, cur);
  }
  // the block's long nodes, one at a time
  for (int q = 0; q < NODE_WARPS; ++q) {
    const int m = ns[q];
    if (m <= long_min) continue;
    const int u = blockIdx.x * NODE_WARPS + q;
    const float acc = rank_long(u, m, tr, off, slots, vals, w, bits, pre, part, red);
    if (threadIdx.x == 0) write_node(u, m, acc, x, xn, cnt, cur);
  }
}

// One tick: positions x [N] into xn [N] (another buffer).  Draws: step_idx
// [w] int64, coin_zipf / coin_back [w] bool (one byte each), u01 / u02 [w]
// float32.  Tables (int64 unless said): node_of_step, step_pos (float32),
// step_path, step_rank [S]; path_first, path_count [P]; H [space + 1]
// float32, the table of this tick's phase.  Work: ti, tj [w] int32, tr [w]
// float32, slots [2w] int32, vals [2w] float32, off [N] int32, and cnt, cur
// [N] int32 and done [1] which must be 0 on entry (the tick leaves them 0).
// A node named by more than long_min terms is ranked by a block, not a warp.
// Returns the CUDA error code of the launches.
extern "C" int sgd_tick_launch(const void* x, void* xn, const void* step_idx, const void* coin_zipf,
                               const void* coin_back, const void* u01, const void* u02,
                               const void* node_of_step, const void* step_pos, const void* step_path,
                               const void* step_rank, const void* path_first, const void* path_count,
                               const void* H, void* ti, void* tj, void* tr, void* slots, void* vals,
                               void* off, void* cnt, void* cur, void* done, long long space,
                               int cooling, float eta, int w, int N, int long_min, void* stream) {
  if (w <= 0 || w > (1 << 30) - WIN_BITS || N <= 0 || space < 1 || long_min < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int term_blocks = (w + TERM_THREADS - 1) / TERM_THREADS;
  sgd_terms_kernel<<<term_blocks, TERM_THREADS, 0, st>>>(
      (const float*)x, (const long long*)step_idx, (const uint8_t*)coin_zipf,
      (const uint8_t*)coin_back, (const float*)u01, (const float*)u02,
      (const long long*)node_of_step, (const float*)step_pos, (const long long*)step_path,
      (const long long*)step_rank, (const long long*)path_first, (const long long*)path_count,
      (const float*)H, space, cooling, eta, w, N, (int*)ti, (int*)tj, (float*)tr, (int*)cnt,
      (int*)off, (unsigned*)done);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sgd_slots_kernel<<<term_blocks, TERM_THREADS, 0, st>>>((const int*)ti, (const int*)tj,
                                                         (const int*)off, (int*)cur, (int*)slots, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sgd_nodes_kernel<<<(N + NODE_WARPS - 1) / NODE_WARPS, NODE_THREADS, 0, st>>>(
      (const float*)x, (const float*)tr, (const int*)off, (const int*)slots, (int*)cnt, (int*)cur,
      (float*)vals, (float*)xn, w, N, long_min);
  return (int)cudaGetLastError();
}
