// The path-guided SGD ticks: a block of B ticks of PG-SGD in one persistent
// launch.  Each tick moves `w` term pairs against one snapshot of the node
// positions x [N] float32 and writes the next snapshot into another buffer.
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
// One cooperative launch runs ticks lo .. lo + B - 1 (tick t of the run
// reads its eta from the device's table at t / n_sub, and the cooling H once
// t / n_sub reaches first_cooling); the positions ping-pong between two
// buffers.  The grid is every block the card holds at once, and grid-wide
// barriers part a tick's phases:
//   1. terms: a block takes a chunk of C terms, several a thread in flight
//      (a step's node, path, rank and position are one 16-byte record, a
//      path's first step and count one 8-byte record), writes each term's
//      nodes and displacement, and counts the chunk's entries by node in
//      shared memory (__match_any_sync, one shared atomic a node a warp),
//      once for the first-step entries and once for the second-step ones:
//      two columns of the count matrix [bins][chunks] (chunks = 2 ceil(w / C),
//      in the order of cat([i, j]); where C does not divide w, each side's
//      last chunk is padded with entries that name no node), written where
//      they are not 0;
//   2. scan: a warp a node scans its row of the matrix over the chunks into
//      each (node, chunk)'s first slot among the node's entries, writes the
//      node's total and clears the row for the next tick;
//   3. place: every block scans the totals (bins of them) in shared memory
//      into each node's first slot; then a block takes a chunk of entries,
//      a warp a run of them in order: each warp ranks its entries 32 at a
//      time by node with __match_any_sync, and in its turn (the warps in
//      order) adds the counts of the chunk's earlier entries of each node
//      (kept in shared memory), so each valid entry's displacement goes to
//      its node's first slot plus its (node, chunk)'s plus that rank: a
//      stable counting sort;
//   4. fold: a warp a node folds its slots, now contiguous and in the order
//      of cat([i, j]), and writes x + sum / max(count, 1).  Up to 32 values
//      go through shuffles; more are staged 256 at a time in shared memory,
//      the warp loading the next 256 while lane 0 adds.  Every node is
//      written, also one that no term names.
// Where the node count exceeds one pass's bins (two histograms of them in
// a block's shared memory), phases 2-3 sort by the node id's digits, low
// digit first, each pass stable (a count phase before each later pass);
// the fold then finds a node's slots by a 32-way search of the sorted ids.
// No step's work grows with n^2 or with the span of a node's positions:
// the count matrix is bins x chunks, and C is the smallest chunk (256
// terms, doubled) whose matrix fits the plan's budget, kept inside L2.
//
// What bounds it on an H100: latency.  The bytes a tick must move
// (tools/sgd_timing.py::tick_bytes): each term's draws (18 B); its gathers
// at 4 B a field, the records' width (the first step's node, position, path
// and rank, the second step's node and position, the path's first step and
// count, H[js] and up to bit_length(space + 1) probes), each table charged
// at most its size; the positions read once and written once.  0.38 MB for
// the headline's 8,192 terms, 0.11 us at 3.35 TB/s.  A term is a chain of
// five dependent device-memory reads (its draws, its first step's record, its
// path's, its second step's, the positions); H is staged in shared memory
// when it fits, so the search's ~12 probes stay on the SM (a 60 kb locus's
// H does not: its probes go through L1).  At 1,000 paths
// the records' random reads are the term phase's traffic.  Four grid
// barriers a tick part the phases, the place phase's warps take their turns
// inside a block, and a node's fold is a chain of n dependent adds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TERM_BATCH = 2;    // terms a thread keeps in flight
constexpr int SCAN_RUN = 8;      // a lane's chunks of a node's row in the scan
constexpr int PLACE_BATCH = 4;   // groups of 32 entries a warp loads at once in the place
constexpr int FOLD_STAGE = 256;  // values a warp stages at a time for a long node's fold
constexpr unsigned FULL = 0xffffffffu;

struct Ticks {
  const float* x_in;  // the positions before tick lo (may be out1, never out0)
  float* out0;        // tick lo + b writes out0 for even b, out1 for odd b
  float* out1;
  const long long* step_idx;  // the draws [B, w]
  const uint8_t* coin_zipf;
  const uint8_t* coin_back;
  const float* u01;
  const float* u02;
  const int4* step_rec;  // [S] a step's node, path, rank and position (float32 bits)
  const int2* path_rec;  // [P] a path's first step and count
  const float* Hmain;    // [space + 1]
  const float* Hcool;
  const float* etas;  // [n_etas]
  int* ti;            // [w] a term's first node, -1 where it is not valid
  int* tj;            // [w] its second node
  float* tr;          // [w] its displacement
  int* counts;        // [bins][chunks] the count matrix; 0 between ticks
  int* offs;          // [bins][chunks] each (bin, chunk)'s first slot among the bin's entries
  int* totals;        // [bins] each bin's entries
  int* node_off;      // [N] a node's first slot (one pass)
  int* node_cnt;      // [N] its valid terms (one pass)
  int* keys0;         // [2w] the node ids in each digit pass's order (digit passes)
  int* keys1;
  float* vals0;  // [2w] the displacements in each pass's order
  float* vals1;
  unsigned long long* phase_ns;  // [5] nanoseconds of each phase (terms, the later passes' counts,
                                 // scan, place, fold), summed; null: not timed
  long long space;
  long long lo;  // the run's index of the first tick
  int n_etas, first_cooling, n_sub, n_ticks, w, N;
  int chunk;       // C: terms of a term chunk, entries of an entry chunk
  int chunks;      // entry chunks, 2 * ceil(w / C)
  int bins;        // bins of the first pass (the most of any pass)
  int digit_bits;  // 0: one pass by node id; else bits of a digit
  int passes;
  int stage_h;  // H staged in shared memory
  int stage_x;  // the positions staged in shared memory by each block with terms
};

// Inclusive scan of v over the block; `part` holds 32 ints of shared memory.
// The caller separates two calls by a barrier.
__device__ int block_scan_inclusive(int v, int* part) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) part[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int s = lane < WARPS ? part[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += t;
    }
    part[lane] = s;
  }
  __syncthreads();
  return wid ? v + part[wid - 1] : v;
}

template <bool STAGED>
__device__ __forceinline__ float hload(const float* H, long long i) {
  if constexpr (STAGED) {
    return H[i];
  } else {
    return __ldg(H + i);
  }
}

// First index i in [0, n) with H[i] >= v, or n (torch.searchsorted, side
// "left", on a non-decreasing H).
template <bool STAGED>
__device__ __forceinline__ long long lower_bound(const float* H, long long n, float v) {
  long long lo = 0;
  while (n > 0) {
    const long long half = n >> 1;
    if (hload<STAGED>(H, lo + half) < v) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__device__ __forceinline__ int bins_of(const Ticks& a, int pass) {
  return a.digit_bits ? min(1 << a.digit_bits, ((a.N - 1) >> (pass * a.digit_bits)) + 1) : a.N;
}

__device__ __forceinline__ int digit_of(const Ticks& a, int node, int pass) {
  return a.digit_bits ? (node >> (pass * a.digit_bits)) & ((1 << a.digit_bits) - 1) : node;
}

// One entry counted into a histogram by its warp: the lanes of one key
// agree, the lowest adds their number.  Every lane of the warp calls it.
__device__ __forceinline__ void count_key(int* hist, int key) {
  const unsigned peers = __match_any_sync(FULL, key);
  if (key >= 0 && __ffs(peers) - 1 == (int)(threadIdx.x & 31)) atomicAdd(&hist[key], __popc(peers));
}

// A block's entry chunk c counted into its histogram: the column's counts
// that are not 0 written into the count matrix (which holds 0 elsewhere),
// the histogram cleared.
__device__ void write_column(const Ticks& a, int* hist, int bins, int c) {
  __syncthreads();
  for (int v = threadIdx.x; v < bins; v += THREADS) {
    const int n = hist[v];
    if (n) {
      a.counts[(size_t)v * a.chunks + c] = n;
      hist[v] = 0;
    }
  }
  __syncthreads();
}

// Phase 1: the terms of tick b and their count by the first pass's digit.
template <bool STAGED, bool STAGED_X>
__device__ void terms_phase(const Ticks& a, const float* H, const float* x, float* Xs, long long doff, float eta,
                            int cooling, int* hist_i, int* hist_j) {
  const int C = a.chunk, tchunks = (a.w + C - 1) / C;
  const int per = (C + THREADS - 1) / THREADS;  // terms a thread in a chunk
  const int bins = bins_of(a, 0);
  if (STAGED_X && (int)blockIdx.x < tchunks) {
    for (int v = threadIdx.x; v < a.N; v += THREADS) Xs[v] = __ldcg(x + v);
    __syncthreads();
  }
  for (int tc = blockIdx.x; tc < tchunks; tc += gridDim.x) {
    for (int q0 = 0; q0 < per; q0 += TERM_BATCH) {
      const int live = min(TERM_BATCH, per - q0);  // the batch's slots, the same for the whole block
      long long s[TERM_BATCH];
      int k[TERM_BATCH], ni[TERM_BATCH], nj[TERM_BATCH], ra[TERM_BATCH], c[TERM_BATCH], sb[TERM_BATCH];
      bool act[TERM_BATCH], valid[TERM_BATCH];
      float pa[TERM_BATCH], pb[TERM_BATCH], u1[TERM_BATCH], u2[TERM_BATCH], xi[TERM_BATCH], xj[TERM_BATCH];
      int2 path[TERM_BATCH];
      uint8_t cz[TERM_BATCH], cb[TERM_BATCH];
#pragma unroll
      for (int u = 0; u < TERM_BATCH; ++u) {
        if (u >= live) break;
        const int local = (q0 + u) * THREADS + threadIdx.x;
        k[u] = tc * C + local;
        act[u] = local < C && k[u] < a.w;
        const long long d = doff + (act[u] ? k[u] : 0);
        s[u] = __ldg(a.step_idx + d);
        cz[u] = __ldg(a.coin_zipf + d);
        cb[u] = __ldg(a.coin_back + d);
        u1[u] = __ldg(a.u01 + d);
        u2[u] = __ldg(a.u02 + d);
      }
#pragma unroll
      for (int u = 0; u < TERM_BATCH; ++u) {
        if (u >= live) break;
        const int4 r = __ldg(a.step_rec + s[u]);
        ni[u] = r.x;
        ra[u] = r.z;
        pa[u] = __int_as_float(r.w);
        path[u] = __ldg(a.path_rec + r.y);
      }
#pragma unroll
      for (int u = 0; u < TERM_BATCH; ++u) {
        if (u >= live) break;
        c[u] = path[u].y;
        const bool back = ra[u] > 0 && (cb[u] != 0 || ra[u] == c[u] - 1);
        const long long space_back = ra[u] < a.space ? ra[u] : a.space;
        const long long fwd = c[u] - ra[u] - 1;
        const long long space_fwd = fwd < a.space ? fwd : a.space;
        long long js = back ? space_back : space_fwd;
        js = js < 1 ? 1 : js;
        // inverse-CDF Zipf over 1..js: the first H[z] >= u01 * H[js]
        long long z = lower_bound<STAGED>(H, a.space + 1, __fmul_rn(u1[u], hload<STAGED>(H, js)));
        z = z < 1 ? 1 : z;
        z = z < js ? z : js;
        int rb;
        if (back) {
          rb = ra[u] - z < 0 ? 0 : (int)(ra[u] - z);
        } else {
          rb = ra[u] + z < c[u] - 1 ? (int)(ra[u] + z) : c[u] - 1;
        }
        if (!cooling && cz[u] == 0) {
          const long long un = (long long)__fmul_rn(u2[u], (float)c[u]);  // truncation toward zero
          const int top = c[u] - 1 < 0 ? 0 : c[u] - 1;
          rb = un < top ? (int)un : top;
        }
        valid[u] = act[u] && c[u] > 1 && ra[u] != rb;
        sb[u] = path[u].x + rb;
      }
#pragma unroll
      for (int u = 0; u < TERM_BATCH; ++u) {
        if (u >= live) break;
        const int4 r = __ldg(a.step_rec + sb[u]);
        nj[u] = r.x;
        pb[u] = __int_as_float(r.w);
      }
#pragma unroll
      for (int u = 0; u < TERM_BATCH; ++u) {
        if (u >= live) break;
        xi[u] = STAGED_X ? Xs[ni[u]] : __ldcg(x + ni[u]);
        xj[u] = STAGED_X ? Xs[nj[u]] : __ldcg(x + nj[u]);
      }
#pragma unroll
      for (int u = 0; u < TERM_BATCH; ++u) {
        if (u >= live) break;
        float td = fabsf(__fsub_rn(pa[u], pb[u]));
        valid[u] = valid[u] && td > 0.0f;  // taken before the clamp: a zero distance is no term
        td = td < 1e-9f ? 1e-9f : td;
        const float wt = __fdiv_rn(1.0f, td);
        float mu = __fmul_rn(eta, wt);
        mu = mu > 1.0f ? 1.0f : mu;
        float dx = __fsub_rn(xi[u], xj[u]);
        dx = dx == 0.0f ? 1e-9f : dx;
        const float mag = fabsf(dx);
        const float du = __fdiv_rn(__fmul_rn(mu, __fsub_rn(mag, td)), 2.0f);
        const float r = __fmul_rn(__fdiv_rn(du, mag), dx);
        if (act[u]) {
          a.ti[k[u]] = valid[u] ? ni[u] : -1;
          a.tj[k[u]] = nj[u];
          a.tr[k[u]] = valid[u] ? r : 0.0f;
        }
        count_key(hist_i, valid[u] ? digit_of(a, ni[u], 0) : -1);
        count_key(hist_j, valid[u] ? digit_of(a, nj[u], 0) : -1);
      }
    }
    write_column(a, hist_i, bins, tc);
    write_column(a, hist_j, bins, tc + tchunks);
  }
}

// The count of a digit pass after the first: the previous pass's order,
// a chunk of C entries a block.
__device__ void count_phase(const Ticks& a, int pass, int nvalid, int* hist) {
  const int* keys = (pass - 1) & 1 ? a.keys1 : a.keys0;
  const int bins = bins_of(a, pass);
  for (int c = blockIdx.x; c < a.chunks; c += gridDim.x) {
    for (int r = 0; r < a.chunk; r += THREADS) {
      const int local = r + threadIdx.x, e = c * a.chunk + local;
      const bool in = local < a.chunk && e < nvalid;
      count_key(hist, in ? digit_of(a, __ldcg(keys + e), pass) : -1);
    }
    write_column(a, hist, bins, c);
  }
}

// Phase 2: a warp a bin scans its row of the count matrix over the chunks
// into each (bin, chunk)'s first slot among the bin's entries, writes the
// bin's total and clears the row.
__device__ void scan_phase(const Ticks& a, int pass) {
  const int lane = threadIdx.x & 31, bins = bins_of(a, pass);
  const int nwarps = gridDim.x * WARPS;
  for (int v = blockIdx.x * WARPS + (threadIdx.x >> 5); v < bins; v += nwarps) {
    int* row = a.counts + (size_t)v * a.chunks;
    int* off = a.offs + (size_t)v * a.chunks;
    int base = 0;
    // SCAN_RUN groups of 32 chunks, all loaded (coalesced) before any is
    // scanned
    for (int c0 = 0; c0 < a.chunks; c0 += 32 * SCAN_RUN) {
      int n[SCAN_RUN];
#pragma unroll
      for (int u = 0; u < SCAN_RUN; ++u) {
        const int c = c0 + u * 32 + lane;
        n[u] = c < a.chunks ? __ldcg(row + c) : 0;
      }
#pragma unroll
      for (int u = 0; u < SCAN_RUN; ++u) {
        if (c0 + u * 32 >= a.chunks) break;
        const int c = c0 + u * 32 + lane;
        int incl = n[u];
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += t;
        }
        if (c < a.chunks) {
          off[c] = base + incl - n[u];
          if (n[u]) row[c] = 0;
        }
        base += __shfl_sync(FULL, incl, 31);
      }
    }
    if (lane == 0) a.totals[v] = base;
  }
}

// Each bin's first slot: the exclusive scan of the totals, in `tot`, by
// the whole block.  With one pass the bins are the nodes, and the blocks
// write each node's first slot and count.  Returns the valid entries.
__device__ int scan_totals(const Ticks& a, int bins, int* tot, int* part, int* total) {
  const int tid = threadIdx.x;
  for (int v = tid; v < bins; v += THREADS) tot[v] = __ldcg(a.totals + v);
  __syncthreads();
  const int per = (bins + THREADS - 1) / THREADS;
  const int lo = min(tid * per, bins), hi = min(lo + per, bins);
  int sum = 0;
  for (int v = lo; v < hi; ++v) sum += tot[v];
  const int incl = block_scan_inclusive(sum, part);
  if (tid == THREADS - 1) *total = incl;
  int run = incl - sum;
  for (int v = lo; v < hi; ++v) {
    const int n = tot[v];
    tot[v] = run;
    run += n;
  }
  __syncthreads();
  const int nvalid = *total;
  if (a.passes == 1)
    for (int v = blockIdx.x * THREADS + tid; v < bins; v += gridDim.x * THREADS) {
      a.node_off[v] = tot[v];
      a.node_cnt[v] = (v + 1 < bins ? tot[v + 1] : nvalid) - tot[v];
    }
  return nvalid;
}

// A warp's batch of up to PLACE_BATCH groups of 32 entries of its run
// [g0, hi) of chunk c: each entry's node and value (node -1: no entry), its
// digit, its group's peers and its first slot before its rank.
struct PlaceBatch {
  int node[PLACE_BATCH], key[PLACE_BATCH], first[PLACE_BATCH];
  unsigned peers[PLACE_BATCH];
  float val[PLACE_BATCH];
  int groups;
};

__device__ __forceinline__ void load_batch(const Ticks& a, int pass, int nvalid, int c, int g0, int hi,
                                           const int* tot, PlaceBatch& p) {
  const int lane = threadIdx.x & 31, tchunks = (a.w + a.chunk - 1) / a.chunk;
  const int* keys_in = (pass - 1) & 1 ? a.keys1 : a.keys0;
  const float* vals_in = (pass - 1) & 1 ? a.vals1 : a.vals0;
  p.groups = min(PLACE_BATCH, (hi - g0 + 31) / 32);
#pragma unroll
  for (int u = 0; u < PLACE_BATCH; ++u) {
    if (u >= p.groups) break;
    const int local = g0 + u * 32 + lane, e = c * a.chunk + local;
    p.node[u] = -1;
    p.val[u] = 0.0f;
    if (local < hi) {
      if (pass == 0) {
        const int k = (c < tchunks ? c : c - tchunks) * a.chunk + local;  // past w: a chunk's padding
        if (k < a.w) {
          const int i = __ldcg(a.ti + k), j = __ldcg(a.tj + k);
          const float rr = __ldcg(a.tr + k);
          p.node[u] = i < 0 ? -1 : c < tchunks ? i : j;
          p.val[u] = c < tchunks ? -rr : rr;
        }
      } else if (e < nvalid) {
        p.node[u] = __ldcg(keys_in + e);
        p.val[u] = __ldcg(vals_in + e);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < PLACE_BATCH; ++u) {
    if (u >= p.groups) break;
    p.key[u] = p.node[u] >= 0 ? digit_of(a, p.node[u], pass) : -1;
    p.peers[u] = __match_any_sync(FULL, p.key[u]);
    p.first[u] = p.key[u] >= 0 ? tot[p.key[u]] + __ldcg(a.offs + (size_t)p.key[u] * a.chunks + c) : 0;
  }
}

// A batch's valid entries stored at their slots.
__device__ __forceinline__ void store_batch(const Ticks& a, const PlaceBatch& p, const int* slot, int* keys_out,
                                            float* vals_out) {
#pragma unroll
  for (int u = 0; u < PLACE_BATCH; ++u) {
    if (u >= p.groups) break;
    if (p.key[u] >= 0) {
      vals_out[slot[u]] = p.val[u];
      if (a.passes > 1) keys_out[slot[u]] = p.node[u];
    }
  }
}

// Phase 3: every valid entry to its slot, stable by the pass's digit: its
// bin's first slot, its (bin, chunk)'s, and its rank among the chunk's
// entries of its bin.  A chunk's entries are cut into a run a warp, in
// order; every warp loads its first batch at once, then the warps take
// their turns in order.  `run` and `tot` are cleared histograms, cleared
// again on return.  Returns the valid entries.
__device__ int place_phase(const Ticks& a, int pass, int* run, int* tot, int* part, int* total) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int bins = bins_of(a, pass);
  const int nvalid = scan_totals(a, bins, tot, part, total);
  const unsigned lower = (1u << lane) - 1u;
  int* keys_out = pass & 1 ? a.keys1 : a.keys0;
  float* vals_out = pass & 1 ? a.vals1 : a.vals0;
  const int span = (a.chunk + WARPS - 1) / WARPS;  // a warp's run of the chunk
  const int lo = min(wid * span, a.chunk), hi = min(lo + span, a.chunk);
  for (int c = blockIdx.x; c < a.chunks; c += gridDim.x) {
    PlaceBatch p;
    load_batch(a, pass, nvalid, c, lo, hi, tot, p);
    int slot[PLACE_BATCH];
    for (int q = 0; q < WARPS; ++q) {
      if (wid == q) {
        for (int g0 = lo; g0 < hi; g0 += 32 * PLACE_BATCH) {
          if (g0 != lo) {  // a run longer than a batch: the batch before is placed first
            store_batch(a, p, slot, keys_out, vals_out);
            load_batch(a, pass, nvalid, c, g0, hi, tot, p);
          }
#pragma unroll
          for (int u = 0; u < PLACE_BATCH; ++u) {
            if (u >= p.groups) break;
            const int key = p.key[u], rank = __popc(p.peers[u] & lower);
            const int before = key >= 0 ? run[key] : 0;
            __syncwarp();
            if (key >= 0 && rank == 0) run[key] = before + __popc(p.peers[u]);
            __syncwarp();
            slot[u] = p.first[u] + before + rank;
          }
        }
      }
      __syncthreads();
    }
    store_batch(a, p, slot, keys_out, vals_out);
    for (int v = tid; v < bins; v += THREADS) run[v] = 0;
    __syncthreads();
  }
  for (int v = tid; v < bins; v += THREADS) tot[v] = 0;
  return nvalid;
}

// First index in [0, n) whose key is >= v, or n, for the warp: 32 probes a
// step narrow the range 32-fold.  Every lane of the warp calls it.
__device__ int warp_lower_bound(const int* keys, int n, int v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + (lane + 1) * step - 1;
    const bool less = i < hi && __ldcg(keys + i) < v;
    const int k = __popc(__ballot_sync(FULL, less));
    const int top = lo + (k + 1) * step - 1;
    lo += k * step;
    hi = top < hi ? top : hi;
  }
  const bool less = lo + lane < hi && __ldcg(keys + lo + lane) < v;
  return lo + __popc(__ballot_sync(FULL, less));
}

// Phase 4: a warp a node, its slots folded from +0.0 with the plain tick's
// float32 adds in slot order.  Up to 32 values: each lane loads one and
// every lane adds them from the shuffles.  More: FOLD_STAGE values at a time
// through the warp's two buffers in shared memory, the warp loading the
// next FOLD_STAGE (coalesced) while lane 0 adds the staged ones, so the
// chain is the adds alone.
__device__ void fold_phase(const Ticks& a, const float* x, float* xn, int nvalid, float* stage) {
  const int lane = threadIdx.x & 31;
  const int fin = (a.passes - 1) & 1;
  const float* vals = fin ? a.vals1 : a.vals0;
  const int* keys = fin ? a.keys1 : a.keys0;
  const int nwarps = gridDim.x * WARPS;
  float* buf = stage + (threadIdx.x >> 5) * 2 * FOLD_STAGE;
  constexpr int PER = FOLD_STAGE / 32;
  for (int v = blockIdx.x * WARPS + (threadIdx.x >> 5); v < a.N; v += nwarps) {
    int off, n;
    if (a.passes == 1) {
      off = __ldcg(a.node_off + v);
      n = __ldcg(a.node_cnt + v);
    } else {
      off = warp_lower_bound(keys, nvalid, v);
      n = warp_lower_bound(keys, nvalid, v + 1) - off;
    }
    const float xv = __ldcg(x + v);
    float acc = 0.0f;
    if (n <= 32) {
      const float t = lane < n ? __ldcg(vals + off + lane) : 0.0f;
      for (int s = 0; s < n; ++s) acc = __fadd_rn(acc, __shfl_sync(FULL, t, s));
    } else {
      float r[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) r[u] = u * 32 + lane < n ? __ldcg(vals + off + u * 32 + lane) : 0.0f;
      for (int c = 0; c < n; c += FOLD_STAGE) {
        float* cur = buf + ((c / FOLD_STAGE) & 1) * FOLD_STAGE;
#pragma unroll
        for (int u = 0; u < PER; ++u) cur[u * 32 + lane] = r[u];
        __syncwarp();
        const int nx = c + FOLD_STAGE;  // the next batch, in flight while lane 0 adds
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int e = nx + u * 32 + lane;
          r[u] = e < n ? __ldcg(vals + off + e) : 0.0f;
        }
        if (lane == 0) {
          const int m = min(FOLD_STAGE, n - c);
          const float4* q = reinterpret_cast<const float4*>(cur);
#pragma unroll 8
          for (int s = 0; s < m / 4; ++s) {
            const float4 g = q[s];
            acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, g.x), g.y), g.z), g.w);
          }
          for (int s = m & ~3; s < m; ++s) acc = __fadd_rn(acc, cur[s]);
        }
        __syncwarp();
      }
    }
    if (lane == 0) xn[v] = __fadd_rn(xv, __fdiv_rn(acc, (float)(n > 1 ? n : 1)));
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Two blocks an SM: the place phase's turns and the fold's warps want the
// blocks more than the term phase wants registers.
__global__ void __launch_bounds__(THREADS, 2) sgd_ticks_kernel(const __grid_constant__ Ticks a) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int part[32];
  __shared__ int total;
  float* stage = reinterpret_cast<float*>(smem);  // WARPS x 2 x FOLD_STAGE floats
  int* hist_i = smem + WARPS * 2 * FOLD_STAGE;
  int* hist_j = hist_i + a.bins;
  float* Hs = reinterpret_cast<float*>(hist_j + a.bins);
  float* Xs = Hs + (a.stage_h ? a.space + 1 : 0);
  cg::grid_group grid = cg::this_grid();
  const bool timed = a.phase_ns != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long t_last = timed ? global_ns() : 0;
  auto barrier = [&](int phase) {
    grid.sync();
    if (timed) {
      const unsigned long long t = global_ns();
      a.phase_ns[phase] += t - t_last;
      t_last = t;
    }
  };
  for (int v = threadIdx.x; v < 2 * a.bins; v += THREADS) hist_i[v] = 0;
  int staged = -1;  // the cooling flag of the H in Hs
  for (int b = 0; b < a.n_ticks; ++b) {
    const long long it = (a.lo + b) / a.n_sub;
    const int cooling = it >= a.first_cooling;
    const float eta = __ldg(a.etas + (it < a.n_etas - 1 ? it : a.n_etas - 1));
    const float* H = cooling ? a.Hcool : a.Hmain;
    const float* x = b == 0 ? a.x_in : (b & 1 ? a.out0 : a.out1);
    float* xn = b & 1 ? a.out1 : a.out0;
    if (a.stage_h) {
      if (staged != cooling) {
        __syncthreads();
        for (long long i = threadIdx.x; i <= a.space; i += THREADS) Hs[i] = __ldg(H + i);
        __syncthreads();
        staged = cooling;
      }
      if (a.stage_x)
        terms_phase<true, true>(a, Hs, x, Xs, (long long)b * a.w, eta, cooling, hist_i, hist_j);
      else
        terms_phase<true, false>(a, Hs, x, Xs, (long long)b * a.w, eta, cooling, hist_i, hist_j);
    } else if (a.stage_x) {
      terms_phase<false, true>(a, H, x, Xs, (long long)b * a.w, eta, cooling, hist_i, hist_j);
    } else {
      terms_phase<false, false>(a, H, x, Xs, (long long)b * a.w, eta, cooling, hist_i, hist_j);
    }
    barrier(0);
    int nvalid = 0;
    for (int pass = 0; pass < a.passes; ++pass) {
      if (pass > 0) {
        count_phase(a, pass, nvalid, hist_i);
        barrier(1);
      }
      scan_phase(a, pass);
      barrier(2);
      nvalid = place_phase(a, pass, hist_i, hist_j, part, &total);
      barrier(3);
    }
    fold_phase(a, x, xn, nvalid, stage);
    barrier(4);
  }
}

}  // namespace

// The largest grid of sgd_ticks_kernel the card holds at once for `smem`
// bytes of dynamic shared memory a block: blocks an SM and SMs.  Also opts
// the kernel into that much shared memory.  Returns a CUDA error code
// (cudaErrorNotSupported where the card has no cooperative launch).
extern "C" int sgd_ticks_occupancy(int smem, int* blocks_per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sgd_ticks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, sgd_ticks_kernel, THREADS, (size_t)smem);
  return (int)err;
}

// Ticks lo .. lo + n_ticks - 1 in one cooperative launch of `grid` blocks
// (at most sgd_ticks_occupancy's blocks an SM times the SMs) with `smem`
// bytes of dynamic shared memory (the fold's stages, 2 * bins ints, space + 1
// floats when H is staged and N when the positions are).  `args` is the host's copy of Ticks;
// the count matrix must hold 0 on entry and holds 0 on return.  Returns a
// CUDA error code: a grid the card cannot hold at once is refused
// (cudaErrorCooperativeLaunchTooLarge), never run another way.
extern "C" int sgd_ticks_launch(const void* args, int grid, int smem, void* stream) {
  Ticks a = *static_cast<const Ticks*>(args);
  if (a.w <= 0 || a.w > (1 << 28) || a.N <= 0 || a.space < 1 || a.n_ticks <= 0 || a.n_sub <= 0 ||
      a.n_etas <= 0 || a.chunk <= 0 || a.chunk > 2 * a.w || a.chunks != 2 * ((a.w + a.chunk - 1) / a.chunk) ||
      a.bins <= 0 || a.passes <= 0 || grid <= 0 || (a.passes > 1) != (a.digit_bits > 0) || a.x_in == a.out0 ||
      (a.n_ticks > 1 && a.out0 == a.out1))
    return (int)cudaErrorInvalidValue;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)sgd_ticks_kernel, dim3(grid), dim3(THREADS), params,
                                          (size_t)smem, (cudaStream_t)stream);
}
