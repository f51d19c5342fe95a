// Kernel A's sharded mode: one pair's band split by lanes over D shards.
//
// The counterpart of the XLA program seqrush_tpu/parallel/bandshard.py::
// _build_sharded_sweep (its per-shard function local_fn under shard_map, one
// shard a device, a one-lane halo exchange by ppermute per anti-diagonal).
// Shard d holds lanes [d * Wl, (d + 1) * Wl) of the band's W = D * Wl; an
// anti-diagonal's cell reads lanes l + dp - 1 and l + dp of the previous
// rows, so each step needs one column of the six DP rows from one
// neighbour: the left one's last lane where dp = 0, the right one's first
// lane where dp = 1, INF at the band's edges.  The arithmetic is that
// program's, the int32 recurrence of _sweep_v3 without clamps and without
// validity masks (off-matrix cells hold whatever the recurrence computes
// there), so the strips equal its traceback byte for byte; the plain
// version is ops/nw_cuda.py::nw_align_sharded_reference.
//
// What bounds it on an H100: the handover.  A step's work is Wl cells
// spread over up to 1,024 threads, a few instructions each, but no shard
// can take step t before its neighbour has published step t - 1, so every
// anti-diagonal costs a round trip through L2 (or NVLink across devices)
// and two block barriers.  The design, simple first:
//   * one block per (pair, shard), the wide route's layout: lane l of the
//     shard on thread l % threads, the 11 DP rows (H at three anti-
//     diagonals, each gap state at two) in shared memory, or in a global
//     scratch where they do not fit, each row with a halo lane at either
//     end, so a framed read is a plain index;
//   * the handover: each block owns a ring of two slots in global memory
//     (slot t & 1: its first and its last lane of the six rows after step
//     t) and a flag, the count of steps it has published.  Thread 0 of a
//     block, between the step's two barriers: waits until both neighbours
//     have published step t - 1 (then neither still reads the slot it is
//     about to overwrite, which held step t - 2), writes its edge lanes
//     into slot t & 1, fences and raises its flag; then waits for the flag
//     of the neighbour it needs, reads that neighbour's slot and puts the
//     column into the halo lanes.  Flags are read with volatile loads and
//     followed, and raised after, a fence of the device's scope (the
//     system's when the shards span devices); a wait longer than 20 s
//     traps, so a lost neighbour fails the launch instead of hanging it;
//   * every block of a launch waits on others, so all must be resident at
//     once: the launch is cooperative (cudaLaunchCooperativeKernel) and the
//     wrapper refuses a grid larger than the resident capacity.  Shards on
//     several devices: one launch per device, the rings read through peer
//     access, every flag zeroed before any launch starts.
// Next step (ROADMAP.md §2): a thread-block cluster per pair, the columns
// exchanged through distributed shared memory with cluster barriers.

#include "nw_sweep.cuh"

constexpr int kRingSlot = 12;  // a slot: the first and the last lane of six rows
constexpr int kRingInts = 2 * kRingSlot;

template <bool SYS>
static __device__ __forceinline__ void fence() {
  if (SYS)
    __threadfence_system();
  else
    __threadfence();
}

static __device__ __forceinline__ int load_volatile(const int* p) {
  return *(const volatile int*)p;
}

static __device__ __forceinline__ void store_volatile(int* p, int v) { *(volatile int*)p = v; }

static __device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// spin until a neighbour has published `want` steps; what it wrote before
// raising its flag is visible afterwards.  A neighbour that never publishes
// (a block that is not resident, a fault elsewhere) ends the kernel with a
// trap after kSpinLimitNs instead of hanging the card
constexpr unsigned long long kSpinLimitNs = 20ull * 1000 * 1000 * 1000;

template <bool SYS>
static __device__ __forceinline__ void wait_flag(const int* flag, int want) {
  if (load_volatile(flag) < want) {
    const unsigned long long t0 = global_ns();
    while (load_volatile(flag) < want) {
      if (global_ns() - t0 > kSpinLimitNs) __trap();
    }
  }
  fence<SYS>();
}

template <bool TWO, bool SYS>
__global__ void __launch_bounds__(1024) nw_sweep_shard(
    const uint8_t* __restrict__ Q,         // [B, Lq] query codes, QPAD-padded
    const uint8_t* __restrict__ T,         // [B, Lt] target codes, TPAD-padded
    const int* __restrict__ qlens,         // [B]
    const int* __restrict__ tlens,         // [B]
    int* __restrict__ scores,              // [B] out, -1 where no shard of this launch sets it
    uint8_t* __restrict__ strips,          // [n_local, B, t_total + 1, Wl] out
    int* __restrict__ gscratch,            // [n_local * B, 11, Wl + 2] or null (shared memory)
    const unsigned long long* __restrict__ table,  // D ring pointers, then D flag pointers
    int B, int Lq, int Lt, int W, int D, int d_lo, int t_total,
    int mismatch, int o1, int e1, int o2, int e2) {
  extern __shared__ int rows_smem[];
  const int ls = blockIdx.x / B;  // the launch's shard
  const int b = blockIdx.x % B;
  const int d = d_lo + ls;
  const int Wl = W / D;
  const int off = d * Wl;
  const int K = W - 1;
  const int R = Wl + 2;  // a row: the left halo lane, Wl lanes, the right halo lane
  int* rows = gscratch ? gscratch + (size_t)blockIdx.x * NW_ROWS * R : rows_smem;
  int* H[3] = {rows, rows + R, rows + 2 * R};
  int* I1[2] = {rows + 3 * R, rows + 4 * R};
  int* D1[2] = {rows + 5 * R, rows + 6 * R};
  int* I2[2] = {rows + 7 * R, rows + 8 * R};
  int* D2[2] = {rows + 9 * R, rows + 10 * R};

  int* const* rings = (int* const*)table;
  int* const* flags = (int* const*)(table + D);
  int* my_ring = rings[d] + (size_t)b * kRingInts;
  int* my_flag = flags[d] + b;
  const int* left_ring = d > 0 ? rings[d - 1] + (size_t)b * kRingInts : nullptr;
  const int* left_flag = d > 0 ? flags[d - 1] + b : nullptr;
  const int* right_ring = d < D - 1 ? rings[d + 1] + (size_t)b * kRingInts : nullptr;
  const int* right_flag = d < D - 1 ? flags[d + 1] + b : nullptr;

  const int qlen = qlens[b];
  const int tlen = tlens[b];
  const int t_final = qlen + tlen;
  const uint8_t* q = Q + (size_t)b * Lq;
  const uint8_t* tg = T + (size_t)b * Lt;
  uint8_t* tbb = strips + (size_t)blockIdx.x * (t_total + 1) * Wl;

  // the state at t = 0 (H 0 at global lane 0) and t = -1, halos included
  // (a halo at the band's edge is never written again: INF); row 0 is zero
  for (int l = threadIdx.x; l < R; l += blockDim.x) {
    H[0][l] = off + l - 1 == 0 ? 0 : NW_INF;
    H[1][l] = NW_INF;
    H[2][l] = NW_INF;
    for (int s = 0; s < 2; ++s) {
      I1[s][l] = NW_INF;
      D1[s][l] = NW_INF;
      I2[s][l] = NW_INF;
      D2[s][l] = NW_INF;
    }
    if (l < Wl) tbb[l] = 0;
  }
  if (threadIdx.x == 0 && t_final == 0 && off == 0) scores[b] = 0;  // the origin is the final cell
  __syncthreads();

  for (int t = 1; t <= t_total; ++t) {
    const int k = t - 1;  // the rows hold the state after step k
    int* h1 = H[k % 3];
    int* h2 = H[(k + 2) % 3];
    int* hw = H[t % 3];
    const int rs = k & 1;
    const int ws = t & 1;
    const int i0 = i0_of(t, K);
    const int dp = i0 - i0_of(t - 1, K);
    const int dpp = i0 - i0_of(t - 2, K);

    if (threadIdx.x == 0 && D > 1) {
      int* cols[6] = {h1, h2, I1[rs], D1[rs], I2[rs], D2[rs]};
      // publish step k once both neighbours hold step k - 1
      if (left_flag) wait_flag<SYS>(left_flag, k);
      if (right_flag) wait_flag<SYS>(right_flag, k);
      int* slot = my_ring + (k & 1) * kRingSlot;
      for (int r = 0; r < 6; ++r) {
        store_volatile(slot + r, cols[r][1]);
        store_volatile(slot + 6 + r, cols[r][Wl]);
      }
      fence<SYS>();
      store_volatile(my_flag, k + 1);
      // the column this step shifts in
      if (dp == 0 && left_flag) {
        wait_flag<SYS>(left_flag, k + 1);
        const int* src = left_ring + (k & 1) * kRingSlot + 6;  // its last lane
        for (int r = 0; r < 6; ++r) cols[r][0] = load_volatile(src + r);
      } else if (dp == 1 && right_flag) {
        wait_flag<SYS>(right_flag, k + 1);
        const int* src = right_ring + (k & 1) * kRingSlot;  // its first lane
        for (int r = 0; r < 6; ++r) cols[r][Wl + 1] = load_volatile(src + r);
      }
    }
    __syncthreads();

    // window starts into the padded operands [QPAD] + q + [QPAD]*W and
    // [TPAD]*W + reverse(tg) + [TPAD]*W, clamped as a dynamic slice is
    const int qs = min(i0, Lq + 1);
    const int ts = max(0, min(Lt - t + i0 + W, Lt + W));
    uint8_t* tbrow = tbb + (size_t)t * Wl;
    for (int l = threadIdx.x; l < Wl; l += blockDim.x) {
      // lane l sits at index l + 1; a shift delta reads index l + 1 + delta
      const int h_up = h1[l + dp];
      const int h_left = h1[l + 1 + dp];
      const int h_diag = h2[l + dpp];
      const int i1_up = I1[rs][l + dp];
      const int d1_left = D1[rs][l + 1 + dp];
      const int g = off + l;
      const int x = qs + g;
      const int qc = (x >= 1 && x <= Lq) ? (int)q[x - 1] : NW_QPAD;
      const int y = ts + g;
      const int tc = (y >= W && y < W + Lt) ? (int)tg[Lt - 1 - (y - W)] : NW_TPAD;
      const int sub = qc == tc ? 0 : mismatch;

      int a = h_up + (o1 + e1);
      int c = i1_up + e1;
      const int I1n = min(a, c);
      const bool i1o = a <= c;
      a = h_left + (o1 + e1);
      c = d1_left + e1;
      const int D1n = min(a, c);
      const bool d1o = a <= c;
      int I2n = NW_INF, D2n = NW_INF;
      bool i2o = false, d2o = false;
      if (TWO) {
        a = h_up + (o2 + e2);
        c = I2[rs][l + dp] + e2;
        I2n = min(a, c);
        i2o = a <= c;
        a = h_left + (o2 + e2);
        c = D2[rs][l + 1 + dp] + e2;
        D2n = min(a, c);
        d2o = a <= c;
      }
      // strict '<' in the order D1, I1, D2, I2: ties keep the earlier choice
      int Hn = h_diag + sub;
      int choice = 0;
      if (D1n < Hn) { Hn = D1n; choice = 1; }
      if (I1n < Hn) { Hn = I1n; choice = 2; }
      if (D2n < Hn) { Hn = D2n; choice = 3; }
      if (I2n < Hn) { Hn = I2n; choice = 4; }

      hw[l + 1] = Hn;
      I1[ws][l + 1] = I1n;
      D1[ws][l + 1] = D1n;
      if (TWO) {
        I2[ws][l + 1] = I2n;
        D2[ws][l + 1] = D2n;
      }
      if (t == t_final && g == qlen - i0 && Hn < NW_INF) scores[b] = Hn;
      tbrow[l] = (uint8_t)(choice | ((int)i1o << 3) | ((int)i2o << 4) | ((int)d1o << 5) |
                           ((int)d2o << 6));
    }
    __syncthreads();
  }
}

static const void* pick_kernel(bool two, bool sys) {
  return two ? (sys ? (const void*)nw_sweep_shard<true, true> : (const void*)nw_sweep_shard<true, false>)
             : (sys ? (const void*)nw_sweep_shard<false, true> : (const void*)nw_sweep_shard<false, false>);
}

// Resident blocks per SM of the sharded mode at this launch shape (the
// fewer of its device- and system-scope instantiations) and the device's SM
// count.  Returns the CUDA error code.
extern "C" int nw_sweep_shard_capacity(int device, int two, int threads, int smem, int* per_sm,
                                       int* sms) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int best = 1 << 30;
  for (int sys = 0; sys < 2; ++sys) {
    const void* fn = pick_kernel(two != 0, sys != 0);
    err = allow_smem(fn, (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    best = n < best ? n : best;
  }
  *per_sm = best;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
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

// One cooperative launch of shards [d_lo, d_lo + n_local) of a D-shard sweep
// on `device`: n_local * B blocks of `threads`, `smem` bytes of dynamic
// shared memory each (0: the rows in scratch).  table: D ring pointers
// ([B, 24] int32 each, zeroed) and D flag pointers ([B] int32, zeroed), as
// int64, readable from `device`; multi selects system-scope fences (shards
// on several devices).  Returns the CUDA error code.
extern "C" int nw_sweep_shard_launch(const void* Q, const void* T, const void* qlens,
                                     const void* tlens, void* scores, void* strips, void* scratch,
                                     const void* table, int device, int multi, int B, int Lq,
                                     int Lt, int W, int D, int d_lo, int n_local, int t_total,
                                     int mismatch, int o1, int e1, int o2, int e2, int threads,
                                     int smem, void* stream) {
  if (B <= 0 || n_local <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = pick_kernel(o2 >= 0, multi != 0);
  err = allow_smem(fn, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const uint8_t* q_ = (const uint8_t*)Q;
  const uint8_t* t_ = (const uint8_t*)T;
  const int* ql_ = (const int*)qlens;
  const int* tl_ = (const int*)tlens;
  int* sc_ = (int*)scores;
  uint8_t* st_ = (uint8_t*)strips;
  int* scr_ = (int*)scratch;
  const unsigned long long* tab_ = (const unsigned long long*)table;
  void* args[] = {&q_, &t_, &ql_, &tl_, &sc_, &st_, &scr_, &tab_, &B, &Lq, &Lt, &W, &D,
                  &d_lo, &t_total, &mismatch, &o1, &e1, &o2, &e2};
  err = cudaLaunchCooperativeKernel(fn, dim3(n_local * B), dim3(threads), args, (size_t)smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
