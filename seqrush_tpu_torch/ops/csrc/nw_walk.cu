// Kernel B: reverse traceback walk over the sweep's packed traceback bytes.
//
// Replaces the Pallas kernel seqrush_tpu/ops/nw_pallas.py::_walk_kernel
// (wrapped by nw_walk_pallas).  Per pair the walk starts at t = qlen + tlen,
// lane qlen - i0(t), visits at most one cell per anti-diagonal, reads its
// packed byte and steps the 5-state machine (H, D1, I1, D2, I2).  Gap-state
// switches consume the same byte as the gap op.  The opcode (0 none, 1 M,
// 2 I, 3 D) lands at column td of a zero-filled [B, tmax + 1] row.  The
// reference scans every anti-diagonal and acts only where the pair's cursor
// sits; here the walk jumps from cursor to cursor, which visits the same
// cells in the same order and leaves the skipped columns at zero.  A cell
// outside [0, W) reads byte 0.  A step that consumes nothing ends the walk.
//
// What bounds it on an H100: the chain of a pair's steps (each cell's byte
// picks the next cell) with about one pair per SM sub-partition, so nothing
// overlaps a step's latency, and, where the pairs are many, the scattered
// 32-byte sectors its tiles read: the operations and the bytes it needs
// are tiny next to both.  Its own timer (WalkTimer, a timing tool's launch
// only) split the first design's pair at the default run's largest chunk
// into 65% waits for the next tile, with one tile of 64 rows prefetched,
// and at the gap-heavy window and sweepga gap chunks into some 2,100 gap
// steps taken one at a time (62-64%) and loads after the cursor left its
// tile sideways (22-25%); with 3 to 5 tiles in flight the largest chunk's
// waits stayed, about 2 sectors a row over 576 pairs.  The design:
//   * one warp per pair, WALK_PAIRS_PER_BLOCK pairs a block, so a
//     dispatch's pairs spread over the whole card;
//   * the warp walks a ring of tiles in shared memory, WALK_R = 64 rows
//     each; while it walks one, WALK_DEPTH more load below it by cp.async,
//     straight into shared memory, no registers held.  A tile is loaded
//     for a path, from the cursor where it was issued: the diagonal (the
//     same lane above K, one lane lost every two anti-diagonals at or below
//     it), or, in a gap, the gap's line carried on.  Each of its rows holds
//     the 32-byte sector that holds the path's lane there
//     (walk_row_window): one sector is the least a row's read moves (two
//     more tiles in flight, or a margin of 8 lanes each side, ran slower:
//     the sectors bound the largest chunk), and the windows follow the
//     path's slope, a steep gap's too, so only a gap that takes the cursor
//     off the path can leave them.  A gap run that leaves the path off the
//     next tile in flight has the tiles in flight loaded again, into free
//     slots of the ring while the ones they replace land unread; only a
//     cursor the tiles miss (the first tile, a gap leaving its window
//     sideways) waits for a load;
//   * in state H, thread k reads the cell k diagonal steps ahead and one
//     ballot finds the first that is not a diagonal choice: the run of
//     diagonal steps before it (matches and mismatches, most of a path) is
//     taken at once;
//   * a gap run likewise: in a gap state, and for the step that opens one
//     from H, thread k reads the cell k gap steps ahead along the gap's line
//     (one row down and gap_lane_shift lanes over a step), and one ballot
//     finds the first cell whose opened bit closes the gap, or the first out
//     of reach; the steps up to it are taken at once.
// Runs mode (nw_walk_runs_kernel; the counterpart of the XLA program
// seqrush_tpu/ops/nw.py::_tb_scan_tbw(emit="runs")): the same walk, but
// instead of one opcode a column the warp keeps the open run (op, length)
// and writes a token op | length << 2 (int32) when it closes: on an op
// change, or when the run has run_len_max steps (the next step of that op
// starts a new run, as the JAX scan's accumulator does).  A ballot's run of
// n steps extends the open run and splits it where the cap falls.  Tokens
// land at index `count` of the pair's [run_max] row while count < run_max,
// in walk order (the alignment's reverse); the count goes on past run_max,
// and the open run is flushed last.  It writes run_max + 1 words a pair
// instead of tmax + 1 bytes.
// Segment mode (nw_walk_seg_kernel; replaces seqrush_tpu/ops/nw.py::
// _tb_scan_segment, the reverse scan of nw_align_long): the traceback holds
// only the rows [t_lo, t_hi] of one segment, and the cursor (anti-diagonal,
// lane, gap state, done) comes from a carry [4, B] int32 and goes back to
// it.  The walk acts only on a cursor inside the segment, stops where it
// leaves it (td < t_lo), and stores the cursor; a walk that ended (done, or
// a step that consumed nothing) stays ended.  Tiles read no row below t_lo
// and no ballot takes a step from one.
// The long route's group walk is this kernel over a group's G * seg rows
// (kernel A's grouped recompute, [B, G * seg, W]) as one segment: the
// cursor crosses the group's segment boundaries inside the kernel, and a
// chunk takes one walk launch a group instead of one a segment.
// Start mode (replaces the start= argument of seqrush_tpu/ops/nw.py::
// _tb_scan_tbw, the bidirectional fold's half-walks): the segment kernel over
// a single-shot traceback [B, tmax_pad, W] as one segment of anti-diagonals
// [1, tmax] (its rows from tb + W, pairs tmax_pad rows apart), from the
// cursors the fold's combine chose (any anti-diagonal, lane and gap state);
// the opcodes land in [B, tmax + 1] as the single-shot walk's do.
// Tiled runs mode (nw_walk_runs_tiled_kernel; replaces the XLA program
// seqrush_tpu/ops/nw.py::_tb_scan_tiled): the runs mode over kernel A's
// tiled traceback, one warp a pair as everywhere else.  The JAX walk runs
// the n_tiles rows of a wide pair in lockstep and passes the owner tile's
// byte to the others by masked rolls, a layout forced by its batch-row
// vectors; here each pair is walked once at its own band (K_w for a wide
// pair), and only the tiles' loader knows the layout: lane l of the pair
// is row first + l / W, lane l % W, and a tile row's window lies in the
// tile row that holds the path's lane (a tile row under 32 lanes gives a
// window of its lanes alone).  Tokens and the count land on the pair's
// first row.

#include <cuda_runtime.h>
#include <stdint.h>

#define H_DIAG 0
#define H_D1 1
#define H_I1 2
#define H_D2 3
#define H_I2 4
#define OP_NONE 0
#define OP_M 1
#define OP_I 2
#define OP_D 3
#define FULL_MASK 0xffffffffu

// The design's constants; nw_cuda.py keeps copies (WALK_ROWS, WALK_DEPTH,
// WALK_PAIRS_PER_BLOCK) that the tests hold to these.
#define WALK_R 64                // tile rows (anti-diagonals)
#define WALK_DEPTH 2             // tiles loading below the one walked
#define WALK_PAIRS_PER_BLOCK 2   // one warp each
// the ring: the tile walked, WALK_DEPTH loading below it, and WALK_DEPTH
// more that a refetch loads into while the ones it replaces land unread
#define WALK_TILES (2 * WALK_DEPTH + 1)
#define WALK_RB 32  // bytes a tile row: one 32-byte sector
#define WALK_TILE_BYTES (WALK_R * WALK_RB)
// dynamic shared memory a block: each warp's ring of tiles and their rows' windows
#define WALK_SMEM (WALK_PAIRS_PER_BLOCK * WALK_TILES * (WALK_TILE_BYTES + 4 * WALK_R))

__device__ __forceinline__ int walk_i0_of(int t, int K) {
  const int x = t - K + 1;
  return x > 0 ? (x >> 1) : 0;
}

// Lanes lost by n diagonal steps from anti-diagonal td: one for each step
// taken at or below K.
__device__ __forceinline__ int corner_steps(int td, int K, int n) {
  const int above = td > K ? (td - K + 1) >> 1 : 0;  // steps taken above K
  return n > above ? n - above : 0;
}

// The lane moved by k gap steps from anti-diagonal td: the lane is i - i0(t),
// and a D step keeps i while an I step lowers it by one, so k steps move it
// by i0(td) - i0(td - k), less k in an I gap (del: a D gap).  Its twin in
// Python is nw_cuda.gap_lane_shift.
__device__ __forceinline__ int gap_lane_shift(int td, int K, int k, bool del) {
  return walk_i0_of(td, K) - walk_i0_of(td - k, K) - (del ? 0 : k);
}

// The path a tile is loaded for: from the cursor at (lane, td) in state m (0
// the diagonal; else the gap state, the gap taken to go on), the lane it
// holds at anti-diagonal t <= td.  (nw_cuda.walk_path_lane is its twin.)
struct WalkPath {
  int lane, td, m;
  __device__ __forceinline__ int lane_at(int t, int K) const {
    return m == 0 ? lane - corner_steps(td, K, (td - t) >> 1) : lane + gap_lane_shift(td, K, td - t, m & 1);
  }
};

// A tile row's window, packed: its first lane c0 (at the row's byte 0) and
// the bytes [s, e) that hold lanes of the pair's tile row.
__device__ __forceinline__ int walk_pack(int c0, int s, int e) {
  return (int)((unsigned)c0 << 14) | (e << 7) | s;
}

// The window of the tile row that holds lane `lane` (its byte at address
// addr) of a row of lanes [lo_lane, hi_lane) laid out contiguously: the
// 32-byte sector that holds the lane, the least a row's read moves.
// (nw_cuda.walk_row_window is its twin.)
__device__ __forceinline__ int walk_row_window(int lane, uintptr_t addr, int lo_lane, int hi_lane) {
  const int c0 = lane - (int)(addr & 31);
  return walk_pack(c0, max(0, lo_lane - c0), min(WALK_RB, hi_lane - c0));
}

__device__ __forceinline__ void walk_cp16(void* smem, uintptr_t gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void walk_cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most n of this thread's copy groups are pending.
__device__ __forceinline__ void walk_cp_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 3)
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (n == 4)
    asm volatile("cp.async.wait_group 4;\n" ::: "memory");
  else if (n == 5)
    asm volatile("cp.async.wait_group 5;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 6;\n" ::: "memory");
}

// Start loading the tile whose top row is `top`, along path P, into buf and
// its rows' windows into win: one cp.async commit group a thread (empty
// where it has no block).  Row rr is thread rr % 32's: its window is
// walk_row_window of the path's lane there (clamped to the band) in the
// pair's tile row that holds that lane, and it copies the window's 16-byte
// blocks that hold lanes of it, each inside the traceback (a block holds one
// of its bytes).  Rows below lo hold nothing.  A tile row narrower than a
// sector (tiled, W < 32) gives a window of its own lanes only.
template <bool TILED>
__device__ __forceinline__ void walk_load(uint8_t* buf, int* win, const WalkPath& P, int top, int lo, int x,
                                          int K, int Wp, int tw, size_t tstride, uintptr_t row0) {
  for (int rr = x; rr < WALK_R; rr += 32) {
    const int row = top - rr;
    if (row < lo) {
      win[rr] = walk_pack(0, 0, 0);
      continue;
    }
    const int p = min(max(P.lane_at(row, K), 0), Wp - 1);
    const int k = TILED ? p / tw : 0;  // the pair's tile row that holds it
    const int lo_lane = k * tw, hi_lane = TILED ? min(lo_lane + tw, Wp) : Wp;
    const uintptr_t a = row0 + (uintptr_t)k * tstride + (uintptr_t)row * tw + (uintptr_t)(p - lo_lane);
    const int w = walk_row_window(p, a, lo_lane, hi_lane);
    win[rr] = w;
    const int c0 = w >> 14, s = w & 127, e = (w >> 7) & 127;
    const uintptr_t g = a - (uintptr_t)(p - c0);  // lane c0's address, 32-byte aligned
#pragma unroll
    for (int j = 0; j < WALK_RB / 16; ++j)
      if (16 * j < e && 16 * j + 16 > s) walk_cp16(buf + rr * WALK_RB + 16 * j, g + 16 * j);
  }
  walk_cp_commit();
}

// The walk's own timer, on a timing tool's launch only (a null phase pointer
// everywhere else launches the untimed instantiations).  Every thread of the
// warp reads the same SM clock (clock64) at the same points; lane 0 adds the
// pair's cycles and counts by phase into phase[] at the end:
//   [0, WALK_PHASES) cycles: tile switches onto a prefetched tile (the wait
//     for its copies, and the copies issued below it), tile loads around a
//     cursor the tiles in flight missed (a sideways exit, or the first
//     tile), diagonal ballots, gap ballots (and the other single steps),
//     token writes (the run accumulator), refetches of the tiles in flight
//     along a path a gap moved;
//   [WALK_PHASES, 2 WALK_PHASES) the number of each;
//   then the pairs' cycles and %globaltimer nanoseconds, the longest pair's
//   cycles, and the pairs walked; then each pair's cycles, at its row.
#define WALK_PHASES 6
#define WALK_PH_SWITCH 0
#define WALK_PH_MISS 1
#define WALK_PH_BALLOT 2
#define WALK_PH_GAP 3
#define WALK_PH_TOKENS 4
#define WALK_PH_REFETCH 5
#define WALK_TIMER_SLOTS (2 * WALK_PHASES + 4)

__device__ __forceinline__ unsigned long long walk_global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool ON>
struct WalkTimer {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void lap(int, bool = true) {}
  __device__ __forceinline__ void finish(unsigned long long*, int, int) {}
};

template <>
struct WalkTimer<true> {
  long long cyc[WALK_PHASES] = {0, 0, 0, 0, 0, 0};
  int n[WALK_PHASES] = {0, 0, 0, 0, 0, 0};
  long long t0 = 0, last = 0;
  unsigned long long ns0 = 0;
  __device__ __forceinline__ void start() {
    ns0 = walk_global_ns();
    t0 = last = clock64();
  }
  // the time since the last lap goes to phase p (counted once where `count`)
  __device__ __forceinline__ void lap(int p, bool count = true) {
    const long long t = clock64();
#pragma unroll
    for (int k = 0; k < WALK_PHASES; ++k) {
      if (k == p) {
        cyc[k] += t - last;
        n[k] += count;
      }
    }
    last = t;
  }
  __device__ __forceinline__ void finish(unsigned long long* phase, int x, int b) {
    const long long total = clock64() - t0;
    const unsigned long long ns = walk_global_ns() - ns0;
    if (x == 0) {
#pragma unroll
      for (int k = 0; k < WALK_PHASES; ++k) {
        atomicAdd(phase + k, (unsigned long long)cyc[k]);
        atomicAdd(phase + WALK_PHASES + k, (unsigned long long)n[k]);
      }
      atomicAdd(phase + 2 * WALK_PHASES, (unsigned long long)total);
      atomicAdd(phase + 2 * WALK_PHASES + 1, ns);
      atomicMax(phase + 2 * WALK_PHASES + 2, (unsigned long long)total);
      atomicAdd(phase + 2 * WALK_PHASES + 3, 1ull);
      phase[WALK_TIMER_SLOTS + b] = (unsigned long long)total;
    }
  }
};

// The run accumulator of the runs mode, the same in every thread of the
// warp: n steps of op extend the open run (sym, len) up to run_len_max a
// token; a run that closes is stored at index count of tok while count <
// run_max, and counted either way.  Every thread stores the same word, so
// the warp never diverges around the store.
struct RunAcc {
  int sym = 0, len = 0, count = 0;

  __device__ __forceinline__ void close(int* tok, int run_max) {
    if (len > 0) {
      if (count < run_max) tok[count] = sym | (len << 2);
      ++count;
    }
  }

  __device__ __forceinline__ void add(int op, int n, int* tok, int run_max, int run_len_max) {
    if (n == 1 && op == sym && len < run_len_max) {  // a gap step inside its run
      ++len;
      return;
    }
    while (n > 0) {
      if (op == sym && len < run_len_max) {
        const int take = min(n, run_len_max - len);
        len += take;
        n -= take;
      } else {
        close(tok, run_max);
        sym = op;
        len = 0;
      }
    }
  }
};

// The walk of pair b.  Single-shot: from (qlen, tlen) over tb [B, tmax_pad,
// W] into ops [B, tmax + 1], or (RUNS) run tokens into tok [B, run_max] and
// the pair's run count into counts [B].  Segment mode: from the cursor in
// state [4, B] (cur_t, lane, mat, done) over the rows t_lo..t_hi of tb (row
// 0 is t_lo; pairs tmax_pad rows apart) into ops [B, ops_cols], and the
// cursor back into state.  Tiled (runs mode only): B pairs whose first rows
// are order[], the first n_wide of n_tiles * W lanes, in tile rows of W.
// Every value the control flow reads is the same in every thread (a
// ballot's, or a broadcast read of the tile), so the warp never diverges.
template <bool SEG, bool RUNS, bool TILED = false, bool TIMED = false>
__device__ __forceinline__ void walk_body(const uint8_t* __restrict__ tb,
                                          const int* __restrict__ qlens,
                                          const int* __restrict__ tlens, uint8_t* __restrict__ ops,
                                          int B, int W, int tmax, int tmax_pad, int* state,
                                          int t_lo, int t_hi, int ops_cols, int* tokens = nullptr,
                                          int* counts = nullptr, int run_max = 0,
                                          int run_len_max = 0, const int* order = nullptr,
                                          int n_wide = 0, int n_tiles = 1,
                                          unsigned long long* phase = nullptr) {
  extern __shared__ __align__(16) uint8_t walk_smem[];
  const int warp = threadIdx.x >> 5;
  const int x = threadIdx.x & 31;
  const int slot = blockIdx.x * WALK_PAIRS_PER_BLOCK + warp;
  if (slot >= B) return;
  const int b = TILED ? order[slot] : slot;
  const int tw = W;  // the tiled mode's tile-row width
  if (TILED && slot < n_wide) W *= n_tiles;  // the pair's lanes
  const int K = W - 1;
  const uint8_t* tbb = tb + (size_t)b * tmax_pad * tw;
  const size_t tstride = (size_t)tmax_pad * tw;
  uint8_t* out = RUNS ? nullptr : ops + (size_t)b * (SEG ? ops_cols : tmax + 1);
  int* tok = RUNS ? tokens + (size_t)b * run_max : nullptr;
  RunAcc acc;
  const int tmin = SEG ? t_lo : 1;  // the lowest anti-diagonal the walk may act on
  const int lo = SEG ? t_lo : 0;    // the traceback's first row
  const uintptr_t row0 = (uintptr_t)tbb - (uintptr_t)lo * (uintptr_t)tw;  // where row 0 would start
  uint8_t* ring = walk_smem + (size_t)warp * WALK_TILES * WALK_TILE_BYTES;
  int* wins = reinterpret_cast<int*>(walk_smem + (size_t)WALK_PAIRS_PER_BLOCK * WALK_TILES * WALK_TILE_BYTES) +
              (size_t)warp * WALK_TILES * WALK_R;

  // the cursor: cell (i, j) on anti-diagonal td = i + j, lane i - i0(td)
  int i, j, td;
  int mat = 0;  // 0 H, 1 D1, 2 I1, 3 D2, 4 I2
  if (SEG) {
    td = state[b];
    if (state[3 * B + b] || td < t_lo || td > t_hi) return;  // ended, or not in this segment
    i = walk_i0_of(td, K) + state[B + b];
    j = td - i;
    mat = state[2 * B + b];
  } else {
    i = qlens[b];
    j = tlens[b];
    td = i + j;
    if (td < 1 || td > tmax) return;  // nothing to walk (the ops row stays zero)
  }
  int lane = i - walk_i0_of(td, K);
  // The tile walked is in ring slot cs, rows top - R + 1 .. top; the cursor
  // sits at its row ur = top - td.  The nq tiles loading below it are in
  // slots qh, qh + 1, ..; fresh: the slots after them hold no copy in
  // flight.  None yet: the first pass loads a tile around the cursor.
  int cs = 0, qh = 1, nq = 0, top = -1;
  bool fresh = true;
  int ur = top - td;
  auto slot_at = [](int s, int q) { return (s + q) % WALK_TILES; };
  // whether tile slot s's row rr holds lane l (lanes off the band read 0 anywhere)
  auto holds = [&](int s, int rr, int l) -> bool {
    if ((unsigned)l >= (unsigned)W) return true;
    const int w = wins[s * WALK_R + rr];
    const int col = l - (w >> 14);
    return col >= (w & 127) && col < ((w >> 7) & 127);
  };
  // the byte of lane l in row rr of the tile walked; -1 where the tile does not hold it
  auto cell = [&](int rr, int l) -> int {
    if ((unsigned)l >= (unsigned)W) return 0;
    const int w = wins[cs * WALK_R + rr];
    const int col = l - (w >> 14);
    if (col < (w & 127) || col >= ((w >> 7) & 127)) return -1;
    return ring[cs * WALK_TILE_BYTES + rr * WALK_RB + col];
  };
  auto load = [&](int s, int t, const WalkPath& P) {
    walk_load<TILED>(ring + s * WALK_TILE_BYTES, wins + s * WALK_R, P, t, lo, x, K, W, tw, tstride, row0);
  };
  WalkTimer<TIMED> timer;
  timer.start();

  while (true) {
    if ((unsigned)ur >= WALK_R || cell(ur, lane) < 0) {
      __syncwarp();  // every thread has read the slot walked and sees the tiles' windows
      const int ntop = top - WALK_R;
      const bool hit = nq > 0 && (unsigned)(ntop - td) < WALK_R && holds(qh, ntop - td, lane);
      if (hit) {
        // the next tile holds the cursor: wait for its copies
        walk_cp_wait(nq - 1);
        cs = qh;
        qh = slot_at(qh, 1);
        --nq;
        top = ntop;
      } else {
        // load a tile around the cursor, on the path from it, into the slot
        // walked; the copies in flight land first
        top = td;
        load(cs, top, WalkPath{lane, td, mat});
        walk_cp_wait(0);
        qh = slot_at(cs, 1);
        nq = 0;
      }
      fresh = true;
      __syncwarp();
      ur = top - td;
      // keep WALK_DEPTH tiles loading below it, on the path from the cursor
      const WalkPath path{lane, td, mat};
      while (nq < WALK_DEPTH && top - WALK_R * (nq + 1) >= tmin) {
        load(slot_at(qh, nq), top - WALK_R * (nq + 1), path);
        ++nq;
      }
      timer.lap(hit ? WALK_PH_SWITCH : WALK_PH_MISS);
    }
    if (mat == 0) {
      // thread x looks x diagonal steps ahead.  A step there is taken if the
      // cell is in the tile, its choice is the diagonal, the walk has not
      // ended before it (it ends after step i - 1 when i == j) and every
      // step before it is taken; a run of n such steps is taken at once.
      const int k = x;
      const int row = ur + 2 * k;
      const int v = row < WALK_R && td - 2 * k >= tmin && (i != j || k < i)
                        ? cell(row, lane - corner_steps(td, K, k))
                        : -1;
      const bool reach = v >= 0;
      const bool take = reach && (v & 7) == H_DIAG;
      const unsigned run = __ballot_sync(FULL_MASK, take);
      const int n = run == FULL_MASK ? 32 : __ffs(~run) - 1;
      timer.lap(WALK_PH_BALLOT);
      if (n > 0) {
        if (RUNS) {
          acc.add(OP_M, n, tok, run_max, run_len_max);
          timer.lap(WALK_PH_TOKENS);
        } else if (x < n) {
          out[td - 2 * x] = OP_M;
        }
        lane -= corner_steps(td, K, n);
        ur += 2 * n;
        td -= 2 * n;
        i -= n;
        j -= n;
        const bool stop = (i == 0 && j == 0) || td < tmin;
        // the cell that stopped the run is decided below if it is in reach
        const bool again = stop || n == 32 || !((__ballot_sync(FULL_MASK, reach) >> n) & 1);
        timer.lap(WALK_PH_BALLOT, false);
        if (stop) break;
        if (again) continue;
      }
    }
    const int bb = cell(ur, lane);
    // g: the state this step leaves: 0 the diagonal, 1 D1, 2 I1, 3 D2, 4 I2
    const int g = mat ? mat : (bb & 7);
    if (g > 4) {  // a choice code no state has: the step consumes nothing
      if (!RUNS) out[td] = OP_NONE;
      if (SEG) mat = ((bb >> 4) & 1) ? 0 : 4;  // the reference's state after such a step
      timer.lap(WALK_PH_GAP);
      break;
    }
    if (g == 0) {
      // one diagonal step (the ballot takes every one it can reach)
      if (RUNS) {
        acc.add(OP_M, 1, tok, run_max, run_len_max);
      } else {
        out[td] = OP_M;
      }
      --i;
      --j;
      timer.lap(WALK_PH_GAP);
      if (i == 0 && j == 0) break;
      lane -= td > K ? 0 : 1;  // a diagonal step keeps the lane above K and loses one below
      ur += 2;
      td -= 2;
      if (td < tmin) break;
      continue;
    }
    // A gap run: the step that opens it from H (the gap state switch
    // consumes the same byte as the gap op), or the next in it, and the
    // steps after it.  Thread k reads the cell k gap steps ahead, one row
    // down and gap_lane_shift lanes over a step; the run goes up to the
    // first cell whose opened bit (5, 3, 6, 4 for D1, I1, D2, I2) closes the
    // gap, that cell's step included, or up to the first out of reach:
    // outside the tile, below tmin, or past the walk's end at i == 0 == j.
    const bool del = g & 1;  // D1 or D2: the target advances alone
    const int op = del ? OP_D : OP_I;
    const int bit = (0x46350 >> (4 * g)) & 15;
    const int k = x;
    const int row = ur + k;
    const int v = row < WALK_R && td - k >= tmin && (del ? (i != 0 || k < j) : (j != 0 || k < i))
                      ? cell(row, lane + gap_lane_shift(td, K, k, del))
                      : -1;
    const bool reach = v >= 0;
    const bool closes = reach && ((v >> bit) & 1);
    const unsigned in = __ballot_sync(FULL_MASK, reach);
    const unsigned shut = __ballot_sync(FULL_MASK, closes);
    const unsigned stop = ~in | shut;  // bit 0 is clear or closes: cell 0 is always in reach
    const int f = stop ? __ffs(stop) - 1 : 32;
    const bool closed = stop && ((shut >> f) & 1);
    const int n = closed ? f + 1 : f;
    timer.lap(WALK_PH_GAP);
    if (RUNS) {
      acc.add(op, n, tok, run_max, run_len_max);
      timer.lap(WALK_PH_TOKENS, false);
    } else if (x < n) {
      out[td - x] = (uint8_t)op;
    }
    if (del) {
      j -= n;
    } else {
      i -= n;
    }
    lane += gap_lane_shift(td, K, n, del);
    ur += n;
    td -= n;
    mat = closed ? 0 : g;
    timer.lap(WALK_PH_GAP, false);
    if ((i == 0 && j == 0) || td < tmin) break;
    if (nq > 0 && (unsigned)ur < WALK_R && cell(ur, lane) >= 0) {
      // the gap moved the path: where the next tile in flight does not hold
      // the path from here (the gap closed: the diagonal; else the gap going
      // on) at its top or bottom row, load the tiles in flight again on it,
      // into the slots after them (the tiles they replace land unread), or
      // in their place once those have landed if a refetch still fills them
      const WalkPath now{lane, td, mat};
      const int ntop = top - WALK_R;
      const int nlow = max(ntop - WALK_R + 1, tmin);
      __syncwarp();
      if (!holds(qh, 0, min(max(now.lane_at(ntop, K), 0), W - 1)) ||
          !holds(qh, ntop - nlow, min(max(now.lane_at(nlow, K), 0), W - 1))) {
        if (fresh) {
          qh = slot_at(qh, nq);
          fresh = false;
        } else {
          walk_cp_wait(0);
          __syncwarp();
        }
        for (int q = 0; q < nq; ++q) load(slot_at(qh, q), top - WALK_R * (q + 1), now);
        timer.lap(WALK_PH_REFETCH);
      }
    }
  }
  walk_cp_wait(0);  // no copy outlives the block's shared memory
  if (RUNS) {
    acc.close(tok, run_max);  // the open run: the alignment's first
    counts[b] = acc.count;
    timer.lap(WALK_PH_TOKENS, false);
  }
  timer.finish(phase, x, b);
  if (SEG && x == 0) {
    // the cursor after the last step: cell (i, j), whose anti-diagonal is
    // i + j (td is not moved by a step that ends the walk or consumes nothing)
    state[b] = i + j;
    state[B + b] = i - walk_i0_of(i + j, K);
    state[2 * B + b] = mat;
    state[3 * B + b] = i == 0 && j == 0;
  }
}

__global__ void __launch_bounds__(32 * WALK_PAIRS_PER_BLOCK) nw_walk_kernel(
    const uint8_t* __restrict__ tb,   // [B, tmax_pad, W]
    const int* __restrict__ qlens,    // [B]
    const int* __restrict__ tlens,    // [B]
    uint8_t* __restrict__ ops,        // [B, tmax + 1] out, zero-filled
    int B, int W, int tmax, int tmax_pad) {
  walk_body<false, false>(tb, qlens, tlens, ops, B, W, tmax, tmax_pad, nullptr, 0, 0, 0);
}

template <bool TIMED>
__global__ void __launch_bounds__(32 * WALK_PAIRS_PER_BLOCK) nw_walk_runs_kernel(
    const uint8_t* __restrict__ tb,   // [B, tmax_pad, W]
    const int* __restrict__ qlens,    // [B]
    const int* __restrict__ tlens,    // [B]
    int* __restrict__ tokens,         // [B, run_max] out, zero-filled
    int* __restrict__ counts,         // [B] out, zero-filled
    int B, int W, int tmax, int tmax_pad, int run_max, int run_len_max,
    unsigned long long* phase) {      // [WALK_TIMER_SLOTS] (TIMED only)
  walk_body<false, true, false, TIMED>(tb, qlens, tlens, nullptr, B, W, tmax, tmax_pad, nullptr, 0, 0,
                                       0, tokens, counts, run_max, run_len_max, nullptr, 0, 1, phase);
}

template <bool TIMED>
__global__ void __launch_bounds__(32 * WALK_PAIRS_PER_BLOCK) nw_walk_runs_tiled_kernel(
    const uint8_t* __restrict__ tb,   // [B, tmax_pad, W] in tile rows
    const int* __restrict__ qlens,    // [B] per row
    const int* __restrict__ tlens,    // [B] per row
    const int* __restrict__ order,    // [n_pairs] first rows: wide, then narrow
    int* __restrict__ tokens,         // [B, run_max] out, zero-filled
    int* __restrict__ counts,         // [B] out, zero-filled
    int n_pairs, int n_wide, int n_tiles, int W, int tmax, int tmax_pad, int run_max,
    int run_len_max, unsigned long long* phase) {
  walk_body<false, true, true, TIMED>(tb, qlens, tlens, nullptr, n_pairs, W, tmax, tmax_pad, nullptr,
                                      0, 0, 0, tokens, counts, run_max, run_len_max, order, n_wide,
                                      n_tiles, phase);
}

__global__ void __launch_bounds__(32 * WALK_PAIRS_PER_BLOCK) nw_walk_seg_kernel(
    const uint8_t* __restrict__ tb,   // row t_lo of pair 0; pairs pair_rows rows apart
    int* __restrict__ state,          // [4, B] cursor in and out
    uint8_t* __restrict__ ops,        // [B, ops_cols] out (columns t_lo..t_hi)
    int B, int W, int t_lo, int t_hi, int ops_cols, int pair_rows) {
  walk_body<true, false>(tb, nullptr, nullptr, ops, B, W, 0, pair_rows, state, t_lo, t_hi,
                         ops_cols);
}

// Launch kernel over B pairs, a warp each, with the rings in dynamic shared
// memory (above 48 KB after the opt-in).  Returns the CUDA error code.
template <typename... P, typename... A>
static int walk_launch(void (*kernel)(P...), int B, void* stream, A... args) {
  if (B <= 0) return (int)cudaSuccess;
  if (WALK_SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WALK_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + WALK_PAIRS_PER_BLOCK - 1) / WALK_PAIRS_PER_BLOCK;
  kernel<<<blocks, 32 * WALK_PAIRS_PER_BLOCK, WALK_SMEM, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

extern "C" int nw_walk_launch(
    const void* tb, const void* qlens, const void* tlens, void* ops,
    int B, int W, int tmax, int tmax_pad, void* stream) {
  return walk_launch(nw_walk_kernel, B, stream, (const uint8_t*)tb, (const int*)qlens,
                            (const int*)tlens, (uint8_t*)ops, B, W, tmax, tmax_pad);
}

// Slots of the walk's timer (phase of the launches below: null, or
// WALK_TIMER_SLOTS zero-filled uint64 that the timed instantiation adds to).
extern "C" int nw_walk_timer_slots() { return WALK_TIMER_SLOTS; }

// The runs mode: tokens [B, run_max] and counts [B] int32, both zero-filled
// by the caller.  Returns the CUDA error code.
extern "C" int nw_walk_runs_launch(
    const void* tb, const void* qlens, const void* tlens, void* tokens, void* counts,
    int B, int W, int tmax, int tmax_pad, int run_max, int run_len_max, void* phase, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (run_max < 1 || run_len_max < 1) return (int)cudaErrorInvalidValue;
  return walk_launch(phase ? nw_walk_runs_kernel<true> : nw_walk_runs_kernel<false>, B, stream,
                            (const uint8_t*)tb, (const int*)qlens, (const int*)tlens, (int*)tokens,
                            (int*)counts, B, W, tmax, tmax_pad, run_max, run_len_max,
                            (unsigned long long*)phase);
}

// The tiled runs mode over kernel A's tiled traceback: order [n_pairs] int32
// first rows, the n_wide wide pairs (n_tiles * W lanes in n_tiles rows)
// first; tokens [B, run_max] and counts [B] zero-filled by the caller, each
// pair's on its first row.  Returns the CUDA error code.
extern "C" int nw_walk_runs_tiled_launch(const void* tb, const void* qlens, const void* tlens,
                                         const void* order, void* tokens, void* counts, int n_pairs,
                                         int n_wide, int n_tiles, int W, int tmax, int tmax_pad,
                                         int run_max, int run_len_max, void* phase, void* stream) {
  if (n_pairs <= 0) return (int)cudaSuccess;
  if (run_max < 1 || run_len_max < 1 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  return walk_launch(phase ? nw_walk_runs_tiled_kernel<true> : nw_walk_runs_tiled_kernel<false>,
                           n_pairs, stream, (const uint8_t*)tb, (const int*)qlens, (const int*)tlens,
                           (const int*)order, (int*)tokens, (int*)counts, n_pairs, n_wide, n_tiles, W,
                           tmax, tmax_pad, run_max, run_len_max, (unsigned long long*)phase);
}

// One segment's walk: anti-diagonals [t_lo, t_hi] of the traceback rows at
// tb (row t_lo of pair 0; each pair's rows pair_rows >= t_hi - t_lo + 1 rows
// after the last pair's: a segment's [B, seg, W], or rows 1..tmax of a
// single-shot [B, tmax_pad, W] from its row 1 in the start mode), the cursor
// carry state [4, B] int32 (updated in place), opcodes into columns
// t_lo..t_hi of ops [B, ops_cols].  Returns the CUDA error code.
extern "C" int nw_walk_segment_launch(const void* tb, void* state, void* ops, int B, int W,
                                      int t_lo, int t_hi, int ops_cols, int pair_rows,
                                      void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (t_hi < t_lo || t_lo < 1 || ops_cols <= t_hi || pair_rows < t_hi - t_lo + 1)
    return (int)cudaErrorInvalidValue;
  return walk_launch(nw_walk_seg_kernel, B, stream, (const uint8_t*)tb, (int*)state, (uint8_t*)ops,
                            B, W, t_lo, t_hi, ops_cols, pair_rows);
}

// Registers per thread, resident blocks per SM and shared memory per block
// (its ring) of the walk's launch shape.
extern "C" int nw_walk_occupancy(int* regs, int* blocks_per_sm, int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, nw_walk_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem_bytes = (int)attr.sharedSizeBytes + WALK_SMEM;
  err = cudaFuncSetAttribute((const void*)nw_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WALK_SMEM);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, nw_walk_kernel, 32 * WALK_PAIRS_PER_BLOCK, WALK_SMEM);
}
