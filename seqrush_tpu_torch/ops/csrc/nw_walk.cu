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
// What bounds it on an H100: latency.  The steps of one pair form a chain
// (each cell's byte picks the next cell), a dispatch has about one pair per
// SM sub-partition, so nothing overlaps a step's latency; the bytes and
// operations it needs are tiny next to that chain.  The design shortens it:
//   * one warp per pair, four pairs per block, so a dispatch's pairs spread
//     over the whole card;
//   * the warp keeps a tile of the traceback in shared memory -- R = 64 rows
//     [top - R + 1, top] x C = 32 lanes [c0, c0 + C), one lane per thread,
//     bytes outside [0, W) as 0.  Going back one anti-diagonal moves the lane
//     by at most one, and along matches not at all, so a tile serves up to
//     R / 2 steps before its rows run out.  While the walk consumes one tile,
//     the next one (the R rows below it) is already loading into registers:
//     one coalesced byte load per row and thread, all in flight at once.
//     Tiles are centred on the lanes a path of matches would take: the same
//     lane, except in the band's corner (t <= K, where i0 is 0) where it
//     falls by one every two anti-diagonals.  Only a cursor that leaves a
//     tile sideways, after a long gap, waits for a load of its own;
//   * in state H, thread k reads the cell k diagonal steps ahead and one
//     ballot finds the first that is not a diagonal choice: the run of
//     diagonal steps before it (matches and mismatches, most of a path) is
//     taken at once, one opcode per thread;
//   * gap steps go one at a time, with the cursor kept as its row and column
//     in the tile and moved by the step's fixed offset, and every thread
//     storing the same opcode, so the warp never diverges.
// Runs mode (nw_walk_runs_kernel; the counterpart of the XLA program
// seqrush_tpu/ops/nw.py::_tb_scan_tbw(emit="runs")): the same walk, the same
// cursor and tiles, but instead of one opcode a column the warp keeps the
// open run (op, length) and writes a token op | length << 2 (int32) when it
// closes: on an op change, or when the run has run_len_max steps (the next
// step of that op starts a new run, as the JAX scan's accumulator does).  A
// diagonal ballot of n steps extends the open M run and splits it where the
// cap falls.  Tokens land at index `count` of the pair's [run_max] row while
// count < run_max, in walk order (the alignment's reverse); the count goes
// on past run_max, and the open run is flushed last.  What bounds it is the
// walk's own chain of steps; it writes run_max + 1 words a pair instead of
// tmax + 1 bytes.
// Segment mode (nw_walk_seg_kernel; replaces seqrush_tpu/ops/nw.py::
// _tb_scan_segment, the reverse scan of nw_align_long): the traceback holds
// only the rows [t_lo, t_hi] of one segment, and the cursor (anti-diagonal,
// lane, gap state, done) comes from a carry [4, B] int32 and goes back to
// it.  The walk acts only on a cursor inside the segment, stops where it
// leaves it (td < t_lo), and stores the cursor; a walk that ended (done, or
// a step that consumed nothing) stays ended.  Tiles read no row below t_lo
// (they hold zeros there) and the diagonal ballot takes no step from one.
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
// pair), and only the tile loader knows the layout: lane l of the pair is
// row first + l / W, lane l % W.  A 32-lane window may straddle two tile
// rows (W not a multiple of 32); each thread loads its own lane's column, so
// it reads from whichever tile row holds it.  Tokens and the count land on
// the pair's first row.

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

#define WALK_R 64                // tile rows
#define WALK_C 32                // tile lanes: one per thread
#define WALK_PAIRS_PER_BLOCK 4   // one warp each

__device__ __forceinline__ int walk_i0_of(int t, int K) {
  const int x = t - K + 1;
  return x > 0 ? (x >> 1) : 0;
}

// Lanes a path of matches loses over the rows top - R + 1 .. top: one per
// two anti-diagonals at or below K, none above.
__device__ __forceinline__ int corner_drift(int top, int K) {
  const int rows = min(top, K) - max(top - WALK_R, 0);
  return rows > 0 ? rows / 2 : 0;
}

// Lanes lost by n diagonal steps from anti-diagonal td: one for each step
// taken at or below K.
__device__ __forceinline__ int corner_steps(int td, int K, int n) {
  const int above = td > K ? (td - K + 1) >> 1 : 0;  // steps taken above K
  return n > above ? n - above : 0;
}

// This thread's column (lane c0 + x) of the tile whose top row is `top`,
// one byte per 32-bit register: nothing reads the registers until the tile
// is stored, so the loads stay in flight while the walk goes on.
// In segment mode tbb's row 0 is anti-diagonal rlo, and rows below it read 0.
// In the tiled mode the pair's W lanes lie in tile rows of tw lanes,
// tstride bytes apart.
template <bool SEG, bool TILED = false>
__device__ __forceinline__ void load_tile(uint32_t (&col)[WALK_R], const uint8_t* __restrict__ tbb,
                                          int top, int c0, int x, int W, int rlo, int tw = 0,
                                          size_t tstride = 0) {
  const int l = c0 + x;
  const bool in_band = l >= 0 && l < W;
  const uint8_t* colp = tbb;  // the tiled mode's column: its tile row, lane l % tw
  if (TILED && in_band) {
    const int tile = l / tw;
    colp = tbb + tile * tstride + (l - tile * tw);
  }
#pragma unroll
  for (int rr = 0; rr < WALK_R; ++rr) {
    const int row = top - rr;
    col[rr] = (in_band && row >= (SEG ? rlo : 0))
                  ? (uint32_t)__ldg(TILED ? colp + (size_t)row * tw
                                          : tbb + (size_t)(SEG ? row - rlo : row) * W + l)
                  : 0u;
  }
}

__device__ __forceinline__ void store_tile(uint8_t (*tile)[WALK_C], const uint32_t (&col)[WALK_R],
                                           int x) {
#pragma unroll
  for (int rr = 0; rr < WALK_R; ++rr) tile[rr][x] = (uint8_t)col[rr];
}

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
template <bool SEG, bool RUNS, bool TILED = false>
__device__ __forceinline__ void walk_body(const uint8_t* __restrict__ tb,
                                          const int* __restrict__ qlens,
                                          const int* __restrict__ tlens, uint8_t* __restrict__ ops,
                                          int B, int W, int tmax, int tmax_pad, int* state,
                                          int t_lo, int t_hi, int ops_cols, int* tokens = nullptr,
                                          int* counts = nullptr, int run_max = 0,
                                          int run_len_max = 0, const int* order = nullptr,
                                          int n_wide = 0, int n_tiles = 1) {
  __shared__ uint8_t tiles[WALK_PAIRS_PER_BLOCK][2][WALK_R][WALK_C];
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
  // tile in use (`cur`): rows top - R + 1 .. top, lanes c0 .. c0 + C - 1;
  // the cursor sits at row ur = top - td, column uc = lane - c0 of it.  The
  // next tile loads into `next`: rows ntop - R + 1 .. ntop, lanes nc0 ..
  uint8_t* cur = &tiles[warp][0][0][0];
  uint8_t* spare = &tiles[warp][1][0][0];
  int top = -1, c0 = 0;
  int ntop = -1, nc0 = 0;
  int ur = top - td;
  int uc = i - walk_i0_of(td, K) - c0;
  uint32_t next[WALK_R];

  while (true) {
    if ((unsigned)ur >= WALK_R || (unsigned)uc >= WALK_C) {
      const int lane = c0 + uc;
      if ((unsigned)(ntop - td) >= WALK_R || (unsigned)(lane - nc0) >= WALK_C) {
        ntop = td;  // the prefetched tile misses the cursor: load one around it
        nc0 = lane - min(corner_drift(td, K) / 2 + WALK_C / 2, WALK_C - 1);
        load_tile<SEG, TILED>(next, tbb, ntop, nc0, x, W, t_lo, tw, tstride);
      }
      __syncwarp();  // every thread has finished reading the buffer replaced now
      uint8_t* t = spare;
      spare = cur;
      cur = t;
      store_tile(reinterpret_cast<uint8_t(*)[WALK_C]>(cur), next, x);
      __syncwarp();
      top = ntop;
      c0 = nc0;
      ur = top - td;
      uc = lane - c0;
      ntop = top - WALK_R;  // prefetch the rows below
      nc0 = lane - corner_drift(td, K) - corner_drift(ntop, K) / 2 - WALK_C / 2;
      load_tile<SEG, TILED>(next, tbb, ntop, nc0, x, W, t_lo, tw, tstride);
    }
    if (mat == 0) {
      // thread x looks x diagonal steps ahead.  A step there is taken if the
      // cell is in the tile, its choice is the diagonal, the walk has not
      // ended before it (it ends after step i - 1 when i == j) and every
      // step before it is taken; a run of n such steps is taken at once.
      const int k = x;
      const int row = ur + 2 * k;
      const int col = uc - corner_steps(td, K, k);
      const bool reach = row < WALK_R && (unsigned)col < WALK_C && td - 2 * k >= tmin &&
                         (i != j || k < i);
      const bool take = reach && (cur[row * WALK_C + col] & 7) == H_DIAG;
      const unsigned run = __ballot_sync(FULL_MASK, take);
      const int n = run == FULL_MASK ? 32 : __ffs(~run) - 1;
      if (n > 0) {
        if (RUNS) {
          acc.add(OP_M, n, tok, run_max, run_len_max);
        } else if (x < n) {
          out[td - 2 * x] = OP_M;
        }
        uc -= corner_steps(td, K, n);
        ur += 2 * n;
        td -= 2 * n;
        i -= n;
        j -= n;
        if ((i == 0 && j == 0) || td < tmin) break;
        // the cell that stopped the run is decided below if it is in reach
        if (n == 32 || !((__ballot_sync(FULL_MASK, reach) >> n) & 1)) continue;
      }
    }
    const int bb = cur[ur * WALK_C + uc];
    // g: the state this step leaves: 0 the diagonal, 1 D1, 2 I1, 3 D2, 4 I2
    const int g = mat ? mat : (bb & 7);
    if (g > 4) {  // a choice code no state has: the step consumes nothing
      if (!RUNS) out[td] = OP_NONE;
      if (SEG) mat = ((bb >> 4) & 1) ? 0 : 4;  // the reference's state after such a step
      break;
    }
    const bool diag = g == 0;
    const bool del = g & 1;  // D1 or D2: the target advances alone
    // every thread stores the same byte: no divergence around the store
    const int op = diag ? OP_M : del ? OP_D : OP_I;
    if (RUNS) {
      acc.add(op, 1, tok, run_max, run_len_max);
    } else {
      out[td] = (uint8_t)op;
    }
    // the opened bit of D1, I1, D2, I2 is bit 5, 3, 6, 4
    const bool opened = (bb >> ((0x46350 >> (4 * g)) & 15)) & 1;
    mat = (diag || opened) ? 0 : g;
    if (!del) --i;
    if (diag || del) --j;
    if (i == 0 && j == 0) break;
    // the lane moves by i0(td) - i0(td') less what i lost: i0 grows by one
    // every two anti-diagonals above K (dp: on this one) and not at all
    // below, so a diagonal step keeps the lane above K and loses one below
    const bool above = td > K;
    const int dp = above ? (td - K) & 1 : 0;
    const int drow = diag ? 2 : 1;
    uc += diag ? (above ? 0 : -1) : del ? dp : dp - 1;
    ur += drow;
    td -= drow;
    if (td < tmin) break;
  }
  if (RUNS) {
    acc.close(tok, run_max);  // the open run: the alignment's first
    counts[b] = acc.count;
  }
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

__global__ void __launch_bounds__(32 * WALK_PAIRS_PER_BLOCK) nw_walk_runs_kernel(
    const uint8_t* __restrict__ tb,   // [B, tmax_pad, W]
    const int* __restrict__ qlens,    // [B]
    const int* __restrict__ tlens,    // [B]
    int* __restrict__ tokens,         // [B, run_max] out, zero-filled
    int* __restrict__ counts,         // [B] out, zero-filled
    int B, int W, int tmax, int tmax_pad, int run_max, int run_len_max) {
  walk_body<false, true>(tb, qlens, tlens, nullptr, B, W, tmax, tmax_pad, nullptr, 0, 0, 0, tokens,
                         counts, run_max, run_len_max);
}

__global__ void __launch_bounds__(32 * WALK_PAIRS_PER_BLOCK) nw_walk_runs_tiled_kernel(
    const uint8_t* __restrict__ tb,   // [B, tmax_pad, W] in tile rows
    const int* __restrict__ qlens,    // [B] per row
    const int* __restrict__ tlens,    // [B] per row
    const int* __restrict__ order,    // [n_pairs] first rows: wide, then narrow
    int* __restrict__ tokens,         // [B, run_max] out, zero-filled
    int* __restrict__ counts,         // [B] out, zero-filled
    int n_pairs, int n_wide, int n_tiles, int W, int tmax, int tmax_pad, int run_max,
    int run_len_max) {
  walk_body<false, true, true>(tb, qlens, tlens, nullptr, n_pairs, W, tmax, tmax_pad, nullptr, 0, 0,
                               0, tokens, counts, run_max, run_len_max, order, n_wide, n_tiles);
}

__global__ void __launch_bounds__(32 * WALK_PAIRS_PER_BLOCK) nw_walk_seg_kernel(
    const uint8_t* __restrict__ tb,   // row t_lo of pair 0; pairs pair_rows rows apart
    int* __restrict__ state,          // [4, B] cursor in and out
    uint8_t* __restrict__ ops,        // [B, ops_cols] out (columns t_lo..t_hi)
    int B, int W, int t_lo, int t_hi, int ops_cols, int pair_rows) {
  walk_body<true, false>(tb, nullptr, nullptr, ops, B, W, 0, pair_rows, state, t_lo, t_hi,
                         ops_cols);
}

extern "C" int nw_walk_launch(
    const void* tb, const void* qlens, const void* tlens, void* ops,
    int B, int W, int tmax, int tmax_pad, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int blocks = (B + WALK_PAIRS_PER_BLOCK - 1) / WALK_PAIRS_PER_BLOCK;
  nw_walk_kernel<<<blocks, 32 * WALK_PAIRS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tb, (const int*)qlens, (const int*)tlens, (uint8_t*)ops,
      B, W, tmax, tmax_pad);
  return (int)cudaGetLastError();
}

// The runs mode: tokens [B, run_max] and counts [B] int32, both zero-filled
// by the caller.  Returns the CUDA error code.
extern "C" int nw_walk_runs_launch(
    const void* tb, const void* qlens, const void* tlens, void* tokens, void* counts,
    int B, int W, int tmax, int tmax_pad, int run_max, int run_len_max, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (run_max < 1 || run_len_max < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (B + WALK_PAIRS_PER_BLOCK - 1) / WALK_PAIRS_PER_BLOCK;
  nw_walk_runs_kernel<<<blocks, 32 * WALK_PAIRS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tb, (const int*)qlens, (const int*)tlens, (int*)tokens, (int*)counts,
      B, W, tmax, tmax_pad, run_max, run_len_max);
  return (int)cudaGetLastError();
}

// The tiled runs mode over kernel A's tiled traceback: order [n_pairs] int32
// first rows, the n_wide wide pairs (n_tiles * W lanes in n_tiles rows)
// first; tokens [B, run_max] and counts [B] zero-filled by the caller, each
// pair's on its first row.  Returns the CUDA error code.
extern "C" int nw_walk_runs_tiled_launch(const void* tb, const void* qlens, const void* tlens,
                                         const void* order, void* tokens, void* counts, int n_pairs,
                                         int n_wide, int n_tiles, int W, int tmax, int tmax_pad,
                                         int run_max, int run_len_max, void* stream) {
  if (n_pairs <= 0) return (int)cudaSuccess;
  if (run_max < 1 || run_len_max < 1 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_pairs + WALK_PAIRS_PER_BLOCK - 1) / WALK_PAIRS_PER_BLOCK;
  nw_walk_runs_tiled_kernel<<<blocks, 32 * WALK_PAIRS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tb, (const int*)qlens, (const int*)tlens, (const int*)order, (int*)tokens,
      (int*)counts, n_pairs, n_wide, n_tiles, W, tmax, tmax_pad, run_max, run_len_max);
  return (int)cudaGetLastError();
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
  const int blocks = (B + WALK_PAIRS_PER_BLOCK - 1) / WALK_PAIRS_PER_BLOCK;
  nw_walk_seg_kernel<<<blocks, 32 * WALK_PAIRS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tb, (int*)state, (uint8_t*)ops, B, W, t_lo, t_hi, ops_cols, pair_rows);
  return (int)cudaGetLastError();
}

// Registers per thread and resident blocks per SM of the walk's launch shape.
extern "C" int nw_walk_occupancy(int* regs, int* blocks_per_sm, int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, nw_walk_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, nw_walk_kernel, 32 * WALK_PAIRS_PER_BLOCK, 0);
}
