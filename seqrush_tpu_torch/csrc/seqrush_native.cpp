// Host library of seqrush_tpu_torch: the colinear anchor chaining and the
// exact window DP of the anchored wide route and the sweepga backend, and
// the sweepga backend's record stitch, as a plain C ABI loaded with ctypes
// (seqrush_tpu_torch/native.py).
//
// A copy of those parts of the JAX package's csrc/seqrush_native.cpp:
// chain_anchors, chain_to_runs_cpp and chain_pairs (bit-identical to
// ops/anchors.py chain_anchors_multi + chain_to_runs per pair), window_dp_one
// and window_dp (full-matrix two-piece Gotoh with the kernels' walk-order tie
// preference), and stitch_records (bit-identical to
// align/sweep.py::SweepAligner._stitch_python).  The arithmetic is
// unchanged, so both libraries give the same chains, scores, CIGARs and
// records; native.py compiles this file with
// -ffp-contract=off so that the chain score, a sum of doubles, is rounded
// the same way on every host.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Colinear anchor-chaining DP: 64-anchor lookback, weight
// f[j] + k - 0.05*skew - 0.01*max(dq, dt), first-max argmax, strict
// improvement test.  anchors must be pre-sorted by (q, t).  Writes the best
// chain's indices (ascending) into out_idx; returns its length.
int64_t chain_anchors(const int64_t* qs, const int64_t* ts, int64_t n,
                      int64_t k, int64_t max_gap, int64_t max_skew,
                      int64_t* out_idx) {
  if (n <= 0) return 0;
  std::vector<double> f((size_t)n, (double)k);
  std::vector<int64_t> pred((size_t)n, -1);
  for (int64_t i = 0; i < n; ++i) {
    int64_t qi = qs[i], ti = ts[i];
    int64_t j0 = i - 64;
    if (j0 < 0) j0 = 0;
    double best_gain = -1.0;
    int64_t best_j = -1;
    for (int64_t j = j0; j < i; ++j) {
      int64_t qj = qs[j], tj = ts[j];
      if (!(qj < qi && tj < ti)) continue;
      int64_t dq = qi - qj, dt = ti - tj;
      if (dq > max_gap || dt > max_gap) continue;
      int64_t skew = dq - dt;
      if (skew < 0) skew = -skew;
      if (skew > max_skew) continue;
      double gain = f[(size_t)j] + (double)k - 0.05 * (double)skew -
                    0.01 * (double)(dq > dt ? dq : dt);
      if (best_j < 0 || gain > best_gain) {  // strict: first max wins
        best_gain = gain;
        best_j = j;
      }
    }
    if (best_j >= 0 && best_gain > f[(size_t)i]) {
      f[(size_t)i] = best_gain;
      pred[(size_t)i] = best_j;
    }
  }
  int64_t end = 0;
  for (int64_t i = 1; i < n; ++i)
    if (f[(size_t)i] > f[(size_t)end]) end = i;  // first max wins
  std::vector<int64_t> chain;
  while (end >= 0) {
    chain.push_back(end);
    end = pred[(size_t)end];
  }
  int64_t m = (int64_t)chain.size();
  for (int64_t c = 0; c < m; ++c) out_idx[c] = chain[(size_t)(m - 1 - c)];
  return m;
}

// chain_to_runs (ops/anchors.py chain_to_runs_spec, bit-identical): merge
// chained anchors into maximal exact-match runs; colinear overlaps
// coalesce, cross-diagonal overlaps trim the later run's start.
void chain_to_runs_cpp(const int64_t* qs, const int64_t* ts,
                              const int64_t* idx, int64_t m, int64_t k,
                              std::vector<int64_t>& rq,
                              std::vector<int64_t>& rt,
                              std::vector<int64_t>& rl) {
  rq.clear();
  rt.clear();
  rl.clear();
  for (int64_t c = 0; c < m; ++c) {
    int64_t qpos = qs[idx[c]], tpos = ts[idx[c]];
    if (!rq.empty()) {
      int64_t q0 = rq.back(), t0 = rt.back(), ln = rl.back();
      if (qpos - q0 == tpos - t0 && qpos <= q0 + ln) {
        int64_t ext = qpos + k - q0;
        rl.back() = ln > ext ? ln : ext;
        continue;
      }
      int64_t d1 = q0 + ln - qpos, d2 = t0 + ln - tpos;
      int64_t delta = d1 > d2 ? d1 : d2;
      if (delta < 0) delta = 0;
      if (delta >= k) continue;  // fully shadowed
      if (delta > 0) {
        rq.push_back(qpos + delta);
        rt.push_back(tpos + delta);
        rl.push_back(k - delta);
        continue;
      }
    }
    rq.push_back(qpos);
    rt.push_back(tpos);
    rl.push_back(k);
  }
}

}  // namespace

extern "C" {

// Batched multi-chain extraction + run merging over many pairs in ONE
// call (the anchored wide route takes max_chains = 1; bit-identical to
// ops/anchors.py chain_anchors + chain_to_runs over each pair).
// qs/ts: anchors of all pairs concatenated, each pair's block pre-sorted
// by (q, t); offs[p]..offs[p+1] delimits pair p.  Emits maximal
// exact-match runs per kept chain:
//   runs_q/runs_t/runs_len (capacity >= total anchor count),
//   chain_pair[c] = pair index, chain_off[c+1] = flat run offsets
//   (chain_off[0] = 0).  Returns the number of chains.
int64_t chain_pairs(const int64_t* qs, const int64_t* ts, const int64_t* offs,
                    int64_t n_pairs, int64_t k, int64_t max_gap,
                    int64_t max_skew, int64_t max_chains, int64_t min_matched,
                    int64_t* runs_q, int64_t* runs_t, int64_t* runs_len,
                    int64_t* chain_pair, int64_t* chain_off) {
  int64_t n_chains = 0, run_pos = 0;
  chain_off[0] = 0;
  std::vector<int64_t> rq, rt, idx, crq, crt, crl;
  for (int64_t p = 0; p < n_pairs; ++p) {
    int64_t n = offs[p + 1] - offs[p];
    if (n <= 0) continue;
    rq.assign(qs + offs[p], qs + offs[p + 1]);
    rt.assign(ts + offs[p], ts + offs[p + 1]);
    idx.resize((size_t)n);
    int64_t pair_chains = 0;
    int64_t rem = n;
    while (rem > 0 && pair_chains < max_chains) {
      int64_t m =
          chain_anchors(rq.data(), rt.data(), rem, k, max_gap, max_skew,
                        idx.data());
      if (m == 0) break;
      chain_to_runs_cpp(rq.data(), rt.data(), idx.data(), m, k, crq, crt, crl);
      int64_t matched = 0;
      for (int64_t r = 0; r < (int64_t)crl.size(); ++r) matched += crl[r];
      if (matched < min_matched && pair_chains > 0) break;
      chain_pair[n_chains] = p;
      for (size_t r = 0; r < crq.size(); ++r) {
        runs_q[run_pos] = crq[r];
        runs_t[run_pos] = crt[r];
        runs_len[run_pos] = crl[r];
        ++run_pos;
      }
      chain_off[++n_chains] = run_pos;
      ++pair_chains;
      if (matched < min_matched) break;
      // remove anchors inside the chain's q AND t span (repeat copies
      // mapping elsewhere survive to seed secondary chains)
      int64_t q0 = rq[(size_t)idx[0]], q1 = rq[(size_t)idx[m - 1]] + k;
      int64_t t0 = rt[(size_t)idx[0]], t1 = rt[(size_t)idx[m - 1]] + k;
      int64_t w = 0;
      for (int64_t i = 0; i < rem; ++i) {
        bool inside = rq[(size_t)i] >= q0 && rq[(size_t)i] < q1 &&
                      rt[(size_t)i] >= t0 && rt[(size_t)i] < t1;
        if (!inside) {
          rq[(size_t)w] = rq[(size_t)i];
          rt[(size_t)w] = rt[(size_t)i];
          ++w;
        }
      }
      if (w == rem) break;  // chain removed nothing: avoid an endless loop
      rem = w;
    }
  }
  return n_chains;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host window DP: exact two-piece-affine global alignment of small windows.
// Full-matrix exact DP with run-length '='/'X'/'I'/'D' output; optimal scores
// equal the device kernel's.  Tie preference mirrors the kernels' walk order
// (diag first, then D1, I1, D2, I2); an equal-score CIGAR may still differ
// from the device walk's in a tie, so the route sends each window to the host
// or to the device by the same budgets as the JAX package.
// ---------------------------------------------------------------------------

namespace {

constexpr int32_t kInf = INT32_MAX / 4;

struct WinPen {
  int32_t mismatch, o1, e1, o2, e2;  // o2 < 0 => one-piece
};

// traceback byte: bits 0-2 H choice (0 diag, 1 D1, 2 I1, 3 D2, 4 I2),
// bit 3 D1-extend, bit 4 I1-extend, bit 5 D2-extend, bit 6 I2-extend.
// Templated on TWO (two-piece penalties) and written with ternaries so
// the hot j-loop compiles branch-free (cmov/setcc): per-cell cost is what
// the host windows cost.
template <bool TWO>
static void window_dp_one(const uint8_t* q, int64_t n, const uint8_t* t,
                          int64_t m, const WinPen& p, int32_t* out_score,
                          uint8_t* out_ops, int32_t* out_lens,
                          int64_t* out_count, std::vector<uint8_t>& tb,
                          std::vector<int32_t>& rows) {
  const int64_t W = m + 1;
  tb.assign((size_t)((n + 1) * W), 0);
  // rolling rows: H, D1, I1, D2, I2 (prev H needed for diag)
  rows.assign((size_t)(6 * W), kInf);
  int32_t* H = rows.data();
  int32_t* Hprev = rows.data() + W;
  int32_t* D1 = rows.data() + 2 * W;
  int32_t* I1 = rows.data() + 3 * W;
  int32_t* D2 = rows.data() + 4 * W;
  int32_t* I2 = rows.data() + 5 * W;
  const int32_t mm = p.mismatch, e1 = p.e1, oe1 = p.o1 + p.e1;
  const int32_t e2 = TWO ? p.e2 : 0, oe2 = TWO ? p.o2 + p.e2 : 0;
  H[0] = 0;
  for (int64_t j = 1; j <= m; ++j) {
    int32_t d1 = (j == 1 ? H[0] + oe1 : D1[j - 1] + e1);
    int32_t od1 = (j == 1 ? kInf : H[j - 1] + oe1);
    uint8_t bits = 0;
    if (d1 <= od1) bits |= 8;  // extend preferred on ties
    else d1 = od1;
    D1[j] = d1;
    int32_t best = d1;
    uint8_t choice = 1;
    if (TWO) {
      int32_t d2 = (j == 1 ? H[0] + oe2 : D2[j - 1] + e2);
      int32_t od2 = (j == 1 ? kInf : H[j - 1] + oe2);
      if (d2 <= od2) bits |= 32;
      else d2 = od2;
      D2[j] = d2;
      if (d2 < best) { best = d2; choice = 3; }
    }
    H[j] = best;
    tb[(size_t)j] = (uint8_t)(bits | choice);
  }
  for (int64_t i = 1; i <= n; ++i) {
    std::swap(H, Hprev);
    // column 0: only I layers
    int32_t i1 = (i == 1 ? Hprev[0] + oe1 : I1[0] + e1);
    int32_t oi1 = (i == 1 ? kInf : Hprev[0] + oe1);
    uint8_t bits0 = 0;
    if (i1 <= oi1) bits0 |= 16;
    else i1 = oi1;
    I1[0] = i1;
    int32_t best0 = i1;
    uint8_t choice0 = 2;
    if (TWO) {
      int32_t i2 = (i == 1 ? Hprev[0] + oe2 : I2[0] + e2);
      int32_t oi2 = (i == 1 ? kInf : Hprev[0] + oe2);
      if (i2 <= oi2) bits0 |= 64;
      else i2 = oi2;
      I2[0] = i2;
      if (i2 < best0) { best0 = i2; choice0 = 4; }
    }
    H[0] = best0;
    D1[0] = kInf;
    if (TWO) D2[0] = kInf;
    tb[(size_t)(i * W)] = (uint8_t)(bits0 | choice0);
    const uint8_t qi = q[i - 1];
    uint8_t* tb_row = tb.data() + (size_t)(i * W);
    int32_t h_left = H[0];      // H(i, j-1)
    int32_t d1_left = kInf;     // D1(i, j-1)
    int32_t d2_left = kInf;
    int32_t hp_diag = Hprev[0];  // H(i-1, j-1)
    for (int64_t j = 1; j <= m; ++j) {
      const int32_t hp_j = Hprev[j];
      // D layers (consume target, move left) — ternaries lower to cmov
      const int32_t d1e = d1_left + e1, d1o = h_left + oe1;
      const bool d1x = d1e <= d1o;
      const int32_t d1 = d1x ? d1e : d1o;
      // I layers (consume query, move up)
      const int32_t i1e = I1[j] + e1, i1o = hp_j + oe1;
      const bool i1x = i1e <= i1o;
      const int32_t i1v = i1x ? i1e : i1o;
      I1[j] = i1v;
      const int32_t diag = hp_diag + (qi == t[j - 1] ? 0 : mm);
      // walk-order tie preference: diag, D1, I1, D2, I2
      int32_t best = diag;
      uint8_t choice = 0;
      choice = d1 < best ? 1 : choice;
      best = d1 < best ? d1 : best;
      choice = i1v < best ? 2 : choice;
      best = i1v < best ? i1v : best;
      uint8_t bits = (uint8_t)((d1x ? 8 : 0) | (i1x ? 16 : 0));
      if (TWO) {
        const int32_t d2e = d2_left + e2, d2o = h_left + oe2;
        const bool d2x = d2e <= d2o;
        const int32_t d2 = d2x ? d2e : d2o;
        const int32_t i2e = I2[j] + e2, i2o = hp_j + oe2;
        const bool i2x = i2e <= i2o;
        const int32_t i2v = i2x ? i2e : i2o;
        I2[j] = i2v;
        choice = d2 < best ? 3 : choice;
        best = d2 < best ? d2 : best;
        choice = i2v < best ? 4 : choice;
        best = i2v < best ? i2v : best;
        bits |= (uint8_t)((d2x ? 32 : 0) | (i2x ? 64 : 0));
        d2_left = d2;
        D2[j] = d2;
      }
      H[j] = best;
      D1[j] = d1;
      tb_row[j] = (uint8_t)(bits | choice);
      h_left = best;
      d1_left = d1;
      hp_diag = hp_j;
    }
  }
  *out_score = H[m];

  // walk: emit run-length ops reversed, then flip
  int64_t i = n, j = m, cnt = 0;
  int layer = 0;  // 0 = H, 1..4 = D1, I1, D2, I2
  auto push = [&](uint8_t op, int32_t len) {
    if (cnt && out_ops[cnt - 1] == op) out_lens[cnt - 1] += len;
    else { out_ops[cnt] = op; out_lens[cnt] = len; ++cnt; }
  };
  while (i > 0 || j > 0) {
    uint8_t b = tb[(size_t)(i * W + j)];
    if (layer == 0) {
      uint8_t c = b & 7;
      if (c == 0) {
        push(q[i - 1] == t[j - 1] ? 0 : 1, 1);  // '=' / 'X'
        --i; --j;
      } else {
        layer = c;
      }
    } else if (layer == 1 || layer == 3) {  // D1 / D2: consume target
      push(3, 1);
      bool ext = b & (layer == 1 ? 8 : 32);
      --j;
      if (!ext) layer = 0;
    } else {  // I1 / I2: consume query
      push(2, 1);
      bool ext = b & (layer == 2 ? 16 : 64);
      --i;
      if (!ext) layer = 0;
    }
  }
  // reverse runs in place
  for (int64_t a = 0, z = cnt - 1; a < z; ++a, --z) {
    std::swap(out_ops[a], out_ops[z]);
    std::swap(out_lens[a], out_lens[z]);
  }
  *out_count = cnt;
}

}  // namespace

extern "C" {

// Batched exact window DP.  qbuf/tbuf: concatenated base codes;
// qoffs/toffs [n_win+1].  Outputs per window w:
//   scores[w]; ops/lens starting at item_offs[w] (caller capacity:
//   item_offs[n_win] with per-window capacity qlen+tlen+1, PRE-FILLED by
//   caller as exclusive prefix sums); counts[w] = emitted run count.
// ops: 0 '=', 1 'X', 2 'I' (consumes query), 3 'D' (consumes target).
// n_threads > 1 parallelizes over windows.  Returns 0.
int64_t window_dp(const uint8_t* qbuf, const int64_t* qoffs,
                  const uint8_t* tbuf, const int64_t* toffs, int64_t n_win,
                  int32_t mismatch, int32_t o1, int32_t e1, int32_t o2,
                  int32_t e2, int64_t n_threads, int32_t* scores,
                  const int64_t* item_offs, uint8_t* ops, int32_t* lens,
                  int64_t* counts) {
  WinPen pen{mismatch, o1, e1, o2, e2};
  const bool two = o2 >= 0;
  auto work = [&](int64_t lo, int64_t hi) {
    std::vector<uint8_t> tb;
    std::vector<int32_t> rows;
    for (int64_t w = lo; w < hi; ++w) {
      auto fn = two ? window_dp_one<true> : window_dp_one<false>;
      fn(qbuf + qoffs[w], qoffs[w + 1] - qoffs[w],
         tbuf + toffs[w], toffs[w + 1] - toffs[w], pen,
         scores + w, ops + item_offs[w], lens + item_offs[w],
         counts + w, tb, rows);
    }
  };
  if (n_threads <= 1 || n_win < 2) {
    work(0, n_win);
  } else {
    int64_t T = n_threads < n_win ? n_threads : n_win;
    std::vector<std::thread> threads;
    // interleave-free block partition by estimated cells so one giant
    // window doesn't serialize the tail
    std::vector<int64_t> cells(n_win + 1, 0);
    for (int64_t w = 0; w < n_win; ++w)
      cells[w + 1] = cells[w] + (qoffs[w + 1] - qoffs[w] + 1) *
                                    (toffs[w + 1] - toffs[w] + 1);
    int64_t total = cells[n_win], lo = 0;
    for (int64_t k = 0; k < T; ++k) {
      int64_t target = total * (k + 1) / T;
      int64_t hi = lo;
      while (hi < n_win && cells[hi + 1] <= target) ++hi;
      if (k == T - 1) hi = n_win;
      if (hi > lo) threads.emplace_back(work, lo, hi);
      lo = hi;
    }
    for (auto& th : threads) th.join();
  }
  return 0;
}

// Stitch chain runs + gap-fill CIGARs into per-record run-length CIGARs
// (the sweepga backend's record assembly, align/sweep.py stage 3; the
// plain Python version is SweepAligner._stitch_python).  Inputs:
//   runs_q/runs_t/runs_len: all surviving records' exact-match runs,
//     concatenated; rec_off [R+1] delimits records.
//   gap table: gap g covers the inter-run gap AFTER global run index
//     gap_ids[g] (sorted ascending); its run-length items are
//     gap_ops/gap_lens[gap_off[g] .. gap_off[g+1]).  Ops: 0 '=', 1 'X',
//     2 'I' (consumes query), 3 'D' (consumes target) — the window_dp
//     convention.  Gaps not in the table fall back to pure I then D from
//     the run deltas (align/sweep.py's "touching next run" branch).
// Adjacent equal-op items merge at every append (sources are internally
// run-length coalesced, so this equals the Python stitch's
// boundary-merge).  Scores use the two-piece gap cost over the MERGED
// items, matching align/sweep.py::_cigar_cost.
// Outputs: out_ops/out_lens flat with out_off [R+1]; out_scores [R].
// Caller capacity for out_ops/out_lens: rec_off[R] + gap_off[G] + 2*rec_off[R].
// Returns total emitted items.
int64_t stitch_records(const int64_t* runs_q, const int64_t* runs_t,
                       const int64_t* runs_len, const int64_t* rec_off,
                       int64_t R, const uint8_t* gap_ops,
                       const int32_t* gap_lens, const int64_t* gap_off,
                       const int64_t* gap_ids, int64_t G, int32_t mismatch,
                       int32_t o1, int32_t e1, int32_t o2, int32_t e2,
                       uint8_t* out_ops, int32_t* out_lens, int64_t* out_off,
                       int64_t* out_scores) {
  const bool two = o2 >= 0;
  int64_t pos = 0;
  int64_t gi = 0;
  out_off[0] = 0;
  for (int64_t r = 0; r < R; ++r) {
    const int64_t first = pos;
    auto emit = [&](int64_t n, uint8_t op) {
      if (n <= 0) return;
      if (pos > first && out_ops[pos - 1] == op) {
        out_lens[pos - 1] += (int32_t)n;
      } else {
        out_ops[pos] = op;
        out_lens[pos] = (int32_t)n;
        ++pos;
      }
    };
    for (int64_t i = rec_off[r]; i < rec_off[r + 1]; ++i) {
      emit(runs_len[i], 0);
      if (i + 1 < rec_off[r + 1]) {
        while (gi < G && gap_ids[gi] < i) ++gi;
        if (gi < G && gap_ids[gi] == i) {
          for (int64_t j = gap_off[gi]; j < gap_off[gi + 1]; ++j)
            emit(gap_lens[j], gap_ops[j]);
        } else {
          emit(runs_q[i + 1] - (runs_q[i] + runs_len[i]), 2);
          emit(runs_t[i + 1] - (runs_t[i] + runs_len[i]), 3);
        }
      }
    }
    int64_t score = 0;
    for (int64_t p = first; p < pos; ++p) {
      const int64_t n = out_lens[p];
      if (out_ops[p] == 1) {
        score += n * (int64_t)mismatch;
      } else if (out_ops[p] >= 2) {
        int64_t g1 = (int64_t)o1 + n * (int64_t)e1;
        if (two) {
          const int64_t g2 = (int64_t)o2 + n * (int64_t)e2;
          if (g2 < g1) g1 = g2;
        }
        score += g1;
      }
    }
    out_scores[r] = score;
    out_off[r + 1] = pos;
  }
  return pos;
}

}  // extern "C"
