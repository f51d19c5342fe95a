// Host library of seqrush_tpu_torch, as a plain C ABI loaded with ctypes
// (seqrush_tpu_torch/native.py): the FASTA parser (fasta_stat, fasta_parse),
// the bulk union-find of the pipeline's unite (uf_unite_bulk, uf_compress),
// the wavefront route's backtrace (wfa_backtrace), the host walk of a packed
// banded traceback (nw_traceback), the colinear anchor chaining
// (chain_anchors, and chain_pairs over many pairs with their run merging),
// the exact window DP of the anchored wide route and the sweepga backend
// (window_dp), and the sweepga backend's record stitch (stitch_records).
//
// A copy of the JAX package's csrc/seqrush_native.cpp, function for
// function: the parser's quirks (lines read through a 65,536-byte fgets
// buffer, only '\r' '\n' stripped at a line's end and only space and tab
// around a sequence line, a name ending at the first space or tab after
// '>') are kept, so both packages read every FASTA file the same way; the
// union-find roots every component at its minimum element, as the device
// unite does; the backtraces keep the Python specifications' tie order
// (ops/wfa.py::backtrace_pair, ops/nw.py::traceback_pair); chain_pairs is
// bit-identical to ops/anchors.py chain_anchors_multi + chain_to_runs per
// pair, window_dp is a full-matrix two-piece Gotoh with the kernels'
// walk-order tie preference, and stitch_records is bit-identical to
// align/sweep.py::SweepAligner._stitch_python.  The arithmetic is
// unchanged, so both libraries give the same records, scores, CIGARs and
// parents; native.py compiles this file with -ffp-contract=off so that the
// chain score, a sum of doubles, is rounded the same way on every host.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// FASTA
// ---------------------------------------------------------------------------

// First pass: count records and sizes so the caller can allocate numpy
// buffers. Returns 0 on success, -1 on IO error.
int64_t fasta_stat(const char* path, int64_t* n_seqs, int64_t* total_len,
                   int64_t* names_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  *n_seqs = 0;
  *total_len = 0;
  *names_len = 0;
  std::string line;
  char buf[1 << 16];
  while (fgets(buf, sizeof buf, f)) {
    size_t n = strlen(buf);
    while (n && (buf[n - 1] == '\n' || buf[n - 1] == '\r')) --n;
    if (n == 0) continue;
    if (buf[0] == '>') {
      ++*n_seqs;
      size_t e = 1;
      while (e < n && buf[e] != ' ' && buf[e] != '\t') ++e;
      *names_len += (int64_t)(e - 1);
    } else if (*n_seqs > 0) {
      size_t s = 0, e = n;
      while (s < e && (buf[s] == ' ' || buf[s] == '\t')) ++s;
      while (e > s && (buf[e - 1] == ' ' || buf[e - 1] == '\t')) --e;
      *total_len += (int64_t)(e - s);
    }
  }
  fclose(f);
  return 0;
}

// Second pass: fill caller buffers.
//   names:      concatenated id bytes          [names_len]
//   name_offs:  per-seq id end offsets         [n_seqs]
//   data:       concatenated sequence bytes    [total_len]
//   seq_offs:   per-seq sequence end offsets   [n_seqs]
int64_t fasta_parse(const char* path, char* names, int64_t* name_offs,
                    uint8_t* data, int64_t* seq_offs) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t seq_i = -1, npos = 0, dpos = 0;
  char buf[1 << 16];
  while (fgets(buf, sizeof buf, f)) {
    size_t n = strlen(buf);
    while (n && (buf[n - 1] == '\n' || buf[n - 1] == '\r')) --n;
    if (n == 0) continue;
    if (buf[0] == '>') {
      if (seq_i >= 0) seq_offs[seq_i] = dpos;
      ++seq_i;
      size_t e = 1;
      while (e < n && buf[e] != ' ' && buf[e] != '\t') ++e;
      memcpy(names + npos, buf + 1, e - 1);
      npos += (int64_t)(e - 1);
      name_offs[seq_i] = npos;
    } else if (seq_i >= 0) {
      size_t s = 0, e = n;
      while (s < e && (buf[s] == ' ' || buf[s] == '\t')) ++s;
      while (e > s && (buf[e - 1] == ' ' || buf[e - 1] == '\t')) --e;
      memcpy(data + dpos, buf + s, e - s);
      dpos += (int64_t)(e - s);
    }
  }
  if (seq_i >= 0) seq_offs[seq_i] = dpos;
  fclose(f);
  return seq_i + 1;
}

// ---------------------------------------------------------------------------
// Union-find (host): deterministic min-element roots
// ---------------------------------------------------------------------------

static int32_t uf_find(int32_t* parent, int32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];  // path halving
    x = parent[x];
  }
  return x;
}

void uf_unite_bulk(int32_t* parent, int64_t n, const int32_t* u,
                   const int32_t* v, int64_t m) {
  for (int64_t i = 0; i < m; ++i) {
    if (u[i] < 0 || u[i] >= n || v[i] < 0 || v[i] >= n) continue;  // defensive
    int32_t ru = uf_find(parent, u[i]);
    int32_t rv = uf_find(parent, v[i]);
    if (ru == rv) continue;
    if (ru < rv)
      parent[rv] = ru;  // min root wins -> deterministic representatives
    else
      parent[ru] = rv;
  }
}

void uf_compress(int32_t* parent, int64_t n) {
  for (int64_t i = 0; i < n; ++i) parent[i] = uf_find(parent, (int32_t)i);
}

// ---------------------------------------------------------------------------
// WFA backtrace from device wavefront histories
// ---------------------------------------------------------------------------

static const int16_t NULL16 = -32768;

static inline int32_t hget(const int16_t* H, int64_t srows, int64_t ndiag,
                           int64_t s, int64_t d) {
  if (!H || s < 0 || d < 0 || d >= ndiag || s >= srows) return INT32_MIN;
  int16_t v = H[s * ndiag + d];
  return v <= NULL16 ? INT32_MIN : (int32_t)v;
}

// Recovers CIGAR ops ('=', 'X', 'I', 'D'), one byte per op step, written
// back-to-front semantics resolved internally: out_ops receives the ops in
// FORWARD order. Returns the number of ops, or -1 on inconsistency.
int64_t wfa_backtrace(const int16_t* HM, const int16_t* HI1, const int16_t* HD1,
                      const int16_t* HI2, const int16_t* HD2, int64_t srows,
                      int64_t ndiag, int32_t score, int32_t qlen, int32_t tlen,
                      int32_t band, int32_t x, int32_t o1, int32_t e1,
                      int32_t o2, int32_t e2, uint8_t* out_ops) {
  const bool two = (HI2 != nullptr) && (o2 >= 0);
  std::vector<uint8_t> rev;
  rev.reserve((size_t)(qlen + tlen));
  int64_t s = score;
  int64_t d = (int64_t)(tlen - qlen) + band;
  int32_t off = tlen;
  // matrix: 0=M 1=D1 2=I1 3=D2 4=I2
  int mat = 0;

  while (true) {
    if (mat == 0) {
      if (s == 0) {
        for (int32_t i = 0; i < off; ++i) rev.push_back('=');
        break;
      }
      int32_t cm = hget(HM, srows, ndiag, s - x, d);
      int32_t cand[5];
      cand[0] = cm == INT32_MIN ? INT32_MIN : cm + 1;           // X
      cand[1] = hget(HD1, srows, ndiag, s, d);                  // D1
      cand[2] = hget(HI1, srows, ndiag, s, d);                  // I1
      cand[3] = two ? hget(HD2, srows, ndiag, s, d) : INT32_MIN; // D2
      cand[4] = two ? hget(HI2, srows, ndiag, s, d) : INT32_MIN; // I2
      int32_t best = INT32_MIN;
      for (int k = 0; k < 5; ++k)
        if (cand[k] > best) best = cand[k];
      if (best == INT32_MIN || off < best) return -1;
      for (int32_t i = 0; i < off - best; ++i) rev.push_back('=');
      off = best;
      int choice = 0;
      for (int k = 0; k < 5; ++k)
        if (cand[k] == best) {
          choice = k;
          break;
        }
      if (choice == 0) {
        rev.push_back('X');
        s -= x;
        off -= 1;
      } else {
        mat = choice;
      }
    } else if (mat == 1 || mat == 3) {  // D1 / D2
      int32_t o = (mat == 1) ? o1 : o2, e = (mat == 1) ? e1 : e2;
      const int16_t* HD = (mat == 1) ? HD1 : HD2;
      rev.push_back('D');
      int32_t prev = off - 1;
      int32_t mp = hget(HM, srows, ndiag, s - o - e, d - 1);
      if (mp != INT32_MIN && mp == prev) {
        s -= o + e;
        d -= 1;
        off = prev;
        mat = 0;
      } else {
        int32_t dp = hget(HD, srows, ndiag, s - e, d - 1);
        if (dp == INT32_MIN || dp != prev) return -1;
        s -= e;
        d -= 1;
        off = prev;
      }
    } else {  // I1 / I2
      int32_t o = (mat == 2) ? o1 : o2, e = (mat == 2) ? e1 : e2;
      const int16_t* HI = (mat == 2) ? HI1 : HI2;
      rev.push_back('I');
      int32_t mp = hget(HM, srows, ndiag, s - o - e, d + 1);
      if (mp != INT32_MIN && mp == off) {
        s -= o + e;
        d += 1;
        mat = 0;
      } else {
        int32_t ip = hget(HI, srows, ndiag, s - e, d + 1);
        if (ip == INT32_MIN || ip != off) return -1;
        s -= e;
        d += 1;
      }
    }
  }
  int64_t n = (int64_t)rev.size();
  for (int64_t i = 0; i < n; ++i) out_ops[i] = rev[(size_t)(n - 1 - i)];
  return n;
}

// ---------------------------------------------------------------------------
// Banded anti-diagonal Gotoh traceback (ops/nw.py packed bytes)
// ---------------------------------------------------------------------------

// tb: uint8 [tmax+1, W] packed rows; emits ops ('M','I','D') forward order.
// Returns op count or -1 on inconsistency.  'M' cells are split into '='/'X'
// on the python side against the sequences.
int64_t nw_traceback(const uint8_t* tb, int64_t tmax_rows, int64_t W,
                     int32_t qlen, int32_t tlen, int32_t band,
                     uint8_t* out_ops) {
  std::vector<uint8_t> rev;
  rev.reserve((size_t)(qlen + tlen));
  int64_t i = qlen, j = tlen;
  int state = 0;  // 0=H 1=D1 2=I1 3=D2 4=I2
  while (i > 0 || j > 0) {
    int64_t t = i + j;
    int64_t i0 = (t - band + 1) / 2;
    if (i0 < 0) i0 = 0;
    int64_t l = i - i0;
    if (t < 0 || t >= tmax_rows || l < 0 || l >= W) return -1;
    uint8_t b = tb[t * W + l];
    if (state == 0) {
      int choice = b & 7;
      if (choice == 0) {
        rev.push_back('M');
        --i;
        --j;
      } else if (choice == 1) {
        state = 1;
      } else if (choice == 2) {
        state = 2;
      } else if (choice == 3) {
        state = 3;
      } else if (choice == 4) {
        state = 4;
      } else {
        return -1;
      }
    } else if (state == 2 || state == 4) {  // I1 / I2
      bool opened = b & (state == 2 ? 8 : 16);
      rev.push_back('I');
      --i;
      if (opened) state = 0;
    } else {  // D1 / D2
      bool opened = b & (state == 1 ? 32 : 64);
      rev.push_back('D');
      --j;
      if (opened) state = 0;
    }
  }
  int64_t n = (int64_t)rev.size();
  for (int64_t k = 0; k < n; ++k) out_ops[k] = rev[(size_t)(n - 1 - k)];
  return n;
}

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

}  // extern "C"

namespace {

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
