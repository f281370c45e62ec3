// Native entry-table emission for the port's host planner: a host library,
// not a kernel. Built with g++ (-O3 -shared -fPIC -std=c++17) on first use
// by csrc/host.py into csrc/build/, loaded with ctypes.
//
// The hot loop is ops/block_meta._emit_entries: for every (slice, q_run,
// q_block, k_run, k_block) intersection emit one kernel entry. Beside it,
// the exact area of the slices restricted to the runs (the planner's area
// accounting), and the dynamic solver's area-left-of-a-cut and its binary
// search for the cut (meta/solver/dynamic_attn_solver._cut_for_fraction).
// Plain C entry points with the magi_torch_ prefix; the Python loops stay
// as the parity oracle (the outputs are byte-identical) and as the path
// under MAGI_ATTENTION_CPP_BACKEND=0.
//
// Entry layout (9 int64s, matching the Python tuple):
//   (q_block, k_block, slice_id, ql0, ql1, kl0, kl1, qoff, koff)

#include <cmath>
#include <cstdint>

namespace {

// sum of integers lo..hi inclusive (0 if hi < lo)
inline int64_t tri_sum(int64_t lo, int64_t hi) {
  if (hi < lo) return 0;
  return (hi + lo) * (hi - lo + 1) / 2;
}

// sum_{i=0}^{n-1} clamp(b + i, 0, cap)
inline int64_t sum_clamp_linear(int64_t n, int64_t b, int64_t cap) {
  if (cap <= 0 || n <= 0) return 0;
  int64_t n0 = -b; if (n0 < 0) n0 = 0; if (n0 > n) n0 = n;
  int64_t n1 = cap - b; if (n1 < 0) n1 = 0; if (n1 > n) n1 = n;
  return tri_sum(b + n0, b + n1 - 1) + (n - n1) * cap;
}

// exact unmasked area of one slice (port of common/mask.slice_area)
inline int64_t slice_area_one(int64_t qs, int64_t qe, int64_t ks, int64_t ke,
                              int64_t mt) {
  const int64_t sq = qe - qs, sk = ke - ks;
  if (sq <= 0 || sk <= 0) return 0;
  const bool causal = (mt & 1) != 0, inv = (mt & 2) != 0;
  if (!causal && !inv) return sq * sk;
  if (causal && !inv) {
    if (sk >= sq) return tri_sum(sk - sq + 1, sk);
    return tri_sum(1, sk);
  }
  if (inv && !causal) {
    const int64_t n_pos = sq < sk ? sq : sk;
    return tri_sum(sk - n_pos + 1, sk);
  }
  const int64_t width = sk - sq + 1;
  return width > 0 ? sq * width : 0;
}

// area of rows q < pos (port of rectangle._truncate_q + area)
inline int64_t area_left_q_one(int64_t qs, int64_t qe, int64_t ks, int64_t ke,
                               int64_t mt, int64_t pos) {
  if (pos <= qs) return 0;
  const int64_t b = pos < qe ? pos : qe;
  int64_t ke2 = ke;
  if (mt & 1) ke2 = ke - (qe - b);  // causal bound rides the bottom row
  if (ke2 <= ks) return 0;
  return slice_area_one(qs, b, ks, ke2, mt);
}

// area of pairs with k < pos (port of common/mask.slice_area_left_of_k)
inline int64_t area_left_k_one(int64_t qs, int64_t qe, int64_t ks, int64_t ke,
                               int64_t mt, int64_t pos) {
  const int64_t sq = qe - qs, sk = ke - ks;
  if (sq <= 0 || sk <= 0 || pos <= ks) return 0;
  const bool causal = (mt & 1) != 0, inv = (mt & 2) != 0;
  const int64_t pcap = (pos < ke ? pos : ke) - ks;
  if (!causal && !inv) return sq * pcap;
  if (causal && !inv) return sum_clamp_linear(sq, sk - sq + 1, pos - ks);
  if (inv && !causal) {
    const int64_t n_pos = pcap < sq ? pcap : sq;
    return tri_sum(pcap - n_pos + 1, pcap);
  }
  const int64_t w = sk - sq + 1;
  if (w <= 0) return 0;
  const int64_t h0 = ke - sq + 1;
  int64_t n_const = pos - h0 + 1;
  if (n_const < 0) n_const = 0; if (n_const > sq) n_const = sq;
  int64_t total = n_const * w;
  const int64_t p2 = pos - ks;
  const int64_t hi_idx = p2 < sq ? p2 : sq;
  if (hi_idx > n_const) total += tri_sum(p2 - hi_idx + 1, p2 - n_const);
  return total;
}

inline int64_t area_left(const int64_t* rects, int64_t n, int64_t axis_q,
                         int64_t pos) {
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* r = rects + i * 5;
    total += axis_q ? area_left_q_one(r[0], r[1], r[2], r[3], r[4], pos)
                    : area_left_k_one(r[0], r[1], r[2], r[3], r[4], pos);
  }
  return total;
}

}  // namespace

extern "C" {

// rects: [n, 5] = (qs, qe, ks, ke, mask_type). Area of the sub-region
// left of the q=pos (axis_q != 0) or k=pos line.
int64_t magi_torch_area_left(const int64_t* rects, int64_t n, int64_t axis_q,
                             int64_t pos) {
  return area_left(rects, n, axis_q, pos);
}

// Binary-search the cut line so the left side holds ~frac of the total
// area — the dynamic solver's probe loop (DynamicAttnSolver._cut_for_fraction),
// bit-identical to the Python implementation (same float target/err math,
// same tie-breaking). Returns the best cut position.
int64_t magi_torch_cut_pos(const int64_t* rects, int64_t n, int64_t axis_q,
                           double frac) {
  int64_t total = 0, lo = INT64_MAX, hi = INT64_MIN;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* r = rects + i * 5;
    total += slice_area_one(r[0], r[1], r[2], r[3], r[4]);
    const int64_t s = axis_q ? r[0] : r[2];
    const int64_t e = axis_q ? r[1] : r[3];
    if (s < lo) lo = s;
    if (e > hi) hi = e;
  }
  if (n == 0 || total == 0) return 0;
  const double target = frac * (double)total;
  int64_t best_pos = lo;
  double best_err = std::fabs((double)area_left(rects, n, axis_q, lo) - target);
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;  // floor for non-negative positions
    const double a = (double)area_left(rects, n, axis_q, mid);
    const double err = std::fabs(a - target);
    if (err < best_err) { best_pos = mid; best_err = err; }
    if (a < target) lo = mid + 1; else hi = mid;
  }
  if (std::fabs((double)area_left(rects, n, axis_q, lo) - target) < best_err)
    best_pos = lo;
  return best_pos;
}

// slices: [n_slices, 5] = (qs, qe, ks, ke, mask_type)
// q_runs / k_runs: [n, 3] = (local_start, global_start, length)
// out: [capacity, 9]; returns number of entries (may exceed capacity, in
// which case only the first `capacity` were written — caller re-allocs).
int64_t magi_torch_emit_entries(
    const int64_t* slices, int64_t n_slices,
    const int64_t* q_runs, int64_t n_q_runs,
    const int64_t* k_runs, int64_t n_k_runs,
    int64_t block_q, int64_t block_k,
    int64_t* out, int64_t capacity) {
  int64_t count = 0;
  for (int64_t sid = 0; sid < n_slices; ++sid) {
    const int64_t qs = slices[sid * 5 + 0];
    const int64_t qe = slices[sid * 5 + 1];
    const int64_t ks = slices[sid * 5 + 2];
    const int64_t ke = slices[sid * 5 + 3];
    const int64_t mt = slices[sid * 5 + 4];
    if (qs >= qe || ks >= ke) continue;
    const bool causal = (mt & 1) != 0;
    const bool inv = (mt & 2) != 0;
    for (int64_t qi = 0; qi < n_q_runs; ++qi) {
      const int64_t q_ls = q_runs[qi * 3 + 0];
      const int64_t q_gs = q_runs[qi * 3 + 1];
      const int64_t q_len = q_runs[qi * 3 + 2];
      const int64_t q_off = q_gs - q_ls;
      const int64_t gq_lo = qs > q_gs ? qs : q_gs;
      const int64_t gq_hi = qe < q_gs + q_len ? qe : q_gs + q_len;
      if (gq_lo >= gq_hi) continue;
      const int64_t ql_lo = gq_lo - q_off;
      const int64_t ql_hi = gq_hi - q_off;
      for (int64_t i = ql_lo / block_q; i * block_q < ql_hi; ++i) {
        const int64_t bq_lo = ql_lo > i * block_q ? ql_lo : i * block_q;
        int64_t bq_hi = (i + 1) * block_q;
        if (ql_hi < bq_hi) bq_hi = ql_hi;
        // k span needed by global rows [bq_lo+q_off, bq_hi+q_off)
        int64_t k_lo = ks, k_hi = ke;
        if (causal) {
          const int64_t h = ke - qe + (bq_hi + q_off);
          if (h < k_hi) k_hi = h;
        }
        if (inv) {
          const int64_t l = ks + ((bq_lo + q_off) - qs);
          if (l > k_lo) k_lo = l;
        }
        if (k_hi <= k_lo) continue;
        for (int64_t ki = 0; ki < n_k_runs; ++ki) {
          const int64_t k_ls = k_runs[ki * 3 + 0];
          const int64_t k_gs = k_runs[ki * 3 + 1];
          const int64_t k_len = k_runs[ki * 3 + 2];
          const int64_t k_off = k_gs - k_ls;
          const int64_t gk_lo = k_lo > k_gs ? k_lo : k_gs;
          const int64_t gk_hi = k_hi < k_gs + k_len ? k_hi : k_gs + k_len;
          if (gk_lo >= gk_hi) continue;
          const int64_t kl_lo = gk_lo - k_off;
          const int64_t kl_hi = gk_hi - k_off;
          for (int64_t j = kl_lo / block_k; j * block_k < kl_hi; ++j) {
            if (count < capacity) {
              int64_t* row = out + count * 9;
              row[0] = i;
              row[1] = j;
              row[2] = sid;
              row[3] = bq_lo;
              row[4] = bq_hi;
              row[5] = kl_lo > j * block_k ? kl_lo : j * block_k;
              row[6] = kl_hi < (j + 1) * block_k ? kl_hi : (j + 1) * block_k;
              row[7] = q_off;
              row[8] = k_off;
            }
            ++count;
          }
        }
      }
    }
  }
  return count;
}

// Exact unmasked-pair count of one slice restricted to (q_runs x k_runs):
// the area accounting loop of build_block_meta_general.
int64_t magi_torch_slice_area_runs(
    const int64_t* slices, int64_t n_slices,
    const int64_t* q_runs, int64_t n_q_runs,
    const int64_t* k_runs, int64_t n_k_runs) {
  int64_t area = 0;
  for (int64_t sid = 0; sid < n_slices; ++sid) {
    const int64_t qs = slices[sid * 5 + 0];
    const int64_t qe = slices[sid * 5 + 1];
    const int64_t ks = slices[sid * 5 + 2];
    const int64_t ke = slices[sid * 5 + 3];
    const int64_t mt = slices[sid * 5 + 4];
    if (qs >= qe || ks >= ke) continue;
    const bool causal = (mt & 1) != 0;
    const bool inv = (mt & 2) != 0;
    for (int64_t qi = 0; qi < n_q_runs; ++qi) {
      const int64_t q_gs = q_runs[qi * 3 + 1];
      const int64_t q_len = q_runs[qi * 3 + 2];
      const int64_t a = qs > q_gs ? qs : q_gs;
      const int64_t b = qe < q_gs + q_len ? qe : q_gs + q_len;
      if (a >= b) continue;
      for (int64_t ki = 0; ki < n_k_runs; ++ki) {
        const int64_t k_gs = k_runs[ki * 3 + 1];
        const int64_t k_len = k_runs[ki * 3 + 2];
        const int64_t c = ks > k_gs ? ks : k_gs;
        const int64_t d = (ke < k_gs + k_len ? ke : k_gs + k_len);
        if (c >= d) continue;
        // rows q in [a, b): cols [max(lo(q), c), min(hi(q), d)) with
        // lo(q) = inv ? ks + q - qs : ks, hi(q) = causal ? ke - qe + q + 1 : ke.
        // A plain per-row loop is plenty fast in native code and immune to
        // the clip-breakpoint case analysis a closed form would need.
        for (int64_t q = a; q < b; ++q) {
          const int64_t lo_q = inv ? ks + (q - qs) : ks;
          const int64_t hi_q = causal ? ke - qe + q + 1 : ke;
          const int64_t lo = lo_q > c ? lo_q : c;
          const int64_t hi = hi_q < d ? hi_q : d;
          if (hi > lo) area += hi - lo;
        }
      }
    }
  }
  return area;
}

}  // extern "C"
