// Batched sequence/positive/negative sampler — the host data-loader hot path.
//
// The reference samples per example in Python inside torch __getitem__
// (xfmr_rec/data.py:669-747), which SURVEY.md §3.2 identifies as a training
// hot spot; at TPU batch rates the Python sampler can starve the device.
// This native implementation samples a whole batch per call:
//
//   * positions: uniform sample without replacement from the first n-1
//     history positions, sorted (parity: data.py:669-688);
//   * positives: uniform over future positive-labeled events within the
//     lookahead window (0 = unbounded) via binary search over the row's
//     positive-position index (parity: data.py:690-721);
//   * negatives: uniform without replacement from items NOT in the user's
//     history, by rejection sampling against a sorted unique history; falls
//     back to with-replacement draws when the complement is smaller than
//     the sequence (parity: data.py:723-747).
//
// RNG: splitmix64 streams keyed on (seed, epoch, row) — stateless and
// reproducible like the numpy path (identical distributions; different
// stream, documented in data/dataset.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // unbiased uniform in [0, bound)
  uint64_t bounded(uint64_t bound) {
    if (bound <= 1) return 0;
    uint64_t threshold = (~bound + 1) % bound;  // 2^64 mod bound
    for (;;) {
      uint64_t r = next();
      if (r >= threshold) return r % bound;
    }
  }
};

// sorted sample without replacement of k from [0, n) (Floyd's algorithm)
void sample_positions(SplitMix64& rng, int64_t n, int64_t k,
                      std::vector<int32_t>& out) {
  out.clear();
  if (k >= n) {
    out.resize(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) out[static_cast<size_t>(i)] = static_cast<int32_t>(i);
    return;
  }
  for (int64_t j = n - k; j < n; ++j) {
    int32_t t = static_cast<int32_t>(rng.bounded(static_cast<uint64_t>(j + 1)));
    if (std::find(out.begin(), out.end(), t) != out.end()) {
      out.push_back(static_cast<int32_t>(j));
    } else {
      out.push_back(t);
    }
  }
  std::sort(out.begin(), out.end());
}

// Sample rows [b_lo, b_hi) of one batch — the per-row work is fully
// independent: the RNG stream is keyed on (seed, epoch, row, b) with no
// carried state, and each row writes a disjoint output slice, so threads
// produce BIT-IDENTICAL batches to the serial loop.
void sample_rows(const int32_t* values, const uint8_t* labels,
                 const int64_t* offsets, int64_t num_rows,
                 const int64_t* row_indices, int64_t b_lo, int64_t b_hi,
                 int64_t max_seq, int64_t pos_lookahead, int64_t num_items,
                 uint64_t seed, uint64_t epoch, int32_t* hist, int32_t* pos,
                 int32_t* neg) {
  std::vector<int32_t> positions;
  std::vector<int32_t> pos_positions;
  std::vector<int32_t> sorted_hist;
  std::vector<int32_t> chosen;

  for (int64_t b = b_lo; b < b_hi; ++b) {
    int64_t row = row_indices[b];
    if (row < 0 || row >= num_rows) continue;
    const int32_t* h = values + offsets[row];
    const uint8_t* lab = labels + offsets[row];
    int64_t n = offsets[row + 1] - offsets[row];
    if (n <= 0) continue;

    // stateless stream per (seed, epoch, row, b)
    SplitMix64 rng(seed * 0x9e3779b97f4a7c15ULL + epoch * 0xc2b2ae3d27d4eb4fULL +
                   static_cast<uint64_t>(row) * 0x165667b19e3779f9ULL +
                   static_cast<uint64_t>(b));

    sample_positions(rng, n - 1, max_seq, positions);
    int64_t seq_len = static_cast<int64_t>(positions.size());
    if (seq_len == 0) continue;

    pos_positions.clear();
    for (int64_t i = 0; i < n; ++i)
      if (lab[i]) pos_positions.push_back(static_cast<int32_t>(i));

    int32_t* hist_row = hist + b * max_seq;
    int32_t* pos_row = pos + b * max_seq;
    int32_t* neg_row = neg + b * max_seq;

    for (int64_t i = 0; i < seq_len; ++i) {
      int32_t p_idx = positions[static_cast<size_t>(i)];
      hist_row[i] = h[p_idx];
      int32_t start = p_idx + 1;
      int32_t end = pos_lookahead > 0
                        ? static_cast<int32_t>(
                              std::min<int64_t>(start + pos_lookahead, n))
                        : static_cast<int32_t>(n);
      auto lo = std::lower_bound(pos_positions.begin(), pos_positions.end(), start);
      auto hi = std::lower_bound(pos_positions.begin(), pos_positions.end(), end);
      int64_t count = hi - lo;
      if (count > 0) {
        pos_row[i] = h[*(lo + static_cast<int64_t>(
                                  rng.bounded(static_cast<uint64_t>(count))))];
      }
    }

    // negatives: uniform w/o replacement from the complement of the history
    sorted_hist.assign(h, h + n);
    std::sort(sorted_hist.begin(), sorted_hist.end());
    sorted_hist.erase(std::unique(sorted_hist.begin(), sorted_hist.end()),
                      sorted_hist.end());
    int64_t complement = num_items - static_cast<int64_t>(sorted_hist.size());
    auto in_hist = [&](int32_t v) {
      return std::binary_search(sorted_hist.begin(), sorted_hist.end(), v);
    };
    if (complement <= 0) {
      // history covers the catalog: fall back to ALL items, without
      // replacement when possible (reference data.py:741-747 falls back to
      // all_idx and only uses replace=True when candidates < seq_len).
      if (num_items >= seq_len) {
        chosen.clear();
        for (int64_t j = num_items - seq_len; j < num_items; ++j) {  // Floyd
          int32_t t = static_cast<int32_t>(rng.bounded(static_cast<uint64_t>(j + 1)));
          if (std::find(chosen.begin(), chosen.end(), t) != chosen.end()) {
            chosen.push_back(static_cast<int32_t>(j));
          } else {
            chosen.push_back(t);
          }
        }
        for (int64_t i = 0; i < seq_len; ++i) neg_row[i] = chosen[static_cast<size_t>(i)] + 1;
      } else {
        for (int64_t i = 0; i < seq_len; ++i)
          neg_row[i] =
              static_cast<int32_t>(rng.bounded(static_cast<uint64_t>(num_items))) + 1;
      }
    } else if (complement < seq_len) {
      // with replacement from the complement (reference data.py:745-747)
      for (int64_t i = 0; i < seq_len; ++i) {
        for (;;) {
          int32_t cand = static_cast<int32_t>(
                             rng.bounded(static_cast<uint64_t>(num_items))) + 1;
          if (!in_hist(cand)) { neg_row[i] = cand; break; }
        }
      }
    } else {
      chosen.clear();
      while (static_cast<int64_t>(chosen.size()) < seq_len) {
        int32_t cand = static_cast<int32_t>(
                           rng.bounded(static_cast<uint64_t>(num_items))) + 1;
        if (in_hist(cand)) continue;
        if (std::find(chosen.begin(), chosen.end(), cand) != chosen.end()) continue;
        chosen.push_back(cand);
      }
      for (int64_t i = 0; i < seq_len; ++i) neg_row[i] = chosen[static_cast<size_t>(i)];
    }
  }
}

}  // namespace

extern "C" {

// Sample one batch (multi-threaded over rows; see sample_rows).
//   values/labels: concatenated per-row histories; offsets: (num_rows+1)
//   row_indices: (batch_size) rows to sample
//   num_threads: 0 -> hardware_concurrency clamped to [1, 16]
//   hist/pos/neg: out, (batch_size * max_seq) int32, zero-padded
void sample_batch(const int32_t* values, const uint8_t* labels,
                  const int64_t* offsets, int64_t num_rows,
                  const int64_t* row_indices, int64_t batch_size,
                  int64_t max_seq, int64_t pos_lookahead, int64_t num_items,
                  uint64_t seed, uint64_t epoch, int64_t num_threads,
                  int32_t* hist, int32_t* pos, int32_t* neg) {
  std::memset(hist, 0, sizeof(int32_t) * static_cast<size_t>(batch_size * max_seq));
  std::memset(pos, 0, sizeof(int32_t) * static_cast<size_t>(batch_size * max_seq));
  std::memset(neg, 0, sizeof(int32_t) * static_cast<size_t>(batch_size * max_seq));

  int64_t nt = num_threads;
  if (nt <= 0) {
    nt = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (nt < 1) nt = 1;
    if (nt > 16) nt = 16;
  }
  // ~16 rows per thread minimum: below that, spawn cost beats the work
  if (nt > (batch_size + 15) / 16) nt = (batch_size + 15) / 16;
  if (nt <= 1) {
    sample_rows(values, labels, offsets, num_rows, row_indices, 0, batch_size,
                max_seq, pos_lookahead, num_items, seed, epoch, hist, pos, neg);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(nt));
  int64_t chunk = (batch_size + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(lo + chunk, batch_size);
    if (lo >= hi) break;
    threads.emplace_back(sample_rows, values, labels, offsets, num_rows,
                         row_indices, lo, hi, max_seq, pos_lookahead,
                         num_items, seed, epoch, hist, pos, neg);
  }
  for (auto& th : threads) th.join();
}

// Deterministic Fisher-Yates permutation of [0, n) keyed on (seed, epoch).
void shuffled_order(int64_t n, uint64_t seed, uint64_t epoch, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  SplitMix64 rng(seed * 0x2545f4914f6cdd1dULL + epoch + 0x9e3779b97f4a7c15ULL);
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(rng.bounded(static_cast<uint64_t>(i + 1)));
    std::swap(out[i], out[j]);
  }
}

}  // extern "C"
