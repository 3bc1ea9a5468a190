// Native Levenshtein alignment scorer (the sclite/sctk hot loop): this
// package's own copy of espnet_slurp_tpu/native/edit_distance.cpp.
//
// Parity target: the reference scores WER via sctk's C sclite
// (asr.sh:1276-1396); here utils/metrics.py's pure-python DP is the
// default and this library is its fast path — identical tie-breaking
// (substitution/hit preferred over deletion over insertion, matching
// align_stats) so counts are exactly equal, ~100x faster on long
// references, with a std::thread pool over utterances.
//
// C ABI (ctypes):
//   edit_stats(ref, n, hyp, m, out4)        -> out4 = {hits, sub, del, ins}
//   edit_stats_batch(flat_refs, ref_off, flat_hyps, hyp_off, b, out, nthr)
//     offsets are prefix offsets of length b+1; out is b*4 ints.
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Cell {
  int32_t cost, h, s, d, i;
};

void align_one(const int32_t* ref, int n, const int32_t* hyp, int m,
               int32_t out[4]) {
  std::vector<Cell> prev(m + 1), cur(m + 1);
  for (int j = 0; j <= m; ++j) prev[j] = {j, 0, 0, 0, j};
  for (int i = 1; i <= n; ++i) {
    cur[0] = {i, 0, 0, i, 0};
    for (int j = 1; j <= m; ++j) {
      // substitution / hit (preferred on ties, as in metrics.align_stats)
      Cell best = prev[j - 1];
      if (ref[i - 1] == hyp[j - 1]) {
        best.h += 1;
      } else {
        best.cost += 1;
        best.s += 1;
      }
      // deletion
      if (prev[j].cost + 1 < best.cost) {
        best = prev[j];
        best.cost += 1;
        best.d += 1;
      }
      // insertion
      if (cur[j - 1].cost + 1 < best.cost) {
        best = cur[j - 1];
        best.cost += 1;
        best.i += 1;
      }
      cur[j] = best;
    }
    std::swap(prev, cur);
  }
  out[0] = prev[m].h;
  out[1] = prev[m].s;
  out[2] = prev[m].d;
  out[3] = prev[m].i;
}

}  // namespace

extern "C" {

void edit_stats(const int32_t* ref, int n, const int32_t* hyp, int m,
                int32_t* out4) {
  align_one(ref, n, hyp, m, out4);
}

void edit_stats_batch(const int32_t* refs, const int64_t* ref_off,
                      const int32_t* hyps, const int64_t* hyp_off, int b,
                      int32_t* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > b) n_threads = b;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int k = next.fetch_add(1);
      if (k >= b) return;
      align_one(refs + ref_off[k],
                static_cast<int>(ref_off[k + 1] - ref_off[k]),
                hyps + hyp_off[k],
                static_cast<int>(hyp_off[k + 1] - hyp_off[k]),
                out + 4 * k);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
