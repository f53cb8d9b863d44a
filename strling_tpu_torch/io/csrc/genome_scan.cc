// Exact genome-index window scan (host second-stage filter).
//
// The genome STR index stage (core/genome_index.py; reference
// src/strpkg/genome_strs.nim:61-92) scans 100bp windows at stride 60 through
// the repeat detector. The dimer-count bound (sio_genome_prefilter) proves
// ~93% of random-genome windows repeat-free, but the surviving ~7% false
// positives would still travel to the device. This file adds an EXACT
// per-window evaluation of the reference detector (utils.nim:236-271, ported
// byte-for-byte from the executable spec in strling_tpu/ops/oracle.py) so
// only truly repeat-bearing windows (~0.1-1% of a genome) reach the device
// kernel, which remains the scanner of record for unit codes and counts.
//
// Semantics mirrored exactly (cross-validated against ops/oracle.py in
// tests/test_genome_index.py):
// - slide_by (utils.nim:10-35): windows of width k at stride k, each
//   contributing the min over its k cyclic rotations of the 2-bit code
//   ((byte >> 1) & 3 — N aliases G, as in the reference encode).
// - modal code with the running-argmax tie-break (utils.nim:192-211): a code
//   wins only when its count becomes strictly greater than the current max.
// - get_repeat (utils.nim:236-271): N>20 skip, k=2..6 scan, kmer-estimated
//   score with early exit, exact non-overlapping ASCII substring recount
//   (N breaks matches there), proportion threshold.

#include "sio_util.h"

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// decode 2-bit digit -> ASCII, inverse of (c >> 1) & 3 over ACGT
// (ops/encode.py decode_kmer): 0->A 1->C 2->T 3->G
constexpr char kDigit[4] = {'A', 'C', 'T', 'G'};

struct ScanScratch {
  // per-thread modal-count histogram with epoch versioning so it never
  // needs clearing (code space is 4^k <= 4096 for k <= 6). Epochs are
  // 64-bit: the extract engine keeps one scratch for a whole run, and a
  // 32-bit counter would wrap after ~860M evaluations and resurrect
  // stale counts (silently dropping real STR rows).
  uint32_t counts[4096];
  uint64_t epoch[4096];
  uint64_t cur = 0;
  ScanScratch() {
    memset(counts, 0, sizeof(counts));
    memset(epoch, 0xFF, sizeof(epoch));
  }
};

// Exact port of oracle.get_repeat's per-k modal window code
// (slide_by + running-argmax). Returns count; *imax_out = modal code or -1.
static int modal_window_code(const uint8_t* s, int n, int k, ScanScratch& sc,
                             int* imax_out) {
  sc.cur++;
  int imax = -1;
  uint32_t imax_count = 0;
  if (k <= n) {
    const uint32_t mask = (1u << (2 * k)) - 1;
    // first window [0, k)
    uint32_t f = 0;
    for (int j = 0; j < k; j++) f = ((f << 2) | ((s[j] >> 1) & 3)) & mask;
    int i = 0;
    while (true) {
      uint32_t kmin = f;
      for (int j = 0; j < k; j++) {
        f = ((f << 2) | ((s[i + j] >> 1) & 3)) & mask;
        kmin = std::min(kmin, f);
      }
      // histogram + running argmax (utils.nim:192-211 tie-break: strictly
      // greater replaces; equal keeps the earlier winner)
      if (sc.epoch[kmin] != sc.cur) {
        sc.epoch[kmin] = sc.cur;
        sc.counts[kmin] = 0;
      }
      uint32_t c = ++sc.counts[kmin];
      if (imax == -1 || c > imax_count) {
        imax = (int)kmin;
        imax_count = c;
      }
      i += k;
      if (i + k > n) break;
      // build first code of the next window
      for (int m = 0; m < k; m++)
        f = ((f << 2) | ((s[i + m] >> 1) & 3)) & mask;
    }
  }
  *imax_out = imax;
  return imax == -1 ? 0 : (int)imax_count;
}

using sio_util::count_nonoverlapping;

// Exact port of oracle.get_repeat (utils.nim:236-271) returning only the
// final repeat_count (0 == window is not STR-like). The homopolymer
// reduction multiplier (utils.nim:271) never changes zero-ness, so it is
// omitted here; the device kernel computes the full result for survivors.
static int get_repeat_count(const uint8_t* s, int len, double prop,
                            ScanScratch& sc) {
  int n_count = 0;
  for (int i = 0; i < len; i++) n_count += (s[i] == 'N');
  if (n_count > 20) return 0;  // utils.nim:238

  int best_score = -1;
  int repeat_count = 0;
  bool have_result = false;
  char unit[8];
  for (int k = 2; k <= 6; k++) {
    int imax;
    int count = modal_window_code(s, len, k, sc, &imax);
    // decode of imax: -1 decodes as all-ones bits -> "G"*k (utils.nim:197)
    uint32_t code = imax >= 0 ? (uint32_t)imax : (1u << (2 * k)) - 1;
    for (int j = 0; j < k; j++)
      unit[j] = kDigit[(code >> (2 * (k - 1 - j))) & 3];
    int score = count * k;
    if (score <= best_score) {
      if (count < (int)((double)len * 0.12 / (double)k))  // utils.nim:251
        break;
      continue;
    }
    count = count_nonoverlapping(s, len, unit, k);  // utils.nim:254
    score = count * k;
    if (score < best_score) continue;  // utils.nim:256
    best_score = score;
    if (count > (int)((double)len * prop / (double)k)) {  // utils.nim:259
      have_result = true;
      repeat_count = count;
    }
  }
  return have_result ? repeat_count : 0;
}

// cheap first-stage dimer bound, same as Engine::max_dimer_count /
// sio_genome_prefilter (extract_engine.cc): sound overcount via the 2-bit
// alias, threshold tp[6] = trunc(len * prop / 6)
static bool dimer_provably_zero(const uint8_t* s, int len, double prop) {
  int counts[16] = {0};
  for (int i = 0; i + 1 < len; i++)
    counts[(((s[i] >> 1) & 3) << 2) | ((s[i + 1] >> 1) & 3)]++;
  int mx = 0;
  for (int i = 0; i < 16; i++) mx = std::max(mx, counts[i]);
  return mx <= (int)(int64_t)((double)len * prop / 6.0);
}

}  // namespace

extern "C" {

// Reusable exact-scan scratch for callers that evaluate many sequences on
// one thread (the extract engine's producer uses this as its second-stage
// row filter; core/genome_index uses sio_genome_scan below).
void* sio_scan_scratch_new() { return new ScanScratch(); }
void sio_scan_scratch_free(void* s) { delete (ScanScratch*)s; }

// Exact reference-detector count for one sequence (0 == not STR-like);
// byte-faithful to ops/oracle.py get_repeat (fuzz-tested) and therefore to
// the device kernel.
int sio_get_repeat_count(void* scratch, const uint8_t* s, int64_t len,
                         double prop) {
  return get_repeat_count(s, (int)len, prop, *(ScanScratch*)scratch);
}

// For each window of `window` bases at stride `step` over the ASCII
// chromosome, set zero_mask=1 when the reference detector provably (and now
// exactly) returns repeat_count==0: dimer bound first, exact get_repeat on
// the survivors. Multithreaded over window ranges (n_threads<=0 picks the
// hardware count). Returns the number of windows written.
int64_t sio_genome_scan(const uint8_t* seq, int64_t L, int64_t window,
                        int64_t step, double prop, uint8_t* zero_mask,
                        int n_threads) {
  int64_t n_windows = L > 0 ? (L + step - 1) / step : 0;
  if (n_windows == 0) return 0;
  int T = n_threads > 0 ? n_threads
                        : (int)std::thread::hardware_concurrency();
  T = std::max(1, std::min<int>(T, 64));
  if ((int64_t)T > n_windows) T = (int)n_windows;

  auto work = [&](int64_t w0, int64_t w1) {
    ScanScratch sc;
    for (int64_t w = w0; w < w1; w++) {
      int64_t s = w * step;
      int len = (int)std::min<int64_t>(window, L - s);
      if (dimer_provably_zero(seq + s, len, prop)) {
        zero_mask[w] = 1;
      } else {
        zero_mask[w] = get_repeat_count(seq + s, len, prop, sc) == 0 ? 1 : 0;
      }
    }
  };

  if (T == 1) {
    work(0, n_windows);
  } else {
    std::vector<std::thread> threads;
    int64_t per = (n_windows + T - 1) / T;
    for (int t = 0; t < T; t++) {
      int64_t w0 = t * per;
      int64_t w1 = std::min(n_windows, w0 + per);
      if (w0 >= w1) break;
      threads.emplace_back(work, w0, w1);
    }
    for (auto& th : threads) th.join();
  }
  return n_windows;
}

}  // extern "C"
