// Native extract engine: the order-sensitive host side of `extract`.
//
// C++ port of the mate-cache state machine in strling_tpu/core/extract.py
// (itself a line-faithful port of reference src/strpkg/extract.nim:60-248).
// The engine streams BAM records, applies the genome-index fast path, emits
// device-scan rows (primary reads + soft-clip sub-reads under both proportion
// variants), then consumes the kernel's packed unit codes and runs pairing /
// unplaced canonicalization / adjust_by, appending treads in exactly the
// reference's output order.
//
// Python drives the lockstep loop:
//   rows = engine.next()        (C++ reads+packs, applies fast path)
//   results = kernel(rows)      (device)
//   engine.feed(results)        (C++ state machine)

#include "strling_io.h"

#include <atomic>
#include <cassert>
#include <cmath>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>

#if defined(__AVX512BW__) && defined(__AVX512VBMI__)
#include <immintrin.h>
#endif

// exact reference-detector scan (genome_scan.cc): the producer's
// second-stage row filter — byte-faithful to ops/oracle.py get_repeat and
// therefore to the device kernel (fuzz-tested there)
extern "C" void* sio_scan_scratch_new();
extern "C" void sio_scan_scratch_free(void*);
extern "C" int sio_get_repeat_count(void*, const uint8_t*, int64_t, double);


namespace {

using sio::BamRec;
using sio::Reader;
using sio::endpos;

constexpr uint16_t FLAG_PROPER_PAIR = 0x2;
constexpr uint16_t FLAG_REVERSE = 0x10;
constexpr uint16_t FLAG_MATE_REVERSE = 0x20;
constexpr uint16_t FLAG_SECONDARY = 0x100;
constexpr uint16_t FLAG_SUPPLEMENTARY = 0x800;

enum Soft : uint8_t {
  SOFT_LEFT = 0,
  SOFT_RIGHT = 1,
  SOFT_BOTH = 2,
  SOFT_NONE = 3,
  SOFT_NONE_RIGHT = 4,
  SOFT_NONE_LEFT = 5,
};

struct Tread {
  int32_t tid = 0;
  uint32_t position = 0;
  char repeat[6] = {0, 0, 0, 0, 0, 0};
  uint16_t flag = 0;
  uint8_t split = SOFT_NONE;
  uint8_t mapq = 0;
  uint8_t repeat_count = 0;
  uint8_t align_length = 0;
  std::string qname;
  // emission-order key: the sequential extract appends treads in record
  // order, so tagging each tread with the (segment, record tid, record
  // rank, push slot) that emitted it lets ANY sharded run reconstruct the
  // exact single-process bin order by a stable sort (segment 0 = mapped
  // tids ascending, 1 = the no-coor tail of the sequential scan, 2 = the
  // explicit query("*") pass — the block is processed twice,
  // extract.nim:308,326). slots: left clip 0, right clip 1, pair pushes 2,3.
  uint8_t kseg = 0;
  uint8_t ksub = 0;
  int32_t ktid = 0;
  int64_t krank = 0;

  int repeat_length() const {
    for (int i = 0; i < 6; i++)
      if (!repeat[i]) return i;
    return 6;
  }
  // extract.nim:56-58 — uint8 product wraps mod 256
  double p_repeat() const {
    int prod = (int(repeat_count) * repeat_length()) & 0xFF;
    return double(prod) / std::max<int>(1, align_length);
  }
};

// ---- unit canonicalization (nim-kmer 2-bit order, see ops/encode.py) -------

static inline int code2(char c) { return (c >> 1) & 3; }
static const char DECODE[] = "ACTG";

static char complement_base(char c) {
  switch (c) {
    case 'A': return 'T';
    case 'T': return 'A';
    case 'C': return 'G';
    case 'G': return 'C';
    default: return c;
  }
}

// min 2-bit-code rotation of the reverse complement (utils.nim:61-80)
static void min_rev_complement(char rep[6]) {
  int n = 0;
  while (n < 6 && rep[n]) n++;
  if (n == 0) return;
  char rc[6];
  for (int i = 0; i < n; i++) rc[i] = complement_base(rep[n - 1 - i]);
  uint64_t best = ~0ull;
  for (int r = 0; r < n; r++) {
    uint64_t v = 0;
    for (int m = 0; m < n; m++) v = (v << 2) | code2(rc[(m + r) % n]);
    best = std::min(best, v);
  }
  for (int i = 0; i < n; i++)
    rep[i] = DECODE[(best >> (2 * (n - 1 - i))) & 3];
}

// utils.nim:304-316: candidate vs original by NUL-padded ascii compare
static void canonical_repeat(char rep[6]) {
  char cand[6];
  memcpy(cand, rep, 6);
  min_rev_complement(cand);
  if (memcmp(cand, rep, 6) < 0) memcpy(rep, cand, 6);
}

static bool should_reverse(uint16_t flag) {
  // extract.nim:134-139: flip when reverse == mate_reverse
  return bool(flag & FLAG_REVERSE) == bool(flag & FLAG_MATE_REVERSE);
}

// ------------------------------------------------------------------- engine

struct Pending {
  // decoded alignment metadata for one buffered primary record
  uint8_t seg = 0;     // 0 mapped, 1 no-coor (sequential tail), 2 query("*")
  int64_t rank = 0;    // record index within (seg, tid)
  int32_t tid, pos, mate_tid, mate_pos, end_pos, read_len;
  uint16_t flag;
  uint8_t mapq;
  int32_t lclip, rclip;
  int32_t n_cigar;
  int32_t m_len;  // first-op M length when exact-match fast path
  bool fast;
  int32_t scan_row = -1;
  int32_t clip_row_l = -1;  // rows (r, r+1) hold (after, first) variants
  int32_t clip_row_r = -1;
  std::string qname;
};

struct KernelResult {
  int32_t code, len, count;
};

struct Engine {
  Reader* src = nullptr;
  bool begun = false;
  double proportion_repeat = 0.8;
  int min_mapq = 40;
  int64_t median_fragment_length = 0;
  int Lmax = 256;

  bool has_gi = false;
  bool prefilter = true;
  // second-stage exact filter scratch (producer-thread only; the engine is
  // never driven from two threads at once)
  void* exact_scratch = nullptr;
  void* exact_sc() {
    if (!exact_scratch) exact_scratch = sio_scan_scratch_new();
    return exact_scratch;
  }
  std::vector<std::vector<int64_t>> gi_starts, gi_pmax;

  std::unordered_map<std::string, Tread> tbl;
  std::vector<Tread> out;
  // internal row buffers for the fused-payload path (sio_ex_next_fused)
  std::vector<uint8_t> row_bases;
  std::vector<int32_t> row_len;
  std::vector<double> row_prop;
  // sharded (multi-host) mode: iterate only the owned tids (+ optionally
  // the no-coor block); an after-mate lookup miss then means "mate lives in
  // another shard" — the read is spilled for the cross-shard pairing pass
  // instead of dropped (extract.nim:199 drops it: there a miss means a
  // duplicate/missing mate)
  bool sharded = false;
  std::vector<int32_t> shard_tids;
  std::vector<bool> owned;  // tid -> owned by this shard
  size_t shard_i = 0;
  bool shard_unplaced = false;
  bool noc_pass0 = false;  // first (sequential-tail-equivalent) no-coor pass
  std::vector<Tread> spill;
  // FIFO of batches awaiting kernel results (enables Python-side pipelining:
  // the next batch is read+packed while the device scans the previous one)
  std::deque<std::vector<Pending>> queue;
  std::vector<Pending> pending;  // batch being built
  std::vector<KernelResult> results;
  int phase = 0;  // 0 main scan, 1 no-coor scan, 2 done
  int64_t nreads = 0;
  std::string err;
  bool refused = false;  // a scan result's unit did not fit `repeat`

  // --- fragment-length histogram tee (single-stream mode only) ------------
  // Mirrors sio_frag_hist's record predicate over the engine's OWN phase-0
  // stream (which equals the standalone pre-pass's whole-file scan record
  // for record), so extract needs ONE BGZF decode pass instead of two
  // (utils.nim:86-111; the pre-pass was ~45% of host work on a 2-core VM).
  // Producer thread writes; fh_ready is the release/acquire gate after
  // which fh_hist/fh_skipped are frozen (stopped or phase-0 EOF).
  bool fh_enabled = false;
  bool fh_stopped = false;  // counted > fh_n: the reference's early stop
  bool fh_warned = false;
  int64_t fh_i = -1;
  int64_t fh_counted = 0;
  int64_t fh_skip = 100000, fh_n = 2000000;
  std::atomic<int32_t> fh_max_len{0};
  std::atomic<bool> fh_ready{false};
  uint32_t fh_hist[4096] = {0};
  std::vector<int32_t> fh_skipped;

  void fh_tee(const BamRec& r) {
    if (fh_stopped) return;
    fh_i++;
    if (r.l_seq > fh_max_len.load(std::memory_order_relaxed))
      fh_max_len.store(r.l_seq, std::memory_order_relaxed);
    if (!(r.flag & FLAG_PROPER_PAIR)) return;
    if (r.flag & (FLAG_SUPPLEMENTARY | FLAG_SECONDARY)) return;
    if (r.isize < 0) return;
    if (r.isize > 4095) return;
    if (fh_i < fh_skip) {
      fh_skipped.push_back((int32_t)r.isize);
      return;
    }
    fh_skipped.clear();
    fh_hist[r.isize]++;
    if (++fh_counted > fh_n) {
      fh_stopped = true;
      fh_ready.store(true, std::memory_order_release);
    }
  }

  // --- producer-thread pipelining (sio_ex_next_fused) ---------------------
  // BGZF decode + record parse + prefilter + wire packing run on a producer
  // thread while the main thread runs the order-dependent feed state
  // machine and Python dispatches device work: the two big host costs
  // overlap instead of serializing. The producer owns the Reader and the
  // scratch row buffers; the main thread owns tbl/out/results. Handoff is a
  // small Produced record (packed payload + Pending metadata).
  struct Produced {
    std::vector<Pending> pend;
    std::vector<uint8_t> payload;     // fb != 1: rows * rowW packed bytes
    std::vector<uint8_t> ascii_bases; // fb == 1 (IUPAC fallback): raw rows
    std::vector<int32_t> ascii_len;
    std::vector<double> ascii_prop;
    int64_t rows = 0, n_records = 0, rowW = 0;
    int fb = 0;
  };
  std::thread producer;
  std::mutex mu;
  std::condition_variable cv_space, cv_ready;
  std::deque<std::unique_ptr<Produced>> ready_q;
  std::vector<std::unique_ptr<Produced>> pool;
  bool producer_started = false;
  bool producer_done = false;
  bool quitting = false;
  std::string perr;
  int64_t prod_max_records = 0, prod_rows_cap = 0;
  static constexpr size_t MAX_READY = 3;

  ~Engine() {
    stop_producer();  // join the producer FIRST: it uses exact_scratch
    if (exact_scratch) sio_scan_scratch_free(exact_scratch);
  }

  void stop_producer() {
    {
      std::lock_guard<std::mutex> lk(mu);
      quitting = true;
    }
    cv_space.notify_all();
    cv_ready.notify_all();
    if (producer.joinable()) producer.join();
  }

  std::atomic<int64_t> max_len_seen{0};  // longest l_seq the engine saw
  // emission-key rank tracking (producer side)
  int32_t rank_tid = INT32_MIN;
  uint8_t rank_seg = 0;
  int64_t rank_ctr = 0;

  bool gi_overlaps(int tid, int64_t start, int64_t stop) const {
    const auto& s = gi_starts[tid];
    // Lapper.find: iv.start < stop && iv.stop > start
    auto it = std::lower_bound(s.begin(), s.end(), stop);
    size_t idx = it - s.begin();
    if (idx == 0) return false;
    return gi_pmax[tid][idx - 1] > start;
  }

  bool gi_has_chrom(int tid) const {
    return has_gi && tid >= 0 && tid < (int)gi_starts.size() &&
           !gi_starts[tid].empty();
  }

  // Host prefilter: prove the device kernel would return count==0 for this
  // row without running it. The kernel reports a repeat only when some
  // k in 2..6 has exact non-overlapping modal-kmer count > tp[k] where
  // tp[k] = trunc(len * prop / k) (utils.nim:259; same double expression as
  // the fused meta below). Every non-overlapping occurrence of a k-mer
  // (k >= 2) contains an occurrence of that k-mer's FIRST DIMER at a
  // distinct position, so exact_k <= max over the 16 dimers of that dimer's
  // positional count. tp[k] is decreasing in k, so if
  //   max_dimer_count <= tp[6] = trunc(len * prop / 6)
  // then exact_k <= tp[k] for every k and the kernel result is exactly
  // zero — the row never needs to reach the device. Random (non-STR) reads
  // satisfy this with overwhelming probability (~L/16 expected vs the
  // ~0.13*L threshold), which removes ~97% of tunnel payload on WGS-like
  // input. Dimer codes use (c>>1)&3, so N/IUPAC bytes alias real bases and
  // can only OVERcount — the bound stays sound.
  static int max_dimer_count(const uint8_t* s, int len) {
    int cnt[16] = {0};
    for (int j = 0; j + 2 <= len; j++)
      cnt[(((s[j] >> 1) & 3) << 2) | ((s[j + 1] >> 1) & 3)]++;
    int mx = 0;
    for (int v : cnt) mx = std::max(mx, v);
    return mx;
  }

  // exact clip drop: the two phase-A device rows for a clip carry
  // proportions min(pr, 0.6) and pr - 0.07 (see the pack sites below);
  // the clip is droppable iff the reference detector returns 0 at BOTH
  bool clip_exact_zero(const uint8_t* cp, int cl) {
    return sio_get_repeat_count(exact_sc(), cp, cl,
                                std::min(proportion_repeat, 0.6)) == 0 &&
           sio_get_repeat_count(exact_sc(), cp, cl,
                                proportion_repeat - 0.07) == 0;
  }

  bool provably_zero(const uint8_t* s, int len, double prop) const {
    return max_dimer_count(s, len) <= (int)(int64_t)((double)len * prop / 6.0);
  }

  // Same bound straight off the packed 4-bit BAM sequence, so filtered
  // reads (the vast majority) never pay the nibble->ASCII decode. Per-byte
  // LUTs give the two base codes and the intra-byte dimer; codes are
  // (SEQ_NT16[nib]>>1)&3, the exact aliasing the ASCII path uses.
  struct NibLut {
    uint8_t hi[256], lo[256], in[256];
    NibLut() {
      for (int b = 0; b < 256; b++) {
        int h = (sio::SEQ_NT16[b >> 4] >> 1) & 3;
        int l = (sio::SEQ_NT16[b & 15] >> 1) & 3;
        hi[b] = (uint8_t)h;
        lo[b] = (uint8_t)l;
        in[b] = (uint8_t)((h << 2) | l);
      }
    }
  };

#if defined(__AVX512BW__) && defined(__AVX512VBMI__)
  // Vectorized dimer histogram straight off the packed 4-bit sequence:
  // 64 nibble-bytes (128 bases) per iteration. Per chunk: two 16-entry
  // pshufb LUTs decode the hi/lo 2-bit base codes, the cross-byte
  // predecessor comes from a full-width byte permute (VBMI), and each of
  // the 16 dimer values is counted with a masked byte-compare whose
  // 64-bit mask register popcounts in one scalar op. The per-chunk
  // byte-0 cross dimer (carry from the previous chunk) is handled
  // scalarly. Exact same counts as the scalar loop (test hook
  // sio_max_dimer_nib fuzzes them against each other).
  static int max_dimer_count_nib_simd(const uint8_t* seq4, int len) {
    static const NibLut T;
    alignas(16) uint8_t code4[16];
    for (int i = 0; i < 16; i++) code4[i] = T.lo[i];  // lo[b&15] == code of nib
    const __m512i lut =
        _mm512_broadcast_i32x4(_mm_load_si128((const __m128i*)code4));
    const __m512i m0f = _mm512_set1_epi8(0x0f);
    alignas(64) uint8_t shift_idx[64];
    shift_idx[0] = 0;
    for (int i = 1; i < 64; i++) shift_idx[i] = (uint8_t)(i - 1);
    const __m512i idxshift = _mm512_load_si512((const void*)shift_idx);
    const int n_bytes = (len + 1) / 2;
    const int n_in = len / 2;          // in-byte dimer at gb needs 2gb+1 < len
    const int n_cross = (len + 1) / 2; // cross dimer at gb needs 2gb < len
    int cnt[16] = {0};
    int carry = -1;  // lo-code of the previous byte (cross-dimer first base)
    for (int off = 0; off < n_bytes; off += 64) {
      const int rem = n_bytes - off;
      const __mmask64 mload =
          rem >= 64 ? ~0ULL : ((1ULL << rem) - 1);
      const __m512i v = _mm512_maskz_loadu_epi8(mload, seq4 + off);
      const __m512i ch =
          _mm512_shuffle_epi8(lut, _mm512_and_si512(_mm512_srli_epi16(v, 4), m0f));
      const __m512i cl = _mm512_shuffle_epi8(lut, _mm512_and_si512(v, m0f));
      // codes <= 3, so the <<2 stays inside each byte
      const __m512i din =
          _mm512_or_si512(_mm512_slli_epi16(ch, 2) , cl);
      const __m512i pl = _mm512_permutexvar_epi8(idxshift, cl);
      const __m512i dcross = _mm512_or_si512(_mm512_slli_epi16(pl, 2), ch);
      const int in_rem = n_in - off;      // valid in-dimer bytes this chunk
      const int cr_rem = n_cross - off;   // valid cross-dimer bytes (gb>=1)
      const __mmask64 min_m =
          in_rem <= 0 ? 0 : (in_rem >= 64 ? ~0ULL : ((1ULL << in_rem) - 1));
      __mmask64 mcr_m =
          cr_rem <= 0 ? 0 : (cr_rem >= 64 ? ~0ULL : ((1ULL << cr_rem) - 1));
      mcr_m &= ~1ULL;  // local byte 0 pairs with the previous chunk: scalar
      if (min_m | mcr_m) {
        for (int val = 0; val < 16; val++) {
          const __m512i bv = _mm512_set1_epi8((char)val);
          cnt[val] += (int)__builtin_popcountll(
              _mm512_mask_cmpeq_epi8_mask(min_m, din, bv));
          cnt[val] += (int)__builtin_popcountll(
              _mm512_mask_cmpeq_epi8_mask(mcr_m, dcross, bv));
        }
      }
      // scalar carry dimer: (prev chunk's last lo-code, this chunk's first
      // hi-code) at global byte `off`
      if (carry >= 0 && off < n_cross)
        cnt[(carry << 2) | T.hi[seq4[off]]]++;
      const int last = std::min(off + 63, n_bytes - 1);
      carry = (2 * last + 1 < len) ? T.lo[seq4[last]] : -1;
    }
    int mx = 0;
    for (int v : cnt) mx = std::max(mx, v);
    return mx;
  }
#endif

  static int max_dimer_count_nib_scalar(const uint8_t* seq4, int len) {
    static const NibLut T;
    int cnt[16] = {0};
    int prev = -1;
    const int n_bytes = (len + 1) / 2;
    for (int b = 0; b < n_bytes; b++) {
      uint8_t by = seq4[b];
      if (prev >= 0) cnt[(prev << 2) | T.hi[by]]++;
      if (2 * b + 1 < len) {
        cnt[T.in[by]]++;
        prev = T.lo[by];
      }
    }
    int mx = 0;
    for (int v : cnt) mx = std::max(mx, v);
    return mx;
  }

  static int max_dimer_count_nib(const uint8_t* seq4, int len) {
#if defined(__AVX512BW__) && defined(__AVX512VBMI__)
    return max_dimer_count_nib_simd(seq4, len);
#else
    return max_dimer_count_nib_scalar(seq4, len);
#endif
  }

  bool provably_zero_nib(const uint8_t* seq4, int len, double prop) const {
    return max_dimer_count_nib(seq4, len) <=
           (int)(int64_t)((double)len * prop / 6.0);
  }

  void decode_seq(const BamRec& r, std::string* seq) const {
    int L = std::min<int32_t>(r.l_seq, Lmax);
    seq->resize(L);
    for (int i = 0; i < L; i++) {
      uint8_t nib = (r.seq4[i >> 1] >> ((i & 1) ? 0 : 4)) & 0xf;
      (*seq)[i] = sio::SEQ_NT16[nib];
    }
  }

  // Buffer up to max_records primary records, packing scan rows into the
  // caller's buffers and Pending metadata into *out (appended).
  // Returns row count; *n_records set to buffered record count.
  int64_t next(int64_t max_records, int64_t* n_records, uint8_t* bases,
               int32_t* lengths, double* props, int64_t rows_cap,
               std::vector<Pending>* out) {
    pending.clear();
    int64_t rows = 0;
    std::string seq;
    BamRec r;
    if (!begun) {
      if (sharded) {
        if (!shard_tids.empty()) {
          src->begin(1, shard_tids[0], 0, src->ref_lens()[shard_tids[0]]);
          shard_i = 1;
        } else if (shard_unplaced) {
          src->begin(2, -1, 0, 0);
          noc_pass0 = true;  // second pass follows via the phase machine
        } else {
          phase = 2;
        }
      } else {
        src->begin(0, -1, 0, 0);
      }
      begun = true;
    }
    while ((int64_t)pending.size() < max_records && phase < 2) {
      if (rows + 5 > rows_cap) break;  // a record adds at most 1 + 2*2 rows
      int rc = src->next(&r);
      if (rc < 0) {
        err = src->err;
        return -1;
      }
      if (rc == 0) {
        if (sharded && phase == 0 && shard_i < shard_tids.size()) {
          src->begin(1, shard_tids[shard_i], 0, src->ref_lens()[shard_tids[shard_i]]);
          shard_i++;
          continue;
        }
        if (sharded && phase == 0 && shard_unplaced && !noc_pass0) {
          // the sequential whole-file scan reaches the trailing no-coor
          // block once BEFORE the explicit query("*") pass (extract.nim:308,
          // 326 — the block is processed twice); replicate for the shard
          // that owns it
          noc_pass0 = true;
          src->begin(2, -1, 0, 0);
          continue;
        }
        if (phase == 0) {
          if (fh_enabled) fh_ready.store(true, std::memory_order_release);
          if (sharded && !shard_unplaced) {
            phase = 2;
            break;
          }
          // switch to the no-coor block (extract.nim:326: query("*"))
          phase = 1;
          src->begin(2, -1, 0, 0);
          continue;
        }
        phase = 2;
        break;
      }
      // hist tee sees every phase-0 record BEFORE any filtering — the same
      // stream the standalone pre-pass iterates (phase 1 is the second
      // visit of the no-coor block and must not count)
      if (fh_enabled && phase == 0) fh_tee(r);
      if (r.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) continue;
      if (r.l_seq > max_len_seen.load(std::memory_order_relaxed))
        max_len_seen.store(r.l_seq, std::memory_order_relaxed);

      Pending p;
      p.seg = r.tid >= 0 ? 0 : (phase == 0 ? 1 : 2);
      {
        int32_t rt = r.tid >= 0 ? r.tid : -1;
        if (p.seg != rank_seg || rt != rank_tid) {
          rank_seg = p.seg;
          rank_tid = rt;
          rank_ctr = 0;
        }
        p.rank = rank_ctr++;
      }
      p.tid = r.tid;
      p.pos = r.pos;
      p.mate_tid = r.mate_tid;
      p.mate_pos = r.mate_pos;
      p.end_pos = (int32_t)endpos(r);
      p.read_len = r.l_seq;
      p.flag = r.flag;
      p.mapq = r.mapq;
      p.n_cigar = (int32_t)r.cigar.size();
      p.lclip = 0;
      p.rclip = 0;
      p.m_len = 0;
      if (p.n_cigar) {
        if ((r.cigar[0] & 0xf) == 4) p.lclip = r.cigar[0] >> 4;
        if (p.n_cigar > 1 && (r.cigar.back() & 0xf) == 4)
          p.rclip = r.cigar.back() >> 4;
      }
      p.qname = r.qname;

      // reference-STR fast path (extract.nim:29-34)
      bool exact = p.n_cigar == 1 && (r.cigar[0] & 0xf) == 0;
      p.fast = false;
      if (exact && gi_has_chrom(p.tid)) {
        if (!gi_overlaps(p.tid, p.pos, p.end_pos)) {
          p.fast = true;
          p.m_len = r.cigar[0] >> 4;
        }
      }

      int L = std::min<int32_t>(p.read_len, Lmax);
      bool decoded = false;
      if (!p.fast) {
        if (prefilter && provably_zero_nib(r.seq4.data(), L,
                                           proportion_repeat)) {
          p.scan_row = -2;  // kernel result is provably zero; no device row
        } else {
          decode_seq(r, &seq);
          decoded = true;
          // second-stage EXACT filter: the dimer bound passes ~2x more
          // rows than actually scan nonzero; the exact evaluation
          // (identical to the kernel, ~1-2us) keeps them off the wire
          if (prefilter &&
              sio_get_repeat_count(exact_sc(), (const uint8_t*)seq.data(),
                                   L, proportion_repeat) == 0) {
            p.scan_row = -2;
          } else {
            p.scan_row = rows;
            memcpy(bases + rows * Lmax, seq.data(), L);
            memset(bases + rows * Lmax + L, 0, Lmax - L);
            lengths[rows] = L;
            props[rows] = proportion_repeat;
            rows++;
          }
        }
      }
      // soft-clip rows, two proportion variants each (extract.py phase A).
      // Both variants share a prefilter bound at the smaller of the two
      // proportions: if the clip is provably zero at min(prop) it is zero
      // at both, and add_soft's `row < 0` branch already means "count 0".
      const double clip_prop_min =
          std::min(std::min(proportion_repeat, 0.6), proportion_repeat - 0.07);
      if (p.mapq >= min_mapq) {
        if (p.lclip >= 2) {
          if (!decoded) {
            decode_seq(r, &seq);
            decoded = true;
          }
          int cl = std::min<int32_t>(p.lclip, Lmax);
          const uint8_t* cpl = (const uint8_t*)seq.data();
          if (prefilter && (provably_zero(cpl, cl, clip_prop_min) ||
                            clip_exact_zero(cpl, cl))) {
            // leave clip_row_l = -1: same handling as a <2bp clip
          } else {
            p.clip_row_l = rows;
            for (int v = 0; v < 2; v++) {
              memcpy(bases + rows * Lmax, seq.data(), cl);
              memset(bases + rows * Lmax + cl, 0, Lmax - cl);
              lengths[rows] = cl;
              props[rows] = v == 0 ? std::min(proportion_repeat, 0.6)
                                   : proportion_repeat - 0.07;
              rows++;
            }
          }
        }
        if (p.rclip >= 2) {
          if (!decoded) {
            decode_seq(r, &seq);
            decoded = true;
          }
          int cl = std::min<int32_t>(p.rclip, Lmax);
          const uint8_t* cpr = (const uint8_t*)seq.data() + L - cl;
          if (prefilter && (provably_zero(cpr, cl, clip_prop_min) ||
                            clip_exact_zero(cpr, cl))) {
            // leave clip_row_r = -1
          } else {
            p.clip_row_r = rows;
            for (int v = 0; v < 2; v++) {
              memcpy(bases + rows * Lmax, seq.data() + L - cl, cl);
              memset(bases + rows * Lmax + cl, 0, Lmax - cl);
              lengths[rows] = cl;
              props[rows] = v == 0 ? std::min(proportion_repeat, 0.6)
                                   : proportion_repeat - 0.07;
              rows++;
            }
          }
        }
      }
      pending.push_back(std::move(p));
    }
    *n_records = (int64_t)pending.size();
    if (!pending.empty()) {
      *out = std::move(pending);
      pending.clear();
    }
    return rows;
  }

  // One producer step: read a batch, choose the wire layout, pack. Mirrors
  // the synchronous sio_ex_next_fused contract (fb 0/2 = fused payload at
  // rowW stride, fb 1 = raw ASCII fallback for IUPAC bytes).
  bool produce(Produced* p) {
    const int64_t rows_cap = prod_rows_cap;
    row_bases.resize((size_t)rows_cap * Lmax);
    row_len.resize(rows_cap);
    row_prop.resize(rows_cap);
    p->pend.clear();
    int64_t rows = next(prod_max_records, &p->n_records, row_bases.data(),
                        row_len.data(), row_prop.data(), rows_cap, &p->pend);
    if (rows < 0) {
      perr = src->err.empty() ? "read error" : src->err;
      return false;
    }
    p->rows = rows;
    p->fb = 0;
    p->rowW = 0;
    if (rows == 0) return true;
    static bool ok_tbl_init = false;
    static bool ok_tbl[256];
    if (!ok_tbl_init) {
      memset(ok_tbl, 0, sizeof(ok_tbl));
      ok_tbl[0] = ok_tbl['A'] = ok_tbl['C'] = ok_tbl['G'] = ok_tbl['T'] =
          ok_tbl['N'] = true;
      ok_tbl_init = true;
    }
    bool iupac = false;
    bool has_n = false;
    for (int64_t r = 0; r < rows && !iupac; r++) {
      const uint8_t* src8 = row_bases.data() + (size_t)r * Lmax;
      for (int j = 0; j < row_len[r]; j++) {
        if (!ok_tbl[src8[j]]) {
          iupac = true;
          break;
        }
        has_n |= src8[j] == 'N';
      }
    }
    if (iupac) {
      p->fb = 1;
      p->ascii_bases.assign(row_bases.data(),
                            row_bases.data() + (size_t)rows * Lmax);
      p->ascii_len.assign(row_len.data(), row_len.data() + rows);
      p->ascii_prop.assign(row_prop.data(), row_prop.data() + rows);
      return true;
    }
    const bool meta8 = Lmax <= 248 && proportion_repeat <= 1.0;
    const bool non = meta8 && !has_n;
    const int64_t rowW = non ? (int64_t)Lmax / 4 + 11
                             : 3 * (int64_t)Lmax / 8 + (meta8 ? 11 : 22);
    p->rowW = rowW;
    p->fb = non ? 2 : 0;
    p->payload.resize((size_t)rows * rowW);
    pack_rows(p->payload.data(), rows, rowW, meta8, non);
    return true;
  }

  // pack `rows` scratch rows into `dst` at rowW stride (fused wire layout)
  void pack_rows(uint8_t* payload, int64_t rows, int64_t rowW, bool meta8,
                 bool non) {
    for (int64_t r = 0; r < rows; r++) {
      const uint8_t* src8 = row_bases.data() + (size_t)r * Lmax;
      uint8_t* dst = payload + r * rowW;
      for (int j = 0; j < Lmax; j += 4)
        dst[j >> 2] =
            (uint8_t)(((src8[j] >> 1) & 3) | ((src8[j + 1] >> 1) & 3) << 2 |
                      ((src8[j + 2] >> 1) & 3) << 4 |
                      ((src8[j + 3] >> 1) & 3) << 6);
      int64_t meta_off = Lmax / 4;
      if (!non) {
        uint8_t* nb = dst + Lmax / 4;
        for (int j = 0; j < Lmax; j += 8) {
          uint8_t b = 0;
          for (int i = 0; i < 8; i++) b |= (uint8_t)(src8[j + i] == 'N') << i;
          nb[j >> 3] = b;
        }
        meta_off = 3 * Lmax / 8;
      }
      const double L = (double)row_len[r];
      const double prop = row_prop[r];
      if (meta8) {  // u8 meta (te<=14, tp<=124, length<=248)
        uint8_t* meta = dst + meta_off;
        for (int ki = 0; ki < 5; ki++) {
          const double k = (double)(ki + 2);
          meta[ki] = (uint8_t)(int64_t)(L * 0.12 / k);
          meta[5 + ki] = (uint8_t)(int64_t)(L * prop / k);
        }
        meta[10] = (uint8_t)row_len[r];
      } else {
        uint16_t* meta = (uint16_t*)(dst + meta_off);
        for (int ki = 0; ki < 5; ki++) {
          const double k = (double)(ki + 2);
          meta[ki] = (uint16_t)(int64_t)(L * 0.12 / k);
          meta[5 + ki] = (uint16_t)(int64_t)(L * prop / k);
        }
        meta[10] = (uint16_t)row_len[r];
      }
    }
  }

  void producer_loop() {
    for (;;) {
      std::unique_ptr<Produced> p;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return quitting || ready_q.size() < MAX_READY;
        });
        if (quitting) return;
        if (!pool.empty()) {
          p = std::move(pool.back());
          pool.pop_back();
        }
      }
      if (!p) p = std::make_unique<Produced>();
      bool ok = produce(p.get());
      bool at_end = ok && p->n_records == 0 && phase >= 2;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (!ok) {
          producer_done = true;  // perr set; surfaced by next pop
        } else {
          ready_q.push_back(std::move(p));
          if (at_end) producer_done = true;
        }
      }
      cv_ready.notify_all();
      if (!ok || at_end) return;
    }
  }

  // main-thread side: pop the next produced batch (starts the thread on
  // first use), copy into the caller's buffers, queue Pending for feed()
  int64_t pop_fused(int64_t max_records, int64_t* n_records, uint8_t* payload,
                    uint8_t* ascii_bases, int32_t* ascii_len,
                    double* ascii_prop, int64_t rows_cap,
                    int32_t* used_fallback) {
    if (!producer_started) {
      producer_started = true;
      prod_max_records = max_records;
      prod_rows_cap = rows_cap;
      producer = std::thread([this] { producer_loop(); });
    }
    std::unique_ptr<Produced> p;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_ready.wait(lk, [&] {
        return !ready_q.empty() || (producer_done && !perr.empty()) ||
               (producer_done && ready_q.empty());
      });
      if (ready_q.empty()) {
        if (!perr.empty()) {
          err = perr;
          return -1;
        }
        *n_records = 0;
        *used_fallback = 0;
        return 0;  // drained
      }
      p = std::move(ready_q.front());
      ready_q.pop_front();
    }
    cv_space.notify_all();
    *n_records = p->n_records;
    *used_fallback = p->fb;
    int64_t rows = p->rows;
    if (rows > 0) {
      if (p->fb == 1) {
        memcpy(ascii_bases, p->ascii_bases.data(), (size_t)rows * Lmax);
        memcpy(ascii_len, p->ascii_len.data(), rows * sizeof(int32_t));
        memcpy(ascii_prop, p->ascii_prop.data(), rows * sizeof(double));
      } else {
        // caller's buffer is rows_cap*maxW and pre-zeroed; rows are packed
        // at p->rowW stride which the Python side re-views
        memcpy(payload, p->payload.data(), (size_t)rows * p->rowW);
      }
    }
    if (!p->pend.empty()) queue.push_back(std::move(p->pend));
    {
      std::lock_guard<std::mutex> lk(mu);
      if (pool.size() < MAX_READY + 1) pool.push_back(std::move(p));
    }
    return rows;
  }

  bool drained() {
    std::lock_guard<std::mutex> lk(mu);
    return producer_started ? (producer_done && ready_q.empty())
                            : phase >= 2;
  }

  // A unit longer than the 6-byte `repeat` is refused, never written: the
  // engine's error is set and sio_ex_feed returns -1. (The JAX package's
  // packed word lets counts of 256 and more spill into the unit length, and
  // a length of 7 would write one byte past `repeat`.)
  void unit_from_result(const KernelResult& kr, Tread* t) {
    t->repeat_count = (uint8_t)kr.count;
    memset(t->repeat, 0, 6);
    if (kr.len < 0 || kr.len > 6) {
      if (!refused)
        err = "scan result with a unit length of " + std::to_string(kr.len) +
              " (at most 6)";
      refused = true;
      return;
    }
    for (int i = 0; i < kr.len; i++)
      t->repeat[i] = DECODE[(kr.code >> (2 * (kr.len - 1 - i))) & 3];
  }

  // extract.nim:182-190
  bool unplaced_pair(const Tread& a, const Tread& b) const {
    double pr = proportion_repeat;
    if (a.p_repeat() > pr && b.p_repeat() > pr) return true;
    if (a.p_repeat() > pr && b.mapq < min_mapq) return true;
    if (b.p_repeat() > pr && a.mapq < min_mapq) return true;
    return false;
  }

  // extract.nim:141-179; mutates a, returns keep
  bool adjust_by(Tread& a, const Tread& b, uint32_t b_position) const {
    if (a.repeat_count == 0) return false;
    if (b.mapq > min_mapq &&
        ((a.p_repeat() > proportion_repeat && b.p_repeat() < 0.2) ||
         (!(a.flag & FLAG_PROPER_PAIR) && a.mapq < min_mapq))) {
      uint32_t half = (uint32_t)(int64_t)(a.align_length / 2.0 + 0.5);
      if (b.flag & FLAG_REVERSE) {
        a.position = (uint32_t)(b_position - (uint32_t)median_fragment_length +
                                b.align_length + half);
        if (b.split == SOFT_NONE_LEFT) a.position = b_position;
      } else {
        a.position =
            (uint32_t)(b_position + (uint32_t)median_fragment_length - half);
        if (b.split == SOFT_NONE_RIGHT)
          a.position = b_position + (uint32_t)b.align_length;
      }
      a.split = SOFT_NONE;
      a.tid = b.tid;
      a.mapq = std::max(a.mapq, b.mapq);
      if (should_reverse(a.flag)) min_rev_complement(a.repeat);
    } else if (a.mapq >= min_mapq || (a.flag & FLAG_PROPER_PAIR)) {
      a.position += (uint32_t)(int64_t)(a.align_length / 2.0 + 0.5);
      a.mapq = std::max(a.mapq, b.mapq);
    }
    return true;
  }

  // extract.nim:93-132 (clip treads go straight to out)
  void add_soft(const Pending& p, bool first, const char main_repeat[6]) {
    if (p.mapq < min_mapq) return;
    struct Side {
      int row;
      int clip_len;
      bool left;
    } sides[2] = {{p.clip_row_l, p.lclip, true}, {p.clip_row_r, p.rclip, false}};
    for (auto& s : sides) {
      if (s.clip_len == 0) continue;
      if (main_repeat[0] == 0 && s.clip_len <= 16) continue;
      if (s.row < 0) continue;  // <2bp clip: detector would return 0 anyway
      const KernelResult& kr = results[s.row + (first ? 1 : 0)];
      if (kr.count == 0) continue;
      Tread t;
      t.tid = p.tid;
      t.position = (uint32_t)std::max<int32_t>(0, s.left ? p.pos : p.end_pos);
      t.flag = p.flag;
      unit_from_result(kr, &t);
      t.align_length = (uint8_t)std::min<int32_t>(s.clip_len, Lmax);
      t.split = s.left ? SOFT_LEFT : SOFT_RIGHT;
      t.mapq = p.mapq;
      t.qname = p.qname;
      t.kseg = p.seg;
      t.ktid = p.tid;
      t.krank = p.rank;
      t.ksub = s.left ? 0 : 1;
      if (t.p_repeat() < 0.9) continue;  // extract.nim:131
      out.push_back(std::move(t));
    }
  }

  // run the state machine over the OLDEST queued batch (extract.nim:192-248)
  void feed() {
    if (queue.empty()) {
      results.clear();
      return;
    }
    std::vector<Pending> batch = std::move(queue.front());
    queue.pop_front();
    // non-const: qnames are MOVED out of the batch below (a const ref
    // would silently bind std::move to the copy constructor)
    for (Pending& p : batch) {
      nreads++;
      Tread tr;
      tr.tid = p.tid;
      tr.position = (uint32_t)std::max<int32_t>(0, p.pos);
      tr.flag = p.flag;
      tr.split = SOFT_NONE;
      tr.mapq = p.mapq;
      tr.kseg = p.seg;
      tr.ktid = p.tid;
      tr.krank = p.rank;
      // qname is moved in (not copied) below, after add_soft's last use of
      // p.qname; cached treads keep it in the table key instead
      if (p.fast) {
        tr.repeat_count = 0;
        tr.align_length = (uint8_t)p.m_len;
      } else if (p.scan_row == -2) {
        // prefiltered: the kernel would have returned count 0 (see
        // provably_zero); identical downstream state to a zero scan result
        tr.repeat_count = 0;
        tr.align_length = (uint8_t)std::min<int32_t>(p.read_len, Lmax);
      } else {
        const KernelResult& kr = results[p.scan_row];
        assert(kr.count < 256);
        unit_from_result(kr, &tr);
        tr.align_length = (uint8_t)std::min<int32_t>(p.read_len, Lmax);
      }
      if (p.n_cigar > 1) {
        if (p.lclip > 16) tr.split = SOFT_NONE_LEFT;
        if (p.rclip > 16) tr.split = SOFT_NONE_RIGHT;
      }

      bool after_mate =
          p.tid > p.mate_tid ||
          (p.tid == p.mate_tid &&
           (p.pos > p.mate_pos ||
            (p.pos == p.mate_pos && tbl.count(p.qname) > 0)));

      if (after_mate) {
        auto it = tbl.find(p.qname);
        if (it == tbl.end()) {
          // In sharded mode a miss whose mate tid belongs to ANOTHER shard
          // means the mate is remote: keep our side for the cross-shard
          // pairing pass. Misses whose mate tid we own (or whose mate is
          // unmapped-no-coor, mate_tid -1) are genuine drops, exactly as in
          // the reference (extract.nim:199).
          if (sharded && p.mate_tid >= 0 &&
              (p.mate_tid >= (int32_t)owned.size() || !owned[p.mate_tid])) {
            add_soft(p, /*first=*/false, tr.repeat);
            tr.qname = std::move(p.qname);
            spill.push_back(std::move(tr));
          }
          continue;
        }
        auto nh = tbl.extract(it);
        Tread mate = std::move(nh.mapped());
        mate.qname = std::move(nh.key());
        add_soft(p, /*first=*/false, tr.repeat);
        tr.qname = std::move(p.qname);
        // pair emission happens at THIS record: both treads sort under the
        // current record's key, in push order (slots 2, 3)
        mate.kseg = p.seg;
        mate.ktid = p.tid;
        mate.krank = p.rank;
        if (mate.repeat_count == 0 && tr.repeat_count == 0) continue;
        if (unplaced_pair(tr, mate)) {
          if (tr.repeat[0] == 0 || mate.repeat[0] == 0) continue;
          canonical_repeat(tr.repeat);
          tr.position = 0;
          tr.tid = -1;
          canonical_repeat(mate.repeat);
          mate.position = 0;
          mate.tid = -1;
          tr.ksub = 2;
          mate.ksub = 3;
          out.push_back(std::move(tr));
          out.push_back(std::move(mate));
          continue;
        }
        uint32_t mp = mate.position;
        mate.ksub = 2;
        tr.ksub = 3;
        if (adjust_by(mate, tr, tr.position)) out.push_back(mate);
        if (adjust_by(tr, mate, mp)) out.push_back(tr);
      } else {
        add_soft(p, /*first=*/true, tr.repeat);
        if (sharded && p.mate_tid >= 0 &&
            (p.mate_tid >= (int32_t)owned.size() || !owned[p.mate_tid])) {
          // mate is in another shard: it can never arrive in this stream —
          // spill for the cross-shard pairing pass instead of caching
          tr.qname = std::move(p.qname);
          spill.push_back(std::move(tr));
          continue;
        }
        // the table key carries the qname; the cached Tread's own qname
        // stays empty until extraction moves the key back in
        auto ins = tbl.emplace(std::move(p.qname), std::move(tr));
        if (!ins.second) {
          fprintf(stderr,
                  "[strling] warning. bad read (this happens with bwa-kit "
                  "alignments):%s already in table\n",
                  ins.first->first.c_str());
          tbl.erase(ins.first);
        }
      }
    }
    results.clear();
  }
};

}  // namespace

extern "C" {

void* sio_ex_create(void* bam_handle, double proportion_repeat, int min_mapq,
                    int64_t median_fragment_length, int Lmax) {
  auto* h = (sio::Handle*)bam_handle;
  Engine* e = new Engine();
  e->src = h->rd;
  e->proportion_repeat = proportion_repeat;
  e->min_mapq = min_mapq;
  e->median_fragment_length = median_fragment_length;
  e->Lmax = Lmax;
  int n = (int)h->rd->ref_names().size();
  e->gi_starts.resize(n);
  e->gi_pmax.resize(n);
  return e;
}

void sio_ex_destroy(void* ve) { delete (Engine*)ve; }

void sio_ex_set_index(void* ve, int tid, const int64_t* starts,
                      const int64_t* pmax, int64_t n) {
  Engine* e = (Engine*)ve;
  e->has_gi = true;
  e->gi_starts[tid].assign(starts, starts + n);
  e->gi_pmax[tid].assign(pmax, pmax + n);
}

int64_t sio_ex_next(void* ve, int64_t max_records, int64_t* n_records,
                    uint8_t* bases, int32_t* lengths, double* props,
                    int64_t rows_cap) {
  Engine* e = (Engine*)ve;
  if (e->producer_started) {
    e->err = "cannot mix sio_ex_next with the pipelined fused reader";
    return -1;
  }
  std::vector<Pending> tmp;
  int64_t rows = e->next(max_records, n_records, bases, lengths, props,
                         rows_cap, &tmp);
  if (!tmp.empty()) e->queue.push_back(std::move(tmp));
  return rows;
}

// Fused-payload batch read: rows come out directly in the kernel's wire
// layout (ops/kmer.py fuse_payload; see Engine::pack_rows for the exact
// bytes and the te/tp double-precision expressions, utils.nim:251,259).
// Production path is PIPELINED: a producer thread decodes+prefilters+packs
// the next batch while the caller's thread runs feed() and Python
// dispatches device work. If a batch contains a byte outside {0,A,C,G,T,N}
// the 2-bit code is not faithful, so raw ASCII rows are returned instead
// (*used_fallback = 1).
int64_t sio_ex_next_fused(void* ve, int64_t max_records, int64_t* n_records,
                          uint8_t* payload, uint8_t* ascii_bases,
                          int32_t* ascii_len, double* ascii_prop,
                          int64_t rows_cap, int32_t* used_fallback) {
  return ((Engine*)ve)->pop_fused(max_records, n_records, payload,
                                  ascii_bases, ascii_len, ascii_prop,
                                  rows_cap, used_fallback);
}

int sio_ex_feed(void* ve, const int32_t* unit_code, const int32_t* unit_len,
                const int32_t* counts, int64_t n_rows) {
  Engine* e = (Engine*)ve;
  e->results.resize(n_rows);
  for (int64_t i = 0; i < n_rows; i++)
    e->results[i] = {unit_code[i], unit_len[i], counts[i]};
  e->feed();
  return e->refused ? -1 : 0;
}

int sio_ex_done(void* ve) { return ((Engine*)ve)->drained() ? 1 : 0; }

// Restrict the engine to a tid shard (multi-host extract). Must be called
// before the first sio_ex_next*; tids are iterated in the given order via
// index region queries. include_unplaced additionally scans the no-coor
// block (exactly one shard should own it).
int sio_ex_set_shard(void* ve, const int32_t* tids, int64_t n_tids,
                     int include_unplaced) {
  Engine* e = (Engine*)ve;
  if (e->begun || e->producer_started) return -1;
  e->sharded = true;
  e->shard_tids.assign(tids, tids + n_tids);
  int n = (int)e->gi_starts.size();
  e->owned.assign(n, false);
  for (int64_t i = 0; i < n_tids; i++)
    if (tids[i] >= 0 && tids[i] < n) e->owned[tids[i]] = true;
  e->shard_unplaced = include_unplaced != 0;
  e->fh_enabled = false;  // tee needs the whole-file phase-0 stream
  return 0;
}

// Enable the fragment-length histogram tee over the engine's own phase-0
// stream (single-stream mode only; see Engine::fh_tee). Must be called
// before the first sio_ex_next*.
int sio_ex_set_hist_tee(void* ve, int64_t skip_reads, int64_t n_reads) {
  Engine* e = (Engine*)ve;
  if (e->begun || e->producer_started || e->sharded) return -1;
  e->fh_enabled = true;
  e->fh_skip = skip_reads;
  e->fh_n = n_reads;
  return 0;
}

// 1 once the teed histogram is frozen: the reference's 2M-record budget was
// consumed, or the phase-0 stream ended. The driver holds feeds (which are
// the only consumer of the median) until this flips.
int sio_ex_hist_ready(void* ve) {
  return ((Engine*)ve)->fh_ready.load(std::memory_order_acquire) ? 1 : 0;
}

// Copy out the teed histogram (+ max l_seq over the tee'd stream). Applies
// the reference's not-enough-pairs fallback to the copy (utils.nim:104-108:
// fall back to the skipped first-window isizes). -1 if not ready.
int sio_ex_get_hist(void* ve, uint32_t* hist /*4096*/,
                    int32_t* max_read_len) {
  Engine* e = (Engine*)ve;
  if (!e->fh_ready.load(std::memory_order_acquire)) return -1;
  memcpy(hist, e->fh_hist, 4096 * sizeof(uint32_t));
  *max_read_len = e->fh_max_len.load(std::memory_order_relaxed);
  uint64_t total = 0;
  for (int j = 0; j < 4096; j++) total += hist[j];
  if (total == 0) {
    if (!e->fh_warned) {
      fprintf(stderr,
              "using first reads in fragment_length_distribution calculation "
              "as there were not enough\n");
      e->fh_warned = true;
    }
    for (int32_t v : e->fh_skipped) hist[v]++;
  }
  return 0;
}

// Toggle the host dimer-bound prefilter (on by default; tests disable it to
// cross-check that outputs are byte-identical either way).
void sio_ex_set_prefilter(void* ve, int enabled) {
  ((Engine*)ve)->prefilter = enabled != 0;
}

// Deferred median: the fragment-length pre-pass (utils.nim:86-111) can run
// concurrently with the producer because the median is only consumed by
// feed()'s adjust_by (extract.nim:141-179). Must be set before the first
// sio_ex_feed.
void sio_ex_set_median(void* ve, int64_t median) {
  ((Engine*)ve)->median_fragment_length = median;
}

// Longest primary-record l_seq the engine has seen (to validate a peeked
// Lmax after the run: a longer read would have been truncated on the wire).
int64_t sio_ex_max_len(void* ve) {
  return ((Engine*)ve)->max_len_seen.load(std::memory_order_relaxed);
}

// Light-parse the first n records (sequential) and report the max l_seq —
// the cheap Lmax probe for the overlapped extract. Rewinds by virtue of the
// next begin() call re-priming the iterator.
int64_t sio_peek_max_len(void* bam_handle, int64_t n_records) {
  auto* h = (sio::Handle*)bam_handle;
  Reader* rd = h->rd;
  rd->begin(0, -1, 0, 0);
  rd->set_light(true);
  BamRec r;
  int64_t mx = 0;
  for (int64_t i = 0; i < n_records; i++) {
    int rc = rd->next(&r);
    if (rc <= 0) break;
    mx = std::max<int64_t>(mx, r.l_seq);
  }
  rd->set_light(false);
  return mx;
}

int64_t sio_ex_n_spill(void* ve) {
  return (int64_t)((Engine*)ve)->spill.size();
}

int64_t sio_ex_get_spill(void* ve, int32_t* tid, uint32_t* position,
                         uint8_t* repeat6, uint16_t* flag, uint8_t* split,
                         uint8_t* mapq, uint8_t* repeat_count,
                         uint8_t* align_length, char* qname_buf,
                         int64_t qname_cap, int64_t* qname_off) {
  Engine* e = (Engine*)ve;
  int64_t qoff = 0;
  qname_off[0] = 0;
  for (size_t i = 0; i < e->spill.size(); i++) {
    const Tread& t = e->spill[i];
    tid[i] = t.tid;
    position[i] = t.position;
    memcpy(repeat6 + 6 * i, t.repeat, 6);
    flag[i] = t.flag;
    split[i] = t.split;
    mapq[i] = t.mapq;
    repeat_count[i] = t.repeat_count;
    align_length[i] = t.align_length;
    if (qoff + (int64_t)t.qname.size() > qname_cap) return -1;
    memcpy(qname_buf + qoff, t.qname.data(), t.qname.size());
    qoff += (int64_t)t.qname.size();
    qname_off[i + 1] = qoff;
  }
  return (int64_t)e->spill.size();
}

// Emission-order keys for the output (which=0) or spill (which=1) treads —
// the sharded extract sorts gathered treads by (seg, tid, rank, sub) to
// reproduce the sequential bin order byte-for-byte.
int64_t sio_ex_get_keys(void* ve, int which, uint8_t* seg, int32_t* ktid,
                        int64_t* krank, uint8_t* ksub) {
  Engine* e = (Engine*)ve;
  const std::vector<Tread>& v = which ? e->spill : e->out;
  for (size_t i = 0; i < v.size(); i++) {
    seg[i] = v[i].kseg;
    ktid[i] = v[i].ktid;
    krank[i] = v[i].krank;
    ksub[i] = v[i].ksub;
  }
  return (int64_t)v.size();
}

int64_t sio_ex_nreads(void* ve) { return ((Engine*)ve)->nreads; }

int64_t sio_ex_n_treads(void* ve) { return (int64_t)((Engine*)ve)->out.size(); }

int64_t sio_ex_get_treads(void* ve, int32_t* tid, uint32_t* position,
                          uint8_t* repeat6, uint16_t* flag, uint8_t* split,
                          uint8_t* mapq, uint8_t* repeat_count,
                          uint8_t* align_length, char* qname_buf,
                          int64_t qname_cap, int64_t* qname_off) {
  Engine* e = (Engine*)ve;
  int64_t qoff = 0;
  qname_off[0] = 0;
  for (size_t i = 0; i < e->out.size(); i++) {
    const Tread& t = e->out[i];
    tid[i] = t.tid;
    position[i] = t.position;
    memcpy(repeat6 + 6 * i, t.repeat, 6);
    flag[i] = t.flag;
    split[i] = t.split;
    mapq[i] = t.mapq;
    repeat_count[i] = t.repeat_count;
    align_length[i] = t.align_length;
    if (qoff + (int64_t)t.qname.size() > qname_cap) return -1;
    memcpy(qname_buf + qoff, t.qname.data(), t.qname.size());
    qoff += (int64_t)t.qname.size();
    qname_off[i + 1] = qoff;
  }
  return (int64_t)e->out.size();
}

const char* sio_ex_error(void* ve) { return ((Engine*)ve)->err.c_str(); }

// Genome-index window prefilter (core/genome_index.py): for each window of
// `window` bases at stride `step` over an ASCII chromosome, set mask=1 when
// the dimer-count bound proves the repeat kernel would return count==0
// (same bound as Engine::provably_zero; genome_strs.nim:61-92 scans these
// windows through the same detector as reads). Runs at several million
// windows/s on one core, so a human genome's 53M windows prefilter in
// seconds and only the repeat-bearing windows travel to the device.
int64_t sio_genome_prefilter(const uint8_t* seq, int64_t L, int64_t window,
                             int64_t step, double prop, uint8_t* zero_mask) {
  int64_t n_windows = L > 0 ? (L + step - 1) / step : 0;
  for (int64_t w = 0; w < n_windows; w++) {
    int64_t s = w * step;
    int64_t len = std::min(window, L - s);
    zero_mask[w] =
        Engine::max_dimer_count(seq + s, (int)len) <=
                (int)(int64_t)((double)len * prop / 6.0)
            ? 1
            : 0;
  }
  return n_windows;
}

// Native fragment-length histogram pre-pass (utils.nim:86-111).
// Also reports the max read length seen (for adaptive transfer width).
// test hook: the packed-nibble dimer bound, SIMD (force_scalar=0, when
// compiled in) vs the scalar reference (force_scalar=1) — fuzzed against
// each other in tests/test_extract_native.py
int sio_max_dimer_nib(const uint8_t* seq4, int len, int force_scalar) {
  if (force_scalar) return Engine::max_dimer_count_nib_scalar(seq4, len);
  return Engine::max_dimer_count_nib(seq4, len);
}

int sio_frag_hist(void* bam_handle, int64_t skip_reads, int64_t n_reads,
                  uint32_t* hist /*4096*/, int32_t* max_read_len) {
  auto* h = (sio::Handle*)bam_handle;
  Reader* rd = h->rd;
  rd->begin(0, -1, 0, 0);
  rd->set_light(true);  // only flag/isize/l_seq are read below
  memset(hist, 0, 4096 * sizeof(uint32_t));
  *max_read_len = 0;
  std::vector<int32_t> skipped;
  BamRec r;
  int64_t i = -1;
  int64_t counted = 0;
  while (true) {
    int rc = rd->next(&r);
    if (rc <= 0) break;
    i++;
    *max_read_len = std::max(*max_read_len, r.l_seq);
    if (!(r.flag & FLAG_PROPER_PAIR)) continue;
    if (r.flag & (FLAG_SUPPLEMENTARY | FLAG_SECONDARY)) continue;
    if (r.isize < 0) continue;
    if (r.isize > 4095) continue;
    if (i < skip_reads) {
      skipped.push_back(r.isize);
      continue;
    }
    skipped.clear();
    hist[r.isize]++;
    counted++;
    if (counted > n_reads) break;
  }
  rd->set_light(false);
  uint64_t total = 0;
  for (int j = 0; j < 4096; j++) total += hist[j];
  if (total == 0) {
    fprintf(stderr,
            "using first reads in fragment_length_distribution calculation as "
            "there were not enough\n");
    for (int32_t v : skipped) hist[v]++;
  }
  return 0;
}

}  // extern "C"
