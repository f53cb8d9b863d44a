// Native per-locus support collection (production call stage).
//
// Exact mirror of the per-record spec in core/collect.py `spanners`
// (reference src/strpkg/collect.nim:130-182), computing for each locus the
// quantities `genotype` consumes: spanning-read rows (CIGAR-projected
// repeat count + indel sum, read order), the spanning-fragment count from
// complete pairs, the window's median depth, the expected spanning sum
// (per-qname sequential averaging in read order + float32 fold in
// first-seen order), the total support count and the 20k distinct-pair
// abort. The Python paths (collect.spanners spec and collect_batched
// vectorized twin) remain; tests assert all three agree bit-for-bit.
//
// One BAI/CRAI region query per locus, loci processed in caller order.
// The caller may shard loci across threads with separate handles — this
// function holds no global state and releases the GIL via ctypes.

#include "sio_util.h"
#include "strling_io.h"

using sio::BamRec;
using sio::Reader;
using sio::endpos;
using sio::SEQ_NT16;

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint16_t SKIP_FLAGS = 0x100 | 0x800 | 0x400;  // sec/supp/dup
constexpr uint16_t FLAG_REVERSE = 0x10;

// cigar op consumes query / consumes ref (MIDNSHP=X, collect.nim:50-71)
constexpr bool CQ[16] = {true, true, false, false, true, false, false,
                         true, true, false, false, false, false, false,
                         false, false};
constexpr bool CR[16] = {true, false, true, true, false, false, false,
                         true, true, false, false, false, false, false,
                         false, false};

// collect.nim:50-71 find_read_position
static int64_t find_read_position(const BamRec& r, int64_t position) {
  int64_t r_off = r.pos;
  int64_t q_off = 0;
  for (uint32_t c : r.cigar) {
    if (r_off > position) return -1;
    int64_t len = c >> 4;
    int op = (int)(c & 0xF);
    if (CQ[op]) q_off += len;
    if (CR[op]) r_off += len;
    if (r_off < position) continue;
    int64_t over = r_off - position;
    if (over > q_off) return -1;
    if (!CQ[op]) return -1;
    return q_off - over;
  }
  return -1;
}


// utils.nim:148-158 median with values clamped to 1047
static int32_t median_depth(const std::vector<int64_t>& depths) {
  int32_t h[1048] = {0};
  for (int64_t d : depths) h[std::min<int64_t>(std::max<int64_t>(d, 0), 1047)]++;
  // numpy minimum() does not clamp negatives; mirror fraglen.median_depth:
  // np.minimum(depths, 1047) keeps negatives, np.bincount would throw —
  // depths are diff-array cumsums and never negative in practice, but
  // clamp at 0 for safety (identical when non-negative).
  int64_t s = 0;
  double half = (double)depths.size() / 2.0;
  for (int i = 0; i < 1048; i++) {
    s += h[i];
    if ((double)s > half) return i;
  }
  return 0;
}

struct QnameVal {
  double val;
  int32_t order;
};

struct PairRec {
  int64_t first_start;
  int64_t second_end;
  int32_t count;
};

}  // namespace

extern "C" {

// Returns 0 on success, -1 on read error, -2 if span_cap was too small
// (caller re-invokes with a bigger buffer). All output arrays are
// caller-allocated; span_off has n_loci+1 entries. out_n_records[i] is the
// number of records locus i's query decoded, before any filter.
int64_t sio_collect_many(
    void* vh, int64_t n_loci, const int32_t* ltid, const int64_t* lleft,
    const int64_t* lright, const char* lrep /*8 bytes per locus, NUL-pad*/,
    int64_t window, const float* cd, int64_t cd_len, int32_t min_mapq,
    int32_t max_size, int32_t* out_n_support, int32_t* out_n_span_reads,
    int32_t* out_n_frag, int32_t* out_med_depth, float* out_expected,
    int64_t span_cap, int64_t* span_off, uint8_t* out_span_rc,
    int32_t* out_span_ind, int32_t want_rc, int64_t* out_n_records) {
  auto* h = (sio::Handle*)vh;
  Reader* rd = h->rd;

  BamRec r;
  std::string dna;
  std::unordered_map<std::string, QnameVal> by_qname;
  std::vector<const std::string*> qname_order;  // first-seen keys
  std::unordered_map<std::string, PairRec> pairs;
  std::vector<int64_t> depths;
  int64_t span_n = 0;
  span_off[0] = 0;

  for (int64_t li = 0; li < n_loci; li++) {
    const int64_t left = lleft[li];
    const int64_t right = lright[li];
    const char* rep = lrep + 8 * li;
    const int64_t replen = (int64_t)strnlen(rep, 6);
    const int64_t wl = left - window;
    const int64_t wr = right + window;
    const int64_t ev = right - left;

    // collect.nim:38-41 slop
    int64_t slop = replen - 1;
    if (right - left < 5) slop += 5 - (right - left);

    by_qname.clear();
    qname_order.clear();
    pairs.clear();
    depths.assign((size_t)std::max<int64_t>(wr - wl, 0), 0);

    int32_t n_overlap = 0;
    int64_t span_start = span_n;
    bool aborted = false;

    if (!rd->begin(1, ltid[li], std::max<int64_t>(0, wl), wr)) return -1;
    int rc;
    out_n_records[li] = 0;
    while ((rc = rd->next(&r)) == 1) {
      out_n_records[li]++;
      if (r.flag & SKIP_FLAGS) continue;
      if (r.mapq < min_mapq) continue;
      const int64_t start = r.pos;
      const int64_t stop = endpos(r);

      // expected spanning probability (spanning.nim:20-49), float64 math
      double prob = 0.0;
      {
        int64_t dist = -1;
        bool ok = false;
        if (start < right - 20) {
          if (!(r.flag & FLAG_REVERSE)) {
            dist = left - start;
            ok = dist >= 0 && dist + ev >= 20;
          }
        } else if (r.flag & FLAG_REVERSE) {
          dist = stop - right;
          ok = dist >= 0 && dist + ev >= 20;
        }
        if (ok) {
          dist += 20 + ev;
          if (dist >= 0 && dist <= cd_len - 1)
            prob = 1.0 - (double)cd[dist];
        }
      }
      if (prob > 0) {
        auto it = by_qname.find(r.qname);
        if (it != by_qname.end()) {
          it->second.val = 0.5 * (it->second.val + prob);
        } else {
          auto ins = by_qname.emplace(
              r.qname, QnameVal{prob, (int32_t)qname_order.size()});
          qname_order.push_back(&ins.first->first);
        }
      }

      if (!depths.empty()) {
        depths[(size_t)std::max<int64_t>(0, start - wl - 1)] += 1;
        depths[(size_t)std::min<int64_t>((int64_t)depths.size() - 1,
                                         stop - wl - 1)] -= 1;
      }

      // overlapping / spanning read (collect.nim:96-116)
      if (r.tid == ltid[li] && std::max(start, left) <= std::min(stop, right)) {
        n_overlap++;
        if (start < (left - slop) && stop > (right + slop)) {
          // spanning read row: repeat count + uint8-wrapped indel sums
          if (span_n >= span_cap) return -2;
          uint8_t rc8 = 0;
          // genotype reads only the indel column and the class counts
          // (genotyper.nim:62-95 uses the indel modes; the repeat-count
          // modes are computed but unused) — the per-read seq decode +
          // CIGAR projection is skipped unless the caller wants the rc
          // column (the equivalence tests do)
          if (want_rc && right >= left) {
            int64_t rl = find_read_position(r, left);
            int64_t rr = find_read_position(r, right);
            // decode 4-bit seq to ASCII lazily (only spanning reads)
            dna.resize((size_t)r.l_seq);
            for (int64_t i = 0; i < r.l_seq; i++) {
              uint8_t b = r.seq4[(size_t)(i / 2)];
              dna[(size_t)i] = SEQ_NT16[(i & 1) ? (b & 0xF) : (b >> 4)];
            }
            if (rl >= 0 && rr < 0) rr = r.l_seq;
            if (!(rl < 0 && rr < 0)) {
              if (rl < 0) rl = 0;
              int64_t sl = std::max<int64_t>(0, rr - rl);
              if (rl + sl > (int64_t)dna.size())
                sl = (int64_t)dna.size() - rl;
              int c = 0;
              if (sl > 0 && replen > 0)
                c = sio_util::count_nonoverlapping(
                    (const uint8_t*)dna.data() + rl, sl, rep, replen);
              if (replen > 0 &&
                  c < (int)((double)sl * 0.7 / (double)replen))  // purity
                c = 0;
              rc8 = (uint8_t)(c & 0xFF);
            }
          }
          int ins = 0, dele = 0;
          for (uint32_t c : r.cigar) {
            int64_t len = c >> 4;
            int op = (int)(c & 0xF);
            if (op == 1) ins = (ins + (int)(len & 0xFF)) & 0xFF;
            if (op == 2) dele = (dele + (int)(len & 0xFF)) & 0xFF;
          }
          out_span_rc[span_n] = rc8;
          out_span_ind[span_n] = ins - dele;
          span_n++;
        }
      }

      // pair candidates (collect.nim:160-170)
      if (r.tid != r.mate_tid) continue;
      if (std::llabs((long long)r.isize) > max_size) continue;
      auto pit = pairs.find(r.qname);
      if (pit == pairs.end()) {
        pairs.emplace(r.qname, PairRec{start, stop, 1});
        if (pairs.size() > 20000) {  // high-depth abort
          aborted = true;
          break;
        }
      } else {
        pit->second.count++;
        if (pit->second.count == 2) pit->second.second_end = stop;
      }
    }
    if (rc < 0) return -1;

    if (aborted) {
      out_n_support[li] = 0;
      out_n_span_reads[li] = 0;
      out_n_frag[li] = 0;
      out_med_depth[li] = -1;
      out_expected[li] = 0.0f;
      span_n = span_start;  // discard this locus's rows
      span_off[li + 1] = span_n;
      continue;
    }

    // expected: f32 fold over first-seen qname order (collect.nim:172-173)
    float expected = 0.0f;
    for (const std::string* q : qname_order)
      expected = (float)((double)expected + by_qname[*q].val);

    // complete pairs -> spanning fragments (collect.nim:36-48,175-179)
    int32_t n_frag = 0;
    for (auto& kv : pairs) {
      if (kv.second.count != 2) continue;
      if (kv.second.first_start < (left - slop) &&
          kv.second.second_end > (right + slop))
        n_frag++;
    }

    // depth cumsum -> median
    int64_t acc = 0;
    for (auto& d : depths) {
      acc += d;
      d = acc;
    }
    out_med_depth[li] = median_depth(depths);
    out_expected[li] = expected;
    out_n_span_reads[li] = (int32_t)(span_n - span_start);
    out_n_frag[li] = n_frag;
    out_n_support[li] = n_overlap + n_frag;
    span_off[li + 1] = span_n;
  }
  return 0;
}

}  // extern "C"
