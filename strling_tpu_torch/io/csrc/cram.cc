// cram.cc — from-scratch CRAM 3.0 reader (no htslib in this environment).
//
// Implements the subset of the CRAM 3.0 specification needed to play the
// reference's htslib role for CRAM inputs (SURVEY.md §2 native-component
// ledger items 1-3): sequential record streaming, CRAI region queries, the
// no-coor ("*") scan, and reference-based sequence reconstruction.
//
// Supported block codecs: raw, gzip, rANS4x8 (order 0 and 1), and the CRAM
// 3.1 codecs: rANSNx16 (orders 0/1, 4- and 32-way, pack/RLE/stripe/cat),
// adaptive arithmetic (method 6), fqzcomp qualities (method 7,
// single-parameter streams), and the name tokeniser (method 8, rans or
// arith token streams). bzip2/lzma block compression is not supported.
// Supported field encodings: EXTERNAL, HUFFMAN (canonical), BETA, GAMMA,
// BYTE_ARRAY_LEN, BYTE_ARRAY_STOP.
//
// Exposed through the sio::Reader interface (strling_io.h) so the extract
// engine, frag-hist pass and batch iterators work on CRAM transparently.

#include "strling_io.h"

#include <lzma.h>

#include <array>
#include <climits>
#include <condition_variable>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <thread>

namespace {

using sio::BamRec;
using sio::Reader;

// ------------------------------------------------------------------ cursors

struct Buf {
  const uint8_t* p = nullptr;
  const uint8_t* e = nullptr;
  bool fail = false;

  Buf() = default;
  Buf(const uint8_t* b, size_t n) : p(b), e(b + n) {}
  size_t left() const { return (size_t)(e - p); }
  uint8_t u8() {
    if (p >= e) { fail = true; return 0; }
    return *p++;
  }
  bool raw(void* dst, size_t n) {
    if (left() < n) { fail = true; memset(dst, 0, n); return false; }
    if (n) memcpy(dst, p, n);  // p may be null on an empty cursor
    p += n;
    return true;
  }
  uint32_t u32le() {
    uint8_t b[4];
    raw(b, 4);
    return (uint32_t)b[0] | ((uint32_t)b[1] << 8) | ((uint32_t)b[2] << 16) |
           ((uint32_t)b[3] << 24);
  }
  uint32_t u16le() {
    uint32_t lo = u8();
    return lo | ((uint32_t)u8() << 8);
  }
  // ITF8: 1-5 bytes, leading-ones prefix; value reinterpreted as int32
  int32_t itf8() {
    uint32_t b0 = u8();
    if (b0 < 0x80) return (int32_t)b0;
    if (b0 < 0xc0) return (int32_t)((((b0 << 8) | u8()) & 0x3fff));
    if (b0 < 0xe0) {
      uint32_t v = (b0 << 16) | ((uint32_t)u8() << 8);
      v |= u8();
      return (int32_t)(v & 0x1fffff);
    }
    if (b0 < 0xf0) {
      uint32_t v = (b0 << 24) | ((uint32_t)u8() << 16);
      v |= (uint32_t)u8() << 8;
      v |= u8();
      return (int32_t)(v & 0x0fffffff);
    }
    uint32_t v = (b0 & 0x0f) << 28;
    v |= (uint32_t)u8() << 20;
    v |= (uint32_t)u8() << 12;
    v |= (uint32_t)u8() << 4;
    v |= u8() & 0x0f;
    return (int32_t)v;
  }
  // LTF8: 1-9 bytes
  int64_t ltf8() {
    uint64_t b0 = u8();
    if (b0 < 0x80) return (int64_t)b0;
    int extra;
    uint64_t v;
    if (b0 < 0xc0) { extra = 1; v = b0 & 0x3f; }
    else if (b0 < 0xe0) { extra = 2; v = b0 & 0x1f; }
    else if (b0 < 0xf0) { extra = 3; v = b0 & 0x0f; }
    else if (b0 < 0xf8) { extra = 4; v = b0 & 0x07; }
    else if (b0 < 0xfc) { extra = 5; v = b0 & 0x03; }
    else if (b0 < 0xfe) { extra = 6; v = b0 & 0x01; }
    else if (b0 == 0xfe) { extra = 7; v = 0; }
    else { extra = 8; v = 0; }
    for (int i = 0; i < extra; i++) v = (v << 8) | u8();
    return (int64_t)v;
  }
};

// --------------------------------------------------------------- rANS 4x8
//
// CRAM 3.0 §13 rANS codec: 4 interleaved 32-bit byte-renormalised states,
// 12-bit normalised frequencies. Stream layout: order byte, u32 compressed
// size, u32 uncompressed size, frequency table, data.

constexpr uint32_t RANS_LOW = 1u << 23;
constexpr int TF_SHIFT = 12;
constexpr uint32_t TF_MASK = (1u << TF_SHIFT) - 1;

// shared RLE frequency-table reader; returns false on malformed input
static bool rans_read_freqs(Buf& b, uint32_t F[256], uint32_t C[256]) {
  memset(F, 0, 256 * sizeof(uint32_t));
  int rle = 0;
  int j = b.u8();
  do {
    uint32_t f = b.u8();
    if (f >= 128) f = ((f & 127) << 8) | b.u8();
    F[j] = f;
    if (rle > 0) {
      rle--;
      j++;
    } else {
      if (b.p < b.e && *b.p == j + 1) {
        j = b.u8();
        rle = b.u8();
      } else {
        j = b.u8();
      }
    }
    if (b.fail || j > 255) return false;
  } while (j != 0);
  uint32_t x = 0;
  for (int s = 0; s < 256; s++) {
    C[s] = x;
    x += F[s];
  }
  return x <= (1u << TF_SHIFT);
}

static bool rans_decode_o0(Buf b, uint8_t* out, uint32_t out_sz) {
  uint32_t F[256], C[256];
  if (!rans_read_freqs(b, F, C)) return false;
  // reverse lookup
  std::vector<uint8_t> ssym(1u << TF_SHIFT);
  for (int s = 0; s < 256; s++)
    for (uint32_t m = C[s]; m < C[s] + F[s]; m++) ssym[m] = (uint8_t)s;
  uint32_t R[4];
  for (int k = 0; k < 4; k++) R[k] = b.u32le();
  if (b.fail) return false;
  auto step = [&](int k) -> uint8_t {
    uint32_t m = R[k] & TF_MASK;
    uint8_t s = ssym[m];
    R[k] = F[s] * (R[k] >> TF_SHIFT) + m - C[s];
    while (R[k] < RANS_LOW) {
      if (b.p >= b.e) { b.fail = true; break; }
      R[k] = (R[k] << 8) | *b.p++;
    }
    return s;
  };
  uint32_t out_end = out_sz & ~3u;
  for (uint32_t i = 0; i < out_end; i += 4)
    for (int k = 0; k < 4; k++) out[i + k] = step(k);
  // remainder bytes come from states 1..3 (encoder pushes them there first)
  for (uint32_t r = 0; r < (out_sz & 3); r++) out[out_end + r] = step(1 + r);
  return !b.fail;
}

static bool rans_decode_o1(Buf b, uint8_t* out, uint32_t out_sz) {
  // context-conditioned tables, outer RLE over contexts
  static thread_local std::vector<uint32_t> Fv, Cv;
  static thread_local std::vector<uint8_t> ssym;
  Fv.assign(256 * 256, 0);
  Cv.assign(256 * 256, 0);
  ssym.assign(256u << TF_SHIFT, 0);
  int rle_i = 0;
  int i = b.u8();
  do {
    uint32_t* F = &Fv[i * 256];
    uint32_t* C = &Cv[i * 256];
    if (!rans_read_freqs(b, F, C)) return false;
    uint8_t* sy = &ssym[(size_t)i << TF_SHIFT];
    for (int s = 0; s < 256; s++)
      for (uint32_t m = C[s]; m < C[s] + F[s]; m++) sy[m] = (uint8_t)s;
    if (rle_i > 0) {
      rle_i--;
      i++;
    } else {
      if (b.p < b.e && *b.p == i + 1) {
        i = b.u8();
        rle_i = b.u8();
      } else {
        i = b.u8();
      }
    }
    if (b.fail || i > 255) return false;
  } while (i != 0);
  uint32_t R[4];
  for (int k = 0; k < 4; k++) R[k] = b.u32le();
  if (b.fail) return false;
  int ctx[4] = {0, 0, 0, 0};
  auto step = [&](int k) -> uint8_t {
    const uint32_t* F = &Fv[ctx[k] * 256];
    const uint32_t* C = &Cv[ctx[k] * 256];
    uint32_t m = R[k] & TF_MASK;
    uint8_t s = ssym[((size_t)ctx[k] << TF_SHIFT) + m];
    R[k] = F[s] * (R[k] >> TF_SHIFT) + m - C[s];
    while (R[k] < RANS_LOW) {
      if (b.p >= b.e) { b.fail = true; break; }
      R[k] = (R[k] << 8) | *b.p++;
    }
    ctx[k] = s;
    return s;
  };
  uint32_t isz4 = out_sz >> 2;
  for (uint32_t j = 0; j < isz4; j++)
    for (int k = 0; k < 4; k++) out[k * isz4 + j] = step(k);
  // remainder carried by stream 3 continuing its context
  for (uint32_t j = 4 * isz4; j < out_sz; j++) out[j] = step(3);
  return !b.fail;
}

static bool rans_decode(const uint8_t* in, size_t in_sz,
                        std::vector<uint8_t>* out) {
  Buf b(in, in_sz);
  int order = b.u8();
  uint32_t csz = b.u32le();
  uint32_t usz = b.u32le();
  (void)csz;
  if (b.fail || usz > (1u << 28)) return false;
  out->resize(usz);
  if (usz == 0) return true;
  if (order == 0) return rans_decode_o0(b, out->data(), usz);
  if (order == 1) return rans_decode_o1(b, out->data(), usz);
  return false;
}

// -------------------------------------------------------------- rANS Nx16
// CRAM 3.1 rANSNx16 codec (block method 5): 16-bit-renormalised rANS with 4-
// or 32-way interleave plus the bit-pack / RLE / stripe / cat transforms, as
// specified by the CRAM 3.1 codecs document (htscodecs rans_nx16 layout).
// The reference tool only ever *writes* CRAM 3.0 via htslib, but 3.1 files
// are valid inputs to it, so the native reader accepts them too.

constexpr uint32_t NX16_LOW = 1u << 15;

enum Nx16Flags {
  NX16_ORDER1 = 1,
  NX16_X32 = 4,
  NX16_STRIPE = 8,
  NX16_NOSZ = 16,
  NX16_CAT = 32,
  NX16_RLE = 64,
  NX16_PACK = 128,
};

static uint32_t uint7(Buf& b) {
  uint32_t v = 0;
  for (int i = 0; i < 5; i++) {
    uint8_t c = b.u8();
    v = (v << 7) | (c & 0x7f);
    if (!(c & 0x80)) break;
  }
  return v;
}

// Sorted-ascending symbol list with consecutive-run compression, terminated
// by a 0 symbol (which can only legitimately appear first).
static bool nx16_alphabet(Buf& b, int* A, int* nA) {
  bool seen[256] = {false};
  int rle = 0;
  int sym = b.u8();
  int last = sym;
  do {
    if (sym > 255) return false;
    seen[sym] = true;
    if (rle > 0) {
      rle--;
      sym++;
    } else {
      sym = b.u8();
      if (sym == last + 1) rle = b.u8();
    }
    last = sym;
  } while (sym != 0 && !b.fail);
  if (b.fail) return false;
  *nA = 0;
  for (int s = 0; s < 256; s++)
    if (seen[s]) A[(*nA)++] = s;
  return true;
}

struct Nx16Tab {
  uint32_t F[256];
  uint32_t C[256];
  uint8_t lookup[1 << 12];  // slot -> symbol; only the first 1<<shift used
};

// Shift-normalise stored frequencies up to exactly 1<<shift and build the
// cumulative + slot-lookup tables. Stored sums are always a power-of-two
// fraction of the table size (the encoder normalises to a power of two).
static bool nx16_build_tab(const uint32_t* F, int shift, Nx16Tab* t) {
  uint64_t tot = 0;
  for (int s = 0; s < 256; s++) tot += F[s];
  if (tot == 0 || tot > (1u << shift)) return false;
  int sh = 0;
  while ((tot << sh) < (1u << shift)) sh++;
  if ((tot << sh) != (1u << shift)) return false;
  uint32_t c = 0;
  for (int s = 0; s < 256; s++) {
    t->F[s] = F[s] << sh;
    t->C[s] = c;
    c += t->F[s];
  }
  for (int s = 0; s < 256; s++)
    for (uint32_t i = 0; i < t->F[s]; i++) t->lookup[t->C[s] + i] = (uint8_t)s;
  return true;
}

static bool nx16_o0_bare(Buf& b, uint32_t len, int N, uint8_t* out) {
  int A[256], nA;
  if (!nx16_alphabet(b, A, &nA)) return false;
  uint32_t F[256] = {0};
  for (int i = 0; i < nA; i++) F[A[i]] = uint7(b);
  if (b.fail) return false;
  auto t = std::make_unique<Nx16Tab>();
  if (!nx16_build_tab(F, 12, t.get())) return false;
  uint32_t R[32];
  for (int j = 0; j < N; j++) R[j] = b.u32le();
  if (b.fail) return false;
  for (uint32_t i = 0; i < len; i++) {
    uint32_t& x = R[i % N];
    uint32_t m = x & 0xfff;
    uint8_t s = t->lookup[m];
    out[i] = s;
    x = t->F[s] * (x >> 12) + m - t->C[s];
    if (x < NX16_LOW) x = (x << 16) | b.u16le();
  }
  return !b.fail;
}

// Order-1: context = previous byte; the output is split into N contiguous
// fragments of len/N bytes (state j decodes fragment j from context 0), and
// state N-1 then continues through the len%N tail.
static bool nx16_o1_bare(Buf& b, uint32_t len, int N, uint8_t* out) {
  int comp = b.u8();
  int shift = comp >> 4;
  if (b.fail || shift < 1 || shift > 12) return false;
  std::vector<uint8_t> ftab;
  Buf fb;
  if (comp & 1) {  // frequency table itself rANS-compressed (order-0, 4-way)
    uint32_t usz = uint7(b);
    uint32_t csz = uint7(b);
    if (b.fail || usz > (1u << 24) || b.left() < csz) return false;
    Buf cb(b.p, csz);
    b.p += csz;
    ftab.resize(usz);
    if (usz == 0 || !nx16_o0_bare(cb, usz, 4, ftab.data())) return false;
    fb = Buf(ftab.data(), ftab.size());
  }
  Buf& f = (comp & 1) ? fb : b;
  int A[256], nA;
  if (!nx16_alphabet(f, A, &nA)) return false;
  std::vector<std::unique_ptr<Nx16Tab>> tabs(256);
  for (int ii = 0; ii < nA; ii++) {
    uint32_t F[256] = {0};
    uint32_t run = 0;
    for (int jj = 0; jj < nA; jj++) {
      if (run > 0) {
        run--;
        continue;
      }
      F[A[jj]] = uint7(f);
      if (F[A[jj]] == 0) run = f.u8();
    }
    if (f.fail) return false;
    uint64_t tot = 0;
    for (int s = 0; s < 256; s++) tot += F[s];
    if (tot == 0) continue;  // in the alphabet but never used as context
    tabs[A[ii]] = std::make_unique<Nx16Tab>();
    if (!nx16_build_tab(F, shift, tabs[A[ii]].get())) return false;
  }
  uint32_t R[32];
  for (int j = 0; j < N; j++) R[j] = b.u32le();
  if (b.fail) return false;
  uint32_t mask = (1u << shift) - 1;
  uint32_t L = len / N;
  uint32_t pos[32];
  uint8_t last[32];
  for (int j = 0; j < N; j++) {
    pos[j] = (uint32_t)j * L;
    last[j] = 0;
  }
  for (uint32_t i = 0; i < L; i++) {
    for (int j = 0; j < N; j++) {
      const Nx16Tab* t = tabs[last[j]].get();
      if (!t) return false;
      uint32_t& x = R[j];
      uint32_t m = x & mask;
      uint8_t s = t->lookup[m];
      out[pos[j]++] = s;
      x = t->F[s] * (x >> shift) + m - t->C[s];
      if (x < NX16_LOW) x = (x << 16) | b.u16le();
      last[j] = s;
    }
  }
  for (uint32_t i = (uint32_t)N * L; i < len; i++) {
    const Nx16Tab* t = tabs[last[N - 1]].get();
    if (!t) return false;
    uint32_t& x = R[N - 1];
    uint32_t m = x & mask;
    uint8_t s = t->lookup[m];
    out[i] = s;
    x = t->F[s] * (x >> shift) + m - t->C[s];
    if (x < NX16_LOW) x = (x << 16) | b.u16le();
    last[N - 1] = s;
  }
  return !b.fail;
}

static bool nx16_decode_buf(Buf& b, uint32_t len, std::vector<uint8_t>* out,
                            int depth);

// Byte-interleave transform: stream j holds output positions j, j+X, j+2X...
// with each sub-stream independently rANSNx16-compressed.
static bool nx16_stripe(Buf& b, uint32_t len, std::vector<uint8_t>* out,
                        int depth) {
  int X = b.u8();
  if (b.fail || X <= 0) return false;
  std::vector<uint32_t> clen(X);
  for (int j = 0; j < X; j++) clen[j] = uint7(b);
  if (b.fail) return false;
  out->assign(len, 0);
  for (int j = 0; j < X; j++) {
    uint32_t ulen = len / X + (len % X > (uint32_t)j ? 1 : 0);
    if (b.left() < clen[j]) return false;
    Buf sb(b.p, clen[j]);
    b.p += clen[j];
    std::vector<uint8_t> t;
    if (!nx16_decode_buf(sb, ulen, &t, depth + 1)) return false;
    if (t.size() != ulen) return false;
    for (uint32_t i = 0; i < ulen; i++) (*out)[(uint64_t)i * X + j] = t[i];
  }
  return true;
}

static bool nx16_decode_buf(Buf& b, uint32_t len, std::vector<uint8_t>* out,
                            int depth) {
  if (depth > 3) return false;
  int flags = b.u8();
  if (b.fail) return false;
  if (!(flags & NX16_NOSZ)) len = uint7(b);
  if (b.fail || len > (1u << 28)) return false;
  int N = (flags & NX16_X32) ? 32 : 4;
  if (flags & NX16_STRIPE) return nx16_stripe(b, len, out, depth);

  // PACK meta: up to 16 symbols, packed 8/4/2 values per byte.
  uint32_t unpack_len = len;
  int nsym = -1;
  uint8_t P[16] = {0};
  if (flags & NX16_PACK) {
    nsym = b.u8();
    if (b.fail || nsym > 16) return false;
    for (int i = 0; i < nsym; i++) P[i] = b.u8();
    len = uint7(b);
    if (b.fail || len > (1u << 28)) return false;
  }
  // RLE meta: which symbols carry runs + a uint7 run-length stream (itself
  // optionally order-0 compressed).
  uint32_t rle_len = 0;
  std::vector<uint8_t> rle_meta_store;
  Buf rm;
  bool do_rle = (flags & NX16_RLE) != 0;
  if (do_rle) {
    uint32_t m = uint7(b);
    rle_len = len;
    len = uint7(b);
    uint32_t meta_sz = m >> 1;
    if (b.fail || meta_sz > (1u << 24) || len > (1u << 28)) return false;
    if (m & 1) {  // raw metadata
      if (b.left() < meta_sz) return false;
      rm = Buf(b.p, meta_sz);
      b.p += meta_sz;
    } else {  // order-0 compressed metadata
      uint32_t csz = uint7(b);
      if (b.fail || b.left() < csz) return false;
      Buf cb(b.p, csz);
      b.p += csz;
      rle_meta_store.resize(meta_sz);
      if (meta_sz == 0 || !nx16_o0_bare(cb, meta_sz, 4, rle_meta_store.data()))
        return false;
      rm = Buf(rle_meta_store.data(), meta_sz);
    }
  }
  std::vector<uint8_t> lit(len);
  if (flags & NX16_CAT) {
    if (!b.raw(lit.data(), len)) return false;
  } else if (len > 0) {
    bool ok = (flags & NX16_ORDER1) ? nx16_o1_bare(b, len, N, lit.data())
                                    : nx16_o0_bare(b, len, N, lit.data());
    if (!ok) return false;
  }
  if (do_rle) {
    std::vector<uint8_t> ex;
    ex.reserve(rle_len);
    bool has_run[256] = {false};
    int n = rm.u8();
    if (n == 0) n = 256;
    for (int i = 0; i < n; i++) has_run[rm.u8()] = true;
    if (rm.fail) return false;
    for (uint32_t i = 0; i < len; i++) {
      uint8_t s = lit[i];
      if (ex.size() >= rle_len) return false;
      ex.push_back(s);
      if (has_run[s]) {
        uint32_t run = uint7(rm);
        if (rm.fail || ex.size() + run > rle_len) return false;
        ex.insert(ex.end(), run, s);
      }
    }
    if (ex.size() != rle_len) return false;
    lit.swap(ex);
    len = rle_len;
  }
  if (flags & NX16_PACK) {
    std::vector<uint8_t> up(unpack_len);
    if (nsym <= 0 && unpack_len > 0) return false;
    if (nsym <= 1) {
      for (uint32_t i = 0; i < unpack_len; i++) up[i] = P[0];
    } else {
      int bits = nsym <= 2 ? 1 : nsym <= 4 ? 2 : 4;
      int per = 8 / bits;
      uint32_t msk = (1u << bits) - 1;
      if ((uint64_t)len * per < unpack_len) return false;
      for (uint32_t i = 0; i < unpack_len; i++) {
        uint32_t v = lit[i / per] >> (bits * (i % per));
        up[i] = P[v & msk];
      }
    }
    lit.swap(up);
  }
  out->swap(lit);
  return true;
}

static bool rans_nx16_decode(const uint8_t* in, size_t in_sz, uint32_t usize,
                             std::vector<uint8_t>* out) {
  Buf b(in, in_sz);
  return nx16_decode_buf(b, usize, out, 0);
}

// ------------------------------------------------- adaptive range coder (3.1)
//
// CRAM 3.1 adaptive arithmetic codec (block method 6) and the fqzcomp
// quality codec (method 7) share one carry-aware range decoder and one
// adaptive frequency model, per the CRAM 3.1 codecs document: 32-bit range,
// 2^24 renormalisation, 5 prefetched bytes (the encoder's first byte is a
// cache dummy), and a move-up-one adaptive model with +16 increments
// renormalised at 2^16-16. The matching encoder lives in io/cramwrite.py;
// round-trip tests pin both sides (no external htscodecs tooling exists in
// this environment to cross-validate, as docs/parity.md notes).

struct RangeDec {
  Buf* b;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;

  explicit RangeDec(Buf* buf) : b(buf) {
    for (int i = 0; i < 5; i++) code = (code << 8) | b->u8();
  }
  uint32_t get_freq(uint32_t tot) {
    range /= tot;
    return code / range;
  }
  void advance(uint32_t cum, uint32_t freq) {
    code -= cum * range;
    range *= freq;
    while (range < (1u << 24)) {
      code = (code << 8) | b->u8();
      range <<= 8;
    }
  }
};

constexpr uint32_t AMODEL_STEP = 16;
constexpr uint32_t AMODEL_MAX = (1u << 16) - AMODEL_STEP;

struct AModel {
  std::vector<uint16_t> freq;
  std::vector<uint8_t> sym;  // slot -> symbol (slots bubble toward the front)
  uint32_t total = 0;
  int nsym = 0;

  void init(int n) {
    nsym = n;
    freq.assign(n, 1);
    sym.resize(n);
    for (int i = 0; i < n; i++) sym[i] = (uint8_t)i;
    total = (uint32_t)n;
  }
  int decode(RangeDec& rc) {
    uint32_t f = rc.get_freq(total);
    if (f >= total) return -1;  // corrupt stream
    uint32_t acc = 0;
    int x = 0;
    while (acc + freq[x] <= f) acc += freq[x++];
    rc.advance(acc, freq[x]);
    int s = sym[x];
    freq[x] += AMODEL_STEP;
    total += AMODEL_STEP;
    if (x > 0 && freq[x] > freq[x - 1]) {
      std::swap(freq[x], freq[x - 1]);
      std::swap(sym[x], sym[x - 1]);
    }
    if (total > AMODEL_MAX) {
      total = 0;
      for (int i = 0; i < nsym; i++) {
        freq[i] -= freq[i] >> 1;
        total += freq[i];
      }
    }
    return s;
  }
};

// Run lengths: first chunk from a per-literal model, 255-continuations from a
// shared model; run = sum of chunks while chunk == 255.
static int64_t arith_run(RangeDec& rc, AModel& first, AModel& cont) {
  int v = first.decode(rc);
  if (v < 0) return -1;
  int64_t run = v;
  while (v == 255) {
    v = cont.decode(rc);
    if (v < 0) return -1;
    run += v;
  }
  return run;
}

static bool arith_decode_buf(Buf& b, uint32_t len, std::vector<uint8_t>* out,
                             int depth);

static bool arith_stripe(Buf& b, uint32_t len, std::vector<uint8_t>* out,
                         int depth) {
  int X = b.u8();
  if (b.fail || X <= 0) return false;
  std::vector<uint32_t> clen(X);
  for (int j = 0; j < X; j++) clen[j] = uint7(b);
  if (b.fail) return false;
  out->assign(len, 0);
  for (int j = 0; j < X; j++) {
    uint32_t ulen = len / X + (len % X > (uint32_t)j ? 1 : 0);
    if (b.left() < clen[j]) return false;
    Buf sb(b.p, clen[j]);
    b.p += clen[j];
    std::vector<uint8_t> t;
    if (!arith_decode_buf(sb, ulen, &t, depth + 1)) return false;
    if (t.size() != ulen) return false;
    for (uint32_t i = 0; i < ulen; i++) (*out)[(uint64_t)i * X + j] = t[i];
  }
  return true;
}

// Method-6 container: same flag byte layout as rANSNx16 (bit 2 selects the
// "external" sub-codec instead of 32-way interleave, which has no meaning
// here); PACK metadata shared with nx16.
static bool arith_decode_buf(Buf& b, uint32_t len, std::vector<uint8_t>* out,
                             int depth) {
  if (depth > 3) return false;
  int flags = b.u8();
  if (b.fail) return false;
  if (!(flags & NX16_NOSZ)) len = uint7(b);
  if (b.fail || len > (1u << 28)) return false;
  if (flags & NX16_STRIPE) return arith_stripe(b, len, out, depth);
  if (flags & NX16_X32) return false;  // "external" (bzip2/lzma) sub-codec

  uint32_t unpack_len = len;
  int nsym = -1;
  uint8_t P[16] = {0};
  if (flags & NX16_PACK) {
    nsym = b.u8();
    if (b.fail || nsym > 16) return false;
    for (int i = 0; i < nsym; i++) P[i] = b.u8();
    len = uint7(b);
    if (b.fail || len > (1u << 28)) return false;
  }
  std::vector<uint8_t> lit(len);
  if (flags & NX16_CAT) {
    if (!b.raw(lit.data(), len)) return false;
  } else if (len > 0) {
    int max_sym = b.u8();
    if (b.fail) return false;
    if (max_sym == 0) max_sym = 256;
    RangeDec rc(&b);
    bool order1 = (flags & NX16_ORDER1) != 0;
    std::vector<AModel> lits(order1 ? 256 : 1);
    for (auto& m : lits) m.init(max_sym);
    if (flags & NX16_RLE) {
      std::vector<AModel> runs(256);
      for (auto& m : runs) m.init(256);
      AModel cont;
      cont.init(256);
      uint32_t i = 0;
      int last = 0;
      while (i < len) {
        int s = lits[order1 ? last : 0].decode(rc);
        if (s < 0 || s >= max_sym) return false;
        int64_t run = arith_run(rc, runs[s], cont);
        if (run < 0 || i + 1 + run > len) return false;
        for (int64_t r = 0; r <= run; r++) lit[i++] = (uint8_t)s;
        last = s;
      }
    } else {
      int last = 0;
      for (uint32_t i = 0; i < len; i++) {
        int s = lits[order1 ? last : 0].decode(rc);
        if (s < 0 || s >= max_sym) return false;
        lit[i] = (uint8_t)s;
        last = s;
      }
    }
    if (b.fail) return false;
  }
  if (flags & NX16_PACK) {
    std::vector<uint8_t> up(unpack_len);
    if (nsym <= 0 && unpack_len > 0) return false;
    if (nsym <= 1) {
      for (uint32_t i = 0; i < unpack_len; i++) up[i] = P[0];
    } else {
      int bits = nsym <= 2 ? 1 : nsym <= 4 ? 2 : 4;
      int per = 8 / bits;
      uint32_t msk = (1u << bits) - 1;
      if ((uint64_t)len * per < unpack_len) return false;
      for (uint32_t i = 0; i < unpack_len; i++) {
        uint32_t v = lit[i / per] >> (bits * (i % per));
        up[i] = P[v & msk];
      }
    }
    lit.swap(up);
  }
  out->swap(lit);
  return true;
}

static bool arith_decode(const uint8_t* in, size_t in_sz, uint32_t usize,
                         std::vector<uint8_t>* out) {
  Buf b(in, in_sz);
  return arith_decode_buf(b, usize, out, 0);
}

// ----------------------------------------------------------- fqzcomp (3.1)
//
// Quality-string codec (block method 7): one adaptive model per 16-bit
// context, where the context mixes recent quality history (qbits/qshift via
// qtab), position in the read (ptab), a running delta count (dtab) and
// optionally the per-record selector (sloc), each placed at a configurable
// bit offset. Supports every gflags stream shape: multi-parameter,
// selector table, and reversed-quality records; read lengths ride in-band
// through four length models, matching the CRAM 3.1 layout where the qual
// block is self-delimiting per record.

struct FqzParam {
  uint32_t context = 0;
  int pflags = 0;
  int max_sym = 0;
  int qbits = 0, qshift = 0, qloc = 0, sloc = 0, ploc = 0, dloc = 0;
  uint8_t qmap[256];
  uint8_t qtab[256];
  uint8_t ptab[1024];
  uint8_t dtab[256];
};

enum FqzPFlags {
  FQZ_DO_DEDUP = 2,
  FQZ_DO_LEN = 4,
  FQZ_DO_SEL = 8,
  FQZ_HAVE_QMAP = 16,
  FQZ_HAVE_PTAB = 32,
  FQZ_HAVE_DTAB = 64,
  FQZ_HAVE_QTAB = 128,
};

enum FqzGFlags {
  FQZ_GFLAG_MULTI_PARAM = 1,
  FQZ_GFLAG_HAVE_STAB = 2,
  FQZ_GFLAG_DO_REV = 4,
};

// htscodecs read_array: tables (qtab/ptab/dtab/stab) are stored as run
// lengths per ascending value (255-continuation bytes, with a trailing 0
// for exact multiples), and that byte stream is itself RLE'd — a byte
// equal to its predecessor is followed by a count of additional copies.
// Reconstructed from the htscodecs store_array/read_array pair; the
// encoder in io/cramwrite.py mirrors it exactly (round-trip tested).
static bool fqz_read_array(Buf& b, uint8_t* arr, int size) {
  int i = 0, v = 0;
  int prev = -1, pending = 0;
  auto next_rb = [&](int* out) -> bool {
    if (pending > 0) {
      pending--;
      *out = prev;
      return true;
    }
    int x = b.u8();
    if (b.fail) return false;
    if (x == prev) {
      pending = b.u8();
      if (b.fail) return false;
    }
    prev = x;
    *out = x;
    return true;
  };
  while (i < size) {
    int run = 0, rb;
    do {
      if (!next_rb(&rb)) return false;
      run += rb;
    } while (rb == 255);
    if (run > size - i) return false;
    for (int r = 0; r < run; r++) arr[i++] = (uint8_t)v;
    v++;
    if (v > 256 && i < size) return false;  // runaway guard
  }
  return true;
}

static bool fqz_read_param(Buf& b, FqzParam* p, std::string* err) {
  p->context = b.u16le();
  p->pflags = b.u8();
  p->max_sym = b.u8();
  if (p->max_sym == 0) p->max_sym = 256;
  int x = b.u8();
  p->qbits = x >> 4;
  p->qshift = x & 15;
  x = b.u8();
  p->qloc = x >> 4;
  p->sloc = x & 15;
  x = b.u8();
  p->ploc = x >> 4;
  p->dloc = x & 15;
  for (int i = 0; i < 256; i++) {
    p->qmap[i] = (uint8_t)i;
    p->qtab[i] = (uint8_t)i;
    p->dtab[i] = 0;
  }
  memset(p->ptab, 0, sizeof p->ptab);
  if (p->pflags & FQZ_HAVE_QMAP)
    for (int i = 0; i < p->max_sym; i++) p->qmap[i] = b.u8();
  if (p->pflags & FQZ_HAVE_QTAB)
    if (!fqz_read_array(b, p->qtab, 256)) {
      *err = "fqzcomp: bad qtab";
      return false;
    }
  if (p->pflags & FQZ_HAVE_PTAB)
    if (!fqz_read_array(b, p->ptab, 1024)) {
      *err = "fqzcomp: bad ptab";
      return false;
    }
  if (p->pflags & FQZ_HAVE_DTAB)
    if (!fqz_read_array(b, p->dtab, 256)) {
      *err = "fqzcomp: bad dtab";
      return false;
    }
  if (b.fail) {
    *err = "fqzcomp: truncated parameter block";
    return false;
  }
  return true;
}

// Full CRAM 3.1 fqzcomp stream shapes: single- and multi-parameter
// (gflag 1), selector table (gflag 2, with per-record selector symbols
// optionally mixed into the context via sloc when pflag 8 is set), and
// reversed-quality records (gflag 4: a per-record reverse bit; flagged
// records are reversed after decode). Per-record decode order is
// [selector][length][rev][dup][bases].
static bool fqz_decode(const uint8_t* in, size_t in_sz, uint32_t usize,
                       std::vector<uint8_t>* out, std::string* err) {
  Buf b(in, in_sz);
  int vers = b.u8();
  int gflags = b.u8();
  if (b.fail || vers != 5) {
    *err = "fqzcomp: unsupported version";
    return false;
  }
  if (gflags & ~(FQZ_GFLAG_MULTI_PARAM | FQZ_GFLAG_HAVE_STAB |
                 FQZ_GFLAG_DO_REV)) {
    *err = "fqzcomp: unknown gflags";
    return false;
  }
  int nparam = 1;
  if (gflags & FQZ_GFLAG_MULTI_PARAM) nparam = b.u8();
  if (b.fail || nparam < 1) {
    *err = "fqzcomp: bad parameter count";
    return false;
  }
  int max_sel = nparam > 1 ? nparam - 1 : 0;
  uint8_t stab[256];
  for (int i = 0; i < 256; i++)
    stab[i] = (uint8_t)(i < nparam ? i : nparam - 1);
  if (gflags & FQZ_GFLAG_HAVE_STAB) {
    max_sel = b.u8();
    if (b.fail || !fqz_read_array(b, stab, 256)) {
      *err = "fqzcomp: bad selector table";
      return false;
    }
  }
  const bool do_rev = (gflags & FQZ_GFLAG_DO_REV) != 0;
  std::vector<FqzParam> ps(nparam);
  int gmax_sym = 0;
  for (int i = 0; i < nparam; i++) {
    if (!fqz_read_param(b, &ps[i], err)) return false;
    gmax_sym = std::max(gmax_sym, ps[i].max_sym);
  }

  RangeDec rc(&b);
  // context models are GLOBAL across params (the context value carries the
  // param-specific mixing); lazily initialized — see the single-param note
  std::vector<AModel> qual(1 << 16);
  AModel lens[4];
  for (auto& m : lens) m.init(256);
  AModel dup, sel, rev;
  dup.init(2);
  sel.init(256);
  rev.init(2);

  out->clear();
  out->reserve(usize);
  uint32_t rec_len = 0;
  bool first = true;
  size_t prev_start = 0;
  std::vector<std::pair<size_t, uint32_t>> rev_recs;
  while (out->size() < usize) {
    int s = 0;
    if (max_sel) {
      s = sel.decode(rc);
      if (s < 0) {
        *err = "fqzcomp: corrupt selector";
        return false;
      }
    }
    const FqzParam& p = ps[stab[s & 0xff]];
    if (first || (p.pflags & FQZ_DO_LEN)) {
      uint32_t l = 0;
      for (int i = 0; i < 4; i++) {
        int v = lens[i].decode(rc);
        if (v < 0) {
          *err = "fqzcomp: corrupt length";
          return false;
        }
        l |= (uint32_t)v << (8 * i);
      }
      rec_len = l;
    }
    first = false;
    if (rec_len == 0 || out->size() + rec_len > usize) {
      *err = "fqzcomp: record length overruns block";
      return false;
    }
    bool rec_rev = false;
    if (do_rev) {
      int rv = rev.decode(rc);
      if (rv < 0) {
        *err = "fqzcomp: corrupt reverse flag";
        return false;
      }
      rec_rev = rv != 0;
    }
    size_t start = out->size();
    if (p.pflags & FQZ_DO_DEDUP) {
      int d = dup.decode(rc);
      if (d < 0) {
        *err = "fqzcomp: corrupt dup flag";
        return false;
      }
      if (d == 1) {
        if (start == 0 || start - prev_start != rec_len) {
          *err = "fqzcomp: dup without matching previous record";
          return false;
        }
        out->insert(out->end(), out->begin() + prev_start,
                    out->begin() + start);
        prev_start = start;
        if (rec_rev) rev_recs.emplace_back(start, rec_len);
        continue;
      }
    }
    uint32_t ctx = p.context;
    uint32_t qctx = 0;
    int q1 = 0, delta = 0;
    for (uint32_t i = 0; i < rec_len; i++) {
      AModel& qm = qual[ctx & 0xffff];
      if (qm.nsym == 0) qm.init(gmax_sym);
      int q = qm.decode(rc);
      if (q < 0) {
        *err = "fqzcomp: corrupt quality stream";
        return false;
      }
      out->push_back(p.qmap[q]);
      qctx = (qctx << p.qshift) + p.qtab[q];
      ctx = p.context;
      if (p.qbits)
        ctx += (qctx & ((1u << p.qbits) - 1)) << p.qloc;
      uint32_t pos = rec_len - 1 - i;  // positions count down, as stored
      ctx += (uint32_t)p.ptab[pos < 1024 ? pos : 1023] << p.ploc;
      ctx += (uint32_t)p.dtab[delta < 256 ? delta : 255] << p.dloc;
      if (p.pflags & FQZ_DO_SEL) ctx += (uint32_t)s << p.sloc;
      delta += (q1 != q);
      q1 = q;
    }
    if (rec_rev) rev_recs.emplace_back(start, rec_len);
    prev_start = start;
  }
  if (b.fail) {
    *err = "fqzcomp: truncated stream";
    return false;
  }
  for (auto& rr : rev_recs)
    std::reverse(out->begin() + rr.first, out->begin() + rr.first + rr.second);
  return out->size() == usize;
}

// --------------------------------------------------------- name tokeniser
// CRAM 3.1 name tokeniser ("tok3", block method 8): read names are split
// into per-position token streams (string/char/digit/delta/match/...), each
// stream rANSNx16-compressed (use_arith=0) or arithmetic-coded
// (use_arith=1). htslib compresses the RN series this way by default when
// writing CRAM 3.1, and qnames drive mate pairing in extract (reference
// extract.nim:89-91), so 3.1 inputs need it.

enum TokType {
  TOK_TYPE = 0,
  TOK_STRING = 1,
  TOK_CHAR = 2,
  TOK_DIGITS0 = 3,
  TOK_DZLEN = 4,
  TOK_DUP = 5,
  TOK_DIFF = 6,
  TOK_DIGITS = 7,
  TOK_DELTA = 8,
  TOK_DELTA0 = 9,
  TOK_MATCH = 10,
  TOK_NOP = 11,
  TOK_END = 12,
  TOK_NTYPES = 13,
};

constexpr int TOK_MAX_POS = 1024;  // token positions per name (spec: small)

struct TokToken {  // one decoded token, kept so later names can MATCH/DELTA
  uint8_t type = TOK_END;
  uint32_t val = 0;
  uint8_t len = 0;
  std::string s;
};

static bool tok3_decode(const uint8_t* in, size_t in_sz, uint32_t usize,
                        std::vector<uint8_t>* out) {
  Buf b(in, in_sz);
  uint32_t ulen = b.u32le();
  uint32_t nnames = b.u32le();
  int use_arith = b.u8();
  // each decoded name contributes at least its terminator byte to the
  // output, so nnames > ulen is unsatisfiable — reject before allocating
  // the per-name token table (a ~13-byte corrupt stream could otherwise
  // force a multi-GB upfront allocation)
  if (b.fail || ulen != usize || nnames > (1u << 26) || nnames > ulen)
    return false;
  if (use_arith > 1) return false;

  // token streams: B[t][type] bytes + an independent read cursor each
  std::vector<std::array<std::shared_ptr<std::vector<uint8_t>>, TOK_NTYPES>>
      streams;
  int t = -1;
  while (b.left() > 0) {
    uint8_t ttype = b.u8();
    int type = ttype & 0x3f;
    if (type >= TOK_NTYPES) return false;
    if (ttype & 0x80) t++;
    if (t < 0 || t >= TOK_MAX_POS) return false;
    if ((int)streams.size() <= t) streams.resize(t + 1);
    if (ttype & 0x40) {  // duplicate of an earlier stream
      int dp = b.u8();
      int dt = b.u8();
      if (b.fail || dp > t || dt >= TOK_NTYPES || !streams[dp][dt])
        return false;
      streams[t][type] = streams[dp][dt];
    } else {
      uint32_t clen = uint7(b);
      if (b.fail || b.left() < clen) return false;
      auto data = std::make_shared<std::vector<uint8_t>>();
      bool ok = use_arith ? arith_decode(b.p, clen, 0, data.get())
                          : rans_nx16_decode(b.p, clen, 0, data.get());
      if (!ok) return false;
      b.p += clen;
      streams[t][type] = data;
    }
  }
  std::vector<std::array<Buf, TOK_NTYPES>> cur(streams.size());
  for (size_t i = 0; i < streams.size(); i++)
    for (int k = 0; k < TOK_NTYPES; k++)
      if (streams[i][k]) cur[i][k] = Buf(streams[i][k]->data(),
                                         streams[i][k]->size());
  auto get = [&](int pos, int type) -> Buf* {
    if (pos >= (int)cur.size() || !streams[pos][type]) return nullptr;
    return &cur[pos][type];
  };

  std::vector<std::vector<TokToken>> toks(nnames);
  out->clear();
  out->reserve(ulen);
  char numbuf[16];
  for (uint32_t i = 0; i < nnames; i++) {
    Buf* ty0 = get(0, TOK_TYPE);
    if (!ty0) return false;
    int t0 = ty0->u8();
    if (ty0->fail) return false;
    uint32_t dist = 0;
    if (t0 == TOK_DUP || t0 == TOK_DIFF) {
      Buf* d = get(0, t0);
      if (!d) return false;
      dist = d->u32le();
      if (d->fail || dist > i) return false;
    } else {
      return false;
    }
    uint32_t ref = i - dist;  // name to duplicate / diff against
    if (t0 == TOK_DUP) {
      if (ref == i) return false;
      toks[i] = toks[ref];
      for (const TokToken& tk : toks[i])
        out->insert(out->end(), tk.s.begin(), tk.s.end());
      out->push_back(0);
      continue;
    }
    const std::vector<TokToken>* prev =
        (ref != i) ? &toks[ref] : nullptr;  // dist=0 on the first name
    for (int pos = 1; pos < TOK_MAX_POS; pos++) {
      Buf* ty = get(pos, TOK_TYPE);
      if (!ty) return false;
      int type = ty->u8();
      if (ty->fail) return false;
      TokToken tk;
      tk.type = (uint8_t)type;
      const TokToken* ptk =
          (prev && pos - 1 < (int)prev->size()) ? &(*prev)[pos - 1] : nullptr;
      switch (type) {
        case TOK_CHAR: {
          Buf* s = get(pos, TOK_CHAR);
          if (!s) return false;
          tk.s.push_back((char)s->u8());
          if (s->fail) return false;
          break;
        }
        case TOK_STRING: {
          Buf* s = get(pos, TOK_STRING);
          if (!s) return false;
          for (;;) {
            uint8_t c = s->u8();
            if (s->fail) return false;
            if (c == 0) break;
            tk.s.push_back((char)c);
          }
          break;
        }
        case TOK_DIGITS: {
          Buf* s = get(pos, TOK_DIGITS);
          if (!s) return false;
          tk.val = s->u32le();
          if (s->fail) return false;
          tk.s.assign(numbuf, snprintf(numbuf, sizeof numbuf, "%u", tk.val));
          break;
        }
        case TOK_DIGITS0: {
          Buf* s = get(pos, TOK_DIGITS0);
          Buf* l = get(pos, TOK_DZLEN);
          if (!s || !l) return false;
          tk.val = s->u32le();
          tk.len = l->u8();
          if (s->fail || l->fail || tk.len > 10) return false;
          tk.s.assign(numbuf,
                      snprintf(numbuf, sizeof numbuf, "%0*u", tk.len, tk.val));
          break;
        }
        case TOK_DELTA:
        case TOK_DELTA0: {
          Buf* s = get(pos, type);
          if (!s || !ptk) return false;
          tk.val = ptk->val + s->u8();
          if (s->fail) return false;
          if (type == TOK_DELTA) {
            tk.type = TOK_DIGITS;
            tk.s.assign(numbuf, snprintf(numbuf, sizeof numbuf, "%u", tk.val));
          } else {
            tk.type = TOK_DIGITS0;
            tk.len = ptk->len;
            if (tk.len > 10) return false;
            tk.s.assign(
                numbuf, snprintf(numbuf, sizeof numbuf, "%0*u", tk.len, tk.val));
          }
          break;
        }
        case TOK_MATCH:
          if (!ptk) return false;
          tk = *ptk;
          break;
        case TOK_NOP:
          break;
        case TOK_END:
          break;
        default:
          return false;
      }
      if (type == TOK_END) break;
      if (type != TOK_NOP) {
        toks[i].push_back(std::move(tk));
        const TokToken& back = toks[i].back();
        out->insert(out->end(), back.s.begin(), back.s.end());
      } else {
        toks[i].push_back(std::move(tk));
      }
      if (out->size() > ulen) return false;
    }
    out->push_back(0);
    if (out->size() > ulen) return false;
  }
  return out->size() == ulen;
}

// ------------------------------------------------------------------- codecs

// bzip2 (CRAM block method 2). The environment ships libbz2.so.1.0 without
// its header; the one-shot decompressor has a stable ABI, declared here.
extern "C" int BZ2_bzBuffToBuffDecompress(char* dest, unsigned int* destLen,
                                          char* source,
                                          unsigned int sourceLen, int small,
                                          int verbosity);

static bool bz2_decode(const uint8_t* in, size_t in_sz, size_t out_sz,
                       std::vector<uint8_t>* out) {
  if (out_sz > (1u << 28) || in_sz > (1u << 28)) return false;
  out->resize(out_sz);
  unsigned int dlen = (unsigned int)out_sz;
  int r = BZ2_bzBuffToBuffDecompress(
      (char*)out->data(), &dlen, (char*)const_cast<uint8_t*>(in),
      (unsigned int)in_sz, /*small=*/0, /*verbosity=*/0);
  return r == 0 /*BZ_OK*/ && dlen == out_sz;
}

// lzma (CRAM block method 3): htslib writes .xz container streams
// (lzma_easy_buffer_encode); lzma_stream_buffer_decode reads them.
static bool xz_decode(const uint8_t* in, size_t in_sz, size_t out_sz,
                      std::vector<uint8_t>* out) {
  if (out_sz > (1u << 28)) return false;
  out->resize(out_sz);
  uint64_t memlimit = UINT64_MAX;
  size_t in_pos = 0, out_pos = 0;
  lzma_ret r = lzma_stream_buffer_decode(&memlimit, 0, nullptr, in, &in_pos,
                                         in_sz, out->data(), &out_pos,
                                         out_sz);
  return r == LZMA_OK && out_pos == out_sz;
}

static bool gunzip(const uint8_t* in, size_t in_sz, size_t out_sz,
                   std::vector<uint8_t>* out) {
  out->resize(out_sz);
  libdeflate_decompressor* d = libdeflate_alloc_decompressor();
  size_t actual = 0;
  auto r = libdeflate_gzip_decompress(d, in, in_sz, out->data(), out_sz,
                                      &actual);
  libdeflate_free_decompressor(d);
  return r == LIBDEFLATE_SUCCESS && actual == out_sz;
}

// gunzip with unknown output size (CRAI files)
static bool gunzip_all(const uint8_t* in, size_t in_sz,
                       std::vector<uint8_t>* out) {
  libdeflate_decompressor* d = libdeflate_alloc_decompressor();
  out->clear();
  size_t off = 0;
  std::vector<uint8_t> tmp(1 << 20);
  bool ok = true;
  while (off < in_sz) {
    size_t actual_out = 0, actual_in = 0;
    for (;;) {
      auto r = libdeflate_gzip_decompress_ex(d, in + off, in_sz - off,
                                             tmp.data(), tmp.size(),
                                             &actual_in, &actual_out);
      if (r == LIBDEFLATE_SUCCESS) break;
      if (r == LIBDEFLATE_INSUFFICIENT_SPACE && tmp.size() < (1u << 28)) {
        tmp.resize(tmp.size() * 2);
        continue;
      }
      ok = false;
      break;
    }
    if (!ok) break;
    out->insert(out->end(), tmp.begin(), tmp.begin() + actual_out);
    off += actual_in;
  }
  libdeflate_free_decompressor(d);
  return ok;
}

// ------------------------------------------------------------------- blocks

enum BlockType {
  BT_FILE_HEADER = 0,
  BT_COMP_HEADER = 1,
  BT_SLICE_HEADER = 2,
  BT_EXTERNAL = 4,
  BT_CORE = 5,
};

struct Block {
  int method = 0;
  int ctype = 0;
  int content_id = 0;
  bool skipped = false;  // payload not decompressed (required-fields skip)
  std::vector<uint8_t> data;
};

// used_ids != nullptr enables the required-fields skip: an EXTERNAL block
// whose content id no needed data series reads (and which is not the
// embedded reference) is not decompressed at all — the equivalent of
// htslib's CRAM_OPT_REQUIRED_FIELDS (reference extract.nim:278,291 skips
// QUAL/AUX everywhere). Quality + tag blocks are typically most of a CRAM's
// bytes.
static bool read_block(Buf& b, Block* blk, std::string* err,
                       const std::set<int>* used_ids = nullptr,
                       int embedded_ref_id = INT_MIN) {
  blk->method = b.u8();
  blk->ctype = b.u8();
  blk->content_id = b.itf8();
  int32_t csize = b.itf8();
  int32_t usize = b.itf8();
  if (b.fail || csize < 0 || usize < 0 || usize > (1 << 28) ||
      b.left() < (size_t)csize) {
    *err = "truncated CRAM block";
    return false;
  }
  const uint8_t* cdata = b.p;
  b.p += csize;
  b.u32le();  // CRC32 trailer (computed over header+data; not verified)
  if (used_ids && blk->ctype == BT_EXTERNAL &&
      blk->content_id != embedded_ref_id &&
      used_ids->find(blk->content_id) == used_ids->end()) {
    blk->skipped = true;
    blk->data.clear();
    return true;
  }
  switch (blk->method) {
    case 0:  // raw
      blk->data.assign(cdata, cdata + csize);
      break;
    case 1:  // gzip
      if (!gunzip(cdata, csize, usize, &blk->data)) {
        *err = "CRAM gzip block decode failed";
        return false;
      }
      break;
    case 4:  // rANS 4x8
      if (!rans_decode(cdata, csize, &blk->data)) {
        *err = "CRAM rANS block decode failed";
        return false;
      }
      break;
    case 5:  // rANS Nx16 (CRAM 3.1)
      if (!rans_nx16_decode(cdata, csize, usize, &blk->data)) {
        *err = "CRAM rANSNx16 block decode failed";
        return false;
      }
      break;
    case 6:  // adaptive arithmetic (CRAM 3.1)
      if (!arith_decode(cdata, csize, usize, &blk->data)) {
        *err = "CRAM arith block decode failed";
        return false;
      }
      break;
    case 7:  // fqzcomp quality codec (CRAM 3.1)
      if (!fqz_decode(cdata, csize, usize, &blk->data, err)) {
        if (err->empty()) *err = "CRAM fqzcomp block decode failed";
        return false;
      }
      break;
    case 8:  // name tokeniser (CRAM 3.1)
      if (!tok3_decode(cdata, csize, usize, &blk->data)) {
        *err = "CRAM name-tokeniser block decode failed";
        return false;
      }
      break;
    case 2:  // bzip2
      if (!bz2_decode(cdata, csize, usize, &blk->data)) {
        *err = "CRAM bzip2 block decode failed";
        return false;
      }
      break;
    case 3:  // lzma (.xz container, as htslib writes)
      if (!xz_decode(cdata, csize, usize, &blk->data)) {
        *err = "CRAM lzma block decode failed";
        return false;
      }
      break;
    default:
      *err = "CRAM 3.1 codec (method " + std::to_string(blk->method) +
             ") not supported";
      return false;
  }
  if ((int)blk->data.size() != usize) {
    *err = "CRAM block size mismatch";
    return false;
  }
  return true;
}

// ---------------------------------------------------------------- encodings

struct Ctx;

struct Encoding {
  int codec = 0;  // 0 NULL, 1 EXTERNAL, 3 HUFFMAN, 4 BYTE_ARRAY_LEN,
                  // 5 BYTE_ARRAY_STOP, 6 BETA, 9 GAMMA
  int content_id = -1;
  uint8_t stop = 0;
  int64_t offset = 0;  // BETA/GAMMA
  int nbits = 0;       // BETA
  // HUFFMAN canonical tables
  std::vector<int64_t> hsyms;           // sorted by (len, sym)
  std::vector<int> hlens;               // parallel
  std::unique_ptr<Encoding> len_enc, val_enc;

  bool parse(Buf& b, std::string* err);
  int64_t dec_int(Ctx& c) const;
  int dec_byte(Ctx& c) const;
  bool dec_bytes(Ctx& c, std::vector<uint8_t>* out) const;
};

struct Stream {
  const uint8_t* p = nullptr;
  const uint8_t* e = nullptr;
};

struct Ctx {
  // content-id -> stream: flat array for the small ids every data series
  // uses (one lookup per decoded value — this is the hottest call in the
  // whole CRAM path), map fallback for large ids (3-byte tag keys)
  static constexpr int SMALL = 256;
  Stream ext_small[SMALL] = {};
  std::map<int, Stream> ext_big;
  Stream core;
  size_t corebit = 0;
  bool fail = false;
  std::string err;

  void put(int id, Stream s) {
    if ((unsigned)id < SMALL) ext_small[id] = s;
    else ext_big[id] = s;
  }

  Stream* get(int id) {
    if ((unsigned)id < SMALL) {
      Stream* s = &ext_small[id];
      if (s->p) return s;
    } else {
      auto it = ext_big.find(id);
      if (it != ext_big.end()) return &it->second;
    }
    fail = true;
    err = "missing external block " + std::to_string(id);
    return nullptr;
  }
  int bit() {
    size_t byte = corebit >> 3;
    if (core.p + byte >= core.e) { fail = true; return 0; }
    int v = (core.p[byte] >> (7 - (corebit & 7))) & 1;
    corebit++;
    return v;
  }
  uint64_t bits(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | (uint64_t)bit();
    return v;
  }
  uint8_t ext_u8(int id) {
    Stream* s = get(id);
    if (!s || s->p >= s->e) { fail = true; return 0; }
    return *s->p++;
  }
  int64_t ext_itf8(int id) {
    // inlined itf8 (hot: ~12 calls per record) — fast path for 1-byte values
    Stream* s = get(id);
    if (!s || s->p >= s->e) { fail = true; return 0; }
    uint32_t b0 = *s->p++;
    if (b0 < 0x80) return (int64_t)(int32_t)b0;
    if (b0 >= 0xf0) {  // 5-byte form: low 4 bits of the final byte only
      if (s->e - s->p < 4) { fail = true; return 0; }
      uint32_t w = (b0 & 0x0f) << 28;
      w |= (uint32_t)s->p[0] << 20;
      w |= (uint32_t)s->p[1] << 12;
      w |= (uint32_t)s->p[2] << 4;
      w |= (uint32_t)(s->p[3] & 0x0f);
      s->p += 4;
      return (int64_t)(int32_t)w;
    }
    int extra = b0 < 0xc0 ? 1 : b0 < 0xe0 ? 2 : 3;
    if (s->e - s->p < extra) { fail = true; return 0; }
    uint32_t v = b0;
    for (int i = 0; i < extra; i++) v = (v << 8) | *s->p++;
    static const uint32_t MASK[4] = {0, 0x3fff, 0x1fffff, 0x0fffffff};
    return (int64_t)(int32_t)(v & MASK[extra]);
  }
};

bool Encoding::parse(Buf& b, std::string* err) {
  codec = b.itf8();
  int32_t plen = b.itf8();
  if (b.fail || b.left() < (size_t)plen) {
    *err = "truncated encoding";
    return false;
  }
  Buf pb(b.p, plen);
  b.p += plen;
  switch (codec) {
    case 0:
      break;
    case 1:  // EXTERNAL
      content_id = pb.itf8();
      break;
    case 3: {  // HUFFMAN
      int32_t n = pb.itf8();
      if (n < 0 || n > (1 << 20)) { *err = "bad huffman alphabet"; return false; }
      std::vector<int64_t> syms(n);
      std::vector<int> lens(n);
      for (int i = 0; i < n; i++) syms[i] = pb.itf8();
      int32_t nl = pb.itf8();
      if (nl != n) { *err = "huffman len mismatch"; return false; }
      for (int i = 0; i < n; i++) {
        lens[i] = pb.itf8();
        if (lens[i] < 0 || lens[i] > 56) { *err = "bad huffman code length"; return false; }
      }
      // canonical order: (len, symbol) ascending
      std::vector<int> order(n);
      for (int i = 0; i < n; i++) order[i] = i;
      std::stable_sort(order.begin(), order.end(), [&](int a, int c) {
        if (lens[a] != lens[c]) return lens[a] < lens[c];
        return syms[a] < syms[c];
      });
      hsyms.resize(n);
      hlens.resize(n);
      for (int i = 0; i < n; i++) {
        hsyms[i] = syms[order[i]];
        hlens[i] = lens[order[i]];
      }
      break;
    }
    case 4: {  // BYTE_ARRAY_LEN
      len_enc.reset(new Encoding());
      val_enc.reset(new Encoding());
      if (!len_enc->parse(pb, err) || !val_enc->parse(pb, err)) return false;
      break;
    }
    case 5:  // BYTE_ARRAY_STOP
      stop = pb.u8();
      content_id = pb.itf8();
      break;
    case 6:  // BETA
      offset = pb.itf8();
      nbits = pb.itf8();
      break;
    case 9:  // GAMMA
      offset = pb.itf8();
      break;
    default:
      *err = "unsupported encoding codec " + std::to_string(codec);
      return false;
  }
  if (pb.fail) { *err = "truncated encoding params"; return false; }
  return true;
}

static int64_t huffman_decode(const Encoding& E, Ctx& c) {
  if (E.hsyms.empty()) { c.fail = true; return 0; }
  if (E.hlens[0] == 0) return E.hsyms[0];  // single zero-bit symbol
  uint64_t code = 0;
  int len = 0;
  size_t i = 0;
  uint64_t first = 0;  // canonical first code of current length
  while (i < E.hsyms.size()) {
    int L = E.hlens[i];
    code = (code << (L - len)) | c.bits(L - len);
    first <<= (L - len);
    len = L;
    // count symbols at this length
    size_t j = i;
    while (j < E.hsyms.size() && E.hlens[j] == L) j++;
    if (code - first < (uint64_t)(j - i)) return E.hsyms[i + (code - first)];
    first += (uint64_t)(j - i);
    i = j;
    if (c.fail) break;
  }
  c.fail = true;
  c.err = "bad huffman code";
  return 0;
}

int64_t Encoding::dec_int(Ctx& c) const {
  switch (codec) {
    case 1:
      return c.ext_itf8(content_id);
    case 3:
      return huffman_decode(*this, c);
    case 6:
      return (int64_t)c.bits(nbits) - offset;
    case 9: {
      int nz = 0;
      while (!c.fail && c.bit() == 0) nz++;
      int64_t v = 1;
      for (int i = 0; i < nz; i++) v = (v << 1) | (int64_t)c.bit();
      return v - offset;
    }
    default:
      c.fail = true;
      c.err = "encoding cannot produce ints (codec " + std::to_string(codec) + ")";
      return 0;
  }
}

int Encoding::dec_byte(Ctx& c) const {
  switch (codec) {
    case 1:
      return c.ext_u8(content_id);
    case 3:
      return (int)huffman_decode(*this, c);
    case 6:
      return (int)((int64_t)c.bits(nbits) - offset);
    default:
      c.fail = true;
      c.err = "encoding cannot produce bytes";
      return 0;
  }
}

bool Encoding::dec_bytes(Ctx& c, std::vector<uint8_t>* out) const {
  out->clear();
  switch (codec) {
    case 5: {  // BYTE_ARRAY_STOP
      Stream* s = c.get(content_id);
      if (!s) return false;
      const uint8_t* q = s->p;
      while (q < s->e && *q != stop) q++;
      if (q >= s->e) { c.fail = true; c.err = "unterminated byte array"; return false; }
      out->assign(s->p, q);
      s->p = q + 1;
      return true;
    }
    case 4: {  // BYTE_ARRAY_LEN
      int64_t n = len_enc->dec_int(c);
      if (c.fail || n < 0 || n > (1 << 20)) { c.fail = true; return false; }
      if (val_enc->codec == 1) {  // fast path: raw slab from external
        Stream* s = c.get(val_enc->content_id);
        if (!s || s->e - s->p < n) { c.fail = true; return false; }
        out->assign(s->p, s->p + n);
        s->p += n;
        return true;
      }
      out->resize(n);
      for (int64_t i = 0; i < n; i++) (*out)[i] = (uint8_t)val_enc->dec_byte(c);
      return !c.fail;
    }
    default:
      c.fail = true;
      c.err = "encoding cannot produce byte arrays";
      return false;
  }
}

// -------------------------------------------------- compression header

struct CompHdr {
  bool read_names = true;
  bool ap_delta = true;
  bool ref_required = true;
  uint8_t sm[5] = {0x1b, 0x1b, 0x1b, 0x1b, 0x1b};
  // tag dictionary: line -> list of (tag0, tag1, type)
  std::vector<std::vector<std::array<uint8_t, 3>>> td;
  std::map<uint16_t, Encoding> ds;  // key = (c0<<8)|c1
  std::map<int32_t, Encoding> tags;

  // required-fields analysis (computed once per compression header): this
  // reader decodes-and-discards qualities (QS/QQ) and aux tags, so any of
  // them whose encodings draw only on EXTERNAL blocks that no needed series
  // shares can be skipped entirely — including the block decompression.
  bool skip_enabled = false;
  bool skip_qs = false, skip_qq = false;
  std::set<int32_t> skip_tag_keys;
  std::set<int> used_ids;  // external content ids that must be decompressed

  const Encoding* get(const char* k) const {
    auto it = ds.find((uint16_t)(((uint8_t)k[0] << 8) | (uint8_t)k[1]));
    return it == ds.end() ? nullptr : &it->second;
  }
};

// collect what an encoding consumes: core bitstream and/or external ids
static void enc_use(const Encoding& e, bool* core, std::set<int>* ids) {
  switch (e.codec) {
    case 1:  // EXTERNAL
    case 5:  // BYTE_ARRAY_STOP
      ids->insert(e.content_id);
      break;
    case 4:  // BYTE_ARRAY_LEN
      if (e.len_enc) enc_use(*e.len_enc, core, ids);
      if (e.val_enc) enc_use(*e.val_enc, core, ids);
      break;
    case 3:  // HUFFMAN: a single zero-length symbol consumes no core bits
      if (!(e.hlens.size() == 1 && e.hlens[0] == 0)) *core = true;
      break;
    case 6:  // BETA
    case 9:  // GAMMA
      *core = true;
      break;
    default:
      break;  // NULL
  }
}

static bool cram_decode_all() {
  // magic static: thread-safe one-time init (decode workers race here)
  static const bool v = [] {
    const char* e = getenv("STRLING_CRAM_DECODE_ALL");
    return e && *e && *e != '0';
  }();
  return v;
}

static void analyze_required_fields(CompHdr* ch) {
  if (cram_decode_all()) return;
  std::set<int> needed;
  const uint16_t KQS = ('Q' << 8) | 'S', KQQ = ('Q' << 8) | 'Q';
  for (const auto& kv : ch->ds) {
    if (kv.first == KQS || kv.first == KQQ) continue;
    bool core = false;
    enc_use(kv.second, &core, &needed);
  }
  struct Cand {
    int which;  // 0 QS, 1 QQ, 2 tag
    int32_t key;
    bool core = false;
    std::set<int> ids;
    bool skipped = true;
  };
  std::vector<Cand> cands;
  for (int w = 0; w < 2; w++) {
    auto it = ch->ds.find(w == 0 ? KQS : KQQ);
    if (it == ch->ds.end()) continue;
    Cand c;
    c.which = w;
    c.key = 0;
    enc_use(it->second, &c.core, &c.ids);
    cands.push_back(std::move(c));
  }
  for (const auto& kv : ch->tags) {
    Cand c;
    c.which = 2;
    c.key = kv.first;
    enc_use(kv.second, &c.core, &c.ids);
    cands.push_back(std::move(c));
  }
  // fixpoint: demote any candidate that consumes core bits or shares an
  // external block with a series that must be decoded
  bool changed = true;
  while (changed) {
    changed = false;
    for (auto& c : cands) {
      if (!c.skipped) continue;
      bool overlap = c.core;
      for (int id : c.ids)
        if (overlap || needed.count(id)) {
          overlap = true;
          break;
        }
      if (overlap) {
        c.skipped = false;
        for (int id : c.ids) needed.insert(id);
        changed = true;
      }
    }
  }
  for (const auto& c : cands) {
    if (!c.skipped) continue;
    if (c.which == 0) ch->skip_qs = true;
    else if (c.which == 1) ch->skip_qq = true;
    else ch->skip_tag_keys.insert(c.key);
  }
  ch->used_ids = std::move(needed);
  ch->skip_enabled = true;
}

static bool parse_comp_hdr(const std::vector<uint8_t>& data, CompHdr* ch,
                           std::string* err) {
  Buf b(data.data(), data.size());
  // preservation map
  int32_t psz = b.itf8();
  (void)psz;
  int32_t n = b.itf8();
  for (int i = 0; i < n && !b.fail; i++) {
    char k0 = (char)b.u8(), k1 = (char)b.u8();
    if (k0 == 'R' && k1 == 'N') ch->read_names = b.u8() != 0;
    else if (k0 == 'A' && k1 == 'P') ch->ap_delta = b.u8() != 0;
    else if (k0 == 'R' && k1 == 'R') ch->ref_required = b.u8() != 0;
    else if (k0 == 'S' && k1 == 'M') b.raw(ch->sm, 5);
    else if (k0 == 'T' && k1 == 'D') {
      int32_t len = b.itf8();
      if (b.fail || b.left() < (size_t)len) { *err = "bad TD"; return false; }
      const uint8_t* q = b.p;
      const uint8_t* qe = q + len;
      std::vector<std::array<uint8_t, 3>> line;
      while (q < qe) {
        if (*q == 0) {
          ch->td.push_back(line);
          line.clear();
          q++;
        } else {
          if (qe - q < 3) { *err = "bad TD triplet"; return false; }
          line.push_back({q[0], q[1], q[2]});
          q += 3;
        }
      }
      b.p += len;
    } else {
      *err = std::string("unknown preservation key ") + k0 + k1;
      return false;
    }
  }
  if (ch->td.empty()) ch->td.push_back({});
  // data series encodings
  int32_t dsz = b.itf8();
  (void)dsz;
  n = b.itf8();
  for (int i = 0; i < n && !b.fail; i++) {
    uint8_t k0 = b.u8(), k1 = b.u8();
    Encoding E;
    if (!E.parse(b, err)) return false;
    ch->ds[(uint16_t)((k0 << 8) | k1)] = std::move(E);
  }
  // tag encodings
  int32_t tsz = b.itf8();
  (void)tsz;
  n = b.itf8();
  for (int i = 0; i < n && !b.fail; i++) {
    int32_t key = b.itf8();
    Encoding E;
    if (!E.parse(b, err)) return false;
    ch->tags[key] = std::move(E);
  }
  if (b.fail) { *err = "truncated compression header"; return false; }
  analyze_required_fields(ch);
  return true;
}

// ------------------------------------------------------------ FASTA access

struct FastaRef {
  struct Ent {
    int64_t len = 0, off = 0, linebases = 0, linewidth = 0;
  };
  std::string path;
  std::map<std::string, Ent> idx;
  std::map<std::string, std::string> cache;
  std::mutex cache_mu;  // fetch() is called from decode workers
  bool ok = false;

  bool open(const char* p) {
    path = p;
    std::string fai = path + ".fai";
    FILE* f = fopen(fai.c_str(), "rb");
    if (f) {
      char line[4096];
      while (fgets(line, sizeof line, f)) {
        char name[2048];
        Ent e;
        if (sscanf(line, "%2047s\t%ld\t%ld\t%ld\t%ld", name, &e.len, &e.off,
                   &e.linebases, &e.linewidth) == 5)
          idx[name] = e;
      }
      fclose(f);
      ok = !idx.empty();
      if (ok) return true;
    }
    return scan();
  }

  // build the index by scanning a plain-text FASTA
  bool scan() {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return false;
    std::string name;
    Ent cur;
    int64_t off = 0;
    char line[65536];
    bool first_seq_line = true;
    auto flush = [&]() {
      if (!name.empty()) idx[name] = cur;
    };
    while (fgets(line, sizeof line, f)) {
      size_t n = strlen(line);
      if (line[0] == '>') {
        flush();
        cur = Ent();
        char* sp = strpbrk(line + 1, " \t\r\n");
        name.assign(line + 1, sp ? sp - (line + 1) : n - 1);
        cur.off = off + n;
        first_seq_line = true;
      } else if (!name.empty()) {
        size_t bases = n;
        while (bases && (line[bases - 1] == '\n' || line[bases - 1] == '\r'))
          bases--;
        if (first_seq_line) {
          cur.linebases = bases;
          cur.linewidth = n;
          first_seq_line = false;
        }
        cur.len += bases;
      }
      off += n;
    }
    flush();
    fclose(f);
    ok = !idx.empty();
    return ok;
  }

  const std::string* fetch(const std::string& name) {
    std::lock_guard<std::mutex> lk(cache_mu);
    auto c = cache.find(name);
    if (c != cache.end()) return &c->second;
    auto it = idx.find(name);
    if (it == idx.end()) return nullptr;
    const Ent& e = it->second;
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return nullptr;
    std::string s;
    s.reserve(e.len);
    fseeko(f, e.off, SEEK_SET);
    int64_t nlines = e.linebases ? (e.len + e.linebases - 1) / e.linebases : 0;
    int64_t raw = e.len + nlines * (e.linewidth - e.linebases);
    std::vector<char> tmp(raw);
    size_t got = fread(tmp.data(), 1, raw, f);
    fclose(f);
    for (size_t i = 0; i < got; i++) {
      char ch = tmp[i];
      if (ch == '\n' || ch == '\r') continue;
      s.push_back((char)toupper((unsigned char)ch));
    }
    auto ins = cache.emplace(name, std::move(s));
    return &ins.first->second;
  }
};

// --------------------------------------------------------------- containers

struct ContHdr; static bool read_cont_hdr_fp(FILE* fp, int64_t off,
                                             struct ContHdr* ch,
                                             std::string* err);

struct ContHdr {
  int64_t length = 0;  // payload bytes
  int32_t ref_id = 0, start = 0, span = 0, n_rec = 0;
  int64_t counter = 0, bases = 0;
  int32_t n_blocks = 0;
  std::vector<int32_t> landmarks;
  int64_t header_size = 0;  // bytes consumed by the header itself
};

struct SliceHdr {
  int32_t ref_id = 0, start = 0, span = 0, n_rec = 0;
  int64_t counter = 0;
  int32_t n_blocks = 0;
  std::vector<int32_t> content_ids;
  int32_t embedded_ref_id = -1;
  uint8_t md5[16] = {0};
};

static bool parse_cont_hdr(Buf& b, ContHdr* h) {
  const uint8_t* start = b.p;
  h->length = (int32_t)b.u32le();
  if (h->length < 0) return false;
  h->ref_id = b.itf8();
  h->start = b.itf8();
  h->span = b.itf8();
  h->n_rec = b.itf8();
  h->counter = b.ltf8();
  h->bases = b.ltf8();
  h->n_blocks = b.itf8();
  int32_t nl = b.itf8();
  if (b.fail || nl < 0 || nl > (1 << 20)) return false;
  h->landmarks.resize(nl);
  for (int i = 0; i < nl; i++) h->landmarks[i] = b.itf8();
  b.u32le();  // crc32
  if (b.fail) return false;
  h->header_size = b.p - start;
  return true;
}

static bool read_cont_hdr_fp(FILE* fp, int64_t off, ContHdr* ch,
                             std::string* err) {
  for (size_t cap = 1 << 10;; cap <<= 4) {
    if (fseeko(fp, off, SEEK_SET) != 0) { *err = "seek failed"; return false; }
    std::vector<uint8_t> buf(cap);
    size_t got = fread(buf.data(), 1, cap, fp);
    if (got == 0) return false;  // physical EOF (err left empty)
    Buf b(buf.data(), got);
    if (parse_cont_hdr(b, ch)) {
      fseeko(fp, off + ch->header_size, SEEK_SET);
      return true;
    }
    if (got < cap || cap > (1u << 24)) {
      *err = "bad CRAM container header";
      return false;
    }
  }
}

static bool parse_slice_hdr(const std::vector<uint8_t>& data, SliceHdr* sh) {
  Buf b(data.data(), data.size());
  sh->ref_id = b.itf8();
  sh->start = b.itf8();
  sh->span = b.itf8();
  sh->n_rec = b.itf8();
  sh->counter = b.ltf8();
  sh->n_blocks = b.itf8();
  int32_t n = b.itf8();
  if (b.fail || n < 0 || n > (1 << 20)) return false;
  sh->content_ids.resize(n);
  for (int i = 0; i < n; i++) sh->content_ids[i] = b.itf8();
  sh->embedded_ref_id = b.itf8();
  b.raw(sh->md5, 16);
  return !b.fail;
}

// substitution decode: SM byte for ref base packs 2-bit codes for the four
// alternative bases in "ACGTN"-minus-ref order (CRAM 3.0 §10.3)
static const char* SUB_ALTS[5] = {"CGTN", "AGTN", "ACTN", "ACGN", "ACGT"};

static int base_index(char c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return 4;
  }
}

static char substitute(const uint8_t sm[5], char refbase, int code) {
  int i = base_index(refbase);
  for (int j = 0; j < 4; j++)
    if (((sm[i] >> (6 - 2 * j)) & 3) == code) return SUB_ALTS[i][j];
  return 'N';
}

// ASCII base -> BAM 4-bit code
static uint8_t nt16(char c);
struct NT16Tab {
  uint8_t t[256];
  NT16Tab() {
    for (int i = 0; i < 256; i++) t[i] = nt16((char)i);
  }
};
static const NT16Tab NT16T;

static uint8_t nt16(char c) {
  switch (c) {
    case '=': return 0;
    case 'A': case 'a': return 1;
    case 'C': case 'c': return 2;
    case 'M': case 'm': return 3;
    case 'G': case 'g': return 4;
    case 'R': case 'r': return 5;
    case 'S': case 's': return 6;
    case 'V': case 'v': return 7;
    case 'T': case 't': return 8;
    case 'W': case 'w': return 9;
    case 'Y': case 'y': return 10;
    case 'H': case 'h': return 11;
    case 'K': case 'k': return 12;
    case 'D': case 'd': return 13;
    case 'B': case 'b': return 14;
    default: return 15;
  }
}

// ------------------------------------------------------------- CRAM reader

struct CramMT;

struct CramReader : Reader {
  CramMT* cmt = nullptr;  // parallel container decode for sequential scans
  int64_t mt_next_off = 0;
  void start_mt(int64_t off, int threads);
  void stop_mt();
  int load_next_container_mt();

  FILE* fp = nullptr;
  std::string path_;
  std::string hdr_text;
  std::vector<std::string> names;
  std::vector<int64_t> lens;
  FastaRef fasta;
  bool have_fasta = false;
  int64_t data_start = 0;  // offset of the first data container

  struct CraiEnt {
    int32_t seq;
    int64_t start, span, coff, soff, ssize;
  };
  std::vector<CraiEnt> crai;
  bool crai_loaded = false;

  // iteration state
  int mode = 0;
  int qtid = -1;
  int64_t qbeg = 0, qend = 0;
  int64_t next_off = 0;
  size_t crai_idx = 0;
  bool iter_done = false;
  std::vector<BamRec> recq;
  size_t reci = 0;

  // cached container for CRAI slice queries
  int64_t cached_coff = -1;
  std::vector<uint8_t> cached_payload;
  CompHdr cached_ch;
  bool cached_ok = false;

  ~CramReader() override;

  const std::string& header_text() override { return hdr_text; }
  const std::vector<std::string>& ref_names() override { return names; }
  const std::vector<int64_t>& ref_lens() override { return lens; }
  bool has_index() override { return crai_loaded; }

  bool set_fasta(const char* p) override {
    have_fasta = fasta.open(p);
    if (!have_fasta) err = "cannot open reference fasta " + std::string(p);
    return have_fasta;
  }

  bool open(const char* path) {
    path_ = path;
    fp = fopen(path, "rb");
    if (!fp) { err = "cannot open " + std::string(path); return false; }
    uint8_t def[26];
    if (fread(def, 1, 26, fp) != 26 || memcmp(def, "CRAM", 4) != 0) {
      err = "not a CRAM file";
      return false;
    }
    if (def[4] != 3) {
      err = "unsupported CRAM major version " + std::to_string(def[4]);
      return false;
    }
    // SAM-header container
    ContHdr ch;
    if (!read_cont_hdr(26, &ch)) return false;
    std::vector<uint8_t> payload(ch.length);
    if ((int64_t)fread(payload.data(), 1, ch.length, fp) != ch.length) {
      err = "truncated CRAM header container";
      return false;
    }
    Buf b(payload.data(), payload.size());
    Block blk;
    if (!read_block(b, &blk, &err)) return false;
    if (blk.ctype != BT_FILE_HEADER || blk.data.size() < 4) {
      err = "first CRAM block is not the SAM header";
      return false;
    }
    Buf hb(blk.data.data(), blk.data.size());
    uint32_t hlen = hb.u32le();
    if (hlen > hb.left()) { err = "bad SAM header length"; return false; }
    hdr_text.assign((const char*)hb.p, hlen);
    while (!hdr_text.empty() && hdr_text.back() == '\0') hdr_text.pop_back();
    parse_sq();
    data_start = 26 + ch.header_size + ch.length;
    next_off = data_start;
    load_crai();
    return true;
  }

  void parse_sq() {
    size_t pos = 0;
    while (pos < hdr_text.size()) {
      size_t eol = hdr_text.find('\n', pos);
      if (eol == std::string::npos) eol = hdr_text.size();
      std::string line = hdr_text.substr(pos, eol - pos);
      pos = eol + 1;
      if (line.rfind("@SQ", 0) != 0) continue;
      std::string sn;
      int64_t ln = 0;
      size_t t = 0;
      while (t < line.size()) {
        size_t nt = line.find('\t', t);
        if (nt == std::string::npos) nt = line.size();
        std::string fld = line.substr(t, nt - t);
        if (fld.rfind("SN:", 0) == 0) sn = fld.substr(3);
        if (fld.rfind("LN:", 0) == 0) ln = atoll(fld.c_str() + 3);
        t = nt + 1;
      }
      if (!sn.empty()) {
        names.push_back(sn);
        lens.push_back(ln);
      }
    }
  }

  void load_crai() {
    for (const std::string& cand :
         {path_ + ".crai",
          path_.size() > 5 ? path_.substr(0, path_.size() - 5) + ".crai"
                           : std::string()}) {
      if (cand.empty()) continue;
      FILE* f = fopen(cand.c_str(), "rb");
      if (!f) continue;
      fseeko(f, 0, SEEK_END);
      int64_t sz = ftello(f);
      fseeko(f, 0, SEEK_SET);
      std::vector<uint8_t> raw(sz);
      if ((int64_t)fread(raw.data(), 1, sz, f) != sz) { fclose(f); continue; }
      fclose(f);
      std::vector<uint8_t> txt;
      if (sz >= 2 && raw[0] == 0x1f && raw[1] == 0x8b) {
        if (!gunzip_all(raw.data(), sz, &txt)) continue;
      } else {
        txt = raw;
      }
      // lines: seq_id \t start \t span \t container_off \t slice_off \t size
      const char* q = (const char*)txt.data();
      const char* qe = q + txt.size();
      while (q < qe) {
        CraiEnt e;
        long long v[6] = {0, 0, 0, 0, 0, 0};
        int fld = 0;
        const char* line_end = (const char*)memchr(q, '\n', qe - q);
        if (!line_end) line_end = qe;
        const char* s = q;
        while (s < line_end && fld < 6) {
          v[fld++] = atoll(s);
          const char* tabp = (const char*)memchr(s, '\t', line_end - s);
          if (!tabp) break;
          s = tabp + 1;
        }
        if (fld == 6) {
          e.seq = (int32_t)v[0];
          e.start = v[1];
          e.span = v[2];
          e.coff = v[3];
          e.soff = v[4];
          e.ssize = v[5];
          crai.push_back(e);
        }
        q = line_end + 1;
      }
      crai_loaded = !crai.empty();
      if (crai_loaded) return;
    }
  }

  bool read_cont_hdr(int64_t off, ContHdr* ch) {
    return read_cont_hdr_fp(fp, off, ch, &err);
  }

  bool begin(int m, int tid, int64_t beg, int64_t end) override {
    mode = m;
    qtid = tid;
    qbeg = beg;
    qend = end;
    recq.clear();
    reci = 0;
    iter_done = false;
    next_off = data_start;
    crai_idx = 0;
    stop_mt();
    if (mode == 1) {
      if (!crai_loaded) {
        err = "no .crai index";
        return false;
      }
      return true;
    }
    const char* t = getenv("STRLING_CRAM_THREADS");
    int hw = (int)std::thread::hardware_concurrency();
    int threads = t ? atoi(t) : std::max(1, std::min(8, hw));
    if (threads > 0) start_mt(data_start, threads);
    return true;
  }

  int next(BamRec* r) override {
    while (reci >= recq.size()) {
      if (iter_done) return 0;
      int rc = (mode == 1) ? load_next_crai_slice() : load_next_container();
      if (rc < 0) return -1;
      if (rc == 0) iter_done = true;
    }
    *r = std::move(recq[reci++]);
    return 1;
  }

  // ------------------------------------------------------ sequential scan

  // returns 1 if records were (possibly) appended, 0 at EOF, -1 error
  int load_next_container() {
    if (cmt) return load_next_container_mt();
    recq.clear();
    reci = 0;
    ContHdr ch;
    if (!read_cont_hdr(next_off, &ch)) return err.empty() ? 0 : -1;
    int64_t payload_off = next_off + ch.header_size;
    next_off = payload_off + ch.length;
    if (ch.n_rec == 0) return 1;  // EOF container or empty: skip payload
    if (mode == 2 && ch.ref_id >= 0) return 1;  // mapped-only container
    std::vector<uint8_t> payload(ch.length);
    if ((int64_t)fread(payload.data(), 1, ch.length, fp) != ch.length) {
      err = "truncated container";
      return -1;
    }
    if (!decode_container_payload(payload, mode == 2, &recq, &err)) return -1;
    return 1;
  }

  // ------------------------------------------------------- region queries

  int load_next_crai_slice() {
    recq.clear();
    reci = 0;
    while (crai_idx < crai.size()) {
      const CraiEnt& e = crai[crai_idx++];
      bool candidate =
          (e.seq == qtid &&
           e.start - 1 < qend && e.start - 1 + e.span > qbeg) ||
          e.seq == -2;  // multiref slices must be decoded and filtered
      if (!candidate) continue;
      if (!load_crai_container(e.coff)) return -1;
      if (e.soff < 0 || (size_t)e.soff >= cached_payload.size()) {
        err = "bad slice offset in .crai";
        return -1;
      }
      Buf b(cached_payload.data() + e.soff,
            cached_payload.size() - (size_t)e.soff);
      if (!decode_slice_at(&b, cached_ch, &recq, &err)) return -1;
      // overlap filter (htslib iterator semantics: endpos>beg && pos<end)
      size_t w = 0;
      for (size_t i = 0; i < recq.size(); i++) {
        BamRec& r = recq[i];
        if (!(r.tid == qtid && r.pos < qend && sio::endpos(r) > qbeg)) continue;
        if (w != i) recq[w] = std::move(r);
        w++;
      }
      recq.resize(w);
      return 1;
    }
    return 0;
  }

  bool load_crai_container(int64_t coff) {
    if (cached_coff == coff && cached_ok) return true;
    cached_ok = false;
    ContHdr ch;
    if (!read_cont_hdr(coff, &ch)) {
      if (err.empty()) err = "bad container offset in .crai";
      return false;
    }
    cached_payload.resize(ch.length);
    if ((int64_t)fread(cached_payload.data(), 1, ch.length, fp) != ch.length) {
      err = "truncated container";
      return false;
    }
    Buf b(cached_payload.data(), cached_payload.size());
    Block blk;
    if (!read_block(b, &blk, &err)) return false;
    cached_ch = CompHdr();
    if (blk.ctype != BT_COMP_HEADER ||
        !parse_comp_hdr(blk.data, &cached_ch, &err))
      return false;
    cached_coff = coff;
    cached_ok = true;
    return true;
  }

  // --------------------------------------------------------- slice decode

  // decode one slice starting at *b (slice header block first), appending
  // decoded records to *out; advances b past the slice
  bool decode_slice_at(Buf* b, const CompHdr& cmp, std::vector<BamRec>* out,
                       std::string* errp) {
    Block shb;
    if (!read_block(*b, &shb, errp)) return false;
    if (shb.ctype != BT_SLICE_HEADER) {
      *errp = "expected slice header block";
      return false;
    }
    SliceHdr sh;
    if (!parse_slice_hdr(shb.data, &sh)) {
      *errp = "bad slice header";
      return false;
    }
    std::vector<Block> blocks(sh.n_blocks);
    const std::set<int>* used = cmp.skip_enabled ? &cmp.used_ids : nullptr;
    for (int i = 0; i < sh.n_blocks; i++)
      if (!read_block(*b, &blocks[i], errp, used, sh.embedded_ref_id))
        return false;
    return decode_slice(cmp, sh, blocks, out, errp);
  }

  // decode every slice of a container payload (thread-safe: only touches
  // shared read-only state plus the locked FASTA cache)
  bool decode_container_payload(const std::vector<uint8_t>& payload,
                                bool only_nocoor, std::vector<BamRec>* out,
                                std::string* errp) {
    CompHdr cmp;
    Buf b(payload.data(), payload.size());
    Block blk;
    if (!read_block(b, &blk, errp)) return false;
    if (blk.ctype != BT_COMP_HEADER) {
      *errp = "expected compression header block";
      return false;
    }
    if (!parse_comp_hdr(blk.data, &cmp, errp)) return false;
    while (b.p < b.e) {
      if (!decode_slice_at(&b, cmp, out, errp)) return false;
    }
    if (only_nocoor) {
      size_t w = 0;
      for (size_t i = 0; i < out->size(); i++) {
        if ((*out)[i].tid >= 0) continue;
        if (w != i) (*out)[w] = std::move((*out)[i]);
        w++;
      }
      out->resize(w);
    }
    return true;
  }

  const std::string* ref_for(int tid) {
    if (tid < 0 || tid >= (int)names.size()) return nullptr;
    if (!have_fasta) return nullptr;
    return fasta.fetch(names[tid]);
  }

  bool decode_slice(const CompHdr& cmp, const SliceHdr& sh,
                    const std::vector<Block>& blocks,
                    std::vector<BamRec>* out, std::string* errp) {
    Ctx c;
    const std::vector<uint8_t>* embedded_ref = nullptr;
    for (const Block& blk : blocks) {
      if (blk.skipped) continue;  // required-fields: never decompressed
      if (blk.ctype == BT_CORE) {
        c.core = {blk.data.data(), blk.data.data() + blk.data.size()};
      } else if (blk.ctype == BT_EXTERNAL) {
        c.put(blk.content_id,
              {blk.data.data(), blk.data.data() + blk.data.size()});
        if (blk.content_id == sh.embedded_ref_id) embedded_ref = &blk.data;
      }
    }
    auto DS = [&](const char* k) -> const Encoding* { return cmp.get(k); };
    const Encoding *eBF = DS("BF"), *eCF = DS("CF"), *eRI = DS("RI"),
                   *eRL = DS("RL"), *eAP = DS("AP"), *eRG = DS("RG"),
                   *eRN = DS("RN"), *eMF = DS("MF"), *eNS = DS("NS"),
                   *eNP = DS("NP"), *eTS = DS("TS"), *eNF = DS("NF"),
                   *eTL = DS("TL"), *eFN = DS("FN"), *eFC = DS("FC"),
                   *eFP = DS("FP"), *eDL = DS("DL"), *eBB = DS("BB"),
                   *eQQ = DS("QQ"), *eBS = DS("BS"), *eIN = DS("IN"),
                   *eSC = DS("SC"), *eHC = DS("HC"), *ePD = DS("PD"),
                   *eRS = DS("RS"), *eBA = DS("BA"), *eMQ = DS("MQ");
    // required-fields: a skipped series decodes as if absent (every use
    // site already guards on the pointer)
    const Encoding* eQS = cmp.skip_qs ? nullptr : DS("QS");
    if (cmp.skip_qq) eQQ = nullptr;
    if (!eBF || !eCF || !eRL || !eAP) {
      *errp = "missing required data series";
      return false;
    }
    int64_t last_ap = sh.start;
    size_t base = out->size();
    std::vector<int64_t> mate_link(sh.n_rec, -1);
    std::vector<uint8_t> arr;
    std::string seqbuf;
    // per-tid chromosome cache for multiref slices
    int cur_ref_tid = -3;
    const std::string* cur_ref = nullptr;

    for (int i = 0; i < sh.n_rec; i++) {
      BamRec r;
      int64_t bf = eBF->dec_int(c);
      int64_t cf = eCF->dec_int(c);
      int32_t tid = sh.ref_id;
      if (sh.ref_id == -2) {
        if (!eRI) { *errp = "multiref slice without RI"; return false; }
        tid = (int32_t)eRI->dec_int(c);
      }
      int64_t rl = eRL->dec_int(c);
      if (rl < 0 || rl > (1 << 20)) { *errp = "bad CRAM read length"; return false; }
      int64_t ap;
      if (cmp.ap_delta) {
        ap = last_ap + eAP->dec_int(c);
        last_ap = ap;
      } else {
        ap = eAP->dec_int(c);
      }
      if (eRG) eRG->dec_int(c);
      if (cmp.read_names && eRN) {
        eRN->dec_bytes(c, &arr);
        r.qname.assign((const char*)arr.data(), arr.size());
      }
      r.mate_tid = -1;
      r.mate_pos = -1;
      r.isize = 0;
      if (cf & 0x2) {  // detached
        int64_t mf = eMF ? eMF->dec_int(c) : 0;
        if (!cmp.read_names && eRN) {
          eRN->dec_bytes(c, &arr);
          r.qname.assign((const char*)arr.data(), arr.size());
        }
        r.mate_tid = eNS ? (int32_t)eNS->dec_int(c) : -1;
        r.mate_pos = eNP ? (int32_t)eNP->dec_int(c) - 1 : -1;
        r.isize = eTS ? (int32_t)eTS->dec_int(c) : 0;
        if (mf & 0x1) bf |= 0x20;  // mate reverse
        if (mf & 0x2) bf |= 0x8;   // mate unmapped
      } else if (cf & 0x4) {  // mate downstream in this slice
        int64_t nf = eNF ? eNF->dec_int(c) : 0;
        mate_link[i] = i + nf + 1;
      }
      // tags
      int64_t tl = eTL ? eTL->dec_int(c) : 0;
      if (tl < 0 || tl >= (int64_t)cmp.td.size()) {
        *errp = "bad TL index";
        return false;
      }
      for (const auto& t : cmp.td[tl]) {
        int32_t key = ((int32_t)t[0] << 16) | ((int32_t)t[1] << 8) | t[2];
        if (cmp.skip_tag_keys.count(key)) continue;  // required-fields skip
        auto it = cmp.tags.find(key);
        if (it == cmp.tags.end()) { *errp = "missing tag encoding"; return false; }
        it->second.dec_bytes(c, &arr);  // decode & discard
      }
      if (c.fail) { *errp = c.err.empty() ? "slice decode failed" : c.err; return false; }

      r.tid = tid;
      r.pos = (int32_t)(ap - 1);
      r.l_seq = (int32_t)rl;
      seqbuf.clear();
      r.cigar.clear();

      if (!(bf & 0x4)) {  // mapped read: features against the reference
        const char* refp = nullptr;
        int64_t ref_off = 0;  // value to subtract from 1-based ref pos
        int64_t ref_len = 0;
        if (embedded_ref) {
          refp = (const char*)embedded_ref->data();
          ref_off = sh.start;  // embedded ref starts at slice start
          ref_len = (int64_t)embedded_ref->size();
        } else if (cmp.ref_required) {
          if (tid != cur_ref_tid) {
            cur_ref = ref_for(tid);
            cur_ref_tid = tid;
          }
          if (cur_ref) {
            refp = cur_ref->data();
            ref_off = 1;
            ref_len = (int64_t)cur_ref->size();
          } else if (have_fasta) {
            *errp = "reference sequence not found for CRAM slice";
            return false;
          } else {
            *errp = "CRAM decode requires the reference fasta (pass --fasta)";
            return false;
          }
        }
        auto refbase = [&](int64_t pos1) -> char {
          int64_t k = pos1 - ref_off;
          if (!refp || k < 0 || k >= ref_len) return 'N';
          return refp[k];
        };
        // bulk append of a match span (the common case: whole reads are one
        // M gap) — memcpy when fully inside the reference, per-base at edges
        auto append_ref = [&](int64_t pos1, int64_t n) {
          int64_t k = pos1 - ref_off;
          if (refp && k >= 0 && k + n <= ref_len) {
            seqbuf.append(refp + k, (size_t)n);
          } else {
            for (int64_t g = 0; g < n; g++)
              seqbuf.push_back(refbase(pos1 + g));
          }
        };
        auto addcig = [&](int op, int64_t len) {
          if (len <= 0) return;
          if (!r.cigar.empty() && (int)(r.cigar.back() & 0xf) == op)
            r.cigar.back() += (uint32_t)(len << 4);
          else
            r.cigar.push_back((uint32_t)((len << 4) | op));
        };
        int64_t fn = eFN ? eFN->dec_int(c) : 0;
        if (fn < 0 || fn > 4 * rl + 64) { *errp = "bad CRAM feature count"; return false; }
        int64_t rpos = ap;  // 1-based reference cursor
        int64_t qpos = 1;   // 1-based read cursor
        int64_t prev_fp = 0;
        for (int64_t f = 0; f < fn && !c.fail; f++) {
          int fc = eFC ? eFC->dec_byte(c) : 0;
          int64_t fp_ = prev_fp + (eFP ? eFP->dec_int(c) : 0);
          if (fp_ < 0 || fp_ > rl + 1) { *errp = "bad CRAM feature position"; return false; }
          prev_fp = fp_;
          int64_t gap = fp_ - qpos;
          if (gap > 0) {
            append_ref(rpos, gap);
            addcig(0, gap);
            rpos += gap;
            qpos += gap;
          }
          switch (fc) {
            case 'B': {
              int ba = eBA ? eBA->dec_byte(c) : 'N';
              if (eQS) eQS->dec_byte(c);
              seqbuf.push_back((char)ba);
              addcig(0, 1);
              rpos++; qpos++;
              break;
            }
            case 'X': {
              int code = eBS ? eBS->dec_byte(c) : 0;
              seqbuf.push_back(substitute(cmp.sm, refbase(rpos), code));
              addcig(0, 1);
              rpos++; qpos++;
              break;
            }
            case 'S': {
              if (!eSC || !eSC->dec_bytes(c, &arr)) { c.fail = true; break; }
              seqbuf.append((const char*)arr.data(), arr.size());
              addcig(4, (int64_t)arr.size());
              qpos += (int64_t)arr.size();
              break;
            }
            case 'I': {
              if (!eIN || !eIN->dec_bytes(c, &arr)) { c.fail = true; break; }
              seqbuf.append((const char*)arr.data(), arr.size());
              addcig(1, (int64_t)arr.size());
              qpos += (int64_t)arr.size();
              break;
            }
            case 'i': {
              int ba = eBA ? eBA->dec_byte(c) : 'N';
              seqbuf.push_back((char)ba);
              addcig(1, 1);
              qpos++;
              break;
            }
            case 'b': {
              if (!eBB || !eBB->dec_bytes(c, &arr)) { c.fail = true; break; }
              seqbuf.append((const char*)arr.data(), arr.size());
              addcig(0, (int64_t)arr.size());
              rpos += (int64_t)arr.size();
              qpos += (int64_t)arr.size();
              break;
            }
            case 'q': {
              // eQQ may be deliberately null (required-fields skip)
              if (eQQ && !eQQ->dec_bytes(c, &arr)) c.fail = true;
              break;
            }
            case 'Q': {
              if (eQS) eQS->dec_byte(c);
              break;
            }
            case 'D': {
              int64_t n = eDL ? eDL->dec_int(c) : 0;
              addcig(2, n);
              rpos += n;
              break;
            }
            case 'N': {
              int64_t n = eRS ? eRS->dec_int(c) : 0;
              addcig(3, n);
              rpos += n;
              break;
            }
            case 'P': {
              int64_t n = ePD ? ePD->dec_int(c) : 0;
              addcig(6, n);
              break;
            }
            case 'H': {
              int64_t n = eHC ? eHC->dec_int(c) : 0;
              addcig(5, n);
              break;
            }
            default:
              *errp = std::string("unknown feature code '") + (char)fc + "'";
              return false;
          }
        }
        if (qpos > rl + 1) { *errp = "CRAM features overrun read length"; return false; }
        int64_t tail = rl - (qpos - 1);
        if (tail > 0) {
          append_ref(rpos, tail);
          addcig(0, tail);
        }
        r.mapq = eMQ ? (uint8_t)eMQ->dec_int(c) : 0;
        if (cf & 0x1) {  // stored quality scores: consume & discard
          for (int64_t q = 0; q < rl && !c.fail; q++)
            if (eQS) eQS->dec_byte(c);
        }
      } else {  // unmapped
        r.mapq = 0;
        if (cf & 0x8) {
          seqbuf.assign(rl, 'N');  // SEQ "*"
        } else {
          for (int64_t q = 0; q < rl && !c.fail; q++)
            seqbuf.push_back((char)(eBA ? eBA->dec_byte(c) : 'N'));
        }
        if (cf & 0x1) {
          for (int64_t q = 0; q < rl && !c.fail; q++)
            if (eQS) eQS->dec_byte(c);
        }
      }
      if (c.fail) { *errp = c.err.empty() ? "slice decode failed" : c.err; return false; }
      r.flag = (uint16_t)bf;
      r.n_cigar = (uint16_t)r.cigar.size();
      // pack sequence to 4-bit (LUT, two bases per output byte)
      if ((int64_t)seqbuf.size() < rl) seqbuf.resize(rl, 'N');
      r.seq4.resize(((size_t)rl + 1) / 2);
      {
        const uint8_t* tab = NT16T.t;
        const char* sp = seqbuf.data();
        uint8_t* dp = r.seq4.data();
        int64_t q = 0;
        for (; q + 1 < rl; q += 2)
          dp[q >> 1] = (uint8_t)((tab[(uint8_t)sp[q]] << 4) |
                                 tab[(uint8_t)sp[q + 1]]);
        if (q < rl) dp[q >> 1] = (uint8_t)(tab[(uint8_t)sp[q]] << 4);
      }
      out->push_back(std::move(r));
    }

    // resolve downstream-mate pairs (CRAM 3.0 §10.5)
    for (int i = 0; i < sh.n_rec; i++) {
      if (mate_link[i] < 0) continue;
      if (mate_link[i] >= sh.n_rec) { *errp = "mate link out of slice"; return false; }
      BamRec& a = (*out)[base + i];
      BamRec& m = (*out)[base + mate_link[i]];
      a.mate_tid = m.tid;
      a.mate_pos = m.pos;
      m.mate_tid = a.tid;
      m.mate_pos = a.pos;
      if (m.flag & 0x10) a.flag |= 0x20;
      if (m.flag & 0x4) a.flag |= 0x8;
      if (a.flag & 0x10) m.flag |= 0x20;
      if (a.flag & 0x4) m.flag |= 0x8;
      int64_t aleft = std::min(a.pos, m.pos);
      int64_t aright = std::max(sio::endpos(a), sio::endpos(m));
      int32_t tlen = (int32_t)(aright - aleft);
      if (a.pos <= m.pos) {
        a.isize = tlen;
        m.isize = -tlen;
      } else {
        a.isize = -tlen;
        m.isize = tlen;
      }
    }
    return true;
  }
};

// ------------------------------------------- parallel container decode

struct CramMT {
  CramReader* owner = nullptr;
  FILE* fp = nullptr;
  bool only_nocoor = false;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_done, cv_space;
  int64_t read_off = 0;
  bool reader_eof = false;
  bool stopping = false;
  int inflight = 0;

  struct Item {
    std::vector<BamRec> recs;
    int64_t next_off = -1;
    bool eof = false;
    std::string err;
  };
  std::map<int64_t, Item> done;
  size_t max_ahead = 6;  // decoded containers ahead (~1MB each)

  ~CramMT() { stop(); }

  bool start(const char* path, int64_t off, int threads, bool nocoor,
             CramReader* o) {
    owner = o;
    only_nocoor = nocoor;
    fp = fopen(path, "rb");
    if (!fp) return false;
    read_off = off;
    for (int i = 0; i < threads; i++)
      workers.emplace_back([this] { worker(); });
    return true;
  }

  void stop() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_space.notify_all();
    cv_done.notify_all();
    for (auto& w : workers) w.join();
    workers.clear();
    if (fp) {
      fclose(fp);
      fp = nullptr;
    }
  }

  void worker() {
    for (;;) {
      int64_t off;
      Item item;
      std::vector<uint8_t> payload;
      bool decode = false;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stopping ||
                 (!reader_eof && done.size() + (size_t)inflight < max_ahead);
        });
        if (stopping) break;
        off = read_off;
        ContHdr ch;
        std::string herr;
        if (!read_cont_hdr_fp(fp, off, &ch, &herr)) {
          item.eof = herr.empty();
          item.err = herr;
          reader_eof = true;
          done[off] = std::move(item);
          cv_done.notify_all();
          continue;
        }
        item.next_off = off + ch.header_size + ch.length;
        read_off = item.next_off;
        bool skip = ch.n_rec == 0 || (only_nocoor && ch.ref_id >= 0);
        if (!skip) {
          payload.resize(ch.length);
          if ((int64_t)fread(payload.data(), 1, ch.length, fp) !=
              ch.length) {
            item.err = "truncated container";
            reader_eof = true;
            done[off] = std::move(item);
            cv_done.notify_all();
            continue;
          }
          decode = true;
          inflight++;
        } else {
          done[off] = std::move(item);
          cv_done.notify_all();
          continue;
        }
      }
      // decode outside the lock (read-only shared state; FASTA cache locked)
      std::string derr;
      if (!owner->decode_container_payload(payload, only_nocoor, &item.recs,
                                           &derr))
        item.err = derr;
      {
        std::lock_guard<std::mutex> lk(mu);
        inflight--;
        done[off] = std::move(item);
      }
      cv_done.notify_all();
    }
  }

  bool get(int64_t off, Item* out) {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      auto it = done.find(off);
      if (it != done.end()) {
        *out = std::move(it->second);
        done.erase(it);
        cv_space.notify_all();
        return out->err.empty();
      }
      if (reader_eof && inflight == 0 &&
          (done.empty() || done.begin()->first > off)) {
        out->eof = true;
        out->err.clear();
        return true;
      }
      cv_done.wait(lk);
    }
  }
};

CramReader::~CramReader() {
  stop_mt();
  if (fp) fclose(fp);
}

void CramReader::start_mt(int64_t off, int threads) {
  CramMT* m = new CramMT();
  if (!m->start(path_.c_str(), off, threads, mode == 2, this)) {
    delete m;
    return;
  }
  cmt = m;
  mt_next_off = off;
}

void CramReader::stop_mt() {
  delete cmt;
  cmt = nullptr;
}

int CramReader::load_next_container_mt() {
  recq.clear();
  reci = 0;
  CramMT::Item item;
  if (!cmt->get(mt_next_off, &item)) {
    err = item.err;
    return -1;
  }
  if (item.eof) return 0;
  mt_next_off = item.next_off;
  recq = std::move(item.recs);
  return 1;
}

}  // namespace

namespace sio {

Reader* open_cram(const char* path) {
  CramReader* r = new CramReader();
  if (!r->open(path)) {
    fprintf(stderr, "[strling] CRAM open failed: %s\n", r->err.c_str());
    delete r;
    return nullptr;
  }
  return r;
}

}  // namespace sio

// test hook: decode one rANS4x8 stream (order 0/1); returns output size or -1
// test hook: decode one rANSNx16 stream; returns output size or -1
extern "C" int64_t sio_rans_nx16_decode(const uint8_t* in, int64_t in_sz,
                                        int64_t usize, uint8_t* out,
                                        int64_t out_cap) {
  std::vector<uint8_t> o;
  if (!rans_nx16_decode(in, (size_t)in_sz, (uint32_t)usize, &o)) return -1;
  if ((int64_t)o.size() > out_cap) return -1;
  memcpy(out, o.data(), o.size());
  return (int64_t)o.size();
}

// test hook: decode one adaptive-arithmetic stream; returns size or -1
extern "C" int64_t sio_arith_decode(const uint8_t* in, int64_t in_sz,
                                    int64_t usize, uint8_t* out,
                                    int64_t out_cap) {
  std::vector<uint8_t> o;
  if (!arith_decode(in, (size_t)in_sz, (uint32_t)usize, &o)) return -1;
  if ((int64_t)o.size() > out_cap) return -1;
  memcpy(out, o.data(), o.size());
  return (int64_t)o.size();
}

// test hook: decode one fqzcomp quality stream; returns size or -1
extern "C" int64_t sio_fqz_decode(const uint8_t* in, int64_t in_sz,
                                  int64_t usize, uint8_t* out,
                                  int64_t out_cap) {
  std::vector<uint8_t> o;
  std::string err;
  if (!fqz_decode(in, (size_t)in_sz, (uint32_t)usize, &o, &err)) return -1;
  if ((int64_t)o.size() > out_cap) return -1;
  memcpy(out, o.data(), o.size());
  return (int64_t)o.size();
}

// test hook: drive fqz_read_array directly so hand-authored store_array
// byte fixtures (tests/test_fqz_fixtures.py) pin the table wire format
// independently of the Python encoder. Returns bytes consumed or -1.
extern "C" int64_t sio_fqz_read_array_test(const uint8_t* in, int64_t in_sz,
                                           uint8_t* out, int size) {
  Buf b(in, (size_t)in_sz);
  std::vector<uint8_t> tmp(size);
  if (!fqz_read_array(b, tmp.data(), size)) return -1;
  memcpy(out, tmp.data(), (size_t)size);
  return (int64_t)(b.p - in);
}

// test hook: decode one name-tokeniser (tok3) blob; returns size or -1
extern "C" int64_t sio_tok3_decode(const uint8_t* in, int64_t in_sz,
                                   int64_t usize, uint8_t* out,
                                   int64_t out_cap) {
  std::vector<uint8_t> o;
  if (!tok3_decode(in, (size_t)in_sz, (uint32_t)usize, &o)) return -1;
  if ((int64_t)o.size() > out_cap) return -1;
  memcpy(out, o.data(), o.size());
  return (int64_t)o.size();
}

extern "C" int64_t sio_rans_decode(const uint8_t* in, int64_t in_sz,
                                   uint8_t* out, int64_t out_cap) {
  std::vector<uint8_t> o;
  if (!rans_decode(in, (size_t)in_sz, &o)) return -1;
  if ((int64_t)o.size() > out_cap) return -1;
  memcpy(out, o.data(), o.size());
  return (int64_t)o.size();
}
