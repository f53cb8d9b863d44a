#pragma once
// strling_io — native host ingest for strling_tpu.
//
// A from-scratch BGZF/BAM/BAI reader (no htslib in this environment) exposing
// a batch-oriented C API consumed via ctypes. It plays the role of the
// reference's htslib dependency (SURVEY.md §2 native-component ledger):
// sequential BAM streaming, BAI region queries incl. the no-coor ("*") block,
// and packing of decoded records into fixed-shape arrays ready for
// jax.device_put.
//
// Format references: SAM/BAM spec v1.6 (BGZF §4.1, BAM §4.2, BAI §5.2).
// Decompression uses libdeflate (raw DEFLATE) with a zlib fallback.
//
// Thread-safety: one handle per thread; no shared mutable state.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#include <algorithm>

#include <sys/syscall.h>
#include <unistd.h>

#include <libdeflate.h>

namespace sio {

// ---------------------------------------------------------------- BGZF reader

constexpr int BGZF_MAX_BLOCK = 1 << 16;

// ------------------------------------------------------ counters and spans
//
// What the threads that read for an extract engine report (the engine reads
// them out through sio_ex_counters). Each counter is a sum or a gauge, added
// with relaxed atomics once a block; times are std::chrono::steady_clock,
// which is CLOCK_MONOTONIC on Linux, the clock of Python's perf_counter.
// The engine owns them; its reader and the reader's inflate pool hold a
// shared reference, so whichever of them goes last frees them.
//
// Span events are kept only while `tracing` is on: then each thread that
// works for the engine gets a buffer that it alone writes, and the engine
// copies them out once its pass has drained.

inline int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// (utils/profiling.ENGINE_SPANS names them in the trace)
enum SpanKind { SPAN_PRODUCE = 0, SPAN_INFLATE = 1 };

// [t0, t1) on the steady clock and two numbers of what it covered: a
// produced batch's number and the ns it waited on blocks; an inflate
// stretch's blocks and their inflated bytes. Atomic because an inflate
// worker widens its last stretch in place.
struct SpanEvent {
  std::atomic<int64_t> t0, t1, a, b;
};

struct SpanBuf {
  static constexpr int64_t CAP = 1 << 16;  // events kept; later ones drop
  int kind = 0;
  int64_t tid = 0;  // the writing thread's id (gettid)
  std::atomic<int64_t> n{0};
  std::unique_ptr<SpanEvent[]> ev{new SpanEvent[CAP]};
};

// inflate stretches closer than this merge into one span
constexpr int64_t SPAN_MERGE_NS = 50000;

struct IoCounters {
  std::atomic<int64_t> inflate_ns{0};         // inside libdeflate
  std::atomic<int64_t> inflate_out_bytes{0};  // what it produced
  std::atomic<int64_t> inflate_workers{0};    // the largest pool that ran
  // the reading thread blocked on a block the pool has not inflated yet,
  // or inflating one itself off the pool (the synchronous path)
  std::atomic<int64_t> block_wait_ns{0};
  std::atomic<int64_t> ahead_bytes{0};  // blocks the pool holds (a gauge)
  std::atomic<int64_t> dropped{0};      // span events lost to full buffers
  // on for one engine pass; threads that start while it is on keep spans
  std::atomic<bool> tracing{false};
  std::mutex mu;         // guards bufs
  std::vector<std::unique_ptr<SpanBuf>> bufs;

  // a span buffer for the calling thread; nullptr while tracing is off
  SpanBuf* span_buf(int kind) {
    if (!tracing.load(std::memory_order_relaxed)) return nullptr;
    auto b = std::make_unique<SpanBuf>();
    b->kind = kind;
    b->tid = (int64_t)syscall(SYS_gettid);
    std::lock_guard<std::mutex> lk(mu);
    bufs.push_back(std::move(b));
    return bufs.back().get();
  }

  void add_span(SpanBuf* sb, int64_t t0, int64_t t1, int64_t a, int64_t b) {
    const int64_t i = sb->n.load(std::memory_order_relaxed);
    if (i == SpanBuf::CAP) {
      dropped.fetch_add(1, std::memory_order_relaxed);
      return;
    }
    SpanEvent& e = sb->ev[i];
    e.t0.store(t0, std::memory_order_relaxed);
    e.t1.store(t1, std::memory_order_relaxed);
    e.a.store(a, std::memory_order_relaxed);
    e.b.store(b, std::memory_order_relaxed);
    sb->n.store(i + 1, std::memory_order_release);
  }

  // one inflated block: its time and bytes, and (tracing) its stretch
  void inflated(SpanBuf* sb, int64_t t0, int64_t t1, int64_t bytes) {
    inflate_ns.fetch_add(t1 - t0, std::memory_order_relaxed);
    inflate_out_bytes.fetch_add(bytes, std::memory_order_relaxed);
    if (!sb) return;
    const int64_t n = sb->n.load(std::memory_order_relaxed);
    if (n > 0) {
      SpanEvent& last = sb->ev[n - 1];
      if (t0 - last.t1.load(std::memory_order_relaxed) < SPAN_MERGE_NS) {
        last.t1.store(t1, std::memory_order_relaxed);
        last.a.fetch_add(1, std::memory_order_relaxed);
        last.b.fetch_add(bytes, std::memory_order_relaxed);
        return;
      }
    }
    add_span(sb, t0, t1, 1, bytes);
  }
};

// ------------------------------------------------- multithreaded BGZF decode
//
// BGZF blocks are independent deflate members, so sequential whole-file scans
// (extract's dominant access pattern; the frag-hist pre-pass) can inflate
// blocks on a worker pool ahead of the consumer — the htslib bgzf_mt
// equivalent. Random access (BAI chunk hops) bypasses this and stays on the
// synchronous path.

struct MtBlock {
  int64_t addr = -1;
  int64_t next_addr = 0;
  int ulen = 0;
  bool eof = false;
  std::string err;
  std::unique_ptr<uint8_t[]> data;  // BGZF_MAX_BLOCK when !eof
};

struct BgzfMT {
  FILE* fp = nullptr;  // private stream (independent of the sync reader's)
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_done, cv_space;
  int64_t read_addr = 0;
  bool reader_eof = false;
  bool stopping = false;
  std::map<int64_t, MtBlock> done;
  int inflight = 0;
  size_t max_ahead = 64;  // blocks (64 x 64KB = 4MB window)
  std::shared_ptr<IoCounters> ctr;  // may be null: nothing is counted

  ~BgzfMT() { stop(); }

  // the blocks held, inflated or inflating, each counted at its output
  // buffer and its map entry (caller holds mu)
  void note_ahead() {
    if (ctr)
      ctr->ahead_bytes.store(
          (int64_t)(done.size() + inflight) * (BGZF_MAX_BLOCK + sizeof(MtBlock)),
          std::memory_order_relaxed);
  }

  bool start(const char* path, int64_t start_addr, int threads,
             std::shared_ptr<IoCounters> counters) {
    fp = fopen(path, "rb");
    if (!fp) return false;
    ctr = std::move(counters);
    if (ctr && threads > ctr->inflate_workers.load(std::memory_order_relaxed))
      ctr->inflate_workers.store(threads, std::memory_order_relaxed);
    read_addr = start_addr;
    fseeko(fp, start_addr, SEEK_SET);
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
    if (ctr) ctr->ahead_bytes.store(0, std::memory_order_relaxed);
  }

  // read the compressed payload of one block at the current file position
  // (caller holds mu). Returns false on EOF or error.
  bool read_raw(int64_t addr, std::vector<uint8_t>* cdata, int* bsize,
                std::string* err, bool* at_eof) {
    uint8_t hdr[12];
    size_t n = fread(hdr, 1, 12, fp);
    if (n == 0) { *at_eof = true; return false; }
    if (n < 12 || hdr[0] != 0x1f || hdr[1] != 0x8b) {
      *err = "bad BGZF block header";
      return false;
    }
    int xlen = hdr[10] | (hdr[11] << 8);
    std::vector<uint8_t> extra(xlen);
    if (xlen && fread(extra.data(), 1, xlen, fp) != (size_t)xlen) {
      *err = "truncated BGZF extra";
      return false;
    }
    int bs = -1;
    for (int i = 0; i + 4 <= xlen;) {
      int slen = extra[i + 2] | (extra[i + 3] << 8);
      if (extra[i] == 'B' && extra[i + 1] == 'C' && slen == 2) {
        bs = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
        break;
      }
      i += 4 + slen;
    }
    if (bs < 0) { *err = "no BSIZE in BGZF block"; return false; }
    int cdata_len = bs - 12 - xlen - 8;
    if (cdata_len < 0) { *err = "bad BSIZE"; return false; }
    cdata->resize(cdata_len + 8);
    if (fread(cdata->data(), 1, cdata_len + 8, fp) != (size_t)(cdata_len + 8)) {
      *err = "truncated BGZF block";
      return false;
    }
    *bsize = bs;
    (void)addr;
    return true;
  }

  void worker() {
    libdeflate_decompressor* dec = libdeflate_alloc_decompressor();
    SpanBuf* sb = nullptr;  // made at the first block this worker inflates
    for (;;) {
      int64_t addr;
      std::vector<uint8_t> cdata;
      int bsize = 0;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stopping ||
                 (!reader_eof && done.size() + (size_t)inflight < max_ahead);
        });
        if (stopping) break;
        addr = read_addr;
        std::string lerr;
        bool at_eof = false;
        if (!read_raw(addr, &cdata, &bsize, &lerr, &at_eof)) {
          MtBlock b;
          b.addr = addr;
          b.eof = at_eof;
          b.err = lerr;
          reader_eof = true;
          done[addr] = std::move(b);
          cv_done.notify_all();
          continue;
        }
        read_addr = addr + bsize;
        inflight++;
        note_ahead();
      }
      MtBlock b;
      b.addr = addr;
      b.next_addr = addr + bsize;
      b.data.reset(new uint8_t[BGZF_MAX_BLOCK]);
      uint32_t isize;
      memcpy(&isize, cdata.data() + cdata.size() - 4, 4);
      size_t actual = 0;
      if (isize > 0) {
        if (ctr && !sb) sb = ctr->span_buf(SPAN_INFLATE);
        const int64_t t0 = ctr ? now_ns() : 0;
        auto r = libdeflate_deflate_decompress(dec, cdata.data(),
                                               cdata.size() - 8, b.data.get(),
                                               BGZF_MAX_BLOCK, &actual);
        if (ctr) ctr->inflated(sb, t0, now_ns(), (int64_t)actual);
        if (r != LIBDEFLATE_SUCCESS) b.err = "inflate failed";
      }
      if (b.err.empty() && actual != isize) b.err = "BGZF ISIZE mismatch";
      b.ulen = (int)isize;
      {
        std::lock_guard<std::mutex> lk(mu);
        inflight--;
        done[addr] = std::move(b);
        note_ahead();
      }
      cv_done.notify_all();
    }
    libdeflate_free_decompressor(dec);
  }

  // blocking fetch of the block at `addr` (must lie on the sequential chain
  // from start_addr). Returns false only on decode error. The time it blocks
  // counts as the reading thread's block wait.
  bool get(int64_t addr, MtBlock* out) {
    std::unique_lock<std::mutex> lk(mu);
    int64_t t0 = 0;  // set once it has to wait
    for (;;) {
      auto it = done.find(addr);
      const bool past_end = it == done.end() && reader_eof && inflight == 0 &&
                            (done.empty() || done.begin()->first > addr);
      if (it != done.end() || past_end) {
        if (t0 && ctr)
          ctr->block_wait_ns.fetch_add(now_ns() - t0,
                                       std::memory_order_relaxed);
        if (past_end) {
          out->addr = addr;
          out->eof = true;
          out->err.clear();
          return true;
        }
        *out = std::move(it->second);
        done.erase(it);
        // drop anything stale before addr (can't happen in-order, but safe)
        while (!done.empty() && done.begin()->first < addr)
          done.erase(done.begin());
        note_ahead();
        cv_space.notify_all();
        return out->err.empty();
      }
      if (!t0 && ctr) t0 = now_ns();
      cv_done.wait(lk);
    }
  }
};

struct BgzfReader {
  FILE* fp = nullptr;
  libdeflate_decompressor* dec = nullptr;
  // current decompressed block
  uint8_t ubuf[BGZF_MAX_BLOCK];
  int ulen = 0;
  int upos = 0;
  int64_t block_addr = 0;  // compressed offset of current block
  bool have_block = false;  // ubuf holds the decoded block at block_addr
  int64_t next_addr = 0;   // compressed offset of next block
  bool eof = false;
  std::string err;
  std::string path_;
  BgzfMT* mt = nullptr;
  std::shared_ptr<IoCounters> ctr;  // an extract engine's, while it reads

  ~BgzfReader() {
    delete mt;
    if (fp) fclose(fp);
    if (dec) libdeflate_free_decompressor(dec);
  }

  bool open(const char* path) {
    path_ = path;
    fp = fopen(path, "rb");
    if (!fp) { err = "cannot open file"; return false; }
    dec = libdeflate_alloc_decompressor();
    return load_block(0);
  }

  void disable_mt() {
    delete mt;
    mt = nullptr;
  }

  // start worker-pool block prefetch from the current stream position; used
  // by sequential whole-file scans. Any out-of-chain seek falls back to the
  // synchronous path automatically.
  void enable_mt(int threads) {
    disable_mt();
    if (threads <= 0) return;
    BgzfMT* m = new BgzfMT();
    if (!m->start(path_.c_str(), next_addr, threads, ctr)) {
      delete m;
      return;
    }
    mt = m;
  }

  // load the BGZF block at compressed offset `addr`
  bool load_block(int64_t addr) {
    if (mt) {
      if (addr != next_addr) {
        disable_mt();  // random access: back to the synchronous reader
      } else {
        MtBlock b;
        if (!mt->get(addr, &b)) { err = b.err; return false; }
        block_addr = addr;
        upos = 0;
        if (b.eof) {
          eof = true;
          ulen = 0;
          return true;
        }
        ulen = b.ulen;
        next_addr = b.next_addr;
        if (ulen == 0) return load_block(next_addr);  // empty/EOF-marker block
        memcpy(ubuf, b.data.get(), ulen);
        have_block = true;
        return true;
      }
    }
    return load_block_sync(addr);
  }

  bool load_block_sync(int64_t addr) {
    if (fseeko(fp, addr, SEEK_SET) != 0) { err = "seek failed"; return false; }
    uint8_t hdr[18];
    size_t n = fread(hdr, 1, 18, fp);
    if (n == 0) {
      eof = true; ulen = upos = 0; block_addr = addr; have_block = false;
      return true;
    }
    if (n < 18 || hdr[0] != 0x1f || hdr[1] != 0x8b) {
      err = "bad BGZF block header"; return false;
    }
    int xlen = hdr[10] | (hdr[11] << 8);
    // find BC subfield for BSIZE
    std::vector<uint8_t> extra(xlen);
    if (xlen > 6) {
      memcpy(extra.data(), hdr + 12, 6);
      if (fread(extra.data() + 6, 1, xlen - 6, fp) != size_t(xlen - 6)) {
        err = "truncated BGZF extra"; return false;
      }
    } else {
      memcpy(extra.data(), hdr + 12, xlen);
      if (xlen < 6) { err = "missing BSIZE"; return false; }
      // rewind the over-read header bytes
      fseeko(fp, addr + 12 + xlen, SEEK_SET);
    }
    int bsize = -1;
    for (int i = 0; i + 4 <= xlen;) {
      int si1 = extra[i], si2 = extra[i + 1];
      int slen = extra[i + 2] | (extra[i + 3] << 8);
      if (si1 == 'B' && si2 == 'C' && slen == 2) {
        bsize = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
        break;
      }
      i += 4 + slen;
    }
    if (bsize < 0) { err = "no BSIZE in BGZF block"; return false; }
    int cdata_len = bsize - xlen - 19 - 1;  // minus fixed hdr(12)+xlen+crc(4)+isize(4) => 12+xlen+cdata+8
    cdata_len = bsize - 12 - xlen - 8;
    std::vector<uint8_t> cdata(cdata_len + 8);
    if (fseeko(fp, addr + 12 + xlen, SEEK_SET) != 0) { err = "seek"; return false; }
    if (fread(cdata.data(), 1, cdata_len + 8, fp) != size_t(cdata_len + 8)) {
      err = "truncated BGZF block"; return false;
    }
    uint32_t isize;
    memcpy(&isize, cdata.data() + cdata_len + 4, 4);
    size_t actual = 0;
    if (isize > 0) {
      const int64_t t0 = ctr ? now_ns() : 0;
      auto r = libdeflate_deflate_decompress(dec, cdata.data(), cdata_len,
                                             ubuf, BGZF_MAX_BLOCK, &actual);
      if (ctr) {
        const int64_t t1 = now_ns();
        ctr->inflated(nullptr, t0, t1, (int64_t)actual);
        ctr->block_wait_ns.fetch_add(t1 - t0, std::memory_order_relaxed);
      }
      if (r != LIBDEFLATE_SUCCESS) { err = "inflate failed"; return false; }
    }
    if (actual != isize) { err = "BGZF ISIZE mismatch"; return false; }
    ulen = (int)isize;
    upos = 0;
    block_addr = addr;
    have_block = true;
    next_addr = addr + bsize;
    if (ulen == 0) {
      // could be the EOF marker block or an empty block mid-file; peek on
      int64_t save = next_addr;
      // detect physical EOF
      if (fseeko(fp, save, SEEK_SET) == 0) {
        int c = fgetc(fp);
        if (c == EOF) { eof = true; return true; }
        ungetc(c, fp);
        return load_block(save);
      }
      eof = true;
    }
    return true;
  }

  // virtual offset of the next byte to be read
  int64_t tell() const { return (block_addr << 16) | (upos & 0xffff); }

  bool seek_virtual(int64_t voff) {
    int64_t addr = voff >> 16;
    int off = voff & 0xffff;
    eof = false;
    // current-block fast path: successive region queries frequently land in
    // the block already decoded (file-adjacent loci share BGZF blocks —
    // the per-locus support collection is the hot caller), so skip the
    // seek + re-inflate when the target block is resident
    if (!mt && have_block && addr == block_addr && ulen > 0) {
      if (off > ulen) { err = "virtual offset beyond block"; return false; }
      upos = off;
      return true;
    }
    if (!load_block(addr)) return false;
    if (off > ulen) { err = "virtual offset beyond block"; return false; }
    upos = off;
    return true;
  }

  // read exactly n bytes; returns bytes read (< n only at EOF)
  int64_t read(uint8_t* dst, int64_t n) {
    int64_t got = 0;
    while (got < n) {
      if (upos >= ulen) {
        if (eof) break;
        if (!load_block(next_addr)) return -1;
        if (eof) break;
        continue;
      }
      int64_t take = std::min<int64_t>(n - got, ulen - upos);
      memcpy(dst + got, ubuf + upos, take);
      upos += (int)take;
      got += take;
    }
    return got;
  }
};

// ------------------------------------------------------------------ BAI index

struct Chunk { uint64_t beg, end; };

struct RefIndex {
  // bin id -> chunks
  std::vector<std::pair<uint32_t, std::vector<Chunk>>> bins;
  std::vector<uint64_t> ioffsets;  // 16kb linear index
};

struct BaiIndex {
  std::vector<RefIndex> refs;
  uint64_t n_no_coor = 0;
  uint64_t max_chunk_end = 0;  // used as the start point for the no-coor scan
  bool loaded = false;

  bool load(const std::string& path) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return false;
    char magic[4];
    if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "BAI\1", 4) != 0) {
      fclose(f);
      return false;
    }
    int32_t n_ref;
    if (fread(&n_ref, 4, 1, f) != 1) { fclose(f); return false; }
    refs.resize(n_ref);
    for (int r = 0; r < n_ref; r++) {
      int32_t n_bin;
      if (fread(&n_bin, 4, 1, f) != 1) { fclose(f); return false; }
      for (int b = 0; b < n_bin; b++) {
        uint32_t bin;
        int32_t n_chunk;
        fread(&bin, 4, 1, f);
        if (fread(&n_chunk, 4, 1, f) != 1) { fclose(f); return false; }
        std::vector<Chunk> chunks(n_chunk);
        if (n_chunk && fread(chunks.data(), 16, n_chunk, f) != size_t(n_chunk)) {
          fclose(f); return false;
        }
        if (bin == 37450) continue;  // pseudo-bin metadata
        for (auto& c : chunks) max_chunk_end = std::max(max_chunk_end, c.end);
        refs[r].bins.emplace_back(bin, std::move(chunks));
      }
      int32_t n_intv;
      if (fread(&n_intv, 4, 1, f) != 1) { fclose(f); return false; }
      refs[r].ioffsets.resize(n_intv);
      if (n_intv &&
          fread(refs[r].ioffsets.data(), 8, n_intv, f) != size_t(n_intv)) {
        fclose(f); return false;
      }
    }
    if (fread(&n_no_coor, 8, 1, f) != 1) n_no_coor = 0;
    fclose(f);
    loaded = true;
    return true;
  }
};

// bins overlapping [beg, end), BAI 6-level scheme
static void reg2bins(int64_t beg, int64_t end, std::vector<uint32_t>* bins) {
  if (beg >= end) return;
  end--;
  bins->push_back(0);
  for (int l = 1, sh = 26, off = 1; l <= 5; l++, sh -= 3) {
    for (int64_t k = off + (beg >> sh); k <= off + (end >> sh); k++)
      bins->push_back((uint32_t)k);
    off = off * 8 + 1;
  }
}

// --------------------------------------------------------------- BAM records

struct BamRec {
  int32_t tid, pos;
  uint16_t flag, n_cigar;
  uint8_t mapq;
  int32_t l_seq, mate_tid, mate_pos, isize;
  std::string qname;
  std::vector<uint32_t> cigar;
  std::vector<uint8_t> seq4;  // packed 4-bit
};

static const char SEQ_NT16[] = "=ACMGRSVTWYHKDBN";
static const char CIGAR_OPS[] = "MIDNSHP=X";

struct BamFile {
  BgzfReader bgzf;
  std::string header_text;
  std::vector<std::string> ref_names;
  std::vector<int64_t> ref_lens;
  int64_t first_rec_voff = 0;
  BaiIndex bai;
  std::string err;

  bool open(const char* path) {
    if (!bgzf.open(path)) { err = bgzf.err; return false; }
    uint8_t magic[4];
    if (bgzf.read(magic, 4) != 4 || memcmp(magic, "BAM\1", 4) != 0) {
      err = "not a BAM file"; return false;
    }
    int32_t l_text;
    bgzf.read((uint8_t*)&l_text, 4);
    header_text.resize(l_text);
    bgzf.read((uint8_t*)header_text.data(), l_text);
    // trim trailing NULs (htslib's sam_hdr_str does not include them)
    while (!header_text.empty() && header_text.back() == '\0')
      header_text.pop_back();
    int32_t n_ref;
    bgzf.read((uint8_t*)&n_ref, 4);
    for (int i = 0; i < n_ref; i++) {
      int32_t l_name, l_ref;
      bgzf.read((uint8_t*)&l_name, 4);
      std::string name(l_name, '\0');
      bgzf.read((uint8_t*)name.data(), l_name);
      if (!name.empty() && name.back() == '\0') name.pop_back();
      bgzf.read((uint8_t*)&l_ref, 4);
      ref_names.push_back(name);
      ref_lens.push_back(l_ref);
    }
    first_rec_voff = bgzf.tell();
    std::string bp = std::string(path) + ".bai";
    if (!bai.load(bp)) {
      // also try replacing .bam with .bai
      std::string p2(path);
      auto dot = p2.rfind(".bam");
      if (dot != std::string::npos) bai.load(p2.substr(0, dot) + ".bai");
    }
    return true;
  }

  std::vector<uint8_t> recbuf;  // per-record scratch (reused across calls)
  // light parse: fixed 32-byte header only (tid/pos/flag/mapq/l_seq/mate/
  // isize); qname/cigar/seq are left empty. Used by the frag-hist pre-pass
  // (utils.nim:86-111 needs only flag+isize+l_seq) — sequential mode only,
  // since region iteration needs endpos (cigar).
  bool light = false;

  // read one record; returns 1 ok, 0 eof, -1 error
  int next(BamRec* r) {
    int32_t block_size;
    int64_t n = bgzf.read((uint8_t*)&block_size, 4);
    if (n == 0) return 0;
    if (n != 4) { err = "truncated record size"; return -1; }
    if (block_size < 32) { err = "bad record size"; return -1; }
    std::vector<uint8_t>& buf = recbuf;
    if ((int64_t)buf.size() < block_size) buf.resize(block_size);
    if (bgzf.read(buf.data(), block_size) != block_size) {
      err = "truncated record"; return -1;
    }
    const uint8_t* p = buf.data();
    memcpy(&r->tid, p, 4);
    memcpy(&r->pos, p + 4, 4);
    uint8_t l_read_name = p[8];
    r->mapq = p[9];
    memcpy(&r->n_cigar, p + 12, 2);
    memcpy(&r->flag, p + 14, 2);
    uint32_t l_seq;
    memcpy(&l_seq, p + 16, 4);
    r->l_seq = (int32_t)l_seq;
    memcpy(&r->mate_tid, p + 20, 4);
    memcpy(&r->mate_pos, p + 24, 4);
    memcpy(&r->isize, p + 28, 4);
    if (light) {
      r->qname.clear();
      r->cigar.clear();
      r->seq4.clear();
      return 1;
    }
    const uint8_t* q = p + 32;
    r->qname.assign((const char*)q, l_read_name ? l_read_name - 1 : 0);
    q += l_read_name;
    r->cigar.assign((const uint32_t*)q, (const uint32_t*)q + r->n_cigar);
    q += 4 * r->n_cigar;
    r->seq4.assign(q, q + (l_seq + 1) / 2);
    return 1;
  }
};

static int64_t endpos(const BamRec& r) {
  // htslib bam_endpos: pos+1 for unmapped / cigar-less records
  if ((r.flag & 4) || r.cigar.empty()) return r.pos + 1;
  int64_t rlen = 0;
  for (uint32_t c : r.cigar) {
    int op = c & 0xf;
    // M D N = X consume reference
    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) rlen += c >> 4;
  }
  if (rlen == 0) rlen = 1;
  return r.pos + rlen;
}

// ------------------------------------------------------------------ iterator

struct BamIter {
  BamFile* bam;
  // mode 0: whole file; 1: region; 2: no-coor ("*")
  int mode = 0;
  int tid = -1;
  int64_t beg = 0, end = 0;
  std::vector<Chunk> chunks;
  size_t cur_chunk = 0;
  bool primed = false;
  bool done = false;
  std::string err;

  static int bgzf_threads() {
    const char* s = getenv("STRLING_BGZF_THREADS");
    if (s) return atoi(s);
    // adaptive: on small hosts the decode pool oversubscribes the cores the
    // parser/consumer need (measured: 1 worker beats 4 by ~20% on a 2-core
    // VM); big hosts still get parallel decode
    unsigned hw = std::thread::hardware_concurrency();
    if (hw >= 8) return 4;
    if (hw >= 4) return 2;
    return 1;
  }

  bool prime() {
    primed = true;
    if (mode == 0) {
      if (!bam->bgzf.seek_virtual(bam->first_rec_voff)) return false;
      bam->bgzf.enable_mt(bgzf_threads());  // sequential whole-file scan
      return true;
    }
    if (mode == 2) {
      // no-coor block: records sort last; start at the max indexed chunk end
      int64_t start = bam->bai.loaded && bam->bai.max_chunk_end
                          ? (int64_t)bam->bai.max_chunk_end
                          : bam->first_rec_voff;
      if (!bam->bgzf.seek_virtual(start)) return false;
      bam->bgzf.enable_mt(bgzf_threads());  // sequential scan to EOF
      return true;
    }
    // region query via BAI
    if (!bam->bai.loaded) { err = "no .bai index"; return false; }
    if (tid < 0 || tid >= (int)bam->bai.refs.size()) { done = true; return true; }
    const RefIndex& ri = bam->bai.refs[tid];
    std::vector<uint32_t> bins;
    reg2bins(beg, end, &bins);
    uint64_t min_off = 0;
    size_t w = beg >> 14;
    if (w < ri.ioffsets.size()) min_off = ri.ioffsets[w];
    std::vector<Chunk> sel;
    for (auto& bc : ri.bins) {
      if (!std::binary_search(bins.begin(), bins.end(), bc.first)) {
        if (std::find(bins.begin(), bins.end(), bc.first) == bins.end())
          continue;
      }
      for (auto& c : bc.second)
        if (c.end > min_off) sel.push_back(c);
    }
    std::sort(sel.begin(), sel.end(),
              [](const Chunk& a, const Chunk& b) { return a.beg < b.beg; });
    // merge adjacent/overlapping
    for (auto& c : sel) {
      if (!chunks.empty() && c.beg <= chunks.back().end)
        chunks.back().end = std::max(chunks.back().end, c.end);
      else
        chunks.push_back(c);
    }
    cur_chunk = 0;
    if (chunks.empty()) { done = true; return true; }
    return bam->bgzf.seek_virtual((int64_t)chunks[0].beg);
  }

  // next record matching the iterator's filter; 1 ok, 0 end, -1 err
  int next(BamRec* r) {
    if (!primed && !prime()) { err = err.empty() ? bam->bgzf.err : err; return -1; }
    if (done) return 0;
    for (;;) {
      if (mode == 1) {
        // stop at chunk end; hop to next chunk
        while (cur_chunk < chunks.size() &&
               (uint64_t)bam->bgzf.tell() >= chunks[cur_chunk].end) {
          cur_chunk++;
          if (cur_chunk >= chunks.size()) { done = true; return 0; }
          if (!bam->bgzf.seek_virtual((int64_t)chunks[cur_chunk].beg)) {
            err = bam->bgzf.err; return -1;
          }
        }
        if (cur_chunk >= chunks.size()) { done = true; return 0; }
      }
      int rc = bam->next(r);
      if (rc <= 0) { done = true; return rc; }
      if (mode == 0) return 1;
      if (mode == 2) {
        if (r->tid < 0) return 1;
        continue;  // still in the placed tail before the no-coor block
      }
      // region filter
      if (r->tid > tid || (r->tid == tid && r->pos >= end)) { done = true; return 0; }
      if (r->tid != tid) continue;
      if (endpos(*r) > beg && r->pos < end) return 1;
    }
  }
};

// ------------------------------------------------------------ Reader interface
//
// Abstracts BAM vs CRAM behind one record-stream API so the extract engine,
// frag-hist pass and batch iterators work on either container format
// (the reference gets this polymorphism from htslib; extract.nim:275-329).

struct Reader {
  std::string err;
  virtual ~Reader() = default;
  virtual const std::string& header_text() = 0;
  virtual const std::vector<std::string>& ref_names() = 0;
  virtual const std::vector<int64_t>& ref_lens() = 0;
  virtual bool has_index() = 0;
  // CRAM needs the reference FASTA for sequence reconstruction; no-op for BAM
  virtual bool set_fasta(const char* /*path*/) { return true; }
  // mode 0 = whole file, 1 = region [beg,end) on tid, 2 = no-coor ("*")
  virtual bool begin(int mode, int tid, int64_t beg, int64_t end) = 0;
  virtual int next(BamRec* r) = 0;  // 1 ok, 0 end, -1 error
  // fixed-header-only parsing for sequential stat passes (no-op by default)
  virtual void set_light(bool) {}
  // where to count the inflate work: BGZF (BAM) input counts it, CRAM and
  // SAM text count none
  virtual void set_counters(std::shared_ptr<IoCounters>) {}
};

struct BamReader : Reader {
  BamFile bam;
  BamIter it;

  bool open(const char* path) {
    if (!bam.open(path)) { err = bam.err; return false; }
    return true;
  }
  const std::string& header_text() override { return bam.header_text; }
  const std::vector<std::string>& ref_names() override { return bam.ref_names; }
  const std::vector<int64_t>& ref_lens() override { return bam.ref_lens; }
  bool has_index() override { return bam.bai.loaded; }
  bool begin(int mode, int tid, int64_t beg, int64_t end) override {
    it = BamIter();
    it.bam = &bam;
    it.mode = mode;
    it.tid = tid;
    it.beg = beg;
    it.end = end;
    return true;
  }
  int next(BamRec* r) override {
    int rc = it.next(r);
    if (rc < 0) err = it.err.empty() ? bam.err : it.err;
    return rc;
  }
  void set_light(bool v) override { bam.light = v; }
  void set_counters(std::shared_ptr<IoCounters> c) override {
    bam.bgzf.ctr = std::move(c);
  }
};

// implemented in cram.cc / samtext.cc
Reader* open_cram(const char* path);
Reader* open_sam(const char* path);

struct Handle {
  Reader* rd = nullptr;
  ~Handle() { delete rd; }
};

// CIGAR summary + batch fill shared by all iterators
struct BatchOut {
  int32_t *tid, *pos, *mate_tid, *mate_pos, *isize, *read_len, *end_pos;
  int32_t *lclip, *rclip, *ins_sum, *del_sum;
  uint16_t* flag;
  uint8_t *mapq, *seq;
  uint32_t* cigar_buf;
  int64_t cigar_cap;
  int64_t* cigar_off;
  char* qname_buf;
  int64_t qname_cap;
  int64_t* qname_off;
};

}  // namespace sio
