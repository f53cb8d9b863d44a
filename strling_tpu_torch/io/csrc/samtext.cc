// samtext.cc — plain-text SAM reader behind the sio::Reader interface.
//
// The reference accepts SAM/BAM/CRAM interchangeably because htslib
// auto-detects the container (extract.nim:275 just calls open). This covers
// the SAM leg: header parsing, sequential record streaming, and the no-coor
// scan. Region queries are rejected (SAM text has no index — htslib behaves
// the same).

#include "strling_io.h"

#include <zlib.h>

namespace {

using sio::BamRec;
using sio::Reader;

// BAM 4-bit code for an ASCII base
static uint8_t nt16(char c) {
  static const char* order = "=ACMGRSVTWYHKDBN";
  for (int i = 0; i < 16; i++)
    if (order[i] == toupper((unsigned char)c)) return (uint8_t)i;
  return 15;
}

// text source: plain file or gzip/BGZF stream (zlib auto-detect, windowBits
// 15+32, multi-member via inflateReset — htslib reads .sam.gz the same way)
struct LineSource {
  FILE* fp = nullptr;
  bool gz = false;
  z_stream zs{};
  bool zinit = false;
  std::vector<uint8_t> inbuf;
  std::vector<char> outbuf;
  size_t opos = 0, olen = 0;
  bool in_eof = false;
  bool member_done = true;   // at a gzip member boundary
  bool truncated = false;    // input ended mid-member

  ~LineSource() { close(); }

  void close() {
    if (zinit) {
      inflateEnd(&zs);
      zinit = false;
    }
    if (fp) {
      fclose(fp);
      fp = nullptr;
    }
  }

  bool open(const char* path) {
    close();
    fp = fopen(path, "rb");
    if (!fp) return false;
    uint8_t magic[2] = {0, 0};
    size_t n = fread(magic, 1, 2, fp);
    gz = n == 2 && magic[0] == 0x1f && magic[1] == 0x8b;
    fseeko(fp, 0, SEEK_SET);
    if (gz) {
      memset(&zs, 0, sizeof zs);
      if (inflateInit2(&zs, 15 + 32) != Z_OK) return false;
      zinit = true;
      inbuf.resize(1 << 16);
      outbuf.resize(1 << 16);
      opos = olen = 0;
      in_eof = false;
    }
    consumed = 0;
    return true;
  }

  void rewind_to(int64_t off) {
    // plain files seek; gzip streams restart and re-inflate (header is
    // consumed once per begin(); SAM scans are sequential)
    if (!gz) {
      fseeko(fp, off, SEEK_SET);
      consumed = off;
      return;
    }
    fseeko(fp, 0, SEEK_SET);
    inflateReset2(&zs, 15 + 32);
    zs.avail_in = 0;
    opos = olen = 0;
    in_eof = false;
    member_done = true;
    truncated = false;
    consumed = 0;
    skip_bytes = off;
  }

  int64_t skip_bytes = 0;  // decompressed bytes to discard after rewind

  // refill outbuf; returns false at stream end
  bool refill() {
    if (!gz) return false;
    opos = 0;
    olen = 0;
    while (olen == 0) {
      if (zs.avail_in == 0 && !in_eof) {
        size_t got = fread(inbuf.data(), 1, inbuf.size(), fp);
        zs.next_in = inbuf.data();
        zs.avail_in = (uInt)got;
        if (got == 0) in_eof = true;
      }
      if (in_eof && zs.avail_in == 0) return false;
      zs.next_out = (Bytef*)outbuf.data();
      zs.avail_out = (uInt)outbuf.size();
      int rc = inflate(&zs, Z_NO_FLUSH);
      olen = outbuf.size() - zs.avail_out;
      if (olen > 0 || zs.avail_in > 0 || !in_eof) member_done = false;
      if (rc == Z_STREAM_END) {
        member_done = true;
        // multi-member (BGZF): continue with the next member
        if (inflateReset2(&zs, 15 + 32) != Z_OK) in_eof = true;
      } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
        truncated = true;  // corrupt stream
        return olen > 0;
      }
      if (in_eof && zs.avail_in == 0 && olen == 0) {
        if (!member_done) truncated = true;
        return false;
      }
    }
    return true;
  }

  int64_t consumed = 0;  // decompressed bytes delivered so far

  // read one byte; -1 at EOF
  int getc_() {
    int c;
    if (!gz) {
      c = fgetc(fp);
    } else {
      while (opos >= olen) {
        if (!refill()) return -1;
      }
      c = (unsigned char)outbuf[opos++];
    }
    if (c >= 0) consumed++;
    return c;
  }

  bool getline(std::vector<char>* line) {
    line->clear();
    while (skip_bytes > 0) {
      if (getc_() < 0) return false;
      skip_bytes--;
    }
    int c;
    while ((c = getc_()) >= 0) {
      if (c == '\n') break;
      line->push_back((char)c);
    }
    if (c < 0 && line->empty()) return false;
    while (!line->empty() && line->back() == '\r') line->pop_back();
    line->push_back('\0');
    return true;
  }

};

struct SamReader : Reader {
  LineSource src;
  std::string hdr_text;
  std::vector<std::string> names;
  std::vector<int64_t> lens;
  std::map<std::string, int> name2tid;
  int64_t first_rec_off = 0;  // plain: file offset; gz: decompressed offset
  int mode = 0;
  bool iter_done = false;
  std::vector<char> line;

  const std::string& header_text() override { return hdr_text; }
  const std::vector<std::string>& ref_names() override { return names; }
  const std::vector<int64_t>& ref_lens() override { return lens; }
  bool has_index() override { return false; }

  bool getline() { return src.getline(&line); }

  bool open(const char* path) {
    if (!src.open(path)) { err = "cannot open file"; return false; }
    // header lines; track the (decompressed) offset of the first record
    int64_t off = 0;
    while (true) {
      off = src.consumed;
      if (!getline()) break;
      if (line[0] != '@') break;
      hdr_text.append(line.data());
      hdr_text.push_back('\n');
      if (strncmp(line.data(), "@SQ", 3) == 0) {
        std::string sn;
        int64_t ln = 0;
        char* save = nullptr;
        for (char* tok = strtok_r(line.data(), "\t", &save); tok;
             tok = strtok_r(nullptr, "\t", &save)) {
          if (strncmp(tok, "SN:", 3) == 0) sn = tok + 3;
          if (strncmp(tok, "LN:", 3) == 0) ln = atoll(tok + 3);
        }
        if (!sn.empty()) {
          name2tid[sn] = (int)names.size();
          names.push_back(sn);
          lens.push_back(ln);
        }
      }
    }
    first_rec_off = off;
    return true;
  }

  bool begin(int m, int tid, int64_t beg, int64_t end) override {
    (void)tid; (void)beg; (void)end;
    if (m == 1) {
      err = "region queries require an indexed BAM/CRAM (SAM text has no index)";
      return false;
    }
    mode = m;
    iter_done = false;
    src.rewind_to(first_rec_off);
    return true;
  }

  int tid_of(const char* rname, int self_tid) {
    if (strcmp(rname, "*") == 0) return -1;
    if (strcmp(rname, "=") == 0) return self_tid;
    auto it = name2tid.find(rname);
    return it == name2tid.end() ? -1 : it->second;
  }

  int next(BamRec* r) override {
    for (;;) {
      if (iter_done) return 0;
      if (!getline()) {
        if (src.truncated) {
          err = "truncated gzip stream in SAM input";
          return -1;
        }
        iter_done = true;
        return 0;
      }
      if (line[0] == '@' || line[0] == '\0') continue;
      // split 11 mandatory fields (aux ignored)
      char* f[12] = {nullptr};
      char* save = nullptr;
      int nf = 0;
      for (char* tok = strtok_r(line.data(), "\t", &save); tok && nf < 12;
           tok = strtok_r(nullptr, "\t", &save))
        f[nf++] = tok;
      if (nf < 11) { err = "truncated SAM record"; return -1; }
      r->qname = f[0];
      r->flag = (uint16_t)atoi(f[1]);
      r->tid = tid_of(f[2], -1);
      r->pos = atoll(f[3]) - 1;
      r->mapq = (uint8_t)atoi(f[4]);
      r->cigar.clear();
      if (strcmp(f[5], "*") != 0) {
        int64_t num = 0;
        for (const char* p = f[5]; *p; p++) {
          if (*p >= '0' && *p <= '9') {
            num = num * 10 + (*p - '0');
          } else {
            const char* ops = "MIDNSHP=X";
            const char* o = strchr(ops, *p);
            if (!o) { err = "bad CIGAR op in SAM"; return -1; }
            r->cigar.push_back((uint32_t)((num << 4) | (o - ops)));
            num = 0;
          }
        }
      }
      r->n_cigar = (uint16_t)r->cigar.size();
      r->mate_tid = tid_of(f[6], r->tid);
      r->mate_pos = atoll(f[7]) - 1;
      r->isize = atoi(f[8]);
      const char* seq = f[9];
      if (strcmp(seq, "*") == 0) {
        r->l_seq = 0;
        r->seq4.clear();
      } else {
        size_t L = strlen(seq);
        r->l_seq = (int32_t)L;
        r->seq4.assign((L + 1) / 2, 0);
        for (size_t i = 0; i < L; i++) {
          uint8_t nib = nt16(seq[i]);
          r->seq4[i >> 1] |= (i & 1) ? nib : (uint8_t)(nib << 4);
        }
      }
      if (mode == 2 && r->tid >= 0) continue;  // no-coor scan
      return 1;
    }
  }
};

}  // namespace

namespace sio {

Reader* open_sam(const char* path) {
  SamReader* r = new SamReader();
  if (!r->open(path)) {
    delete r;
    return nullptr;
  }
  return r;
}

}  // namespace sio
