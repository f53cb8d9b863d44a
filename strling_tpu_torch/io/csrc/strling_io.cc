#include "strling_io.h"

#include <zlib.h>

using namespace sio;

namespace {

// detect container format: raw "CRAM"; gzip wrapping either BAM or SAM text
// (peek the decompressed head); plain-text SAM ('@' header or a
// tab-separated record line); else BAM
enum Fmt { FMT_BAM, FMT_CRAM, FMT_SAM };

Fmt classify_text(const unsigned char* buf, size_t n) {
  if (n > 0 && buf[0] == '@') return FMT_SAM;
  size_t tabs = 0;
  for (size_t i = 0; i < n && buf[i] != '\n'; i++) {
    if (buf[i] == '\t') tabs++;
    if (buf[i] == 0) return FMT_BAM;  // binary
  }
  return tabs >= 10 ? FMT_SAM : FMT_BAM;
}

Fmt sniff(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return FMT_BAM;
  unsigned char buf[1 << 15];
  size_t n = fread(buf, 1, sizeof buf, f);
  fclose(f);
  if (n >= 4 && memcmp(buf, "CRAM", 4) == 0) return FMT_CRAM;
  if (n >= 2 && buf[0] == 0x1f && buf[1] == 0x8b) {
    // gzip: peek the decompressed head ("BAM\1" vs SAM text)
    unsigned char peek[64] = {0};
    z_stream zs;
    memset(&zs, 0, sizeof zs);
    if (inflateInit2(&zs, 15 + 32) != Z_OK) return FMT_BAM;
    zs.next_in = buf;
    zs.avail_in = (uInt)n;
    zs.next_out = peek;
    zs.avail_out = sizeof peek;
    int rc = inflate(&zs, Z_NO_FLUSH);
    size_t got = sizeof peek - zs.avail_out;
    inflateEnd(&zs);
    if ((rc == Z_OK || rc == Z_STREAM_END || rc == Z_BUF_ERROR) && got >= 4) {
      if (memcmp(peek, "BAM\1", 4) == 0) return FMT_BAM;
      return classify_text(peek, got);
    }
    return FMT_BAM;
  }
  return classify_text(buf, n);
}

}  // namespace

extern "C" {

void* sio_open(const char* path) {
  Handle* h = new Handle();
  Fmt fmt = sniff(path);
  if (fmt == FMT_CRAM) {
    h->rd = open_cram(path);
  } else if (fmt == FMT_SAM) {
    h->rd = open_sam(path);
  } else {
    BamReader* br = new BamReader();
    if (!br->open(path)) {
      delete br;
      br = nullptr;
    }
    h->rd = br;
  }
  if (!h->rd) {
    delete h;
    return nullptr;
  }
  return h;
}

// attach the reference FASTA (required to decode reference-based CRAM)
int sio_set_fasta(void* vh, const char* path) {
  return ((Handle*)vh)->rd->set_fasta(path) ? 0 : -1;
}

void sio_close(void* vh) { delete (Handle*)vh; }

int sio_nrefs(void* vh) {
  return (int)((Handle*)vh)->rd->ref_names().size();
}

int64_t sio_ref_len(void* vh, int i) { return ((Handle*)vh)->rd->ref_lens()[i]; }

int sio_ref_name(void* vh, int i, char* buf, int cap) {
  const std::string& s = ((Handle*)vh)->rd->ref_names()[i];
  int n = (int)std::min<size_t>(s.size(), cap - 1);
  memcpy(buf, s.data(), n);
  buf[n] = 0;
  return (int)s.size();
}

int64_t sio_header_text(void* vh, char* buf, int64_t cap) {
  const std::string& s = ((Handle*)vh)->rd->header_text();
  if (buf && cap > 0) {
    int64_t n = std::min<int64_t>((int64_t)s.size(), cap);
    memcpy(buf, s.data(), n);
  }
  return (int64_t)s.size();
}

int sio_has_index(void* vh) { return ((Handle*)vh)->rd->has_index() ? 1 : 0; }

// start an iterator on this handle. mode: 0=all, 1=region(tid,beg,end), 2="*"
int sio_begin(void* vh, int mode, int tid, int64_t beg, int64_t end) {
  Handle* h = (Handle*)vh;
  return h->rd->begin(mode, tid, beg, end) ? 0 : -1;
}

// Fill a batch of up to `cap` records. Returns count (0 = iterator end, -1 =
// error). Sequences are ASCII-expanded and truncated to Lmax bytes.
int64_t sio_next_batch(void* vh, int64_t cap, int Lmax, int32_t* tid,
                       int32_t* pos, uint16_t* flag, uint8_t* mapq,
                       int32_t* mate_tid, int32_t* mate_pos, int32_t* isize,
                       int32_t* read_len, int32_t* end_pos, int32_t* lclip,
                       int32_t* rclip, int32_t* ins_sum, int32_t* del_sum,
                       uint8_t* seq, uint32_t* cigar_buf, int64_t cigar_cap,
                       int64_t* cigar_off, char* qname_buf, int64_t qname_cap,
                       int64_t* qname_off) {
  Handle* h = (Handle*)vh;
  BamRec r;
  int64_t n = 0;
  int64_t coff = 0, qoff = 0;
  cigar_off[0] = 0;
  qname_off[0] = 0;
  while (n < cap) {
    // capacity check for variable-length blobs: peek-free, so require space
    // for a worst-case record before reading
    if (coff + 65535 > cigar_cap || qoff + 256 > qname_cap) break;
    int rc = h->rd->next(&r);
    if (rc < 0) return -1;
    if (rc == 0) break;
    tid[n] = r.tid;
    pos[n] = r.pos;
    flag[n] = r.flag;
    mapq[n] = r.mapq;
    mate_tid[n] = r.mate_tid;
    mate_pos[n] = r.mate_pos;
    isize[n] = r.isize;
    read_len[n] = r.l_seq;
    end_pos[n] = (int32_t)endpos(r);
    int32_t lc = 0, rcl = 0, ins = 0, del = 0;
    size_t nc = r.cigar.size();
    if (nc) {
      if ((r.cigar[0] & 0xf) == 4) lc = r.cigar[0] >> 4;
      if (nc > 1 && (r.cigar[nc - 1] & 0xf) == 4) rcl = r.cigar[nc - 1] >> 4;
      for (uint32_t c : r.cigar) {
        int op = c & 0xf;
        if (op == 1) ins += c >> 4;
        if (op == 2) del += c >> 4;
      }
    }
    lclip[n] = lc;
    rclip[n] = rcl;
    ins_sum[n] = ins;
    del_sum[n] = del;
    // seq ASCII expand: one LUT hit expands a packed byte to two chars
    static const struct Nib2 {
      uint16_t t[256];
      Nib2() {
        for (int b = 0; b < 256; b++)
          t[b] = (uint16_t)((uint8_t)SEQ_NT16[b >> 4] |
                            ((uint16_t)(uint8_t)SEQ_NT16[b & 0xf] << 8));
      }
    } NIB2;
    uint8_t* sdst = seq + n * Lmax;
    int L = std::min<int32_t>(r.l_seq, Lmax);
    {
      int i = 0;
      for (; i + 1 < L; i += 2) {
        uint16_t two = NIB2.t[r.seq4[i >> 1]];
        memcpy(sdst + i, &two, 2);
      }
      if (i < L)
        sdst[i] = (uint8_t)SEQ_NT16[(r.seq4[i >> 1] >> 4) & 0xf];
    }
    memset(sdst + L, 0, Lmax - L);
    if (nc)  // empty CIGAR: .data() may be null, UB to pass to memcpy
      memcpy(cigar_buf + coff, r.cigar.data(), 4 * nc);
    coff += (int64_t)nc;
    cigar_off[n + 1] = coff;
    if (!r.qname.empty())
      memcpy(qname_buf + qoff, r.qname.data(), r.qname.size());
    qoff += (int64_t)r.qname.size();
    qname_off[n + 1] = qoff;
    n++;
  }
  return n;
}

const char* sio_error(void* vh) {
  Handle* h = (Handle*)vh;
  return h->rd->err.c_str();
}

}  // extern "C"
