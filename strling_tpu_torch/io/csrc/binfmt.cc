// Native bin-file codec (the msgpack-framed evidence format; see
// strling_tpu/io/binfmt.py for the layout and reference citations).
// Byte-identical to the Python codec — cohort merges read millions of treads
// per sample, so the per-record work lives here.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace {

struct Writer {
  std::vector<uint8_t> buf;
  void u8(uint8_t v) { buf.push_back(v); }
  void raw(const void* p, size_t n) {
    const uint8_t* b = (const uint8_t*)p;
    buf.insert(buf.end(), b, b + n);
  }
  void be16(uint16_t v) { u8(v >> 8); u8(v & 0xff); }
  void be32(uint32_t v) { u8(v >> 24); u8(v >> 16); u8(v >> 8); u8(v); }
  // msgpack minimal unsigned
  void pack_uint(uint64_t v) {
    if (v < 128) u8((uint8_t)v);
    else if (v < 256) { u8(0xcc); u8((uint8_t)v); }
    else if (v < 65536) { u8(0xcd); be16((uint16_t)v); }
    else { u8(0xce); be32((uint32_t)v); }
  }
  void pack_int(int64_t v) {
    if (v >= 0) { pack_uint((uint64_t)v); return; }
    if (v >= -32) { u8((uint8_t)(0x100 + v)); return; }
    if (v >= -128) { u8(0xd0); u8((uint8_t)(int8_t)v); return; }
    if (v >= -32768) { u8(0xd1); be16((uint16_t)(int16_t)v); return; }
    u8(0xd2); be32((uint32_t)(int32_t)v);
  }
  void pack_str(const char* s, size_t n) {
    if (n < 32) u8(0xa0 | (uint8_t)n);
    else if (n < 256) { u8(0xd9); u8((uint8_t)n); }
    else { u8(0xda); be16((uint16_t)n); }
    raw(s, n);
  }
};

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint8_t u8() { return *p++; }
  uint64_t be(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 8) | *p++;
    return v;
  }
  int64_t take_int() {
    uint8_t b = u8();
    if (b < 0x80) return b;
    if (b >= 0xe0) return (int64_t)b - 0x100;
    switch (b) {
      case 0xcc: return (int64_t)be(1);
      case 0xcd: return (int64_t)be(2);
      case 0xce: return (int64_t)be(4);
      case 0xcf: return (int64_t)be(8);
      case 0xd0: return (int8_t)be(1);
      case 0xd1: return (int16_t)be(2);
      case 0xd2: return (int32_t)be(4);
      case 0xd3: return (int64_t)be(8);
      default: ok = false; return 0;
    }
  }
  int take_array() {
    uint8_t b = u8();
    if (b >= 0x90 && b <= 0x9f) return b & 0xf;
    if (b == 0xdc) return (int)be(2);
    ok = false;
    return 0;
  }
  std::pair<const char*, int64_t> take_str() {
    uint8_t b = u8();
    int64_t n;
    if (b >= 0xa0 && b <= 0xbf) n = b & 0x1f;
    else if (b == 0xd9) n = (int64_t)be(1);
    else if (b == 0xda) n = (int64_t)be(2);
    else if (b == 0xdb) n = (int64_t)be(4);
    else { ok = false; return {nullptr, 0}; }
    const char* s = (const char*)p;
    p += n;
    return {s, n};
  }
};

struct BinData {
  std::vector<int32_t> tid;
  std::vector<uint32_t> position;
  std::vector<uint8_t> repeat;  // 6 per read
  std::vector<uint16_t> flag;
  std::vector<uint8_t> split, mapq, repeat_count, align_length;
  std::string qnames;
  std::vector<int64_t> qname_off;
  uint32_t frag[4096];
  std::string header;
  std::string soft_version;
  float proportion_repeat = 0;
  uint8_t min_mapq = 0;
  int32_t n_reads_declared = 0;
  std::string err;
};

}  // namespace

extern "C" {

// Write treads + header to a bin file. Returns 0 on success.
int sio_bin_write(const char* path, int16_t fmt_version,
                  const char* soft_version9, float proportion_repeat,
                  uint8_t min_mapq, const uint32_t* frag4096,
                  const char* header, int64_t header_len, int64_t n,
                  const int32_t* tid, const uint32_t* position,
                  const uint8_t* repeat6, const uint16_t* flag,
                  const uint8_t* split, const uint8_t* mapq,
                  const uint8_t* repeat_count, const uint8_t* align_length,
                  const char* qname_buf, const int64_t* qname_off) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  Writer w;
  w.raw("STR", 3);
  w.raw(&fmt_version, 2);
  w.raw(soft_version9, 9);
  w.raw(&proportion_repeat, 4);
  w.raw(&min_mapq, 1);
  w.raw(frag4096, 4096 * 4);
  int32_t hl = (int32_t)header_len;
  w.raw(&hl, 4);
  w.raw(header, header_len);
  int32_t n32 = (int32_t)n;
  w.raw(&n32, 4);
  for (int64_t i = 0; i < n; i++) {
    w.pack_int(tid[i]);
    w.pack_uint(position[i]);
    w.u8(0x96);
    for (int j = 0; j < 6; j++) w.pack_uint(repeat6[6 * i + j]);
    w.pack_uint(flag[i]);
    w.pack_uint(split[i]);
    w.pack_uint(mapq[i]);
    w.pack_uint(repeat_count[i]);
    w.pack_uint(align_length[i]);
    int64_t qn = qname_off[i + 1] - qname_off[i];
    w.pack_uint((uint64_t)qn);
    w.pack_str(qname_buf + qname_off[i], (size_t)qn);
    if (w.buf.size() > (1 << 22)) {
      fwrite(w.buf.data(), 1, w.buf.size(), f);
      w.buf.clear();
    }
  }
  fwrite(w.buf.data(), 1, w.buf.size(), f);
  fclose(f);
  return 0;
}

// Parse a bin file with optional filters. Returns a handle (or null).
void* sio_bin_read(const char* path, int drop_unplaced, int has_requested_tid,
                   int32_t requested_tid) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  BinData* d = new BinData();
  if (size < 19 + 4096 * 4 + 8 || memcmp(buf.data(), "STR", 3) != 0) {
    d->err = "bad magic";
    return d;
  }
  int16_t fmt;
  memcpy(&fmt, buf.data() + 3, 2);
  if (fmt != 0) {
    d->err = "bad format version";
    return d;
  }
  d->soft_version.assign((const char*)buf.data() + 5, 9);
  memcpy(&d->proportion_repeat, buf.data() + 14, 4);
  d->min_mapq = buf[18];
  memcpy(d->frag, buf.data() + 19, 4096 * 4);
  int64_t off = 19 + 4096 * 4;
  int32_t hl;
  memcpy(&hl, buf.data() + off, 4);
  off += 4;
  d->header.assign((const char*)buf.data() + off, hl);
  off += hl;
  memcpy(&d->n_reads_declared, buf.data() + off, 4);
  off += 4;
  Reader r{buf.data() + off, buf.data() + size};
  d->qname_off.push_back(0);
  while (r.p < r.end && r.ok) {
    int32_t tid = (int32_t)r.take_int();
    uint32_t pos = (uint32_t)r.take_int();
    int na = r.take_array();
    uint8_t rep[6] = {0};
    for (int j = 0; j < na && j < 6; j++) rep[j] = (uint8_t)r.take_int();
    uint16_t flag = (uint16_t)r.take_int();
    uint8_t split = (uint8_t)r.take_int();
    uint8_t mapq = (uint8_t)r.take_int();
    uint8_t rc = (uint8_t)r.take_int();
    uint8_t al = (uint8_t)r.take_int();
    int64_t qlen = r.take_int();
    auto qs = r.take_str();
    if (!r.ok || qs.second != qlen) {
      d->err = "corrupt tread stream";
      return d;
    }
    if (has_requested_tid && tid != requested_tid) continue;
    if (drop_unplaced && tid < 0) continue;
    d->tid.push_back(tid);
    d->position.push_back(pos);
    for (int j = 0; j < 6; j++) d->repeat.push_back(rep[j]);
    d->flag.push_back(flag);
    d->split.push_back(split);
    d->mapq.push_back(mapq);
    d->repeat_count.push_back(rc);
    d->align_length.push_back(al);
    d->qnames.append(qs.first, qs.second);
    d->qname_off.push_back((int64_t)d->qnames.size());
  }
  return d;
}

const char* sio_bin_error(void* vd) { return ((BinData*)vd)->err.c_str(); }

int64_t sio_bin_n(void* vd) { return (int64_t)((BinData*)vd)->tid.size(); }

int32_t sio_bin_n_declared(void* vd) { return ((BinData*)vd)->n_reads_declared; }

float sio_bin_proportion(void* vd) { return ((BinData*)vd)->proportion_repeat; }

int sio_bin_min_mapq(void* vd) { return ((BinData*)vd)->min_mapq; }

int64_t sio_bin_header(void* vd, char* out, int64_t cap) {
  BinData* d = (BinData*)vd;
  if (out && cap > 0)
    memcpy(out, d->header.data(), std::min<int64_t>(cap, d->header.size()));
  return (int64_t)d->header.size();
}

void sio_bin_soft_version(void* vd, char* out9) {
  memcpy(out9, ((BinData*)vd)->soft_version.data(), 9);
}

void sio_bin_frag(void* vd, uint32_t* out4096) {
  memcpy(out4096, ((BinData*)vd)->frag, 4096 * 4);
}

int64_t sio_bin_qnames_size(void* vd) {
  return (int64_t)((BinData*)vd)->qnames.size();
}

void sio_bin_fill(void* vd, int32_t* tid, uint32_t* position, uint8_t* repeat6,
                  uint16_t* flag, uint8_t* split, uint8_t* mapq,
                  uint8_t* repeat_count, uint8_t* align_length,
                  char* qname_buf, int64_t* qname_off) {
  BinData* d = (BinData*)vd;
  size_t n = d->tid.size();
  memcpy(tid, d->tid.data(), n * 4);
  memcpy(position, d->position.data(), n * 4);
  memcpy(repeat6, d->repeat.data(), n * 6);
  memcpy(flag, d->flag.data(), n * 2);
  memcpy(split, d->split.data(), n);
  memcpy(mapq, d->mapq.data(), n);
  memcpy(repeat_count, d->repeat_count.data(), n);
  memcpy(align_length, d->align_length.data(), n);
  memcpy(qname_buf, d->qnames.data(), d->qnames.size());
  memcpy(qname_off, d->qname_off.data(), (n + 1) * 8);
}

void sio_bin_free(void* vd) { delete (BinData*)vd; }

}  // extern "C"
