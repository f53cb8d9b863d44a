// libdeflate's decompression API (the subset in libdeflate/libdeflate.h)
// implemented on zlib, for hosts without libdeflate. Each decompressor keeps
// one raw-DEFLATE and one gzip inflate state and resets them per call, so a
// call decodes exactly one stream (one BGZF block, one gzip member), as
// libdeflate's whole-buffer functions do. zlib inflates more slowly than
// libdeflate; results are identical.

#include <climits>
#include <new>

#include <zlib.h>

#include "libdeflate/libdeflate.h"

struct libdeflate_decompressor {
  z_stream raw{};
  z_stream gz{};
  bool raw_ready = false;
  bool gz_ready = false;
};

namespace {

libdeflate_result inflate_one(z_stream* s, const void* in, size_t in_n,
                              void* out, size_t out_n, size_t* in_used,
                              size_t* out_used) {
  if (in_n > UINT_MAX || out_n > UINT_MAX) return LIBDEFLATE_BAD_DATA;
  if (inflateReset(s) != Z_OK) return LIBDEFLATE_BAD_DATA;
  s->next_in = static_cast<Bytef*>(const_cast<void*>(in));
  s->avail_in = static_cast<uInt>(in_n);
  s->next_out = static_cast<Bytef*>(out);
  s->avail_out = static_cast<uInt>(out_n);
  const int r = inflate(s, Z_FINISH);
  const size_t produced = out_n - s->avail_out;
  if (r == Z_STREAM_END) {
    if (in_used) *in_used = in_n - s->avail_in;
    if (out_used) {
      *out_used = produced;
    } else if (produced != out_n) {
      return LIBDEFLATE_SHORT_OUTPUT;
    }
    return LIBDEFLATE_SUCCESS;
  }
  if ((r == Z_OK || r == Z_BUF_ERROR) && s->avail_out == 0)
    return LIBDEFLATE_INSUFFICIENT_SPACE;
  return LIBDEFLATE_BAD_DATA;
}

}  // namespace

extern "C" {

libdeflate_decompressor* libdeflate_alloc_decompressor(void) {
  auto* d = new (std::nothrow) libdeflate_decompressor;
  if (!d) return nullptr;
  d->raw_ready = inflateInit2(&d->raw, -MAX_WBITS) == Z_OK;
  d->gz_ready = inflateInit2(&d->gz, 16 + MAX_WBITS) == Z_OK;
  if (!d->raw_ready || !d->gz_ready) {
    libdeflate_free_decompressor(d);
    return nullptr;
  }
  return d;
}

void libdeflate_free_decompressor(libdeflate_decompressor* d) {
  if (!d) return;
  if (d->raw_ready) inflateEnd(&d->raw);
  if (d->gz_ready) inflateEnd(&d->gz);
  delete d;
}

libdeflate_result libdeflate_deflate_decompress(
    libdeflate_decompressor* d, const void* in, size_t in_nbytes, void* out,
    size_t out_nbytes_avail, size_t* actual_out_nbytes_ret) {
  return inflate_one(&d->raw, in, in_nbytes, out, out_nbytes_avail, nullptr,
                     actual_out_nbytes_ret);
}

libdeflate_result libdeflate_gzip_decompress(
    libdeflate_decompressor* d, const void* in, size_t in_nbytes, void* out,
    size_t out_nbytes_avail, size_t* actual_out_nbytes_ret) {
  return inflate_one(&d->gz, in, in_nbytes, out, out_nbytes_avail, nullptr,
                     actual_out_nbytes_ret);
}

libdeflate_result libdeflate_gzip_decompress_ex(
    libdeflate_decompressor* d, const void* in, size_t in_nbytes, void* out,
    size_t out_nbytes_avail, size_t* actual_in_nbytes_ret,
    size_t* actual_out_nbytes_ret) {
  return inflate_one(&d->gz, in, in_nbytes, out, out_nbytes_avail,
                     actual_in_nbytes_ret, actual_out_nbytes_ret);
}

}  // extern "C"
