/* Compat header: the decompression subset of libdeflate's public API that
 * the host engine (strling_tpu/io/csrc) calls, for hosts without libdeflate.
 * Implemented on zlib by ../libdeflate_zlib.cc; same names, values and
 * semantics as libdeflate.h. */
#ifndef STRLING_COMPAT_LIBDEFLATE_H
#define STRLING_COMPAT_LIBDEFLATE_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

struct libdeflate_decompressor;

enum libdeflate_result {
  LIBDEFLATE_SUCCESS = 0,
  LIBDEFLATE_BAD_DATA = 1,
  LIBDEFLATE_SHORT_OUTPUT = 2,
  LIBDEFLATE_INSUFFICIENT_SPACE = 3,
};

struct libdeflate_decompressor* libdeflate_alloc_decompressor(void);
void libdeflate_free_decompressor(struct libdeflate_decompressor* d);

enum libdeflate_result libdeflate_deflate_decompress(
    struct libdeflate_decompressor* d, const void* in, size_t in_nbytes,
    void* out, size_t out_nbytes_avail, size_t* actual_out_nbytes_ret);

enum libdeflate_result libdeflate_gzip_decompress(
    struct libdeflate_decompressor* d, const void* in, size_t in_nbytes,
    void* out, size_t out_nbytes_avail, size_t* actual_out_nbytes_ret);

enum libdeflate_result libdeflate_gzip_decompress_ex(
    struct libdeflate_decompressor* d, const void* in, size_t in_nbytes,
    void* out, size_t out_nbytes_avail, size_t* actual_in_nbytes_ret,
    size_t* actual_out_nbytes_ret);

#ifdef __cplusplus
}
#endif

#endif
