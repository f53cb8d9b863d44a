/* Compat header: the one liblzma entry point the host engine's CRAM reader
 * calls (strling_tpu/io/csrc/cram.cc), for hosts that ship liblzma.so.5
 * without its header. Declared from liblzma's public, stable ABI
 * (lzma/base.h, lzma/container.h). */
#ifndef STRLING_COMPAT_LZMA_H
#define STRLING_COMPAT_LZMA_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef enum {
  LZMA_OK = 0,
  LZMA_STREAM_END = 1,
  LZMA_NO_CHECK = 2,
  LZMA_UNSUPPORTED_CHECK = 3,
  LZMA_GET_CHECK = 4,
  LZMA_MEM_ERROR = 5,
  LZMA_MEMLIMIT_ERROR = 6,
  LZMA_FORMAT_ERROR = 7,
  LZMA_OPTIONS_ERROR = 8,
  LZMA_DATA_ERROR = 9,
  LZMA_BUF_ERROR = 10,
  LZMA_PROG_ERROR = 11,
} lzma_ret;

typedef struct lzma_allocator lzma_allocator;

lzma_ret lzma_stream_buffer_decode(uint64_t* memlimit, uint32_t flags,
                                   const lzma_allocator* allocator,
                                   const uint8_t* in, size_t* in_pos,
                                   size_t in_size, uint8_t* out,
                                   size_t* out_pos, size_t out_size);

#ifdef __cplusplus
}
#endif

#endif
