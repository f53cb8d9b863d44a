// Small shared helpers for the native sources.
#pragma once

#include <cstdint>
#include <cstring>

namespace sio_util {

// Nim strutils.count / Python str.count: greedy non-overlapping occurrences
// of pat (length k) in s[0:n], matched at the byte level (utils.nim:254 —
// 'N'/IUPAC bytes never match a decoded ACGT unit).
inline int count_nonoverlapping(const uint8_t* s, int64_t n, const char* pat,
                                int64_t k) {
  int count = 0;
  int64_t i = 0;
  while (i + k <= n) {
    if (memcmp(s + i, pat, (size_t)k) == 0) {
      count++;
      i += k;
    } else {
      i++;
    }
  }
  return count;
}

}  // namespace sio_util
