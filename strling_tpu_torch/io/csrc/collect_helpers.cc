// Small exact-arithmetic helpers for the batched support collection
// (core/collect_batched.py).

#include <cstdint>

extern "C" {

// float32 left-to-right fold over float64 values with the reference's
// rounding chain (collect.nim:172-173: the accumulator field is float32;
// each += promotes to float64, adds, then narrows on store):
//   acc = (float)((double)acc + v)
float sio_f32_seq_sum(const double* vals, int64_t n) {
  float acc = 0.0f;
  for (int64_t i = 0; i < n; i++) acc = (float)((double)acc + vals[i]);
  return acc;
}

}  // extern "C"
