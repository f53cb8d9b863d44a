// Repeat-unit scan for Hopper (sm_90a): one thread per read.
//
// Replaces the Pallas TPU kernel `_kernel` in strling_tpu/ops/kmer_pallas.py
// (launched by get_repeat_codes_pallas, pallas_call at :495; entered through
// _pallas_fused_jit and _pallas_jit). It computes what that kernel computes,
// per read (src/strpkg/utils.nim:236-271 of the reference):
//   - for k = 2..6, the stride-k window codes, each the minimum over the
//     window's cyclic rotations (utils.nim:10-35);
//   - the modal window code with the running-argmax tie-break
//     (utils.nim:192-198); a modal of -1 (no valid window) decodes as G*k;
//   - the exact non-overlapping recount of the decoded modal k-mer
//     (utils.nim:254), where N and IUPAC bytes never match;
//   - the k-selection state machine against the host thresholds te/tp,
//     the homopolymer reduction and the >20 N skip.
//
// Design. The TPU kernel lays reads across vector lanes and turns every
// per-read loop into band matmuls and lane-packed bit tricks. On the GPU each
// thread simply walks its own read in natural position order. Inputs are the
// fused payload rows in all three wire layouts (n8/w8/w16, byte t bits 2m =
// position 4t+m) or raw ASCII rows (the engine's IUPAC fallback), where a
// byte that is not the canonical letter of its own 2-bit code is flagged so
// it never matches in the recount.
//
// Modal for k >= 3 uses the reach-max-first identity of the TPU kernel's
// _modal_pairwise: the winner is the earliest window whose running
// occurrence count reaches the maximum, so a running argmax over
// occ(j) = 1 + #{i < j : w_i == w_j} reproduces the reference exactly. The
// window codes live in a per-thread slice of shared memory (stride
// blockDim.x, so a warp's accesses fall in distinct banks). The TPU kernel's
// SWAR field packing (4 reads per int32 for k = 3) is not carried over: it
// overflows for reads over 192bp (fault F1). k = 2 counts its 16 codes in a
// per-thread histogram.
//
// Output is code, length and count as three int32 arrays. The count is not
// packed into 8 bits (fault F2: a 256bp homopolymer counts 256, as the
// reference detector says).
//
// What bounds it on the card: the O(W^2) modal compare loop in shared memory
// (about 2.7k compares per 152bp read) and the dependent byte loads of the
// read, issued by few threads: a batch of B reads runs B threads, so the
// production batches of 4k-64k reads leave most of the card's 270k thread
// slots idle. That is latency, not bandwidth (the payload is ~49 bytes a
// read); splitting a read over several threads is work for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Layout : int { ASCII = 0, N8 = 1, W8 = 2, W16 = 3 };

constexpr int NK = 5;  // k = 2..6

// One read's bytes and how to decode them.
template <int LAYOUT>
struct Read {
  const uint8_t* row;
  int L;  // row width in bases

  __device__ __forceinline__ int digit(int p) const {
    if (LAYOUT == ASCII) return (__ldg(row + p) >> 1) & 3;
    return (__ldg(row + (p >> 2)) >> (2 * (p & 3))) & 3;
  }
  // the byte can never match a decoded ACTG letter (N or another IUPAC code)
  __device__ __forceinline__ bool flagged(int p) const {
    if (LAYOUT == ASCII) {
      int b = __ldg(row + p);
      int d = (b >> 1) & 3;
      return b != 65 + 2 * d + 15 * (d == 2);  // A=65 C=67 T=84 G=71
    }
    if (LAYOUT == N8) return false;
    return (__ldg(row + (L >> 2) + (p >> 3)) >> (p & 7)) & 1;
  }
  __device__ __forceinline__ bool is_n(int p) const {
    if (LAYOUT == ASCII) return __ldg(row + p) == 'N';
    return flagged(p);  // payload rows are ACGTN-only: the flag is the N bit
  }
};

__device__ __forceinline__ int min_rotation(int f, int k) {
  const int mask = (1 << (2 * k)) - 1;
  int m = f;
  for (int r = 1; r < k; ++r) {
    f = ((f << 2) & mask) | (f >> (2 * (k - 1)));
    m = min(m, f);
  }
  return m;
}

template <int LAYOUT>
__device__ __forceinline__ int window_code(const Read<LAYOUT>& rd, int j, int k) {
  int f = 0;
  for (int m = 0; m < k; ++m) f = (f << 2) | rd.digit(j * k + m);
  return min_rotation(f, k);
}

template <int LAYOUT>
__global__ void repeat_scan_kernel(const uint8_t* __restrict__ in,
                                   int64_t n_rows, int64_t row_stride, int L,
                                   const int32_t* __restrict__ lengths_in,
                                   const int32_t* __restrict__ te_in,
                                   const int32_t* __restrict__ tp_in,
                                   int32_t* __restrict__ code_out,
                                   int32_t* __restrict__ len_out,
                                   int32_t* __restrict__ cnt_out) {
  extern __shared__ uint16_t wins[];  // [W3max][blockDim.x]
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int T = blockDim.x;
  uint16_t* ws = wins + threadIdx.x;

  Read<LAYOUT> rd{in + r * row_stride, L};
  int len, te[NK], tp[NK];
  if (LAYOUT == ASCII) {
    len = lengths_in[r];
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      te[i] = te_in[r * NK + i];
      tp[i] = tp_in[r * NK + i];
    }
  } else {
    const uint8_t* meta = rd.row + (LAYOUT == N8 ? L / 4 : 3 * L / 8);
#pragma unroll
    for (int i = 0; i < 2 * NK + 1; ++i) {
      int v = (LAYOUT == W16) ? (meta[2 * i] | (meta[2 * i + 1] << 8)) : meta[i];
      if (i < NK) te[i] = v;
      else if (i < 2 * NK) tp[i - NK] = v;
      else len = v;
    }
  }
  len = max(0, min(len, L));

  int n_count = 0;
  for (int p = 0; p < len; ++p) n_count += rd.is_n(p);
  if (n_count > 20) {  // utils.nim:238
    code_out[r] = 0;
    len_out[r] = 0;
    cnt_out[r] = 0;
    return;
  }

  int kcount[NK], target[NK];
  // k = 2: count each of the 16 codes directly
  {
    uint16_t hist[16];
#pragma unroll
    for (int v = 0; v < 16; ++v) hist[v] = 0;
    int M = 0, modal = -1;
    const int W = len / 2;
    for (int j = 0; j < W; ++j) {
      int w = window_code(rd, j, 2);
      int c = ++hist[w];
      if (c > M) {
        M = c;
        modal = w;
      }
    }
    kcount[0] = M;
    target[0] = modal < 0 ? 15 : modal;
  }
  // k = 3..6: running argmax of the occurrence count
#pragma unroll
  for (int ki = 1; ki < NK; ++ki) {
    const int k = ki + 2;
    const int W = len / k;
    for (int j = 0; j < W; ++j) ws[j * T] = (uint16_t)window_code(rd, j, k);
    int M = 0, modal = -1;
    for (int j = 0; j < W; ++j) {
      const int w = ws[j * T];
      int occ = 1;
      for (int i = 0; i < j; ++i) occ += (ws[i * T] == w);
      if (occ > M) {
        M = occ;
        modal = w;
      }
    }
    kcount[ki] = M;
    target[ki] = modal < 0 ? (1 << (2 * k)) - 1 : modal;
  }

  // exact non-overlapping recount, all k in one pass over the read
  int exact[NK], next_free[NK];
#pragma unroll
  for (int ki = 0; ki < NK; ++ki) exact[ki] = next_free[ki] = 0;
  int roll = 0, last_flag = -1;
  for (int p = 0; p < len; ++p) {
    roll = ((roll << 2) | rd.digit(p)) & 0xFFF;
    if (rd.flagged(p)) last_flag = p;
#pragma unroll
    for (int ki = 0; ki < NK; ++ki) {
      const int k = ki + 2;
      const int start = p - k + 1;
      if (start >= next_free[ki] && last_flag < start &&
          (roll & ((1 << (2 * k)) - 1)) == target[ki]) {
        ++exact[ki];
        next_free[ki] = p + 1;
      }
    }
  }

  // k-selection state machine (utils.nim:243-269)
  int best = -1, res_ki = -1, res_cnt = 0, res_code = 0;
  bool done = false;
#pragma unroll
  for (int ki = 0; ki < NK; ++ki) {
    const int k = ki + 2;
    if (done) break;
    if (kcount[ki] * k <= best) {
      if (kcount[ki] < te[ki]) done = true;
      continue;
    }
    if (exact[ki] * k < best) continue;
    best = exact[ki] * k;
    if (exact[ki] > tp[ki]) {
      res_ki = ki;
      res_cnt = exact[ki];
      res_code = target[ki];
    }
  }

  int klen = res_ki >= 0 ? res_ki + 2 : 0;
  // homopolymer reduction (utils.nim:220-233): all base-4 digits equal
  if (klen > 0) {
    const int first = res_code & 3;
    bool homo = true;
    for (int d = 1; d < klen; ++d) homo &= ((res_code >> (2 * d)) & 3) == first;
    if (homo) {
      res_cnt *= klen;
      res_code = first;
      klen = 1;
    }
  }
  code_out[r] = res_code;
  len_out[r] = klen;
  cnt_out[r] = res_cnt;
}

template <int LAYOUT>
cudaError_t launch(const uint8_t* in, int64_t n_rows, int64_t row_stride,
                   int L, const int32_t* lengths, const int32_t* te,
                   const int32_t* tp, int32_t* code, int32_t* len,
                   int32_t* cnt, cudaStream_t stream) {
  // shared memory holds each thread's k = 3 window codes (the most windows
  // of the k >= 3 passes); halve the block until it fits
  const size_t w3 = L / 3 > 0 ? L / 3 : 1;
  int threads = 128;
  size_t smem = threads * w3 * sizeof(uint16_t);
  while (threads > 32 && smem > 96 * 1024) {
    threads /= 2;
    smem = threads * w3 * sizeof(uint16_t);
  }
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        repeat_scan_kernel<LAYOUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (n_rows + threads - 1) / threads;
  repeat_scan_kernel<LAYOUT><<<(unsigned)blocks, threads, smem, stream>>>(
      in, n_rows, row_stride, L, lengths, te, tp, code, len, cnt);
  return cudaGetLastError();
}

}  // namespace

// layout: 0 ASCII rows (lengths/te/tp given), 1 n8, 2 w8, 3 w16 payload rows
// (lengths/te/tp read from each row's meta bytes; pass null).
extern "C" int repeat_scan_launch(const void* in, long long n_rows,
                                  long long row_stride, int layout, int L,
                                  const void* lengths, const void* te,
                                  const void* tp, void* code, void* len,
                                  void* cnt, void* stream) {
  if (n_rows <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto i8 = static_cast<const uint8_t*>(in);
  auto li = static_cast<const int32_t*>(lengths);
  auto tei = static_cast<const int32_t*>(te);
  auto tpi = static_cast<const int32_t*>(tp);
  auto co = static_cast<int32_t*>(code);
  auto lo = static_cast<int32_t*>(len);
  auto no = static_cast<int32_t*>(cnt);
  switch (layout) {
    case ASCII: return launch<ASCII>(i8, n_rows, row_stride, L, li, tei, tpi, co, lo, no, s);
    case N8: return launch<N8>(i8, n_rows, row_stride, L, li, tei, tpi, co, lo, no, s);
    case W8: return launch<W8>(i8, n_rows, row_stride, L, li, tei, tpi, co, lo, no, s);
    case W16: return launch<W16>(i8, n_rows, row_stride, L, li, tei, tpi, co, lo, no, s);
    default: return cudaErrorInvalidValue;
  }
}
