// Repeat-unit scan for Hopper (sm_90a): one thread per read.
//
// Replaces the Pallas TPU kernel `_kernel` in strling_tpu/ops/kmer_pallas.py
// (launched by get_repeat_codes_pallas, pallas_call at :495; entered through
// _pallas_fused_jit, _pallas_jit and _pallas_packed_jit) in all of its forms:
// the k >= 3 modal as _modal_pairwise (:121) or _modal_sorted (:44,
// STRLING_MODAL_IMPL=sorted), and the stage-disabled `variant`s of the
// attribution tool (:201-214). It computes what that kernel computes, per
// read (src/strpkg/utils.nim:236-271 of the reference):
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
// position 4t+m), 2-bit rows with a separate N bitmask and per-row
// lengths/thresholds (`packed`, pack_bases' pair: the batches whose
// thresholds the payload's meta cannot hold), or raw ASCII rows (the
// engine's IUPAC fallback), where a byte that is not the canonical letter of
// its own 2-bit code is flagged so it never matches in the recount.
//
// Every form is a compile-time specialisation (LAYOUT, MODAL, VARIANT) of
// the one kernel, chosen by the plain-C launcher.
//
// Modal for k >= 3, pairwise (the default): the reach-max-first identity of
// the TPU kernel's _modal_pairwise: the winner is the earliest window whose
// running occurrence count reaches the maximum, so a running argmax over
// occ(j) = 1 + #{i < j : w_i == w_j} reproduces the reference exactly. The
// window codes live in a per-thread slice of shared memory (stride
// blockDim.x, so a warp's accesses fall in distinct banks). The TPU kernel's
// SWAR field packing (4 reads per int32 for k = 3) is not carried over: it
// overflows for reads over 192bp (fault F1). k = 2 counts its 16 codes in a
// per-thread histogram, in both modal forms.
//
// Modal for k >= 3, sorted: each thread bitonic-sorts its keys
// code << 12 | window in its own int32 shared-memory slice (padded to a
// power of two with sentinels), then walks the runs of equal codes: the
// winner has the largest total and, among ties, the earliest last
// occurrence. The window index gets 12 bits (up to 4095 windows, and the
// sorted form takes at most 1024): the TPU form's 6-bit field corrupts the
// tie-break past 64 windows (fault F6).
//
// Variants (the attribution tool only): NO_GREEDY takes the modal count as
// the exact count; NO_MODAL takes the first window's code as the modal and
// the number of windows as its count (k = 2 computes only that window; for
// k >= 3 the window codes are still written, so the difference to FULL is
// the modal loop); WINMIN_ONLY does both.
//
// Output is code, length and count as three int32 arrays. The count is not
// packed into 8 bits (fault F2: a 256bp homopolymer counts 256, as the
// reference detector says).
//
// What bounds it on the card: the O(W^2) pairwise modal loop in shared
// memory, about 2.7k compares per 152bp read and two thirds of the kernel's
// time on n8 rows by the stage variants (the sorted form's networks make
// about 1.8k compare-exchanges over k = 3..6, each two loads and up to two
// stores, and run 1.4x longer), and the dependent byte loads of the read,
// issued by few threads: a batch of B reads runs B threads, so the
// production batches of 4k-64k reads leave most of the card's 270k thread
// slots idle. That is latency, not bandwidth (the payload is ~49 bytes a
// read); splitting a read over several threads is work for a later change.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Layout : int { ASCII = 0, N8 = 1, W8 = 2, W16 = 3, PACKED = 4 };
enum Modal : int { PAIRWISE = 0, SORTED = 1 };
enum Variant : int { FULL = 0, NO_GREEDY = 1, NO_MODAL = 2, WINMIN_ONLY = 3 };

constexpr int NK = 5;  // k = 2..6
constexpr int WIDX_BITS = 12;
constexpr int SORTED_MAX_KEYS = 1 << 10;

// One read's bytes and how to decode them.
template <int LAYOUT>
struct Read {
  const uint8_t* row;
  const uint8_t* nbits;  // PACKED: the row's N bitmask
  int L;                 // row width in bases

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
    if (LAYOUT == PACKED) return (__ldg(nbits + (p >> 3)) >> (p & 7)) & 1;
    return (__ldg(row + (L >> 2) + (p >> 3)) >> (p & 7)) & 1;
  }
  __device__ __forceinline__ bool is_n(int p) const {
    if (LAYOUT == ASCII) return __ldg(row + p) == 'N';
    return flagged(p);  // 2-bit rows are ACGTN-only: the flag is the N bit
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

// k >= 3 modal by sorting this thread's keys (stride T in shared memory).
// Returns the modal code (-1 with no window) and sets M to its total.
template <int LAYOUT>
__device__ __forceinline__ int modal_sorted(const Read<LAYOUT>& rd, int W,
                                            int k, int32_t* ks, int T,
                                            int& M) {
  int P = 1;
  while (P < W) P <<= 1;
  for (int j = 0; j < W; ++j) ks[j * T] = (window_code(rd, j, k) << WIDX_BITS) | j;
  for (int j = W; j < P; ++j) ks[j * T] = INT_MAX;
  // bitonic network, ascending: pair (i, i | s) with bit s of i clear
  for (int size = 2; size <= P; size <<= 1) {
    for (int s = size >> 1; s > 0; s >>= 1) {
      for (int t = 0; t < P / 2; ++t) {
        const int i = ((t & ~(s - 1)) << 1) | (t & (s - 1));
        const int j = i | s;
        const int a = ks[i * T], b = ks[j * T];
        if ((a > b) == ((i & size) == 0)) {
          ks[i * T] = b;
          ks[j * T] = a;
        }
      }
    }
  }
  // runs of equal codes are in window order: the last key holds the code's
  // last occurrence
  int modal = -1, best_last = 0, run_start = 0;
  M = 0;
  int key = W > 0 ? ks[0] : 0;
  for (int i = 0; i < W; ++i) {
    const int next = i + 1 < W ? ks[(i + 1) * T] : -1;
    const int code = key >> WIDX_BITS;
    if (i + 1 == W || (next >> WIDX_BITS) != code) {
      const int tot = i - run_start + 1;
      const int last = key & ((1 << WIDX_BITS) - 1);
      if (tot > M || (tot == M && last < best_last)) {
        M = tot;
        best_last = last;
        modal = code;
      }
      run_start = i + 1;
    }
    key = next;
  }
  return modal;
}

template <int LAYOUT, int MODAL, int VARIANT>
__global__ void repeat_scan_kernel(const uint8_t* __restrict__ in,
                                   int64_t n_rows, int64_t row_stride, int L,
                                   const uint8_t* __restrict__ nbits_in,
                                   const int32_t* __restrict__ lengths_in,
                                   const int32_t* __restrict__ te_in,
                                   const int32_t* __restrict__ tp_in,
                                   int32_t* __restrict__ code_out,
                                   int32_t* __restrict__ len_out,
                                   int32_t* __restrict__ cnt_out) {
  constexpr bool DO_MODAL = VARIANT == FULL || VARIANT == NO_GREEDY;
  constexpr bool DO_GREEDY = VARIANT == FULL || VARIANT == NO_MODAL;
  // per thread: [W3max] u16 window codes, or [P3] int32 sort keys (SORTED)
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int T = blockDim.x;
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem) + threadIdx.x;
  int32_t* ks = reinterpret_cast<int32_t*>(smem) + threadIdx.x;

  Read<LAYOUT> rd{in + r * row_stride,
                  LAYOUT == PACKED ? nbits_in + r * (L >> 3) : nullptr, L};
  int len, te[NK], tp[NK];
  if (LAYOUT == ASCII || LAYOUT == PACKED) {
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
    const int W = len / 2;
    int M = 0, modal = -1;
    if (DO_MODAL) {
      uint16_t hist[16];
#pragma unroll
      for (int v = 0; v < 16; ++v) hist[v] = 0;
      for (int j = 0; j < W; ++j) {
        int w = window_code(rd, j, 2);
        int c = ++hist[w];
        if (c > M) {
          M = c;
          modal = w;
        }
      }
    } else if (W > 0) {
      M = W;
      modal = window_code(rd, 0, 2);
    }
    kcount[0] = M;
    target[0] = modal < 0 ? 15 : modal;
  }
  // k = 3..6
#pragma unroll
  for (int ki = 1; ki < NK; ++ki) {
    const int k = ki + 2;
    const int W = len / k;
    int M = 0, modal = -1;
    if (DO_MODAL && MODAL == SORTED) {
      modal = modal_sorted(rd, W, k, ks, T, M);
    } else {
      for (int j = 0; j < W; ++j) ws[j * T] = (uint16_t)window_code(rd, j, k);
      if (!DO_MODAL) {
        if (W > 0) {
          M = W;
          modal = ws[0];
        }
      } else {
        // running argmax of the occurrence count
        for (int j = 0; j < W; ++j) {
          const int w = ws[j * T];
          int occ = 1;
          for (int i = 0; i < j; ++i) occ += (ws[i * T] == w);
          if (occ > M) {
            M = occ;
            modal = w;
          }
        }
      }
    }
    kcount[ki] = M;
    target[ki] = modal < 0 ? (1 << (2 * k)) - 1 : modal;
  }

  // exact non-overlapping recount, all k in one pass over the read
  int exact[NK];
#pragma unroll
  for (int ki = 0; ki < NK; ++ki) exact[ki] = DO_GREEDY ? 0 : kcount[ki];
  if (DO_GREEDY) {
    int next_free[NK];
#pragma unroll
    for (int ki = 0; ki < NK; ++ki) next_free[ki] = 0;
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

struct Args {
  const uint8_t* in;
  int64_t n_rows, row_stride;
  int L;
  const uint8_t* nbits;
  const int32_t *lengths, *te, *tp;
  int32_t *code, *len, *cnt;
  cudaStream_t stream;
};

constexpr int MAX_SMEM = 227 * 1024;  // the most a block may have on sm_90

template <int LAYOUT, int MODAL, int VARIANT>
cudaError_t set_attributes() {
  // The attributes belong to the function on each card and never change:
  // set them once a card (one bit for each of the first 64).
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  auto kernel = repeat_scan_kernel<LAYOUT, MODAL, VARIANT>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM);
  if (e != cudaSuccess) return e;
  // Half of each SM's unified memory as shared memory, half as L1 (a hint;
  // a block that needs more still gets it). Left to CUDA's choice, forms
  // with few registers got the largest shared share, and the per-thread
  // byte walks over ASCII rows (a warp's loads fall on 32 rows) thrashed
  // the L1 that was left: 2.5x slower for winmin_only and 1.3x for the
  // sorted modal on 32768x152 ASCII rows, n8 rows unchanged (measured on
  // an H100, PERF.md).
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout, 50);
  if (e != cudaSuccess) return e;
  done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

template <int LAYOUT, int MODAL, int VARIANT>
cudaError_t launch(const Args& a) {
  // shared memory holds each thread's k = 3 window codes (the most windows
  // of the k >= 3 passes), as u16 codes or, for the sorted modal, as int32
  // keys padded to a power of two; halve the block until it fits
  constexpr bool SORTING =
      MODAL == SORTED && (VARIANT == FULL || VARIANT == NO_GREEDY);
  const size_t w3 = a.L / 3 > 0 ? a.L / 3 : 1;
  size_t per_thread = w3 * sizeof(uint16_t);
  if (SORTING) {
    size_t p3 = 1;
    while (p3 < w3) p3 <<= 1;
    if (p3 > SORTED_MAX_KEYS) return cudaErrorInvalidValue;
    per_thread = p3 * sizeof(int32_t);
  }
  int threads = 128;
  size_t smem = threads * per_thread;
  while (threads > 32 && smem > 96 * 1024) {
    threads /= 2;
    smem = threads * per_thread;
  }
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t e = set_attributes<LAYOUT, MODAL, VARIANT>();
  if (e != cudaSuccess) return e;
  const int64_t blocks = (a.n_rows + threads - 1) / threads;
  repeat_scan_kernel<LAYOUT, MODAL, VARIANT><<<(unsigned)blocks, threads, smem,
                                               a.stream>>>(
      a.in, a.n_rows, a.row_stride, a.L, a.nbits, a.lengths, a.te, a.tp,
      a.code, a.len, a.cnt);
  return cudaGetLastError();
}

template <int LAYOUT>
cudaError_t launch_form(const Args& a, int modal, int variant) {
  // the sorted form only differs where a modal is computed
  if (modal == SORTED && variant == FULL) return launch<LAYOUT, SORTED, FULL>(a);
  if (modal == SORTED && variant == NO_GREEDY)
    return launch<LAYOUT, SORTED, NO_GREEDY>(a);
  if (modal != PAIRWISE && modal != SORTED) return cudaErrorInvalidValue;
  switch (variant) {
    case FULL: return launch<LAYOUT, PAIRWISE, FULL>(a);
    case NO_GREEDY: return launch<LAYOUT, PAIRWISE, NO_GREEDY>(a);
    case NO_MODAL: return launch<LAYOUT, PAIRWISE, NO_MODAL>(a);
    case WINMIN_ONLY: return launch<LAYOUT, PAIRWISE, WINMIN_ONLY>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// layout: 0 ASCII rows, 4 2-bit rows with an N bitmask `nbits` [n_rows, L/8]
// (both with lengths [n_rows], te/tp [n_rows, 5] int32), or 1 n8, 2 w8,
// 3 w16 payload rows (lengths/te/tp read from each row's meta bytes; pass
// null). modal: 0 pairwise, 1 sorted (at most 1024 keys: L/3 <= 1024).
// variant: 0 full, 1 no_greedy, 2 no_modal, 3 winmin_only.
extern "C" int repeat_scan_launch(const void* in, long long n_rows,
                                  long long row_stride, int layout, int L,
                                  const void* nbits, const void* lengths,
                                  const void* te, const void* tp, int modal,
                                  int variant, void* code, void* len,
                                  void* cnt, void* stream) {
  if (n_rows <= 0) return 0;
  const Args a{static_cast<const uint8_t*>(in), n_rows, row_stride, L,
               static_cast<const uint8_t*>(nbits),
               static_cast<const int32_t*>(lengths),
               static_cast<const int32_t*>(te),
               static_cast<const int32_t*>(tp), static_cast<int32_t*>(code),
               static_cast<int32_t*>(len), static_cast<int32_t*>(cnt),
               static_cast<cudaStream_t>(stream)};
  switch (layout) {
    case ASCII: return launch_form<ASCII>(a, modal, variant);
    case N8: return launch_form<N8>(a, modal, variant);
    case W8: return launch_form<W8>(a, modal, variant);
    case W16: return launch_form<W16>(a, modal, variant);
    case PACKED: return launch_form<PACKED>(a, modal, variant);
    default: return cudaErrorInvalidValue;
  }
}
