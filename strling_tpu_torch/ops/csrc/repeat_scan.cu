// Repeat-unit scan for Hopper (sm_90a).
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
// Inputs are the fused payload rows in all three wire layouts (n8/w8/w16,
// byte t bits 2m = position 4t+m), 2-bit rows with a separate N bitmask and
// per-row lengths/thresholds (`packed`, pack_bases' pair: the batches whose
// thresholds the payload's meta cannot hold), or raw ASCII rows (the
// engine's IUPAC fallback), where a byte that is not the canonical letter of
// its own 2-bit code is flagged so it never matches in the recount. Every
// form is a compile-time specialisation of one of two kernels, chosen by the
// plain-C launcher.
//
// Pairwise modal, every variant (the main path): one warp per read,
// repeat_scan_warp_kernel. The TPU kernel lays reads across vector lanes and
// turns every per-read loop into band matmuls and lane-packed bit tricks; a
// thread per read (this kernel's first form) left a 4096-read batch on 32 of
// the 132 SMs and walked each read serially. Here the 32 lanes share a read:
//   - they load the row once, coalesced, and give each base p a u16 in the
//     warp's shared memory: the 6-digit code of the bases ending at p and
//     how many of them may match (none before the read's start), so a
//     window's code and a recount test are one shared-memory load each. On
//     2-bit rows a lane takes a byte (4 bases) and the two before it from
//     its neighbours by shuffles; ASCII rows go through one byte per base
//     first. The N count is a warp sum of per-lane counts;
//   - the k-selection state machine runs k = 2..6 in order and computes a
//     k's modal and exact count only when it reads them: it stops once a
//     modal count falls below its early threshold, and skips the recount
//     when the modal count cannot beat the best score. On the bench mix a
//     random 152bp read recounts k = 2 alone (93% of them) and stops after
//     k = 3 or 4 (91%); the answer is the one the reference's loop gives;
//   - windows: lane j of each chunk of 32 windows computes window j's
//     minimum rotation;
//   - modal: the reach-max-first identity of the TPU kernel's
//     _modal_pairwise: the winner is the earliest window whose running
//     occurrence count reaches the maximum, so a running argmax over
//     occ(j) = 1 + #{i < j : w_i == w_j} reproduces the reference exactly.
//     occ(j) is O(1) per window: a per-warp count table of 4^6 entries in
//     shared memory holds the earlier chunks' counts, and __match_any_sync
//     gives the earlier lanes of this chunk with the same code; each group's
//     lowest lane then adds the group's size to the table. A warp max and a
//     ballot give the chunk's (max, first lane), so the running argmax
//     advances a chunk at a time. After each k the entries the read touched
//     are set back to 0 (the table is cleared once, when the warp starts).
//     The entries are u8 for rows up to 511 bases (no code occurs more than
//     255 times) and u16 beyond. The TPU kernel's SWAR field packing is not
//     carried over: it overflows for reads over 192bp (fault F1);
//   - recount: lanes test 32 end positions a step; a ballot collects the
//     hits and the greedy non-overlapping pick walks the set bits,
//     identically on every lane, carrying next_free across steps;
//   - lane 0 writes the warp-uniform result.
// Blocks hold WARPS warps and the grid holds as many blocks as the card
// keeps resident (each warp strides over reads), so a warp clears its table
// once however many reads it takes.
//
// Sorted modal (STRLING_MODAL_IMPL=sorted, off the main path): one thread
// per read, repeat_scan_sorted_kernel. Each thread bitonic-sorts its keys
// code << 12 | window in its own int32 shared-memory slice (padded to a
// power of two with sentinels), then walks the runs of equal codes: the
// winner has the largest total and, among ties, the earliest last
// occurrence. The window index gets 12 bits (up to 4095 windows, and the
// sorted form takes at most 1024): the TPU form's 6-bit field corrupts the
// tie-break past 64 windows (fault F6). Its k = 2 modal counts the 16 codes
// in a per-thread histogram.
//
// Variants (the TPU kernel's stage-disabled forms, for the stage tool only):
// NO_GREEDY takes the modal count as the exact count; NO_MODAL takes the
// first window's code as the modal and the number of windows as its count
// (the window codes are still computed); WINMIN_ONLY does both. On the warp
// kernel a variant's counts steer the lazy k-selection too: NO_MODAL's count
// keeps every k in play, so it runs five recounts where FULL recounts k = 2
// alone on most reads, and FULL minus a variant is not a stage's cost. The
// stages are attributed by STAGES instead: FULL, with each warp adding the
// clock cycles it spent in each stage (loading and position codes, window
// codes, modal, recount, the rest) to g_stage_cycles, which
// repeat_scan_stage_cycles reads and clears.
//
// Output is code, length and count as three int32 arrays. The count is not
// packed into 8 bits (fault F2: a 256bp homopolymer counts 256, as the
// reference detector says). The launcher reports which kernel it launched
// (WARP_PER_READ or THREAD_PER_READ) through `design`.
//
// What bounds it on the card: neither bytes (about 60 per read) nor integer
// operations (about 4.0k on a random 152bp read, for the k the selection
// reaches: exp_kernel_timing.scan_ops) but the latency of each read's chain
// of dependent warp collectives and shared-memory accesses; the design's
// answer is many reads in flight (one warp each). Shared memory per warp (the
// count table, then 4 bytes a base) bounds how many warps an SM holds: 44 at
// 152 bases with the u8 table.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Layout : int { ASCII = 0, N8 = 1, W8 = 2, W16 = 3, PACKED = 4 };
enum Modal : int { PAIRWISE = 0, SORTED = 1 };
enum Variant : int {
  FULL = 0, NO_GREEDY = 1, NO_MODAL = 2, WINMIN_ONLY = 3,
  STAGES = 4,  // FULL, clocked by stage
};
enum Design : int { WARP_PER_READ = 0, THREAD_PER_READ = 1 };
// the stages STAGES clocks, in g_stage_cycles' order
enum Stage : int {
  ST_LOAD = 0, ST_WINDOWS = 1, ST_MODAL = 2, ST_RECOUNT = 3, ST_SELECT = 4,
};
constexpr int NSTAGES = 5;

constexpr int NK = 5;  // k = 2..6
constexpr int WIDX_BITS = 12;
constexpr int SORTED_MAX_KEYS = 1 << 10;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARPS = 4;  // warps per block of the warp kernel
// blocks an SM should hold, which caps the kernel at 40 registers a thread:
// left to itself ptxas gave the n8 detector 46, which the card allocates as
// 48, so an SM held 40 warps where shared memory allows 44 at 152 bases
// (measured on an H100: 0.0655 ms against 0.0554 per 32768x152 batch, no
// spills either way; PERF.md)
constexpr int MIN_BLOCKS = 12;
constexpr int TABLE_ENTRIES = 4096;  // 4^6 window codes
// rows up to this many bases count in u8 table entries: no code occurs more
// than L / 2 times (k = 2 has the most windows)
constexpr int U8_TABLE_MAX_L = 511;
constexpr int MAX_SMEM = 227 * 1024;   // the most a block may have on sm_90
constexpr uint8_t NO_MATCH = 4;        // unpacked base: bit 2 = never matches

__device__ __forceinline__ int min_rotation(int f, int k) {
  const int mask = (1 << (2 * k)) - 1;
  int m = f;
  for (int r = 1; r < k; ++r) {
    f = ((f << 2) & mask) | (f >> (2 * (k - 1)));
    m = min(m, f);
  }
  return m;
}

// ASCII: the byte is not the canonical letter of its own 2-bit code (N or
// another IUPAC code), so it can never match a decoded ACTG k-mer
__device__ __forceinline__ bool ascii_flagged(int b) {
  const int d = (b >> 1) & 3;
  return b != 65 + 2 * d + 15 * (d == 2);  // A=65 C=67 T=84 G=71
}

// The homopolymer reduction (utils.nim:220-233): a unit whose base-4 digits
// are all equal is reported as one base, its count multiplied by k.
__device__ __forceinline__ void reduce_homopolymer(int& code, int& klen,
                                                   int& cnt) {
  if (klen == 0) return;
  const int first = code & 3;
  bool homo = true;
  for (int d = 1; d < klen; ++d) homo &= ((code >> (2 * d)) & 3) == first;
  if (homo) {
    cnt *= klen;
    code = first;
    klen = 1;
  }
}

// ------------------------------------------------- warp per read (pairwise)

// Cycles by stage of the STAGES form, summed over warps
__device__ unsigned long long g_stage_cycles[NSTAGES];

// The STAGES form's clock: each lap gives the cycles since the last one to a
// stage. Lane 0 keeps the warp's counters in shared memory (registers would
// take from the 40 the kernel is capped at). With ON = false it is nothing.
template <bool ON>
struct StageClock {
  unsigned* acc;  // the warp's NSTAGES counters
  unsigned t;
  __device__ __forceinline__ void start() {
    if (ON) t = (unsigned)clock64();
  }
  __device__ __forceinline__ void lap(int stage, int lane) {
    if (ON) {
      const unsigned now = (unsigned)clock64();
      if (lane == 0) acc[stage] += now - t;
      t = now;
    }
  }
};

// One k of the warp's read: the modal window code (-1 with no window) and
// its count M, warp-uniform. pc[p] holds the 6-digit code ending at base p,
// so window j's digits are the low 2K bits of pc[jK + K - 1]. `tab` is the
// warp's zeroed count table and is left zeroed; `wcode` keeps the window
// codes for that.
template <int K, bool DO_MODAL, typename TabT, typename Clock>
__device__ __forceinline__ void warp_modal(const uint16_t* pc, int len,
                                           TabT* tab, uint16_t* wcode,
                                           int lane, Clock& clk, int& M,
                                           int& modal) {
  const int W = len / K;
  M = 0;
  modal = -1;
  unsigned sink = 0;
  clk.lap(ST_SELECT, lane);
  for (int c = 0; c < W; c += 32) {
    const int j = c + lane;
    const bool active = j < W;
    int w = 0;
    if (active) w = min_rotation(pc[j * K + K - 1] & ((1 << (2 * K)) - 1), K);
    clk.lap(ST_WINDOWS, lane);
    if (DO_MODAL) {
      // lanes past the last window take codes no window has
      const unsigned grp =
          __match_any_sync(FULL_MASK, active ? (unsigned)w : 0x10000u + lane);
      const unsigned earlier = grp & ((1u << lane) - 1u);
      int occ = 0;
      if (active) {
        occ = tab[w] + __popc(earlier) + 1;
        wcode[j] = (uint16_t)w;
      }
      __syncwarp();
      if (active && earlier == 0) tab[w] += (TabT)__popc(grp);
      __syncwarp();
      const int cmax = (int)__reduce_max_sync(FULL_MASK, (unsigned)occ);
      if (cmax > M) {  // reached first in this chunk, at its first lane
        const int first = __ffs(__ballot_sync(FULL_MASK, occ == cmax)) - 1;
        M = cmax;
        modal = __shfl_sync(FULL_MASK, w, first);
      }
      clk.lap(ST_MODAL, lane);
    } else {
      if (c == 0) modal = __shfl_sync(FULL_MASK, w, 0);
      sink ^= (unsigned)w;
    }
  }
  if (DO_MODAL) {
    for (int j = lane; j < W; j += 32) tab[wcode[j]] = 0;
    __syncwarp();
    clk.lap(ST_MODAL, lane);
  } else {
    M = W;
    asm volatile("" ::"r"(sink));  // the window codes stay computed
  }
}

// Exact non-overlapping count of `target` (K digits) in the read
// (warp-uniform). Bits 12-14 of pc[p] say how many bases ending at p may
// match (at most 6), so a K-mer ends at p when they are at least K and the
// low 2K bits equal the target.
template <int K, typename Clock>
__device__ __forceinline__ int warp_recount(const uint16_t* pc, int len,
                                            int target, int lane,
                                            Clock& clk) {
  clk.lap(ST_SELECT, lane);
  int exact = 0, next_free = 0;
  for (int base = 0; base < len; base += 32) {
    const int p = base + lane;
    const int v = p < len ? pc[p] : 0;
    unsigned m = __ballot_sync(FULL_MASK, (v >> 12) >= K &&
                                              (v & ((1 << (2 * K)) - 1)) == target);
    // a hit ending at base + b starts at base + b - K + 1 and counts when
    // that start is at or past next_free
    int lowest = next_free + K - 1 - base;
    while (lowest < 32) {
      if (lowest > 0) m &= ~0u << lowest;
      if (m == 0) break;
      const int b = __ffs(m) - 1;
      ++exact;
      next_free = base + b + 1;
      lowest = b + K;
    }
  }
  clk.lap(ST_RECOUNT, lane);
  return exact;
}

// One step of the k-selection state machine (utils.nim:243-269), computing
// k's modal and exact count only when the machine reads them: once it is
// done, or when k's modal count cannot beat the best score, the rest is not
// needed (the answer is the same as computing every k).
template <int K, bool DO_MODAL, bool DO_GREEDY, typename TabT,
          typename Clock>
__device__ __forceinline__ void warp_select(const uint16_t* pc, int len,
                                            TabT* tab, uint16_t* wcode,
                                            int lane, Clock& clk, int te,
                                            int tp, int& best, bool& done,
                                            int& klen, int& cnt, int& code) {
  if (done) return;
  int M, modal;
  warp_modal<K, DO_MODAL>(pc, len, tab, wcode, lane, clk, M, modal);
  const int target = modal < 0 ? (1 << (2 * K)) - 1 : modal;
  if (M * K <= best) {
    if (M < te) done = true;
    return;
  }
  const int exact =
      DO_GREEDY ? warp_recount<K>(pc, len, target, lane, clk) : M;
  if (exact * K < best) return;
  best = exact * K;
  if (exact > tp) {
    klen = K;
    cnt = exact;
    code = target;
  }
}

template <int LAYOUT, int VARIANT, typename TabT>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
    repeat_scan_warp_kernel(const uint8_t* __restrict__ in, int64_t n_rows,
                            int64_t row_stride, int L,
                            const uint8_t* __restrict__ nbits_in,
                            const int32_t* __restrict__ lengths_in,
                            const int32_t* __restrict__ te_in,
                            const int32_t* __restrict__ tp_in,
                            int32_t* __restrict__ code_out,
                            int32_t* __restrict__ len_out,
                            int32_t* __restrict__ cnt_out) {
  constexpr bool CLOCKED = VARIANT == STAGES;
  constexpr bool DO_MODAL = VARIANT == FULL || VARIANT == NO_GREEDY || CLOCKED;
  constexpr bool DO_GREEDY = VARIANT == FULL || VARIANT == NO_MODAL || CLOCKED;
  // per warp: [4096] count table, [lpad / 2] u16 window codes, [lpad]
  // unpacked bases (ASCII rows), [lpad] u16 position codes; after every
  // warp's, STAGES keeps NSTAGES u32 counters a warp
  constexpr int TABLE_BYTES = TABLE_ENTRIES * sizeof(TabT);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lpad = (L + 15) & ~15;
  unsigned char* mine = smem + (size_t)warp * (TABLE_BYTES + 4 * lpad);
  TabT* tab = reinterpret_cast<TabT*>(mine);
  uint16_t* wcode = reinterpret_cast<uint16_t*>(mine + TABLE_BYTES);
  uint8_t* s = mine + TABLE_BYTES + lpad;
  uint16_t* pc = reinterpret_cast<uint16_t*>(mine + TABLE_BYTES + 2 * lpad);
  StageClock<CLOCKED> clk;
  if constexpr (CLOCKED) {
    clk.acc = reinterpret_cast<unsigned*>(
                  smem + (size_t)WARPS * (TABLE_BYTES + 4 * lpad)) +
              warp * NSTAGES;
    if (lane < NSTAGES) clk.acc[lane] = 0;
    __syncwarp();
    clk.start();
  }
  if (DO_MODAL) {
    for (int i = lane; i < TABLE_BYTES / 16; i += 32)
      reinterpret_cast<uint4*>(tab)[i] = make_uint4(0, 0, 0, 0);
    clk.lap(ST_MODAL, lane);
  }
  const int64_t stride = (int64_t)gridDim.x * WARPS;
  for (int64_t r = (int64_t)blockIdx.x * WARPS + warp; r < n_rows; r += stride) {
    __syncwarp();  // the previous read's shared memory is no longer read
    const uint8_t* row = in + r * row_stride;
    // lanes 0-4 te, 5-9 tp, 10 the length
    int mv = 0;
    if (LAYOUT == ASCII || LAYOUT == PACKED) {
      if (lane < NK) mv = te_in[r * NK + lane];
      else if (lane < 2 * NK) mv = tp_in[r * NK + lane - NK];
      else if (lane == 2 * NK) mv = lengths_in[r];
    } else if (lane <= 2 * NK) {
      const uint8_t* meta = row + (LAYOUT == N8 ? L / 4 : 3 * L / 8);
      mv = LAYOUT == W16 ? (meta[2 * lane] | (meta[2 * lane + 1] << 8))
                         : meta[lane];
    }
    const int len = max(0, min(__shfl_sync(FULL_MASK, mv, 2 * NK), L));

    // pc[p]: the 6-digit code of the bases ending at p (p's digit least
    // significant) and, in bits 12-14, how many bases ending at p may match
    // (none before the read's start; at most 6). The loads do not wait for
    // the length; the Ns of [0, len) are counted on the way.
    int n_lane = 0;
    if (LAYOUT == ASCII) {
      // one byte per base in s first, then pc from s
      for (int p = lane; p < L; p += 32) {
        const int b = row[p];
        s[p] = (uint8_t)(((b >> 1) & 3) | (ascii_flagged(b) ? NO_MATCH : 0));
        n_lane += b == 'N' && p < len;
      }
      __syncwarp();
      for (int p = lane; p < len; p += 32) {
        int code = 0, nomatch = 0;
#pragma unroll
        for (int d = 5; d >= 0; --d) {
          const int b = p - d >= 0 ? s[p - d] : NO_MATCH;
          code = (code << 2) | (b & 3);
          nomatch |= ((b >> 2) & 1) << d;
        }
        pc[p] = (uint16_t)(code | (__ffs(nomatch | 0x40) - 1) << 12);
      }
    } else {
      // 2-bit rows: lane t takes byte t (bases 4t..4t+3, base 4t + i in
      // bits 2i) and its N nibble (w8/w16: N bit of base p is bit p & 7 of
      // N byte p >> 3), with bytes t - 1 and t - 2 from its neighbours (the
      // previous 32 bytes' last lanes for lanes 0 and 1; before the read,
      // digits 0 that never match)
      const uint8_t* nb = LAYOUT == PACKED ? nbits_in + r * (L >> 3)
                                           : row + (L >> 2);
      const int up1 = (lane + 31) & 31, up2 = (lane + 30) & 31;
      unsigned b_last = 0, n_last = 0xFu;
      for (int t0 = 0; t0 < (L >> 2); t0 += 32) {
        const int t = t0 + lane;
        const bool in = t < (L >> 2);
        const unsigned b = in ? row[t] : 0u;
        unsigned nib = 0;
        if (LAYOUT != N8 && in) nib = (nb[t >> 1] >> (4 * (t & 1))) & 0xFu;
        n_lane += __popc(nib & ((1u << max(0, min(4, len - 4 * t))) - 1u));
        const unsigned xb1 = __shfl_sync(FULL_MASK, b, up1);
        const unsigned yb1 = __shfl_sync(FULL_MASK, b_last, up1);
        const unsigned xb2 = __shfl_sync(FULL_MASK, b, up2);
        const unsigned yb2 = __shfl_sync(FULL_MASK, b_last, up2);
        const unsigned xn1 = __shfl_sync(FULL_MASK, nib, up1);
        const unsigned yn1 = __shfl_sync(FULL_MASK, n_last, up1);
        const unsigned xn2 = __shfl_sync(FULL_MASK, nib, up2);
        const unsigned yn2 = __shfl_sync(FULL_MASK, n_last, up2);
        b_last = b;
        n_last = nib;
        // bases 4t-8..4t+3: digits at bits 2g, N bits at bit g
        const unsigned w = (lane >= 2 ? xb2 : yb2) |
                           (lane >= 1 ? xb1 : yb1) << 8 | b << 16;
        const unsigned f = (lane >= 2 ? xn2 : yn2) |
                           (lane >= 1 ? xn1 : yn1) << 4 | nib << 8;
        // reverse the order of the 2-bit groups: group g -> group 15 - g
        unsigned rev = __brev(w);
        rev = ((rev >> 1) & 0x55555555u) | ((rev & 0x55555555u) << 1);
        unsigned v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // base p = 4t + i: its digit is group 8 + i of w, so digit p - d
          // is group 7 - i + d of rev; flag p - 5 + e is bit i + 3 + e of f
          const unsigned code = (rev >> (2 * (7 - i))) & 0xFFFu;
          const unsigned g = (f >> (i + 3)) & 0x3Fu;
          v[i] = code | __clz((g << 26) | (1u << 25)) << 12;
        }
        if (in)
          *reinterpret_cast<uint2*>(pc + 4 * t) =
              make_uint2(v[0] | v[1] << 16, v[2] | v[3] << 16);
      }
    }
    const int n_count = (int)__reduce_add_sync(FULL_MASK, (unsigned)n_lane);
    if (n_count > 20) {  // utils.nim:238
      if (lane == 0) {
        code_out[r] = 0;
        len_out[r] = 0;
        cnt_out[r] = 0;
      }
      clk.lap(ST_LOAD, lane);
      continue;
    }
    __syncwarp();  // pc is written before any lane reads it
    clk.lap(ST_LOAD, lane);

    int te[NK], tp[NK];
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      te[i] = __shfl_sync(FULL_MASK, mv, i);
      tp[i] = __shfl_sync(FULL_MASK, mv, NK + i);
    }
    int best = -1, klen = 0, cnt = 0, code = 0;
    bool done = false;
    warp_select<2, DO_MODAL, DO_GREEDY>(pc, len, tab, wcode, lane, clk,
                                        te[0], tp[0], best, done, klen,
                                        cnt, code);
    warp_select<3, DO_MODAL, DO_GREEDY>(pc, len, tab, wcode, lane, clk,
                                        te[1], tp[1], best, done, klen,
                                        cnt, code);
    warp_select<4, DO_MODAL, DO_GREEDY>(pc, len, tab, wcode, lane, clk,
                                        te[2], tp[2], best, done, klen,
                                        cnt, code);
    warp_select<5, DO_MODAL, DO_GREEDY>(pc, len, tab, wcode, lane, clk,
                                        te[3], tp[3], best, done, klen,
                                        cnt, code);
    warp_select<6, DO_MODAL, DO_GREEDY>(pc, len, tab, wcode, lane, clk,
                                        te[4], tp[4], best, done, klen,
                                        cnt, code);
    reduce_homopolymer(code, klen, cnt);
    if (lane == 0) {
      code_out[r] = code;
      len_out[r] = klen;
      cnt_out[r] = cnt;
    }
    clk.lap(ST_SELECT, lane);
  }
  if constexpr (CLOCKED) {
    __syncwarp();
    if (lane < NSTAGES)
      atomicAdd(&g_stage_cycles[lane], (unsigned long long)clk.acc[lane]);
  }
}

// ----------------------------------------------- thread per read (sorted)

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
    if (LAYOUT == ASCII) return ascii_flagged(__ldg(row + p));
    if (LAYOUT == N8) return false;
    if (LAYOUT == PACKED) return (__ldg(nbits + (p >> 3)) >> (p & 7)) & 1;
    return (__ldg(row + (L >> 2) + (p >> 3)) >> (p & 7)) & 1;
  }
  __device__ __forceinline__ bool is_n(int p) const {
    if (LAYOUT == ASCII) return __ldg(row + p) == 'N';
    return flagged(p);  // 2-bit rows are ACGTN-only: the flag is the N bit
  }
};

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

template <int LAYOUT, int VARIANT>
__global__ void repeat_scan_sorted_kernel(const uint8_t* __restrict__ in,
                                          int64_t n_rows, int64_t row_stride,
                                          int L,
                                          const uint8_t* __restrict__ nbits_in,
                                          const int32_t* __restrict__ lengths_in,
                                          const int32_t* __restrict__ te_in,
                                          const int32_t* __restrict__ tp_in,
                                          int32_t* __restrict__ code_out,
                                          int32_t* __restrict__ len_out,
                                          int32_t* __restrict__ cnt_out) {
  static_assert(VARIANT == FULL || VARIANT == NO_GREEDY,
                "the sorted form only differs where a modal is computed");
  constexpr bool DO_GREEDY = VARIANT == FULL;
  // per thread: [P3] int32 sort keys, stride blockDim.x
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int T = blockDim.x;
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
    kcount[0] = M;
    target[0] = modal < 0 ? 15 : modal;
  }
  // k = 3..6
#pragma unroll
  for (int ki = 1; ki < NK; ++ki) {
    const int k = ki + 2;
    int M = 0;
    const int modal = modal_sorted(rd, len / k, k, ks, T, M);
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
  int best = -1, klen = 0, cnt = 0, code = 0;
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
      klen = k;
      cnt = exact[ki];
      code = target[ki];
    }
  }
  reduce_homopolymer(code, klen, cnt);
  code_out[r] = code;
  len_out[r] = klen;
  cnt_out[r] = cnt;
}

// ---------------------------------------------------------------- launch

struct Args {
  const uint8_t* in;
  int64_t n_rows, row_stride;
  int L;
  const uint8_t* nbits;
  const int32_t *lengths, *te, *tp;
  int32_t *code, *len, *cnt;
  cudaStream_t stream;
  int* design;  // set to the Design of the kernel launched
};

using KernelFn = void (*)(const uint8_t*, int64_t, int64_t, int,
                          const uint8_t*, const int32_t*, const int32_t*,
                          const int32_t*, int32_t*, int32_t*, int32_t*);

// The attributes belong to the function on each card and never change: set
// them once a card (one bit of `done` for each of the first 64).
cudaError_t set_attributes(KernelFn kernel, int carveout,
                           std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           carveout);
  if (e != cudaSuccess) return e;
  done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

cudaError_t launch_kernel(KernelFn kernel, Design design, const Args& a,
                          int64_t blocks, int threads, size_t smem) {
  kernel<<<(unsigned)blocks, threads, smem, a.stream>>>(
      a.in, a.n_rows, a.row_stride, a.L, a.nbits, a.lengths, a.te, a.tp,
      a.code, a.len, a.cnt);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && a.design) *a.design = design;
  return e;
}

template <int LAYOUT, int VARIANT, typename TabT>
cudaError_t launch_warp_table(const Args& a) {
  static std::atomic<uint64_t> done{0};
  const KernelFn kernel = repeat_scan_warp_kernel<LAYOUT, VARIANT, TabT>;
  const size_t lpad = ((size_t)a.L + 15) & ~size_t{15};
  const size_t smem = WARPS * (TABLE_ENTRIES * sizeof(TabT) + 4 * lpad) +
                      (VARIANT == STAGES ? WARPS * NSTAGES * sizeof(unsigned)
                                         : 0);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  // the kernel wants shared memory, not L1: its global loads are coalesced
  // and read once
  cudaError_t e = set_attributes(kernel, cudaSharedmemCarveoutMaxShared, done);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    WARPS * 32, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // as many blocks as the card holds at once; each warp strides over reads
  const int64_t needed = (a.n_rows + WARPS - 1) / WARPS;
  const int64_t resident = (int64_t)per_sm * sms;
  return launch_kernel(kernel, WARP_PER_READ, a,
                       needed < resident ? needed : resident, WARPS * 32,
                       smem);
}

template <int LAYOUT, int VARIANT>
cudaError_t launch_sorted(const Args& a) {
  static std::atomic<uint64_t> done{0};
  const KernelFn kernel = repeat_scan_sorted_kernel<LAYOUT, VARIANT>;
  // shared memory holds each thread's k = 3 window keys (the most windows
  // of the k >= 3 passes) as int32, padded to a power of two; halve the
  // block until it fits
  const size_t w3 = a.L / 3 > 0 ? a.L / 3 : 1;
  size_t p3 = 1;
  while (p3 < w3) p3 <<= 1;
  if (p3 > SORTED_MAX_KEYS) return cudaErrorInvalidValue;
  const size_t per_thread = p3 * sizeof(int32_t);
  int threads = 128;
  size_t smem = threads * per_thread;
  while (threads > 32 && smem > 96 * 1024) {
    threads /= 2;
    smem = threads * per_thread;
  }
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  // Half of each SM's unified memory as shared memory, half as L1 (a hint;
  // a block that needs more still gets it). Left to CUDA's choice, the
  // thread-per-read forms' byte walks over ASCII rows (a warp's loads fall
  // on 32 rows) thrashed the L1 that was left: 1.3x slower for the sorted
  // modal on 32768x152 ASCII rows (measured on an H100, PERF.md).
  cudaError_t e = set_attributes(kernel, 50, done);
  if (e != cudaSuccess) return e;
  return launch_kernel(kernel, THREAD_PER_READ, a,
                       (a.n_rows + threads - 1) / threads, threads, smem);
}

// the table's entries are as narrow as the row's longest count allows: more
// warps fit on an SM
template <int LAYOUT, int VARIANT>
cudaError_t launch_warp(const Args& a) {
  return a.L <= U8_TABLE_MAX_L
             ? launch_warp_table<LAYOUT, VARIANT, uint8_t>(a)
             : launch_warp_table<LAYOUT, VARIANT, uint16_t>(a);
}

template <int LAYOUT>
cudaError_t launch_form(const Args& a, int modal, int variant) {
  // the sorted form only differs where a modal is computed
  if (modal == SORTED && variant == FULL) return launch_sorted<LAYOUT, FULL>(a);
  if (modal == SORTED && variant == NO_GREEDY)
    return launch_sorted<LAYOUT, NO_GREEDY>(a);
  if (modal != PAIRWISE && modal != SORTED) return cudaErrorInvalidValue;
  switch (variant) {
    case FULL: return launch_warp<LAYOUT, FULL>(a);
    case NO_GREEDY: return launch_warp<LAYOUT, NO_GREEDY>(a);
    case NO_MODAL: return launch_warp<LAYOUT, NO_MODAL>(a);
    case WINMIN_ONLY: return launch_warp<LAYOUT, WINMIN_ONLY>(a);
    case STAGES: return launch_warp<LAYOUT, STAGES>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// layout: 0 ASCII rows, 4 2-bit rows with an N bitmask `nbits` [n_rows, L/8]
// (both with lengths [n_rows], te/tp [n_rows, 5] int32), or 1 n8, 2 w8,
// 3 w16 payload rows (lengths/te/tp read from each row's meta bytes; pass
// null). modal: 0 pairwise, 1 sorted (at most 1024 keys: L/3 <= 1024).
// variant: 0 full, 1 no_greedy, 2 no_modal, 3 winmin_only, 4 full clocked by
// stage (pairwise only; see repeat_scan_stage_cycles). On a launch, *design
// is set to the kernel's design: 0 warp per read, 1 thread per read.
extern "C" int repeat_scan_launch(const void* in, long long n_rows,
                                  long long row_stride, int layout, int L,
                                  const void* nbits, const void* lengths,
                                  const void* te, const void* tp, int modal,
                                  int variant, void* code, void* len,
                                  void* cnt, void* stream, int* design) {
  if (n_rows <= 0) return 0;
  if (modal == SORTED && variant == STAGES) return cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(in), n_rows, row_stride, L,
               static_cast<const uint8_t*>(nbits),
               static_cast<const int32_t*>(lengths),
               static_cast<const int32_t*>(te),
               static_cast<const int32_t*>(tp), static_cast<int32_t*>(code),
               static_cast<int32_t*>(len), static_cast<int32_t*>(cnt),
               static_cast<cudaStream_t>(stream), design};
  switch (layout) {
    case ASCII: return launch_form<ASCII>(a, modal, variant);
    case N8: return launch_form<N8>(a, modal, variant);
    case W8: return launch_form<W8>(a, modal, variant);
    case W16: return launch_form<W16>(a, modal, variant);
    case PACKED: return launch_form<PACKED>(a, modal, variant);
    default: return cudaErrorInvalidValue;
  }
}

// The STAGES form's cycles by stage (load, windows, modal, recount, select),
// summed over its launches on the current card since the last call, into
// `out` [5] on the host; the counters are then cleared. Waits for `stream`.
extern "C" int repeat_scan_stage_cycles(unsigned long long* out,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyFromSymbolAsync(out, g_stage_cycles,
                                            sizeof(g_stage_cycles), 0,
                                            cudaMemcpyDeviceToHost, st);
  if (e != cudaSuccess) return e;
  const unsigned long long zero[NSTAGES] = {};
  e = cudaMemcpyToSymbolAsync(g_stage_cycles, zero, sizeof(zero), 0,
                              cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return e;
  return cudaStreamSynchronize(st);
}
