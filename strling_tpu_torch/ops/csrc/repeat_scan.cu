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
// form is a compile-time specialisation of one kernel,
// repeat_scan_warp_kernel, chosen by the plain-C launcher.
//
// One warp per read, for both modals and every variant. The TPU kernel lays
// reads across vector lanes and turns every per-read loop into band matmuls
// and lane-packed bit tricks; a thread per read (this kernel's first form)
// left a 4096-read batch on 32 of the 132 SMs and walked each read serially.
// Here the 32 lanes share a read:
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
//   - recount: lanes test 32 end positions a step; a ballot collects the
//     hits and the greedy non-overlapping pick walks the set bits,
//     identically on every lane, carrying next_free across steps;
//   - lane 0 writes the warp-uniform result.
// Only the k >= 3 modal differs between the modals (MODAL); k = 2 counts
// its 16 codes by value in both, as the TPU kernel does (:335-349):
//   - pairwise (the default): the reach-max-first identity of the TPU
//     kernel's _modal_pairwise: the winner is the earliest window whose
//     running occurrence count reaches the maximum, so a running argmax
//     over occ(j) = 1 + #{i < j : w_i == w_j} reproduces the reference
//     exactly. occ(j) is O(1) per window: a per-warp count table of 4^6
//     entries in shared memory holds the earlier chunks' counts, and
//     __match_any_sync gives the earlier lanes of this chunk with the same
//     code; each group's lowest lane then adds the group's size to the
//     table. A warp max and a ballot give the chunk's (max, first lane), so
//     the running argmax advances a chunk at a time. After each k the
//     entries the read touched are set back to 0 (the table is cleared
//     when the warp starts). The entries are u8 for rows up to 511
//     bases (no code occurs more than 255 times) and u16 beyond. The TPU
//     kernel's SWAR field packing is not carried over: it overflows for
//     reads over 192bp (fault F1);
//   - sorted: the keys code << 12 | window sort ascending, so each code's
//     windows form a run in window order, whose length is the code's total
//     and whose last key holds its last occurrence; the winner has the
//     longest run and, among equal lengths, the earliest last occurrence
//     (the same reach-max-first rule). Up to 64 windows the keys stay in
//     registers, two a lane (key i in lane i >> 1), and a bitonic network
//     sorts them: 21 steps, 15 of them across lanes by __shfl_xor_sync (the
//     stride-1 steps stay in the lane). Then the run walk: a key starts a
//     run where its code differs from the previous key's (the lane's other
//     key, or a shuffle from the neighbour), two ballots give the masks of
//     starts, a run ending at key i starts at the highest start <= i, and
//     the rank len << 12 | (4095 - last) of each run's end goes through
//     __reduce_max_sync; a ballot names the lane whose code won. Past 64
//     windows (k = 3 on rows over 194 bases) the keys go to the warp's
//     shared memory: each 64-key block is sorted in registers, the
//     network's strides of 64 and more run in shared memory with the lanes
//     taking the compare-exchanges and __syncwarp between steps, strides
//     below 64 in registers again; the walk then takes 64 keys at a time,
//     carrying the run start from block to block. The window index gets 12
//     bits (up to 4095 windows; the longest row, MAX_L bases, has 3,333 at
//     k = 3): the TPU form's 6-bit field corrupts the tie-break past 64
//     windows (fault F6).
// Blocks hold WARPS warps, a read each, and the grid covers the batch: the
// block scheduler hands a block to an SM as one finishes, which evens out
// the last round. (A grid of the blocks the card keeps resident, each warp
// striding over reads and clearing its table once, took 2-10% longer for
// both modals at 32768 and 65536 rows on an H100: a warp that drew one
// read more than the average set the end; PERF.md.)
//
// Variants (the TPU kernel's stage-disabled forms, for the stage tool only):
// NO_GREEDY takes the modal count as the exact count; NO_MODAL takes the
// first window's code as the modal and the number of windows as its count
// (the window codes are still computed); WINMIN_ONLY does both (these two
// compute no modal, so the sorted modal's launch runs the pairwise
// specialisation). A variant's counts steer the lazy k-selection too:
// NO_MODAL's count keeps every k in play, so it runs five recounts where
// FULL recounts k = 2 alone on most reads, and FULL minus a variant is not a
// stage's cost. The stages are attributed by STAGES instead (for either
// modal): FULL, with each warp adding the clock cycles it spent in each
// stage (loading and position codes, window codes, modal, recount, the
// rest) to g_stage_cycles, which repeat_scan_stage_cycles reads and clears.
//
// Output is code, length and count as three int32 arrays. The count is not
// packed into 8 bits (fault F2: a 256bp homopolymer counts 256, as the
// reference detector says). The launcher reports the design of the kernel
// it launched (WARP_PER_READ) through `design`.
//
// What bounds it on the card: neither bytes (about 60 per read) nor integer
// operations (about 4.0k on a random 152bp read, for the k the selection
// reaches: exp_kernel_timing.scan_ops) but the latency of each read's chain
// of dependent warp collectives and shared-memory accesses; the design's
// answer is many reads in flight (one warp each). Shared memory per warp
// (the pairwise count table, then 4 bytes a base) bounds how many warps an
// SM holds for the pairwise modal: 44 at 152 bases with the u8 table. The
// sorted modal keeps 3 bytes a base and a 32-byte table (no keys up to 194
// bases), so registers bound it instead: 48 warps at the 40-register cap.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Layout : int { ASCII = 0, N8 = 1, W8 = 2, W16 = 3, PACKED = 4 };
enum Modal : int { PAIRWISE = 0, SORTED = 1 };
enum Variant : int {
  FULL = 0, NO_GREEDY = 1, NO_MODAL = 2, WINMIN_ONLY = 3,
  STAGES = 4,  // FULL, clocked by stage
};
enum Design : int { WARP_PER_READ = 0 };
// the stages STAGES clocks, in g_stage_cycles' order
enum Stage : int {
  ST_LOAD = 0, ST_WINDOWS = 1, ST_MODAL = 2, ST_RECOUNT = 3, ST_SELECT = 4,
};
constexpr int NSTAGES = 5;

constexpr int NK = 5;  // k = 2..6
constexpr int WIDX_BITS = 12;
constexpr unsigned WIDX_MASK = (1u << WIDX_BITS) - 1;
constexpr unsigned NO_KEY = 0xffffffffu;  // pads a sort: after every key
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARPS = 4;  // warps per block
// blocks an SM should hold, which caps the kernel at 40 registers a thread:
// left to itself ptxas gave the pairwise n8 detector 46, which the card
// allocates as 48, so an SM held 40 warps where shared memory allows 44 at
// 152 bases (measured on an H100: 0.0655 ms against 0.0554 per 32768x152
// batch, no spills either way; PERF.md). The sorted modal takes the same
// cap, spilling 0-20 bytes in its full forms: at 48 registers it spilled
// nothing but an SM held 40 warps instead of 48, and took 0.0852 ms against
// 0.0664 per 32768x152 n8 batch (H100; PERF.md)
constexpr int MIN_BLOCKS = 12;
constexpr int TABLE_ENTRIES = 4096;  // 4^6 window codes
constexpr int K2_CODES = 16;         // 4^2: the sorted modal's k = 2 table
// rows up to this many bases count in u8 table entries: no code occurs more
// than L / 2 times (k = 2 has the most windows)
constexpr int U8_TABLE_MAX_L = 511;
// the sorted modal's keys stay in registers up to this many windows
constexpr int REG_KEYS = 64;
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

// The sorted modal's keys in a warp's shared memory: none where every k's
// windows fit the registers (L / 3 <= REG_KEYS: rows up to 194 bases), else
// k = 3's (the most windows) padded to a power of two
__host__ __device__ inline int sorted_smem_keys(int L) {
  const int w = L / 3;
  if (w <= REG_KEYS) return 0;
  int p = 2 * REG_KEYS;
  while (p < w) p <<= 1;
  return p;
}

// Shared-memory bytes of one warp: the count table (pairwise: 4^6 entries;
// sorted: k = 2's 16), the pairwise modal's u16 window codes (lpad bytes),
// the unpacked read (lpad), the u16 position codes (2 lpad) and the sorted
// modal's keys. A multiple of 16.
template <int MODAL, typename TabT>
__host__ __device__ inline size_t warp_smem_bytes(int L) {
  const size_t lpad = ((size_t)L + 15) & ~size_t{15};
  if (MODAL == SORTED)
    return K2_CODES * sizeof(TabT) + 3 * lpad + 4 * (size_t)sorted_smem_keys(L);
  return TABLE_ENTRIES * sizeof(TabT) + 4 * lpad;
}

// ------------------------------------------------------------ the stages

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

// -------------------------------------------------------- pairwise modal

// One k of the warp's read: the modal window code (-1 with no window) and
// its count M, warp-uniform. pc[p] holds the 6-digit code ending at base p,
// so window j's digits are the low 2K bits of pc[jK + K - 1]. `tab` is the
// warp's zeroed count table and is left zeroed: k = 2 touches only its 16
// codes, which are cleared directly; a larger K keeps its window codes in
// `wcode` for that.
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
        if constexpr (K > 2) wcode[j] = (uint16_t)w;
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
    if constexpr (K == 2) {
      if (lane < K2_CODES) tab[lane] = 0;
    } else {
      for (int j = lane; j < W; j += 32) tab[wcode[j]] = 0;
    }
    __syncwarp();
    clk.lap(ST_MODAL, lane);
  } else {
    M = W;
    asm volatile("" ::"r"(sink));  // the window codes stay computed
  }
}

// ---------------------------------------------------------- sorted modal

// 64 keys a warp, key i in lane i >> 1: register a for even i, b for odd.
// The bitonic network's compare-exchange of a lane's key with the same
// register's key in the lane d away (the network's stride 2d): the pair's
// lower key is in the lane whose bit d is clear, and it keeps the smaller
// key where the pair's order is ascending (`up`).
__device__ __forceinline__ unsigned cx_lanes(unsigned v, int d, bool up,
                                             int lane) {
  const unsigned p = __shfl_xor_sync(FULL_MASK, v, d);
  return ((lane & d) == 0) == up ? min(v, p) : max(v, p);
}

// Stride 1: the lane's own two keys.
__device__ __forceinline__ void cx_in_lane(unsigned& a, unsigned& b,
                                           bool up) {
  const unsigned lo = min(a, b), hi = max(a, b);
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// merge64 sorts a bitonic sequence of the 64 keys into `asc`ending order
// (the half-cleaners of strides 32..2 across lanes, then 1 within each);
// sort64 sorts any 64 keys (stages 2..32 of the network, then merge64): 21
// steps, 15 of them by shuffles.
__device__ __forceinline__ void merge64(unsigned& a, unsigned& b, bool asc,
                                        int lane) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    a = cx_lanes(a, d, asc, lane);
    b = cx_lanes(b, d, asc, lane);
  }
  cx_in_lane(a, b, asc);
}

__device__ __forceinline__ void sort64(unsigned& a, unsigned& b, bool asc,
                                       int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    // a stage's pairs run ascending where bit `size` of the key's index,
    // bit size / 2 of the lane, is clear
    const bool up = (lane & (size >> 1)) == 0;
#pragma unroll
    for (int d = size >> 2; d > 0; d >>= 1) {
      a = cx_lanes(a, d, up, lane);
      b = cx_lanes(b, d, up, lane);
    }
    cx_in_lane(a, b, up);
  }
  merge64(a, b, asc, lane);
}

// The key index in a block of the highest set bit of a mask of run starts
// (bit l: key 2l + odd), or -1
__device__ __forceinline__ int top_key(unsigned m, int odd) {
  return m ? 2 * (31 - __clz(m)) + odd : -1;
}

// The run walk over 64 sorted keys (a, b) that are keys c..c+63 of the W
// valid ones. A run is the keys of one code; at the key that ends a run the
// rank is len << 12 | (4095 - last window): each lane keeps the best rank
// it saw and that run's code (`best`, `best_code`). `prev_code` and
// `run_start` carry the code and run start of key c - 1 into the block and
// those of key c + 63 out of it; `next_code` is key c + 64's code where
// there is one.
__device__ __forceinline__ void walk64(unsigned a, unsigned b, int c, int W,
                                       unsigned next_code, int lane,
                                       unsigned& prev_code, int& run_start,
                                       unsigned& best, unsigned& best_code) {
  const unsigned ca = a >> WIDX_BITS, cb = b >> WIDX_BITS;
  const unsigned up_b = __shfl_up_sync(FULL_MASK, cb, 1);
  const unsigned dn_a = __shfl_down_sync(FULL_MASK, ca, 1);
  const int ia = c + 2 * lane, ib = ia + 1;
  const bool va = ia < W, vb = ib < W;
  // the codes of the key before a and of the key after b
  const unsigned pa = lane == 0 ? prev_code : up_b;
  const unsigned nb = lane == 31 ? next_code : dn_a;
  const unsigned sa = __ballot_sync(FULL_MASK, va && ca != pa);
  const unsigned sb = __ballot_sync(FULL_MASK, vb && cb != ca);
  // a run ending at key i starts at the highest start <= i, or before the
  // block: for a, the starts of lanes up to this one's a and before its b
  const unsigned upto = FULL_MASK >> (31 - lane);
  const unsigned below = lane ? FULL_MASK >> (32 - lane) : 0u;
  const int sa_upto = top_key(sa & upto, 0);
  const int ra = max(sa_upto, top_key(sb & below, 1));
  const int rb = max(sa_upto, top_key(sb & upto, 1));
  if (va && (ia + 1 == W || cb != ca)) {
    const unsigned rank =
        (unsigned)(ia - (ra >= 0 ? c + ra : run_start) + 1) << WIDX_BITS |
        (WIDX_MASK - (a & WIDX_MASK));
    if (rank > best) {
      best = rank;
      best_code = ca;
    }
  }
  if (vb && (ib + 1 == W || nb != cb)) {
    const unsigned rank =
        (unsigned)(ib - (rb >= 0 ? c + rb : run_start) + 1) << WIDX_BITS |
        (WIDX_MASK - (b & WIDX_MASK));
    if (rank > best) {
      best = rank;
      best_code = cb;
    }
  }
  prev_code = __shfl_sync(FULL_MASK, cb, 31);
  const int last = max(top_key(sa, 0), top_key(sb, 1));
  if (last >= 0) run_start = c + last;
}

// One k >= 3 of the warp's read by the sorted modal: as warp_modal. `keys`
// is the warp's shared-memory slice for more than REG_KEYS windows.
template <int K, typename Clock>
__device__ __forceinline__ void warp_modal_sorted(const uint16_t* pc,
                                                  int len, unsigned* keys,
                                                  int lane, Clock& clk,
                                                  int& M, int& modal) {
  const int W = len / K;
  clk.lap(ST_SELECT, lane);
  const auto key = [&](int j) -> unsigned {
    return (unsigned)min_rotation(pc[j * K + K - 1] & ((1 << (2 * K)) - 1), K)
               << WIDX_BITS | (unsigned)j;
  };
  unsigned prev_code = NO_KEY, best = 0, best_code = 0;
  int run_start = 0;
  if (W <= REG_KEYS) {
    unsigned a = 2 * lane < W ? key(2 * lane) : NO_KEY;
    unsigned b = 2 * lane + 1 < W ? key(2 * lane + 1) : NO_KEY;
    clk.lap(ST_WINDOWS, lane);
    sort64(a, b, true, lane);
    walk64(a, b, 0, W, NO_KEY, lane, prev_code, run_start, best, best_code);
  } else {
    int P = 2 * REG_KEYS;
    while (P < W) P <<= 1;
    for (int i = lane; i < P; i += 32) keys[i] = i < W ? key(i) : NO_KEY;
    clk.lap(ST_WINDOWS, lane);
    // the network's stages up to 64: each block of 64 keys in registers,
    // ascending where bit 64 of its index is clear (after the fill each
    // lane reads and writes only its own two keys of a block: no barrier
    // between blocks)
    uint2* pairs = reinterpret_cast<uint2*>(keys);
    __syncwarp();
    for (int c = 0; c < P; c += 64) {
      uint2 k = pairs[c / 2 + lane];
      sort64(k.x, k.y, (c & 64) == 0, lane);
      pairs[c / 2 + lane] = k;
    }
    for (int size = 128; size <= P; size <<= 1) {
      // strides of 64 and more across the blocks in shared memory
      for (int s = size >> 1; s >= 64; s >>= 1) {
        __syncwarp();
        for (int t = lane; t < P / 2; t += 32) {
          const int i = ((t & ~(s - 1)) << 1) | (t & (s - 1));
          const unsigned x = keys[i], y = keys[i + s];
          if ((x > y) == ((i & size) == 0)) {
            keys[i] = y;
            keys[i + s] = x;
          }
        }
      }
      __syncwarp();
      // strides 32..1 stay within a block, in one direction per block
      for (int c = 0; c < P; c += 64) {
        uint2 k = pairs[c / 2 + lane];
        merge64(k.x, k.y, (c & size) == 0, lane);
        pairs[c / 2 + lane] = k;
      }
    }
    __syncwarp();
    for (int c = 0; c < W; c += 64) {
      const uint2 k = pairs[c / 2 + lane];
      const unsigned next = c + 64 < W ? keys[c + 64] >> WIDX_BITS : NO_KEY;
      walk64(k.x, k.y, c, W, next, lane, prev_code, run_start, best,
             best_code);
    }
    __syncwarp();  // the keys are read before the next k writes them
  }
  // a run's rank is at least 1 << 12: 0 means no window
  const unsigned top = __reduce_max_sync(FULL_MASK, best);
  const int won = __ffs(__ballot_sync(FULL_MASK, best == top)) - 1;
  const unsigned code = __shfl_sync(FULL_MASK, best_code, won);
  M = (int)(top >> WIDX_BITS);
  modal = top ? (int)code : -1;
  clk.lap(ST_MODAL, lane);
}

// -------------------------------------------------- recount and selection

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
template <int K, int MODAL, bool DO_MODAL, bool DO_GREEDY, typename TabT,
          typename Clock>
__device__ __forceinline__ void warp_select(const uint16_t* pc, int len,
                                            TabT* tab, uint16_t* wcode,
                                            unsigned* keys, int lane,
                                            Clock& clk, int te, int tp,
                                            int& best, bool& done, int& klen,
                                            int& cnt, int& code) {
  if (done) return;
  int M, modal;
  if constexpr (MODAL == SORTED && K > 2)
    warp_modal_sorted<K>(pc, len, keys, lane, clk, M, modal);
  else
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

// ------------------------------------------------------------ the kernel

template <int LAYOUT, int VARIANT, int MODAL, typename TabT>
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
  static_assert(MODAL == PAIRWISE || DO_MODAL,
                "the sorted form only differs where a modal is computed");
  // per warp (warp_smem_bytes): the count table, the pairwise form's
  // [lpad / 2] u16 window codes, [lpad] unpacked bases (ASCII rows),
  // [lpad] u16 position codes, the sorted form's keys; after every warp's,
  // STAGES keeps NSTAGES u32 counters a warp
  constexpr int TABLE_BYTES =
      (MODAL == SORTED ? K2_CODES : TABLE_ENTRIES) * sizeof(TabT);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lpad = (L + 15) & ~15;
  const size_t per_warp = warp_smem_bytes<MODAL, TabT>(L);
  unsigned char* mine = smem + (size_t)warp * per_warp;
  TabT* tab = reinterpret_cast<TabT*>(mine);
  uint16_t* wcode = reinterpret_cast<uint16_t*>(mine + TABLE_BYTES);
  uint8_t* s = mine + TABLE_BYTES + (MODAL == PAIRWISE ? lpad : 0);
  uint16_t* pc = reinterpret_cast<uint16_t*>(s + lpad);
  unsigned* keys = reinterpret_cast<unsigned*>(s + 3 * lpad);
  StageClock<CLOCKED> clk;
  if constexpr (CLOCKED) {
    clk.acc = reinterpret_cast<unsigned*>(smem + WARPS * per_warp) +
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
    warp_select<2, MODAL, DO_MODAL, DO_GREEDY>(pc, len, tab, wcode, keys,
                                               lane, clk, te[0], tp[0], best,
                                               done, klen, cnt, code);
    warp_select<3, MODAL, DO_MODAL, DO_GREEDY>(pc, len, tab, wcode, keys,
                                               lane, clk, te[1], tp[1], best,
                                               done, klen, cnt, code);
    warp_select<4, MODAL, DO_MODAL, DO_GREEDY>(pc, len, tab, wcode, keys,
                                               lane, clk, te[2], tp[2], best,
                                               done, klen, cnt, code);
    warp_select<5, MODAL, DO_MODAL, DO_GREEDY>(pc, len, tab, wcode, keys,
                                               lane, clk, te[3], tp[3], best,
                                               done, klen, cnt, code);
    warp_select<6, MODAL, DO_MODAL, DO_GREEDY>(pc, len, tab, wcode, keys,
                                               lane, clk, te[4], tp[4], best,
                                               done, klen, cnt, code);
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

// ---------------------------------------------------------------- launch

using KernelFn = void (*)(const uint8_t*, int64_t, int64_t, int,
                          const uint8_t*, const int32_t*, const int32_t*,
                          const int32_t*, int32_t*, int32_t*, int32_t*);

// A form's specialisation at a row width: the kernel, its dynamic shared
// memory a block, and the cards whose attributes it has set (one bit for
// each of the first 64)
struct Plan {
  KernelFn kernel;
  size_t smem;
  std::atomic<uint64_t>* attributes_set;
};

template <int LAYOUT, int VARIANT, int MODAL, typename TabT>
Plan plan_of(int L) {
  static std::atomic<uint64_t> done{0};
  return {repeat_scan_warp_kernel<LAYOUT, VARIANT, MODAL, TabT>,
          WARPS * warp_smem_bytes<MODAL, TabT>(L) +
              (VARIANT == STAGES ? WARPS * NSTAGES * sizeof(unsigned) : 0),
          &done};
}

// The specialisation of a form: the sorted modal where a modal is computed
// (its k = 2 table is u16: at most L / 2 <= 5,000 counts); the pairwise
// one otherwise, its table entries as narrow as the row's longest count
// allows (more warps fit on an SM)
template <int LAYOUT, int VARIANT>
Plan plan_variant(int L, int modal) {
  if constexpr (VARIANT == FULL || VARIANT == NO_GREEDY || VARIANT == STAGES)
    if (modal == SORTED) return plan_of<LAYOUT, VARIANT, SORTED, uint16_t>(L);
  return L <= U8_TABLE_MAX_L ? plan_of<LAYOUT, VARIANT, PAIRWISE, uint8_t>(L)
                             : plan_of<LAYOUT, VARIANT, PAIRWISE, uint16_t>(L);
}

template <int LAYOUT>
cudaError_t plan_layout(int L, int modal, int variant, Plan& p) {
  if (modal != PAIRWISE && modal != SORTED) return cudaErrorInvalidValue;
  switch (variant) {
    case FULL: p = plan_variant<LAYOUT, FULL>(L, modal); break;
    case NO_GREEDY: p = plan_variant<LAYOUT, NO_GREEDY>(L, modal); break;
    case NO_MODAL: p = plan_variant<LAYOUT, NO_MODAL>(L, modal); break;
    case WINMIN_ONLY: p = plan_variant<LAYOUT, WINMIN_ONLY>(L, modal); break;
    case STAGES: p = plan_variant<LAYOUT, STAGES>(L, modal); break;
    default: return cudaErrorInvalidValue;
  }
  return p.smem > MAX_SMEM ? cudaErrorInvalidValue : cudaSuccess;
}

cudaError_t make_plan(int layout, int L, int modal, int variant, Plan& p) {
  switch (layout) {
    case ASCII: return plan_layout<ASCII>(L, modal, variant, p);
    case N8: return plan_layout<N8>(L, modal, variant, p);
    case W8: return plan_layout<W8>(L, modal, variant, p);
    case W16: return plan_layout<W16>(L, modal, variant, p);
    case PACKED: return plan_layout<PACKED>(L, modal, variant, p);
    default: return cudaErrorInvalidValue;
  }
}

// The attributes belong to the function on each card and never change:
// they are set once a card. The kernel wants shared memory, not L1: its
// global loads are coalesced and read once.
cudaError_t set_attributes(const Plan& p) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (p.attributes_set->load(std::memory_order_acquire) & bit)
    return cudaSuccess;
  e = cudaFuncSetAttribute(p.kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(p.kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  p.attributes_set->fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace

// layout: 0 ASCII rows, 4 2-bit rows with an N bitmask `nbits` [n_rows, L/8]
// (both with lengths [n_rows], te/tp [n_rows, 5] int32), or 1 n8, 2 w8,
// 3 w16 payload rows (lengths/te/tp read from each row's meta bytes; pass
// null). modal: 0 pairwise, 1 sorted. variant: 0 full, 1 no_greedy,
// 2 no_modal, 3 winmin_only, 4 full clocked by stage (see
// repeat_scan_stage_cycles). On a launch, *design is set to the kernel's
// design: 0 warp per read.
extern "C" int repeat_scan_launch(const void* in, long long n_rows,
                                  long long row_stride, int layout, int L,
                                  const void* nbits, const void* lengths,
                                  const void* te, const void* tp, int modal,
                                  int variant, void* code, void* len,
                                  void* cnt, void* stream, int* design) {
  if (n_rows <= 0) return 0;
  const int64_t blocks = (n_rows + WARPS - 1) / WARPS;  // a read a warp
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = make_plan(layout, L, modal, variant, p);
  if (e != cudaSuccess) return e;
  if ((e = set_attributes(p)) != cudaSuccess) return e;
  p.kernel<<<(unsigned)blocks, WARPS * 32, p.smem,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), n_rows, row_stride, L,
      static_cast<const uint8_t*>(nbits), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(te), static_cast<const int32_t*>(tp),
      static_cast<int32_t*>(code), static_cast<int32_t*>(len),
      static_cast<int32_t*>(cnt));
  e = cudaGetLastError();
  if (e == cudaSuccess && design) *design = WARP_PER_READ;
  return e;
}

// The warps of a form (as repeat_scan_launch takes it) that an SM of the
// current card holds at once, at row width L, into *warps (the occupancy of
// its registers and shared memory).
extern "C" int repeat_scan_warps_per_sm(int layout, int L, int modal,
                                        int variant, int* warps) {
  Plan p;
  cudaError_t e = make_plan(layout, L, modal, variant, p);
  if (e != cudaSuccess) return e;
  if ((e = set_attributes(p)) != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.kernel,
                                                    WARPS * 32, p.smem);
  if (e != cudaSuccess) return e;
  *warps = per_sm * WARPS;
  return 0;
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
