"""The sorted modal's warp algorithm (ops/csrc/repeat_scan.cu,
warp_modal_sorted), emulated lane by lane on the CPU.

The kernel runs only on the card, so its algorithm is kept here in numpy, a
step for each step of the kernel: 32 lanes, two keys a lane (key i in lane
i >> 1, register a for even i and b for odd), the bitonic network with
`__shfl_xor_sync` partners (stride 1 within the lane), the run walk with its
masks of starts from two ballots, and, past 64 windows, the shared-memory
stages and the walk 64 keys at a time with the run start carried between
blocks. Each array's last
axis is the warp's lanes; leading axes hold independent warps (reads). The
emulation is held to the plain sorted modal (`ops.kmer._modal_code_sorted`)
and, up to 64 windows, to the JAX package's `_modal_sorted` (past 64 windows
the JAX form is wrong: fault F6). The plain sorted detector is also held to
the pairwise one and the oracle on rows past the thread kernel's old
3,074-base limit.
"""

import numpy as np
import pytest
import torch

from strling_tpu.ops import oracle
from strling_tpu_torch.ops import kmer as TK
from test_torch_kernel_forms import _jax_sorted

torch.set_num_threads(1)

LANES = np.arange(32)
U64 = np.uint64
NO_KEY = 0xFFFFFFFF
WIDX_BITS = 12
WIDX_MASK = (1 << WIDX_BITS) - 1
REG_KEYS = 64
ALL_BITS = U64(0xFFFFFFFFFFFFFFFF)

# ------------------------------------------------------- warp primitives


def shfl_xor(v, s):
    return v[..., LANES ^ s]


def shfl_up(v, d):
    """__shfl_up_sync: lanes below d keep their own value."""
    return np.where(LANES >= d, v[..., (LANES - d) % 32], v)


def shfl_down(v, d):
    """__shfl_down_sync: lanes from 32 - d keep their own value."""
    return np.where(LANES + d < 32, v[..., (LANES + d) % 32], v)


def shfl(v, src):
    return np.broadcast_to(v[..., src:src + 1], v.shape)


def ballot(pred):
    return (pred.astype(U64) << LANES.astype(U64)).sum(axis=-1, dtype=U64)


def top_bit(x):
    """63 - __clzll(x) for x != 0 (-1 for 0)."""
    x = np.asarray(x, U64)
    out = np.full(x.shape, -1, np.int64)
    for k in range(64):
        out = np.where((x >> U64(k)) & U64(1), k, out)
    return out


# ------------------------------------------------- the kernel's algorithm


def cx_lanes(v, d, up):
    """Compare-exchange with the lane d away (the network's stride 2d):
    the lower key of the pair is in the lane whose bit d is clear."""
    p = shfl_xor(v, d)
    take_min = ((LANES & d) == 0) == up
    return np.where(take_min, np.minimum(v, p), np.maximum(v, p))


def cx_in_lane(a, b, up):
    """Stride 1: the lane's own two keys."""
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    return np.where(up, lo, hi), np.where(up, hi, lo)


def merge64(a, b, asc):
    """Strides 32..1 of a bitonic sequence, into `asc`ending order."""
    for d in (16, 8, 4, 2, 1):
        a, b = cx_lanes(a, d, asc), cx_lanes(b, d, asc)
    return cx_in_lane(a, b, asc)


def sort64(a, b, asc):
    steps = 0
    for size in (2, 4, 8, 16, 32):
        # key i = 2 lane + r: bit `size` of i is bit size / 2 of the lane
        up = (LANES & (size >> 1)) == 0
        d = size >> 2
        while d > 0:
            a, b = cx_lanes(a, d, up), cx_lanes(b, d, up)
            steps += 1
            d >>= 1
        a, b = cx_in_lane(a, b, up)
        steps += 1
    assert steps == 15  # + merge64's 6: 21 steps, 15 across lanes
    return merge64(a, b, asc)


def _top_key(mask, odd):
    """The key index of the highest set bit (lane l -> key 2 l + odd), or
    -1."""
    t = top_bit(mask)
    return np.where(t >= 0, 2 * t + odd, -1)


def walk64(a, b, c, W, next_code, prev_code, run_start, best, best_code):
    """One block of 64 sorted keys (key c + 2 lane in a, c + 2 lane + 1 in
    b); W, next_code and the carries have the warps' shape, best and
    best_code the lanes' too. Returns the carries and the lanes' best."""
    ca, cb = a >> WIDX_BITS, b >> WIDX_BITS
    up_b = shfl_up(cb, 1)
    dn_a = shfl_down(ca, 1)
    ia, ib = c + 2 * LANES, c + 2 * LANES + 1
    va, vb = ia < W[..., None], ib < W[..., None]
    pa = np.where(LANES == 0, prev_code[..., None], up_b)
    nb = np.where(LANES == 31, next_code[..., None], dn_a)
    sa = ballot(va & (ca != pa))[..., None]
    sb = ballot(vb & (cb != ca))[..., None]
    upto = ALL_BITS >> (63 - LANES).astype(U64)   # lanes <= l
    below = np.where(LANES > 0, ALL_BITS >> (64 - LANES).astype(U64), 0)
    start_a = np.maximum(_top_key(sa & upto, 0), _top_key(sb & below, 1))
    start_b = np.maximum(_top_key(sa & upto, 0), _top_key(sb & upto, 1))
    start_a = np.where(start_a >= 0, c + start_a, run_start[..., None])
    start_b = np.where(start_b >= 0, c + start_b, run_start[..., None])
    for i, key, code, nxt, valid, start in ((ia, a, ca, cb, va, start_a),
                                            (ib, b, cb, nb, vb, start_b)):
        end = valid & ((i + 1 == W[..., None]) | (nxt != code))
        rank = ((i - start + 1) << WIDX_BITS) | (WIDX_MASK - (key & WIDX_MASK))
        take = end & (rank > best)
        best = np.where(take, rank, best)
        best_code = np.where(take, code, best_code)
    prev_code = shfl(cb, 31)[..., 0]
    last = np.maximum(_top_key(sa[..., 0], 0), _top_key(sb[..., 0], 1))
    run_start = np.where(last >= 0, c + last, run_start)
    return prev_code, run_start, best, best_code


def finish(best, best_code):
    """__reduce_max_sync, the ballot that names the winning lane, and the
    shuffle of its code: (M, modal) of each warp."""
    top = best.max(axis=-1)
    won = np.argmax(best == top[..., None], axis=-1)
    code = np.take_along_axis(best_code, won[..., None], -1)[..., 0]
    return (top >> WIDX_BITS).astype(np.int64), np.where(top > 0, code, -1)


def modal_in_registers(wcodes, W):
    """Up to 64 windows: wcodes [R, 64] (window j's code, j < W [R])."""
    R = len(W)
    j = np.arange(64)
    keys = np.where(j < W[:, None], (wcodes << WIDX_BITS) | j, NO_KEY)
    a, b = sort64(keys[:, 0::2], keys[:, 1::2], True)
    z = np.zeros(R, np.int64)
    prev, start, best, best_code = walk64(
        a, b, 0, W, np.full(R, NO_KEY), np.full(R, NO_KEY), z,
        np.zeros((R, 32), np.int64), np.zeros((R, 32), np.int64))
    return finish(best, best_code)


def modal_in_shared(wcodes):
    """More than 64 windows: one warp, the keys in its shared memory."""
    W = len(wcodes)
    P = 2 * REG_KEYS
    while P < W:
        P <<= 1
    j = np.arange(P)
    keys = np.full(P, NO_KEY, np.int64)
    keys[:W] = (np.asarray(wcodes, np.int64) << WIDX_BITS) | j[:W]
    # each block's keys in registers: key c + 2 lane + r in register r
    blocks = keys.reshape(P // 64, 32, 2)
    asc = (np.arange(P // 64) * 64 & 64) == 0
    a, b = sort64(blocks[:, :, 0], blocks[:, :, 1], asc[:, None])
    keys = np.stack([a, b], axis=2).reshape(P)
    size = 128
    while size <= P:
        s = size >> 1
        while s >= 64:
            # lanes take the compare-exchanges t = lane, lane + 32, ...; the
            # pairs of a step are disjoint
            for t0 in range(0, P // 2, 32):
                t = t0 + LANES
                t = t[t < P // 2]
                i = ((t & ~(s - 1)) << 1) | (t & (s - 1))
                x, y = keys[i].copy(), keys[i + s].copy()
                swap = (x > y) == ((i & size) == 0)
                keys[i] = np.where(swap, y, x)
                keys[i + s] = np.where(swap, x, y)
            s >>= 1
        blocks = keys.reshape(P // 64, 32, 2)
        asc = (np.arange(P // 64) * 64 & size) == 0
        a, b = merge64(blocks[:, :, 0], blocks[:, :, 1], asc[:, None])
        keys = np.stack([a, b], axis=2).reshape(P)
        size <<= 1
    assert (np.diff(keys) >= 0).all()
    Wv = np.array([W])
    prev, start = np.array([NO_KEY]), np.array([0])
    best = best_code = np.zeros((1, 32), np.int64)
    for c in range(0, W, 64):
        nxt = np.array([keys[c + 64] >> WIDX_BITS if c + 64 < W else NO_KEY])
        prev, start, best, best_code = walk64(
            keys[None, c:c + 64:2], keys[None, c + 1:c + 64:2], c, Wv, nxt,
            prev, start, best, best_code)
    M, modal = finish(best, best_code)
    return int(M[0]), int(modal[0])


def warp_modal_sorted(wcodes, W):
    """The kernel's sorted modal of each row's first W[r] window codes:
    (modal [R], M [R]), modal -1 with no window."""
    W = np.asarray(W)
    M = np.zeros(len(W), np.int64)
    modal = np.full(len(W), -1, np.int64)
    reg = W <= REG_KEYS
    if reg.any():
        w64 = np.zeros((int(reg.sum()), 64), np.int64)
        w64[:, :min(64, wcodes.shape[1])] = wcodes[reg, :64]
        M[reg], modal[reg] = modal_in_registers(w64, W[reg])
    for r in np.flatnonzero(~reg):
        M[r], modal[r] = modal_in_shared(wcodes[r, :W[r]])
    return modal, M


# ------------------------------------------------------------------ inputs


def _prefix_rows(seed, R, width, n_codes, W=None):
    """Rows of `width` window codes of which the first W are valid (random
    W if None; some rows with none)."""
    rng = np.random.default_rng(seed)
    wcodes = rng.integers(0, n_codes, (R, width)).astype(np.int64)
    if W is None:
        W = rng.integers(0, width + 1, R)
        W[:2] = 0
    return wcodes, np.broadcast_to(np.asarray(W), (R,)).copy()


def _plain(wcodes, W):
    valid = np.arange(wcodes.shape[1])[None, :] < W[:, None]
    code, M = TK._modal_code_sorted(torch.from_numpy(wcodes.astype(np.int32)),
                                    torch.from_numpy(valid))
    return code.numpy(), M.numpy()


def _hold(wcodes, W, jax_too):
    got = warp_modal_sorted(wcodes, W)
    want = _plain(wcodes, W)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if jax_too:
        valid = np.arange(wcodes.shape[1])[None, :] < W[:, None]
        jax = _jax_sorted(wcodes.astype(np.int32), valid)
        np.testing.assert_array_equal(got[0], jax[0])
        np.testing.assert_array_equal(got[1], jax[1])


def _tie_across_blocks(W, first_last_wins):
    """Two codes with 40 windows each whose sorted runs straddle the first
    block edge (keys 30..69 and 70..109): code 5 after 30 smaller distinct
    codes, code 9 after it, larger distinct codes to W. Which of the two
    occurs last first decides the winner."""
    small, large = list(range(100, 130)), list(range(1000, 1000 + W - 110))
    fives, nines = [5] * 40, [9] * 40
    order = small + large
    if first_last_wins:  # 5 ends before 9 does
        seq = fives[:20] + nines[:20] + fives[20:] + order + nines[20:]
    else:
        seq = nines[:20] + fives[:20] + nines[20:] + order + fives[20:]
    seq = [v % 4096 for v in seq]
    return np.array([seq], np.int64), np.array([W])


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("n_codes", [1, 3, 16, 64, 4096])
def test_warp_sort_in_registers_every_width(n_codes):
    """Every W from 1 to 64 (key pads from 0 to 63), random and all-equal
    codes, against the plain form and the JAX package's _modal_sorted."""
    rows = [_prefix_rows(W * 7 + n_codes, 6, 64, n_codes, W)
            for W in range(0, 65)]
    wcodes = np.concatenate([r[0] for r in rows])
    W = np.concatenate([r[1] for r in rows])
    _hold(wcodes, W, jax_too=True)


def test_warp_sort_in_registers_ties():
    """Codes tying on their totals: the earliest last occurrence wins."""
    rows = [[5, 9, 9, 5], [9, 5, 5, 9], [3, 1, 2, 3, 2, 1], [7] * 3 + [2] * 3,
            [2, 7, 2, 7, 7, 2], [0, 4095, 0, 4095], [63, 62, 62, 63, 1],
            [4095] * 64, list(range(64)), list(range(63, -1, -1)),
            [1, 2] * 32, [2, 1] * 32]
    wcodes = np.zeros((len(rows), 64), np.int64)
    for i, r in enumerate(rows):
        wcodes[i, :len(r)] = r
    _hold(wcodes, np.array([len(r) for r in rows]), jax_too=True)


@pytest.mark.parametrize("W,n_codes", [(65, 64), (85, 64), (85, 3), (128, 2),
                                       (129, 4096), (200, 16), (3333, 64),
                                       (3333, 1)])
def test_warp_sort_in_shared_memory(W, n_codes):
    """Past 64 windows (the F6 tile's 85 at k = 3, up to MAX_L's 3,333):
    the shared-memory stages and the walk across blocks, against the plain
    form only (the JAX form is wrong here, F6)."""
    wcodes, Wv = _prefix_rows(W, 2 if W > 1000 else 6, W, n_codes, W)
    _hold(wcodes, Wv, jax_too=False)


def test_warp_sort_f6_reproducer():
    """64 distinct codes, then code 10 21 more times: modal 10, 22 times
    (the JAX form answers 11)."""
    wcodes = np.array([list(range(64)) + [10] * 21], np.int64)
    modal, M = warp_modal_sorted(wcodes, np.array([85]))
    assert (int(modal[0]), int(M[0])) == (10, 22)


@pytest.mark.parametrize("first_last_wins", [True, False])
@pytest.mark.parametrize("W", [130, 200])
def test_warp_walk_ties_across_block_edge(W, first_last_wins):
    """Equal runs whose sorted keys straddle the first block edge: the run
    start carried into the second block gives both the same length, and the
    earlier last occurrence wins."""
    wcodes, Wv = _tie_across_blocks(W, first_last_wins)
    modal, M = warp_modal_sorted(wcodes, Wv)
    assert (int(modal[0]), int(M[0])) == ((5 if first_last_wins else 9), 40)
    _hold(wcodes, Wv, jax_too=False)


def test_plain_sorted_detector_past_old_row_limit():
    """ASCII rows of 4,000 bases (past the 3,074 the thread-per-read kernel
    took): the plain sorted detector equals the pairwise one and the
    oracle."""
    L = 4000
    rng = np.random.default_rng(40)
    reads = ["CAG" * (L // 3) + "C", ("AAGGG" * L)[:L - 3],
             "".join(rng.choice(list("ACGT"), L)),
             ("".join(rng.choice(["AT", "AC"], L // 2, p=[0.7, 0.3])))[:L]]
    bases = np.zeros((len(reads), L), np.uint8)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    lengths = np.array([len(r) for r in reads], np.int32)
    props = np.array([0.8, 0.6, 0.8, 0.4])
    te, tp = TK._host_thresholds(lengths, props)
    args = [torch.from_numpy(a) for a in (bases, lengths, te, tp)]
    got = [t.numpy() for t in
           TK.repeat_codes_plain(args[0], "ascii", *args[1:], modal="sorted")]
    want = TK.repeat_codes_plain(args[0], "ascii", *args[1:],
                                 modal="pairwise")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    units = TK.unpack_unit_codes(got[0], got[1])
    for i, (r, p) in enumerate(zip(reads, props)):
        assert (units[i], int(got[2][i])) == oracle.get_repeat(r, float(p)), i
