"""Segmented (vectorized) clustering + bounds — the production call path.

SURVEY §7 L3 formulation of reference cluster.nim:175-374: the greedy grow
loop's median window freezes after 9 reads, so segmentation is a handful of
scalar steps + two sorted-array jumps per cluster; everything downstream —
trim, window metadata, anchor/support filters, the double-locus split test
and the locus-bounds estimation — runs as segment operations over the whole
(tid, repeat) group at once instead of per-cluster Python.

Exactness: every tie-break matches the scalar path in core/cluster.py
(`_largest`'s reach-the-max-first rule, posmed truncation, the uint32
left_most underflow, the "XXX correction"). tests/test_cluster_batched.py
asserts identical output against cluster()+bounds_checked on the ported
reference regression cases and on randomized fuzz groups; the scalar path
remains the executable spec.
"""

from __future__ import annotations

import sys

import numpy as np

from strling_tpu_torch.core.cluster import U32, Bounds, Cluster
from strling_tpu_torch.core.tread import Soft


def _posmed_idx(size):
    """Index offset of _posmed within a window of `size` (cluster.nim:59-62:
    mid = int(min(9, size)/2 - 0.5) == (min(9, size)-1)//2)."""
    return (np.minimum(size, 9) - 1) // 2


def segment_group(posns: np.ndarray, max_dist: int) -> list[tuple[int, int]]:
    """Exact cluster segmentation of one position-sorted group
    (cluster.nim:323-352): grow with evolving <=9-read medians, then the
    8-median jump and the frozen 9-median jump."""
    D = max_dist + 100
    n = len(posns)
    segs = []
    a = 0
    while a < n:
        b = a + 1
        # stepwise growth, window sizes 1..8 (threshold uses the pre-accept
        # window: accept pos[a+w] iff <= pos[a + (w-1)//2] + D)
        while b - a < 9 and b < n:
            thr = int(posns[a + (b - a - 1) // 2]) + D
            if posns[b] <= thr:
                b += 1
            else:
                break
        else:
            if b - a == 9 and b <= n:
                # the jump that fired on reaching size 9 used the 8-read
                # median threshold (computed pre-accept)
                thr8 = int(posns[a + 3]) + D
                b = max(int(np.searchsorted(posns, thr8, side="right")), b)
                # subsequent growth re-tests with the frozen 9-read median
                if b < n:
                    thr9 = int(posns[a + 4]) + D
                    if posns[b] <= thr9:
                        b = max(
                            int(np.searchsorted(posns, thr9, side="right")),
                            b + 1,
                        )
        segs.append((a, b))
        a = b
    return segs


def _seg_largest(seg: np.ndarray, val: np.ndarray, order: np.ndarray,
                 n_seg: int):
    """Per-segment CountTable.largest with the reference tie-break: winner
    is the value that REACHES the max count first — among max-count values,
    the one whose count-th (== last) occurrence comes earliest.

    Returns (key[n_seg], count[n_seg]); count==-1 for empty segments.
    """
    key_out = np.zeros(n_seg, np.int64)
    cnt_out = np.full(n_seg, -1, np.int64)
    if len(seg) == 0:
        return key_out, cnt_out
    perm = np.lexsort((order, val, seg))
    s, v, o = seg[perm], val[perm], order[perm]
    new_run = np.empty(len(s), bool)
    new_run[0] = True
    new_run[1:] = (s[1:] != s[:-1]) | (v[1:] != v[:-1])
    run_start = np.flatnonzero(new_run)
    run_end = np.append(run_start[1:], len(s)) - 1
    run_seg = s[run_start]
    run_val = v[run_start]
    run_cnt = run_end - run_start + 1
    run_reach = o[run_end]  # last occurrence == count-th occurrence
    pick = np.lexsort((run_reach, -run_cnt, run_seg))
    first = np.empty(len(pick), bool)
    ps = run_seg[pick]
    first[0] = True
    first[1:] = ps[1:] != ps[:-1]
    w = pick[first]
    key_out[run_seg[w]] = run_val[w]
    cnt_out[run_seg[w]] = run_cnt[w]
    return key_out, cnt_out


def cluster_group_batched(reads: np.ndarray, max_dist: int,
                          min_supporting_reads: int, min_clip: int,
                          min_clip_total: int, max_clip_dist: int,
                          qnames=None):
    """cluster()+split_cluster()+bounds_checked() for one placed
    (tid, repeat) group, as segment ops. Yields (Bounds, reads_view,
    qnames_view) in exactly the scalar pipeline's order, applying the same
    gates (and stderr skip messages)."""
    n = len(reads)
    if n == 0:
        return
    posns = reads["position"].astype(np.int64)
    splits = reads["split"].astype(np.int64)
    D = max_dist + 100

    segs = segment_group(posns, max_dist)
    a0 = np.array([s[0] for s in segs], np.int64)
    b0 = np.array([s[1] for s in segs], np.int64)

    # ---- trim (cluster.nim:252-257): cutoff from the incoming cluster's
    # <=9-median; first kept index capped at size-1
    pm0 = posns[a0 + _posmed_idx(b0 - a0)]
    lo = np.maximum(0, pm0 - D)
    it = np.searchsorted(posns, lo, side="left")
    a1 = np.minimum(np.maximum(a0, it), b0 - 1)

    # ---- window meta (cluster.nim:343-344) on the trimmed cluster
    pm1 = posns[a1 + _posmed_idx(b0 - a1)]
    right_most = np.maximum(posns[b0 - 1], pm1 + max_dist)
    cand = pm1 - max_dist
    cand = np.where(cand < 0, cand + U32, cand)
    left_most = np.minimum(posns[a1], cand)

    # ---- anchor + support filters (cluster.nim:354-362)
    sz = b0 - a1
    cum_anchor = np.concatenate([[0], np.cumsum(splits == int(Soft.none))])
    has_anchor = (cum_anchor[b0] - cum_anchor[a1]) > 0
    keep = (sz >= min_supporting_reads) & has_anchor

    kept = np.flatnonzero(keep)
    if len(kept) == 0:
        return
    ka, kb = a1[kept], b0[kept]
    k_left_most, k_right_most = left_most[kept], right_most[kept]
    n_seg = len(kept)

    # ---- split test (cluster.nim:283-320), segmented over kept clusters
    seg_sz = kb - ka
    total = int(seg_sz.sum())
    seg_of_read = np.repeat(np.arange(n_seg), seg_sz)
    off0 = np.concatenate([[0], np.cumsum(seg_sz)[:-1]])
    ridx = np.repeat(ka, seg_sz) + (np.arange(total) - np.repeat(off0, seg_sz))
    r_split = splits[ridx]
    r_pos = posns[ridx]
    is_l = r_split == int(Soft.left)
    is_r = r_split == int(Soft.right)
    ll_key, ll_val = _seg_largest(seg_of_read[is_l], r_pos[is_l],
                                  ridx[is_l], n_seg)
    rl_key, rl_val = _seg_largest(seg_of_read[is_r], r_pos[is_r],
                                  ridx[is_r], n_seg)
    # distinct position counts per segment for each side
    def _distinct(mask):
        segm = seg_of_read[mask]
        valm = r_pos[mask]
        if len(segm) == 0:
            return np.zeros(n_seg, np.int64)
        pr = np.lexsort((valm, segm))
        sm, vm = segm[pr], valm[pr]
        newv = np.empty(len(sm), bool)
        newv[0] = True
        newv[1:] = (sm[1:] != sm[:-1]) | (vm[1:] != vm[:-1])
        return np.bincount(sm[newv], minlength=n_seg).astype(np.int64)

    nld = _distinct(is_l)
    nrd = _distinct(is_r)
    with np.errstate(divide="ignore", invalid="ignore"):
        do_split = (
            (ll_val > 0) & (rl_val > 0)
            & (rl_key < ll_key)
            & (rl_val >= min_supporting_reads)
            & (ll_val >= min_supporting_reads)
            & (ll_val / np.maximum(nld, 1) > 0.5)
            & (rl_val / np.maximum(nrd, 1) > 0.5)
        )
    mid = (0.5 + (rl_key + ll_key) / 2.0).astype(np.int64)

    # ---- emit: for each kept cluster, one or two (sub)clusters in order,
    # then bounds_checked gates per subcluster (vectorized bounds below)
    sub_a, sub_b, sub_lm, sub_rm = [], [], [], []
    for j in range(n_seg):
        if do_split[j]:
            m = int(np.searchsorted(posns[ka[j] : kb[j]], mid[j], side="left"))
            # posns < mid  ==  [ka, ka+m)
            sub_a.append(ka[j]); sub_b.append(ka[j] + m)
            sub_lm.append(0); sub_rm.append(int(mid[j]) - 1)
            sub_a.append(ka[j] + m); sub_b.append(kb[j])
            sub_lm.append(int(mid[j])); sub_rm.append(0)
        else:
            sub_a.append(ka[j]); sub_b.append(kb[j])
            sub_lm.append(int(k_left_most[j])); sub_rm.append(int(k_right_most[j]))
    sub_a = np.array(sub_a, np.int64)
    sub_b = np.array(sub_b, np.int64)
    sub_lm = np.array(sub_lm, np.int64)
    sub_rm = np.array(sub_rm, np.int64)

    for bnd, a, b in _bounds_batched(reads, posns, splits, sub_a, sub_b,
                                     sub_lm, sub_rm, min_clip,
                                     min_clip_total, max_clip_dist):
        yield bnd, reads[a:b], (qnames[a:b] if qnames is not None else None)


def _bounds_batched(reads, posns, splits, sa, sb, slm, srm, min_clip,
                    min_clip_total, max_clip_dist):
    """Vectorized bounds() + bounds_checked() gates (cluster.nim:175-250,
    callclusters.nim:52-66) over subclusters [sa, sb) with cluster-level
    left_most/right_most overrides slm/srm (0 == unset)."""
    n_seg = len(sa)
    if n_seg == 0:
        return
    sz = sb - sa
    cm = posns[sa + sz // 2]  # center_mass: posns[int(len/2)]

    seg_of_read = np.repeat(np.arange(n_seg), sz)
    off0 = np.concatenate([[0], np.cumsum(sz)[:-1]])
    ridx = np.repeat(sa, sz) + (np.arange(int(sz.sum())) - np.repeat(off0, sz))
    r_pos = posns[ridx]
    r_split = splits[ridx]
    cm_r = cm[seg_of_read]
    left_gate = (r_split == int(Soft.left)) & (r_pos < cm_r + max_clip_dist)
    right_gate = (r_split == int(Soft.right)) & (r_pos > cm_r - max_clip_dist)
    n_left = np.bincount(seg_of_read[left_gate], minlength=n_seg)
    n_right = np.bincount(seg_of_read[right_gate], minlength=n_seg)

    lkey, lval = _seg_largest(seg_of_read[left_gate], r_pos[left_gate],
                              ridx[left_gate], n_seg)
    rkey, rval = _seg_largest(seg_of_read[right_gate], r_pos[right_gate],
                              ridx[right_gate], n_seg)
    left = np.where((n_left > 0) & (lval > 1), lkey, 0)
    right = np.where((n_right > 0) & (rval > 1), rkey, 0)

    # fixups (cluster.nim:213-231); sz > 0 always here
    left = np.where(left == 0, cm, left)
    right = np.where(right == 0, left + 1, right)
    bad = left >= right
    swap = bad & (n_left > 0) & (n_right > 0)
    l2 = np.where(swap, right, left)
    r2 = np.where(swap, left, right)
    l2 = np.where(bad & ~swap, r2 - 1, l2)
    left, right = l2, r2

    # left/right-most (cluster.nim:234-241) + the "XXX correction"
    cum_min = posns[sa]     # group slice min == first (sorted)
    cum_max = posns[sb - 1]
    lm = np.where(slm > 0, slm, cum_min)
    rm = np.where(srm > 0, srm, cum_max)
    lm = np.minimum(lm, left)
    rm = np.maximum(rm, right)

    for j in range(n_seg):
        if sz[j] >= 0xFFFF:
            print(
                f"More than {0xFFFF} reads in cluster with first read:"
                f"{reads[sa[j]]} skipping",
                file=sys.stderr,
            )
            continue
        b = Bounds(
            tid=int(reads["tid"][sa[j]]),
            left=int(left[j]), right=int(right[j]),
            left_most=int(lm[j]), right_most=int(rm[j]),
            center_mass=int(cm[j]), n_left=int(n_left[j]),
            n_right=int(n_right[j]), n_total=int(sz[j]),
            repeat=reads["repeat"][sa[j]].decode(),
        )
        assert b.left <= b.right, repr(b)
        assert b.left_most <= b.right_most, repr(b)
        if b.right - b.left > 1000:
            print(f"large bounds:{b} skipping", file=sys.stderr)
            continue
        if not b.force_report:
            if b.n_left < min_clip or b.n_right < min_clip:
                continue
            if (b.n_right + b.n_left) < min_clip_total:
                continue
        yield b, int(sa[j]), int(sb[j])
