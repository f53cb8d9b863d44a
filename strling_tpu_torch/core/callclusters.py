"""Locus assignment and cluster->bounds gating (src/strpkg/callclusters.nim)."""

from __future__ import annotations

import sys

import numpy as np

from strling_tpu_torch.core.cluster import Bounds, Cluster, bounds as cluster_bounds
from strling_tpu_torch.core.tread import Soft


class TreadGroups:
    """treads bucketed by (tid, repeat) and position-sorted, with parallel
    qname arrays (call.nim:118-130 / merge.nim:92-139)."""

    def __init__(self):
        self.groups: dict[tuple[int, str], tuple[np.ndarray, np.ndarray]] = {}

    @classmethod
    def from_batch(cls, tb) -> "TreadGroups":
        self = cls()
        data = tb.data
        n = len(data)
        if n == 0:
            return self
        if isinstance(tb.qnames, np.ndarray):
            qn = tb.qnames  # merge's int sample ids: keep the fast dtype
        else:
            qn = np.array(
                tb.qnames if tb.qnames else [""] * n, dtype=object
            )
        # vectorized bucketing: unique (tid, repeat) keys, first-seen order
        # (Nim table order is a hash artifact; see cluster.py docstring),
        # stably position-sorted within each group. The repeat unit packs
        # into one int64 key — structured-dtype np.unique compares rows
        # elementwise in Python and is ~10x slower at cohort scale.
        rep = (
            np.ascontiguousarray(data["repeat"])
            .view(np.uint8).reshape(n, 6).astype(np.uint64)
        )
        rep64 = rep[:, 0]
        for i in range(1, 6):
            rep64 = rep64 | (rep[:, i] << np.uint64(8 * i))
        tid = data["tid"].astype(np.int64)
        perm = np.lexsort((data["position"], rep64, tid))  # stable
        tid_s = tid[perm]
        rep_s = rep64[perm]
        newgrp = np.empty(n, bool)
        newgrp[0] = True
        newgrp[1:] = (tid_s[1:] != tid_s[:-1]) | (rep_s[1:] != rep_s[:-1])
        starts = np.flatnonzero(newgrp)
        ends = np.append(starts[1:], n)
        first_idx = np.minimum.reduceat(perm, starts)
        key_rank = np.argsort(first_idx, kind="stable")  # first-seen order
        # one global gather, then zero-copy group views (no consumer mutates
        # group arrays in place; assign_reads_locus copies before filtering)
        data_sorted = data[perm]
        qn_sorted = qn[perm]
        for kid in key_rank:
            lo, hi = starts[kid], ends[kid]
            k = (int(data_sorted["tid"][lo]),
                 data_sorted["repeat"][lo].decode())
            self.groups[k] = (data_sorted[lo:hi], qn_sorted[lo:hi])
        return self

    def items(self):
        return self.groups.items()


def assign_reads_locus(locus: Bounds, groups: TreadGroups):
    """callclusters.nim:14-50: pull treads within [left_most-1, right_most]
    out of the group, update the locus counts.

    Returns (tread record array, qname array). Reproduces the reference's
    off-by-one: the first tread beyond right_most is dropped from the table
    entirely (callclusters.nim:34-36).
    """
    from strling_tpu_torch.core.tread import TREAD_DTYPE

    key = (locus.tid, locus.repeat)
    got = groups.groups.get(key)
    left_most = locus.left_most - 1 if locus.left_most != 0 else 0
    if got is not None and len(got[0]) > 0:
        trs, names = got
        pos = trs["position"]
        li = int(np.searchsorted(pos, left_most, side="left"))
        ri = int(np.searchsorted(pos, locus.right_most, side="right"))
        result = (trs[li:ri].copy(), names[li:ri].copy())
        # remove from table — keeping [0, li) and (ri, high] (the reference
        # drops trs[ri] itself, callclusters.nim:34-36)
        if ri < len(trs) - 1:
            keep = np.concatenate([np.arange(li), np.arange(ri + 1, len(trs))])
        else:
            keep = np.arange(li)
        groups.groups[key] = (trs[keep], names[keep])
    else:
        result = (np.zeros(0, TREAD_DTYPE), np.zeros(0, object))

    locus.force_report = True
    reads, _ = result
    locus.n_total = len(reads)
    locus.n_right = int((reads["split"] == int(Soft.right)).sum()) if len(reads) else 0
    locus.n_left = int((reads["split"] == int(Soft.left)).sum()) if len(reads) else 0
    return result


def bounds_checked(c: Cluster, min_clip: int, min_clip_total: int,
                   max_clip_dist: int) -> tuple[Bounds | None, bool]:
    """callclusters.nim:52-66."""
    if len(c.reads) >= 0xFFFF:
        print(
            f"More than {0xFFFF} reads in cluster with first read:"
            f"{c.reads[0]} skipping",
            file=sys.stderr,
        )
        return None, False
    b = cluster_bounds(c, max_clip_dist)
    if b.right - b.left > 1000:
        print(f"large bounds:{b} skipping", file=sys.stderr)
        return None, False
    if not b.force_report:
        if b.n_left < min_clip:
            return None, False
        if b.n_right < min_clip:
            return None, False
        if (b.n_right + b.n_left) < min_clip_total:
            return None, False
    return b, True
