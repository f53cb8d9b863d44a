"""Fragment-length (insert-size) model.

Port of utils.nim:86-158: the 4096-bin insert-size histogram sampled from the
first ~2M proper pairs (after skipping 100k records), plus the
median/percentile helpers reused across windows, spanning expectation and
simulation.
"""

from __future__ import annotations

import numpy as np

from strling_tpu_torch.core.tread import (
    FLAG_PROPER_PAIR,
    FLAG_SECONDARY,
    FLAG_SUPPLEMENTARY,
)

NBINS = 4096


def fragment_length_distribution(bam, n_reads: int = 2_000_000,
                                 skip_reads: int = 100_000) -> np.ndarray:
    """utils.nim:86-111, vectorized over read batches.

    `i` counts every record; proper-pair/secondary/isize filters apply before
    the skip-window check, exactly as in the reference. If nothing was counted
    (small BAMs) the skipped early reads are used instead.
    """
    hist = np.zeros(NBINS, np.uint32)
    skipped_isizes: list[np.ndarray] = []
    i = 0
    counted = 0
    for batch in bam.batches():
        flag = batch.flag.astype(np.int64)
        ok = (
            (flag & FLAG_PROPER_PAIR) != 0
        ) & ((flag & (FLAG_SUPPLEMENTARY | FLAG_SECONDARY)) == 0)
        ok &= (batch.isize >= 0) & (batch.isize < NBINS)
        n = len(batch)
        idx_global = np.arange(i, i + n)
        in_skip = idx_global < skip_reads
        take_skip = ok & in_skip
        if take_skip.any():
            skipped_isizes.append(batch.isize[take_skip].copy())
        count_mask = ok & ~in_skip
        if count_mask.any():
            skipped_isizes = []  # reference clears the stash once counting starts
            vals = batch.isize[count_mask]
            # stop after n_reads counted (strictly greater check, utils.nim:103)
            if counted + len(vals) > n_reads + 1:
                vals = vals[: n_reads + 1 - counted]
            np.add.at(hist, vals, 1)
            counted += len(vals)
        i += n
        if counted > n_reads:
            break

    if hist.sum() == 0:
        import sys

        print(
            "using first reads in fragment_length_distribution calculation as "
            "there were not enough",
            file=sys.stderr,
        )
        for vals in skipped_isizes:
            np.add.at(hist, vals, 1)
    return hist


def percentile(fragment_sizes: np.ndarray, fragment_length: int) -> float:
    """utils.nim:129-137 — cumulative proportion at fragment_length
    (inclusive of the bin at that index)."""
    total = int(fragment_sizes.sum())
    upto = min(fragment_length, NBINS - 1)
    s = int(fragment_sizes[: upto + 1].sum())
    return s / max(1, total)


def median(fragment_sizes: np.ndarray, pct: float = 0.5) -> int:
    """utils.nim:139-146 — first index with cum count >= round(n*pct)."""
    n = int(fragment_sizes.sum())
    target = int(0.5 + n / (1.0 / pct))
    c = np.cumsum(fragment_sizes.astype(np.int64))
    idx = np.searchsorted(c, target)
    if idx >= NBINS:
        return NBINS
    return int(idx)


def median_depth(depths: np.ndarray) -> int:
    """utils.nim:148-158 — median with values clamped to 1047."""
    depths = np.asarray(depths)
    h = np.bincount(np.minimum(depths, 1047), minlength=1048)
    s = np.cumsum(h)
    over = s > len(depths) / 2.0
    if not over.any():
        return 0
    return int(np.argmax(over))


def mode(xs) -> object:
    """utils.nim:160-162 — most frequent value (CountTable.largest:
    first value to attain the max count wins)."""
    counts: dict = {}
    best, best_c = None, -1
    for x in xs:
        c = counts.get(x, 0) + 1
        counts[x] = c
        if c > best_c:
            best, best_c = x, c
    return best


def most_frequent(counts: dict, n: int) -> list:
    """utils.nim:165-176 — top-n keys by count (descending).

    Ties keep insertion order (the reference's CountTable.sort order for ties
    is a hash-table artifact; see cluster.py docstring).
    """
    if n > len(counts):
        raise IndexError(
            f"Insufficient keys in CountTable ({len(counts)}) to report {n}"
        )
    items = sorted(counts.items(), key=lambda kv: -kv[1])
    return [k for k, _ in items[:n]]
