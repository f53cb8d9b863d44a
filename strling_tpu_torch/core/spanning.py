"""Spanning-probability model (src/strpkg/spanning.nim).

The smoothed cumulative insert-size distribution and the probability that a
fragment starting at a read's position spans an event.
"""

from __future__ import annotations

import numpy as np

from strling_tpu_torch.core.tread import FLAG_REVERSE

WINDOW = 11  # spanning.nim:11


def cumulative(frag_dist: np.ndarray) -> np.ndarray:
    """spanning.nim:7-18: ±11-bin smoothed histogram -> normalized CDF.

    float32 arithmetic like the reference (cumulative_dist = array[4096,
    float32]); summation order may differ in the last bit.
    """
    f = frag_dist.astype(np.float32)
    kernel = np.ones(2 * WINDOW + 1, np.float32)
    sm = np.convolve(f, kernel, mode="same").astype(np.float32)
    out = np.add.accumulate(sm, dtype=np.float32)
    fmax = out[-1]
    return (out / fmax).astype(np.float32)


def expected_spanning_probability(cd: np.ndarray, read, event_start: int,
                                  event_stop: int | None = None,
                                  min_spanning_bases: int = 20) -> float:
    """spanning.nim:20-49. `read` is any Record-like with .start/.stop/.flag."""
    if event_stop is None:
        event_stop = event_start + 1
    if read.start < event_stop - min_spanning_bases:
        if read.flag & FLAG_REVERSE:
            return 0.0
        dist = event_start - read.start
        if dist < 0:
            return 0.0
        if dist + (event_stop - event_start) < min_spanning_bases:
            return 0.0
    else:
        if not (read.flag & FLAG_REVERSE):
            return 0.0
        dist = read.stop - event_stop
        if dist < 0:
            return 0.0
        if dist + (event_stop - event_start) < min_spanning_bases:
            return 0.0

    dist += min_spanning_bases
    dist += event_stop - event_start
    if dist < 0 or dist > len(cd) - 1:
        return 0.0
    return float(1 - cd[dist])
