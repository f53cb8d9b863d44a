"""Cluster segmentation on a torch device: the SURVEY §7 L3 formulation.

Port of `strling_tpu.ops.cluster_jax`. The reference's greedy grow loop
(cluster.nim:323-352) looks inherently sequential, but its median window
freezes after 9 reads, so one cluster costs at most 8 scalar accept steps
plus two sorted-array jumps — a bounded body. Here that body runs as tensor
operations on the device, one cluster per iteration, returning per-read
segment ids for a whole position-sorted (tid, repeat) group.

Exactness: identical boundaries to core/cluster_batched.segment_group
(itself fuzz-verified against the scalar trcluster) and to the JAX
package's segment_ids. No production path calls it (the host segmented
pipeline is production, as in the JAX package); it is the device form for
mesh-resident pipelines. The JAX form is XLA, not Pallas, so plain torch
ops are its counterpart.
"""

from __future__ import annotations

import numpy as np
import torch


def segment_ids_torch(positions: torch.Tensor, n_valid: int,
                      max_dist: int) -> torch.Tensor:
    """Per-read cluster ids for one position-sorted group.

    positions: int64[N] sorted on its device, padded beyond n_valid with a
    huge sentinel (rows >= n_valid get id -1). Returns int32[N] segment
    ids."""
    N = positions.shape[0]
    dev = positions.device
    pos = positions.to(torch.int64)
    D = max_dist + 100
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    ids = torch.full((N,), -1, dtype=torch.int32, device=dev)

    def at(i):
        return pos[i.clamp(max=N - 1)]

    a = torch.zeros((), dtype=torch.int64, device=dev)
    seg = 0
    while bool(a < n_valid):
        # stepwise growth, window sizes 1..8: accept pos[a+w] iff
        # <= pos[a + (w-1)//2] + D (threshold from the pre-accept window)
        b = a + 1
        for w in range(1, 9):
            ok = (b == a + w) & (a + w < n_valid) & (
                at(a + w) <= at(a + (w - 1) // 2) + D)
            b = torch.where(ok, a + w + 1, b)
        # reached size 9 via the last accept: the 8-median jump, then one
        # frozen 9-median jump if the next read is close
        thr8 = at(a + 3) + D
        j1 = torch.searchsorted(pos, thr8[None], right=True)[0]
        b1 = torch.maximum(j1.clamp(max=n_valid), b)
        thr9 = at(a + 4) + D
        nxt_ok = (b1 < n_valid) & (at(b1) <= thr9)
        j2 = torch.searchsorted(pos, thr9[None], right=True)[0]
        b2 = torch.maximum(j2.clamp(max=n_valid), b1 + 1)
        b = torch.where(b - a == 9, torch.where(nxt_ok, b2, b1), b)
        ids = torch.where((idx >= a) & (idx < b), seg, ids)
        a, seg = b, seg + 1
    return ids


def segment_ids(positions: np.ndarray, max_dist: int, device,
                pad_to: int | None = None) -> np.ndarray:
    """Host wrapper: pad to a bucketed shape, run the segmentation on
    `device`, return int32 ids for the valid rows."""
    n = len(positions)
    if n == 0:
        return np.zeros(0, np.int32)
    N = pad_to or max(256, 1 << int(np.ceil(np.log2(n))))
    pad = np.full(N - n, np.iinfo(np.int64).max // 4, np.int64)
    arr = torch.from_numpy(np.concatenate([positions.astype(np.int64), pad]))
    ids = segment_ids_torch(arr.to(device), n, max_dist)
    return ids.cpu().numpy()[:n]
