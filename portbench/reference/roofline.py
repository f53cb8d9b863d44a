"""The repeat scan's least time on the card, for `kernel.repeat_scan.roofline_share`.

Frozen copies of the port's bound (`strling_tpu_torch/scripts/
exp_kernel_timing.py`: `scan_ops`, `scan_bound`) and of the payload decoding
it needs (`strling_tpu_torch/ops/kmer.py`: `payload_geometry`,
`unpack_ascii`, `unfuse_payload`), kept with the benchmark so that a change
to the program cannot change the yardstick.

A batch's bound is the larger of two terms:
- bytes: every input byte read once and 12 output bytes a read written once,
  over the H100's published HBM bandwidth (3.35 TB/s, SXM data sheet);
- operations: the integer operations the detector needs on these reads
  (`scan_ops`, counting only the k its selection state machine reads, from
  `detector.detect_tensors` on the same rows), over the INT32 peak:
  132 SMs x 64 INT32 lanes x the SM clock.
The SM clock is the card's maximum as `nvidia-smi` reports it
(`clocks.max.sm`); 1.98 GHz where it cannot be read.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.detector import KS, detect_tensors

HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES = 132, 64
DEFAULT_SM_HZ = 1.98e9
FUSE_META8, FUSE_META16 = 11, 22


def int32_ops_per_s(sm_hz: float | None) -> float:
    return SMS * INT32_LANES * (sm_hz or DEFAULT_SM_HZ)


def payload_geometry(width: int, layout: str):
    if layout == "n8":
        L = (width - FUSE_META8) * 4
        return L, L // 4, FUSE_META8
    if layout in ("w8", "w16"):
        meta_w = FUSE_META8 if layout == "w8" else FUSE_META16
        L = (width - meta_w) * 8 // 3
        return L, 3 * L // 8, meta_w
    raise ValueError(f"unknown payload layout {layout!r}")


def unpack_ascii(packed: torch.Tensor, nbits: torch.Tensor | None):
    B, L4 = packed.shape
    shifts = torch.arange(4, dtype=torch.int32, device=packed.device) * 2
    d = ((packed[:, :, None].to(torch.int32) >> shifts) & 3).reshape(B, L4 * 4)
    a = 65 + 2 * d + 15 * (d == 2).to(torch.int32)
    if nbits is None:
        return a.to(torch.uint8)
    bit = torch.arange(8, dtype=torch.int32, device=packed.device)
    nm = ((nbits[:, :, None].to(torch.int32) >> bit) & 1).reshape(B, -1)
    return torch.where(nm[:, : L4 * 4] == 1, ord("N"), a).to(torch.uint8)


def unfuse_payload(payload: torch.Tensor, layout: str):
    """(bases ASCII, lengths, te, tp) of fused payload rows."""
    L, meta_off, meta_w = payload_geometry(payload.shape[1], layout)
    pb = payload[:, : L // 4]
    nb = None if layout == "n8" else payload[:, L // 4: 3 * L // 8]
    meta = payload[:, meta_off:].to(torch.int32)
    if meta_w == FUSE_META16:
        meta = meta[:, 0::2] | (meta[:, 1::2] << 8)
    return unpack_ascii(pb, nb), meta[:, 10], meta[:, :5], meta[:, 5:10]


def scan_ops(lengths, reached, recounted, skip) -> int:
    """Integer operations the full detector needs on these reads: per base
    the unpack and N count (1) and, where some k is recounted, the rolling
    code (3); for each reached k, per window the k digit shifts and ors
    (2k), k - 1 rotations (5 each) and the modal update (4); for each
    recounted k, per base the masked compare and the greedy step (5). A read
    skipped for its Ns needs only its N count."""
    n = np.asarray(lengths, np.int64)
    reached = np.asarray(reached, bool)
    recounted = np.asarray(recounted, bool)
    ops = n + 3 * n * recounted.any(axis=1)
    for ki, k in enumerate(KS):
        ops += reached[:, ki] * (n // k) * (2 * k + 5 * (k - 1) + 4)
        ops += recounted[:, ki] * 5 * n
    return int(np.where(np.asarray(skip, bool), n, ops).sum())


def batch_bound(rows: np.ndarray, layout: str, named: dict, device,
                sm_hz: float | None) -> dict:
    """The bound of one scan call: `rows` as the kernel received them
    (payload rows, or ASCII rows with lengths/te/tp in `named`)."""
    x = torch.from_numpy(np.ascontiguousarray(rows)).to(device)
    if layout == "ascii":
        bases = x
        lengths = torch.from_numpy(named["lengths"]).to(device)
        te = torch.from_numpy(named["te"]).to(device)
        tp = torch.from_numpy(named["tp"]).to(device)
    elif layout in ("n8", "w8", "w16"):
        bases, lengths, te, tp = unfuse_payload(x, layout)
    else:
        raise ValueError(f"no bound for the {layout!r} entry")
    with torch.no_grad():
        *_, reached, recounted, skip = detect_tensors(bases, lengths, te, tp)
    row_bytes = rows.shape[1] + sum(a[0].nbytes for a in named.values())
    nbytes = rows.shape[0] * (row_bytes + 12)
    ops = scan_ops(*(t.cpu().numpy() for t in (lengths, reached, recounted,
                                                skip)))
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / int32_ops_per_s(sm_hz)
    return {"bound_s": max(by_bytes, by_ops), "bytes": nbytes, "ops": ops,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
