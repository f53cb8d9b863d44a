"""One small launch of each kernel layout, for the CUDA compute-sanitizer.

    compute-sanitizer --tool memcheck python -m strling_tpu_torch.scripts.sanitizer_launches
    compute-sanitizer --tool racecheck python -m strling_tpu_torch.scripts.sanitizer_launches

Launches the repeat-scan kernel once on 256 rows of each input layout (n8,
w8 with Ns, w16, ASCII with IUPAC bytes, packed 2-bit rows with thresholds
outside u16) with the pairwise modal, and the sorted modal on the w16 F6
tile (85 k = 3 windows) and on ASCII rows of up to 4,000 bases (past the 64
windows its registers hold: the shared-memory sort). Each launch is held to
the plain PyTorch version; the script raises on a mismatch and prints one
line per launch. Needs a card.
"""

from __future__ import annotations

import numpy as np
import torch

from strling_tpu_torch.ops import kmer as K
from strling_tpu_torch.ops.kmer_cuda import repeat_scan
from strling_tpu_torch.scripts.exp_kernel_timing import bench_batch, f6_tile


def _inputs(bases, lengths, props, layout, dev):
    if layout in ("ascii", "packed"):
        te, tp = K._host_thresholds(lengths, props)
        named = {"lengths": lengths, "te": te, "tp": tp}
        x = bases
        if layout == "packed":
            x, named["nbits"] = K.pack_bases(bases)
        return (torch.from_numpy(np.ascontiguousarray(x)).to(dev),
                {k: torch.from_numpy(v).to(dev) for k, v in named.items()})
    payload, got = K.fuse_payload(bases, lengths, props, return_layout=True)
    assert got == layout, (got, layout)
    return torch.from_numpy(payload).to(dev), {}


def cases(B: int = 256):
    """(name, bases, lengths, props, layout, modal)"""
    bases, lengths = bench_batch(B, 152)
    props = np.full(B, 0.8)
    nb = bases.copy()
    nb[1::9, 40:70] = ord("N")
    iu = bases.copy()
    iu[3::20, 10] = ord("R")
    wb, wl = bench_batch(B, 256)
    f6b, f6l = f6_tile()
    rng = np.random.default_rng(4)
    lb = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (32, 4000))]
    lb[::2] = np.frombuffer((b"AAT" * 1334)[:4000], np.uint8)
    ll = rng.integers(3000, 4001, 32).astype(np.int32)
    for i in range(32):
        lb[i, ll[i]:] = 0
    lb[5, 100] = ord("R")
    return [
        ("n8", bases, lengths, props, "n8", "pairwise"),
        ("w8 with Ns", nb, lengths, props, "w8", "pairwise"),
        ("w16 (L=256)", wb, wl, np.full(B, 0.8), "w16", "pairwise"),
        ("ascii with IUPAC", iu, lengths, props, "ascii", "pairwise"),
        ("packed (props -0.05 and 1000)", nb, lengths,
         np.where(np.arange(B) % 2 == 0, -0.05, 1000.0), "packed", "pairwise"),
        ("sorted, F6 tile (85 k=3 windows)", f6b[:B], f6l[:B], np.full(B, 0.5),
         "w16", "sorted"),
        ("sorted, ascii up to 4000 bases", lb, ll, np.full(32, 0.5), "ascii",
         "sorted"),
    ]


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the launches need a card")
    dev = torch.device("cuda", 0)
    for name, bases, lengths, props, layout, modal in cases():
        x, named = _inputs(bases, lengths, props, layout, dev)
        got = [t.cpu() for t in repeat_scan(x, layout, modal=modal, **named)]
        want = [t.cpu() for t in K.repeat_codes_plain(x, layout, modal=modal,
                                                       **named)]
        bad = int(sum((g != w).sum() for g, w in zip(got, want)))
        print(f"{name}: {len(bases)} rows, layout {layout}, modal {modal}, "
              f"mismatches against the plain version {bad}", flush=True)
        if bad:
            raise RuntimeError(f"{name}: the kernel disagrees")
    print("sanitizer launches ok")


if __name__ == "__main__":
    main()
