"""Wall of the native extract of a bench BAM on the card, repeated
(experiment tool).

    python strling_tpu_torch/scripts/exp_extract_wall.py [--reads 500000] [--reps 5]

Generates the bench BAM (`exp_kernel_compare.bench_bam`: 150bp pairs, every
20th pair's second read a pure STR; cached under .smoke_cache/), runs
`extract_native` on cuda:0 once to warm up and then `--reps` times, and
prints one JSON line: the package it imported (its directory), every wall,
their median, the treads and the kernel launches of one run. Run as a file
with PYTHONPATH set to another checkout, it times that checkout's package
(for turns against a parent commit: parent, this, this, parent).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

import strling_tpu_torch
from strling_tpu_torch.core.extract import extract_native
from strling_tpu_torch.io import Bam
from strling_tpu_torch.ops import kmer_cuda
from strling_tpu_torch.scripts.exp_kernel_compare import bench_bam

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=500_000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the walls are the card's")
    dev = torch.device("cuda", 0)
    path = os.path.join(ROOT, ".smoke_cache", f"bench_{args.reads // 2}.bam")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        bench_bam(path, args.reads // 2)
    extract_native(Bam(path), None, None, devices=[dev])
    walls = []
    for _ in range(args.reps):
        kmer_cuda.launches = 0
        t0 = time.perf_counter()
        tb, _, _ = extract_native(Bam(path), None, None, devices=[dev])
        walls.append(time.perf_counter() - t0)
    out = {"package": os.path.dirname(strling_tpu_torch.__file__),
           "device": torch.cuda.get_device_name(dev), "reads": args.reads,
           "walls_s": walls, "median_s": statistics.median(walls),
           "treads": len(tb), "launches": kmer_cuda.launches}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
