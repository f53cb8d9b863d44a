"""Cohort-scale joint-merge demo: N samples, single-process vs distributed.

Port of the JAX package's `scripts/cohort_demo.py`. Builds an N-sample
cohort (simulated BAMs at shared + private STR loci, native extract -> bin
each, the scan on `--device`), then runs joint locus discovery twice:
  1. single-process `run_merge`
  2. `merge --distributed` on `--procs` torch.distributed ranks
     (`parallel.merge_dist.run_merge_dist`, subprocesses with `file://`
     init in --out; Gloo on the CPU or when ranks share a card, NCCL when
     each has its own)
and asserts the two -bounds.txt files are BYTE-IDENTICAL (including line
order — both paths write the canonical order). Reports wall time and peak
RSS against the reference's slurm budget for the merge stage
(120 GB / 48 h, pipelines/bpipe.config:16-18). Peak RSS is each process's
own: the kernel's high-water mark (VmHWM) where /proc has it, else the
largest VmRSS a sampling thread saw. getrusage's ru_maxrss, which the JAX
script prints, can carry a rank's parent's peak across fork and exec.

Usage: python -m strling_tpu_torch.scripts.cohort_demo --out /tmp/cohort [--n 100] [--procs 2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import numpy as np

from strling_tpu_torch.core.extract import extract_native, scan_devices
from strling_tpu_torch.core.merge import run_merge
from strling_tpu_torch.core.simulate import Allele, normal_hist, simulate_str_bam
from strling_tpu_torch.io.bam import Bam
from strling_tpu_torch.io.binfmt import write_bin
from strling_tpu_torch.io.fasta import build_fai, write_fasta
from strling_tpu_torch.scripts.ranks import run_ranks

#: one rank: the port alone, a group from a file:// store
RANK = """
import sys
sys.modules["jax"] = None
sys.modules["strling_tpu"] = None
import time
from strling_tpu_torch.parallel.merge_dist import run_merge_dist
from strling_tpu_torch.parallel.mesh import init_distributed
from strling_tpu_torch.scripts.cohort_demo import PeakRss
rss = PeakRss()
pid, n, init, device, out_prefix = sys.argv[1:6]
bins = sys.argv[6:]
init_distributed(device, init_method="file://" + init, rank=int(pid),
                 world_size=int(n))
t0 = time.perf_counter()
run_merge_dist(bins, output_prefix=out_prefix)
dt = time.perf_counter() - t0
print(f"[p{pid}] wall={dt:.1f}s peak_rss={rss.gb():.2f}GB", file=sys.stderr)
"""


def _status_kb(field: str) -> int | None:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith(field + ":"):
                return int(line.split()[1])
    return None


class PeakRss:
    """This process's peak resident set from its creation on: VmHWM where
    /proc/self/status has it (Linux), else the largest VmRSS a daemon
    thread reads every 10 ms (hosts whose /proc lacks the high-water
    mark)."""

    def __init__(self):
        self.peak_kb = 0
        if _status_kb("VmHWM") is None:
            threading.Thread(target=self._sample, daemon=True).start()

    def _sample(self):
        while True:
            self.peak_kb = max(self.peak_kb, _status_kb("VmRSS") or 0)
            time.sleep(0.01)

    def gb(self) -> float:
        hwm = _status_kb("VmHWM")
        if hwm is None:
            hwm = max(self.peak_kb, _status_kb("VmRSS") or 0)
        return hwm * 1024 / 1e9


def build_cohort(out: str, n: int, seed: int, device: str = "cuda"):
    devices = scan_devices(device)
    rng = np.random.default_rng(seed)
    G = 120_000
    g = "".join(np.array(list("ACGT"))[rng.integers(0, 4, G)])
    # three shared reference STR loci + room for private novel ones
    shared = [(30_000, "CAG"), (60_000, "AT"), (90_000, "AAGGG")]
    parts, cur = [], 0
    for pos, unit in shared:
        parts.append(g[cur:pos])
        parts.append(unit * 10)
        cur = pos
    parts.append(g[cur:])
    fa = os.path.join(out, "ref.fa")
    write_fasta(fa, {"chr1": "".join(parts)})
    build_fai(fa, fa + ".fai")
    hist = normal_hist(400, 50)
    bins = []
    for s in range(n):
        binp = os.path.join(out, f"s{s:03d}.bin")
        bins.append(binp)
        if os.path.exists(binp):
            continue
        alleles = []
        for i, (pos, unit) in enumerate(shared):
            exp = int(rng.integers(60, 200)) if rng.random() < 0.4 else 0
            if exp:
                alleles.append(Allele("chr1", pos + 10 * len(unit) * i, (0, exp), unit))
        if not alleles:
            alleles = [Allele("chr1", 30_000, (0, int(rng.integers(80, 160))), "CAG")]
        bam_p = os.path.join(out, f"s{s:03d}.bam")
        simulate_str_bam(fa, alleles, bam_p, hist, depth=20, flank=10_000,
                         seed=int(rng.integers(0, 1 << 31)))
        bam = Bam(bam_p)
        tb, frag, _ = extract_native(bam, None, None, devices=devices)
        write_bin(binp, tb, frag, bam.header_text, 0.8, 40)
        os.unlink(bam_p)
        if os.path.exists(bam_p + ".bai"):
            os.unlink(bam_p + ".bai")
        print(f"[cohort] sample {s}: {len(tb)} treads", file=sys.stderr)
    return bins


def build_cohort_synthetic(out: str, n: int, treads_per_sample: int,
                           n_loci: int, seed: int):
    """Heavy-cohort mode: bins written directly with generated treads
    (clustered around n_loci shared loci across 22 chromosomes), stressing
    merge at WGS-cohort scale without simulating reads."""
    from strling_tpu_torch.core.tread import TREAD_DTYPE, TreadBatch

    rng = np.random.default_rng(seed)
    targets = [(f"chr{c+1}", 50_000_000) for c in range(22)]
    header = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{ln}\n" for name, ln in targets)
    units = np.array([b"AGC", b"AT", b"AAGGG", b"A", b"AAG", b"AATGG"],
                     dtype="S6")
    loci_tid = rng.integers(0, 22, n_loci)
    loci_pos = rng.integers(100_000, 49_000_000, n_loci)
    loci_unit = rng.integers(0, len(units), n_loci)
    hist = normal_hist(400, 50)
    bins = []
    for s in range(n):
        binp = os.path.join(out, f"y{s:03d}.bin")
        bins.append(binp)
        if os.path.exists(binp):
            continue
        m = treads_per_sample
        li = rng.integers(0, n_loci, m)
        data = np.zeros(m, TREAD_DTYPE)
        data["tid"] = loci_tid[li]
        data["position"] = (loci_pos[li]
                            + rng.integers(-300, 300, m)).astype(np.uint32)
        data["repeat"] = units[loci_unit[li]]
        data["flag"] = 97
        data["split"] = 3  # Soft.none (anchored)
        data["mapping_quality"] = 60
        data["repeat_count"] = rng.integers(20, 50, m)
        data["align_length"] = 150
        order = np.lexsort((data["position"], data["tid"]))
        data = data[order]
        tb = TreadBatch(data=data, qnames=[f"q{s}_{i}" for i in range(m)])
        write_bin(binp, tb, hist, header, 0.8, 40)
        if s % 20 == 0:
            print(f"[cohort] synthetic sample {s}", file=sys.stderr)
    return bins


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--synthetic-treads", type=int, default=0,
                   help="per-sample tread count: skip read simulation and "
                        "write synthetic bins at WGS-cohort scale")
    p.add_argument("--loci", type=int, default=2000)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where extract scans and the ranks' device: cuda "
                        "(default; raises without a card) or cpu")
    args = p.parse_args(argv)
    scan_devices(args.device)  # no card for --device cuda: raise now
    rss = PeakRss()
    os.makedirs(args.out, exist_ok=True)
    if args.synthetic_treads:
        bins = build_cohort_synthetic(args.out, args.n, args.synthetic_treads,
                                      args.loci, args.seed)
    else:
        bins = build_cohort(args.out, args.n, args.seed, args.device)

    sp_prefix = os.path.join(args.out, "joint_sp")
    t0 = time.perf_counter()
    run_merge(bins, output_prefix=sp_prefix)
    sp_wall = time.perf_counter() - t0
    print(f"[cohort] single-process merge: wall={sp_wall:.1f}s "
          f"peak_rss={rss.gb():.2f}GB")

    dp_prefix = os.path.join(args.out, "joint_dp")
    t0 = time.perf_counter()
    errs = run_ranks(RANK, args.procs, os.path.join(args.out, "dist_init"),
                     [args.device, dp_prefix] + bins)
    for err in errs:
        sys.stderr.write(err[-500:])
    dp_wall = time.perf_counter() - t0
    print(f"[cohort] {args.procs}-process distributed merge: "
          f"wall={dp_wall:.1f}s")

    with open(sp_prefix + "-bounds.txt", "rb") as fh:
        a = fh.read()
    with open(dp_prefix + "-bounds.txt", "rb") as fh:
        b = fh.read()
    assert a == b, "distributed merge output differs from single-process!"
    n_loci = len(a.splitlines()) - 1
    print(f"[cohort] OK: {args.n} samples, {n_loci} joint loci, outputs "
          "byte-identical (incl. order). Reference merge budget: "
          "120 GB / 48 h (bpipe.config:16-18).")


if __name__ == "__main__":
    main()
