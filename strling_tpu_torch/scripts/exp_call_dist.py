"""One process against N ranks of `call` on the same host (experiment tool).

    python -m strling_tpu_torch.scripts.exp_call_dist [--loci 5000] [--ranks 2] [--device cuda|cpu]

Builds bench.py's call workload (`_bench_call_inputs`: n novel CAG clusters
25 kb apart, 20x coverage within 1,150 bp of each, the evidence treads
written straight to the bin; cached under .smoke_cache/), times `run_call`
(best of 2) and `run_call_dist` in `--ranks` ranks (`scripts/ranks.run_ranks`:
a `file://` store; NCCL when each rank has a card of its own, else Gloo),
timed from a barrier after the group starts (the slower rank, best of 2),
checks that the ranks' files are byte-identical to the one-process files,
and prints one JSON line: loci called, seconds and loci/s of each, and their
ratio. The JAX package's 2-process call ran at 0.54x its one process on
this workload (fault F4: every process redid the setup).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from strling_tpu_torch.scripts.ranks import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CACHE = os.path.join(ROOT, ".smoke_cache")

RANK = """
import json, sys, time
sys.modules["jax"] = None
sys.modules["strling_tpu"] = None
import torch.distributed as dist
from strling_tpu_torch.parallel.call_dist import run_call_dist
from strling_tpu_torch.parallel.mesh import init_distributed
rank, world, init, bam, binp, prefix, device, out = sys.argv[1:9]
dev = init_distributed(device, init_method="file://" + init, rank=int(rank),
                       world_size=int(world))
secs = []
for _ in range(2):
    dist.barrier()
    t0 = time.perf_counter()
    run_call_dist(bam, binp, output_prefix=prefix, device=dev)
    secs.append(time.perf_counter() - t0)
with open(out % int(rank), "w") as fh:
    json.dump({"secs": secs, "backend": dist.get_backend()}, fh)
"""


def call_inputs(n_loci: int, depth: int = 20, gap: int = 25_000):
    """bench.py's _bench_call_inputs, on the port's writers."""
    from strling_tpu_torch.core.tread import TREAD_DTYPE, Soft, TreadBatch
    from strling_tpu_torch.io import BamRecord, write_bam, write_bin
    from strling_tpu_torch.utils.fraglen import NBINS

    os.makedirs(CACHE, exist_ok=True)
    bam_path = os.path.join(CACHE, f"call_{n_loci}_{depth}.bam")
    bin_path = os.path.join(CACHE, f"call_{n_loci}_{depth}.bin")
    if os.path.exists(bam_path) and os.path.exists(bin_path):
        return bam_path, bin_path
    rng = np.random.default_rng(11)
    G = gap * (n_loci + 1) + 20_000
    L, half = 150, 1_150
    n_pairs = int(2 * half * depth / (2 * L))
    lut = np.frombuffer(b"ACGT", np.uint8)
    loci_pos = (np.arange(n_loci, dtype=np.int64) + 1) * gap
    starts = (loci_pos[:, None]
              + rng.integers(-half, half - 420, (n_loci, n_pairs))).ravel()
    isz = rng.integers(330, 470, n_loci * n_pairs)
    codes = rng.integers(0, 4, (n_loci * n_pairs, 2, L), dtype=np.uint8)
    recs = []
    for j in range(n_loci * n_pairs):
        p, i = int(starts[j]), int(isz[j])
        s1 = lut[codes[j, 0]].tobytes().decode()
        s2 = lut[codes[j, 1]].tobytes().decode()
        recs.append(BamRecord(f"r{j}", 0x63, 0, p, 60, [(L, 0)], 0,
                              p + i - L, i, s1))
        recs.append(BamRecord(f"r{j}", 0x93, 0, p + i - L, 60, [(L, 0)], 0, p,
                              -i, s2))
    recs.sort(key=lambda r: r.pos)
    hdr = "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chrC\tLN:%d\n" % G
    write_bam(bam_path + ".tmp", hdr, [("chrC", G)], recs)
    os.replace(bam_path + ".tmp.bai", bam_path + ".bai")
    os.replace(bam_path + ".tmp", bam_path)
    # evidence treads: per locus 12 anchored + 6 left-clip + 6 right-clip
    per = 24
    data = np.zeros(n_loci * per, TREAD_DTYPE)
    qnames = []
    k = 0
    for li in range(n_loci):
        p = int(loci_pos[li])
        for a in np.sort(rng.integers(p - 350, p - 40, 12)):
            data[k] = (0, a, b"CAG", 0x63, int(Soft.none), 60,
                       int(rng.integers(25, 50)), L, -1)
            qnames.append(f"t{li}_{k % per}")
            k += 1
        for pos, split in ((p, Soft.left), (p + 40, Soft.right)):
            for _ in range(6):
                data[k] = (0, pos, b"CAG", 0x63, int(split), 60, 45, L, -1)
                qnames.append(f"t{li}_{k % per}")
                k += 1
    hist = np.zeros(NBINS, np.uint32)
    np.add.at(hist, isz, 1)
    write_bin(bin_path + ".tmp", TreadBatch(data=data, qnames=qnames), hist,
              hdr, 0.8, 40)
    os.replace(bin_path + ".tmp", bin_path)
    return bam_path, bin_path


def call_ranks(bam, binp, prefix, device, n: int) -> tuple[list, str]:
    """`run_call_dist` twice in `n` ranks; returns the slower rank's seconds
    of each run and the backend."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rank%d.json")
        run_ranks(RANK, n, os.path.join(d, "init"),
                  [bam, binp, prefix, device, out])
        res = []
        for r in range(n):
            with open(out % r) as fh:
                res.append(json.load(fh))
    return ([max(r["secs"][i] for r in res) for i in range(2)],
            res[0]["backend"])


def same_call_files(a: str, b: str):
    for sfx in ("-genotype.txt", "-bounds.txt", "-unplaced.txt"):
        with open(a + sfx, "rb") as x, open(b + sfx, "rb") as y:
            if x.read() != y.read():
                raise RuntimeError(f"{b}{sfx} differs from {a}{sfx}")


def main(argv=None) -> dict:
    from strling_tpu_torch.core.call import run_call

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loci", type=int, default=5000)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    bam, binp = call_inputs(a.loci)
    gen_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        one = []
        for _ in range(2):
            t0 = time.perf_counter()
            run_call(bam, binp, output_prefix=os.path.join(d, "one"))
            one.append(time.perf_counter() - t0)
        secs, backend = call_ranks(bam, binp, os.path.join(d, "ranks"),
                                   a.device, a.ranks)
        same_call_files(os.path.join(d, "one"), os.path.join(d, "ranks"))
        with open(os.path.join(d, "one-genotype.txt")) as fh:
            n = len(fh.read().splitlines()) - 1
    rec = {"loci_called": n, "one_process_s": min(one),
           "one_process_loci_per_s": n / min(one), "ranks": a.ranks,
           "ranks_s": min(secs), "ranks_loci_per_s": n / min(secs),
           "ranks_over_one": min(one) / min(secs), "backend": backend,
           "inputs_s": gen_s,
           "timing": "host clock; one process best of 2; the ranks the "
                     "slower rank from a barrier, best of 2",
           "outputs": "byte-identical"}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
