"""The port on several cards of one host: what more cards buy (experiment
tool).

    python -m strling_tpu_torch.scripts.exp_multicard [--steps devices,dist_extract,call,merge,torchrun]
        [--pairs 2500000] [--samples 100] [--out FILE]
    python -m strling_tpu_torch.scripts.exp_multicard --prepare [--pairs ...] [--samples ...]

Needs CUDA cards: without one it raises, and nothing falls back to the CPU.
The sizes are 1, 2 and 4 cards, those of them the host has. Every
comparison runs in turns inside the one call, up and down the sizes (1, 2,
4, 4, 2, 1); a size's result is the median of its turns beside their
lowest and highest. Every run's output is held byte for byte
to one process's (the gate) before its time is kept. The inputs are cached
under .smoke_cache/; `--prepare` only builds them (the BAM takes minutes),
so that it can run beside other work.

Steps (each prints one JSON line; all of them go to `--out` as well):
- devices: `extract_native` over the first N cards (`extract --devices N`:
  scan batches round robin) of a bench BAM of `--pairs` pairs over 24
  contigs (`exp_kernel_compare.bench_bam(n_chrom=24)`): wall, device_wait
  (the feed loop's wait on scans), host_loop (the rest), batches and
  launches by card; gate: the bin equals one card's.
- dist_extract: `run_extract_dist` of the same BAM in N ranks, a card each
  (NCCL): each rank's wall and its split (BAM open, rank 0's histogram
  pass, scan, gathers and pairing, write), from the second of two runs in
  the group (the first loads the kernel); gate: the bin equals one
  process's.
- call: `run_call_dist` of bench.py's 5,000-locus workload
  (`exp_call_dist.call_inputs`) in N ranks, the slower rank from a barrier,
  best of two runs a group; one process's `run_call`, best of 2, takes the
  first and the last turn (one, 1, 2, 4, 4, 2, 1, one); gate: the files
  equal the first turn's.
- merge: `cohort_demo`'s merge ranks (`run_merge_dist`) on a synthetic
  cohort (`--samples` samples of 100,000 treads,
  `cohort_demo.build_cohort_synthetic`) in N ranks: each rank's wall and
  peak RSS; gate: the bounds equal one process's `run_merge`. `free -g`
  comes first: the sample count must fit the host.
- torchrun: the CLI as users launch it, `torchrun --standalone
  --nproc-per-node 4 -m strling_tpu_torch.cli extract|merge|call
  --distributed`, on the BAM, the cohort's first 20 samples and the call
  workload, each timed on the host clock; gate: every file equals one
  process's.

The dryrun at world 4 is timed by `chip_smoke.py` phase 7 and the card test.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from strling_tpu_torch.parallel.mesh import backend_rule
from strling_tpu_torch.scripts.ranks import ROOT, run_ranks

CACHE = os.path.join(ROOT, ".smoke_cache")
#: the rank scripts' first line: the port alone
GUARD = 'import sys; sys.modules["jax"] = None; sys.modules["strling_tpu"] = None\n'
#: ranks of the CLI under torchrun
TORCHRUN_RANKS = 4
#: samples of the cohort that the torchrun merge takes
TORCHRUN_SAMPLES = 20
#: treads a sample, loci and seed of the synthetic cohort
COHORT = (100_000, 2000, 3)

EXTRACT_RANK = GUARD + """
import json
import torch.distributed as dist
from strling_tpu_torch.ops import kmer_cuda
from strling_tpu_torch.parallel.extract_dist import run_extract_dist
from strling_tpu_torch.parallel.mesh import init_distributed
rank, world, init, bam, binp, out = sys.argv[1:7]
init_distributed("cuda", init_method="file://" + init, rank=int(rank),
                 world_size=int(world))
runs = []
for _ in range(2):
    kmer_cuda.launches_by_device.clear()
    st = {}
    run_extract_dist(bam, output_bin=binp, stats=st)
    runs.append(dict(st, launches_by_device=dict(kmer_cuda.launches_by_device),
                     backend=dist.get_backend()))
with open(out % int(rank), "w") as fh:
    json.dump(runs, fh)
"""


class Run:
    """What the steps share: the sizes, the inputs and the results so far."""

    def __init__(self, sizes: list[int], pairs: int, samples: int,
                 work: str):
        self.sizes = sizes
        self.pairs, self.samples, self.work = pairs, samples, work
        self.results: dict = {}
        self._ref_bin = None

    @staticmethod
    def devices(n: int) -> list[torch.device]:
        return [torch.device("cuda", i) for i in range(n)]

    def turns(self) -> list[int]:
        """The sizes up and down: 1, 2, 4, 4, 2, 1."""
        return [*self.sizes, *reversed(self.sizes)]

    def bam(self) -> str:
        from strling_tpu_torch.scripts.exp_kernel_compare import bench_bam

        path = os.path.join(CACHE, f"bench24_{self.pairs}.bam")
        if not os.path.exists(path):
            os.makedirs(CACHE, exist_ok=True)
            bench_bam(path, self.pairs, n_chrom=24)
        return path

    def cohort(self) -> list[str]:
        from strling_tpu_torch.scripts.cohort_demo import build_cohort_synthetic

        # a directory per cohort: the builder keeps the bins it finds
        d = os.path.join(CACHE, "cohort_synthetic_" + "_".join(
            map(str, (self.samples, *COHORT))))
        os.makedirs(d, exist_ok=True)
        return build_cohort_synthetic(d, self.samples, *COHORT)

    def ref_bin(self) -> bytes:
        """One process's bin of the BAM, on one device."""
        if self._ref_bin is None:
            from strling_tpu_torch.core.extract import extract_native
            from strling_tpu_torch.io import Bam, write_bin

            bam = Bam(self.bam())
            tb, frag, _ = extract_native(bam, None, None,
                                         devices=self.devices(1))
            path = os.path.join(self.work, "ref.bin")
            write_bin(path, tb, frag, bam.header_text, 0.8, 40)
            self._ref_bin = _read(path)
        return self._ref_bin

    def emit(self, step: str, rec: dict):
        self.results[step] = rec
        print(json.dumps({"step": step, **rec}), flush=True)


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _same(got: str, want: bytes | str, what: str):
    if _read(got) != (want if isinstance(want, bytes) else _read(want)):
        raise RuntimeError(f"{what}: {got} differs from one process's")


def summary(by_size: dict) -> dict:
    """{size: {runs, median, min, max}} of {size: [seconds, ...]}."""
    return {str(n): {"runs": v, "median": statistics.median(v),
                     "min": min(v), "max": max(v)}
            for n, v in sorted(by_size.items())}


def step_devices(run: Run):
    """extract --devices N in one process."""
    from strling_tpu_torch.core.extract import extract_native
    from strling_tpu_torch.io import Bam, write_bin
    from strling_tpu_torch.ops import kmer_cuda

    want = run.ref_bin()
    walls, detail = {}, {}
    for n in run.turns():
        kmer_cuda.launches_by_device.clear()
        stats = {}
        t0 = time.perf_counter()
        bam = Bam(run.bam())
        tb, frag, _ = extract_native(bam, None, None,
                                     devices=run.devices(n), stats=stats)
        wall = time.perf_counter() - t0
        path = os.path.join(run.work, f"devices{n}.bin")
        write_bin(path, tb, frag, bam.header_text, 0.8, 40)
        _same(path, want, f"extract --devices {n}")
        by_card = dict(kmer_cuda.launches_by_device)
        if sorted(by_card) != list(range(n)):
            raise RuntimeError(f"--devices {n} launched on cards {by_card}")
        walls.setdefault(n, []).append(wall)
        detail.setdefault(str(n), []).append(
            {"wall_s": wall, "device_wait_s": stats["wait_s"],
             "host_loop_s": wall - stats["wait_s"],
             "inflight_scan_s": stats["scan_s"],
             "batches": stats["n_batches"],
             "launches_by_card": {str(k): v for k, v in sorted(by_card.items())}})
    run.emit("devices", {"reads": 2 * run.pairs, "wall_s": summary(walls),
                         "runs": detail, "gate": "bins byte-identical"})


def _rank_results(out: str, world: int) -> list:
    res = []
    for r in range(world):
        with open(out % r) as fh:
            res.append(json.load(fh))
    return res


def step_dist_extract(run: Run):
    want = run.ref_bin()
    walls, detail = {}, {}
    for n in run.turns():
        with tempfile.TemporaryDirectory(dir=run.work) as d:
            out, binp = os.path.join(d, "rank%d.json"), os.path.join(d, "x.bin")
            run_ranks(EXTRACT_RANK, n, os.path.join(d, "init"),
                      [run.bam(), binp, out], timeout=1200)
            _same(binp, want, f"distributed extract at {n} ranks")
            ranks = [rs[1] for rs in _rank_results(out, n)]
        keys = ("wall_s", "open_s", "hist_s", "index_s", "scan_s",
                "gather_s", "write_s", "treads_local", "spills_local",
                "gathered_bytes", "launches_by_device")
        walls.setdefault(n, []).append(max(r["wall_s"] for r in ranks))
        detail.setdefault(str(n), []).append(
            {"backend": ranks[0]["backend"],
             "ranks": [{k: r[k] for k in keys} for r in ranks]})
    run.emit("dist_extract", {"reads": 2 * run.pairs,
                              "slowest_rank_wall_s": summary(walls),
                              "runs": detail, "gate": "bins byte-identical"})


def step_call(run: Run):
    from strling_tpu_torch.core.call import run_call
    from strling_tpu_torch.scripts.exp_call_dist import (
        call_inputs, call_ranks, same_call_files)

    bam, binp = call_inputs(5000)
    want = os.path.join(run.work, "call_want")
    secs, backends = {}, {}
    for n in ["one", *run.turns(), "one"]:
        prefix = os.path.join(run.work, f"call_{n}")
        if n == "one":
            s = []
            for _ in range(2):
                t0 = time.perf_counter()
                run_call(bam, binp, output_prefix=prefix)
                s.append(time.perf_counter() - t0)
            if not os.path.exists(want + "-genotype.txt"):
                for sfx in ("-genotype.txt", "-bounds.txt", "-unplaced.txt"):
                    shutil.copyfile(prefix + sfx, want + sfx)
        else:
            s, backends[str(n)] = call_ranks(bam, binp, prefix, "cuda", n)
        same_call_files(want, prefix)
        secs.setdefault(n, []).append(min(s))
    with open(want + "-genotype.txt") as fh:
        loci = len(fh.read().splitlines()) - 1
    one = secs.pop("one")
    run.emit("call", {"loci": loci, "one_process_s": summary({1: one})["1"],
                      "ranks_s": summary(secs), "backend": backends,
                      "timing": "host clock; one process and the slower "
                                "rank from a barrier, best of 2 a turn",
                      "gate": "files byte-identical to the first turn's"})


def _free_g() -> str:
    return subprocess.run(["free", "-g"], capture_output=True, text=True,
                          check=True).stdout


def step_merge(run: Run):
    from strling_tpu_torch.core.merge import run_merge
    from strling_tpu_torch.scripts.cohort_demo import RANK

    free = _free_g()
    bins = run.cohort()
    want = os.path.join(run.work, "merge_one")
    run_merge(bins, output_prefix=want)
    walls, detail = {}, {}
    for n in run.turns():
        with tempfile.TemporaryDirectory(dir=run.work) as d:
            prefix = os.path.join(d, "dist")
            run_ranks(RANK, n, os.path.join(d, "init"),
                      ["cuda", prefix, *bins], timeout=3600)
            _same(prefix + "-bounds.txt", want + "-bounds.txt",
                  f"merge at {n} ranks")
            ranks = _rank_results(prefix + "-rank%d.json", n)
        walls.setdefault(n, []).append(max(r["wall_s"] for r in ranks))
        detail.setdefault(str(n), []).append(ranks)
    run.emit("merge", {"samples": len(bins), "treads": COHORT[0] * len(bins),
                       "free_g": free, "slowest_rank_wall_s": summary(walls),
                       "runs": detail, "gate": "bounds byte-identical to one "
                                               "process's run_merge"})


def _torchrun(args: list[str]) -> float:
    """The CLI under torchrun; returns its wall. Every rank must have taken
    the backend the rule gives four ranks on this host's cards."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(TORCHRUN_RANKS), "-m", "strling_tpu_torch.cli",
         args[0], "--distributed", "--device", "cuda", *args[1:]],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=1800)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun {args[0]} exited with "
                           f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    backend = _torchrun_backend()
    if proc.stderr.count(f": backend {backend} (") != TORCHRUN_RANKS:
        raise RuntimeError(f"torchrun {args[0]}: not every rank on {backend}:"
                           f"\n{proc.stderr[-3000:]}")
    return wall


def _torchrun_backend() -> str:
    return backend_rule("cuda", TORCHRUN_RANKS, torch.cuda.device_count())[0]


def step_torchrun(run: Run):
    from strling_tpu_torch.core.call import run_call
    from strling_tpu_torch.core.merge import run_merge
    from strling_tpu_torch.scripts.exp_call_dist import call_inputs, same_call_files

    rec = {"ranks": TORCHRUN_RANKS, "backend": _torchrun_backend()}
    binp = os.path.join(run.work, "torchrun.bin")
    rec["extract_s"] = _torchrun(["extract", run.bam(), binp])
    _same(binp, run.ref_bin(), "torchrun extract")
    bins = run.cohort()[:TORCHRUN_SAMPLES]
    one = os.path.join(run.work, "torchrun_one_merge")
    run_merge(bins, output_prefix=one)
    prefix = os.path.join(run.work, "torchrun_merge")
    rec["merge_s"] = _torchrun(["merge", "-o", prefix, *bins])
    _same(prefix + "-bounds.txt", one + "-bounds.txt", "torchrun merge")
    bam, cbin = call_inputs(5000)
    one = os.path.join(run.work, "torchrun_one_call")
    run_call(bam, cbin, output_prefix=one)
    prefix = os.path.join(run.work, "torchrun_call")
    rec["call_s"] = _torchrun(["call", "-o", prefix, bam, cbin])
    same_call_files(one, prefix)
    rec["gate"] = "extract bin, merge bounds, call files byte-identical"
    rec["timing"] = "host clock around torchrun, the ranks' start included"
    run.emit("torchrun", rec)


STEP_FUNCS = {"devices": step_devices, "dist_extract": step_dist_extract,
              "call": step_call, "merge": step_merge,
              "torchrun": step_torchrun}


def smi_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", default=",".join(STEP_FUNCS))
    ap.add_argument("--pairs", type=int, default=2_500_000)
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--prepare", action="store_true",
                    help="only build the inputs")
    ap.add_argument("--out", default=os.path.join(CACHE, "exp_multicard.json"))
    a = ap.parse_args(argv)
    steps = a.steps.split(",")
    unknown = set(steps) - set(STEP_FUNCS)
    if unknown:
        raise SystemExit(f"unknown steps {sorted(unknown)}; steps: "
                         f"{list(STEP_FUNCS)}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the walls are the cards'")
    n = torch.cuda.device_count()
    os.makedirs(CACHE, exist_ok=True)
    work = tempfile.mkdtemp(prefix="exp_multicard_", dir=CACHE)
    run = Run([s for s in (1, 2, 4) if s <= n], a.pairs, a.samples, work)
    if a.prepare:
        from strling_tpu_torch.scripts.exp_call_dist import call_inputs

        run.bam(), run.cohort(), call_inputs(5000)
        os.rmdir(work)
        return {}
    head = {"cards": n, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi_lines(), "sizes": run.sizes}
    print(json.dumps(head), flush=True)
    t0 = time.perf_counter()
    try:
        for step in steps:
            STEP_FUNCS[step](run)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = dict(head, steps=run.results, seconds=time.perf_counter() - t0)
    with open(a.out, "w") as fh:
        json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
