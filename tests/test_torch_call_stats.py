"""The call's spans and counters: `run_call_dist(stats=...)` on two Gloo
ranks fills every key and its shards add up to the work, `run_call(stats=
...)` fills its own, the records the histogram and the collect decode are
counted, and `call --distributed --profile` holds each phase's span in
every rank's trace. The outputs are unchanged: both ranks' files equal one
process's.

Ranks run as subprocesses on Gloo with `file://` init in tmp_path, each
with a timeout; the port alone (JAX and the JAX package blocked)."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from strling_tpu_torch.core.call import PHASES as CALL_PHASES
from strling_tpu_torch.core.call import run_call
from strling_tpu_torch.core.extract import extract_native
from strling_tpu_torch.core.simulate import Allele, normal_hist, simulate_str_bam
from strling_tpu_torch.io import Bam, write_bin, write_fasta
from strling_tpu_torch.io.extract_native import native_frag_hist
from strling_tpu_torch.parallel.call_dist import PHASES

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCUS = 20000
FILES = ("-genotype.txt", "-bounds.txt", "-unplaced.txt")

RANK = """
import json, os, sys
sys.modules["jax"] = None
sys.modules["strling_tpu"] = None
import torch
torch.set_num_threads(1)
from strling_tpu_torch.parallel.mesh import init_distributed
rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
a = json.loads(sys.argv[4])
dev = init_distributed("cpu", init_method="file://" + init, rank=rank,
                       world_size=world)
from strling_tpu_torch.core.call import call_main
from strling_tpu_torch.parallel.call_dist import run_call_dist
stats = {}
run_call_dist(a["bam"], a["bin"], loci=a["bed"],
              output_prefix=a["prefix"] + "stats", device=dev, stats=stats)
# the CLI's path: the group is up, so call_main joins it
call_main(["--distributed", "--device", "cpu", "--profile", a["trace"],
           "-l", a["bed"], "-o", a["prefix"] + "cli", a["bam"], a["bin"]])
print(json.dumps(stats))
"""


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """A CAG expansion at 30x on a 40 kb contig, its bin (the port's
    extract on the CPU), a two-locus bed, and one process's call of it."""
    d = tmp_path_factory.mktemp("callstats")
    rng = np.random.default_rng(7)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40000)])
    seq = seq[:LOCUS] + "CAG" * 10 + seq[LOCUS:]
    fa = str(d / "ref.fa")
    write_fasta(fa, {"chr1": seq})
    bam_p = str(d / "s.bam")
    simulate_str_bam(fa, [Allele("chr1", LOCUS, (0, 120), "CAG")], bam_p,
                     normal_hist(400, 50), depth=30, flank=6000, seed=4)
    bam = Bam(bam_p)
    treads, frag, _ = extract_native(bam, None, None,
                                     devices=[torch.device("cpu")])
    bin_p = str(d / "s.bin")
    write_bin(bin_p, treads, frag, bam.header_text, 0.8, 40)
    bed = str(d / "loci.bed")
    with open(bed, "w") as fh:
        fh.write(f"chr1\t{LOCUS}\t{LOCUS + 30}\tCAG\tHTT_like\n"
                 f"chr1\t{LOCUS + 3000}\t{LOCUS + 3024}\tAT\n")
    stats = {}
    run_call(bam_p, bin_p, loci=bed, output_prefix=str(d / "one"),
             stats=stats)
    return d, bam_p, bin_p, bed, stats


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def two_ranks(sample, tmp_path_factory):
    d, bam_p, bin_p, bed, _ = sample
    tmp = tmp_path_factory.mktemp("callstats2")
    script = tmp / "rank.py"
    script.write_text(textwrap.dedent(RANK))
    args = json.dumps({"bam": bam_p, "bin": bin_p, "bed": bed,
                       "prefix": str(tmp / "dist_"),
                       "trace": str(tmp / "trace")})
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2", str(tmp / "init"), args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-2000:]}"
    return tmp, [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]


def test_two_rank_stats_fill_every_key(sample, two_ranks):
    _, per_rank = two_ranks
    for r, st in enumerate(per_rank):
        assert st["rank"] == r and st["world"] == 2
        assert set(st["span_s"]) == set(PHASES)
        assert all(v >= 0 for v in st["span_s"].values())
        assert st["span_s"]["collect"] > 0 and st["span_s"]["replay"] > 0
        assert 0 < st["collective_wait_s"] < sum(st["span_s"].values())
        assert st["broadcast_bytes"] > 0 and st["gathered_bytes"] > 0
        assert st["collect_records"] > 0
    # only rank 0 reads the histogram: every record of a BAM this small
    n = sum(len(b) for b in Bam(sample[1]).batches())
    assert [st["hist_records"] for st in per_rank] == [n, 0]
    # the shards are a partition of the work items, dealt round-robin:
    # item i to rank (i + 1) % world
    work = per_rank[0]["work_items"]
    assert all(st["work_items"] == work for st in per_rank)
    assert [st["shard_loci"] for st in per_rank] == [
        sum((i + 1) % 2 == r for i in range(work)) for r in range(2)]
    assert per_rank[0]["called"] == per_rank[1]["called"] <= work


def test_two_rank_files_equal_one_process(sample, two_ranks):
    d = sample[0]
    tmp, _ = two_ranks
    for run in ("stats", "cli"):
        for s in FILES:
            assert _bytes(str(tmp / f"dist_{run}{s}")) == _bytes(str(d / ("one" + s)))


def test_profile_holds_every_phase_on_every_rank(two_ranks):
    tmp, _ = two_ranks
    for r in range(2):
        with open(tmp / "trace" / f"call.rank{r}.pt.trace.json") as fh:
            names = {e.get("name") for e in json.load(fh)["traceEvents"]
                     if e.get("cat") == "user_annotation"}
        assert {f"strling.call.{p}" for p in PHASES} <= names


def test_one_process_stats(sample):
    bam_p, stats = sample[1], sample[4]
    assert set(stats["span_s"]) == set(CALL_PHASES)
    assert stats["span_s"]["setup"] > 0 and stats["span_s"]["collect"] > 0
    assert stats["collective_wait_s"] == 0.0
    assert stats["hist_records"] == sum(len(b) for b in Bam(bam_p).batches())
    assert stats["collect_records"] > 0
    assert 1 <= stats["called"] <= stats["work_items"]


@pytest.mark.parametrize("skip, take", [(0, 10), (100, 50), (10 ** 6, 10)])
def test_histogram_counts_the_records_it_decodes(sample, skip, take):
    """sio_frag_hist stops at the record that counts take + 1 fragments
    after the skip (utils.nim:103), else at the end of the BAM."""
    bam_p = sample[1]
    flag = np.concatenate([b.flag for b in Bam(bam_p).batches()]).astype(int)
    isize = np.concatenate([b.isize for b in Bam(bam_p).batches()])
    ok = (((flag & 0x2) != 0) & ((flag & 0x900) == 0) & (isize >= 0)
          & (isize < 4096))
    counted = np.flatnonzero(ok & (np.arange(len(flag)) >= skip))
    want = int(counted[take]) + 1 if len(counted) > take else len(flag)
    st = {}
    native_frag_hist(Bam(bam_p), skip, take, stats=st)
    assert st["records"] == want
