"""Fault F10: under `call --distributed --profile DIR` every rank wrote the
same `DIR/call.pt.trace.json`, so one trace survived. The trace is now
named by rank (`DIR/<label>.rank<r>.pt.trace.json`) when a group of more
than one rank is up or RANK is set; a single process keeps its name."""

import os

import numpy as np
import pytest
import torch

from strling_tpu.core.call import run_call as ref_run_call
from strling_tpu.core.extract import extract as ref_extract
from strling_tpu.core.simulate import Allele, normal_hist, simulate_str_bam
from strling_tpu.io.bam import Bam as RefBam
from strling_tpu.io.binfmt import write_bin as ref_write_bin
from strling_tpu.io.fasta import write_fasta
from strling_tpu_torch.utils import profiling

from test_torch_parallel import _files, spawn_ranks

torch.set_num_threads(1)
LOCUS = 12000


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("f10")
    rng = np.random.default_rng(10)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 24000)])
    seq = seq[:LOCUS] + "CAG" * 10 + seq[LOCUS:]
    write_fasta(str(d / "ref.fa"), {"chr1": seq})
    bam_p = str(d / "s.bam")
    simulate_str_bam(str(d / "ref.fa"), [Allele("chr1", LOCUS, (0, 110), "CAG")],
                     bam_p, normal_hist(400, 50), depth=20, flank=4000, seed=3)
    bam = RefBam(bam_p)
    treads, frag, _ = ref_extract(bam, None, None)
    bin_p = str(d / "s.bin")
    ref_write_bin(bin_p, treads, frag, bam.header_text, 0.8, 40)
    ref_run_call(bam_p, bin_p, output_prefix=str(d / "ref"))
    return d, bam_p, bin_p


PROFILED_CALL = """
from strling_tpu_torch.cli import main
main(["call", "--distributed", "--device", "cpu", "--profile", args["dir"],
      "-o", args["prefix"], args["bam"], args["bin"]])
print(json.dumps({"rank": rank}))
"""


def test_two_ranks_write_a_trace_each(sample, tmp_path):
    d, bam_p, bin_p = sample
    trace = tmp_path / "trace"
    prefix = str(tmp_path / "dist")
    outs = spawn_ranks(tmp_path, PROFILED_CALL, 2, {
        "dir": str(trace), "prefix": prefix, "bam": bam_p, "bin": bin_p})
    assert sorted(o["rank"] for o in outs) == [0, 1]
    assert sorted(os.listdir(trace)) == ["call.rank0.pt.trace.json",
                                         "call.rank1.pt.trace.json"]
    for name in os.listdir(trace):
        assert os.path.getsize(trace / name) > 0
    assert _files(prefix) == _files(str(d / "ref"))


def test_trace_name_single_process_and_rank_env(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    assert profiling.trace_name("call") == "call.pt.trace.json"
    monkeypatch.setenv("RANK", "3")
    assert profiling.trace_name("extract") == "extract.rank3.pt.trace.json"
