"""The plain reference of `call` against the port on the tiny call
deployment: its three files equal the one-process `run_call`'s byte for
byte, and `run_call_dist`'s at two Gloo ranks; the catalog's expanded loci
are called alike on both sides, and so is the unique-large-expansion
refinement, which call.nim's `is_large` never reaches."""

import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench.reference import call_ref
from portbench.tests._tiny import REPO
from portbench.tests._tiny_call import SEED, make_inputs

torch.set_num_threads(1)
FILES = ("genotype", "bounds", "unplaced")

RANK = """
import json, sys
sys.modules["jax"] = None
sys.modules["strling_tpu"] = None
import torch
torch.set_num_threads(1)
from strling_tpu_torch.parallel.call_dist import run_call_dist
from strling_tpu_torch.parallel.mesh import init_distributed
rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
a = json.loads(sys.argv[4])
dev = init_distributed("cpu", init_method="file://" + init, rank=rank,
                       world_size=world)
run_call_dist(a["bam"], a["bin"], a["fasta"], loci=a["catalog"],
              output_prefix=a["prefix"], device=dev)
"""


@pytest.fixture(scope="module", params=[(SEED, 10), (SEED + 77, 20)],
            ids=["10x", "20x"])
def case(request, tmp_path_factory):
    seed, cov = request.param
    d = tmp_path_factory.mktemp(f"callref{cov}")
    m = make_inputs(str(d / "in"), seed, cov)
    ref = call_ref.reference_call(m["bam"], m["bin"], m["catalog"])
    return d, m, ref


def _files(prefix):
    out = {}
    for k in FILES:
        with open(f"{prefix}-{k}.txt") as fh:
            out[k] = fh.read()
    return out


def test_reference_equals_one_process_call(case):
    from strling_tpu_torch.core.call import run_call

    d, m, ref = case
    run_call(m["bam"], m["bin"], m["fasta"], loci=m["catalog"],
             output_prefix=str(d / "one"))
    got = _files(str(d / "one"))
    assert {k: got[k] for k in FILES} == {k: ref[k] for k in FILES}
    assert call_ref.compare_call(got, ref) == {
        f"{k}_lines_wrong": 0 for k in FILES}
    # the 50 loci of the catalog, and novel clusters besides
    assert ref["calls"] > 50 and len(ref["genotype"].splitlines()) > 50


def test_reference_equals_two_gloo_ranks(case):
    d, m, ref = case
    script = d / "rank.py"
    script.write_text(textwrap.dedent(RANK))
    args = json.dumps({"bam": m["bam"], "bin": m["bin"], "fasta": m["fasta"],
                       "catalog": m["catalog"], "prefix": str(d / "two")})
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2",
                               str(d / "init"), args], cwd=REPO, env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for e in errs]
    got = _files(str(d / "two"))
    assert {k: got[k] for k in FILES} == {k: ref[k] for k in FILES}


def test_expanded_loci_are_called_and_the_refinement_agrees(case):
    """The four expanded disease loci of the catalog come out of call with
    their summed repeat counts far above the reference's alleles, on both
    sides; call.nim's `is_large` reads allele 2 before it is set, so the
    refinement runs over every unit and changes no call; set by hand, it
    computes what the port's `update_genotype` does."""
    from strling_tpu_torch.core.genotyper import Call, update_genotype

    _, m, ref = case
    names = ("SCA10_ATXN10", "FTDALS1_C9orf72", "CANVAS_RFC1", "FRDA_FXN")
    with open(m["catalog"]) as fh:
        rows = {p[4]: p for p in (line.split() for line in fh) if len(p) == 5}
    lines = {tuple(x.split("\t")[:3]): x.split("\t")
             for x in ref["genotype"].splitlines()[1:]}
    for name in names:
        chrom, left, right, unit = rows[name][:4]
        got = lines[(chrom, left, right)]
        assert got[3] == unit
        # anchored and overlapping repeat units, far above the reference's
        assert int(got[15]) > 3 * (int(right) - int(left)) // len(unit)
        assert float(got[5]) > (int(right) - int(left)) / len(unit)
        assert got[13] == "0"       # no refinement: unplaced_pairs 0
    for unplaced, depth in ((40, 31.0), (2, 12.0), (400, 7.0)):
        c = call_ref.Call("chr22", call_ref.Locus(21, 10, 80, "ATTCT"), depth)
        c.allele2 = 5.0
        call_ref._refine(c, unplaced)
        p = Call(chrom="chr22", start=10, stop=80, repeat="ATTCT",
                 depth=depth, allele2=5.0)
        update_genotype(p, unplaced)
        assert (c.unplaced, c.allele2) == (p.unplaced_reads, p.allele2)
        assert unplaced <= 2 or c.allele2 > 5.0
    assert not math.isnan(float(lines[tuple(rows[names[0]][:3])][14]))


def test_the_inputs_hold_the_reference_of_their_bam(case, monkeypatch):
    """The generator's reference files, computed from the records it
    decoded for the sample's bin, equal the reference's call over the BAM
    decoded anew; the entry reads them while the reference's sources are
    those they were made under, and not once these change."""
    from portbench.entries import call as entry
    from portbench.gen import call_inputs

    _, m, ref = case
    stored = entry.stored_reference(m)
    assert stored is not None and stored["calls"] == ref["calls"]
    assert {k: stored[k] for k in FILES} == {k: ref[k] for k in FILES}
    monkeypatch.setattr(call_inputs, "reference_source", lambda: "changed")
    assert entry.stored_reference(m) is None
