"""The golden flows of tests/test_golden.py run on the port alone: simulate,
extract (the port's native extract on the CPU), merge and call from
`strling_tpu_torch`, with the same seeds, simulation parameters and call and
merge arguments, must reproduce tests/golden/ byte for byte."""

import os

import numpy as np
import pytest
import torch

from strling_tpu_torch.core.call import run_call
from strling_tpu_torch.core.extract import extract_native
from strling_tpu_torch.core.merge import run_merge
from strling_tpu_torch.core.simulate import Allele, normal_hist, simulate_str_bam
from strling_tpu_torch.io import Bam, write_bin, write_fasta

from test_golden import LOCUS, _check

torch.set_num_threads(1)


def _extract(bam_path: str, bin_path: str):
    bam = Bam(bam_path)
    treads, frag_dist, _ = extract_native(bam, None, None,
                                          devices=[torch.device("cpu")])
    write_bin(bin_path, treads, frag_dist, bam.header_text, 0.8, 40)


def _run(tmp):
    """test_golden._run on the port."""
    rng = np.random.default_rng(1234)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40000)])
    seq = seq[:LOCUS] + "CAG" * 10 + seq[LOCUS:]
    write_fasta(os.path.join(tmp, "ref.fa"), {"chr1": seq})
    simulate_str_bam(
        os.path.join(tmp, "ref.fa"),
        [Allele("chr1", LOCUS, (0, 100), "CAG")],
        os.path.join(tmp, "g.bam"),
        normal_hist(400, 50), depth=30, flank=8000, seed=99,
    )
    _extract(os.path.join(tmp, "g.bam"), os.path.join(tmp, "g.bin"))
    prefix = os.path.join(tmp, "g")
    run_call(os.path.join(tmp, "g.bam"), os.path.join(tmp, "g.bin"),
             output_prefix=prefix)
    return {name: open(f"{prefix}-{name}").read()
            for name in ("genotype.txt", "bounds.txt", "unplaced.txt")}


def _samples(tmp, which=(0, 1, 2)):
    """test_golden._run_joint's simulated samples `which`, extracted."""
    rng = np.random.default_rng(77)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 60000)])
    seq = seq[:LOCUS] + "CAG" * 10 + seq[LOCUS:30000] + "AT" * 12 + seq[30000:]
    ref = os.path.join(tmp, "ref.fa")
    write_fasta(ref, {"chr1": seq})
    alleles_by_sample = [
        [Allele("chr1", LOCUS, (0, 80), "CAG")],
        [Allele("chr1", LOCUS, (10, 40), "CAG"),
         Allele("chr1", 30030, (0, 60), "AT")],
        [Allele("chr1", 30030, (30, 30), "AT")],
    ]
    bams, bins = {}, {}
    for s in which:
        alleles = alleles_by_sample[s]
        bam_path = os.path.join(tmp, f"s{s}.bam")
        simulate_str_bam(ref, alleles, bam_path, normal_hist(400, 50),
                         depth=24, flank=8000, seed=100 + s)
        binp = os.path.join(tmp, f"s{s}.bin")
        _extract(bam_path, binp)
        bams[s], bins[s] = bam_path, binp
    return ref, bams, bins


def _run_joint(tmp):
    """test_golden._run_joint without its --loci part: merge, then call
    --bounds per sample."""
    ref, bams, bins = _samples(tmp)
    joint = os.path.join(tmp, "joint")
    run_merge([bins[s] for s in range(3)], fasta=ref, output_prefix=joint)
    out = {"joint-bounds.txt": open(joint + "-bounds.txt").read()}
    for s in range(3):
        prefix = os.path.join(tmp, f"s{s}-joint")
        run_call(bams[s], bins[s], bounds_path=joint + "-bounds.txt",
                 output_prefix=prefix)
        out[f"s{s}-joint-genotype.txt"] = open(prefix + "-genotype.txt").read()
        out[f"s{s}-joint-bounds.txt"] = open(prefix + "-bounds.txt").read()
    return out


def _run_loci(tmp):
    """test_golden._run_joint's --loci part: sample 1 called on a provided
    bed over the two simulated loci."""
    _, bams, bins = _samples(tmp, which=(1,))
    loci_bed = os.path.join(tmp, "loci.bed")
    with open(loci_bed, "w") as fh:
        fh.write(f"chr1\t{LOCUS}\t{LOCUS + 30}\tCAG\tHTTish\n")
        fh.write("chr1\t30030\t30054\tAT\tATlocus\n")
    prefix = os.path.join(tmp, "s1-loci")
    run_call(bams[1], bins[1], loci=loci_bed, output_prefix=prefix)
    return {"s1-loci-genotype.txt": open(prefix + "-genotype.txt").read(),
            "s1-loci-bounds.txt": open(prefix + "-bounds.txt").read()}


@pytest.mark.parametrize("flow", [_run, _run_joint, _run_loci],
                         ids=["single", "joint", "loci"])
def test_port_reproduces_goldens(tmp_path, flow):
    outputs = flow(str(tmp_path))
    assert len(outputs) >= 2
    _check(outputs)
