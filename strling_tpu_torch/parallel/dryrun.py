"""Multi-rank dryrun of the parallel layer, run by every rank of a group.

Counterpart of the JAX package's `__graft_entry__.dryrun_multichip`: every
collective path of the port on tiny shapes, each checked, ending in the
production chain (extract -> run_merge_dist -> run_call_dist, for the
`--bounds` and `--loci` flows) byte-identical to tests/golden/.

    torchrun --nproc-per-node N -m strling_tpu_torch.parallel.dryrun [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from strling_tpu_torch.ops.kmer import _host_thresholds

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
GOLDEN = os.path.join(ROOT, "tests", "golden")


def example_inputs(B: int = 64, L: int = 96, seed: int = 0):
    """A batch for the sharded step (numpy): random reads, a CAG repeat in
    every fourth and an AT run in every eighth from the second, every fifth
    read cut to 60 bases, insert sizes outside the histogram's range on
    both sides and 30% of the pairs not counted."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (B, L))]
    for i in range(0, B, 4):
        bases[i] = np.frombuffer((b"CAG" * (L // 3 + 1))[:L], np.uint8)
    bases[1::8, :30] = np.frombuffer(b"AT" * 15, np.uint8)
    lengths = np.full(B, L, np.int32)
    lengths[2::5] = 60
    te, tp = _host_thresholds(lengths, np.full(B, 0.8))
    isize = rng.integers(-50, 5000, B).astype(np.int32)
    frag_valid = rng.random(B) < 0.7
    return bases, lengths, te, tp, isize, frag_valid


def sharded_step_on_rank(device, B: int = 64, L: int = 96, seed: int = 0):
    """This rank's outputs of the sharded extract step over a mesh of the
    whole group ("data" x "locus" at 4 ranks or more), on its slice of
    `example_inputs(B, L, seed)`, as numpy arrays."""
    from strling_tpu_torch.parallel.extract_sharded import make_sharded_extract_step
    from strling_tpu_torch.parallel.mesh import make_mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    step = make_sharded_extract_step(make_mesh(locus_axis=world >= 4))
    n = B // world
    local = [torch.from_numpy(np.ascontiguousarray(a[rank * n:(rank + 1) * n]))
             .to(device) for a in example_inputs(B, L, seed)]
    return [t.cpu().numpy() for t in step(*local)]


def _check_sharded_step(device):
    """The step over the group's mesh against the kernel on the rank's rows
    and against the same step at a world of one (the whole batch, no
    mesh) on the rank's device."""
    from strling_tpu_torch.ops.kmer import codes_to_ascii
    from strling_tpu_torch.ops.kmer_cuda import repeat_scan
    from strling_tpu_torch.parallel.extract_sharded import extract_step_local

    world, rank = dist.get_world_size(), dist.get_rank()
    B = 8 * max(8, world)
    unit, ulen, count, frag, uhist, n_str = sharded_step_on_rank(device, B)
    inputs = example_inputs(B)
    bases, lengths, te, tp, isize, valid = inputs
    n = B // world
    rows = slice(rank * n, (rank + 1) * n)
    x, *named = (torch.from_numpy(np.ascontiguousarray(a[rows])).to(device)
                 for a in (bases, lengths, te, tp))
    code, wl, wc = (t.cpu().numpy() for t in repeat_scan(x, "ascii", *named))
    assert np.array_equal(ulen, wl) and np.array_equal(count, wc)
    assert np.array_equal(unit, codes_to_ascii(code, wl))
    assert int(count.max()) > 0  # the planted repeats were found
    # the histograms are the whole batch's (insert sizes clip to 0..4095)
    assert int(frag.sum()) == int(valid.sum())
    assert int(frag[4095]) >= int((valid & (isize > 4095)).sum())
    assert int(uhist.sum()) == int(n_str.sum()) > 0
    one = [t.cpu().numpy() for t in extract_step_local(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in inputs))]
    for got, want in zip((unit, ulen, count), one):
        assert np.array_equal(got, want[rows])
    assert np.array_equal(frag, one[3]) and np.array_equal(uhist, one[4])
    # n_str: one count a locus shard ("locus" dim), the batch's in all
    assert int(n_str.sum()) == int(one[5].sum())


def _check_exchange():
    """The merge's all_reduce of fragment histograms and its chunked
    all_to_all (rows of rank s for rank d carry (s, d, i)): every rank
    receives the transpose of the (source, destination) blocks."""
    import strling_tpu_torch.parallel.merge_dist as MD
    from strling_tpu_torch.parallel.mesh import group_device

    world, rank = dist.get_world_size(), dist.get_rank()
    frag = torch.zeros(4096, dtype=torch.int64, device=group_device())
    frag[300] = 7
    dist.all_reduce(frag)
    assert int(frag[300]) == 7 * world
    cmax = 4
    counts = np.array([[(s + d) % cmax + 1 for d in range(world)]
                       for s in range(world)])
    buckets = [np.array([[rank, d, i, 0, 0, 0] for i in range(counts[rank, d])],
                        np.int32) for d in range(world)]
    budget = MD.EXCHANGE_BUDGET_BYTES
    MD.EXCHANGE_BUDGET_BYTES = 2 * world * MD.PACK_W * 4  # rounds of 2 rows
    try:
        stats = {}
        got = MD.exchange_rows(buckets, counts, stats)
    finally:
        MD.EXCHANGE_BUDGET_BYTES = budget
    assert stats["rounds"] == 2
    for s in range(world):
        want = [[s, rank, i, 0, 0, 0] for i in range(counts[s, rank])]
        assert got[s].tolist() == want, (s, got[s])


def _check_oe_barrier(device):
    """The call's O/E percentile barrier against the host math (ragged
    rows, a NaN and an inf among them)."""
    from strling_tpu_torch.parallel.call_dist import rank_oes_on_mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    rng = np.random.default_rng(7)
    rows = [rng.uniform(0.0, 3.0, 3 + s).astype(np.float32)
            for s in range(world)]
    rows[0][1], rows[-1][0] = np.nan, np.inf
    pct = rank_oes_on_mesh(rows[rank], device)
    allv = np.sort(np.concatenate(rows))
    want = (np.searchsorted(allv, rows[rank], side="left").astype(np.float32)
            / np.float32(len(allv) - 1))
    assert pct.tobytes() == want.tobytes(), (pct, want)


def _check_device_forms(device):
    from strling_tpu_torch.core.cluster_batched import segment_group
    from strling_tpu_torch.ops.cluster_torch import segment_ids
    from strling_tpu_torch.ops.genotyper_torch import genotype_model_batch

    rng = np.random.default_rng(7)
    pos = np.sort(rng.integers(0, 100_000, 300)).astype(np.int64)
    ids = segment_ids(pos, 500, device)
    want = np.empty(len(pos), np.int32)
    for k, (a, b) in enumerate(segment_group(pos, 500)):
        want[a:b] = k
    assert np.array_equal(ids, want)
    a2 = genotype_model_batch(np.array([0, 100, 500]),
                              np.array([30.0, 30.0, 10.0]),
                              np.array([3, 3, 3]), device)
    assert np.isnan(a2[0]) and a2[2] > a2[1] > 0


def check_round_robin(device, many, path: str):
    """The engine's round robin of scan batches over the devices `many`, in
    batches of 8 scan rows (a batch or more a device), on a BAM written to
    `path`, against extract_native on `device` alone; on cards, every card
    of `many` must launch the kernel."""
    from strling_tpu_torch.core.extract import extract_native
    from strling_tpu_torch.io import Bam, BamRecord, write_bam
    from strling_tpu_torch.io.extract_native import NativeExtractor
    from strling_tpu_torch.ops import kmer_cuda

    rng = np.random.default_rng(5)
    alpha = np.array(list("ACGT"))
    recs = []
    for i in range(160):
        pos = 1000 + i * 53
        s1 = "".join(alpha[rng.integers(0, 4, 100)])
        s2 = ("CAG" * 34)[:100] if i % 2 == 0 else "".join(
            alpha[rng.integers(0, 4, 100)])
        mq2 = 0 if i % 2 == 0 else 60
        recs.append(BamRecord(f"p{i}", 97, 0, pos, 60, "100M", 0, pos + 200,
                              300, s1))
        recs.append(BamRecord(f"p{i}", 145, 0, pos + 200, mq2, "100M", 0, pos,
                              -300, s2))
    recs.sort(key=lambda r: r.pos)
    write_bam(path, "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:100000\n",
              [("chr1", 100000)], recs)
    tb1, _, opts = extract_native(Bam(path), None, None, devices=[device])
    before = kmer_cuda.launches_by_device.copy()
    ne = NativeExtractor(Bam(path), 0.8, 40, opts.median_fragment_length,
                         rows_per_batch=8)
    tbn = ne.run(many)
    if device.type == "cuda":
        idle = [d for d in many
                if kmer_cuda.launches_by_device[d.index] <= before[d.index]]
        assert not idle, f"no scan batch launched on {idle}"
    t1 = [(t.tid, t.position, t.repeat, t.flag, t.qname) for t in tb1.to_treads()]
    tn = [(t.tid, t.position, t.repeat, t.flag, t.qname) for t in tbn.to_treads()]
    assert t1 == tn and len(t1) > 0


def _check_extract_devices(device, work) -> int:
    """check_round_robin over every local device of the rank's kind (two
    turns of the CPU on cpu). Returns the number of devices."""
    from strling_tpu_torch.core.extract import scan_devices

    many = (scan_devices("cuda", "all") if device.type == "cuda"
            else [device, device])
    check_round_robin(device, many, os.path.join(
        work, f"devices_r{dist.get_rank()}.bam"))
    return len(many)


def _golden_chain(device, work, golden):
    """tests/test_golden.py's three-sample cohort: rank 0 simulates and
    extracts on its device; every rank runs run_merge_dist and
    run_call_dist (--bounds for each sample, --loci for sample 1); rank 0
    holds each file to the golden one."""
    from strling_tpu_torch.core.extract import extract_native
    from strling_tpu_torch.core.simulate import Allele, normal_hist, simulate_str_bam
    from strling_tpu_torch.io import Bam, write_bin, write_fasta
    from strling_tpu_torch.parallel.call_dist import run_call_dist
    from strling_tpu_torch.parallel.merge_dist import run_merge_dist

    rank = dist.get_rank()
    locus = 20000
    ref = os.path.join(work, "ref.fa")
    bins = [os.path.join(work, f"s{s}.bin") for s in range(3)]
    bams = [os.path.join(work, f"s{s}.bam") for s in range(3)]
    if rank == 0:
        rng = np.random.default_rng(77)
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 60000)])
        seq = (seq[:locus] + "CAG" * 10 + seq[locus:30000] + "AT" * 12
               + seq[30000:])
        write_fasta(ref, {"chr1": seq})
        alleles_by_sample = [
            [Allele("chr1", locus, (0, 80), "CAG")],
            [Allele("chr1", locus, (10, 40), "CAG"),
             Allele("chr1", 30030, (0, 60), "AT")],
            [Allele("chr1", 30030, (30, 30), "AT")],
        ]
        for s, alleles in enumerate(alleles_by_sample):
            simulate_str_bam(ref, alleles, bams[s], normal_hist(400, 50),
                             depth=24, flank=8000, seed=100 + s)
            bam = Bam(bams[s])
            treads, frag_dist, _ = extract_native(bam, None, None,
                                                  devices=[device])
            write_bin(bins[s], treads, frag_dist, bam.header_text, 0.8, 40)
    dist.barrier()
    outputs = {}
    joint = os.path.join(work, "joint")
    run_merge_dist(bins, fasta=ref, output_prefix=joint)
    outputs[joint + "-bounds.txt"] = "joint-bounds.txt"
    for s in range(3):
        prefix = os.path.join(work, f"s{s}-joint")
        run_call_dist(bams[s], bins[s], bounds_path=joint + "-bounds.txt",
                      output_prefix=prefix, device=device)
        outputs[prefix + "-genotype.txt"] = f"s{s}-joint-genotype.txt"
        outputs[prefix + "-bounds.txt"] = f"s{s}-joint-bounds.txt"
    loci_bed = os.path.join(work, "loci.bed")
    if rank == 0:
        with open(loci_bed, "w") as fh:
            fh.write(f"chr1\t{locus}\t{locus + 30}\tCAG\tHTTish\n")
            fh.write("chr1\t30030\t30054\tAT\tATlocus\n")
    dist.barrier()
    prefix = os.path.join(work, "s1-loci")
    run_call_dist(bams[1], bins[1], loci=loci_bed, output_prefix=prefix,
                  device=device)
    outputs[prefix + "-genotype.txt"] = "s1-loci-genotype.txt"
    outputs[prefix + "-bounds.txt"] = "s1-loci-bounds.txt"
    if rank == 0:
        for path, name in outputs.items():
            with open(path) as got, open(os.path.join(golden, name)) as want:
                if got.read() != want.read():
                    raise AssertionError(f"{name} diverged from the golden "
                                         "file in the distributed chain")
    return "byte-identical" if rank == 0 else "checked by rank 0"


def dryrun_multichip(device, golden: str = GOLDEN) -> dict:
    """Run every check on this rank of the default group (all ranks call
    it); raises on the first difference. Returns {world, rank, backend,
    wall_s, launches (the rank's kernel launches), launches_by_device (by
    card index), extract_devices (the devices the round robin used),
    golden_chain}."""
    from strling_tpu_torch.ops import kmer_cuda
    from strling_tpu_torch.parallel.mesh import broadcast_blob

    t0 = time.perf_counter()
    device = torch.device(device)
    before = kmer_cuda.launches
    by_device = kmer_cuda.launches_by_device.copy()
    _check_sharded_step(device)
    _check_exchange()
    _check_oe_barrier(device)
    _check_device_forms(device)
    rank = dist.get_rank()
    work = broadcast_blob(tempfile.mkdtemp(prefix="strling_dryrun_").encode()
                          if rank == 0 else None).decode()
    try:
        n_devices = _check_extract_devices(device, work)
        chain = _golden_chain(device, work, golden)
        dist.barrier()
    finally:
        if rank == 0:
            shutil.rmtree(work, ignore_errors=True)
    by_device = kmer_cuda.launches_by_device - by_device
    return {"world": dist.get_world_size(), "rank": rank,
            "backend": dist.get_backend(), "wall_s": time.perf_counter() - t0,
            "launches": kmer_cuda.launches - before,
            "launches_by_device": {str(k): v for k, v in
                                   sorted(by_device.items())},
            "extract_devices": n_devices, "golden_chain": chain}


def main(argv=None):
    from strling_tpu_torch.parallel.mesh import init_distributed

    p = argparse.ArgumentParser("strling_tpu_torch.parallel.dryrun")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    print(json.dumps(dryrun_multichip(init_distributed(a.device))))


if __name__ == "__main__":
    main()
