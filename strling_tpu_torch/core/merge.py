"""`merge` — joint locus discovery across samples (src/strpkg/merge.nim)."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from strling_tpu_torch.core.callclusters import TreadGroups, assign_reads_locus, bounds_checked
from strling_tpu_torch.core.cluster import BOUNDS_HEADER, Bounds, Cluster, cluster, parse_bed
from strling_tpu_torch.io.bam import Target
from strling_tpu_torch.io.binfmt import read_bin, same_targets
from strling_tpu_torch.io.fasta import Fasta
from strling_tpu_torch.utils import fraglen
from strling_tpu_torch.utils.options import Options


def has_per_sample_reads(c: Cluster, supporting_reads: int) -> bool:
    """merge.nim:18-25: >= supporting_reads from at least one sample (sample
    id carried in the qname slot)."""
    if len(c.qnames) == 0:
        return False
    _, counts = np.unique(np.asarray(c.qnames), return_counts=True)
    return int(counts.max()) >= supporting_reads


def fill_targets(fasta: str) -> list[Target]:
    """merge.nim:27-34."""
    fa = Fasta(fasta)
    return [
        Target(tid=i, name=name, length=fa.chrom_len(name))
        for i, name in enumerate(fa.names)
    ]


def get_tid_from_fasta(fasta: str, chromosome: str) -> int:
    """merge.nim:36-45."""
    targets = fill_targets(fasta)
    if not targets:
        raise ValueError(
            f"[strling merge] chromosome: {chromosome} specified, but no "
            "targets found in fasta. Specify a valid fasta file."
        )
    for t in targets:
        if t.name == chromosome:
            return t.tid
    raise ValueError(
        f"[strling merge] chromosome: {chromosome} not found in fasta, check "
        "name and 'chr' prefix"
    )


def run_merge(bins: list[str], fasta: str | None = None, window: int = -1,
              min_support: int = 5, chromosome: str | None = None,
              min_clip: int = 0, min_clip_total: int = 0, min_mapq: int = 40,
              bed: str | None = None, output_prefix: str = "strling",
              diff_refs: bool = False, verbose: bool = False):
    """merge_main (merge.nim:47-191)."""
    if bed and not os.path.exists(bed):
        raise SystemExit("couldn't open bed file")

    targets: list[Target] = []
    if fasta and diff_refs:
        targets = fill_targets(fasta)

    requested_tid = None
    if chromosome is not None:
        requested_tid = get_tid_from_fasta(fasta, chromosome)

    frag_dist = np.zeros(4096, np.uint64)
    all_rows = []
    all_samples = []

    for sample_i, binfile in enumerate(bins):
        if verbose:
            print(f"[strling] reading bin file: {binfile}", file=sys.stderr)
        # NOTE: the reference never passes targets here (merge.nim:101), so no
        # tid remapping happens even with --diff-refs
        ex = read_bin(
            binfile, drop_unplaced=True, verbose=verbose,
            requested_tid=requested_tid, skip_qnames=True,
        )
        if not targets:
            targets = ex.targets
        else:
            if not same_targets(ex.targets, targets) and not diff_refs:
                raise SystemExit(
                    f"[strling] Error: inconsistent bam header for {binfile}. "
                    "Were all samples run on the same reference genome?"
                )
        frag_dist = frag_dist + ex.fragment_distribution.astype(np.uint64)
        assert (frag_dist <= np.iinfo(np.uint32).max).all(), "overflow"
        # HACK preserved from merge.nim:118-124: sample id rides in the qname
        data = ex.reads.data.copy()
        data["sample"] = sample_i
        all_rows.append(data)
        all_samples.append(np.full(len(data), sample_i, np.int32))
        print(
            f"[strling] read {len(data)} STR reads from file: {binfile}",
            file=sys.stderr,
        )

    frag32 = frag_dist.astype(np.uint32)
    from strling_tpu_torch.core.tread import TREAD_DTYPE, TreadBatch

    data = np.concatenate(all_rows) if all_rows else np.zeros(0, TREAD_DTYPE)
    samples = np.concatenate(all_samples) if all_samples else np.zeros(0, np.int32)
    tb = TreadBatch(data=data, qnames=samples)
    groups = TreadGroups.from_batch(tb)

    ntr = sum(len(g[0]) for g in groups.groups.values())
    if verbose:
        print(f"[strling] read {ntr} STR reads across all samples.", file=sys.stderr)
        print(
            "[strling] Calculated median fragment length accross all samples:"
            f"{fraglen.median(frag32)}",
            file=sys.stderr,
        )

    opts = Options(
        median_fragment_length=fraglen.median(frag32, 0.98),
        min_support=min_support, min_mapq=min_mapq, targets=targets,
    )
    if window < 0:
        window = fraglen.median(frag32, 0.98)

    loci: list[Bounds] = []
    if bed:
        loci = parse_bed(bed, targets, window, tid=requested_tid)

    bounds_fh = open(output_prefix + "-bounds.txt", "w")
    bounds_fh.write(BOUNDS_HEADER + "\n")

    for locus in loci:
        assign_reads_locus(locus, groups)
        bounds_fh.write(locus.tostring(opts.targets) + "\n")

    # Canonical output order: bed loci first (bed order, above), then cluster
    # bounds sorted by (tid, left, repeat). The reference writes clusters in
    # Nim table-iteration order (merge.nim:171-187) — not a contract; sorting
    # makes single-process and --distributed merge byte-identical.
    cluster_lines: list[tuple[tuple, str]] = []
    for (tid, repeat), (treads, names) in groups.items():
        for c in cluster(treads, max_dist=window,
                         min_supporting_reads=opts.min_support, qnames=names):
            if c.reads["tid"][0] == -1:
                continue
            if not has_per_sample_reads(c, opts.min_support):
                continue
            max_clip_dist = int(0.5 * float(fraglen.median(frag32, 0.5)))
            b, good = bounds_checked(c, min_clip, min_clip_total, max_clip_dist)
            if not good:
                continue
            cluster_lines.append(((b.tid, b.left, b.repeat), b.tostring(targets)))
    for _, line in sorted(cluster_lines):
        bounds_fh.write(line + "\n")

    bounds_fh.close()
    if verbose:
        print(
            f"[strling] Wrote merged str bounds to {output_prefix}-bounds.txt",
            file=sys.stderr,
        )


def merge_main(argv):
    p = argparse.ArgumentParser("strling merge")
    p.add_argument("-f", "--fasta", default="")
    p.add_argument("-w", "--window", type=int, default=-1)
    p.add_argument("-m", "--min-support", type=int, default=5)
    p.add_argument("--chromosome", default="-2")
    p.add_argument("-c", "--min-clip", type=int, default=0)
    p.add_argument("-t", "--min-clip-total", type=int, default=0)
    p.add_argument("-q", "--min-mapq", type=int, default=40)
    p.add_argument("-l", "--bed", default="")
    p.add_argument("-o", "--output-prefix", default="strling")
    p.add_argument("-d", "--diff-refs", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--distributed", action="store_true",
                   help="shard locus space over torch.distributed ranks "
                        "(launch with torchrun; one rank alone without it)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="with --distributed: this rank's device, cuda "
                        "(default; NCCL or Gloo by the backend rule) or cpu "
                        "(Gloo)")
    p.add_argument("bin", nargs="+")
    a = p.parse_args(argv)
    if a.distributed:
        from strling_tpu_torch.parallel.merge_dist import run_merge_dist
        from strling_tpu_torch.parallel.mesh import init_distributed

        init_distributed(a.device)
        run_merge_dist(
            a.bin, a.fasta or None, a.window, a.min_support,
            None if a.chromosome == "-2" else a.chromosome, a.min_clip,
            a.min_clip_total, a.min_mapq, a.bed or None, a.output_prefix,
            a.verbose,
        )
        return
    run_merge(
        a.bin, a.fasta or None, a.window, a.min_support,
        None if a.chromosome == "-2" else a.chromosome, a.min_clip,
        a.min_clip_total, a.min_mapq, a.bed or None, a.output_prefix,
        a.diff_refs, a.verbose,
    )
