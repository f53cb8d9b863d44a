"""`call` — genotype provided loci and novel clusters (src/strpkg/call.nim)."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from strling_tpu_torch.core.callclusters import TreadGroups, assign_reads_locus, bounds_checked
from strling_tpu_torch.core.cluster import (
    BOUNDS_HEADER,
    Bounds,
    Cluster,
    cluster,
    parse_bed,
    parse_bounds,
)
from strling_tpu_torch.core.collect import spanners_many
from strling_tpu_torch.core.collect_batched import collect_many, collect_many_native
from strling_tpu_torch.core.genotyper import (
    GT_HEADER,
    Call,
    genotype,
    genotype_ls,
    update_genotype,
)
from strling_tpu_torch.io.bam import Bam
from strling_tpu_torch.io.binfmt import read_bin, same_targets
from strling_tpu_torch.ops.encode import canonical_repeat
from strling_tpu_torch.utils import fraglen
from strling_tpu_torch.utils.options import Options


def oe_ratio(c: Call) -> np.float32:
    """call.nim:32-35 (float32 arithmetic)."""
    obs = np.float32(c.spanning_pairs)
    exp = np.float32(c.expected_spanning_fragments)
    return np.float32((np.float32(1) + obs - exp) / (exp + np.float32(1)))


def add_percentile(genotypes_by_repeat: dict[str, list[Call]]):
    """call.nim:38-47: global O/E percentile rank across all calls."""
    oes = []
    for calls in genotypes_by_repeat.values():
        for c in calls:
            oes.append(oe_ratio(c))
    oes = np.sort(np.array(oes, np.float32))
    for calls in genotypes_by_repeat.values():
        for c in calls:
            lb = int(np.searchsorted(oes, oe_ratio(c), side="left"))
            # division by high == len-1 (call.nim:30); len==1 gives 0/0=nan
            with np.errstate(invalid="ignore", divide="ignore"):
                c.spanning_fragments_oe_percentile = np.float32(lb) / np.float32(
                    len(oes) - 1
                )


def run_call(bam_path: str, bin_path: str, fasta: str | None = None,
             min_support: int = 5, min_clip: int = 0, min_clip_total: int = 0,
             min_mapq: int = 40, loci: str | None = None,
             bounds_path: str | None = None, output_prefix: str = "strling",
             verbose: bool = False, debug: bool = False,
             stats: dict | None = None):
    """call_main (call.nim:50-303). `debug` also writes the per-read and
    per-span evidence files the reference emits in -d:debug builds
    (call.nim:148-157,257-261). The phases (`PHASES`: setup, replay,
    collect, genotype, oe_barrier, write) are `strling.call.<phase>` spans
    under a profiler; `stats`, when given, gets their seconds (`span_s`),
    the records the histogram and the collect decoded (`hist_records`,
    `collect_records`: the native collector's), the work items and the
    calls written (`work_items`, `called`)."""
    from strling_tpu_torch.utils.profiling import PhaseClock

    clock = PhaseClock(stats, "strling.call.", PHASES)
    try:
        _run_call(clock, bam_path, bin_path, fasta, min_support, min_clip,
                  min_clip_total, min_mapq, loci, bounds_path, output_prefix,
                  verbose, debug)
    finally:
        clock.switch(None)


#: the phases of run_call, in order (one process: no broadcast or gather)
PHASES = ("setup", "replay", "collect", "genotype", "oe_barrier", "write")


def _run_call(clock, bam_path, bin_path, fasta, min_support, min_clip,
              min_clip_total, min_mapq, loci, bounds_path, output_prefix,
              verbose, debug):
    st = clock.stats
    if loci and not os.path.exists(loci):
        raise SystemExit("couldn't open loci file")
    if bounds_path and not os.path.exists(bounds_path):
        raise SystemExit("couldn't open bounds file")

    clock.switch("setup")
    bam = Bam(bam_path, fasta=fasta)
    from strling_tpu_torch.io.extract_native import native_frag_hist

    hist_stats: dict = {}
    # byte-equal to the Python pass
    frag_dist = native_frag_hist(bam, stats=hist_stats)
    st["hist_records"] = hist_stats["records"]
    frag_median = fraglen.median(frag_dist)
    if verbose:
        print(f"Calculated median fragment length:{frag_median}", file=sys.stderr)

    opts = Options(
        median_fragment_length=frag_median, min_clip=min_clip,
        min_clip_total=min_clip_total, min_support=min_support,
        min_mapq=min_mapq, window=fraglen.median(frag_dist, 0.99),
        targets=bam.targets,
    )

    extracted = read_bin(bin_path)
    assert same_targets(extracted.targets, bam.targets)
    groups = TreadGroups.from_batch(extracted.reads)
    clock.switch("replay")  # the locus assignment, then the clustering

    gt_fh = open(output_prefix + "-genotype.txt", "w")
    bounds_fh = open(output_prefix + "-bounds.txt", "w")
    unplaced_fh = open(output_prefix + "-unplaced.txt", "w")
    bounds_fh.write(BOUNDS_HEADER + "\tdepth\n")
    gt_fh.write(GT_HEADER + "\n")

    reads_fh = span_fh = None
    if debug:
        reads_fh = open(output_prefix + "-reads.txt", "w")
        span_fh = open(output_prefix + "-spanning.txt", "w")
        reads_fh.write("#chrom\tpos\tstr\tsoft_clip\tstr_count\tqname\tcluster_id\n")

    def _debug_write(b, spans, str_reads, str_qnames, cluster_id):
        if not debug:
            return
        from strling_tpu_torch.core.tread import Soft

        chrom = opts.targets[b.tid].name
        for s in spans:
            span_fh.write(s.tostring(b, chrom) + "\n")
        for i in range(len(str_reads)):
            r = str_reads[i]
            rep = r["repeat"].decode()
            split = Soft(int(r["split"])).name
            qn = str_qnames[i] if str_qnames is not None else ""
            reads_fh.write(
                f"{'unknown' if r['tid'] == -1 else opts.targets[r['tid']].name}"
                f"\t{r['position']}\t{rep}\t{split}\t{r['repeat_count']}\t{qn}"
                f"\t{cluster_id}\n"
            )

    loci_list: list[Bounds] = []
    if loci:
        loci_list = parse_bed(loci, opts.targets, opts.window)
        print(f"Read {len(loci_list)} loci from {loci}", file=sys.stderr)

    bounds_list: list[Bounds] = []
    if bounds_path:
        bounds_list = parse_bounds(bounds_path, opts.targets)
        print(f"Read {len(bounds_list)} bounds from {bounds_path}", file=sys.stderr)

    # merge loci and bounds, loci overwriting overlapping bounds (call.nim:170-183)
    for bound in bounds_list:
        for i, locus in enumerate(loci_list):
            if locus.overlaps(bound):
                bound.name = locus.name
                bound.left = locus.left
                bound.right = locus.right
                del loci_list[i]
                break
    bounds_list.extend(loci_list)

    unplaced_counts: dict[str, int] = {}
    genotypes_by_repeat: dict[str, list[Call]] = {}

    # The debug evidence files need the full Support rows (percentiles,
    # per-row tostring), so --debug keeps the per-record spec collection;
    # the production path runs the vectorized batched twin
    # (collect_batched.py), equivalence-tested bit-for-bit.
    def _spans_for(work):
        bl = [w[0] for w in work]
        if debug:
            return spanners_many(bam, bl, opts.window, frag_dist,
                                 opts.min_mapq)
        got = collect_many_native(bam, bl, opts.window, frag_dist,
                                  opts.min_mapq)
        if got is not None:
            return got
        return collect_many(bam, bl, opts.window, frag_dist,
                            opts.min_mapq, with_rc=False)

    def _genotype_one(res, bound, str_reads, str_qnames):
        """Shared guard + genotype step; returns (gt, med_depth, spans|None)
        or None when a guard skips the locus (call.nim:225-231)."""
        if debug:
            spans, med_depth, expected = res
            if len(spans) > 5_000 or med_depth == -1:
                return None
            gt = genotype(bound, str_reads, str_qnames, spans, opts,
                          float(med_depth))
            gt.expected_spanning_fragments = expected
            return gt, med_depth, spans
        if res.n_support > 5_000 or res.med_depth == -1:
            return None
        gt = genotype_ls(bound, str_reads, str_qnames, res, opts,
                         float(res.med_depth))
        gt.expected_spanning_fragments = res.expected
        return gt, res.med_depth, None

    # PASS A — provided loci (call.nim:189-218). Locus bookkeeping first
    # (assign_reads_locus mutates the tread table in order), then ONE
    # streaming support-collection pass over merged locus windows
    # instead of a random-access BAM query per locus.
    work_a = []
    for bound in bounds_list:
        str_reads, str_qnames = assign_reads_locus(bound, groups)
        if bound.right - bound.left > 1000:
            print(f"large bounds:{bound} skipping", file=sys.stderr)
            continue
        work_a.append((bound, str_reads, str_qnames))
    clock.switch("collect")
    span_a = _spans_for(work_a)
    clock.switch("genotype")
    for i, (bound, str_reads, str_qnames) in enumerate(work_a):
        got = _genotype_one(span_a[i], bound, str_reads, str_qnames)
        if got is None:
            continue
        gt, med_depth, spans = got
        canon = canonical_repeat(bound.repeat)
        genotypes_by_repeat.setdefault(canon, []).append(gt)
        bounds_fh.write(bound.tostring(opts.targets) + "\t" + str(med_depth) + "\n")
        _debug_write(bound, spans, str_reads, str_qnames, bound.id(opts.targets))
    clock.switch("replay")

    # PASS B — novel clusters (call.nim:221-262): clustering consumes the
    # remaining treads (independent of support collection), then the same
    # batched streaming pass over the discovered bounds. Production runs the
    # segmented formulation (cluster_batched.py — segment ops over each
    # whole (tid, repeat) group); the scalar cluster()+bounds_checked path
    # is the executable spec (used by --debug, equivalence-tested).
    from strling_tpu_torch.core.cluster_batched import cluster_group_batched

    work_b = []
    max_clip_dist = int(0.5 * float(fraglen.median(frag_dist, 0.5)))
    for (tid, repeat), (treads, names) in groups.items():
        if len(treads) == 0:
            continue
        if debug:
            for c in cluster(treads, max_dist=opts.window,
                             min_supporting_reads=opts.min_support,
                             qnames=names):
                if c.reads["tid"][0] == -1:
                    unplaced_counts[c.reads["repeat"][0].decode()] = len(c.reads)
                    continue
                b, good = bounds_checked(c, min_clip, min_clip_total,
                                         max_clip_dist)
                if not good:
                    continue
                work_b.append((b, c))
            continue
        if treads["tid"][0] < 0:
            unplaced_counts[treads["repeat"][0].decode()] = len(treads)
            continue
        for b, rv, qv in cluster_group_batched(
            treads, opts.window, opts.min_support, min_clip, min_clip_total,
            max_clip_dist, names,
        ):
            work_b.append((b, Cluster(reads=rv, qnames=qv)))
    clock.switch("collect")
    span_b = _spans_for(work_b)
    clock.switch("genotype")
    ci = 0
    for i, (b, c) in enumerate(work_b):
        got = _genotype_one(span_b[i], b, c.reads, c.qnames)
        if got is None:
            continue
        gt, med_depth, spans = got
        canon = canonical_repeat(b.repeat)
        genotypes_by_repeat.setdefault(canon, []).append(gt)
        bounds_fh.write(b.tostring(opts.targets) + "\t" + str(med_depth) + "\n")
        _debug_write(b, spans, c.reads, c.qnames, ci)
        ci += 1
    st["work_items"] = len(work_a) + len(work_b)
    st["called"] = sum(len(v) for v in genotypes_by_repeat.values())
    st["collect_records"] = sum(getattr(x, "n_records", 0)
                                for x in (*span_a.values(), *span_b.values()))
    clock.switch("oe_barrier")
    add_percentile(genotypes_by_repeat)
    clock.switch("write")

    # unique-large-expansion refinement (call.nim:268-277; dead in practice —
    # see genotyper.genotype's is_large note) then write genotypes
    for repeat, genotypes in genotypes_by_repeat.items():
        gt_expanded = []
        for gt in genotypes:
            if gt.is_large:
                gt_expanded.append(gt)
                if len(gt_expanded) > 1:
                    break
        if len(gt_expanded) == 1:
            update_genotype(gt_expanded[0], unplaced_counts.get(repeat, 0))
        for gt in genotypes:
            gt_fh.write(gt.tostring() + "\n")

    for repeat, count in unplaced_counts.items():
        unplaced_fh.write(f"{repeat}\t{count}\n")

    gt_fh.close()
    bounds_fh.close()
    unplaced_fh.close()
    if debug:
        span_fh.close()
        reads_fh.close()
    if verbose:
        print(
            f"wrote genotypes to {output_prefix}-genotype.txt", file=sys.stderr
        )


def call_main(argv):
    p = argparse.ArgumentParser("strling call")
    p.add_argument("-f", "--fasta", default="", help="path to fasta file")
    p.add_argument("--profile", default="", help="write a torch.profiler trace to this directory")
    p.add_argument("-m", "--min-support", type=int, default=5)
    p.add_argument("-c", "--min-clip", type=int, default=0)
    p.add_argument("-t", "--min-clip-total", type=int, default=0)
    p.add_argument("-q", "--min-mapq", type=int, default=40)
    p.add_argument("-l", "--loci", default="")
    p.add_argument("-b", "--bounds", default="")
    p.add_argument("-o", "--output-prefix", default="strling")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="also write -reads.txt/-spanning.txt evidence files")
    p.add_argument("--distributed", action="store_true",
                   help="shard per-locus genotyping over torch.distributed "
                        "ranks (launch with torchrun); rank 0 writes "
                        "byte-identical outputs")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="with --distributed: this rank's device, where the "
                        "O/E percentile barrier sorts: cuda (default) or cpu")
    p.add_argument("bam")
    p.add_argument("bin")
    a = p.parse_args(argv)
    from strling_tpu_torch.utils.profiling import maybe_trace

    with maybe_trace(a.profile or None, "call"):
        _run_call_cli(a)


def _run_call_cli(a):
    if a.distributed:
        if a.debug:
            raise SystemExit(
                "--debug evidence files are not supported with "
                "--distributed; run single-process call for debugging")
        from strling_tpu_torch.parallel.call_dist import run_call_dist
        from strling_tpu_torch.parallel.mesh import init_distributed

        device = init_distributed(a.device)
        run_call_dist(a.bam, a.bin, a.fasta or None, a.min_support,
                      a.min_clip, a.min_clip_total, a.min_mapq,
                      a.loci or None, a.bounds or None, a.output_prefix,
                      a.verbose, device=device)
        return
    run_call(a.bam, a.bin, a.fasta or None, a.min_support, a.min_clip,
             a.min_clip_total, a.min_mapq, a.loci or None, a.bounds or None,
             a.output_prefix, a.verbose, a.debug)
