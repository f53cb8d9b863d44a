"""Distributed `call` — locus-space sharding of per-sample genotyping.

Port of `strling_tpu.parallel.call_dist` onto torch.distributed. The
reference `call` is single-threaded with two global barriers that need *all*
calls before output (SURVEY.md §3.2): the spanning O/E percentile ranking
(call.nim:29-47,264) and the unique-large-expansion unplaced refinement
(call.nim:268-277). Here:

- rank 0 alone computes the fragment-length histogram (a pass over the
  BAM) and reads the bin, and broadcasts both; the JAX package had every
  process redo that setup (fault F4). Every rank then replays the cheap,
  order-dependent locus bookkeeping identically — `assign_reads_locus`
  mutates the tread table (callclusters.nim:14-50) and clustering consumes
  what remains, so the enumeration of work items is identical on every
  rank;
- the expensive per-locus work (`spanners` BAM window queries + genotype,
  collect.nim:130-182) is round-robin sharded over ranks;
- the O/E percentile barrier runs on the devices: each rank's O/E ratios,
  padded into a fixed row, are gathered and ranked with a sort and a
  searchsorted on the rank's device (f32 semantics identical to
  core.call.add_percentile, NaN and inf ratios included);
- Call records are exchanged via a gather and re-assembled in the exact
  single-process order, so `-genotype.txt`, `-bounds.txt` and
  `-unplaced.txt` are byte-identical to `run_call`'s, including line order.

A pass runs in phases, each a `strling.call.<phase>` span under a profiler
(`call --distributed --profile`: one trace a rank) and its seconds in the
optional `stats` (`PHASES`); `stats` also counts the rank's shard, the
records its collect and its histogram decoded, the bytes it broadcast and
gathered, and its seconds blocked in collectives.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from strling_tpu_torch.core.call import oe_ratio
from strling_tpu_torch.core.callclusters import TreadGroups, assign_reads_locus
from strling_tpu_torch.core.cluster import BOUNDS_HEADER, Bounds, parse_bed, parse_bounds
from strling_tpu_torch.core.cluster_batched import cluster_group_batched
from strling_tpu_torch.core.collect_batched import collect_many, collect_many_native
from strling_tpu_torch.core.genotyper import GT_HEADER, genotype_ls, update_genotype
from strling_tpu_torch.core.tread import TreadBatch
from strling_tpu_torch.io.bam import Bam
from strling_tpu_torch.io.binfmt import read_bin, same_targets
from strling_tpu_torch.io.extract_native import native_frag_hist
from strling_tpu_torch.ops.encode import canonical_repeat
from strling_tpu_torch.parallel.mesh import broadcast_blob, gather_blobs, group_device
from strling_tpu_torch.utils import fraglen
from strling_tpu_torch.utils.options import Options
from strling_tpu_torch.utils.profiling import PhaseClock

#: the phases of a pass, in order: rank 0's histogram and bin read (and the
#: BAM's open on every rank), the broadcast of both, the replay of the locus
#: assignment and the clustering, this shard's collect and genotype, the O/E
#: barrier, the gather of the calls, rank 0's writes and the last barrier
PHASES = ("setup", "broadcast", "replay", "collect", "genotype",
          "oe_barrier", "gather", "write")


def rank_oes_on_mesh(oes: np.ndarray, device: torch.device,
                     blocked=contextlib.nullcontext) -> np.ndarray:
    """Global O/E percentiles of this rank's f32 ratios among every rank's.

    The row width (the longest rank's count, at least 1) is agreed with an
    all_reduce; each rank's row, padded with +inf, is gathered on the
    group's device and the counts summed. On `device`: sort the gathered
    ratios, rank = searchsorted(sorted, v, left), pct = f32(rank) /
    f32(n_total - 1) — exactly core.call.add_percentile (call.nim:38-47);
    n_total == 1 gives 0/0 = nan. numpy sorts NaN last, so a NaN ratio's
    rank is the number of non-NaN ratios; it is counted, not searched.
    `blocked` is entered around the collectives."""
    gdev = group_device()
    oes = np.asarray(oes, np.float32)
    world = dist.get_world_size()
    with blocked():
        n_max = torch.tensor([max(1, len(oes))], dtype=torch.int64,
                             device=gdev)
        dist.all_reduce(n_max, op=dist.ReduceOp.MAX)
        width = int(n_max.item())
    row = np.full(width, np.inf, np.float32)
    row[:len(oes)] = oes
    mine = torch.from_numpy(row).to(gdev)
    gathered = torch.empty(world * len(row), dtype=torch.float32, device=gdev)
    with blocked():
        dist.all_gather(list(gathered.chunk(world)), mine)
        count = torch.tensor([len(oes)], dtype=torch.int64, device=gdev)
        dist.all_reduce(count)
        n_total = int(count.item())
    allv = gathered.to(device)
    v = mine.to(device)[:len(oes)]
    nan = torch.isnan(allv)
    # NaN ratios sort as +inf here: no ratio is < +inf either way, and the
    # card's sort and searchsorted then never see a NaN
    s = torch.sort(torch.where(nan, torch.inf, allv)).values
    lb = torch.searchsorted(s, torch.where(torch.isnan(v), 0.0, v),
                            side="left")
    lb = torch.where(torch.isnan(v), n_total - nan.sum(), lb)
    pct = lb.to(torch.float32) / torch.tensor(n_total - 1, dtype=torch.float32,
                                              device=device)
    return pct.cpu().numpy()


def run_call_dist(bam_path: str, bin_path: str, fasta: str | None = None,
                  min_support: int = 5, min_clip: int = 0,
                  min_clip_total: int = 0, min_mapq: int = 40,
                  loci: str | None = None, bounds_path: str | None = None,
                  output_prefix: str = "strling", verbose: bool = False,
                  device: torch.device | None = None,
                  stats: dict | None = None):
    """Distributed call_main (call.nim:50-303). Every rank of the default
    group calls this with the same arguments and its own `device` (where
    the O/E barrier sorts; default: the group's device); per-locus
    spanners/genotype work is sharded, the two global barriers run as
    collectives, and rank 0 writes files that are byte-identical to
    single-process `run_call`'s. Returns the genotype lines (identical on
    every rank).

    `stats`, when given, is filled with this rank's counters of the pass:
    `span_s` (seconds in each of `PHASES`), `collective_wait_s` (blocked in
    broadcast, all_reduce, all_gather and barrier), `shard_loci` (work
    items in its shard), `work_items` and `called` (all ranks' work items,
    and the calls written), `collect_records` (records its collect's
    queries decoded), `hist_records` (records the histogram decoded: rank 0
    only), `broadcast_bytes`, `gathered_bytes`, `rank` and `world`."""
    clock = PhaseClock(stats, "strling.call.", PHASES)
    try:
        return _run_call_dist(clock, bam_path, bin_path, fasta, min_support,
                              min_clip, min_clip_total, min_mapq, loci,
                              bounds_path, output_prefix, verbose, device)
    finally:
        clock.switch(None)


def _run_call_dist(clock, bam_path, bin_path, fasta, min_support, min_clip,
                   min_clip_total, min_mapq, loci, bounds_path,
                   output_prefix, verbose, device):
    rank = dist.get_rank()
    world = dist.get_world_size()
    device = device or group_device()
    st = clock.stats
    st.update(rank=rank, world=world, hist_records=0)

    if loci and not os.path.exists(loci):
        raise SystemExit("couldn't open loci file")
    if bounds_path and not os.path.exists(bounds_path):
        raise SystemExit("couldn't open bounds file")

    clock.switch("setup")
    bam = Bam(bam_path, fasta=fasta)
    setup = None
    if rank == 0:
        extracted = read_bin(bin_path)
        assert same_targets(extracted.targets, bam.targets)
        hist_stats: dict = {}
        setup = pickle.dumps((native_frag_hist(bam, stats=hist_stats),
                              extracted.reads.data, extracted.reads.qnames),
                             protocol=pickle.HIGHEST_PROTOCOL)
        st["hist_records"] = hist_stats["records"]
    clock.switch("broadcast")
    with clock.blocked():
        blob = broadcast_blob(setup)
    st["broadcast_bytes"] = len(blob)
    frag_dist, data, qnames = pickle.loads(blob)
    del blob, setup
    clock.switch("replay")
    frag_median = fraglen.median(frag_dist)
    opts = Options(
        median_fragment_length=frag_median, min_clip=min_clip,
        min_clip_total=min_clip_total, min_support=min_support,
        min_mapq=min_mapq, window=fraglen.median(frag_dist, 0.99),
        targets=bam.targets,
    )
    groups = TreadGroups.from_batch(TreadBatch(data=data, qnames=qnames))

    loci_list: list[Bounds] = []
    if loci:
        loci_list = parse_bed(loci, opts.targets, opts.window)
        if rank == 0:
            print(f"Read {len(loci_list)} loci from {loci}", file=sys.stderr)
    bounds_list: list[Bounds] = []
    if bounds_path:
        bounds_list = parse_bounds(bounds_path, opts.targets)
        if rank == 0:
            print(f"Read {len(bounds_list)} bounds from {bounds_path}",
                  file=sys.stderr)
    for bound in bounds_list:
        for i, locus in enumerate(loci_list):
            if locus.overlaps(bound):
                bound.name = locus.name
                bound.left = locus.left
                bound.right = locus.right
                del loci_list[i]
                break
    bounds_list.extend(loci_list)

    # --- enumerate work items identically everywhere; shard the heavy part --
    unplaced_counts: dict[str, int] = {}
    my_calls: list[tuple[int, object, str, str]] = []
    work_i = 0

    def mine() -> bool:
        return work_i % world == rank

    # PASS A — provided loci (call.nim:189-218). assign_reads_locus mutates
    # `groups`, so every rank must replay every locus in order; only the
    # heavy support collection + genotype is sharded (and batched: one
    # native collect over this rank's share of loci).
    my_work: list[tuple[int, Bounds, np.ndarray, object]] = []
    for bound in bounds_list:
        str_reads, str_qnames = assign_reads_locus(bound, groups)
        if bound.right - bound.left > 1000:
            if rank == 0:
                print(f"large bounds:{bound} skipping", file=sys.stderr)
            continue
        wi = work_i
        work_i += 1
        if mine():
            my_work.append((wi, bound, str_reads, str_qnames))

    # PASS B — novel clusters (call.nim:221-262). The segmented clustering
    # (cluster_batched) is deterministic and replayed everywhere; the
    # per-locus collection is sharded.
    max_clip_dist = int(0.5 * float(fraglen.median(frag_dist, 0.5)))
    for (tid, repeat), (treads, names) in groups.items():
        if len(treads) == 0:
            continue
        if treads["tid"][0] < 0:
            unplaced_counts[treads["repeat"][0].decode()] = len(treads)
            continue
        for b, rv, qv in cluster_group_batched(
            treads, opts.window, opts.min_support, min_clip, min_clip_total,
            max_clip_dist, names,
        ):
            wi = work_i
            work_i += 1
            if mine():
                my_work.append((wi, b, rv, qv))

    st["work_items"] = work_i
    st["shard_loci"] = len(my_work)

    # batched support collection over this shard's loci, then genotype
    clock.switch("collect")
    my_bounds = [w[1] for w in my_work]
    ls_map = collect_many_native(bam, my_bounds, opts.window, frag_dist,
                                 opts.min_mapq)
    if ls_map is None:
        ls_map = collect_many(bam, my_bounds, opts.window, frag_dist,
                              opts.min_mapq, with_rc=False)
    st["collect_records"] = sum(ls.n_records for ls in ls_map.values())
    clock.switch("genotype")
    for j, (wi, b, rv, qv) in enumerate(my_work):
        ls = ls_map[j]
        if ls.n_support > 5_000 or ls.med_depth == -1:
            continue
        gt = genotype_ls(b, rv, qv, ls, opts, float(ls.med_depth))
        gt.expected_spanning_fragments = ls.expected
        my_calls.append((wi, gt, b.tostring(opts.targets) + "\t" +
                         str(ls.med_depth), canonical_repeat(b.repeat)))

    # --- barrier 1: global O/E percentile on the devices (call.nim:264) -----
    clock.switch("oe_barrier")
    pct = rank_oes_on_mesh(
        np.array([oe_ratio(it[1]) for it in my_calls], np.float32), device,
        clock.blocked)
    for r, it in enumerate(my_calls):
        it[1].spanning_fragments_oe_percentile = np.float32(pct[r])

    # --- gather Call records; rebuild the single-process order --------------
    clock.switch("gather")
    blob = pickle.dumps(my_calls, protocol=pickle.HIGHEST_PROTOCOL)
    with clock.blocked():
        blobs = gather_blobs(blob)
    st["gathered_bytes"] = sum(len(b) for b in blobs)
    all_items: list[tuple[int, object, str, str]] = []
    for b in blobs:
        all_items.extend(pickle.loads(b))
    del blobs
    all_items.sort(key=lambda t: t[0])
    st["called"] = len(all_items)

    # genotypes_by_repeat insertion order == call order (canon first seen)
    genotypes_by_repeat: dict[str, list] = {}
    bounds_lines = []
    for _, gt, bline, canon in all_items:
        genotypes_by_repeat.setdefault(canon, []).append(gt)
        bounds_lines.append(bline)

    # --- barrier 2: unique-large-expansion refinement (call.nim:268-277) ----
    # unplaced_counts were computed identically on every rank (clustering
    # is replayed), so no exchange is needed.
    gt_lines = []
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
            gt_lines.append(gt.tostring())

    clock.switch("write")
    if rank == 0:
        with open(output_prefix + "-genotype.txt", "w") as fh:
            fh.write(GT_HEADER + "\n")
            for line in gt_lines:
                fh.write(line + "\n")
        with open(output_prefix + "-bounds.txt", "w") as fh:
            fh.write(BOUNDS_HEADER + "\tdepth\n")
            for line in bounds_lines:
                fh.write(line + "\n")
        with open(output_prefix + "-unplaced.txt", "w") as fh:
            for repeat, count in unplaced_counts.items():
                fh.write(f"{repeat}\t{count}\n")
        if verbose:
            print(f"wrote genotypes to {output_prefix}-genotype.txt",
                  file=sys.stderr)
    with clock.blocked():
        dist.barrier()  # the files exist on every rank's return
    return gt_lines
