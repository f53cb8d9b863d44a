"""Distributed joint locus discovery (multi-rank `merge`).

Port of `strling_tpu.parallel.merge_dist` onto torch.distributed. The
reference scales merge only by per-chromosome process fan-out over files
(merge.nim:52,89; pipelines/strling-joint-bychrom.groovy:12-19). Here:

- samples are read in parallel, one subset per rank (per-sample data
  parallelism);
- fragment-length histograms are combined with an all_reduce (the
  reference's element-wise sum at merge.nim:112-115);
- treads are packed into fixed-width int32 rows and resharded by
  (tid, repeat-unit) hash with all_to_all_single, so each rank owns a
  disjoint slice of locus space (the reference's `--chromosome` sharding,
  generalized); the exchange sends each row once, with per-destination
  split sizes, in rounds that move at most EXCHANGE_BUDGET_BYTES a rank;
- each rank clusters its shard (the greedy, order-dependent trcluster logic
  stays host-side, as in the reference);
- candidate bounds are gathered and written once, deterministically sorted.

Output is byte-identical to single-process `run_merge` including line
order: both paths write the canonical order (bed loci in bed order, then
cluster bounds sorted by (tid, left, repeat)).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from strling_tpu_torch.core.callclusters import TreadGroups, assign_reads_locus, bounds_checked
from strling_tpu_torch.core.cluster import BOUNDS_HEADER, Bounds, cluster, parse_bed
from strling_tpu_torch.core.merge import get_tid_from_fasta, has_per_sample_reads
from strling_tpu_torch.core.tread import TREAD_DTYPE, TreadBatch
from strling_tpu_torch.io.binfmt import read_bin, same_targets
from strling_tpu_torch.parallel.mesh import gather_blobs, group_device
from strling_tpu_torch.utils import fraglen
from strling_tpu_torch.utils.options import Options

PACK_W = 6  # int32 columns per packed tread


def pack_treads(data: np.ndarray) -> np.ndarray:
    """TREAD_DTYPE records -> [N, 6] int32 wire rows (field-exact)."""
    n = len(data)
    out = np.zeros((n, PACK_W), np.int32)
    out[:, 0] = data["tid"]
    out[:, 1] = np.ascontiguousarray(data["position"]).view(np.int32)
    rep = np.ascontiguousarray(data["repeat"]).view(np.uint8).reshape(n, 6).astype(np.uint32)
    out[:, 2] = (rep[:, 0] | (rep[:, 1] << 8) | (rep[:, 2] << 16)
                 | (rep[:, 3] << 24)).view(np.int32).astype(np.int32)
    out[:, 3] = (rep[:, 4] | (rep[:, 5] << 8)).astype(np.int32)
    out[:, 4] = np.ascontiguousarray(
        data["flag"].astype(np.uint32)
        | (data["split"].astype(np.uint32) << 16)
        | (data["mapping_quality"].astype(np.uint32) << 24)).view(np.int32)
    out[:, 5] = np.ascontiguousarray(
        data["repeat_count"].astype(np.uint32)
        | (data["align_length"].astype(np.uint32) << 8)
        | (data["sample"].astype(np.uint32) << 16)).view(np.int32)
    return out


def unpack_treads(rows: np.ndarray) -> np.ndarray:
    n = len(rows)
    data = np.zeros(n, TREAD_DTYPE)
    data["tid"] = rows[:, 0]
    data["position"] = rows[:, 1].view(np.uint32)
    rep = np.zeros((n, 6), np.uint8)
    c2 = rows[:, 2].view(np.uint32)
    c3 = rows[:, 3].view(np.uint32)
    rep[:, 0] = c2 & 0xFF
    rep[:, 1] = (c2 >> 8) & 0xFF
    rep[:, 2] = (c2 >> 16) & 0xFF
    rep[:, 3] = (c2 >> 24) & 0xFF
    rep[:, 4] = c3 & 0xFF
    rep[:, 5] = (c3 >> 8) & 0xFF
    data["repeat"] = rep.view("S6").reshape(n)
    c4 = rows[:, 4].view(np.uint32)
    data["flag"] = (c4 & 0xFFFF).astype(np.uint16)
    data["split"] = ((c4 >> 16) & 0xFF).astype(np.uint8)
    data["mapping_quality"] = ((c4 >> 24) & 0xFF).astype(np.uint8)
    c5 = rows[:, 5].view(np.uint32)
    data["repeat_count"] = (c5 & 0xFF).astype(np.uint8)
    data["align_length"] = ((c5 >> 8) & 0xFF).astype(np.uint8)
    data["sample"] = (c5 >> 16).astype(np.int32)
    return data


def shard_of(tid: np.ndarray, repeat: np.ndarray, n_shards: int) -> np.ndarray:
    """Deterministic (tid, repeat-unit) -> shard id (locus-space hash)."""
    rep = np.ascontiguousarray(repeat).view(np.uint8).reshape(len(repeat), 6).astype(np.uint64)
    h = tid.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    for i in range(6):
        h = (h ^ (rep[:, i] + np.uint64(1))) * np.uint64(0x100000001B3)
    return (h % np.uint64(n_shards)).astype(np.int64)


def _shard_key(tid: int, repeat: str, n_shards: int) -> int:
    rep = np.zeros(1, "S6")
    rep[0] = repeat.encode()
    return int(shard_of(np.array([tid], np.int32), rep, n_shards)[0])


#: the most bytes a rank sends in one exchange round. Rows go to their
#: destinations in rounds of at most C rows a (source, destination) pair, so
#: a skewed cohort (one dominant repeat unit hashing to one shard) never
#: stages more than this a round however the counts fall (the reference's
#: whole-cohort-in-RAM merge has the same worst case against its 120GB
#: budget, bpipe.config:16-18).
EXCHANGE_BUDGET_BYTES = 64 << 20


def exchange_rows(buckets: list[np.ndarray], counts: np.ndarray,
                  stats: dict | None = None) -> list[np.ndarray]:
    """all_to_all of int32 [n, PACK_W] row buckets: `buckets[d]` goes to
    rank d; `counts` is the [world, world] (source, destination) row count
    matrix, the same on every rank. Returns the rows received from each
    source, in source order, each source's rows in their sent order.
    Rounds move rows [r*C, (r+1)*C) of every bucket, C set by
    EXCHANGE_BUDGET_BYTES; no padding is sent."""
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = group_device()
    cmax = max(1, int(counts.max()))
    C = max(1, min(cmax, EXCHANGE_BUDGET_BYTES // max(1, world * PACK_W * 4)))
    n_rounds = (cmax + C - 1) // C
    got: list[list[np.ndarray]] = [[] for _ in range(world)]
    for rnd in range(n_rounds):
        lo = rnd * C
        parts = [b[lo:lo + C] for b in buckets]
        send = torch.from_numpy(
            np.concatenate(parts) if parts else np.zeros((0, PACK_W), np.int32)
        ).to(dev)
        in_splits = [len(p) for p in parts]
        out_splits = [int(min(max(0, counts[s, rank] - lo), C))
                      for s in range(world)]
        recv = torch.empty((sum(out_splits), PACK_W), dtype=torch.int32,
                           device=dev)
        dist.all_to_all_single(recv, send.contiguous(), out_splits, in_splits)
        recv = recv.cpu().numpy()
        off = 0
        for s, k in enumerate(out_splits):
            if k:
                got[s].append(recv[off:off + k])
            off += k
        if stats is not None:
            stats["rounds"] = stats.get("rounds", 0) + 1
            stats["sent_bytes"] = stats.get("sent_bytes", 0) + send.numel() * 4
            stats["max_round_bytes"] = max(stats.get("max_round_bytes", 0),
                                           send.numel() * 4)
    return [np.concatenate(g) if g else np.zeros((0, PACK_W), np.int32)
            for g in got]


def run_merge_dist(bins: list[str], fasta: str | None = None, window: int = -1,
                   min_support: int = 5, chromosome: str | None = None,
                   min_clip: int = 0, min_clip_total: int = 0,
                   min_mapq: int = 40, bed: str | None = None,
                   output_prefix: str = "strling", verbose: bool = False,
                   stats: dict | None = None):
    """Distributed merge_main. Every rank of the default group calls this
    with the full bin list; sample reading, clustering and output are
    partitioned internally. Returns the bounds lines (identical, sorted, on
    every rank); rank 0 writes them. `stats`, when given, receives the
    exchange's rounds, bytes sent and largest round."""
    rank = dist.get_rank()
    S = dist.get_world_size()
    dev = group_device()

    requested_tid = None
    if chromosome is not None:
        requested_tid = get_tid_from_fasta(fasta, chromosome)

    # --- per-rank sample reads (per-sample data parallelism) ----------------
    frag_local = np.zeros(4096, np.uint64)
    rows = []
    targets = None
    for sample_i, binfile in enumerate(bins):
        if sample_i % S != rank:
            continue
        ex = read_bin(binfile, drop_unplaced=True, verbose=verbose,
                      requested_tid=requested_tid, skip_qnames=True)
        if targets is None:
            targets = ex.targets
        elif not same_targets(ex.targets, targets):
            raise SystemExit(
                f"[strling] Error: inconsistent bam header for {binfile}. "
                "Were all samples run on the same reference genome?")
        frag_local += ex.fragment_distribution.astype(np.uint64)
        data = ex.reads.data.copy()
        data["sample"] = sample_i
        rows.append(data)
        if verbose:
            print(f"[strling r{rank}] read {len(data)} STR reads from {binfile}",
                  file=sys.stderr)
    if targets is None:  # more ranks than samples: still need the header
        targets = read_bin(bins[0], drop_unplaced=True).targets
    data = np.concatenate(rows) if rows else np.zeros(0, TREAD_DTYPE)

    # --- pack + route: shard = hash(tid, repeat-unit) % S -------------------
    packed = pack_treads(data)
    dest = shard_of(data["tid"], data["repeat"], S)
    # per-destination buckets (order preserved within a destination)
    order = np.argsort(dest, kind="stable")
    packed, dsorted = packed[order], dest[order]
    starts = np.searchsorted(dsorted, np.arange(S))
    ends = np.searchsorted(dsorted, np.arange(S) + 1)
    buckets = [packed[starts[s]:ends[s]] for s in range(S)]
    counts = torch.from_numpy((ends - starts).astype(np.int64)).to(dev)
    counts_all = [torch.zeros_like(counts) for _ in range(S)]
    dist.all_gather(counts_all, counts)
    counts_global = torch.stack(counts_all).cpu().numpy()  # [src, dst]

    frag = torch.from_numpy(frag_local.astype(np.int64)).to(dev)
    dist.all_reduce(frag)
    frag32 = frag.cpu().numpy().astype(np.uint32)

    got = np.concatenate(exchange_rows(buckets, counts_global, stats))

    # --- this rank's shard: host clustering ---------------------------------
    opts = Options(median_fragment_length=fraglen.median(frag32, 0.98),
                   min_support=min_support, min_mapq=min_mapq, targets=targets)
    if window < 0:
        window = fraglen.median(frag32, 0.98)
    max_clip_dist = int(0.5 * float(fraglen.median(frag32, 0.5)))

    loci: list[Bounds] = []
    if bed:
        loci = parse_bed(bed, targets, window, tid=requested_tid)

    local_bounds: list[tuple] = []  # (group, bed index, sort key, line)
    sdata = unpack_treads(got)
    tb = TreadBatch(data=sdata, qnames=sdata["sample"].copy())
    groups = TreadGroups.from_batch(tb)
    for li, locus in enumerate(loci):
        if _shard_key(locus.tid, locus.repeat, S) != rank:
            continue
        assign_reads_locus(locus, groups)
        local_bounds.append((0, li, "", locus.tostring(targets)))
    for (tid, repeat), (treads, names) in groups.items():
        for c in cluster(treads, max_dist=window,
                         min_supporting_reads=opts.min_support,
                         qnames=names):
            if c.reads["tid"][0] == -1:
                continue
            if not has_per_sample_reads(c, opts.min_support):
                continue
            b, good = bounds_checked(c, min_clip, min_clip_total,
                                     max_clip_dist)
            if not good:
                continue
            key = f"{b.tid:06d}\x01{b.left:012d}\x01{b.repeat}"
            local_bounds.append((1, 0, key, b.tostring(targets)))

    # --- gather bounds lines (tag-prefixed) to every rank, write once -------
    blob = "\x00".join(
        f"{grp}\x01{li:06d}\x01{key}\x02{line}"
        for grp, li, key, line in local_bounds
    ).encode()
    tagged: list[tuple[str, str]] = []
    for b in gather_blobs(blob):
        s = b.decode()
        if s:
            for item in s.split("\x00"):
                tag, line = item.split("\x02", 1)
                tagged.append((tag, line))
    # deterministic output: bed loci first (bed order), then sorted clusters
    out_lines = [line for _, line in sorted(tagged)]

    if rank == 0:
        with open(output_prefix + "-bounds.txt", "w") as fh:
            fh.write(BOUNDS_HEADER + "\n")
            for line in out_lines:
                fh.write(line + "\n")
        if verbose:
            print(f"[strling] Wrote merged str bounds to "
                  f"{output_prefix}-bounds.txt", file=sys.stderr)
    dist.barrier()  # the file exists on every rank's return
    return out_lines
