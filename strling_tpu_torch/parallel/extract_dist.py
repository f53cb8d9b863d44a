"""Distributed `extract`: shard one sample's read stream over ranks.

Port of `strling_tpu.parallel.extract_dist` onto torch.distributed. The
reference parallelizes extract only per SAMPLE (one bpipe task per BAM,
pipelines/strling-joint.groovy:8-13). Here each rank owns a subset of
chromosomes (tid % world == rank, mirroring merge's --chromosome sharding,
merge.nim:89,125; the no-coordinate block goes to rank 0), runs the native
engine with the scan on its device over its shard, and resolves the only
coupling between shards — read pairs whose mates map to different
chromosomes — with one gather of "spilled" treads followed by a
deterministic cross-shard pairing pass that replays the reference's mate
logic (extract.nim:192-248) on every rank identically.

Output equivalence vs single-process extract: BYTE-IDENTICAL bins. Every
tread carries the (segment, record tid, record rank, push slot) key of the
record whose processing emitted it (extract_engine.cc Tread key fields);
sequential extract appends treads exactly in that key order, so a stable
sort of the gathered shard treads (cross-shard pairs keyed by their later
mate) reproduces the single-process bin, including order.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from strling_tpu_torch.core.extract import adjust_by, unplaced_pair
from strling_tpu_torch.core.genome_index import genome_repeats
from strling_tpu_torch.core.tread import TREAD_DTYPE, Tread, TreadBatch
from strling_tpu_torch.io.bam import Bam
from strling_tpu_torch.io.extract_native import NativeExtractor, native_frag_hist
from strling_tpu_torch.ops.encode import canonical_repeat
from strling_tpu_torch.parallel.mesh import broadcast_blob, gather_blobs, rank_device
from strling_tpu_torch.utils import fraglen
from strling_tpu_torch.utils.options import Options

ROW_BYTES = TREAD_DTYPE.itemsize


KEY_DTYPE = np.dtype([("seg", np.uint8), ("ktid", np.int32),
                      ("krank", np.int64), ("ksub", np.uint8)])


def _keys_struct(keys) -> np.ndarray:
    seg, ktid, krank, ksub = keys
    out = np.zeros(len(seg), KEY_DTYPE)
    out["seg"] = seg
    out["ktid"] = ktid
    out["krank"] = krank
    out["ksub"] = ksub
    return out


def _pack_batch(tb: TreadBatch, keys: np.ndarray) -> bytes:
    """(TreadBatch, keys) -> bytes blob (fixed rows + keys + qnames)."""
    rows = np.ascontiguousarray(tb.data).tobytes()
    kb = np.ascontiguousarray(keys).tobytes()
    qn = "\x00".join(tb.qnames).encode()
    head = np.array([len(tb.data), len(qn)], np.int64).tobytes()
    return head + rows + kb + qn


def _unpack_batch(blob: bytes) -> tuple[TreadBatch, np.ndarray]:
    n, qlen = np.frombuffer(blob[:16], np.int64)
    n, qlen = int(n), int(qlen)
    rows = np.frombuffer(
        blob[16:16 + n * ROW_BYTES], TREAD_DTYPE
    ).copy()
    koff = 16 + n * ROW_BYTES
    keys = np.frombuffer(blob[koff:koff + n * KEY_DTYPE.itemsize],
                         KEY_DTYPE).copy()
    qblob = blob[koff + n * KEY_DTYPE.itemsize:
                 koff + n * KEY_DTYPE.itemsize + qlen]
    qnames = qblob.decode().split("\x00") if n else []
    return TreadBatch(data=rows, qnames=qnames), keys


def pair_spills(spills: list[tuple[TreadBatch, np.ndarray]],
                opts: Options) -> tuple[list[Tread], np.ndarray]:
    """Deterministic cross-shard mate pairing (the reference's pairing
    sequence, extract.nim:199-231, applied to the spilled treads; qnames
    processed in sorted order on every rank identically). Returns the
    emitted treads plus their emission keys: the later mate's record key
    with push slots 2/3, exactly as the sequential feed assigns them."""
    groups: dict[str, list[tuple[Tread, np.void]]] = {}
    for tb, keys in spills:
        for i, t in enumerate(tb.to_treads()):
            groups.setdefault(t.qname, []).append((t, keys[i]))
    out: list[Tread] = []
    out_keys: list[tuple] = []
    for qname in sorted(groups):
        g = groups[qname]
        if len(g) != 2:
            if len(g) > 2:
                print(
                    "[strling] warning. bad read (this happens with bwa-kit "
                    f"alignments):{qname} already in table",
                    file=sys.stderr,
                )
            continue
        (a, ka), (b, kb) = g
        # the "after mate" side is the one later in stream order (its
        # emission-key is larger); cross-shard pairs always differ in tid
        later_a = (int(ka["seg"]), int(ka["ktid"]), int(ka["krank"])) > (
            int(kb["seg"]), int(kb["ktid"]), int(kb["krank"]))
        (tr, kt), (mate, km) = ((a, ka), (b, kb)) if later_a else ((b, kb), (a, ka))
        ek = (int(kt["seg"]), int(kt["ktid"]), int(kt["krank"]))
        if mate.repeat_count == 0 and tr.repeat_count == 0:
            continue
        if unplaced_pair(tr, mate, opts):
            if tr.repeat == "" or mate.repeat == "":
                continue
            tr.repeat = canonical_repeat(tr.repeat)
            tr.position = 0
            tr.tid = -1
            mate.repeat = canonical_repeat(mate.repeat)
            mate.position = 0
            mate.tid = -1
            out.append(tr)
            out_keys.append(ek + (2,))
            out.append(mate)
            out_keys.append(ek + (3,))
            continue
        mp = mate.position
        if adjust_by(mate, tr, opts, tr.position):
            out.append(mate)
            out_keys.append(ek + (2,))
        if adjust_by(tr, mate, opts, mp):
            out.append(tr)
            out_keys.append(ek + (3,))
    karr = np.zeros(len(out_keys), KEY_DTYPE)
    for i, (s, t, r, u) in enumerate(out_keys):
        karr[i] = (s, t, r, u)
    return out, karr


def run_extract_dist(bam_path: str, fasta: str | None = None,
                     genome_repeats_path: str | None = None,
                     proportion_repeat: float = 0.8, min_mapq: int = 40,
                     output_bin: str | None = None, verbose: bool = False,
                     device: torch.device | None = None,
                     stats: dict | None = None):
    """Distributed extract_main. Every rank of the default group calls this
    with the same arguments and its own `device` (default: the rank's own,
    `parallel.mesh.rank_device()` of the kind the group was started with);
    the read stream is sharded by chromosome internally. Returns (TreadBatch,
    frag_dist, opts) of the COMBINED result on every rank; rank 0 writes the
    bin if output_bin is given.

    Rank 0 computes the fragment-length histogram (and the longest read it
    saw) and broadcasts it; with a FASTA, rank 0 builds the genome index
    first, so that a missing `genome_repeats_path` is written once. `stats`,
    when given, receives this rank's wall seconds and their split (`open_s`
    the BAM's open, `hist_s` rank 0's histogram pass and its broadcast, which
    the other ranks wait out, `index_s` the genome index, `scan_s` the
    engine's run over the shard, `gather_s` the gathers, the pairing of the
    spills and the sort, `write_s` the bin and the closing barrier), tread
    and spill counts and the bytes the gathers brought in."""
    if device is None:
        device = rank_device()
    t0 = time.perf_counter()
    rank = dist.get_rank()
    world = dist.get_world_size()

    bam = Bam(bam_path, fasta=fasta)
    t_open = time.perf_counter()
    hist = None
    if rank == 0:
        frag, max_len = native_frag_hist(bam, return_max_len=True)
        hist = frag.tobytes() + np.int64(max_len).tobytes()
    hist = broadcast_blob(hist)
    frag_dist = np.frombuffer(hist[:-8], np.uint32).copy()
    max_read_len = int(np.frombuffer(hist[-8:], np.int64)[0])
    frag_median = fraglen.median(frag_dist)
    opts = Options(
        median_fragment_length=frag_median,
        proportion_repeat=proportion_repeat,
        min_mapq=min_mapq,
    )
    t_hist = time.perf_counter()
    genome_index = None
    if fasta:
        def build():
            return genome_repeats(fasta, opts, genome_repeats_path or "",
                                  device)

        if rank == 0:
            genome_index = build()
        dist.barrier()  # a missing bed file is written once, by rank 0
        if rank != 0:
            genome_index = build()

    t_index = time.perf_counter()
    my_tids = [t.tid for t in bam.targets if t.tid % world == rank]
    Lcap = max(32, ((max_read_len + 7) // 8) * 8) if max_read_len else None
    ne = NativeExtractor(
        bam, proportion_repeat, min_mapq, frag_median,
        genome_index=genome_index, Lmax=Lcap,
    )
    ne.set_shard(my_tids, include_unplaced=(rank == 0))
    if verbose:
        print(f"[strling r{rank}] extracting tids {my_tids}", file=sys.stderr)
    tb_local = ne.run([device])
    keys_local = _keys_struct(ne.emission_keys(0))
    sp_local = ne.spill()
    sp_keys = _keys_struct(ne.emission_keys(1))
    t_scan = time.perf_counter()

    spill_blobs = gather_blobs(_pack_batch(sp_local, sp_keys))
    spills = [_unpack_batch(b) for b in spill_blobs]
    extra, extra_keys = pair_spills(spills, opts)

    local_blobs = gather_blobs(_pack_batch(tb_local, keys_local))
    parts = [_unpack_batch(b) for b in local_blobs]
    all_data = np.concatenate(
        [p.data for p, _ in parts]
        + [TreadBatch.from_treads(extra).data]
    )
    all_keys = np.concatenate([k for _, k in parts] + [extra_keys])
    all_qnames: list[str] = []
    for p, _ in parts:
        all_qnames.extend(p.qnames)
    all_qnames.extend(t.qname for t in extra)
    # stable sort by emission key == the sequential append order, so the
    # sharded bin is byte-identical to single-process extract's
    order = np.lexsort((all_keys["ksub"], all_keys["krank"],
                        all_keys["ktid"], all_keys["seg"]))
    tb = TreadBatch(data=all_data[order],
                    qnames=[all_qnames[i] for i in order])
    t_gather = time.perf_counter()

    if output_bin and rank == 0:
        from strling_tpu_torch.io.binfmt import write_bin

        write_bin(output_bin, tb, frag_dist, bam.header_text,
                  proportion_repeat, min_mapq)
        if verbose:
            print(f"[strling] wrote {output_bin} ({len(tb)} treads)",
                  file=sys.stderr)
    dist.barrier()  # the bin exists on every rank's return
    if stats is not None:
        t_end = time.perf_counter()
        stats.update(
            wall_s=t_end - t0, open_s=t_open - t0, hist_s=t_hist - t_open,
            index_s=t_index - t_hist, scan_s=t_scan - t_index,
            gather_s=t_gather - t_scan, write_s=t_end - t_gather, tids=my_tids,
            treads_local=len(tb_local), spills_local=len(sp_local),
            spills_total=sum(len(s) for s, _ in spills),
            gathered_bytes=sum(len(b) for b in spill_blobs + local_blobs),
            treads=len(tb))
    return tb, frag_dist, opts
