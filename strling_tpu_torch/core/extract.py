"""`extract`, with the repeat-unit scan on torch devices.

Port of `strling_tpu.core.extract`: the native path (`extract_native`,
`run_once_exact`: the C++ engine streams, packs and pairs the reads) and the
spec path (`extract`, `Extractor`: the reference's per-batch state machine in
Python, extract.nim:192-248, the mate logic that the distributed extract's
cross-shard pairing replays). Either scans on the given devices (`cpu` runs
the plain PyTorch form, `cuda` the CUDA kernel). Bins are byte-identical to
the JAX package's.

Spec path, per ReadBatch:
  phase A (device): one scan covering
    - every primary read that misses the reference-STR fast path
      (extract.nim:29-34: exact-match CIGAR over non-STR reference -> skip)
    - every soft-clip sub-read, evaluated under BOTH proportion-repeat
      variants the reference uses (min(p,0.6) for the mate-joined read,
      p-0.07 for the first-seen read, extract.nim:206-211,241-243)
  phase B (host): the order-sensitive mate-cache state machine
    (extract.nim:192-248) — pairing, add_soft gating, unplaced_pair
    canonicalization, adjust_by position correction — appending treads in
    exactly the reference's output order so bin files match byte-for-byte.

The trailing no-coor block is processed twice (once by the sequential scan,
once via query("*")) exactly like the reference (extract.nim:308,326).
A read whose repeat count is 256 or more (a homopolymer of 256+ bases: the
kernel's count is exact, F2) stops the spec path at `assert count < 256`,
where the reference's spec path stops too (extract.nim's own assert).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from strling_tpu_torch.core.genome_index import GenomeIndex, genome_repeats
from strling_tpu_torch.core.tread import (
    FLAG_MATE_REVERSE,
    FLAG_PROPER_PAIR,
    FLAG_REVERSE,
    FLAG_SECONDARY,
    FLAG_SUPPLEMENTARY,
    Soft,
    Tread,
    TreadBatch,
)
from strling_tpu_torch.io import Bam
from strling_tpu_torch.io.extract_native import NativeExtractor, peek_max_len
from strling_tpu_torch.ops.encode import canonical_repeat, min_rev_complement
from strling_tpu_torch.ops.kmer import get_repeat_batch, units_to_strings
from strling_tpu_torch.utils import fraglen
from strling_tpu_torch.utils.options import Options


def scan_devices(device: str = "cuda", devices: str | None = None):
    """The torch devices to scan on. `device` is "cpu" or "cuda"; with cuda,
    `devices` is "all" or a count of local cards (default one). Raises if
    cuda is asked for and no card is present: nothing falls back to the
    CPU."""
    if device == "cpu":
        if devices:
            raise ValueError("--devices applies to --device cuda")
        return [torch.device("cpu")]
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch scan)")
    n = torch.cuda.device_count()
    if devices == "all":
        count = n
    elif devices:
        count = int(devices)
        if not 1 <= count <= n:
            raise ValueError(f"--devices {devices}: {n} CUDA devices present")
    else:
        count = 1
    return [torch.device("cuda", i) for i in range(count)]


U32 = 1 << 32


def _u32(x: int) -> int:
    return x % U32


def should_reverse(flag: int) -> bool:
    """extract.nim:134-139: flip when reverse == mate_reverse."""
    return bool(flag & FLAG_REVERSE) == bool(flag & FLAG_MATE_REVERSE)


def unplaced_pair(a: Tread, b: Tread, opts: Options) -> bool:
    """extract.nim:182-190."""
    if a.p_repeat > opts.proportion_repeat and b.p_repeat > opts.proportion_repeat:
        return True
    if a.p_repeat > opts.proportion_repeat and b.mapping_quality < opts.min_mapq:
        return True
    if b.p_repeat > opts.proportion_repeat and a.mapping_quality < opts.min_mapq:
        return True
    return False


def adjust_by(a: Tread, b: Tread, opts: Options, b_position: int) -> bool:
    """extract.nim:141-179 — possibly move A's position using its mate B.

    Mutates `a`; returns whether A should be kept.
    """
    if a.repeat_count == 0:
        return False
    if b.mapping_quality > opts.min_mapq and (
        (a.p_repeat > opts.proportion_repeat and b.p_repeat < 0.2)
        or (not (a.flag & FLAG_PROPER_PAIR) and a.mapping_quality < opts.min_mapq)
    ):
        half = int(a.align_length / 2.0 + 0.5)
        if b.flag & FLAG_REVERSE:
            a.position = _u32(
                b_position - opts.median_fragment_length + b.align_length + half
            )
            # if B was soft-clipped on the left, assume it was because of the
            # repeat and set A's position exactly (extract.nim:157-160)
            if b.split == Soft.none_left:
                a.position = b_position
        else:
            a.position = _u32(b_position + opts.median_fragment_length - half)
            if b.split == Soft.none_right:
                a.position = _u32(b_position + b.align_length)
        a.split = Soft.none
        a.tid = b.tid
        a.mapping_quality = max(a.mapping_quality, b.mapping_quality)
        if should_reverse(a.flag):
            a.repeat = min_rev_complement(a.repeat)
    elif a.mapping_quality >= opts.min_mapq or (a.flag & FLAG_PROPER_PAIR):
        a.position = _u32(a.position + int(a.align_length / 2.0 + 0.5))
        a.mapping_quality = max(a.mapping_quality, b.mapping_quality)
    return True


@dataclass
class _ClipRes:
    unit_after: str
    count_after: int
    unit_first: str
    count_first: int


class Cache:
    """extract.nim:89-91: first-of-pair treads keyed by qname + output list."""

    def __init__(self):
        self.tbl: dict[str, Tread] = {}
        self.out: list[Tread] = []


class Extractor:
    """The spec extract's per-batch state machine (extract.nim:192-248) with
    the repeat scan on `device` (default: the first CUDA card): the
    hand-written kernel's ASCII entry on a card, the plain form on cpu."""

    def __init__(self, opts: Options, genome_index: GenomeIndex | None,
                 targets, Lmax: int = 256, device_chunk: int = 4096,
                 device: torch.device | None = None):
        self.device = device or scan_devices()[0]
        self.opts = opts
        self.gi = genome_index
        self.targets = targets
        self.Lmax = Lmax
        self.device_chunk = device_chunk
        self.cache = Cache()
        self.nreads = 0

    # ---------------------------------------------------------------- phase A

    def _detect(self, bases: np.ndarray, lengths: np.ndarray, props: np.ndarray):
        """Chunked kernel invocation with fixed shapes (pad to device_chunk)."""
        B = len(lengths)
        units: list[str] = []
        counts = np.zeros(B, np.int64)
        for s in range(0, B, self.device_chunk):
            e = min(B, s + self.device_chunk)
            n = e - s
            cb = np.zeros((self.device_chunk, self.Lmax), np.uint8)
            cl = np.zeros(self.device_chunk, np.int32)
            cp = np.full(self.device_chunk, 0.8, np.float64)
            cb[:n] = bases[s:e]
            cl[:n] = lengths[s:e]
            cp[:n] = props[s:e]
            u, ul, c = get_repeat_batch(cb, cl, cp, self.device)
            units.extend(units_to_strings(u[:n], ul[:n]))
            counts[s:e] = c[:n]
        return units, counts

    def process_batch(self, batch) -> None:
        flag = batch.flag.astype(np.int64)
        keep = (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
        n = len(batch)

        # cigar summary columns
        ncig = (batch.cigar_off[1:] - batch.cigar_off[:-1]).astype(np.int64)
        first_op = np.zeros(n, np.int64)
        first_len = np.zeros(n, np.int64)
        has_cig = ncig > 0
        fo = batch.cigar[batch.cigar_off[:-1][has_cig]]
        first_op[has_cig] = fo & 0xF
        first_len[has_cig] = fo >> 4

        # reference-STR fast path (extract.nim:29-34)
        exact = keep & (ncig == 1) & (first_op == 0)
        fast = np.zeros(n, bool)
        if self.gi is not None:
            for tid in np.unique(batch.tid[exact]):
                if tid < 0:
                    continue
                chrom = self.targets[tid].name
                if chrom not in self.gi:
                    continue
                m = exact & (batch.tid == tid)
                ov = self.gi.overlaps(
                    chrom, batch.pos[m].astype(np.int64),
                    batch.end_pos[m].astype(np.int64),
                )
                idx = np.nonzero(m)[0]
                fast[idx[~ov]] = True

        # device rows: primary reads needing a scan
        need_scan = keep & ~fast
        scan_idx = np.nonzero(need_scan)[0]
        L = self.Lmax
        lens_all = np.minimum(batch.read_len, L).astype(np.int32)

        # soft-clip rows (2 proportion variants each)
        clip_rows = []  # (read_index, side, sub_len)
        mq_ok = batch.mapq >= self.opts.min_mapq
        for side, clip_len in (("l", batch.lclip), ("r", batch.rclip)):
            cand = keep & mq_ok & (clip_len >= 2)
            for i in np.nonzero(cand)[0]:
                clip_rows.append((int(i), side, int(min(clip_len[i], L))))

        n_scan = len(scan_idx)
        n_clip = len(clip_rows)
        total_rows = n_scan + 2 * n_clip
        units: list[str] = []
        counts = np.zeros(0, np.int64)
        if total_rows:
            bases = np.zeros((total_rows, L), np.uint8)
            lengths = np.zeros(total_rows, np.int32)
            props = np.zeros(total_rows, np.float64)
            bases[:n_scan] = batch.seq[scan_idx]
            lengths[:n_scan] = lens_all[scan_idx]
            props[:n_scan] = self.opts.proportion_repeat
            pr = self.opts.proportion_repeat
            for j, (i, side, slen) in enumerate(clip_rows):
                rl = int(lens_all[i])
                sub = (
                    batch.seq[i, :slen]
                    if side == "l"
                    else batch.seq[i, rl - slen : rl]
                )
                r0 = n_scan + 2 * j
                bases[r0, :slen] = sub
                bases[r0 + 1, :slen] = sub
                lengths[r0] = lengths[r0 + 1] = slen
                props[r0] = min(pr, 0.6)     # after-mate variant
                props[r0 + 1] = pr - 0.07    # first-seen variant
            units, counts = self._detect(bases, lengths, props)

        scan_map = {int(ix): k for k, ix in enumerate(scan_idx)}
        clip_map: dict[tuple[int, str], _ClipRes] = {}
        for j, (i, side, slen) in enumerate(clip_rows):
            r0 = n_scan + 2 * j
            clip_map[(i, side)] = _ClipRes(
                unit_after=units[r0], count_after=int(counts[r0]),
                unit_first=units[r0 + 1], count_first=int(counts[r0 + 1]),
            )

        # ---------------------------------------------------------- phase B
        qnames = batch.qnames()
        tbl = self.cache.tbl
        out = self.cache.out
        opts = self.opts
        for i in range(n):
            if not keep[i]:
                continue
            self.nreads += 1
            qname = qnames[i]
            tid = int(batch.tid[i])
            pos = int(batch.pos[i])
            f = int(batch.flag[i])

            # to_tread (extract.nim:63-87)
            if fast[i]:
                unit, count = "", 0
                align_length = int(first_len[i])
            else:
                k = scan_map[i]
                unit, count = units[k], int(counts[k])
                align_length = int(lens_all[i])
            assert count < 256
            tr = Tread(
                tid=tid, position=max(0, pos), repeat=unit, flag=f,
                split=Soft.none, mapping_quality=int(batch.mapq[i]),
                repeat_count=count, align_length=align_length & 0xFF,
                qname=qname,
            )
            if ncig[i] > 1:
                if batch.lclip[i] > 16:
                    tr.split = Soft.none_left
                if batch.rclip[i] > 16:
                    tr.split = Soft.none_right

            after_mate = int(batch.tid[i]) > int(batch.mate_tid[i]) or (
                batch.tid[i] == batch.mate_tid[i]
                and (
                    pos > int(batch.mate_pos[i])
                    or (pos == int(batch.mate_pos[i]) and qname in tbl)
                )
            )

            if after_mate:
                mate = tbl.pop(qname, None)
                if mate is None:
                    continue
                self._add_soft(batch, i, tr.repeat, clip_map, first=False)
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
                    out.append(mate)
                    continue
                mp = mate.position
                if adjust_by(mate, tr, opts, tr.position):
                    out.append(mate)
                if adjust_by(tr, mate, opts, mp):
                    out.append(tr)
            else:
                self._add_soft(batch, i, tr.repeat, clip_map, first=True)
                if qname in tbl:
                    print(
                        "[strling] warning. bad read (this happens with "
                        f"bwa-kit alignments):{qname} already in table",
                        file=sys.stderr,
                    )
                    del tbl[qname]
                else:
                    tbl[qname] = tr

    def _add_soft(self, batch, i: int, read_repeat: str, clip_map, first: bool):
        """extract.nim:93-132."""
        if batch.mapq[i] < self.opts.min_mapq:
            return
        for side, clip_len, is_left in (
            ("l", int(batch.lclip[i]), True),
            ("r", int(batch.rclip[i]), False),
        ):
            if clip_len == 0:
                continue
            if read_repeat == "" and clip_len <= 16:
                continue
            res = clip_map.get((i, side))
            if res is None:
                continue  # sub-2bp clip: get_repeat would return 0 anyway
            unit = res.unit_first if first else res.unit_after
            count = res.count_first if first else res.count_after
            if count == 0:
                continue
            position = max(0, int(batch.pos[i])) if is_left else max(
                0, int(batch.end_pos[i])
            )
            tr = Tread(
                tid=int(batch.tid[i]), position=position, flag=int(batch.flag[i]),
                repeat=unit, repeat_count=count,
                align_length=clip_len & 0xFF,
                split=Soft.left if is_left else Soft.right,
                mapping_quality=int(batch.mapq[i]), qname=batch.qname(i),
            )
            if tr.p_repeat < 0.9:  # extract.nim:131
                continue
            self.cache.out.append(tr)


def extract(bam, fasta: str | None, genome_repeats_path: str | None,
            proportion_repeat: float = 0.8, min_mapq: int = 40,
            verbose: bool = False, genome_index: GenomeIndex | None = None,
            device: torch.device | None = None):
    """Run extraction over an open Bam; returns (TreadBatch, frag_dist, opts).

    Mirrors extract_main (extract.nim:250-350) minus file output, with the
    repeat scan on `device` (default: the first CUDA card).
    """
    device = device or scan_devices()[0]
    frag_dist = fraglen.fragment_length_distribution(bam)
    frag_median = fraglen.median(frag_dist)
    if verbose:
        print(f"Calculated median fragment length:{frag_median}", file=sys.stderr)

    opts = Options(
        median_fragment_length=frag_median,
        proportion_repeat=proportion_repeat,
        min_mapq=min_mapq,
    )
    if genome_index is None and fasta:
        genome_index = genome_repeats(fasta, opts, genome_repeats_path or "",
                                      device)

    ex = Extractor(opts, genome_index, bam.targets, Lmax=bam.Lmax,
                   device=device)
    t0 = time.time()
    print("[strling] collecting str-like reads", file=sys.stderr)
    for batch in bam.batches():
        ex.process_batch(batch)
        if verbose and ex.nreads and ex.nreads % 10_000_000 < len(batch):
            rps = ex.nreads / max(1e-9, time.time() - t0)
            print(f"{ex.nreads} @ {rps:.1f} reads/sec", file=sys.stderr)
    print("[strling] extracting unmapped reads", file=sys.stderr)
    for batch in bam.query_unmapped():
        ex.process_batch(batch)

    tb = TreadBatch.from_treads(ex.cache.out)
    return tb, frag_dist, opts


def extract_native(bam, fasta: str | None, genome_repeats_path: str | None,
                   proportion_repeat: float = 0.8, min_mapq: int = 40,
                   verbose: bool = False, genome_index: GenomeIndex | None = None,
                   devices: list[torch.device] | None = None,
                   stats: dict | None = None):
    """Native-engine extraction: C++ streams/packs/pairs, `devices` scan
    (default: one CUDA card). Returns (TreadBatch, frag_dist, opts).

    The fragment-length pre-pass (utils.nim:86-111) rides the engine's own
    record stream, and the engine feeds from the first batch with the median
    pending: the median is set as soon as the tee's 2M-record budget is
    consumed (at the latest at the end of the stream), and the engine then
    adds its term to the few positions fed before it (`NativeExtractor.run`),
    so nothing is held and the bin is the reference's.
    The wire width is probed from the first 10k records; if a later read
    turns out longer (it would have been truncated on the wire), extraction
    runs again at the exact width."""
    devs = devices or scan_devices()
    peek_len = peek_max_len(bam)
    opts = Options(
        median_fragment_length=0,
        proportion_repeat=proportion_repeat,
        min_mapq=min_mapq,
    )
    if genome_index is None and fasta:
        genome_index = genome_repeats(fasta, opts, genome_repeats_path or "",
                                      devs[0])

    print("[strling] collecting str-like reads", file=sys.stderr)
    t0 = time.time()
    Lcap = max(32, ((peek_len + 7) // 8) * 8) if peek_len else None
    ne = NativeExtractor(bam, proportion_repeat, min_mapq, None,
                         genome_index=genome_index, Lmax=Lcap)
    tb = ne.run(devs, stats=stats)
    opts.median_fragment_length = ne.median
    if verbose:
        print(f"Calculated median fragment length:{ne.median}",
              file=sys.stderr)
    frag_dist, max_read_len = ne.get_hist()
    # NativeExtractor caps at min(bam.Lmax, Lcap): the effective width is
    # what the retry guard compares against
    eff_cap = min(bam.Lmax, Lcap) if Lcap else bam.Lmax
    true_max = max(ne.max_len_seen, max_read_len)
    if true_max > eff_cap:
        Lcap = max(32, ((true_max + 7) // 8) * 8)
        bam2 = Bam(bam.path, Lmax=Lcap, fasta=getattr(bam, "fasta", None))
        ne, tb = run_once_exact(bam2, Lcap, proportion_repeat, min_mapq,
                                frag_dist, genome_index, devs, opts)
    if verbose:
        dt = max(1e-9, time.time() - t0)
        print(f"[strling] {ne.nreads} reads @ {ne.nreads/dt:.1f} reads/sec",
              file=sys.stderr)
    return tb, frag_dist, opts


def run_once_exact(bam, Lcap, proportion_repeat, min_mapq, frag_dist,
                   genome_index, devices, opts):
    """Exact-width re-run for the rare mixed-read-length case."""
    median = fraglen.median(frag_dist)
    opts.median_fragment_length = median
    ne = NativeExtractor(bam, proportion_repeat, min_mapq, median,
                         genome_index=genome_index, Lmax=Lcap)
    return ne, ne.run(devices)
