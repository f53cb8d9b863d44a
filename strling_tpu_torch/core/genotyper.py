"""Expansion genotyper (src/strpkg/genotyper.nim).

allele1 (short allele) from spanning-read indel modes; allele2 (long allele)
from the depth-normalized log-linear model over anchored+overlapping read STR
content, with the HTT-simulation-fitted constants (genotyper.nim:117-140).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from strling_tpu_torch.core.cluster import Bounds
from strling_tpu_torch.core.collect import Support, SupportType
from strling_tpu_torch.core.tread import Soft
from strling_tpu_torch.utils.fraglen import most_frequent
from strling_tpu_torch.utils.options import Options

NAN = float("nan")

GT_HEADER = (
    "#chrom\tleft\tright\trepeatunit\tallele1_est\tallele2_est\tanchored_reads"
    "\tspanning_reads\tspanning_pairs\texpected_spanning_pairs"
    "\tspanning_pairs_pctl\tleft_clips\tright_clips\tunplaced_pairs\tdepth"
    "\tsum_str_counts"
)  # genotyper.nim:55


@dataclass
class Evidence:
    """genotyper.nim:14-27."""

    klass: str = ""
    repeat: str = ""
    allele1_bp: float = NAN
    allele2_bp: float = NAN
    allele1_ru: float = NAN
    allele2_ru: float = NAN
    allele1_reads: int = 0
    allele2_reads: int = 0
    supporting_reads: int = 0
    sum_str_counts: int = 0


@dataclass
class Call:
    """genotyper.nim:29-53."""

    chrom: str = ""
    start: int = 0
    stop: int = 0
    repeat: str = ""
    allele1: float = 0.0
    allele2: float = 0.0
    quality: float = 0.0
    overlapping_reads: int = 0
    anchored_reads: int = 0
    spanning_reads: int = 0
    expected_spanning_fragments: float = 0.0  # float32 in the wire format
    spanning_fragments_oe_percentile: float = 0.0
    spanning_pairs: int = 0
    left_clips: int = 0
    right_clips: int = 0
    unplaced_reads: int = 0
    depth: float = 0.0
    sum_str_counts: int = 0
    is_large: bool = False

    def tostring(self) -> str:
        """genotyper.nim:57-58."""
        return (
            f"{self.chrom}\t{self.start}\t{self.stop}\t{self.repeat}"
            f"\t{self.allele1:.2f}\t{self.allele2:.2f}\t{self.anchored_reads}"
            f"\t{self.spanning_reads}\t{self.spanning_pairs}"
            f"\t{self.expected_spanning_fragments:.2f}"
            f"\t{self.spanning_fragments_oe_percentile:.2f}"
            f"\t{self.left_clips}\t{self.right_clips}\t{self.unplaced_reads}"
            f"\t{_nim_float(self.depth)}\t{self.sum_str_counts}"
        )


def _nim_float(x: float) -> str:
    """Nim's `$` for float prints 36.0 (always a decimal point)."""
    if x != x:
        return "nan"
    if x == int(x) and abs(x) < 1e16:
        return f"{x:.1f}"
    return repr(x)


def spanning_read_est(reads: list[Support]) -> Evidence:
    """genotyper.nim:62-95: allele estimates from spanning reads."""
    ev = Evidence(klass="spanning reads")
    ev.repeat = reads[0].repeat
    repeat_counts: dict[int, int] = {}
    indels: dict[int, int] = {}
    for read in reads:
        if read.Type == SupportType.SpanningRead:
            rc = read.SpanningReadRepeatCount
            repeat_counts[rc] = repeat_counts.get(rc, 0) + 1
            ind = read.SpanningReadCigarInsertionLen - read.SpanningReadCigarDeletionLen
            indels[ind] = indels.get(ind, 0) + 1
            ev.supporting_reads += 1

    if len(repeat_counts) >= 2:
        top = most_frequent(repeat_counts, 2)
        ev.allele1_ru = float(top[0])
        ev.allele2_ru = float(top[1])
    elif len(repeat_counts) == 1:
        ev.allele1_ru = float(_largest_key(repeat_counts))

    if len(indels) >= 2:
        top = most_frequent(indels, 2)
        ev.allele1_bp = float(top[0])
        ev.allele2_bp = float(top[1])
    elif len(indels) == 1:
        ev.allele1_bp = float(_largest_key(indels))
    return ev


def _largest_key(counts: dict) -> int:
    best_k, best_v = None, -1
    for k, v in counts.items():
        if v > best_v:
            best_k, best_v = k, v
    return best_k


def spanning_pairs_est(reads: list[Support]) -> Evidence:
    """genotyper.nim:99-112."""
    ev = Evidence(klass="spanning pairs")
    ev.repeat = reads[0].repeat
    for read in reads:
        if read.Type == SupportType.SpanningFragment:
            ev.supporting_reads += 1
    return ev


def anchored_lm(sum_str_counts: int, depth: float) -> float:
    """genotyper.nim:117-124 — HTT-sim-fitted log-linear model."""
    if sum_str_counts == 0:
        return NAN
    intercept = 4.3558142
    coefficient = 0.7565329
    y = math.log2(float(sum_str_counts) / max(1, depth) + 1) * coefficient + intercept
    return math.pow(2, y)


def sum_str_est(reads, depth: float) -> Evidence:
    """genotyper.nim:126-131. `reads` is a tread record array."""
    ev = Evidence(klass="")
    ev.supporting_reads = len(reads)
    ev.sum_str_counts = int(np.sum(reads["repeat_count"].astype(np.int64))) if len(reads) else 0
    ev.allele2_bp = anchored_lm(ev.sum_str_counts, depth)
    return ev


def unplaced_est(unplaced_count: int, depth: float) -> float:
    """genotyper.nim:135-140."""
    intercept = 8.9199168
    coefficient = 0.7595562
    y = math.log2(float(unplaced_count) / depth + 1) * coefficient + intercept
    return math.pow(2, y)


def genotype(b: Bounds, tandems, tandem_qnames, spanners: list[Support],
             opts: Options, depth: float) -> Call:
    """genotyper.nim:142-190. `tandems` is a tread record array with a
    parallel qname array (for the anchored distinct-qname count)."""
    c = Call()
    c.chrom = opts.targets[b.tid].name
    c.start = b.left
    c.stop = b.right
    c.left_clips = b.n_left
    c.right_clips = b.n_right
    c.repeat = b.repeat
    c.depth = depth
    rulen = len(c.repeat)

    if len(spanners) == 0:
        c.allele1 = NAN
    else:
        est = spanning_read_est(spanners)
        if est.allele1_bp == est.allele1_bp:  # not NaN
            c.allele1 = est.allele1_bp / max(1, rulen)
        c.spanning_reads = est.supporting_reads
        pairs_est = spanning_pairs_est(spanners)
        c.spanning_pairs = pairs_est.supporting_reads

    # NOTE reference quirk (genotyper.nim:170-172): is_large reads allele2
    # BEFORE it is assigned below, so it is always False in practice — which
    # also makes the unplaced-refinement pass in call (call.nim:268-276) dead.
    # Reproduced faithfully.
    c.is_large = (
        b.n_left >= opts.min_clip
        and b.n_right >= opts.min_clip
        and (b.n_left + b.n_right) >= opts.min_clip_total
        and len(tandems) >= opts.min_support
        and c.allele2 > float(opts.median_fragment_length)
    )

    est2 = sum_str_est(tandems, depth)
    c.overlapping_reads = est2.supporting_reads
    c.sum_str_counts = est2.sum_str_counts
    c.allele2 = est2.allele2_bp / max(1, rulen)

    qnames = set()
    for i in range(len(tandems)):
        if tandems["split"][i] == int(Soft.none):
            qnames.add(tandem_qnames[i] if tandem_qnames is not None else i)
    c.anchored_reads = len(qnames)
    return c


def genotype_ls(b: Bounds, tandems, tandem_qnames, ls, opts: Options,
                depth: float) -> Call:
    """genotype() consuming a collect_batched.LocusSupport instead of the
    per-record Support list — identical Call output (the Support rows
    genotype actually reads are the SpanningRead indel column and the two
    class counts; equivalence-tested against the spec path)."""
    c = Call()
    c.chrom = opts.targets[b.tid].name
    c.start = b.left
    c.stop = b.right
    c.left_clips = b.n_left
    c.right_clips = b.n_right
    c.repeat = b.repeat
    c.depth = depth
    rulen = len(c.repeat)

    if ls.n_support == 0:
        c.allele1 = NAN
    else:
        # spanning_read_est (genotyper.nim:62-95) on the indel column; the
        # dict reproduces insertion order so most_frequent tie-breaks match
        indels: dict[int, int] = {}
        for v in ls.span_ind:
            v = int(v)
            indels[v] = indels.get(v, 0) + 1
        a1 = NAN
        if len(indels) >= 2:
            a1 = float(most_frequent(indels, 2)[0])
        elif len(indels) == 1:
            a1 = float(_largest_key(indels))
        if a1 == a1:
            c.allele1 = a1 / max(1, rulen)
        c.spanning_reads = ls.n_spanning_reads
        c.spanning_pairs = ls.n_spanning_pairs

    # reference quirk: is_large reads allele2 before assignment (see genotype)
    c.is_large = (
        b.n_left >= opts.min_clip
        and b.n_right >= opts.min_clip
        and (b.n_left + b.n_right) >= opts.min_clip_total
        and len(tandems) >= opts.min_support
        and c.allele2 > float(opts.median_fragment_length)
    )

    est2 = sum_str_est(tandems, depth)
    c.overlapping_reads = est2.supporting_reads
    c.sum_str_counts = est2.sum_str_counts
    c.allele2 = est2.allele2_bp / max(1, rulen)

    qnames = set()
    for i in range(len(tandems)):
        if tandems["split"][i] == int(Soft.none):
            qnames.add(tandem_qnames[i] if tandem_qnames is not None else i)
    c.anchored_reads = len(qnames)
    return c


def update_genotype(call: Call, unplaced_reads: int):
    """genotyper.nim:192-197."""
    rulen = len(call.repeat)
    call.unplaced_reads = unplaced_reads
    if unplaced_reads > 2:
        call.allele2 = unplaced_est(unplaced_reads, call.depth) / rulen
