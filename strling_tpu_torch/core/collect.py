"""Per-locus support collection (src/strpkg/collect.nim).

`spanners` re-queries the BAM around a locus and collects three support
classes: spanning fragments, spanning reads and overlapping reads, plus a
diff-array depth profile and the expected number of spanning pairs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from strling_tpu_torch.core.cluster import Bounds
from strling_tpu_torch.core.spanning import cumulative, expected_spanning_probability
from strling_tpu_torch.core.tread import (
    FLAG_DUP,
    FLAG_REVERSE,
    FLAG_SECONDARY,
    FLAG_SUPPLEMENTARY,
)
from strling_tpu_torch.io.sam import Record
from strling_tpu_torch.utils.fraglen import median, median_depth, percentile

# cigar op indexes: MIDNSHP=X
_CONSUMES_QUERY = {0, 1, 4, 7, 8}
_CONSUMES_REF = {0, 2, 3, 7, 8}


class SupportType:
    SpanningFragment = "SpanningFragment"
    SpanningRead = "SpanningRead"
    OverlappingRead = "OverlappingRead"


@dataclass
class Support:
    """collect.nim:15-31."""

    Type: str = SupportType.SpanningFragment
    SpanningFragmentLength: int = 0
    SpanningFragmentPercentile: float = 0.0
    SpanningReadRepeatCount: int = 0
    SpanningReadCigarInsertionLen: int = 0
    SpanningReadCigarDeletionLen: int = 0
    repeat: str = ""
    qname: str = ""

    def tostring(self, b: Bounds, chrom: str) -> str:  # collect.nim:33-34
        return (
            f"{chrom}\t{b.left}\t{b.right}\t{self.Type}"
            f"\t{self.SpanningFragmentLength}\t{self.SpanningFragmentPercentile}"
            f"\t{self.SpanningReadRepeatCount}\t{self.SpanningReadCigarInsertionLen}"
            f"\t{self.SpanningReadCigarDeletionLen}\t{self.repeat}\t{self.qname}"
        )


def _bounds_slop(bounds: Bounds) -> int:
    """collect.nim:38-41 (shared by the fragment and read gates)."""
    slop = len(bounds.repeat) - 1
    bound_width = bounds.right - bounds.left
    if bound_width < 5:
        slop += 5 - bound_width
    return slop


def spanning_fragment_scalars(l_start: int, r_stop: int, l_isize: int,
                              qname: str, bounds: Bounds,
                              frag_sizes: np.ndarray) -> Support | None:
    """collect.nim:36-48 on the scalar fields the gate actually reads."""
    slop = _bounds_slop(bounds)
    if l_start < (bounds.left - slop) and r_stop > (bounds.right + slop):
        support = Support()
        support.Type = SupportType.SpanningFragment
        support.SpanningFragmentLength = max(1, abs(l_isize))
        support.SpanningFragmentPercentile = percentile(
            frag_sizes, support.SpanningFragmentLength
        )
        support.repeat = bounds.repeat
        support.qname = qname
        return support
    return None


def spanning_fragment(L: Record, R: Record, bounds: Bounds, support: Support,
                      frag_sizes: np.ndarray) -> bool:
    """collect.nim:36-48."""
    assert L.start <= R.start
    s = spanning_fragment_scalars(L.start, R.stop, L.isize, L.qname, bounds,
                                  frag_sizes)
    if s is None:
        return False
    support.Type = s.Type
    support.SpanningFragmentLength = s.SpanningFragmentLength
    support.SpanningFragmentPercentile = s.SpanningFragmentPercentile
    support.repeat = s.repeat
    support.qname = s.qname
    return True


def find_read_position(A: Record, position: int) -> int:
    """collect.nim:50-71: project a reference position into read coordinates."""
    r_off = A.start
    q_off = 0
    for length, op in A.cigar:
        if r_off > position:
            return -1
        cq = op in _CONSUMES_QUERY
        cr = op in _CONSUMES_REF
        if cq:
            q_off += length
        if cr:
            r_off += length
        if r_off < position:
            continue
        over = r_off - position
        if over > q_off:
            return -1
        if not cq:
            return -1
        return q_off - over
    return -1


def count_repeat_in_bounds(A: Record, bounds: Bounds) -> int:
    """collect.nim:74-92: repeat units within the bounds via CIGAR projection,
    with the 0.7 purity gate."""
    if bounds.right < bounds.left:
        return 0
    dna = A.seq
    read_left = find_read_position(A, bounds.left)
    read_right = find_read_position(A, bounds.right)
    if read_left >= 0 and read_right < 0:
        read_right = len(dna)
    if read_left < 0 and read_right < 0:
        return 0
    if read_left < 0:
        read_left = 0
    S = dna[read_left:read_right]
    result = S.count(bounds.repeat)
    if result < int(len(S) * 0.7 / len(bounds.repeat)):
        result = 0
    return result


def overlapping_read(A: Record, bounds: Bounds, support: Support) -> bool:
    """collect.nim:96-116."""
    slop = _bounds_slop(bounds)
    if not (A.tid == bounds.tid and max(A.start, bounds.left) <= min(A.stop, bounds.right)):
        return False
    support.Type = SupportType.OverlappingRead
    support.SpanningReadRepeatCount = count_repeat_in_bounds(A, bounds) & 0xFF
    support.qname = A.qname
    if A.start < (bounds.left - slop) and A.stop > (bounds.right + slop):
        support.Type = SupportType.SpanningRead
        ins = 0
        dele = 0
        for length, op in A.cigar:
            if op == 1:  # I — uint8 accumulation wraps like the reference
                ins = (ins + (length & 0xFF)) & 0xFF
            if op == 2:  # D
                dele = (dele + (length & 0xFF)) & 0xFF
        support.SpanningReadCigarInsertionLen = ins
        support.SpanningReadCigarDeletionLen = dele
    return True


def estimate_size(spanners: list[Support], frag_sizes: np.ndarray) -> int:
    """collect.nim:118-126."""
    small = sorted(
        s.SpanningFragmentLength
        for s in spanners
        if s.SpanningFragmentLength > 0 and s.SpanningFragmentPercentile < 0.01
    )
    if not small:
        return -1
    s = small[int((len(small) - 1) / 2)]
    return median(frag_sizes) - s


def batch_records(batch) -> list[Record]:
    """Materialize light Record objects from a native ReadBatch (window
    queries are small, so per-row objects are fine here)."""
    out = []
    qnames = batch.qnames()
    for i in range(len(batch)):
        cig = batch.cigar_of(i)
        out.append(
            Record(
                qname=qnames[i],
                flag=int(batch.flag[i]),
                tid=int(batch.tid[i]),
                pos=int(batch.pos[i]),
                mapq=int(batch.mapq[i]),
                cigar=[(int(c) >> 4, int(c) & 0xF) for c in cig],
                mate_tid=int(batch.mate_tid[i]),
                mate_pos=int(batch.mate_pos[i]),
                isize=int(batch.isize[i]),
                seq=batch.seq_str(i),
            )
        )
    return out


def spanners_reference(bam, bounds: Bounds, window: int, frag_sizes: np.ndarray,
                       min_mapq: int = 20, max_size: int = 5000):
    """collect.nim:130-182, per-record port. Kept as the executable spec for
    the vectorized `spanners` (equivalence-tested)."""
    pairs: dict[str, list[Record]] = {}
    window_left = bounds.left - window
    window_right = bounds.right + window
    cd = cumulative(frag_sizes)
    depths = np.zeros(window_right - window_left, np.int64)
    expected_by_qname: dict[str, float] = {}
    support: list[Support] = []

    for batch in bam.query(bounds.tid, max(0, window_left), window_right):
        for aln in batch_records(batch):
            if aln.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY | FLAG_DUP):
                continue
            if aln.mapq < min_mapq:
                continue
            prob = expected_spanning_probability(cd, aln, bounds.left, bounds.right)
            if prob > 0:
                if aln.qname in expected_by_qname:
                    expected_by_qname[aln.qname] = 0.5 * (
                        expected_by_qname[aln.qname] + prob
                    )
                else:
                    expected_by_qname[aln.qname] = prob

            depths[max(0, aln.start - window_left - 1)] += 1
            depths[min(len(depths) - 1, aln.stop - window_left - 1)] -= 1

            s = Support()
            if overlapping_read(aln, bounds, s):
                support.append(s)
            if aln.tid != aln.mate_tid:
                continue
            if abs(aln.isize) > max_size:
                continue
            pairs.setdefault(aln.qname, []).append(aln)
            if len(pairs) > 20_000:
                return [], -1, np.float32(0)

    # float32 accumulator over float64 values (collect.nim:172-173: the tuple
    # field is float32; each += promotes to float64 then narrows on store)
    expected = np.float32(0)
    for v in expected_by_qname.values():
        expected = np.float32(np.float64(expected) + v)

    for qname, pair in pairs.items():
        if len(pair) != 2:
            continue
        s = Support()
        if spanning_fragment(pair[0], pair[1], bounds, s, frag_sizes):
            support.append(s)

    depths = np.cumsum(depths)
    return support, median_depth(depths), expected


def _expected_probs_vec(cd: np.ndarray, start, stop, flag, event_start: int,
                        event_stop: int, min_span: int = 20) -> np.ndarray:
    """Vectorized expected_spanning_probability (spanning.nim:20-49)."""
    rev = (flag & FLAG_REVERSE) != 0
    left_case = start < (event_stop - min_span)
    ev = event_stop - event_start
    dist_l = event_start - start
    dist_r = stop - event_stop
    ok_l = left_case & ~rev & (dist_l >= 0) & (dist_l + ev >= min_span)
    ok_r = ~left_case & rev & (dist_r >= 0) & (dist_r + ev >= min_span)
    dist = np.where(left_case, dist_l, dist_r) + min_span + ev
    ok = (ok_l | ok_r) & (dist >= 0) & (dist <= len(cd) - 1)
    probs = np.zeros(len(start), np.float64)
    idx = np.where(ok, dist, 0)
    probs[ok] = 1.0 - cd[idx[ok]].astype(np.float64)
    return probs


def spanners(bam, bounds: Bounds, window: int, frag_sizes: np.ndarray,
             min_mapq: int = 20, max_size: int = 5000, batches=None):
    """collect.nim:130-182, vectorized over the window's read batches.

    The spanning-probability model, depth diff-array and eligibility masks
    run as numpy ops; per-read Python survives only for reads that overlap
    the bounds and for complete pairs. Semantics equivalence-tested against
    `spanners_reference`.

    With `batches` (a cached super-region read stream from spanners_many),
    the per-locus BAM query is skipped and membership in this locus's
    window is applied as a mask with htslib query semantics
    (endpos > start and pos < end) — reads outside contribute nothing, so
    results are identical to a fresh per-locus query.
    """
    window_left = bounds.left - window
    window_right = bounds.right + window
    cd = cumulative(frag_sizes)
    depths = np.zeros(window_right - window_left, np.int64)
    support: list[Support] = []
    all_qnames: list[str] = []
    all_probs: list[np.ndarray] = []
    pair_qnames: list[str] = []
    pair_records: list[tuple[int, int, int]] = []  # (start, stop, isize)

    if batches is not None:
        # cached super-region stream: skip whole batches outside this
        # locus's window (batches are coordinate-sorted; a batch overlaps
        # iff any read's [pos, end_pos) crosses the window)
        src = [b for b in batches
               if len(b) and int(b.end_pos.max()) > max(0, window_left)
               and int(b.pos[0]) < window_right]
    else:
        src = bam.query(bounds.tid, max(0, window_left), window_right)
    for batch in src:
        flag = batch.flag.astype(np.int64)
        keep = (
            (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY | FLAG_DUP)) == 0
        ) & (batch.mapq >= min_mapq)
        if batches is not None:
            keep &= (batch.end_pos.astype(np.int64) > max(0, window_left)) \
                & (batch.pos.astype(np.int64) < window_right)
        if not keep.any():
            continue
        start = batch.pos.astype(np.int64)
        stop = batch.end_pos.astype(np.int64)
        probs = _expected_probs_vec(cd, start, stop, flag, bounds.left, bounds.right)
        qn = batch.qnames()

        k = np.nonzero(keep)[0]
        all_probs.append(probs[k])
        all_qnames.extend(qn[i] for i in k)
        np.add.at(depths, np.maximum(0, start[k] - window_left - 1), 1)
        np.add.at(depths, np.minimum(len(depths) - 1, stop[k] - window_left - 1), -1)

        overlap = keep & (
            np.maximum(start, bounds.left) <= np.minimum(stop, bounds.right)
        ) & (batch.tid == bounds.tid)
        pair_ok = keep & (batch.tid == batch.mate_tid) & (
            np.abs(batch.isize) <= max_size
        )
        # full Record objects (cigar list + seq string) only for reads that
        # overlap the bounds; pair candidates carry just the scalars
        # spanning_fragment reads (start/stop/isize — stop is the native
        # bam_endpos, identical to Record.stop's CIGAR projection)
        for i in np.nonzero(overlap)[0]:
            cig = batch.cigar_of(i)
            rec = Record(
                qname=qn[i], flag=int(flag[i]), tid=int(batch.tid[i]),
                pos=int(start[i]), mapq=int(batch.mapq[i]),
                cigar=[(int(c) >> 4, int(c) & 0xF) for c in cig],
                mate_tid=int(batch.mate_tid[i]), mate_pos=int(batch.mate_pos[i]),
                isize=int(batch.isize[i]), seq=batch.seq_str(i),
            )
            s = Support()
            if overlapping_read(rec, bounds, s):
                support.append(s)
        for i in np.nonzero(pair_ok)[0]:
            pair_qnames.append(qn[i])
            pair_records.append((int(start[i]), int(stop[i]),
                                 int(batch.isize[i])))

    # high-depth abort (collect.nim:167-170): the pair-table size only grows,
    # so the final distinct count triggers iff it triggered mid-stream
    if len(set(pair_qnames)) > 20_000:
        return [], -1, np.float32(0)

    # expected spanners: per-qname sequential averaging of positive probs
    # (collect.nim:144-149) then a float32 accumulation (collect.nim:172-173)
    by_qname: dict[str, float] = {}
    if all_probs:
        probs_cat = np.concatenate(all_probs)
        for j in np.nonzero(probs_cat > 0)[0]:
            q = all_qnames[j]
            p = float(probs_cat[j])
            if q in by_qname:
                by_qname[q] = 0.5 * (by_qname[q] + p)
            else:
                by_qname[q] = p
    expected = np.float32(0)
    for v in by_qname.values():
        expected = np.float32(np.float64(expected) + v)

    # spanning fragments from complete pairs (collect.nim:36-48,175-179)
    groups2: dict[str, list[tuple[int, int, int]]] = {}
    for q, r in zip(pair_qnames, pair_records):
        groups2.setdefault(q, []).append(r)
    for q, pair in groups2.items():
        if len(pair) != 2:
            continue
        (l_start, _, l_isize), (r_start, r_stop, _) = pair
        assert l_start <= r_start
        s = spanning_fragment_scalars(l_start, r_stop, l_isize, q, bounds,
                                      frag_sizes)
        if s is not None:
            support.append(s)

    depths = np.cumsum(depths)
    return support, median_depth(depths), expected


#: cached super-region size guard for spanners_many (reads); beyond this
#: the region's loci fall back to per-locus queries
SPANNERS_REGION_CAP = 400_000


def spanners_many(bam, bounds_list: list[Bounds], window: int,
                  frag_sizes: np.ndarray, min_mapq: int = 20):
    """Batched spanners: one streaming BAM pass per connected component of
    overlapping locus windows instead of one random-access query per locus
    (the reference's per-locus re-query is its call-stage bottleneck,
    collect.nim:130-182; SURVEY §7 prescribes streaming windowed evidence).
    Returns {index -> (support, med_depth, expected)} with results
    identical to per-locus `spanners` (window membership is masked with
    query semantics inside)."""
    from strling_tpu_torch.core.collect_batched import iter_components

    results: dict[int, tuple] = {}
    for region_tid, region in iter_components(bounds_list, window):
        if len(region) == 1:
            i = region[0]
            results[i] = spanners(bam, bounds_list[i], window, frag_sizes,
                                  min_mapq)
            continue
        rl = max(0, min(bounds_list[i].left for i in region) - window)
        rr = max(bounds_list[i].right + window for i in region)
        batches = []
        nreads = 0
        for batch in bam.query(region_tid, rl, rr):
            batches.append(batch)
            nreads += len(batch)
            if nreads > SPANNERS_REGION_CAP:
                batches = None
                break
        for i in region:
            results[i] = spanners(bam, bounds_list[i], window, frag_sizes,
                                  min_mapq, batches=batches)
    return results
