"""The plain reference of `strling call`: the `-genotype.txt`,
`-bounds.txt` and `-unplaced.txt` that STRling's call (call.nim:50-303)
writes for a BAM, its bin, a loci bed and the options, computed without the
program.

In call.nim's order, with its f32 arithmetic where call.nim keeps f32:

1. The fragment-length histogram and its medians (utils.nim:86-146,
   `extract_ref.fragment_histogram`): the window is the 99th percentile,
   the largest clip distance half the median.
2. The bin's treads, bucketed by (tid, unit) and sorted by position
   (call.nim:118-130).
3. Each locus of the bed (cluster.nim:111-141) takes the treads of its
   (tid, unit) between its left_most - 1 and right_most out of the table,
   and the first tread past right_most with them (callclusters.nim:14-50);
   a locus wider than 1,000 bp is then skipped (call.nim:189-218).
4. The novel-cluster pass over what is left (call.nim:221-262): unplaced
   treads (tid -1) are counted by unit; placed ones are clustered greedily
   by position (cluster.nim:323-374: a cluster grows while a tread lies
   within the median of its first nine positions + window + 100, is
   trimmed, needs min_support treads with one anchored read, and splits
   where a right-clip peak lies left of a left-clip peak,
   cluster.nim:283-320), and each cluster gets its bounds
   (cluster.nim:175-250) and the size gates of callclusters.nim:52-66.
5. Spanners (collect.nim:130-182) for every locus and cluster: the
   window's primary, non-duplicate records of MAPQ >= min_mapq; reads
   overlapping the bounds, spanning ones among them (outside the bounds by
   the slop) with their CIGAR's insertions less deletions (uint8 sums);
   complete pairs with |TLEN| <= 5,000 that span; the median depth of the
   window; the expected spanning pairs (spanning.nim:7-49: a smoothed f32
   CDF of the histogram, per-name averages of 1 - CDF, folded in f32). More
   than 20,000 pair names, or more than 5,000 supports, skip the locus.
6. The genotype (genotyper.nim:142-190): allele 1 from the commonest
   indel of the spanning reads, allele 2 from the log-linear model on the
   treads' summed repeat counts over the depth, anchored reads as
   distinct names.
7. The global O/E percentile over every call (call.nim:29-47, f32).
8. The unique-large-expansion refinement (call.nim:268-277), with
   call.nim's `is_large`, which reads allele 2 before it is set
   (genotyper.nim:170-172) and so never holds.

Departures from call.nim:
- Window queries are answered from every record of the BAM, decoded up
  front and taken in file order (a record is in a window when it starts
  before its end and ends after its start, htslib's rule), with no BAI.
- Nim's tables iterate in hash order; here the (tid, unit) groups and the
  unplaced counts go in the order their first tread has in the bin, a tie
  for the commonest position goes to the position that reaches the top
  count first, and one for the commonest indel to the indel seen first
  (the port makes the same choices, and writes them down).
- 1 - CDF is taken in f64 from the f32 CDF, as the port takes it.
  Whether call.nim rounds it to f32 first (`cumulative_dist` is f32; the
  result type of `expected_spanning_probability` is not cited) is open:
  on a 3 Mb share of this deployment at 30x, taking it in f32 changed the
  expected sum in its last bits at 93 of 505 loci, and no printed line.
- The bin's targets are not compared with the BAM's; `-b` bounds files,
  `--debug` evidence files and `-v` messages are left out (the deployment
  uses none of them).

`reference_call(...)` returns the three files' text; `compare_call` gives
the numbers `correct` rests on.
"""

from __future__ import annotations

import math
import time

import numpy as np

from portbench.reference.bamread import read_bam
from portbench.reference.extract_ref import (canonical_repeat,
                                             fragment_histogram, median,
                                             parse_bin)

SOFT_LEFT, SOFT_RIGHT, SOFT_NONE = 0, 1, 3
SKIP = 0x100 | 0x400 | 0x800     # secondary, duplicate, supplementary
REVERSE = 0x10
MIN_SPAN = 20                    # spanning.nim's min_spanning_bases
SMOOTH = 11                      # spanning.nim: +-11 bins
U32 = 1 << 32

GT_HEADER = ("#chrom\tleft\tright\trepeatunit\tallele1_est\tallele2_est"
             "\tanchored_reads\tspanning_reads\tspanning_pairs"
             "\texpected_spanning_pairs\tspanning_pairs_pctl\tleft_clips"
             "\tright_clips\tunplaced_pairs\tdepth\tsum_str_counts")
BOUNDS_HEADER = ("#chrom\tleft\tright\trepeat\tname\tleft_most\tright_most"
                 "\tcenter_mass\tn_left\tn_right\tn_total\tdepth")


class Locus:
    """A locus or a cluster's bounds (cluster.nim:75-88)."""

    def __init__(self, tid, left, right, unit, name="", left_most=0,
                 right_most=0):
        self.tid, self.left, self.right, self.unit = tid, left, right, unit
        self.name, self.left_most, self.right_most = name, left_most, right_most
        self.center_mass = self.n_left = self.n_right = self.n_total = 0

    def line(self, chrom: str) -> str:
        return "\t".join(str(v) for v in (
            chrom, self.left, self.right, self.unit, self.name,
            self.left_most, self.right_most, self.center_mass, self.n_left,
            self.n_right, self.n_total))


# ------------------------------------------------------------ the BAM

class Windows:
    """Window queries over a decoded, coordinate-sorted BAM."""

    def __init__(self, R):
        self.R = R
        self.blocks = {}
        for tid in np.unique(R.tid[R.tid >= 0]).tolist():
            rows = np.flatnonzero(R.tid == tid)
            span = int((R.end_pos[rows] - R.pos[rows]).max())
            self.blocks[tid] = (rows, R.pos[rows], span)

    def query(self, tid: int, beg: int, end: int) -> np.ndarray:
        """Rows of the records of contig `tid` that overlap [beg, end), in
        file order."""
        if tid not in self.blocks:
            return np.zeros(0, np.int64)
        rows, pos, span = self.blocks[tid]
        a = np.searchsorted(pos, beg - span, "left")
        b = np.searchsorted(pos, end, "left")
        cand = rows[a:b]
        return cand[self.R.end_pos[cand] > beg]

    def cigar(self, row: int) -> list[tuple[int, int]]:
        R = self.R
        at = int(R.cig_at[row])
        n = int(R.ncig[row])
        words = R.buf[at:at + 4 * n].copy().view("<u4")
        return [(int(w) & 0xF, int(w) >> 4) for w in words]


def smoothed_cdf(hist: np.ndarray) -> np.ndarray:
    """spanning.nim:7-18: each bin's count summed with its 11 neighbours on
    each side (exact in integers), accumulated in f32 from the first bin,
    over the last."""
    h = np.asarray(hist, np.int64)
    c = np.concatenate([[0], np.cumsum(h)])
    n = len(h)
    i = np.arange(n)
    lo = np.maximum(i - SMOOTH, 0)
    hi = np.minimum(i + SMOOTH + 1, n)
    sm = (c[hi] - c[lo]).astype(np.float32)
    acc = np.cumsum(sm, dtype=np.float32)
    return (acc / acc[-1]).astype(np.float32)


def _span_prob(cd, start, stop, reverse, left, right) -> float:
    """spanning.nim:20-49: the chance that the read's fragment spans the
    event, 1 - CDF(distance), the f32 CDF taken to f64 first (see the
    module's departures)."""
    ev = right - left
    if start < right - MIN_SPAN:
        if reverse:
            return 0.0
        d = left - start
    else:
        if not reverse:
            return 0.0
        d = stop - right
    if d < 0 or d + ev < MIN_SPAN:
        return 0.0
    d += MIN_SPAN + ev
    if d > len(cd) - 1:
        return 0.0
    return 1.0 - float(cd[d])


def spanners(W: Windows, names: dict, locus: Locus, window: int, cd,
             min_mapq: int, max_size: int = 5000):
    """collect.nim:130-182 on one locus: (supports, spanning reads' indels,
    spanning pairs, median depth, expected spanning pairs); median depth
    -1 where more than 20,000 pair names abort the locus."""
    R = W.R
    left, right = locus.left, locus.right
    wl, wr = left - window, right + window
    slop = len(locus.unit) - 1 + max(0, 5 - (right - left))
    rows = W.query(locus.tid, max(0, wl), wr)
    rows = rows[((R.flag[rows] & SKIP) == 0) & (R.mapq[rows] >= min_mapq)]
    depth = np.zeros(wr - wl, np.int64)
    by_name: dict[bytes, float] = {}
    pairs: dict[bytes, list] = {}
    overlapping = 0
    indels = []
    for r in rows.tolist():
        q = names[r]
        start, stop = int(R.pos[r]), int(R.end_pos[r])
        p = _span_prob(cd, start, stop, bool(R.flag[r] & REVERSE), left, right)
        if p > 0:
            by_name[q] = 0.5 * (by_name[q] + p) if q in by_name else p
        depth[max(0, start - wl - 1)] += 1
        depth[min(len(depth) - 1, stop - wl - 1)] -= 1
        if R.tid[r] == locus.tid and max(start, left) <= min(stop, right):
            overlapping += 1
            if start < left - slop and stop > right + slop:
                ins = dele = 0
                for op, ln in W.cigar(r):
                    if op == 1:
                        ins = (ins + ln) & 0xFF
                    elif op == 2:
                        dele = (dele + ln) & 0xFF
                indels.append(ins - dele)
        if R.tid[r] != R.mtid[r] or abs(int(R.tlen[r])) > max_size:
            continue
        pairs.setdefault(q, []).append((start, stop))
        if len(pairs) > 20_000:
            return 0, [], 0, -1, np.float32(0)
    expected = np.float32(0)
    for v in by_name.values():           # first-seen name order
        expected = np.float32(float(expected) + v)
    n_pairs = sum(1 for p in pairs.values() if len(p) == 2
                  and p[0][0] < left - slop and p[1][1] > right + slop)
    cover = np.cumsum(depth)
    counts = np.bincount(np.minimum(cover, 1047), minlength=1048)
    over = np.cumsum(counts) > len(cover) / 2.0
    med = int(np.argmax(over)) if over.any() else 0
    return overlapping + n_pairs, indels, n_pairs, med, expected


# --------------------------------------------------------- clustering

def _first9_median(pos: list) -> int:
    k = min(9, len(pos))
    return pos[int(k / 2 - 0.5)]


def _first_commonest(values) -> int:
    """The commonest value; a tie goes to the value seen first
    (genotyper.nim:62-95's top count of the indels)."""
    seen: dict = {}
    for v in values:
        seen[v] = seen.get(v, 0) + 1
    top = max(seen.values())
    return next(v for v, c in seen.items() if c == top)


def _commonest(values) -> tuple[int, int]:
    """(value, count) of the commonest value; a tie goes to the value that
    reaches the top count first (cluster.nim's CountTable.largest)."""
    seen: dict = {}
    best, top = None, -1
    for v in values:
        seen[v] = seen.get(v, 0) + 1
        if seen[v] > top:
            best, top = v, seen[v]
    return best, top


def _clusters(pos: list, split: list, window: int, min_support: int):
    """cluster.nim:323-362 on one (tid, unit) group sorted by position:
    (index list, left_most, right_most) of each cluster kept, after its
    split (cluster.nim:283-320)."""
    n, i = len(pos), 0
    while i < n:
        a, b = i, i + 1
        while b < n and pos[b] <= _first9_median(pos[a:min(b, a + 9)]) + window + 100:
            b += 1
        i = b
        # trim the reads at the start now far from the median (never the
        # last one), cluster.nim:252-257
        lo = max(0, _first9_median(pos[a:a + 9]) - (window + 100))
        while a < b - 1 and pos[a] < lo:
            a += 1
        idx = list(range(a, b))
        pm = _first9_median(pos[a:min(b, a + 9)])
        right_most = max(pos[b - 1], pm + window)
        left_most = min(pos[a], (pm - window) % U32)  # uint32 in call.nim
        if len(idx) < min_support or all(split[j] != SOFT_NONE for j in idx):
            continue
        yield from _split(idx, pos, split, left_most, right_most, min_support)


def _split(idx, pos, split, left_most, right_most, min_support):
    lp = [pos[j] for j in idx if split[j] == SOFT_LEFT]
    rp = [pos[j] for j in idx if split[j] == SOFT_RIGHT]
    if lp and rp:
        rk, rv = _commonest(rp)
        lk, lv = _commonest(lp)
        if (rk < lk and rv >= min_support and lv >= min_support
                and lv / len(set(lp)) > 0.5 and rv / len(set(rp)) > 0.5):
            mid = int(0.5 + (rk + lk) / 2.0)
            yield [j for j in idx if pos[j] < mid], 0, mid - 1
            yield [j for j in idx if pos[j] >= mid], mid, 0
            return
    yield idx, left_most, right_most


def cluster_bounds(tid, unit, pos, split, left_most, right_most,
                   max_clip_dist) -> Locus:
    """cluster.nim:175-250."""
    b = Locus(tid, 0, 0, unit)
    b.center_mass = pos[int(len(pos) / 2)]
    lefts = [p for p, s in zip(pos, split) if s == SOFT_LEFT
             and p < b.center_mass + max_clip_dist]
    rights = [p for p, s in zip(pos, split) if s == SOFT_RIGHT
              and p > b.center_mass - max_clip_dist]
    b.n_left, b.n_right, b.n_total = len(lefts), len(rights), len(pos)
    if lefts:
        k, c = _commonest(lefts)
        if c > 1:
            b.left = k
    if rights:
        k, c = _commonest(rights)
        if c > 1:
            b.right = k
    if b.left == 0:
        b.left = b.center_mass
    if b.right == 0:
        b.right = b.left + 1
    if b.left >= b.right:
        if b.n_left > 0 and b.n_right > 0:
            b.left, b.right = b.right, b.left
        else:
            b.left = b.right - 1
    b.left_most = min(left_most if left_most > 0 else min(pos), b.left)
    b.right_most = max(right_most if right_most > 0 else max(pos), b.right)
    return b


# ------------------------------------------------------------ genotype

def _fmt2(x: float) -> str:
    return "nan" if x != x else f"{x:.2f}"


class Call:
    def __init__(self, chrom, locus: Locus, depth: int):
        self.chrom, self.locus, self.depth = chrom, locus, float(depth)
        self.allele1 = self.allele2 = 0.0
        self.anchored = self.spanning_reads = self.spanning_pairs = 0
        self.expected = np.float32(0)
        self.pct = np.float32(0)
        self.unplaced = self.sum_str = 0
        self.is_large = False

    def line(self) -> str:
        b = self.locus
        return "\t".join((
            self.chrom, str(b.left), str(b.right), b.unit, _fmt2(self.allele1),
            _fmt2(self.allele2), str(self.anchored), str(self.spanning_reads),
            str(self.spanning_pairs), _fmt2(float(self.expected)),
            _fmt2(float(self.pct)), str(b.n_left), str(b.n_right),
            str(self.unplaced), f"{self.depth:.1f}", str(self.sum_str)))


def genotype(chrom, locus: Locus, treads: list, support, opts) -> Call:
    """genotyper.nim:142-190; `treads` are (split, count, name) rows."""
    n_support, indels, n_pairs, med, expected = support
    c = Call(chrom, locus, med)
    k = len(locus.unit)
    if n_support == 0:
        c.allele1 = float("nan")
    else:
        if indels:
            c.allele1 = _first_commonest(indels) / max(1, k)
        c.spanning_reads = len(indels)
        c.spanning_pairs = n_pairs
    # is_large is read with allele 2 still unset (genotyper.nim:170-172)
    c.is_large = (locus.n_left >= opts["min_clip"]
                  and locus.n_right >= opts["min_clip"]
                  and locus.n_left + locus.n_right >= opts["min_clip_total"]
                  and len(treads) >= opts["min_support"]
                  and c.allele2 > float(opts["median"]))
    c.sum_str = sum(t[1] for t in treads)
    if c.sum_str:
        y = (math.log2(float(c.sum_str) / max(1, c.depth) + 1) * 0.7565329
             + 4.3558142)
        c.allele2 = math.pow(2, y) / max(1, k)
    else:
        c.allele2 = float("nan")
    c.anchored = len({t[2] for t in treads if t[0] == SOFT_NONE})
    c.expected = expected
    return c


def _refine(c: Call, unplaced: int):
    """genotyper.nim:192-197."""
    c.unplaced = unplaced
    if unplaced > 2:
        y = math.log2(float(unplaced) / c.depth + 1) * 0.7595562 + 8.9199168
        c.allele2 = math.pow(2, y) / len(c.locus.unit)


# ------------------------------------------------------------ the call

def read_loci(path: str, refs: list, window: int) -> list[Locus]:
    """cluster.nim:111-141: 4 or 5 fields a line."""
    tids = {}
    for t, (name, _) in enumerate(refs):
        tids.setdefault(name, t)
    out = []
    with open(path) as fh:
        for line in fh:
            p = line.rstrip("\n").split()
            if not p:
                continue
            if len(p) not in (4, 5):
                raise ValueError(f"a loci line has {len(p)} fields: {line!r}")
            tid = tids.get(p[0], -1)
            left, right = int(p[1]), int(p[2])
            out.append(Locus(tid, left, right, p[3], p[4] if len(p) == 5 else "",
                             max(left - window, 0),
                             min(right + window, refs[tid][1])))
    return out


def reference_call(bam_path: str, bin_path: str, loci_path: str,
                   min_support: int = 5, min_mapq: int = 40, min_clip: int = 0,
                   min_clip_total: int = 0, threads: int = 8,
                   records: tuple | None = None) -> dict:
    """The text of `call -l loci_path bam_path bin_path`'s three files,
    with `times` the seconds of its stages and `calls` its work items.
    `records`, the (refs, Records) that `read_bam(bam_path)` returns, saves
    decoding the BAM again."""
    t0 = time.perf_counter()
    _, refs, R = (None, *records) if records else read_bam(bam_path, threads)
    t1 = time.perf_counter()
    hist = fragment_histogram(R)
    med, window = median(hist), median(hist, 0.99)
    max_clip_dist = int(0.5 * float(median(hist, 0.5)))
    opts = {"min_clip": min_clip, "min_clip_total": min_clip_total,
            "min_support": min_support, "median": med}
    with open(bin_path, "rb") as fh:
        _, _, rows = parse_bin(fh.read())
    # (tid, unit) groups in the order of their first tread; position order
    # inside, ties kept in bin order
    groups: dict[tuple[int, str], list] = {}
    for r in rows:
        groups.setdefault((r[0], r[2]), []).append(r)
    for g in groups.values():
        g.sort(key=lambda r: r[1])

    work = []                              # (locus, treads)
    for locus in read_loci(loci_path, refs, window):
        g = groups.get((locus.tid, locus.unit), [])
        lo = locus.left_most - 1 if locus.left_most != 0 else 0
        li = next((i for i, r in enumerate(g) if r[1] >= lo), len(g))
        ri = next((i for i, r in enumerate(g) if r[1] > locus.right_most),
                  len(g))
        taken = g[li:ri]
        if (locus.tid, locus.unit) in groups:
            groups[(locus.tid, locus.unit)] = g[:li] + g[ri + 1:]
        locus.n_total = len(taken)
        locus.n_right = sum(1 for r in taken if r[4] == SOFT_RIGHT)
        locus.n_left = sum(1 for r in taken if r[4] == SOFT_LEFT)
        if locus.right - locus.left > 1000:
            continue
        work.append((locus, taken))

    unplaced: dict[str, int] = {}
    for (tid, unit), g in groups.items():
        if not g:
            continue
        if tid < 0:
            unplaced[unit] = len(g)
            continue
        pos = [r[1] for r in g]
        split = [r[4] for r in g]
        for idx, lm, rm in _clusters(pos, split, window, min_support):
            if len(idx) >= 0xFFFF:
                continue
            b = cluster_bounds(tid, unit, [pos[j] for j in idx],
                               [split[j] for j in idx], lm, rm, max_clip_dist)
            if b.right - b.left > 1000:
                continue
            if (b.n_left < min_clip or b.n_right < min_clip
                    or b.n_left + b.n_right < min_clip_total):
                continue
            work.append((b, [g[j] for j in idx]))
    t2 = time.perf_counter()

    W = Windows(R)
    need = set()
    for locus, _ in work:
        need.update(W.query(locus.tid, max(0, locus.left - window),
                            locus.right + window).tolist())
    need = np.array(sorted(need), np.int64)
    names = dict(zip(need.tolist(), R.names(need)))
    cd = smoothed_cdf(hist)
    by_unit: dict[str, list[Call]] = {}
    bounds_lines = []
    for locus, treads in work:
        sup = spanners(W, names, locus, window, cd, min_mapq)
        if sup[0] > 5000 or sup[3] == -1:
            continue
        chrom = refs[locus.tid][0]
        c = genotype(chrom, locus, [(r[4], r[6], r[8]) for r in treads], sup,
                     opts)
        by_unit.setdefault(canonical_repeat(locus.unit), []).append(c)
        bounds_lines.append(locus.line(chrom) + "\t" + str(sup[3]))
    t3 = time.perf_counter()

    calls = [c for cs in by_unit.values() for c in cs]
    oe = [np.float32((np.float32(1) + np.float32(c.spanning_pairs)
                      - np.float32(c.expected))
                     / (np.float32(c.expected) + np.float32(1)))
          for c in calls]
    ranked = np.sort(np.array(oe, np.float32))
    with np.errstate(invalid="ignore", divide="ignore"):
        for c, v in zip(calls, oe):
            c.pct = (np.float32(np.searchsorted(ranked, v, "left"))
                     / np.float32(len(oe) - 1))
    gt_lines = []
    for unit, cs in by_unit.items():
        large = [c for c in cs if c.is_large][:2]
        if len(large) == 1:
            _refine(large[0], unplaced.get(unit, 0))
        gt_lines.extend(c.line() for c in cs)
    return {
        "genotype": "\n".join([GT_HEADER, *gt_lines]) + "\n",
        "bounds": "\n".join([BOUNDS_HEADER, *bounds_lines]) + "\n",
        "unplaced": "".join(f"{u}\t{n}\n" for u, n in unplaced.items()),
        "calls": len(work), "n_records": len(R),
        "times": {"bam": t1 - t0, "replay": t2 - t1, "collect": t3 - t2,
                  "finish": time.perf_counter() - t3},
    }


def compare_call(got: dict, ref: dict) -> dict:
    """Lines that differ, by place, plus the difference in their number,
    for each of the three files (`got` holds their text under the same
    keys as `reference_call`'s)."""
    out = {}
    for key in ("genotype", "bounds", "unplaced"):
        a, b = got[key].splitlines(), ref[key].splitlines()
        out[f"{key}_lines_wrong"] = (sum(x != y for x, y in zip(a, b))
                                     + abs(len(a) - len(b)))
    return out
