"""Greedy positional clustering of evidence reads and locus-bound estimation.

Port of reference src/strpkg/cluster.nim:52-374. Clusters are contiguous
ranges over a position-sorted tread array for one (tid, repeat-unit) group, so
the greedy grow/trim/split logic runs on index ranges with numpy-backed
storage instead of copying read sequences around.

Divergence note (documented, deliberate): the reference breaks ties in
CountTable.largest by Nim hash-table iteration order (cluster.nim:204-211,
300-303), which is an implementation artifact. Here ties go to the key that
reaches the max count first in read order — identical in all non-tied cases.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Sequence

import numpy as np

from strling_tpu_torch.core.tread import Soft

U32 = 1 << 32
MEDIANI = 9  # cluster.nim:57

BOUNDS_HEADER = (
    "#chrom\tleft\tright\trepeat\tname\tleft_most\tright_most\tcenter_mass"
    "\tn_left\tn_right\tn_total"
)  # cluster.nim:89


@dataclass
class Bounds:
    """cluster.nim:75-88."""

    tid: int = 0
    left: int = 0
    left_most: int = 0
    right: int = 0
    right_most: int = 0
    center_mass: int = 0
    n_left: int = 0
    n_right: int = 0
    n_total: int = 0
    repeat: str = ""
    name: str = ""
    force_report: bool = False

    def __eq__(self, other) -> bool:  # cluster.nim:91-93
        return (
            self.tid == other.tid
            and self.left == other.left
            and self.right == other.right
            and self.repeat == other.repeat
        )

    def overlaps(self, other: "Bounds") -> bool:  # cluster.nim:96-100
        if self.tid == other.tid and self.repeat == other.repeat:
            return max(self.left, other.left) <= min(self.right, other.right)
        return False

    def id(self, targets) -> str:  # cluster.nim:259-260
        return f"{targets[self.tid].name}-{self.left}-{self.repeat}"

    def tostring(self, targets) -> str:  # cluster.nim:262-266
        assert self.left_most <= self.right_most, repr(self)
        assert self.left_most <= self.left, repr(self)
        assert self.right_most >= self.right, repr(self)
        return (
            f"{targets[self.tid].name}\t{self.left}\t{self.right}\t{self.repeat}"
            f"\t{self.name}\t{self.left_most}\t{self.right_most}"
            f"\t{self.center_mass}\t{self.n_left}\t{self.n_right}\t{self.n_total}"
        )


@dataclass
class Cluster:
    """A cluster of treads: a view (record array) plus window metadata.

    `reads` is a TREAD_DTYPE record array (see strling_tpu.core.tread), or any
    sequence exposing .position/.split via field access helpers below.
    """

    reads: np.ndarray
    left_most: int = 0
    right_most: int = 0
    # parallel object-dtype array of qnames, when sample tracking matters
    qnames: np.ndarray | None = None

    def tostring(self, targets) -> str:  # cluster.nim:268-273
        rep = self.reads["repeat"][0].decode()
        return (
            f"{targets[self.reads['tid'][0]].name}\t{self.reads['position'][0]}"
            f"\t{self.reads['position'][-1]}\t{len(self.reads)}\t{rep}"
        )


def _posmed(positions: np.ndarray, n: int = MEDIANI) -> int:
    """Median of the first n positions (cluster.nim:59-62).

    mid = int(min(n, len)/2 - 0.5) — float division then truncation.
    """
    mid = int(min(n, len(positions)) / 2 - 0.5)
    return int(positions[mid])


def _largest(keys) -> tuple[int, int]:
    """(key, count) with max count; ties -> the key that REACHES the max
    count first (i.e. whose M-th occurrence comes earliest in input order).

    Stands in for Nim CountTable.largest (see module docstring for the
    tie-break divergence). Vectorized but semantics-identical to the running
    dict scan: winner = argmin over max-count keys of the index of their
    M-th occurrence.
    """
    arr = np.asarray(keys)
    if arr.size == 0:
        return None, -1
    order = np.argsort(arr, kind="stable")  # keys grouped, input order kept
    uniq, starts, counts = np.unique(
        arr[order], return_index=True, return_counts=True
    )
    best = int(counts.max())
    cand = np.flatnonzero(counts == best)
    reach = order[starts[cand] + best - 1]  # index of each M-th occurrence
    k = cand[np.argmin(reach)]
    return int(uniq[k]), best


def bounds(cl: Cluster, max_clip_dist: int = 200) -> Bounds:
    """Find the locus bounds for a cluster (cluster.nim:175-250)."""
    reads = cl.reads
    b = Bounds()
    b.repeat = reads["repeat"][0].decode()
    b.tid = int(reads["tid"][0])
    assert len(reads) <= 0xFFFF, f"got too many reads for cluster: {reads[0]}"

    posns = reads["position"].astype(np.int64)
    b.center_mass = int(posns[int(len(posns) / 2)])

    splits = reads["split"]
    is_left = splits == int(Soft.left)
    is_right = splits == int(Soft.right)
    # int32 casts as in the reference (cluster.nim:193,197)
    left_gate = is_left & (posns < b.center_mass + max_clip_dist)
    right_gate = is_right & (posns > b.center_mass - max_clip_dist)
    b.n_left = int(left_gate.sum())
    b.n_right = int(right_gate.sum())
    b.n_total = len(reads)

    if b.n_left > 0:
        key, val = _largest(posns[left_gate])
        if val > 1:
            b.left = key
    if b.n_right > 0:
        key, val = _largest(posns[right_gate])
        if val > 1:
            b.right = key

    if len(posns) > 0:  # cluster.nim:213-217
        if b.left == 0:
            b.left = b.center_mass
        if b.right == 0:
            b.right = b.left + 1
    else:
        if b.right == 0:
            b.right = b.left + 1
        if b.left == 0:
            b.left = b.right - 1

    if b.left >= b.right:  # cluster.nim:227-231
        if b.n_left > 0 and b.n_right > 0:
            b.left, b.right = b.right, b.left
        else:
            b.left = b.right - 1

    # left/right-most informative positions (cluster.nim:234-241)
    b.left_most = cl.left_most if cl.left_most > 0 else int(posns.min())
    b.right_most = cl.right_most if cl.right_most > 0 else int(posns.max())

    # "XXX this correction may be hiding a bug elsewhere" (cluster.nim:243-247)
    if b.left_most > b.left:
        b.left_most = b.left
    if b.right_most < b.right:
        b.right_most = b.right

    assert b.left <= b.right, repr(b)
    assert b.left_most <= b.right_most, repr(b)
    return b


def _has_anchor(splits: np.ndarray) -> bool:
    """cluster.nim:275-281."""
    return bool((splits == int(Soft.none)).any())


def split_cluster(c: Cluster, min_supporting_reads: int) -> Iterator[Cluster]:
    """Split right-peak -> left-peak double loci (cluster.nim:283-320)."""
    reads = c.reads
    posns = reads["position"].astype(np.int64)
    splits = reads["split"]
    left_pos = posns[splits == int(Soft.left)]
    right_pos = posns[splits == int(Soft.right)]

    if len(right_pos) == 0 or len(left_pos) == 0:
        yield c
        return

    rl_key, rl_val = _largest(right_pos)
    ll_key, ll_val = _largest(left_pos)
    n_left_distinct = len(np.unique(left_pos))
    n_right_distinct = len(np.unique(right_pos))
    if (
        rl_key < ll_key
        and rl_val >= min_supporting_reads
        and ll_val >= min_supporting_reads
        and ll_val / n_left_distinct > 0.5
        and rl_val / n_right_distinct > 0.5
    ):
        mid = int(0.5 + (rl_key + ll_key) / 2.0)
        sel = posns < mid
        c1 = Cluster(reads=reads[sel], right_most=mid - 1)
        c2 = Cluster(reads=reads[~sel], left_most=mid)
        if c.qnames is not None:
            c1.qnames = c.qnames[sel]
            c2.qnames = c.qnames[~sel]
        yield c1
        yield c2
    else:
        yield c


def _window_meta(reads: np.ndarray, max_dist: int) -> tuple[int, int]:
    """right_most/left_most of a finalized cluster (cluster.nim:343-344).

    left_most underflows in uint32 when posmed < max_dist; the reference then
    takes min() against the first position which always wins — reproduce that.
    """
    posns = reads["position"]
    pm = _posmed(posns)
    right_most = max(int(posns[-1]), pm + max_dist)
    cand = pm - max_dist
    if cand < 0:
        cand += U32
    left_most = min(int(posns[0]), cand)
    return left_most, right_most


def _trim(reads: np.ndarray, max_dist: int, qnames: list | None):
    """Drop reads at cluster start now outside the window (cluster.nim:252-257).

    The cutoff is computed once from the median of the incoming cluster.
    """
    if len(reads) == 0:
        return reads, qnames
    lo = max(0, _posmed(reads["position"]) - max_dist)
    n = len(reads)
    # first index with position >= lo, capped at n-1 (the reference's
    # while-loop never drops the final read)
    i = min(int(np.searchsorted(reads["position"], lo, side="left")), n - 1)
    if i:
        reads = reads[i:]
        if qnames is not None:
            qnames = qnames[i:]
    return reads, qnames


def trcluster(
    reads: np.ndarray,
    max_dist: int,
    min_supporting_reads: int,
    qnames: list | None = None,
) -> Iterator[Cluster]:
    """Greedy clustering of a position-sorted (tid, repeat) group
    (cluster.nim:323-362)."""
    n = len(reads)
    posns = reads["position"].astype(np.int64)
    i = 0
    a = b = 0  # current cluster = reads[a:b]
    while i < n:
        a = i
        b = i + 1
        i += 1
        ended_by_gap = False
        j = b
        while j < n:
            # grow while close enough to the running median of the first <=9
            # reads (cluster.nim:336: fragment distance + 100 for event len)
            thr = _posmed(posns[a:b]) + max_dist + 100
            if posns[j] <= thr:
                b = j + 1
                i = j + 1
                if b - a >= MEDIANI:
                    # the median window is frozen at the first 9 reads, so
                    # the remaining growth is one sorted-array jump
                    b = int(np.searchsorted(posns, thr, side="right", sorter=None))
                    b = max(b, j + 1)
                    i = b
                    j = b
                else:
                    j += 1
                continue
            # finalize cluster at gap
            ended_by_gap = True
            creads, cq = reads[a:b], (qnames[a:b] if qnames is not None else None)
            creads, cq = _trim(creads, max_dist + 100, cq)
            left_most, right_most = _window_meta(creads, max_dist)
            if len(creads) >= min_supporting_reads and _has_anchor(creads["split"]):
                c = Cluster(reads=creads, left_most=left_most, right_most=right_most, qnames=cq)
                yield from split_cluster(c, min_supporting_reads)
            break
        if not ended_by_gap and i >= n:
            break

    # final flush (cluster.nim:354-362); the loop above guarantees reads[a:b]
    # is the last (non-empty) cluster exactly when no gap ended it
    if n and not ended_by_gap:
        creads, cq = reads[a:b], (qnames[a:b] if qnames is not None else None)
        creads, cq = _trim(creads, max_dist + 100, cq)
        left_most, right_most = _window_meta(creads, max_dist)
        assert left_most <= right_most
        if len(creads) >= min_supporting_reads and _has_anchor(creads["split"]):
            c = Cluster(reads=creads, left_most=left_most, right_most=right_most, qnames=cq)
            yield from split_cluster(c, min_supporting_reads)


def cluster(
    reads: np.ndarray,
    max_dist: int,
    min_supporting_reads: int,
    qnames: list | None = None,
) -> Iterator[Cluster]:
    """cluster.nim:364-374: unplaced (tid<0) groups yield one big cluster."""
    if len(reads) == 0:
        return
    assert reads["tid"][0] == reads["tid"][-1] and reads["repeat"][0] == reads["repeat"][-1]
    if reads["tid"][0] < 0:
        yield Cluster(reads=reads, qnames=qnames)
    else:
        yield from trcluster(reads, max_dist, min_supporting_reads, qnames)


# ---------------------------------------------------------------------------
# loci / bounds file parsers (cluster.nim:111-169)
# ---------------------------------------------------------------------------


def get_tid(name: str, targets) -> int:
    """utils.nim:214-218."""
    for t in targets:
        if t.name == name:
            return t.tid
    return -1


def parse_bedline(line: str, targets, window: int) -> Bounds:
    """cluster.nim:111-134."""
    parts = line.split()
    b = Bounds()
    if len(parts) == 4:
        pass
    elif len(parts) == 5:
        b.name = parts[4]
    else:
        raise SystemExit(
            f"Error reading loci bed file. Expected 4 or 5 fields and got "
            f"{len(parts)} on line: {line}"
        )
    b.tid = get_tid(parts[0], targets)
    b.left = int(parts[1])
    b.right = int(parts[2])
    b.repeat = parts[3]
    if len(b.repeat) > 6:
        raise SystemExit(
            "ERROR: STRling currently only supports 1-6 bp repeat units. Input "
            f"bed contains repeat unit length {len(b.repeat)}\n{line}"
        )
    b.left_most = max(b.left - window, 0)
    b.right_most = min(b.right + window, targets[b.tid].length)
    for x in b.repeat:
        if x not in "ATCG":
            raise SystemExit(
                "Error reading loci bed file. Expected DNA (ATCG only) in the "
                f"4th field, and got an unexpected character on line: {line}"
            )
    assert b.left <= b.right, repr(b)
    assert b.left_most <= b.right_most, repr(b)
    return b


def parse_bed(path: str, targets, window: int, tid: int | None = None) -> list[Bounds]:
    """cluster.nim:137-141."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            r = parse_bedline(line, targets, window)
            if tid is not None and r.tid != tid:
                continue
            out.append(r)
    return out


def parse_boundsline(line: str, targets) -> Bounds:
    """cluster.nim:144-163."""
    parts = line.split("\t")
    if len(parts) != 11:
        raise SystemExit(
            f"Error reading loci bed file. Expected 11 fields and got "
            f"{len(parts)} on line: {line}"
        )
    b = Bounds()
    b.tid = get_tid(parts[0], targets)
    b.left = int(parts[1])
    b.right = int(parts[2])
    b.repeat = parts[3]
    b.name = parts[4]
    b.left_most = int(parts[5])
    b.right_most = int(parts[6])
    b.center_mass = int(parts[7])
    b.n_left = int(parts[8])
    b.n_right = int(parts[9])
    b.n_total = int(parts[10])
    for x in b.repeat:
        if x not in "ATCG":
            raise SystemExit(
                "Error reading loci bed file. Expected DNA (ATCG only) in the "
                f"4th field, and got an unexpected character on line: {line}"
            )
    assert b.left <= b.right, line
    assert b.left_most <= b.right_most, line
    return b


def parse_bounds(path: str, targets) -> list[Bounds]:
    """cluster.nim:166-169."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            out.append(parse_boundsline(line.rstrip("\n"), targets))
    return out
