"""The plain reference of `strling extract`: the bin that STRling's extract
(extract.nim:250-350) writes for a BAM, the `.str` bed that `-g` names and
the options, computed without the program.

- The fragment-length histogram: insert sizes of primary proper pairs with
  0 <= TLEN < 4096, the first 2,000,001 of them after the first 100,000
  records (utils.nim:86-111; the records of the skip window when none
  follow), and its median (utils.nim:139-146).
- Each primary record becomes a tread (extract.nim:63-87): a record with one
  M operation that overlaps no `.str` region of a contig the bed names keeps
  no unit; every other one gets the detector's unit and count on its bases
  (`detector.detect`, at the proportion). Soft clips of at least 2 bases of
  records with MAPQ >= min_mapq are scanned at min(p, 0.6) (read after its
  mate) and p - 0.07 (read before it).
- The mate cache (extract.nim:192-248) runs over the records that can emit
  anything (a count above 0, or a clip with one), and over every record that
  shares a name with one, in the order extract reads them: the file, then
  the block of unplaced records once more (extract.nim:308, 326).

`reference_extract(...)` returns the expected bin (head bytes, treads,
histogram) and `compare_bin` the numbers `correct` rests on (extract.nim:331-348,
cluster.nim:38-50; the msgpack encoding of msgpack4nim).
"""

from __future__ import annotations

import struct
import time

import numpy as np

from portbench.reference import detector
from portbench.reference.bamread import read_bam

FLAG_PROPER, FLAG_REVERSE, FLAG_MREVERSE = 0x2, 0x10, 0x20
SOFT_LEFT, SOFT_RIGHT, SOFT_NONE, SOFT_NONE_RIGHT, SOFT_NONE_LEFT = 0, 1, 3, 4, 5
VERSION = b"0.6.0"
NBINS = 4096
U32 = 1 << 32
DEC = "ACTG"
COMP = {"A": "T", "T": "A", "C": "G", "G": "C"}


# ------------------------------------------------------------ unit helpers

def _enc(s: str) -> int:
    v = 0
    for c in s:
        v = (v << 2) | ((ord(c) >> 1) & 3)
    return v


def _dec(v: int, k: int) -> str:
    return "".join(DEC[(v >> (2 * (k - 1 - i))) & 3] for i in range(k))


def min_rev_complement(s: str) -> str:
    """The smallest rotation, by 2-bit code (A<C<T<G), of the reverse
    complement (utils.nim:61-80)."""
    if not s:
        return s
    rc = "".join(COMP.get(c, c) for c in s)[::-1]
    return _dec(min(_enc(rc[i:] + rc[:i]) for i in range(len(rc))), len(rc))


def canonical_repeat(s: str) -> str:
    """utils.nim:304-316: the min rotation of the reverse complement when it
    sorts before the unit as a NUL-padded 6-char array, else the unit."""
    if not s:
        return s
    cand = min_rev_complement(s)
    return cand if cand.encode().ljust(6, b"\0") < s.encode().ljust(6, b"\0") else s


# -------------------------------------------------------- fragment lengths

def fragment_histogram(R, n_reads: int = 2_000_000, skip: int = 100_000):
    ok = (((R.flag & FLAG_PROPER) != 0) & ((R.flag & 0x900) == 0)
          & (R.tlen >= 0) & (R.tlen < NBINS))
    idx = np.arange(len(R))
    counted = np.flatnonzero(ok & (idx >= skip))[: n_reads + 1]
    vals = R.tlen[counted] if len(counted) else R.tlen[ok & (idx < skip)]
    return np.bincount(vals, minlength=NBINS).astype(np.uint32)


def median(hist: np.ndarray, pct: float = 0.5) -> int:
    n = int(hist.sum())
    target = int(0.5 + n / (1.0 / pct))
    c = np.cumsum(hist.astype(np.int64))
    i = int(np.searchsorted(c, target))
    return NBINS if i >= NBINS else i


# ------------------------------------------------------------- the index

def read_bed(path: str):
    by: dict[str, list[tuple[int, int]]] = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or line.startswith("track "):
                continue
            p = line.rstrip("\n").split("\t")
            if len(p) >= 3:
                by.setdefault(p[0], []).append((int(p[1]), int(p[2])))
    out = {}
    for chrom, ivs in by.items():
        ivs.sort()
        s = np.array([a for a, _ in ivs], np.int64)
        pmax = np.maximum.accumulate(np.array([b for _, b in ivs], np.int64))
        out[chrom] = (s, pmax)
    return out


def overlaps(index, chrom: str, starts, stops) -> np.ndarray:
    """Does [start, stop) overlap a region (start < stop' and stop > start')?"""
    s, pmax = index[chrom]
    j = np.searchsorted(s, stops, side="left")
    out = np.zeros(len(starts), bool)
    nz = j > 0
    out[nz] = pmax[j[nz] - 1] > starts[nz]
    return out


# --------------------------------------------------------------- treads

class T:
    __slots__ = ("tid", "pos", "rep", "flag", "split", "mapq", "count",
                 "alen", "qname")

    def __init__(self, tid, pos, rep, flag, split, mapq, count, alen, qname):
        self.tid, self.pos, self.rep, self.flag = tid, pos, rep, flag
        self.split, self.mapq, self.count, self.alen = split, mapq, count, alen
        self.qname = qname

    def p_repeat(self) -> float:
        # two uint8s multiplied: the product wraps at 256 (extract.nim:56-58)
        return ((self.count * len(self.rep)) % 256) / max(1, self.alen)

    def row(self):
        return (self.tid, self.pos, self.rep, self.flag, self.split,
                self.mapq, self.count, self.alen, self.qname)


def _unplaced_pair(a: T, b: T, p: float, mq: int) -> bool:
    if a.p_repeat() > p and b.p_repeat() > p:
        return True
    if a.p_repeat() > p and b.mapq < mq:
        return True
    return b.p_repeat() > p and a.mapq < mq


def _adjust_by(a: T, b: T, p: float, mq: int, median_len: int,
               b_position: int) -> bool:
    """extract.nim:141-179: move A by its mate B; whether to keep A."""
    if a.count == 0:
        return False
    if b.mapq > mq and ((a.p_repeat() > p and b.p_repeat() < 0.2)
                        or (not (a.flag & FLAG_PROPER) and a.mapq < mq)):
        half = int(a.alen / 2.0 + 0.5)
        if b.flag & FLAG_REVERSE:
            a.pos = (b_position - median_len + b.alen + half) % U32
            if b.split == SOFT_NONE_LEFT:
                a.pos = b_position
        else:
            a.pos = (b_position + median_len - half) % U32
            if b.split == SOFT_NONE_RIGHT:
                a.pos = (b_position + b.alen) % U32
        a.split = SOFT_NONE
        a.tid = b.tid
        a.mapq = max(a.mapq, b.mapq)
        if bool(a.flag & FLAG_REVERSE) == bool(a.flag & FLAG_MREVERSE):
            a.rep = min_rev_complement(a.rep)
    elif a.mapq >= mq or (a.flag & FLAG_PROPER):
        a.pos = (a.pos + int(a.alen / 2.0 + 0.5)) % U32
        a.mapq = max(a.mapq, b.mapq)
    return True


def _units(unit: np.ndarray, ulen: np.ndarray) -> list[str]:
    return [bytes(unit[i, :ulen[i]]).decode() for i in range(len(ulen))]


def reference_treads(R, index, p: float, mq: int, median_len: int, device,
                     width: int = 256, greedy: bool = True):
    """The treads extract emits, in its order, as tuples."""
    n = len(R)
    keep = (R.flag & 0x900) == 0
    exact = keep & (R.ncig == 1) & (R.first_op == 0)
    fast = np.zeros(n, bool)
    for tid in np.unique(R.tid[exact]):
        if tid < 0:
            continue
        chrom = R.ref_names[tid]
        if chrom not in index:
            continue
        m = np.flatnonzero(exact & (R.tid == tid))
        fast[m[~overlaps(index, chrom, R.pos[m], R.end_pos[m])]] = True
    W = min(width, int(R.lseq.max(initial=1)))
    alen = np.minimum(R.lseq, W)
    scan = np.flatnonzero(keep & ~fast)
    unit = np.zeros((n, 6), np.uint8)
    ulen = np.zeros(n, np.int64)
    count = np.zeros(n, np.int64)
    if len(scan):
        u, ul, c = detector.detect(R.seq(scan, W), alen[scan],
                                   np.full(len(scan), p), device, greedy)
        unit[scan], ulen[scan], count[scan] = u, ul, c
    # soft clips: (record, side) -> (unit, count) for each proportion
    clips = {}
    mq_ok = keep & (R.mapq >= mq)
    for side, cl in (("l", R.lclip), ("r", R.rclip)):
        rows = np.flatnonzero(mq_ok & (cl >= 2))
        if not len(rows):
            continue
        slen = np.minimum(cl[rows], W)
        full = R.seq(rows, W)
        cw = int(slen.max())
        col = np.arange(cw)[None, :]
        src = col if side == "l" else (alen[rows] - slen)[:, None] + col
        sub = np.where(col < slen[:, None],
                       np.take_along_axis(full, np.minimum(src, W - 1), 1), 0)
        sub = sub.astype(np.uint8)
        res = []
        for prop in (min(p, 0.6), p - 0.07):
            u, ul, c = detector.detect(sub, slen, np.full(len(rows), prop),
                                       device, greedy)
            res.append((_units(u, ul), c))
        for j, r in enumerate(rows.tolist()):
            clips[(r, side)] = (res[0][0][j], int(res[0][1][j]),
                                res[1][0][j], int(res[1][1][j]))

    # the records that can emit, and every record that shares their name
    live = keep & (count > 0)
    for (r, _), (ua, ca, uf, cf) in clips.items():
        if ca or cf:
            live[r] = True
    h = R.name_hash()
    live_names = np.unique(h[live])
    relevant = keep & np.isin(h, live_names)
    noc = np.flatnonzero(R.tid < 0)
    order = np.concatenate([np.flatnonzero(relevant),
                            noc[relevant[noc]]])
    names = dict(zip(np.unique(order).tolist(),
                     R.names(np.unique(order))))
    ustr = {}

    def unit_of(r):
        if r not in ustr:
            ustr[r] = bytes(unit[r, :ulen[r]]).decode()
        return ustr[r]

    tbl: dict[bytes, T] = {}
    out: list[T] = []

    def add_soft(r: int, read_rep: str, first: bool):
        if R.mapq[r] < mq:
            return
        for side, cl, left in (("l", int(R.lclip[r]), True),
                               ("r", int(R.rclip[r]), False)):
            if cl == 0 or (read_rep == "" and cl <= 16):
                continue
            res = clips.get((r, side))
            if res is None:
                continue
            u, c = (res[2], res[3]) if first else (res[0], res[1])
            if c == 0:
                continue
            pos = max(0, int(R.pos[r])) if left else max(0, int(R.end_pos[r]))
            t = T(int(R.tid[r]), pos, u, int(R.flag[r]),
                  SOFT_LEFT if left else SOFT_RIGHT, int(R.mapq[r]), c,
                  cl & 0xFF, names[r])
            if t.p_repeat() < 0.9:
                continue
            out.append(t)

    for r in order.tolist():
        q = names[r]
        tid, pos = int(R.tid[r]), int(R.pos[r])
        if fast[r]:
            rep, c, al = "", 0, int(R.first_len[r])
        else:
            rep, c, al = unit_of(r), int(count[r]), int(alen[r])
        if c >= 256:
            raise AssertionError("a repeat count of 256 or more stops extract")
        split = SOFT_NONE
        if R.ncig[r] > 1:
            if R.lclip[r] > 16:
                split = SOFT_NONE_LEFT
            if R.rclip[r] > 16:
                split = SOFT_NONE_RIGHT
        tr = T(tid, max(0, pos), rep, int(R.flag[r]), split, int(R.mapq[r]),
               c, al & 0xFF, q)
        mtid, mpos = int(R.mtid[r]), int(R.mpos[r])
        after = tid > mtid or (tid == mtid and (pos > mpos or
                                                (pos == mpos and q in tbl)))
        if after:
            mate = tbl.pop(q, None)
            if mate is None:
                continue
            add_soft(r, tr.rep, first=False)
            if mate.count == 0 and tr.count == 0:
                continue
            if _unplaced_pair(tr, mate, p, mq):
                if tr.rep == "" or mate.rep == "":
                    continue
                for t in (tr, mate):
                    t.rep = canonical_repeat(t.rep)
                    t.pos, t.tid = 0, -1
                out.append(tr)
                out.append(mate)
                continue
            mp = mate.pos
            if _adjust_by(mate, tr, p, mq, median_len, tr.pos):
                out.append(mate)
            if _adjust_by(tr, mate, p, mq, median_len, mp):
                out.append(tr)
        else:
            add_soft(r, tr.rep, first=True)
            if q in tbl:
                del tbl[q]
            else:
                tbl[q] = tr
    return [t.row() for t in out]


# ------------------------------------------------------------- the bin

def _uint(out: bytearray, v: int):
    if v < 0x80:
        out.append(v)
    elif v < 0x100:
        out += bytes((0xCC, v))
    elif v < 0x10000:
        out += b"\xcd" + v.to_bytes(2, "big")
    elif v < 1 << 32:
        out += b"\xce" + v.to_bytes(4, "big")
    else:
        out += b"\xcf" + v.to_bytes(8, "big")


def _int(out: bytearray, v: int):
    if v >= 0:
        _uint(out, v)
    elif v >= -32:
        out.append(0x100 + v)
    elif v >= -(1 << 7):
        out += b"\xd0" + v.to_bytes(1, "big", signed=True)
    elif v >= -(1 << 15):
        out += b"\xd1" + v.to_bytes(2, "big", signed=True)
    else:
        out += b"\xd2" + v.to_bytes(4, "big", signed=True)


def tread_bytes(row) -> bytes:
    tid, pos, rep, flag, split, mapq, count, alen, qname = row
    out = bytearray()
    _int(out, tid)
    _uint(out, pos)
    out.append(0x96)
    r = rep.encode() if isinstance(rep, str) else rep
    for i in range(6):
        _uint(out, r[i] if i < len(r) else 0)
    for v in (flag, split, mapq, count, alen, len(qname)):
        _uint(out, v)
    n = len(qname)
    out += (bytes((0xA0 | n,)) if n < 32 else bytes((0xD9, n))) + qname
    return bytes(out)


def bin_head(hist, header_text: str, p: float, mq: int, n: int) -> bytes:
    ht = header_text.encode()
    return (b"STR" + struct.pack("<h", 0) + VERSION.ljust(9, b"\0")
            + struct.pack("<f", p) + struct.pack("<B", mq)
            + np.asarray(hist, "<u4").tobytes()
            + struct.pack("<i", len(ht)) + ht + struct.pack("<i", n))


def reference_extract(bam_path: str, bed_path: str, p: float, mq: int,
                      device, greedy: bool = True) -> dict:
    """The expected bin of `extract -g bed_path bam_path`: its head bytes,
    tread rows and histogram; `times` the seconds of its stages."""
    t0 = time.perf_counter()
    text, refs, R = read_bam(bam_path)
    R.ref_names = [n for n, _ in refs]
    t1 = time.perf_counter()
    hist = fragment_histogram(R)
    rows = reference_treads(R, read_bed(bed_path), p, mq, median(hist),
                            device, greedy=greedy)
    t2 = time.perf_counter()
    return {"head": bin_head(hist, text, p, mq, len(rows)), "rows": rows,
            "hist": hist, "n_records": len(R),
            "times": {"bam": t1 - t0, "treads": t2 - t1}}


# --------------------------------------------------------- the comparison

def _take_uint(buf, i):
    b = buf[i]
    if b < 0x80:
        return b, i + 1
    if b >= 0xE0:
        return b - 0x100, i + 1
    n = {0xCC: 1, 0xCD: 2, 0xCE: 4, 0xCF: 8, 0xD0: 1, 0xD1: 2, 0xD2: 4,
         0xD3: 8}[b]
    return int.from_bytes(buf[i + 1:i + 1 + n], "big", signed=b >= 0xD0), i + 1 + n


def parse_bin(buf: bytes):
    """(head bytes, histogram, tread rows) of a bin file's bytes."""
    off = 19 + 4 * NBINS
    hist = np.frombuffer(buf, "<u4", NBINS, 19)
    hl = struct.unpack_from("<i", buf, off)[0]
    off += 4 + hl + 4
    head = buf[:off]
    rows = []
    i = off
    while i < len(buf):
        tid, i = _take_uint(buf, i)
        pos, i = _take_uint(buf, i)
        i += 1
        rep = bytearray()
        for _ in range(6):
            c, i = _take_uint(buf, i)
            rep.append(c)
        vals = []
        for _ in range(6):
            v, i = _take_uint(buf, i)
            vals.append(v)
        tag = buf[i]
        n = tag & 0x1F if tag < 0xC0 else buf[i + 1]
        i += 1 if tag < 0xC0 else 2
        q = buf[i:i + n]
        i += n
        rows.append((tid, pos, bytes(rep).rstrip(b"\0").decode(), *vals[:5], q))
    return head, hist, rows


def compare_bin(got: bytes, ref: dict) -> dict:
    """The numbers `correct` rests on: treads that differ (by place, plus
    the difference in count), histogram bins that differ, and whether the
    head (format, options, header text, count) differs."""
    want = ref["head"] + b"".join(tread_bytes(r) for r in ref["rows"])
    if got == want:
        return {"treads_wrong": 0, "frag_bins_wrong": 0, "head_wrong": 0}
    try:
        head, hist, rows = parse_bin(got)
    except (IndexError, KeyError, struct.error, ValueError):
        return {"treads_wrong": len(ref["rows"]) or 1,
                "frag_bins_wrong": NBINS, "head_wrong": 1}
    want_rows = ref["rows"]
    diff = sum(1 for a, b in zip(rows, want_rows) if tuple(a) != tuple(b))
    diff += abs(len(rows) - len(want_rows))
    return {"treads_wrong": diff,
            "frag_bins_wrong": int((hist != ref["hist"]).sum()),
            "head_wrong": int(head != ref["head"])}
