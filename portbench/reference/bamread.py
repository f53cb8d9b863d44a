"""A plain BAM decoder: BGZF blocks inflated by Python's zlib in threads,
records located by their block sizes and their fields gathered with NumPy.

`read_bam(path)` returns the header text, the reference names and lengths,
and column arrays of every record in file order.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEQ_NT16 = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
FIXED = np.dtype([("ref", "<i4"), ("pos", "<i4"), ("lrn", "u1"),
                  ("mapq", "u1"), ("bin", "<u2"), ("ncig", "<u2"),
                  ("flag", "<u2"), ("lseq", "<i4"), ("nref", "<i4"),
                  ("npos", "<i4"), ("tlen", "<i4")])


def _inflate(raw: bytes) -> bytes:
    return zlib.decompress(raw, -15)


def inflate_bgzf(path: str, threads: int = 8) -> bytes:
    with open(path, "rb") as fh:
        data = fh.read()
    spans = []
    off = 0
    while off < len(data):
        bsize = struct.unpack_from("<H", data, off + 16)[0] + 1
        spans.append((off + 18, off + bsize - 8))
        off += bsize
    with ThreadPoolExecutor(max_workers=threads) as pool:
        parts = list(pool.map(_inflate, (data[a:b] for a, b in spans),
                              chunksize=64))
    return b"".join(parts)


class Records:
    """Column arrays of a BAM's records; `seq(rows)` decodes bases."""

    def __init__(self, buf: np.ndarray, offs: np.ndarray):
        self.buf = buf
        self.offs = offs
        fx = buf[(offs[:, None] + 4 + np.arange(32)).ravel()].reshape(-1, 32)
        f = fx.copy().view(FIXED).reshape(-1)
        self.tid = f["ref"].astype(np.int64)
        self.pos = f["pos"].astype(np.int64)
        self.mapq = f["mapq"].astype(np.int64)
        self.flag = f["flag"].astype(np.int64)
        self.mtid = f["nref"].astype(np.int64)
        self.mpos = f["npos"].astype(np.int64)
        self.tlen = f["tlen"].astype(np.int64)
        self.lseq = f["lseq"].astype(np.int64)
        self.lrn = f["lrn"].astype(np.int64)
        self.ncig = f["ncig"].astype(np.int64)
        self.name_at = offs + 36
        self.cig_at = self.name_at + self.lrn
        self.seq_at = self.cig_at + 4 * self.ncig
        self._cigar()

    def __len__(self):
        return len(self.offs)

    def _u32(self, at: np.ndarray) -> np.ndarray:
        b = self.buf[(at[:, None] + np.arange(4)).ravel()].reshape(-1, 4)
        return b.copy().view("<u4").reshape(-1).astype(np.int64)

    def _cigar(self):
        n = len(self)
        self.first_op = np.full(n, -1, np.int64)
        self.first_len = np.zeros(n, np.int64)
        self.lclip = np.zeros(n, np.int64)
        self.rclip = np.zeros(n, np.int64)
        ref_len = np.zeros(n, np.int64)
        last_op = np.full(n, -1, np.int64)
        last_len = np.zeros(n, np.int64)
        for j in range(int(self.ncig.max(initial=0))):
            m = np.flatnonzero(self.ncig > j)
            w = self._u32(self.cig_at[m] + 4 * j)
            op, ln = w & 0xF, w >> 4
            if j == 0:
                self.first_op[m] = op
                self.first_len[m] = ln
            ref_len[m] += np.where(np.isin(op, (0, 2, 3, 7, 8)), ln, 0)
            last_op[m] = op
            last_len[m] = ln
        self.lclip = np.where(self.first_op == 4, self.first_len, 0)
        self.rclip = np.where((last_op == 4) & (self.ncig > 1), last_len, 0)
        # bam_endpos: one past the start for an unmapped or CIGAR-less
        # record, else the start plus the reference span (at least 1)
        unplaced = ((self.flag & 4) != 0) | (self.ncig == 0)
        self.end_pos = np.where(unplaced, self.pos + 1,
                                self.pos + np.maximum(ref_len, 1))

    def names(self, rows: np.ndarray) -> list[bytes]:
        out = []
        for r in rows.tolist():
            a = int(self.name_at[r])
            out.append(self.buf[a:a + int(self.lrn[r]) - 1].tobytes())
        return out

    def name_hash(self) -> np.ndarray:
        """A 64-bit hash of every record's name (pairs share theirs): its
        length and its bytes, eight at a time."""
        ln = self.lrn - 1
        width = int(ln.max(initial=0))
        words = (width + 7) // 8
        h = ln.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        for w in range(words):
            at = self.name_at[:, None] + 8 * w + np.arange(8)
            byte = self.buf[np.minimum(at, len(self.buf) - 1)]
            byte = np.where(8 * w + np.arange(8)[None, :] < ln[:, None], byte, 0)
            word = np.ascontiguousarray(byte).view("<u8").reshape(-1)
            h = (h ^ word) * np.uint64(0x100000001B3)
            h ^= h >> np.uint64(29)
        return h

    def seq(self, rows: np.ndarray, width: int) -> np.ndarray:
        """ASCII bases of `rows`, zero-padded or cut to `width`."""
        rows = np.asarray(rows, np.int64)
        out = np.zeros((len(rows), width), np.uint8)
        if len(rows) == 0:
            return out
        nb = (width + 1) // 2
        at = self.seq_at[rows]
        packed = self.buf[np.minimum(at[:, None] + np.arange(nb),
                                     len(self.buf) - 1)]
        hi = SEQ_NT16[packed >> 4]
        lo = SEQ_NT16[packed & 15]
        full = np.empty((len(rows), 2 * nb), np.uint8)
        full[:, 0::2] = hi
        full[:, 1::2] = lo
        ln = np.minimum(self.lseq[rows], width)
        keep = np.arange(width)[None, :] < ln[:, None]
        out[:] = np.where(keep, full[:, :width], 0)
        return out


def read_bam(path: str, threads: int = 8):
    raw = inflate_bgzf(path, threads)
    if raw[:4] != b"BAM\x01":
        raise ValueError(f"{path} is not a BAM file")
    l_text = struct.unpack_from("<i", raw, 4)[0]
    text = raw[8:8 + l_text].split(b"\x00")[0].decode()
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        ln = struct.unpack_from("<i", raw, off)[0]
        name = raw[off + 4:off + 4 + ln - 1].decode()
        off += 4 + ln
        refs.append((name, struct.unpack_from("<i", raw, off)[0]))
        off += 4
    offs = []
    n = len(raw)
    unpack = struct.Struct("<i").unpack_from
    append = offs.append
    while off < n:
        append(off)
        off += 4 + unpack(raw, off)[0]
    buf = np.frombuffer(raw, np.uint8)
    return text, refs, Records(buf, np.array(offs, np.int64))
