"""Pure-Python BAM + BAI writer.

Used by tests and the read simulator (the environment has no samtools/bwa).
Not a performance path. Produces standard BGZF-compressed BAM v1.6 plus a
.bai index so the native reader's region queries work against it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
NT16_CODE = {c: i for i, c in enumerate(SEQ_NT16)}
#: byte -> its 4-bit code (15, N, for a byte outside SEQ_NT16)
NT16_TABLE = bytes(NT16_CODE.get(chr(b), 15) for b in range(256))
CIGAR_OPS = "MIDNSHP=X"


def bgzf_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 25 + 1
    assert bsize <= 65536
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", 6)
        + b"BC"
        + struct.pack("<H", 2)
        + struct.pack("<H", bsize - 1)
    )
    return header + cdata + struct.pack("<I", zlib.crc32(data)) + struct.pack(
        "<I", len(data)
    )


BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class BgzfWriter:
    def __init__(self, path: str):
        self.fh = open(path, "wb")
        self.buf = bytearray()
        # virtual-offset bookkeeping for BAI generation
        self.compressed_off = 0

    def tell_virtual(self) -> int:
        return (self.compressed_off << 16) | len(self.buf)

    def write(self, data: bytes):
        self.buf += data
        while len(self.buf) >= 60000:
            self._flush_block(self.buf[:60000])
            self.buf = self.buf[60000:]

    def _flush_block(self, data: bytes):
        blk = bgzf_block(bytes(data))
        self.fh.write(blk)
        self.compressed_off += len(blk)

    def close(self):
        if self.buf:
            self._flush_block(bytes(self.buf))
            self.buf = bytearray()
        self.fh.write(BGZF_EOF)
        self.fh.close()


def parse_cigar(cig: str) -> list[tuple[int, int]]:
    """'10S90M' -> [(10, S), (90, M)] with op as index into CIGAR_OPS."""
    if cig in ("*", ""):
        return []
    out = []
    num = ""
    for c in cig:
        if c.isdigit():
            num += c
        else:
            out.append((int(num), CIGAR_OPS.index(c)))
            num = ""
    return out


def ref_span(cigar: list[tuple[int, int]]) -> int:
    return sum(n for n, op in cigar if op in (0, 2, 3, 7, 8))


def reg2bin(beg: int, end: int) -> int:
    """SAM spec §5.3."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BamRecord:
    """Minimal alignment record for writing."""

    def __init__(self, qname, flag, tid, pos, mapq, cigar, mate_tid, mate_pos,
                 isize, seq, qual=None):
        self.qname = qname
        self.flag = flag
        self.tid = tid
        self.pos = pos
        self.mapq = mapq
        self.cigar = parse_cigar(cigar) if isinstance(cigar, str) else cigar
        self.mate_tid = mate_tid
        self.mate_pos = mate_pos
        self.isize = isize
        self.seq = seq
        self.qual = qual  # raw phred values (bytes/str of +33 ASCII), or None

    def encode(self) -> bytes:
        l_seq = len(self.seq)
        span = ref_span(self.cigar)
        end = self.pos + (span if span > 0 else 1)
        bin_ = reg2bin(self.pos, end) if self.tid >= 0 else 4680
        name = self.qname.encode() + b"\x00"
        rec = struct.pack(
            "<iiBBHHHIiii",
            self.tid, self.pos, len(name), self.mapq, bin_,
            len(self.cigar), self.flag, l_seq, self.mate_tid, self.mate_pos,
            self.isize,
        )
        rec += name
        for n, op in self.cigar:
            rec += struct.pack("<I", (n << 4) | op)
        rec += pack_seq(self.seq)
        rec += b"\xff" * l_seq  # qual 0xff == missing
        return struct.pack("<i", len(rec)) + rec


def pack_seq(seq: str) -> bytes:
    """A read's bases, two to a byte (the first in the high nibble), each as
    its index in SEQ_NT16 (15 for any other character: one byte a character
    through latin-1, '?' for those outside it)."""
    raw = seq.encode("latin-1", "replace").translate(NT16_TABLE)
    codes = np.frombuffer(raw + b"\0" * (len(seq) % 2), np.uint8)
    return ((codes[0::2] << 4) | codes[1::2]).tobytes()


def write_bam(path: str, header_text: str, targets: list[tuple[str, int]],
              records: list[BamRecord], write_index: bool = True):
    """Write a coordinate-sorted BAM (+ .bai). Records must be pre-sorted
    (mapped by (tid, pos); tid == -1 records last)."""
    w = BgzfWriter(path)
    htext = header_text.encode()
    w.write(b"BAM\x01" + struct.pack("<i", len(htext)) + htext)
    w.write(struct.pack("<i", len(targets)))
    for name, length in targets:
        nb = name.encode() + b"\x00"
        w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", length))

    # per-ref bin -> chunks, linear index
    bins: list[dict[int, list[list[int]]]] = [dict() for _ in targets]
    linear: list[dict[int, int]] = [dict() for _ in targets]
    n_no_coor = 0
    for r in records:
        voff_start = w.tell_virtual()
        w.write(r.encode())
        voff_end = w.tell_virtual()
        if r.tid < 0:
            n_no_coor += 1
            continue
        span = ref_span(r.cigar)
        end = r.pos + (span if span > 0 else 1)
        b = reg2bin(r.pos, end)
        chunks = bins[r.tid].setdefault(b, [])
        if chunks and chunks[-1][1] == voff_start:
            chunks[-1][1] = voff_end
        else:
            chunks.append([voff_start, voff_end])
        for win in range(r.pos >> 14, ((end - 1) >> 14) + 1):
            lin = linear[r.tid]
            if win not in lin or voff_start < lin[win]:
                lin[win] = voff_start
    w.close()

    if not write_index:
        return
    with open(path + ".bai", "wb") as f:
        f.write(b"BAI\x01" + struct.pack("<i", len(targets)))
        for t in range(len(targets)):
            f.write(struct.pack("<i", len(bins[t])))
            for b in sorted(bins[t]):
                chunks = bins[t][b]
                f.write(struct.pack("<Ii", b, len(chunks)))
                for beg, end in chunks:
                    f.write(struct.pack("<QQ", beg, end))
            if linear[t]:
                n_intv = max(linear[t]) + 1
                ioff = []
                prev = 0
                for i in range(n_intv):
                    if i in linear[t]:
                        prev = linear[t][i]
                    ioff.append(prev)
                f.write(struct.pack("<i", n_intv))
                for v in ioff:
                    f.write(struct.pack("<Q", v))
            else:
                f.write(struct.pack("<i", 0))
        f.write(struct.pack("<Q", n_no_coor))


def write_sam(path: str, header_text: str, targets: list[tuple[str, int]],
              records: list[BamRecord]):
    """Write records as plain-text SAM (the native reader auto-detects it)."""
    with open(path, "w") as f:
        f.write(header_text)
        if header_text and not header_text.endswith("\n"):
            f.write("\n")
        for r in records:
            rname = targets[r.tid][0] if r.tid >= 0 else "*"
            if r.mate_tid < 0:
                rnext = "*"
            elif r.mate_tid == r.tid:
                rnext = "="
            else:
                rnext = targets[r.mate_tid][0]
            cig = "".join(f"{n}{CIGAR_OPS[op]}" for n, op in r.cigar) or "*"
            f.write(
                f"{r.qname}\t{r.flag}\t{rname}\t{r.pos + 1}\t{r.mapq}\t{cig}"
                f"\t{rnext}\t{r.mate_pos + 1}\t{r.isize}\t{r.seq or '*'}\t*\n"
            )
