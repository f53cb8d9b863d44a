"""A vectorised BAM writer: records assembled in NumPy a chunk at a time
(`assemble`), each chunk cut into BGZF blocks (`deflate_blocks`, which
worker processes can run side by side), and the BAI built from the records'
virtual offsets (`BgzfFile`, `write_bai`).

Records come in coordinate order as column arrays. Every block of a chunk
holds `BLOCK` uncompressed bytes (its last one fewer), so a record's virtual
offset follows from its offset in its chunk and the blocks' compressed
sizes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

BLOCK = 65280
EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
HDR_DT = np.dtype([("bs", "<i4"), ("ref", "<i4"), ("pos", "<i4"),
                   ("lrn", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                   ("ncig", "<u2"), ("flag", "<u2"), ("lseq", "<i4"),
                   ("nref", "<i4"), ("npos", "<i4"), ("tlen", "<i4")])
CIGAR_OPS = b"MIDNSHP=X"
NT16 = np.full(256, 15, np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    NT16[_c] = _i


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """SAM spec reg2bin over [beg, end), vectorised."""
    beg = np.asarray(beg, np.int64)
    e = np.asarray(end, np.int64) - 1
    out = np.zeros(len(beg), np.int64)
    for sh, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        same = (beg >> sh) == (e >> sh)
        out = np.where(same, off + (beg >> sh), out)
    return out


def _deflate(raw, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    data = c.compress(raw) + c.flush()
    bsize = 18 + len(data) + 8 - 1
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
            + struct.pack("<H", bsize) + data
            + struct.pack("<II", zlib.crc32(raw) & 0xFFFFFFFF, len(raw)))


def cigar_strings(ncig, ops, lens) -> tuple[np.ndarray, list[bytes]]:
    """(index into a table, the table) of each record's CIGAR string (up to
    3 operations of at most 2**16 - 1 bases)."""
    ops = ops.astype(np.int64)
    lens = lens.astype(np.int64)
    key = (ncig.astype(np.int64) | ops[:, 0] << 2 | ops[:, 1] << 6
           | ops[:, 2] << 10 | lens[:, 0] << 14 | lens[:, 1] << 30
           | lens[:, 2] << 46)
    uniq, inv = np.unique(key, return_inverse=True)
    table = []
    for k in uniq.tolist():
        n = k & 3
        parts = [(k >> (14 + 16 * j)) & 0xFFFF for j in range(3)]
        opc = [(k >> (2 + 4 * j)) & 0xF for j in range(3)]
        table.append(b"".join(b"%d%c" % (parts[j], CIGAR_OPS[opc[j]])
                              for j in range(n)) or b"*")
    return inv.reshape(-1), table


def assemble(c: dict, seq: np.ndarray, qual: np.ndarray, names: np.ndarray,
             mc_idx: np.ndarray, mc_table: list[bytes], rg: bytes):
    """The bytes of records, in order, and each record's offset in them.
    `c` holds per-record columns: tid, pos, end (reference end, exclusive),
    mapq, flag, mtid, mpos, tlen, ncig, ops [n, 3], lens [n, 3], mq (the
    mate's MAPQ), nm, as_, mate_mapped, mapped. `seq` and `qual` are [n, L] (ASCII bases,
    phred values), `names` [n, l] bytes with the trailing NUL, `mc_idx`
    each record's mate CIGAR in `mc_table`.

    Every record is laid out in one row of a matrix with a slot of
    fixed width for each field (the CIGAR's 3 operations, the MC tag's
    longest string); the bytes a record does not use are masked, and
    the masked matrix, read row by row, is the records' bytes."""
    n, L = seq.shape
    lrn = names.shape[1]
    ncig = c["ncig"].astype(np.int64)
    mate_mapped = c["mate_mapped"]
    mapped = c["mapped"]
    mc_len = np.array([len(s) for s in mc_table], np.int64)[mc_idx]
    mcw = max(len(s) for s in mc_table) + 1
    rgtag = b"RGZ" + rg + b"\x00"
    widths = [("hdr", 36), ("name", lrn), ("cig", 12), ("seq", (L + 1) // 2),
              ("qual", L), ("rg", len(rgtag)), ("mc", 3 + mcw), ("mq", 4),
              ("as", 4), ("nm", 4)]
    col = {}
    at = 0
    for name, w in widths:
        col[name] = (at, at + w)
        at += w
    B = np.zeros((n, at), np.uint8)
    mask = np.ones((n, at), bool)

    def put(name, rows):
        a, b = col[name]
        B[:, a:b] = rows

    def valid(name, nbytes):
        a, b = col[name]
        mask[:, a:b] = np.arange(b - a)[None, :] < np.asarray(nbytes)[:, None]

    put("name", names)
    words = ((c["lens"].astype(np.uint32) << 4)
                 | c["ops"].astype(np.uint32)).astype("<u4")
    put("cig", words.view(np.uint8).reshape(n, 12))
    valid("cig", 4 * ncig)
    nib = NT16[seq]
    if L % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
    put("seq", (nib[:, 0::2] << 4) | nib[:, 1::2])
    put("qual", qual)
    put("rg", np.frombuffer(rgtag, np.uint8)[None, :])
    tbl = np.zeros((len(mc_table), mcw), np.uint8)
    for i, s in enumerate(mc_table):
        tbl[i, :len(s)] = np.frombuffer(s, np.uint8)
    a, _ = col["mc"]
    B[:, a:a + 3] = np.frombuffer(b"MCZ", np.uint8)
    B[:, a + 3:a + 3 + mcw] = tbl[mc_idx]
    valid("mc", np.where(mate_mapped, 3 + mc_len + 1, 0))
    a, _ = col["mq"]
    B[:, a:a + 3] = np.frombuffer(b"MQC", np.uint8)
    B[:, a + 3] = c["mq"]
    valid("mq", np.where(mate_mapped, 4, 0))
    a, _ = col["as"]
    B[:, a:a + 3] = np.frombuffer(b"ASC", np.uint8)
    B[:, a + 3] = c["as_"]
    a, _ = col["nm"]
    B[:, a:a + 3] = np.frombuffer(b"NMC", np.uint8)
    B[:, a + 3] = c["nm"]
    valid("nm", np.where(mapped, 4, 0))
    reclen = mask.sum(axis=1)

    h = np.zeros(n, HDR_DT)
    h["bs"] = reclen - 4
    h["ref"] = c["tid"]
    h["pos"] = c["pos"]
    h["lrn"] = lrn
    h["mapq"] = c["mapq"]
    h["bin"] = reg2bin(c["pos"], np.maximum(c["end"], c["pos"] + 1))
    h["ncig"] = ncig
    h["flag"] = c["flag"]
    h["lseq"] = L
    h["nref"] = c["mtid"]
    h["npos"] = c["mpos"]
    h["tlen"] = c["tlen"]
    put("hdr", h.view(np.uint8).reshape(n, 36))
    starts = np.zeros(n, np.int64)
    np.cumsum(reclen[:-1], out=starts[1:])
    return B[mask].tobytes(), starts



def deflate_blocks(data: bytes, level: int) -> list[bytes]:
    """BGZF blocks of `data`, BLOCK uncompressed bytes each (the last one
    fewer)."""
    mv = memoryview(data)
    return [_deflate(mv[a:a + BLOCK], level) for a in range(0, len(data), BLOCK)]


class BgzfFile:
    """A BAM file written a chunk of records at a time, each chunk already
    cut into blocks; `close()` adds the EOF block and writes the BAI."""

    def __init__(self, path: str, header_text: str, refs: list[tuple[str, int]],
                 level: int):
        self.path = path
        self.refs = refs
        self.fh = open(path, "wb")
        self.coff = 0
        self.vstart, self.cols = [], []
        ht = header_text.encode()
        hdr = bytearray(b"BAM\x01" + struct.pack("<i", len(ht)) + ht
                        + struct.pack("<i", len(refs)))
        for name, ln in refs:
            nb = name.encode() + b"\x00"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        self._write(deflate_blocks(bytes(hdr), level))

    def _write(self, blocks: list[bytes]) -> np.ndarray:
        """Write blocks; return the compressed offset of each block."""
        sizes = np.array([len(b) for b in blocks], np.int64)
        at = self.coff + np.concatenate([[0], np.cumsum(sizes)[:-1]]) if len(blocks) else sizes
        self.fh.write(b"".join(blocks))
        self.coff += int(sizes.sum())
        return at

    def add(self, blocks: list[bytes], starts: np.ndarray, tid, beg, end):
        """A chunk: its blocks, its records' offsets in its uncompressed
        bytes and their tid, start and end."""
        at = self._write(blocks)
        self.vstart.append(((at[starts // BLOCK] << 16) | (starts % BLOCK))
                           .astype(np.uint64))
        self.cols.append((np.asarray(tid, np.int32), np.asarray(beg, np.int64),
                          np.asarray(end, np.int64)))

    def close(self) -> int:
        """Finish the file and write `<path>.bai`; returns the bytes written."""
        self.fh.write(EOF_BLOCK)
        self.fh.close()
        vstart = np.concatenate(self.vstart) if self.vstart else np.zeros(0, np.uint64)
        vend = np.append(vstart[1:], np.uint64(self.coff << 16))
        tid, beg, end = (np.concatenate([c[i] for c in self.cols]) for i in range(3))
        return self.coff + len(EOF_BLOCK) + write_bai(
            self.path + ".bai", len(self.refs), tid, beg, end, vstart, vend)


def write_bai(path, n_ref, tid, beg, end, vstart, vend) -> int:
    """The BAI of records in coordinate order: a chunk per run of
    consecutive records that share a bin, and the 16 kb linear index with
    empty windows filled from the window before."""
    out = bytearray(b"BAI\x01" + struct.pack("<i", n_ref))
    bins = reg2bin(beg, end)
    for t in range(n_ref):
        m = np.flatnonzero(tid == t)
        if len(m) == 0:
            out += struct.pack("<ii", 0, 0)
            continue
        b = bins[m]
        brk = np.flatnonzero(np.diff(b) != 0) + 1
        run_s = np.concatenate([[0], brk])
        run_e = np.concatenate([brk, [len(m)]]) - 1
        run_bin = b[run_s]
        cs = vstart[m][run_s]
        ce = vend[m][run_e]
        order = np.argsort(run_bin, kind="stable")
        ub, first = np.unique(run_bin[order], return_index=True)
        out += struct.pack("<i", len(ub))
        bounds = np.append(first, len(order))
        for j, bn in enumerate(ub):
            sel = order[bounds[j]:bounds[j + 1]]
            out += struct.pack("<Ii", int(bn), len(sel))
            out += np.stack([cs[sel], ce[sel]], axis=1).astype("<u8").tobytes()
        w0 = beg[m] >> 14
        w1 = (end[m] - 1) >> 14
        n_intv = int(w1.max()) + 1
        lin = np.full(n_intv, np.iinfo(np.uint64).max, np.uint64)
        for d in range(int((w1 - w0).max()) + 1):
            ok = w0 + d <= w1
            np.minimum.at(lin, (w0 + d)[ok], vstart[m][ok])
        empty = lin == np.iinfo(np.uint64).max
        lin[empty] = 0
        idx = np.where(empty, 0, np.arange(n_intv))
        np.maximum.accumulate(idx, out=idx)
        lin = np.where(empty & (idx > 0), lin[idx], lin)
        out += struct.pack("<i", n_intv) + lin.astype("<u8").tobytes()
    out += struct.pack("<Q", int((tid < 0).sum()))
    with open(path, "wb") as fh:
        fh.write(out)
    return len(out)
