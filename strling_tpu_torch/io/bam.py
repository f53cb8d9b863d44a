"""BAM reading via the native strling_io library (ctypes).

Batch-oriented: every iterator yields ReadBatch objects — fixed-shape numpy
arrays ready to feed the device kernels (sequences as ASCII uint8 [B, Lmax])
plus variable-length qname/cigar sidecars for host-side logic.

Plays the role of hts-nim's Bam in the reference (SURVEY.md §2 ledger items
1,3): sequential iteration, BAI region queries, and the "*" no-coor query
(extract.nim:326, collect.nim:139).
"""

from __future__ import annotations

import ctypes as C
from dataclasses import dataclass

import numpy as np

from strling_tpu_torch.io.hostlib import lib_path

_lib = None


def _load():
    global _lib
    if _lib is None:
        _lib = C.CDLL(lib_path())
        _lib.sio_open.restype = C.c_void_p
        _lib.sio_open.argtypes = [C.c_char_p]
        _lib.sio_set_fasta.argtypes = [C.c_void_p, C.c_char_p]
        _lib.sio_rans_decode.restype = C.c_int64
        _lib.sio_rans_decode.argtypes = [
            C.c_char_p, C.c_int64, np.ctypeslib.ndpointer(np.uint8), C.c_int64,
        ]
        _lib.sio_rans_nx16_decode.restype = C.c_int64
        _lib.sio_rans_nx16_decode.argtypes = [
            C.c_char_p, C.c_int64, C.c_int64,
            np.ctypeslib.ndpointer(np.uint8), C.c_int64,
        ]
        _lib.sio_tok3_decode.restype = C.c_int64
        _lib.sio_tok3_decode.argtypes = [
            C.c_char_p, C.c_int64, C.c_int64,
            np.ctypeslib.ndpointer(np.uint8), C.c_int64,
        ]
        _lib.sio_arith_decode.restype = C.c_int64
        _lib.sio_arith_decode.argtypes = [
            C.c_char_p, C.c_int64, C.c_int64,
            np.ctypeslib.ndpointer(np.uint8), C.c_int64,
        ]
        _lib.sio_fqz_decode.restype = C.c_int64
        _lib.sio_fqz_decode.argtypes = [
            C.c_char_p, C.c_int64, C.c_int64,
            np.ctypeslib.ndpointer(np.uint8), C.c_int64,
        ]
        _lib.sio_close.argtypes = [C.c_void_p]
        _lib.sio_nrefs.argtypes = [C.c_void_p]
        _lib.sio_ref_len.restype = C.c_int64
        _lib.sio_ref_len.argtypes = [C.c_void_p, C.c_int]
        _lib.sio_ref_name.argtypes = [C.c_void_p, C.c_int, C.c_char_p, C.c_int]
        _lib.sio_header_text.restype = C.c_int64
        _lib.sio_header_text.argtypes = [C.c_void_p, C.c_char_p, C.c_int64]
        _lib.sio_has_index.argtypes = [C.c_void_p]
        _lib.sio_begin.argtypes = [C.c_void_p, C.c_int, C.c_int, C.c_int64, C.c_int64]
        _lib.sio_error.restype = C.c_char_p
        _lib.sio_error.argtypes = [C.c_void_p]
        P = np.ctypeslib.ndpointer
        _lib.sio_next_batch.restype = C.c_int64
        _lib.sio_next_batch.argtypes = [
            C.c_void_p, C.c_int64, C.c_int,
            P(np.int32), P(np.int32), P(np.uint16), P(np.uint8),
            P(np.int32), P(np.int32), P(np.int32),
            P(np.int32), P(np.int32), P(np.int32), P(np.int32),
            P(np.int32), P(np.int32),
            P(np.uint8), P(np.uint32), C.c_int64, P(np.int64),
            C.c_char_p, C.c_int64, P(np.int64),
        ]
    return _lib


@dataclass
class Target:
    tid: int
    name: str
    length: int

    def __eq__(self, other):  # unpack.nim:12-13
        return (
            self.tid == other.tid
            and self.length == other.length
            and self.name == other.name
        )


@dataclass
class ReadBatch:
    """A decoded batch of BAM records (structure-of-arrays)."""

    tid: np.ndarray        # int32 [B]
    pos: np.ndarray        # int32 [B] 0-based leftmost
    flag: np.ndarray       # uint16 [B]
    mapq: np.ndarray       # uint8 [B]
    mate_tid: np.ndarray   # int32 [B]
    mate_pos: np.ndarray   # int32 [B]
    isize: np.ndarray      # int32 [B]
    read_len: np.ndarray   # int32 [B]
    end_pos: np.ndarray    # int32 [B] htslib bam_endpos semantics
    lclip: np.ndarray      # int32 [B] leading soft-clip length
    rclip: np.ndarray      # int32 [B] trailing soft-clip length
    ins_sum: np.ndarray    # int32 [B] total I op length
    del_sum: np.ndarray    # int32 [B] total D op length
    seq: np.ndarray        # uint8 [B, Lmax] ASCII, zero-padded/truncated
    cigar: np.ndarray      # uint32 [sum n_cigar] packed len<<4|op
    cigar_off: np.ndarray  # int64 [B+1]
    qname_blob: bytes
    qname_off: np.ndarray  # int64 [B+1]

    def __len__(self) -> int:
        return len(self.tid)

    def qname(self, i: int) -> str:
        return self.qname_blob[self.qname_off[i]: self.qname_off[i + 1]].decode()

    def qnames(self) -> list[str]:
        off = self.qname_off
        return [self.qname_blob[off[i]: off[i + 1]].decode() for i in range(len(self))]

    def cigar_of(self, i: int) -> np.ndarray:
        return self.cigar[self.cigar_off[i]: self.cigar_off[i + 1]]

    def seq_str(self, i: int) -> str:
        L = min(self.read_len[i], self.seq.shape[1])
        return bytes(self.seq[i, :L]).decode()


CIGAR_OPS = "MIDNSHP=X"


class Bam:
    """A BAM file handle with batch iterators."""

    def __init__(self, path: str, Lmax: int = 256, batch_size: int = 8192,
                 fasta: str | None = None):
        self._lib = _load()
        self._h = self._lib.sio_open(path.encode())
        if not self._h:
            raise OSError(f"couldn't open bam/cram {path}")
        self.fasta = fasta
        if fasta:
            # required to decode reference-based CRAM; no-op for BAM
            if self._lib.sio_set_fasta(self._h, fasta.encode()) != 0:
                raise OSError(f"couldn't open reference fasta {fasta}")
        self.path = path
        self.Lmax = Lmax
        self.batch_size = batch_size
        n = self._lib.sio_nrefs(self._h)
        self.targets: list[Target] = []
        buf = C.create_string_buffer(4096)
        for i in range(n):
            self._lib.sio_ref_name(self._h, i, buf, 4096)
            self.targets.append(
                Target(tid=i, name=buf.value.decode(), length=int(self._lib.sio_ref_len(self._h, i)))
            )
        tlen = self._lib.sio_header_text(self._h, None, 0)
        hbuf = C.create_string_buffer(int(tlen) + 1)
        self._lib.sio_header_text(self._h, hbuf, tlen)
        self.header_text = hbuf.raw[:tlen].decode()

    def close(self):
        if self._h:
            self._lib.sio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def has_index(self) -> bool:
        return bool(self._lib.sio_has_index(self._h))

    def _batches(self, B=None):
        B, L = B or self.batch_size, self.Lmax
        lib = self._lib
        while True:
            tid = np.empty(B, np.int32); pos = np.empty(B, np.int32)
            flag = np.empty(B, np.uint16); mapq = np.empty(B, np.uint8)
            mate_tid = np.empty(B, np.int32); mate_pos = np.empty(B, np.int32)
            isize = np.empty(B, np.int32); read_len = np.empty(B, np.int32)
            end_pos = np.empty(B, np.int32)
            lclip = np.empty(B, np.int32); rclip = np.empty(B, np.int32)
            ins_sum = np.empty(B, np.int32); del_sum = np.empty(B, np.int32)
            seq = np.zeros((B, L), np.uint8)
            cigar_cap = B * 16 + 65536
            cigar = np.empty(cigar_cap, np.uint32)
            cigar_off = np.empty(B + 1, np.int64)
            qname_cap = B * 64 + 4096
            qname_buf = C.create_string_buffer(qname_cap)
            qname_off = np.empty(B + 1, np.int64)
            n = lib.sio_next_batch(
                self._h, B, L, tid, pos, flag, mapq, mate_tid, mate_pos, isize,
                read_len, end_pos, lclip, rclip, ins_sum, del_sum,
                seq.reshape(-1), cigar, cigar_cap, cigar_off,
                qname_buf, qname_cap, qname_off,
            )
            if n < 0:
                raise IOError(f"bam read error: {lib.sio_error(self._h).decode()}")
            if n == 0:
                return
            n = int(n)
            yield ReadBatch(
                tid=tid[:n], pos=pos[:n], flag=flag[:n], mapq=mapq[:n],
                mate_tid=mate_tid[:n], mate_pos=mate_pos[:n], isize=isize[:n],
                read_len=read_len[:n], end_pos=end_pos[:n], lclip=lclip[:n],
                rclip=rclip[:n], ins_sum=ins_sum[:n], del_sum=del_sum[:n],
                seq=seq[:n], cigar=cigar[: cigar_off[n]].copy(),
                cigar_off=cigar_off[: n + 1].copy(),
                qname_blob=qname_buf.raw[: qname_off[n]],
                qname_off=qname_off[: n + 1].copy(),
            )

    def _begin(self, mode: int, tid: int, beg: int, end: int):
        if self._lib.sio_begin(self._h, mode, tid, beg, end) != 0:
            raise IOError(self._lib.sio_error(self._h).decode())

    def batches(self):
        """Stream all records (including any trailing no-coor block)."""
        self._begin(0, -1, 0, 0)
        yield from self._batches()

    def query(self, tid: int, beg: int, end: int):
        """Records overlapping [beg, end) on tid, via the BAI/CRAI index."""
        self._begin(1, tid, beg, end)
        # window queries are small; full-size zeroed batch buffers would
        # cost more than the reads they carry (the seq plane is B x Lmax)
        yield from self._batches(B=min(self.batch_size, 2048))

    def query_unmapped(self):
        """The no-coor block — htslib's query("*") (extract.nim:326)."""
        self._begin(2, -1, 0, 0)
        yield from self._batches()
