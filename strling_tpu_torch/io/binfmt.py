"""The "bin" evidence file — STRling's durable checkpoint artifact.

Byte-compatible with the reference's format so bins interoperate:
writer extract.nim:331-348 + cluster.nim:38-50 (msgpack4nim `pack_type`),
reader src/strpkg/unpack.nim:36-133.

Layout:
  "STR" | int16 fmt_version | 9-char software version | float32 proportion |
  uint8 min_mapq | uint32[4096] fragment-length histogram (raw LE) |
  int32 header_len | SAM header text | int32 n_reads |
  n_reads msgpack-encoded treads.

Each tread is a flat concatenation of minimally-encoded msgpack scalars (the
msgpack4nim convention: ints use the smallest representation, arrays are
fixarray, strings are str format), in field order:
  tid:int32, position:uint32, repeat:fixarray(6) of char, flag:uint16,
  split:uint8, mapq:uint8, repeat_count:uint8, align_length:uint8,
  qname_len:uint32, qname:str.
"""

from __future__ import annotations

import struct
import sys

import numpy as np

from strling_tpu_torch.io.bam import Target
from strling_tpu_torch.io.sam import parse_header_targets
from strling_tpu_torch.core.tread import TREAD_DTYPE, TreadBatch
from strling_tpu_torch.version import BIN_FMT_VERSION, STRLING_VERSION, as_array9

MAGIC = b"STR"


# ---------------------------------------------------------------- msgpack

def _pack_uint(out: bytearray, v: int):
    """msgpack4nim pack_imp_uint: minimal representation, big-endian."""
    if v < (1 << 7):
        out.append(v)
    elif v < (1 << 8):
        out.append(0xCC)
        out.append(v)
    elif v < (1 << 16):
        out.append(0xCD)
        out += v.to_bytes(2, "big")
    elif v < (1 << 32):
        out.append(0xCE)
        out += v.to_bytes(4, "big")
    else:
        out.append(0xCF)
        out += v.to_bytes(8, "big")


def _pack_int(out: bytearray, v: int):
    """msgpack4nim pack_imp_int: minimal representation."""
    if v >= 0:
        _pack_uint(out, v)
    elif v >= -32:
        out.append(0x100 + v)  # negative fixint
    elif v >= -(1 << 7):
        out.append(0xD0)
        out += v.to_bytes(1, "big", signed=True)
    elif v >= -(1 << 15):
        out.append(0xD1)
        out += v.to_bytes(2, "big", signed=True)
    elif v >= -(1 << 31):
        out.append(0xD2)
        out += v.to_bytes(4, "big", signed=True)
    else:
        out.append(0xD3)
        out += v.to_bytes(8, "big", signed=True)


def _pack_str(out: bytearray, s: bytes):
    n = len(s)
    if n < 32:
        out.append(0xA0 | n)
    elif n < 256:
        out.append(0xD9)
        out.append(n)
    elif n < (1 << 16):
        out.append(0xDA)
        out += n.to_bytes(2, "big")
    else:
        out.append(0xDB)
        out += n.to_bytes(4, "big")
    out += s


class _Unpacker:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)

    def take_int(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        p = self.pos
        if b == 0xCC:
            self.pos += 1
            return self.buf[p]
        if b == 0xCD:
            self.pos += 2
            return int.from_bytes(self.buf[p : p + 2], "big")
        if b == 0xCE:
            self.pos += 4
            return int.from_bytes(self.buf[p : p + 4], "big")
        if b == 0xCF:
            self.pos += 8
            return int.from_bytes(self.buf[p : p + 8], "big")
        if b == 0xD0:
            self.pos += 1
            return int.from_bytes(self.buf[p : p + 1], "big", signed=True)
        if b == 0xD1:
            self.pos += 2
            return int.from_bytes(self.buf[p : p + 2], "big", signed=True)
        if b == 0xD2:
            self.pos += 4
            return int.from_bytes(self.buf[p : p + 4], "big", signed=True)
        if b == 0xD3:
            self.pos += 8
            return int.from_bytes(self.buf[p : p + 8], "big", signed=True)
        raise ValueError(f"unexpected msgpack int tag 0x{b:02x}")

    def take_array_header(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        if 0x90 <= b <= 0x9F:
            return b & 0xF
        if b == 0xDC:
            n = int.from_bytes(self.buf[self.pos : self.pos + 2], "big")
            self.pos += 2
            return n
        raise ValueError(f"unexpected msgpack array tag 0x{b:02x}")

    def take_str(self) -> bytes:
        b = self.buf[self.pos]
        self.pos += 1
        if 0xA0 <= b <= 0xBF:
            n = b & 0x1F
        elif b == 0xD9:
            n = self.buf[self.pos]
            self.pos += 1
        elif b == 0xDA:
            n = int.from_bytes(self.buf[self.pos : self.pos + 2], "big")
            self.pos += 2
        elif b == 0xDB:
            n = int.from_bytes(self.buf[self.pos : self.pos + 4], "big")
            self.pos += 4
        else:
            raise ValueError(f"unexpected msgpack str tag 0x{b:02x}")
        s = self.buf[self.pos : self.pos + n]
        self.pos += n
        return s


def pack_tread(out: bytearray, tid, position, repeat6: bytes, flag, split,
               mapq, repeat_count, align_length, qname: bytes):
    """cluster.nim:38-50."""
    _pack_int(out, tid)
    _pack_uint(out, position)
    out.append(0x96)  # fixarray(6)
    for i in range(6):
        c = repeat6[i] if i < len(repeat6) else 0
        # chars are packed as uint8; DNA/NUL chars are < 128 => fixint
        _pack_uint(out, c)
    _pack_uint(out, flag)
    _pack_uint(out, split)
    _pack_uint(out, mapq)
    _pack_uint(out, repeat_count)
    _pack_uint(out, align_length)
    _pack_uint(out, len(qname))
    _pack_str(out, qname)


def unpack_tread(u: _Unpacker):
    tid = u.take_int()
    position = u.take_int()
    n = u.take_array_header()
    rep = bytes(bytearray(u.take_int() for _ in range(n)))
    rep = rep.rstrip(b"\x00")
    flag = u.take_int()
    split = u.take_int()
    mapq = u.take_int()
    repeat_count = u.take_int()
    align_length = u.take_int()
    L = u.take_int()
    # the writer always packs the string (cluster.nim:49-50); the reference
    # reader skips the unpack when L == 0 but qnames are never empty in
    # practice, so the str header is always present
    qname = u.take_str()
    assert len(qname) == L
    return (tid, position, rep, flag, split, mapq, repeat_count, align_length, qname)


# --------------------------------------------------------------- file level

def write_bin(path: str, treads: TreadBatch, frag_dist: np.ndarray,
              header_text: str, proportion_repeat: float, min_mapq: int,
              software_version: str = STRLING_VERSION, native: bool = True):
    """extract.nim:331-348. Uses the C++ codec when available (byte-identical
    to the Python path; tests enforce it)."""
    if native:
        try:
            _native_write_bin(
                path, treads, frag_dist, header_text, proportion_repeat,
                min_mapq, software_version,
            )
            return
        except OSError:
            pass
    data = treads.data
    qnames = treads.qnames
    with open(path, "wb") as fs:
        fs.write(MAGIC)
        fs.write(struct.pack("<h", BIN_FMT_VERSION))
        fs.write(as_array9(software_version))
        fs.write(struct.pack("<f", proportion_repeat))
        fs.write(struct.pack("<B", min_mapq))
        fd = np.asarray(frag_dist, dtype="<u4")
        assert fd.shape == (4096,)
        fs.write(fd.tobytes())
        hb = header_text.encode()
        fs.write(struct.pack("<i", len(hb)))
        fs.write(hb)
        fs.write(struct.pack("<i", len(data)))
        out = bytearray()
        for i in range(len(data)):
            r = data[i]
            pack_tread(
                out, int(r["tid"]), int(r["position"]), bytes(r["repeat"]),
                int(r["flag"]), int(r["split"]), int(r["mapping_quality"]),
                int(r["repeat_count"]), int(r["align_length"]),
                qnames[i].encode() if qnames else b"",
            )
            if len(out) > (1 << 20):
                fs.write(out)
                out = bytearray()
        fs.write(out)


class Extracted:
    def __init__(self, targets, fragment_distribution, reads: TreadBatch,
                 proportion_repeat: float, min_mapq: int):
        self.targets = targets
        self.fragment_distribution = fragment_distribution
        self.reads = reads
        self.proportion_repeat = proportion_repeat
        self.min_mapq = min_mapq


def read_bin(path: str, drop_unplaced: bool = False, verbose: bool = False,
             targets: list | None = None, requested_tid: int | None = None,
             native: bool = True, skip_qnames: bool = False) -> Extracted:
    """unpack.nim:58-133 including cross-header tid remapping.

    skip_qnames=True leaves TreadBatch.qnames empty — merge overwrites them
    with sample ids anyway (merge.nim:118-124), and skipping saves building
    millions of Python strings on cohort-sized inputs."""
    if native:
        try:
            return _native_read_bin(
                path, drop_unplaced, verbose, targets, requested_tid,
                skip_qnames,
            )
        except OSError:
            pass
    with open(path, "rb") as fh:
        buf = fh.read()
    assert buf[:3] == MAGIC, (
        '[strling] expected bin file to start with "STR". This may indicate '
        "that this bin file was generated by an old version of STRling."
    )
    (fmt_version,) = struct.unpack_from("<h", buf, 3)
    assert fmt_version == BIN_FMT_VERSION, (
        "[strling] this bin file was generated using a different format."
    )
    soft_version = buf[5:14].split(b"\x00")[0].decode()
    (proportion_repeat,) = struct.unpack_from("<f", buf, 14)
    min_mapq = buf[18]
    if verbose:
        print(
            f"[strling] read format version {fmt_version} from software "
            f"version {soft_version}",
            file=sys.stderr,
        )
    frag = np.frombuffer(buf, dtype="<u4", count=4096, offset=19).copy()
    off = 19 + 4096 * 4
    (header_len,) = struct.unpack_from("<i", buf, off)
    off += 4
    header = buf[off : off + header_len].decode()
    off += header_len
    bin_targets = parse_header_targets(header)

    tidmap = None
    out_targets = bin_targets
    if targets is not None and len(targets) > 0:
        if len(targets) != len(bin_targets) or not _same(bin_targets, targets):
            tidmap = {-1: -1}
            byname = {t.name: t for t in targets}
            for bt in bin_targets:
                ot = byname.get(bt.name)
                tidmap[bt.tid] = ot.tid if ot is not None else -1
            out_targets = targets

    (n_reads,) = struct.unpack_from("<i", buf, off)
    off += 4
    u = _Unpacker(buf, off)
    rows = []
    qnames = []
    while not u.at_end():
        (tid, position, rep, flag, split, mapq, rc, al, qname) = unpack_tread(u)
        if tidmap is not None:
            tid = tidmap[tid]
        if requested_tid is not None and tid != requested_tid:
            continue
        if drop_unplaced and tid < 0:
            continue
        rows.append((tid, position, rep, flag, split, mapq, rc, al, 0))
        qnames.append(qname.decode())
    data = np.array(rows, dtype=TREAD_DTYPE) if rows else np.zeros(0, TREAD_DTYPE)
    if requested_tid is None and not drop_unplaced:
        assert len(data) == n_reads, f"[strling] expected {n_reads} got {len(data)}"
    else:
        assert len(data) <= n_reads
    return Extracted(out_targets, frag, TreadBatch(data=data, qnames=qnames),
                     float(proportion_repeat), int(min_mapq))


def _same(a, b) -> bool:
    """unpack.nim:15-21."""
    if len(a) != len(b):
        return False
    return all(x == y for x, y in zip(a, b))


def same_targets(a, b) -> bool:
    return _same(a, b)


# ------------------------------------------------------------- native codec

_nlib = None


def _native_lib():
    global _nlib
    if _nlib is None:
        import ctypes as C

        from strling_tpu_torch.io.hostlib import lib_path

        lib = C.CDLL(lib_path())
        P = np.ctypeslib.ndpointer
        lib.sio_bin_write.restype = C.c_int
        lib.sio_bin_write.argtypes = [
            C.c_char_p, C.c_int16, C.c_char_p, C.c_float, C.c_uint8,
            P(np.uint32), C.c_char_p, C.c_int64, C.c_int64,
            P(np.int32), P(np.uint32), P(np.uint8), P(np.uint16),
            P(np.uint8), P(np.uint8), P(np.uint8), P(np.uint8),
            C.c_char_p, P(np.int64),
        ]
        lib.sio_bin_read.restype = C.c_void_p
        lib.sio_bin_read.argtypes = [C.c_char_p, C.c_int, C.c_int, C.c_int32]
        lib.sio_bin_error.restype = C.c_char_p
        lib.sio_bin_error.argtypes = [C.c_void_p]
        for name, res in [
            ("sio_bin_n", C.c_int64), ("sio_bin_n_declared", C.c_int32),
            ("sio_bin_proportion", C.c_float), ("sio_bin_min_mapq", C.c_int),
            ("sio_bin_qnames_size", C.c_int64),
        ]:
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = [C.c_void_p]
        lib.sio_bin_header.restype = C.c_int64
        lib.sio_bin_header.argtypes = [C.c_void_p, C.c_char_p, C.c_int64]
        lib.sio_bin_soft_version.argtypes = [C.c_void_p, C.c_char_p]
        lib.sio_bin_frag.argtypes = [C.c_void_p, P(np.uint32)]
        lib.sio_bin_fill.argtypes = [
            C.c_void_p, P(np.int32), P(np.uint32), P(np.uint8), P(np.uint16),
            P(np.uint8), P(np.uint8), P(np.uint8), P(np.uint8), C.c_char_p,
            P(np.int64),
        ]
        lib.sio_bin_free.argtypes = [C.c_void_p]
        _nlib = lib
    return _nlib


def _native_write_bin(path, treads: TreadBatch, frag_dist, header_text,
                      proportion_repeat, min_mapq, software_version):
    import ctypes as C

    lib = _native_lib()
    data = treads.data
    n = len(data)
    qnames = treads.qnames or [""] * n
    qblob = "".join(qnames).encode()
    qoff = np.zeros(n + 1, np.int64)
    np.cumsum([len(q.encode()) for q in qnames], out=qoff[1:]) if n else None
    rep = np.ascontiguousarray(data["repeat"]).view(np.uint8).reshape(n, 6)
    rc = lib.sio_bin_write(
        path.encode(), BIN_FMT_VERSION, as_array9(software_version),
        float(proportion_repeat), int(min_mapq),
        np.ascontiguousarray(frag_dist, np.uint32), header_text.encode(),
        len(header_text.encode()), n,
        np.ascontiguousarray(data["tid"]), np.ascontiguousarray(data["position"]),
        np.ascontiguousarray(rep.reshape(-1)), np.ascontiguousarray(data["flag"]),
        np.ascontiguousarray(data["split"]),
        np.ascontiguousarray(data["mapping_quality"]),
        np.ascontiguousarray(data["repeat_count"]),
        np.ascontiguousarray(data["align_length"]), qblob, qoff,
    )
    if rc != 0:
        raise OSError(f"native bin write failed: {path}")


def _native_read_bin(path, drop_unplaced, verbose, targets, requested_tid,
                     skip_qnames=False):
    import ctypes as C

    lib = _native_lib()
    # with a target remap the requested_tid/drop filters must apply after
    # remapping, so read unfiltered and filter in numpy
    pre_filter = targets is None
    h = lib.sio_bin_read(
        path.encode(), int(drop_unplaced and pre_filter),
        int(requested_tid is not None and pre_filter),
        int(requested_tid) if (requested_tid is not None and pre_filter) else 0,
    )
    if not h:
        raise OSError(f"couldn't open bin {path}")
    try:
        err = lib.sio_bin_error(h).decode()
        if err:
            if "magic" in err:
                raise AssertionError(
                    '[strling] expected bin file to start with "STR". This may '
                    "indicate that this bin file was generated by an old "
                    "version of STRling."
                )
            raise AssertionError(f"[strling] bin read error: {err}")
        n = int(lib.sio_bin_n(h))
        data = np.zeros(n, TREAD_DTYPE)
        rep = np.zeros(n * 6, np.uint8)
        qsize = int(lib.sio_bin_qnames_size(h))
        qbuf = C.create_string_buffer(qsize + 1)
        qoff = np.zeros(n + 1, np.int64)
        tid = np.zeros(n, np.int32)
        position = np.zeros(n, np.uint32)
        flag = np.zeros(n, np.uint16)
        split = np.zeros(n, np.uint8)
        mapq = np.zeros(n, np.uint8)
        rcnt = np.zeros(n, np.uint8)
        alen = np.zeros(n, np.uint8)
        lib.sio_bin_fill(h, tid, position, rep, flag, split, mapq, rcnt, alen,
                         qbuf, qoff)
        frag = np.zeros(4096, np.uint32)
        lib.sio_bin_frag(h, frag)
        hlen = lib.sio_bin_header(h, None, 0)
        hbuf = C.create_string_buffer(int(hlen) + 1)
        lib.sio_bin_header(h, hbuf, hlen)
        header = hbuf.raw[:hlen].decode()
        proportion = float(lib.sio_bin_proportion(h))
        min_mapq = int(lib.sio_bin_min_mapq(h))
        n_declared = int(lib.sio_bin_n_declared(h))
    finally:
        lib.sio_bin_free(h)

    data["tid"] = tid
    data["position"] = position
    data["repeat"] = rep.reshape(n, 6).view("S6").reshape(n)
    data["flag"] = flag
    data["split"] = split
    data["mapping_quality"] = mapq
    data["repeat_count"] = rcnt
    data["align_length"] = alen
    if skip_qnames:
        qnames = []
    else:
        blob = qbuf.raw[:qsize]
        qnames = [blob[qoff[i]: qoff[i + 1]].decode() for i in range(n)]

    bin_targets = parse_header_targets(header)
    out_targets = bin_targets
    if targets is not None and len(targets) > 0:
        if len(targets) != len(bin_targets) or not _same(bin_targets, targets):
            tidmap = {-1: -1}
            byname = {t.name: t for t in targets}
            for bt in bin_targets:
                ot = byname.get(bt.name)
                tidmap[bt.tid] = ot.tid if ot is not None else -1
            out_targets = targets
            lut = np.array(
                [tidmap.get(t, -1) for t in range(len(bin_targets))], np.int32
            )
            old = data["tid"]
            data["tid"] = np.where(old >= 0, lut[np.maximum(old, 0)], -1)
        # apply post-remap filters
        keep = np.ones(n, bool)
        if requested_tid is not None:
            keep &= data["tid"] == requested_tid
        if drop_unplaced:
            keep &= data["tid"] >= 0
        if not keep.all():
            data = data[keep]
            if qnames:
                qnames = [q for q, k in zip(qnames, keep) if k]

    if requested_tid is None and not drop_unplaced:
        assert len(data) == n_declared, (
            f"[strling] expected {n_declared} got {len(data)}"
        )
    else:
        assert len(data) <= n_declared
    return Extracted(out_targets, frag, TreadBatch(data=data, qnames=list(qnames)),
                     proportion, min_mapq)
