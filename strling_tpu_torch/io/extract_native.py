"""Python driver for the native C++ extract engine, scanning on torch devices.

The engine (`csrc/extract_engine.cc`) reads, pairs and packs each batch into
the kernel's fused wire payload; a pool of worker threads runs the blocking
transfer -> scan -> fetch chain so the round trips of in-flight batches
overlap each other and the next batch's BGZF decode. Feeds stay FIFO: the
engine's mate cache is order-dependent. The bindings, `peek_max_len`,
`native_frag_hist` and the engine calls of `NativeExtractor` are the
reference's (`strling_tpu/io/extract_native.py:24-118` and the class from
:118); the run loop and the feed are the port's.
"""

from __future__ import annotations

import ctypes as C
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from strling_tpu_torch.core.tread import TREAD_DTYPE, TreadBatch
from strling_tpu_torch.io.bam import Bam, _load
from strling_tpu_torch.ops.kmer import scan_codes, scan_payload

__all__ = ["HOLD_RECORDS", "NativeExtractor", "TEE_SKIP", "TEE_TAKE",
           "native_frag_hist", "peek_max_len"]

#: the fragment-histogram tee's budget, as the reference's NativeExtractor sets
#: it (and `native_frag_hist` by default): skip TEE_SKIP records, then count
#: TEE_TAKE that pass its predicate (primary proper pairs with
#: 0 <= isize <= 4095: about half the records of paired WGS, one mate of
#: each pair)
TEE_SKIP, TEE_TAKE = 100_000, 2_000_000
#: records that feeds may hold while the tee fills: its need where a
#: quarter of the records pass (a held record costs the engine ~110 bytes
#: plus its name)
HOLD_RECORDS = TEE_SKIP + 4 * TEE_TAKE
#: the most scan rows a batch holds (the reference's largest row bucket)
MAX_ROWS = 65536


def _bind(lib):
    P = np.ctypeslib.ndpointer
    lib.sio_ex_create.restype = C.c_void_p
    lib.sio_ex_create.argtypes = [C.c_void_p, C.c_double, C.c_int, C.c_int64, C.c_int]
    lib.sio_ex_destroy.argtypes = [C.c_void_p]
    lib.sio_ex_set_index.argtypes = [C.c_void_p, C.c_int, P(np.int64), P(np.int64), C.c_int64]
    lib.sio_ex_next_fused.restype = C.c_int64
    lib.sio_ex_next_fused.argtypes = [
        C.c_void_p, C.c_int64, C.POINTER(C.c_int64), P(np.uint8), P(np.uint8),
        P(np.int32), P(np.float64), C.c_int64, C.POINTER(C.c_int32),
    ]
    lib.sio_ex_feed.argtypes = [C.c_void_p, P(np.int32), P(np.int32), P(np.int32), C.c_int64]
    lib.sio_ex_feed.restype = C.c_int
    lib.sio_ex_done.argtypes = [C.c_void_p]
    lib.sio_ex_nreads.restype = C.c_int64
    lib.sio_ex_nreads.argtypes = [C.c_void_p]
    lib.sio_ex_n_treads.restype = C.c_int64
    lib.sio_ex_n_treads.argtypes = [C.c_void_p]
    lib.sio_ex_get_treads.restype = C.c_int64
    lib.sio_ex_get_treads.argtypes = [
        C.c_void_p, P(np.int32), P(np.uint32), P(np.uint8), P(np.uint16),
        P(np.uint8), P(np.uint8), P(np.uint8), P(np.uint8), C.c_char_p,
        C.c_int64, P(np.int64),
    ]
    lib.sio_frag_hist.argtypes = [
        C.c_void_p, C.c_int64, C.c_int64, P(np.uint32), C.POINTER(C.c_int32),
    ]
    lib.sio_ex_set_prefilter.argtypes = [C.c_void_p, C.c_int]
    lib.sio_ex_set_median.argtypes = [C.c_void_p, C.c_int64]
    lib.sio_ex_max_len.restype = C.c_int64
    lib.sio_ex_max_len.argtypes = [C.c_void_p]
    lib.sio_peek_max_len.restype = C.c_int64
    lib.sio_peek_max_len.argtypes = [C.c_void_p, C.c_int64]
    lib.sio_ex_error.restype = C.c_char_p
    lib.sio_ex_error.argtypes = [C.c_void_p]
    lib.sio_ex_set_hist_tee.restype = C.c_int
    lib.sio_ex_set_hist_tee.argtypes = [C.c_void_p, C.c_int64, C.c_int64]
    lib.sio_ex_hist_ready.restype = C.c_int
    lib.sio_ex_hist_ready.argtypes = [C.c_void_p]
    lib.sio_ex_get_hist.restype = C.c_int
    lib.sio_ex_get_hist.argtypes = [C.c_void_p, P(np.uint32),
                                    C.POINTER(C.c_int32)]
    lib.sio_ex_set_shard.restype = C.c_int
    lib.sio_ex_set_shard.argtypes = [C.c_void_p, P(np.int32), C.c_int64, C.c_int]
    lib.sio_ex_get_keys.restype = C.c_int64
    lib.sio_ex_get_keys.argtypes = [
        C.c_void_p, C.c_int, P(np.uint8), P(np.int32), P(np.int64),
        P(np.uint8),
    ]
    lib.sio_ex_n_spill.restype = C.c_int64
    lib.sio_ex_n_spill.argtypes = [C.c_void_p]
    lib.sio_ex_get_spill.restype = C.c_int64
    lib.sio_ex_get_spill.argtypes = [
        C.c_void_p, P(np.int32), P(np.uint32), P(np.uint8), P(np.uint16),
        P(np.uint8), P(np.uint8), P(np.uint8), P(np.uint8), C.c_char_p,
        C.c_int64, P(np.int64),
    ]


_bound = False


def _lib():
    global _bound
    lib = _load()
    if not _bound:
        _bind(lib)
        _bound = True
    return lib


def peek_max_len(bam: Bam, n_records: int = 10_000) -> int:
    """Max l_seq over the first records (cheap Lmax probe; the engine
    reports its true max after the run so a longer late read triggers an
    exact re-run)."""
    return int(_lib().sio_peek_max_len(bam._h, n_records))


def native_frag_hist(bam: Bam, skip_reads: int = TEE_SKIP,
                     n_reads: int = TEE_TAKE, return_max_len: bool = False):
    """The fragment-length histogram (uint32[4096]) of `n_reads` records
    that pass its predicate, after skipping `skip_reads`; with
    `return_max_len`, (histogram, the longest read the pass saw)."""
    hist = np.zeros(4096, np.uint32)
    maxlen = C.c_int32(0)
    _lib().sio_frag_hist(bam._h, skip_reads, n_reads, hist, C.byref(maxlen))
    if return_max_len:
        return hist, int(maxlen.value)
    return hist


class NativeExtractor:
    """The C++ extract engine, scanning on torch devices."""

    def __init__(self, bam: Bam, proportion_repeat: float, min_mapq: int,
                 median_fragment_length: int, genome_index=None,
                 batch_records: int = 200_000, Lmax: int | None = None,
                 prefilter: bool = True, rows_per_batch: int = 4096,
                 frag_tee: bool = False):
        self.lib = _lib()
        self.bam = bam
        # transfer width: the max read length (rounded up) bounds the packed
        # row width; 150bp data moves 160-byte rows instead of 256
        self.Lmax = min(bam.Lmax, Lmax) if Lmax else bam.Lmax
        self.proportion_repeat = proportion_repeat
        self.batch_records = batch_records
        # batches are ROWS-driven: the engine cuts a batch when the next
        # record would push scan rows past rows_cap (with the ~2-3%
        # post-exact-filter row rate one 4096-row batch carries ~100-200k
        # records; batch_records is a memory backstop — a Pending record is
        # ~110B + a qname, so the cap bounds a row-starved stretch at ~25MB
        # buffered per produced batch)
        self.rows_cap = max(8, min(rows_per_batch, MAX_ROWS))
        self._e = self.lib.sio_ex_create(
            bam._h, proportion_repeat, min_mapq, median_fragment_length, self.Lmax
        )
        if not prefilter:
            self.lib.sio_ex_set_prefilter(self._e, 0)
        if frag_tee:
            # fragment-length histogram accumulated on the engine's OWN
            # record stream (same predicate/stream as native_frag_hist) —
            # one BGZF decode pass for the whole extract instead of two
            rc = self.lib.sio_ex_set_hist_tee(self._e, TEE_SKIP, TEE_TAKE)
            if rc != 0:
                raise RuntimeError("hist tee must be enabled before reading"
                                   " (and never in sharded mode)")
        if genome_index is not None:
            name_to_tid = {t.name: t.tid for t in bam.targets}
            for chrom, (starts, pmax) in genome_index.by_chrom.items():
                tid = name_to_tid.get(chrom)
                if tid is None:
                    continue
                self.lib.sio_ex_set_index(
                    self._e, tid, np.ascontiguousarray(starts, np.int64),
                    np.ascontiguousarray(pmax, np.int64), len(starts),
                )

    def __del__(self):
        try:
            if self._e:
                self.lib.sio_ex_destroy(self._e)
                self._e = None
        except Exception:
            pass

    def _next_fused(self):
        """Fused-payload batch: returns (rows, n_records, payload|None,
        layout, ascii-tuple|None). The payload buffer is pre-zeroed and
        rows_cap tall, so the scan can use it as an already-padded bucket
        directly (zero rows scan as empty reads — no Python-side pad copy).
        The engine picks the smallest wire layout per batch (fb=2 -> "n8",
        N-free; fb=0 -> "w8"/"w16"); the ascii tuple is only filled on the
        rare IUPAC fallback (fb=1)."""
        # widest possible layout bounds the flat buffer; the engine writes
        # rows at the chosen layout's stride and the buffer is re-viewed
        meta8 = self.Lmax <= 248 and self.proportion_repeat <= 1.0
        maxW = 3 * self.Lmax // 8 + (11 if meta8 else 22)
        buf = np.zeros(self.rows_cap * maxW, np.uint8)
        bases = np.empty((self.rows_cap, self.Lmax), np.uint8)
        lengths = np.empty(self.rows_cap, np.int32)
        props = np.empty(self.rows_cap, np.float64)
        n_records = C.c_int64(0)
        fb = C.c_int32(0)
        rows = self.lib.sio_ex_next_fused(
            self._e, self.batch_records, C.byref(n_records),
            buf, bases.reshape(-1), lengths, props,
            self.rows_cap, C.byref(fb),
        )
        if rows < 0:
            raise IOError(self.lib.sio_ex_error(self._e).decode())
        rows = int(rows)
        if fb.value == 1:
            return rows, int(n_records.value), None, None, (
                bases, lengths, props)
        if fb.value == 2:
            layout, rowW = "n8", self.Lmax // 4 + 11
        else:
            layout, rowW = ("w8", maxW) if meta8 else ("w16", maxW)
        payload = buf[: self.rows_cap * rowW].reshape(self.rows_cap, rowW)
        return rows, int(n_records.value), payload, layout, None

    def set_median(self, median: int):
        """Set the fragment-length median (deferred-median mode); must run
        before the first feed — adjust_by is its only consumer."""
        self.lib.sio_ex_set_median(self._e, int(median))

    @property
    def hist_ready(self) -> bool:
        """True once the teed fragment histogram is frozen (2M-record budget
        consumed or main stream ended)."""
        return bool(self.lib.sio_ex_hist_ready(self._e))

    def get_hist(self):
        """(hist[4096] uint32, max_read_len) from the engine tee; raises if
        not yet ready (see hist_ready / run(hold_drain=...))."""
        hist = np.zeros(4096, np.uint32)
        ml = C.c_int32(0)
        if self.lib.sio_ex_get_hist(self._e, hist, C.byref(ml)) != 0:
            raise RuntimeError("fragment histogram not ready")
        return hist, int(ml.value)

    @property
    def max_len_seen(self) -> int:
        return int(self.lib.sio_ex_max_len(self._e))

    @property
    def nreads(self) -> int:
        return int(self.lib.sio_ex_nreads(self._e))

    def set_shard(self, tids, include_unplaced: bool):
        """Restrict this engine to a tid shard (distributed extract); must be
        called before the first batch. Requires an index on the input."""
        rc = self.lib.sio_ex_set_shard(
            self._e, np.ascontiguousarray(tids, np.int32), len(tids),
            1 if include_unplaced else 0,
        )
        if rc != 0:
            raise RuntimeError("set_shard must be called before reading")

    def treads(self) -> TreadBatch:
        return self._read_treads(self.lib.sio_ex_n_treads,
                                 self.lib.sio_ex_get_treads)

    def spill(self) -> TreadBatch:
        """Treads whose mates live in other shards (sharded mode only)."""
        return self._read_treads(self.lib.sio_ex_n_spill,
                                 self.lib.sio_ex_get_spill)

    def emission_keys(self, which: int = 0):
        """(seg, tid, rank, sub) emission-order key arrays for the output
        (which=0) or spill (which=1) treads; sorting gathered shard treads
        by this key reproduces the sequential bin order exactly."""
        lib = self.lib
        n = int(lib.sio_ex_n_spill(self._e) if which
                else lib.sio_ex_n_treads(self._e))
        seg = np.empty(n, np.uint8)
        ktid = np.empty(n, np.int32)
        krank = np.empty(n, np.int64)
        ksub = np.empty(n, np.uint8)
        lib.sio_ex_get_keys(self._e, which, seg, ktid, krank, ksub)
        return seg, ktid, krank, ksub

    def _read_treads(self, count_fn, get_fn) -> TreadBatch:
        n = int(count_fn(self._e))
        tid = np.empty(n, np.int32)
        position = np.empty(n, np.uint32)
        repeat6 = np.empty(n * 6, np.uint8)
        flag = np.empty(n, np.uint16)
        split = np.empty(n, np.uint8)
        mapq = np.empty(n, np.uint8)
        repeat_count = np.empty(n, np.uint8)
        align_length = np.empty(n, np.uint8)
        qcap = n * 256 + 16
        qbuf = C.create_string_buffer(qcap)
        qoff = np.empty(n + 1, np.int64)
        rc = get_fn(
            self._e, tid, position, repeat6, flag, split, mapq, repeat_count,
            align_length, qbuf, qcap, qoff,
        )
        if rc < 0:
            raise IOError("qname buffer overflow")
        data = np.zeros(n, TREAD_DTYPE)
        data["tid"] = tid
        data["position"] = position
        data["repeat"] = repeat6.reshape(n, 6).view("S6").reshape(n)
        data["flag"] = flag
        data["split"] = split
        data["mapping_quality"] = mapq
        data["repeat_count"] = repeat_count
        data["align_length"] = align_length
        blob = qbuf.raw
        qnames = [
            blob[qoff[i]: qoff[i + 1]].decode() for i in range(n)
        ]
        return TreadBatch(data=data, qnames=qnames)

    def _feed(self, result):
        # The bin stores repeat_count in 8 bits (the engine casts on store
        # and asserts count < 256 on the main-read path). The kernel's count
        # is exact (a 256bp homopolymer counts 256), so reduce it here as
        # the store would, and say so. The unit stays the kernel's, which is
        # the oracle's (ops/oracle.get_repeat). The JAX package packs
        # `cnt | ulen << 8 | code << 11`, so there a count of 256 or more
        # spills into the unit length: for homopolymers of 512 bases and
        # more, and long dimer runs, its bin holds `AAA`/`AAC` where this
        # one holds `A`/`AC` (fault F9; the oracle decides). So bins equal
        # the JAX package's where counts stay under 256, and for
        # homopolymers of 256-511 bases. The spill is not copied, and the
        # engine refuses a unit longer than 6 bases.
        if result is not None:
            code, ulen, cnt = result
            wide = int((cnt > 255).sum())
            if wide:
                print(f"[strling] warning: {wide} scanned reads have a repeat "
                      "count above 255; the bin keeps it modulo 256",
                      file=sys.stderr)
                result = (code, ulen, cnt & 0xFF)
        empty = np.zeros(0, np.int32)
        if result is None:
            rc = self.lib.sio_ex_feed(self._e, empty, empty, empty, 0)
        else:
            code, ulen, cnt = result
            rc = self.lib.sio_ex_feed(
                self._e, np.ascontiguousarray(code, np.int32),
                np.ascontiguousarray(ulen, np.int32),
                np.ascontiguousarray(cnt, np.int32), len(code),
            )
        if rc < 0:
            raise IOError(self.lib.sio_ex_error(self._e).decode())

    def run(self, devices: list[torch.device], depth: int = 8,
            pre_feed_hook=None, stats: dict | None = None,
            hold_drain=None, max_held_records: int = HOLD_RECORDS,
            on_hold_cap=None) -> TreadBatch:
        """Pipelined loop. Each batch comes out of the engine in the fused
        wire layout; `depth` worker threads scan batches (round-robin over
        `devices`) while the main thread decodes and pairs the next one.
        Feeds are drained in submission order, so the output is identical
        for any device list.

        `stats`, when given, accumulates transfer attribution: n_batches,
        h2d/d2h bytes, summed in-flight scan seconds (overlapped across
        workers), total feed-wait seconds on the main thread, and the peak
        number of batches (`max_held`) and records (`max_held_records`)
        held unfed.
        `hold_drain`, when it returns True, holds feeds (scans keep flying)
        until the fragment histogram the feeds need is ready. Once the held
        batches carry `max_held_records` records, `on_hold_cap` is called
        once in place of `pre_feed_hook` (it must give the engine its median
        another way) and feeding resumes."""
        if not devices:
            raise ValueError("run needs at least one torch device")
        if hold_drain is not None and on_hold_cap is None:
            raise ValueError("hold_drain needs on_hold_cap for when the "
                             "held records reach max_held_records")
        if max_held_records < 1:
            raise ValueError("max_held_records must be at least 1, got "
                             f"{max_held_records}")
        depth = max(depth, 2 * len(devices))
        # feeds hold from the first batch on, so every batch in flight
        # while they do is held
        held = held_records = 0
        if stats is not None:
            for key in ("n_batches", "h2d_bytes", "d2h_bytes", "max_held",
                        "max_held_records"):
                stats.setdefault(key, 0)
            stats.setdefault("scan_s", 0.0)   # summed over workers (overlaps)
            stats.setdefault("wait_s", 0.0)   # main-thread feed-drain wait
        slock = threading.Lock()

        def scan_job(payload, layout, ascii_rows, rows, dev):
            t0 = time.perf_counter()
            if payload is not None:
                out = scan_payload(payload, rows, layout, dev)
                h2d = rows * payload.shape[1]
            else:
                b, l, p = ascii_rows
                out = scan_codes(b[:rows], l[:rows], p[:rows], dev)
                h2d = rows * (b.shape[1] + 44)
            if stats is not None:
                with slock:
                    stats["n_batches"] += 1
                    stats["h2d_bytes"] += h2d
                    stats["d2h_bytes"] += rows * 12
                    stats["scan_s"] += time.perf_counter() - t0
            return out

        EMPTY = "empty"  # a batch with no scan rows still takes a feed
        batch_i = 0
        inflight: deque = deque()
        with ThreadPoolExecutor(max_workers=depth) as pool:
            while True:
                rows, n_records, payload, layout, ascii_rows = \
                    self._next_fused()
                if n_records > 0:
                    if rows > 0:
                        dev = devices[batch_i % len(devices)]
                        batch_i += 1
                        inflight.append(pool.submit(
                            scan_job, payload, layout, ascii_rows, rows, dev))
                    else:
                        inflight.append(EMPTY)
                done = n_records == 0 and bool(self.lib.sio_ex_done(self._e))
                if not done and hold_drain is not None and hold_drain():
                    held = len(inflight)
                    held_records += n_records
                    if held_records < max_held_records:
                        continue
                    on_hold_cap()
                    hold_drain = pre_feed_hook = None
                limit = 0 if done else depth - 1
                while len(inflight) > limit:
                    if pre_feed_hook is not None:
                        pre_feed_hook()
                        pre_feed_hook = None
                    f = inflight.popleft()
                    if f is EMPTY:
                        self._feed(None)
                    else:
                        tw = time.perf_counter()
                        res = f.result()
                        if stats is not None:
                            stats["wait_s"] += time.perf_counter() - tw
                        self._feed(res)
                if done:
                    break
        if pre_feed_hook is not None:
            pre_feed_hook()
        if stats is not None:
            stats["max_held"] = max(stats["max_held"], held)
            stats["max_held_records"] = max(stats["max_held_records"],
                                            held_records)
        return self.treads()
