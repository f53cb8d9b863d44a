"""Python driver for the native C++ extract engine, scanning on torch devices.

The engine (`csrc/extract_engine.cc`) reads, pairs and packs each batch into
the kernel's fused wire payload; a pool of worker threads runs the blocking
transfer -> scan -> fetch chain so the round trips of in-flight batches
overlap each other and the next batch's BGZF decode. Feeds stay FIFO: the
engine's mate cache is order-dependent.

The engine counts its threads' work (`ENGINE_COUNTERS`), and `run` copies
the counts into its `stats`. While a torch profiler runs, `run` puts the
feed loop's spans in its trace, and, for a trace that collects them
(`utils.profiling.maybe_trace`), has the engine keep its producer's and
inflate workers' spans. The bindings, `peek_max_len`,
`native_frag_hist` and the engine calls of `NativeExtractor` are the
reference's (`strling_tpu/io/extract_native.py:24-118` and the class from
:118); the run loop, the feed and the deferred median are the port's.
"""

from __future__ import annotations

import contextlib
import ctypes as C
import itertools
import os
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
from strling_tpu_torch.utils import fraglen
from strling_tpu_torch.utils.profiling import engine_span_sink

__all__ = ["ENGINE_COUNTERS", "NativeExtractor", "TEE_SKIP", "TEE_TAKE",
           "native_frag_hist", "peek_max_len"]

#: the fragment-histogram tee's budget, as the reference's NativeExtractor sets
#: it (and `native_frag_hist` by default): skip TEE_SKIP records, then count
#: TEE_TAKE that pass its predicate (primary proper pairs with
#: 0 <= isize <= 4095: about half the records of paired WGS, one mate of
#: each pair)
TEE_SKIP, TEE_TAKE = 100_000, 2_000_000
#: the most scan rows a batch holds (the reference's largest row bucket)
MAX_ROWS = 65536
#: the engine's counters, in the order `sio_ex_counters` writes them: the
#: inflate pool's ns inside libdeflate, the bytes it made and the pool's
#: size; the producer's ns blocked on a block not yet inflated (or
#: inflating one itself off the pool) and waiting for room in the ready
#: queue; the main thread's ns waiting on the producer and in the engine's
#: feed; the peak of the engine's accounted bytes (`Engine::held_bytes` in
#: csrc/extract_engine.cc); the span buffers kept and span events dropped;
#: the records fed while the median was pending, and the treads whose
#: position its late arrival changed
ENGINE_COUNTERS = ("inflate_ns", "inflate_out_bytes", "inflate_workers",
                   "producer_block_wait_ns", "producer_space_wait_ns",
                   "pop_wait_ns", "feed_ns", "held_bytes_peak",
                   "trace_buffers", "trace_dropped", "fed_before_median",
                   "median_patched")
#: counters that two runs on one `stats` combine by their larger value
PEAK_COUNTERS = ("inflate_workers", "held_bytes_peak", "trace_buffers")


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
    lib.sio_frag_hist.restype = C.c_int64
    lib.sio_frag_hist.argtypes = [
        C.c_void_p, C.c_int64, C.c_int64, P(np.uint32), C.POINTER(C.c_int32),
    ]
    lib.sio_ex_set_prefilter.argtypes = [C.c_void_p, C.c_int]
    lib.sio_ex_set_median.restype = C.c_int
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
    lib.sio_ex_counters.restype = C.c_int64
    lib.sio_ex_counters.argtypes = [C.c_void_p, P(np.int64), C.c_int64]
    lib.sio_ex_pending_bytes.restype = C.c_int64
    lib.sio_ex_pending_bytes.argtypes = []
    lib.sio_ex_set_trace.restype = C.c_int
    lib.sio_ex_set_trace.argtypes = [C.c_void_p, C.c_int]
    lib.sio_ex_trace_events.restype = C.c_int64
    lib.sio_ex_trace_events.argtypes = [C.c_void_p, P(np.int64), C.c_int64]


_bound = False


def _lib():
    global _bound
    lib = _load()
    if not _bound:
        _bind(lib)
        _bound = True
    return lib


def _rss_bytes() -> int:
    """The process's resident set, from /proc/self/statm."""
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class _Span:
    """A span of the feed loop in the running profiler's trace, with the
    number of its batch as the span's one input (`record_function` drops
    its `args` string from the trace; a traced input shows where the
    profiler records shapes, as `maybe_trace`'s does)."""

    __slots__ = ("name", "batch", "handle")

    def __init__(self, name: str, batch: int):
        self.name, self.batch, self.handle = name, batch, None

    def __enter__(self):
        self.handle = torch._C._autograd._record_function_with_args_enter(
            self.name, self.batch)
        return self

    def __exit__(self, *exc):
        torch._C._autograd._record_function_with_args_exit(self.handle)


_NO_SPAN = contextlib.nullcontext()


def peek_max_len(bam: Bam, n_records: int = 10_000) -> int:
    """Max l_seq over the first records (cheap Lmax probe; the engine
    reports its true max after the run so a longer late read triggers an
    exact re-run)."""
    return int(_lib().sio_peek_max_len(bam._h, n_records))


def native_frag_hist(bam: Bam, skip_reads: int = TEE_SKIP,
                     n_reads: int = TEE_TAKE, return_max_len: bool = False,
                     stats: dict | None = None):
    """The fragment-length histogram (uint32[4096]) of `n_reads` records
    that pass its predicate, after skipping `skip_reads`; with
    `return_max_len`, (histogram, the longest read the pass saw).
    `stats`, when given, gets the number of records the pass decoded
    (`"records"`)."""
    hist = np.zeros(4096, np.uint32)
    maxlen = C.c_int32(0)
    n = _lib().sio_frag_hist(bam._h, skip_reads, n_reads, hist,
                             C.byref(maxlen))
    if stats is not None:
        stats["records"] = int(n)
    if return_max_len:
        return hist, int(maxlen.value)
    return hist


class NativeExtractor:
    """The C++ extract engine, scanning on torch devices.

    With `median_fragment_length` None, the engine takes the fragment-length
    histogram on its own record stream (the tee; the same records and
    predicate as `native_frag_hist`, one decode pass for the whole extract)
    and its median is pending: it feeds from the first batch, and `run`
    sets the median from the tee once the tee is ready (`median` then holds
    it)."""

    def __init__(self, bam: Bam, proportion_repeat: float, min_mapq: int,
                 median_fragment_length: int | None, genome_index=None,
                 batch_records: int = 200_000, Lmax: int | None = None,
                 prefilter: bool = True, rows_per_batch: int = 4096):
        if median_fragment_length is not None and median_fragment_length < 0:
            raise ValueError("the fragment-length median cannot be negative, "
                             f"got {median_fragment_length}")
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
        self.median = median_fragment_length
        self._e = self.lib.sio_ex_create(
            bam._h, proportion_repeat, min_mapq,
            -1 if self.median is None else self.median, self.Lmax)
        if not prefilter:
            self.lib.sio_ex_set_prefilter(self._e, 0)
        if (self.median is None and
                self.lib.sio_ex_set_hist_tee(self._e, TEE_SKIP, TEE_TAKE)):
            raise RuntimeError("the engine refused the fragment-length tee")
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

    def counters(self) -> dict[str, int]:
        """The engine's counters by name (`ENGINE_COUNTERS`)."""
        out = np.zeros(len(ENGINE_COUNTERS), np.int64)
        n = self.lib.sio_ex_counters(self._e, out, len(out))
        if n != len(out):
            raise RuntimeError(f"the engine has {n} counters, "
                               f"ENGINE_COUNTERS names {len(out)}")
        return dict(zip(ENGINE_COUNTERS, out.tolist()))

    def trace_events(self) -> np.ndarray:
        """The span events the engine kept, int64 rows of (kind: 0 produce,
        1 inflate; thread id; start and end ns on the steady clock; then a
        produced batch's number and ns waiting on blocks, or an inflate
        stretch's blocks and bytes). Read once the pass has drained."""
        n = self.lib.sio_ex_trace_events(self._e, np.empty(6, np.int64), 0)
        rows = np.empty((max(n, 1), 6), np.int64)
        n = min(n, self.lib.sio_ex_trace_events(self._e, rows.reshape(-1), n))
        return rows[:n]

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
        """Set the pending fragment-length median: the treads fed so far
        get its term in their positions, and the feeds that follow use it
        (`sio_ex_set_median`). Once, before the treads are read."""
        if self.lib.sio_ex_set_median(self._e, int(median)) != 0:
            raise RuntimeError("the median is set once, on an engine created "
                               f"without one, and is not negative: {median}")
        self.median = int(median)

    @property
    def hist_ready(self) -> bool:
        """True once the teed fragment histogram is frozen (2M-record budget
        consumed or main stream ended)."""
        return bool(self.lib.sio_ex_hist_ready(self._e))

    def get_hist(self):
        """(hist[4096] uint32, max_read_len) from the engine tee; raises if
        not yet ready (see hist_ready)."""
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
        if lib.sio_ex_get_keys(self._e, which, seg, ktid, krank, ksub) < 0:
            raise RuntimeError(lib.sio_ex_error(self._e).decode())
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
            raise IOError(self.lib.sio_ex_error(self._e).decode())
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
            stats: dict | None = None) -> TreadBatch:
        """Pipelined loop. Each batch comes out of the engine in the fused
        wire layout; `depth` worker threads scan batches (round-robin over
        `devices`) while the main thread decodes and pairs the next one.
        Feeds go in submission order, so the output is identical for any
        device list. After each pop the loop feeds, oldest first, every
        batch whose scan is back (or that had no scan rows), and stops at
        the first still scanning; it waits on a scan only while more than
        `depth - 1` batches are queued unfed, and at the drain. So fast
        scans keep about one batch unfed in the engine, slow ones up to
        `depth - 1`. Feeds start with the first batch. Where the median is
        pending, it is set from the engine's tee after the first
        pop that finds the tee ready, or once the pass has drained at the
        latest (the tee freezes at the end of the whole-file stream), and
        the engine adds its term to the treads fed before it.

        `stats`, when given, accumulates transfer attribution: n_batches,
        h2d/d2h bytes, summed in-flight scan seconds (overlapped across
        workers) and total feed-wait seconds on the main thread; `engine`,
        the engine's counters by name (summed over runs, `PEAK_COUNTERS` by
        their largest); `rss_start_bytes`, the process's resident set as
        the first run's loop starts; and `unfed_batches_peak`, the most
        batches queued unfed in the engine just after a pop (the largest
        over runs).

        While a torch profiler runs, the loop's spans go in its trace:
        `strling.extract.engine_pop` (waiting on the engine's next batch),
        `strling.extract.scan_wait` (on its scan), `strling.extract.feed`
        and `strling.extract.median` (setting the median and patching the
        treads fed before it), each with the batch's number. For a trace
        that collects them (`utils.profiling.engine_span_sink`), the engine
        keeps its threads' spans and the run hands them over once the pass
        has drained."""
        if not devices:
            raise ValueError("run needs at least one torch device")
        depth = max(depth, 2 * len(devices))
        if stats is not None:
            stats.setdefault("rss_start_bytes", _rss_bytes())
            for key in ("n_batches", "h2d_bytes", "d2h_bytes"):
                stats.setdefault(key, 0)
            stats.setdefault("scan_s", 0.0)   # summed over workers (overlaps)
            stats.setdefault("wait_s", 0.0)   # main-thread feed-drain wait
            stats.setdefault("unfed_batches_peak", 0)
        tracing = torch._C._autograd._profiler_enabled()
        sink = engine_span_sink() if tracing else None
        if sink is not None and self.lib.sio_ex_set_trace(self._e, 1) != 0:
            raise RuntimeError("engine tracing must start before its first "
                               "batch")

        def span(name, batch):
            return _Span(name, batch) if tracing else _NO_SPAN

        def median_from_tee(batch):
            with span("strling.extract.median", batch):
                self.set_median(fraglen.median(self.get_hist()[0]))

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
        scans = 0
        # (batch number, scan future or EMPTY); batch b is the engine's b-th
        inflight: deque = deque()
        with ThreadPoolExecutor(max_workers=depth) as pool:
            for batch in itertools.count():
                with span("strling.extract.engine_pop", batch):
                    rows, n_records, payload, layout, ascii_rows = \
                        self._next_fused()
                if n_records > 0:
                    if rows > 0:
                        dev = devices[scans % len(devices)]
                        scans += 1
                        inflight.append((batch, pool.submit(
                            scan_job, payload, layout, ascii_rows, rows,
                            dev)))
                    else:
                        inflight.append((batch, EMPTY))
                if stats is not None:
                    stats["unfed_batches_peak"] = max(
                        stats["unfed_batches_peak"], len(inflight))
                done = n_records == 0 and bool(self.lib.sio_ex_done(self._e))
                if self.median is None and self.hist_ready:
                    median_from_tee(batch)
                limit = 0 if done else depth - 1
                # oldest first: every scan that is back, then block on the
                # head only while more than `limit` batches wait unfed
                while inflight and (len(inflight) > limit
                                    or inflight[0][1] is EMPTY
                                    or inflight[0][1].done()):
                    b, f = inflight.popleft()
                    res = None
                    if f is not EMPTY:
                        tw = time.perf_counter()
                        with span("strling.extract.scan_wait", b):
                            res = f.result()
                        if stats is not None:
                            stats["wait_s"] += time.perf_counter() - tw
                    with span("strling.extract.feed", b):
                        self._feed(res)
                if done:
                    break
        if self.median is None:
            median_from_tee(batch)
        if sink is not None:
            sink.append(self.trace_events())
        if stats is not None:
            engine = stats.setdefault("engine", {})
            for name, v in self.counters().items():
                engine[name] = (max(engine.get(name, 0), v)
                                if name in PEAK_COUNTERS
                                else engine.get(name, 0) + v)
        return self.treads()
