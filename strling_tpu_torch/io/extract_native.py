"""Python driver for the native C++ extract engine, scanning on torch devices.

The engine (the JAX package's `io/csrc/extract_engine.cc`, reused unchanged)
reads, pairs and packs each batch into the kernel's fused wire payload; a
pool of worker threads runs the blocking transfer -> scan -> fetch chain so
the round trips of in-flight batches overlap each other and the next batch's
BGZF decode. Feeds stay FIFO: the engine's mate cache is order-dependent.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import torch

from strling_tpu.core.tread import TreadBatch
from strling_tpu.io import extract_native as _ref
from strling_tpu.io.extract_native import peek_max_len
from strling_tpu_torch.io import hostlib
from strling_tpu_torch.ops.kmer import scan_codes, scan_payload

__all__ = ["NativeExtractor", "peek_max_len"]


class NativeExtractor(_ref.NativeExtractor):
    """The reference engine driver with the scan on torch devices. Only the
    run loop and the feed differ; the engine calls are inherited."""

    def __init__(self, *args, **kwargs):
        hostlib.load()
        super().__init__(*args, **kwargs)

    def _feed(self, result):
        # The bin stores repeat_count in 8 bits (the engine casts on store,
        # extract_engine.cc:865, and asserts count < 256 on the main-read
        # path, :973). The kernel's count is exact (a 256bp homopolymer
        # counts 256), so reduce it here as the store would, and say so.
        if result is not None:
            code, ulen, cnt = result
            wide = int((cnt > 255).sum())
            if wide:
                print(f"[strling] warning: {wide} scanned reads have a repeat "
                      "count above 255; the bin keeps it modulo 256",
                      file=sys.stderr)
                result = (code, ulen, cnt & 0xFF)
        super()._feed(result)

    def run(self, devices: list[torch.device], depth: int = 8,
            pre_feed_hook=None, stats: dict | None = None,
            hold_drain=None) -> TreadBatch:
        """Pipelined loop. Each batch comes out of the engine in the fused
        wire layout; `depth` worker threads scan batches (round-robin over
        `devices`) while the main thread decodes and pairs the next one.
        Feeds are drained in submission order, so the output is identical
        for any device list.

        `stats`, when given, accumulates transfer attribution: n_batches,
        h2d/d2h bytes, summed in-flight scan seconds (overlapped across
        workers), and total feed-wait seconds on the main thread.
        `hold_drain`, when it returns True, holds feeds (scans keep flying)
        until the fragment histogram the feeds need is ready."""
        if not devices:
            raise ValueError("run needs at least one torch device")
        depth = max(depth, 2 * len(devices))
        if stats is not None:
            for key in ("n_batches", "h2d_bytes", "d2h_bytes"):
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
                    continue
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
        return self.treads()
