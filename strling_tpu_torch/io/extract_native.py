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

__all__ = ["HOLD_RECORDS", "NativeExtractor", "TEE_SKIP", "TEE_TAKE",
           "peek_max_len"]

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
