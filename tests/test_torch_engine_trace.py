"""The extract engine's counters and spans (`NativeExtractor.run`'s
`stats["engine"]`, `utils.profiling.maybe_trace`'s engine tracks) on the
extract tests' small BAMs: what the counters add up, that no profiler means
no spans, that the engine's and the feed loop's spans line up by batch, and
that tracing leaves the bin as it was."""

import functools
import gzip
import json
import shutil
import struct
import time

import numpy as np
import pytest
import torch

from strling_tpu_torch.core import extract as port_extract
from strling_tpu_torch.core.extract import extract_native
from strling_tpu_torch.io import Bam, write_bin
from strling_tpu_torch.io.extract_native import (
    ENGINE_COUNTERS, NativeExtractor, _lib)
from strling_tpu_torch.utils.profiling import maybe_trace

from test_torch_extract import _pairs_bam, _str_mutate

torch.set_num_threads(1)
CPU = [torch.device("cpu")]


def _few_repeats(i, s1, s2):
    # one pair in 200 carries a repeat: the plain scan on the CPU is slow
    # per call, and most batches need none
    return _str_mutate(0, s1, s2) if i % 200 == 0 else (s1, s2)


@pytest.fixture(scope="module")
def pairs_bam(tmp_path_factory):
    """About 30 BGZF blocks of 2x150 pairs."""
    path = str(tmp_path_factory.mktemp("trace") / "pairs.bam")
    return _pairs_bam(path, 3000, 150, np.random.default_rng(5), _few_repeats)


#: batches of at most 256 records and 64 scan rows: a small BAM makes many
SMALL = {"batch_records": 256, "rows_per_batch": 64}
#: scans in flight: more threads running the plain scan slow each other
DEPTH = 2


@pytest.fixture
def small_batches(monkeypatch):
    monkeypatch.setattr(port_extract, "NativeExtractor", functools.partial(
        NativeExtractor, **SMALL))
    monkeypatch.setattr(NativeExtractor, "run", functools.partialmethod(
        NativeExtractor.run, depth=DEPTH))


def _extract(path, stats=None):
    bam = Bam(path)
    t0 = time.perf_counter()
    tb, frag, _ = extract_native(bam, None, None, devices=CPU, stats=stats)
    return tb, frag, bam, time.perf_counter() - t0


def _blocks(path):
    """(uncompressed sizes of the BGZF blocks in file order, the offset of
    the first record in the uncompressed stream)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    sizes, off = [], 0
    while off < len(raw):
        xlen = struct.unpack_from("<H", raw, off + 10)[0]
        bsize = struct.unpack_from("<H", raw, off + 16)[0] + 1
        assert raw[off + 12:off + 14] == b"BC" and xlen == 6
        sizes.append(struct.unpack_from("<I", raw, off + bsize - 4)[0])
        off += bsize
    data = gzip.decompress(raw)
    l_text = struct.unpack_from("<i", data, 4)[0]
    pos = 8 + l_text
    n_ref = struct.unpack_from("<i", data, pos)[0]
    pos += 4
    for _ in range(n_ref):
        pos += 4 + struct.unpack_from("<i", data, pos)[0] + 4
    return sizes, pos


def test_inflate_out_bytes_are_the_blocks_the_pass_visited(pairs_bam,
                                                           tmp_path):
    """Without an index the pass reads the file twice from the block that
    holds the header's end: the whole-file scan, then the scan for the
    no-coordinate block. Every block it reads is inflated once, on the pool
    or on the synchronous path, and counted."""
    path = str(tmp_path / "no_index.bam")
    shutil.copyfile(pairs_bam, path)
    sizes, first_record = _blocks(path)
    assert len(sizes) > 10
    # the block holding the header's last byte: the reader seeks to it
    ends = np.cumsum(sizes)
    b0 = int(np.searchsorted(ends, first_record))
    stats = {}
    _extract(path, stats)
    engine = stats["engine"]
    assert engine["inflate_out_bytes"] == 2 * sum(sizes[b0:])
    assert engine["inflate_ns"] > 0
    assert engine["inflate_workers"] >= 1


def test_main_thread_waits_stay_under_the_pass_wall(pairs_bam, small_batches):
    stats = {}
    *_, wall = _extract(pairs_bam, stats)
    engine = stats["engine"]
    assert set(engine) == set(ENGINE_COUNTERS)
    assert engine["pop_wait_ns"] > 0 and engine["feed_ns"] > 0
    assert engine["pop_wait_ns"] + engine["feed_ns"] < wall * 1e9
    assert engine["producer_block_wait_ns"] < wall * 1e9
    assert stats["n_batches"] >= 5
    assert 0 < stats["rss_start_bytes"] < 1 << 40


def test_held_bytes_stay_under_the_batches_in_flight(tmp_path, monkeypatch):
    """The tee is ready only at the end of the stream (12,000 records, fewer
    than it skips), and nothing waits for it: the engine's accounted bytes
    stay under (depth + 4) batches' worth of Pending records (those in
    flight, the ready queue's three and one to spare for the rest), where
    holding until the median would have cost a Pending record for each of
    the 12,000. No inflate pool: its blocks would count besides."""
    monkeypatch.setenv("STRLING_BGZF_THREADS", "0")
    path = _pairs_bam(str(tmp_path / "long.bam"), 6000, 100,
                      np.random.default_rng(9), _few_repeats)
    batch = 1000
    monkeypatch.setattr(port_extract, "NativeExtractor", functools.partial(
        NativeExtractor, batch_records=batch, rows_per_batch=64))
    monkeypatch.setattr(NativeExtractor, "run", functools.partialmethod(
        NativeExtractor.run, depth=DEPTH))
    stats = {}
    _extract(path, stats)
    engine, pending = stats["engine"], _lib().sio_ex_pending_bytes()
    assert stats.get("max_held_records", 0) == 0  # feed.held_records_peak
    assert 0 < engine["fed_before_median"] < 12_000
    assert engine["held_bytes_peak"] < (DEPTH + 4) * batch * pending
    assert (DEPTH + 4) * batch < 12_000


def test_batches_are_fed_as_their_scans_come_back(tmp_path, monkeypatch):
    """With 16 workers the loop could queue 15 batches unfed before it
    waits on a scan; it feeds each one as soon as its scan is back, so at
    most two wait unfed after a pop (the one popped and one still
    scanning), and the engine's accounted bytes stay under six batches'
    Pending records: one queued, one just popped, the ready queue's three
    and one to spare. On the card a scan is back within a millisecond,
    long before the producer's next batch, but the plain scan on the CPU is
    slower than the producer: so here each pop first waits until every
    scan submitted before it is back."""
    from concurrent import futures

    from strling_tpu_torch.io import extract_native as port_ne

    monkeypatch.setenv("STRLING_BGZF_THREADS", "0")
    path = _pairs_bam(str(tmp_path / "long.bam"), 6000, 100,
                      np.random.default_rng(9), _few_repeats)
    batch, depth = 1000, 16
    submitted = []

    class Pool(futures.ThreadPoolExecutor):
        def submit(self, *args, **kwargs):
            submitted.append(super().submit(*args, **kwargs))
            return submitted[-1]

    pop = NativeExtractor._next_fused

    def pop_after_the_scans(self):
        futures.wait(submitted)
        return pop(self)

    monkeypatch.setattr(port_ne, "ThreadPoolExecutor", Pool)
    monkeypatch.setattr(NativeExtractor, "_next_fused", pop_after_the_scans)
    monkeypatch.setattr(port_extract, "NativeExtractor", functools.partial(
        NativeExtractor, batch_records=batch, rows_per_batch=64))
    monkeypatch.setattr(NativeExtractor, "run", functools.partialmethod(
        NativeExtractor.run, depth=depth))
    stats = {}
    _extract(path, stats)
    engine, pending = stats["engine"], _lib().sio_ex_pending_bytes()
    assert len(submitted) == stats["n_batches"] >= 8
    assert 1 <= stats["unfed_batches_peak"] <= 2
    assert engine["held_bytes_peak"] < 6 * batch * pending
    assert (depth - 1) * batch >= 12_000


def test_no_profiler_no_engine_spans(pairs_bam, tmp_path):
    """No profiler: the engine keeps no span buffer. A profiler that no
    trace collects the engine's spans for (the benchmark's own): the feed
    loop's spans are in its trace, and still no engine buffer."""
    assert not torch._C._autograd._profiler_enabled()
    ne = NativeExtractor(Bam(pairs_bam), 0.8, 40, 300, **SMALL)
    stats = {}
    ne.run(CPU, stats=stats, depth=DEPTH)
    assert ne.trace_events().shape == (0, 6)
    assert stats["engine"]["trace_buffers"] == 0
    assert stats["engine"]["trace_dropped"] == 0

    from torch.profiler import ProfilerActivity, profile

    ne = NativeExtractor(Bam(pairs_bam), 0.8, 40, 300, **SMALL)
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch._C._autograd._profiler_enabled()
        ne.run(CPU, stats=stats, depth=DEPTH)
    assert stats["engine"]["trace_buffers"] == 0
    assert len(ne.trace_events()) == 0
    path = tmp_path / "plain.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"strling.extract.engine_pop", "strling.extract.scan_wait",
            "strling.extract.feed"} <= names


def test_maybe_trace_holds_the_engine_tracks_aligned(pairs_bam, small_batches,
                                                     tmp_path):
    """The exported trace holds a producer track, inflate tracks and the
    feed loop's spans; every batch's `produce` span ends before the main
    thread's `engine_pop` span of the same batch does, to within 1 ms (the
    steady clock placed on the profiler's axis)."""
    stats = {}
    with maybe_trace(str(tmp_path), "extract"):
        _extract(pairs_bam, stats)
    events = json.loads(
        (tmp_path / "extract.pt.trace.json").read_text())["traceEvents"]
    tracks = {e["args"]["name"] for e in events
              if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {"strling engine: producer",
            "strling engine: inflate worker"} <= tracks
    spans = [e for e in events if e.get("ph") == "X"]
    by_name: dict = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    for name in ("strling.extract.engine_pop", "strling.extract.scan_wait",
                 "strling.extract.feed", "strling.extract.median",
                 "strling.engine.produce", "strling.engine.inflate"):
        assert by_name.get(name), name
    produced = {e["args"]["batch"]: e for e in by_name["strling.engine.produce"]}
    popped = {e["args"]["batch"]: e for e in by_name["strling.extract.engine_pop"]}
    assert len(popped) > 10 and set(produced) == set(popped)
    for b, pop in popped.items():
        made = produced[b]
        assert made["ts"] + made["dur"] <= pop["ts"] + pop["dur"] + 1000.0, b
    inflated = sum(e["args"]["bytes"] for e in by_name["strling.engine.inflate"])
    assert 0 < inflated <= stats["engine"]["inflate_out_bytes"]
    assert stats["engine"]["trace_buffers"] >= 2
    assert stats["engine"]["trace_dropped"] == 0


def test_bin_is_unchanged_with_tracing(pairs_bam, small_batches, tmp_path):
    bins = []
    for trace in (None, str(tmp_path / "trace")):
        with maybe_trace(trace, "extract"):
            tb, frag, bam, _ = _extract(pairs_bam)
        out = tmp_path / f"{bool(trace)}.bin"
        write_bin(str(out), tb, frag, bam.header_text, 0.8, 40)
        bins.append(out.read_bytes())
    assert bins[0] == bins[1] and len(tb) > 0
