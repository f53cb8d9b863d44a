"""Tracing / profiling hooks (port of `strling_tpu.utils.profiling`).

The reference's only observability is stderr progress (reads/sec every 10M
reads, extract.nim:317-320). On top of that, `extract` and `call` accept
`--profile DIR` to capture a torch.profiler trace of the stage (host ops
always; the card's kernels and copies when a card is in use), written to DIR
as a Chrome trace JSON (viewable in Perfetto or chrome://tracing). An
extract trace also holds the feed loop's `strling.extract.*` spans and a
track for each of the engine's producer and inflate threads, on the
profiler's time axis.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import sys
import time

import torch

#: the span `maybe_trace` reads the clock inside, to place the engine's
#: spans on the trace's time axis
ANCHOR = "strling.clock_anchor"
#: the engine's span kinds (`sio::SpanKind`): (event name, thread track name)
ENGINE_SPANS = {0: ("strling.engine.produce", "strling engine: producer"),
                1: ("strling.engine.inflate", "strling engine: inflate worker")}

_SINK: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "strling_engine_spans", default=None)


def engine_span_sink() -> list | None:
    """The list a running `maybe_trace` collects the extract engine's span
    events in (arrays of `NativeExtractor.trace_events` rows), or None."""
    return _SINK.get()


def trace_name(label: str) -> str:
    """The trace file's name: `<label>.pt.trace.json` in a single process
    (a world of one included), `<label>.rank<r>.pt.trace.json` when a group
    of more than one rank is up or torchrun's RANK is set, so that ranks
    sharing a directory keep a trace each."""
    import torch.distributed as dist

    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return f"{label}.rank{dist.get_rank()}.pt.trace.json"
    if "RANK" in os.environ:
        return f"{label}.rank{int(os.environ['RANK'])}.pt.trace.json"
    return f"{label}.pt.trace.json"


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None, label: str = "stage"):
    """Capture a torch.profiler trace of the enclosed block when a directory
    is given (`DIR/` + `trace_name(label)`, named when the block ends, so a
    group started inside it counts); otherwise a zero-cost no-op. The
    extract engine's spans of the block are merged into it
    (`_merge_engine_spans`)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    sink: list = []
    token = _SINK.set(sink)
    # shapes recorded: the feed loop's spans carry their batch as an input
    prof = profile(activities=activities, record_shapes=True)
    prof.start()
    reads = []
    for _ in range(3):
        with torch.profiler.record_function(ANCHOR):
            reads.append(time.perf_counter_ns())
    try:
        yield
    finally:
        _SINK.reset(token)
        prof.stop()
        path = os.path.join(trace_dir, trace_name(label))
        prof.export_chrome_trace(path)
        _merge_engine_spans(path, reads, sink)
        print(
            f"[strling] {label}: {time.perf_counter() - t0:.2f}s; "
            f"profiler trace written to {trace_dir}",
            file=sys.stderr,
        )


def _merge_engine_spans(path: str, reads: list[int], sink: list) -> None:
    """Put the engine's spans into the Chrome trace at `path`, one track
    per engine thread, and give the feed loop's `strling.extract.*` spans
    their batch number as `args["batch"]`.

    `reads` are perf_counter_ns readings taken inside the trace's `ANCHOR`
    spans, in order. Each anchor's `ts` minus its reading is the offset from
    the steady clock (the engine's, and perf_counter's) to the trace's axis,
    too low by the time from the span's start to the reading; the largest
    of them is used, whatever clock the profiler keeps its axis on."""
    with open(path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"]
    anchors = sorted((e for e in events
                      if e.get("name") == ANCHOR and e.get("ph") == "X"),
                     key=lambda e: float(e["ts"]))
    if len(anchors) != len(reads):
        raise RuntimeError(f"{path}: {len(anchors)} clock anchors, "
                           f"{len(reads)} readings")
    offset_us = max(float(e["ts"]) - r / 1e3 for e, r in zip(anchors, reads))
    pid = anchors[0]["pid"]
    for e in events:
        if (e.get("cat") == "user_annotation"
                and e.get("name", "").startswith("strling.extract.")):
            args = e.setdefault("args", {})
            inputs = args.get("Concrete Inputs")
            if inputs and inputs[0] != "":
                args["batch"] = int(inputs[0])
    tracks = {}
    for rows in sink:
        for kind, tid, t0, t1, a, b in rows.tolist():
            name, track = ENGINE_SPANS[kind]
            tracks[tid] = track
            args = ({"batch": a, "block_wait_us": b / 1e3} if kind == 0
                    else {"blocks": a, "bytes": b})
            events.append({"ph": "X", "cat": "strling_engine", "name": name,
                           "pid": pid, "tid": tid,
                           "ts": t0 / 1e3 + offset_us,
                           "dur": (t1 - t0) / 1e3, "args": args})
    for tid, track in tracks.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": track}})
    with open(path, "w") as fh:
        json.dump(trace, fh)


class PhaseClock:
    """The phases of one run of a stage, back to back: each one a
    `<prefix><phase>` span (`record_function`, seen by any running
    profiler) and its wall seconds in `stats["span_s"][phase]`. `blocked()`
    adds the seconds spent inside it, in collectives, to
    `stats["collective_wait_s"]`. Every phase named at creation reads 0.0
    until it runs; `switch(None)` ends the open phase."""

    def __init__(self, stats: dict | None, prefix: str, phases=()):
        self.stats = stats if stats is not None else {}
        self.stats["span_s"] = dict.fromkeys(phases, 0.0)
        self.stats["collective_wait_s"] = 0.0
        self.prefix = prefix
        self._open = None

    def switch(self, phase: str | None):
        """End the open phase, then start `phase` (None: none)."""
        now = time.perf_counter()
        if self._open is not None:
            name, t0, span = self._open
            span.__exit__(None, None, None)
            spans = self.stats["span_s"]
            spans[name] = spans.get(name, 0.0) + now - t0
            self._open = None
        if phase is not None:
            span = torch.profiler.record_function(self.prefix + phase)
            span.__enter__()
            self._open = (phase, time.perf_counter(), span)

    @contextlib.contextmanager
    def blocked(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats["collective_wait_s"] += time.perf_counter() - t0
