"""Tracing / profiling hooks (port of `strling_tpu.utils.profiling`).

The reference's only observability is stderr progress (reads/sec every 10M
reads, extract.nim:317-320). On top of that, `extract` and `call` accept
`--profile DIR` to capture a torch.profiler trace of the stage (host ops
always; the card's kernels and copies when a card is in use), written to DIR
as a Chrome trace JSON (viewable in Perfetto or chrome://tracing), plus
wall-time stage banners.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch


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
    group started inside it counts); otherwise a zero-cost no-op."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, trace_name(label)))
        print(
            f"[strling] {label}: {time.perf_counter() - t0:.2f}s; "
            f"profiler trace written to {trace_dir}",
            file=sys.stderr,
        )


@contextlib.contextmanager
def stage_timer(label: str, verbose: bool = True):
    """Wall-clock banner for a pipeline stage (cpuTime() analog,
    extract.nim:304)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if verbose:
            print(
                f"[strling] time for {label}: {time.perf_counter() - t0:.2f}s",
                file=sys.stderr,
            )
