"""Spans of the benchmark's own, and the reading of a torch.profiler trace.

`Spans`, while a profiler runs, names blocks of the host's work in its
trace (`record_function`), so the trace's idle gaps can be put down to what
the host was doing. `read_trace` reduces a Chrome trace to the
device's busy time inside the window, device time by operation, and the
longest idle gaps with the innermost span around each.
"""

from __future__ import annotations

import contextlib
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


class Spans:
    def __init__(self):
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.tracing:
            import torch

            with torch.profiler.record_function(name):
                yield
        else:
            yield


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read_trace(path: str) -> dict:
    """busy_s, window_s, device time by name, device events, idle gaps."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    dev, spans, win = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", "?")))
        elif cat == "user_annotation":
            if e.get("name") == WINDOW:
                win = (ts, ts + dur)
            else:
                spans.append((ts, ts + dur, e.get("name", "?")))
    if win is None:
        raise RuntimeError("the trace holds no window span")
    a, b = win
    inside = [(max(s, a), min(t, b), n) for s, t, n in dev if t > a and s < b]
    busy = _union([(s, t) for s, t, _ in inside])
    by_name: dict[str, float] = {}
    for s, t, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-6
    gaps = []
    cur = a
    for s, t in busy + [(b, b)]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    labelled = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (g0 + g1) / 2
        around = [(t - s, n) for s, t, n in spans if s <= mid <= t]
        label = min(around)[1] if around else "host outside the benchmark's spans"
        labelled.append([label, (g1 - g0) * 1e-6])
    return {
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "window_s": (b - a) * 1e-6,
        "by_name": by_name,
        "device_ops": sorted(([n, v] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": labelled,
    }
