"""The readers of the engine's counters (`stats["engine"]` and
`stats["rss_start_bytes"]` of each pass) on a synthetic window of two
passes, and their None where a pass lacks what they read."""

import os

import pytest

from portbench.run import load_file
from portbench.tests._tiny import PKG

GIB = 2 ** 30


def _obs():
    engine = [
        {"inflate_ns": 3 * 10 ** 9, "inflate_out_bytes": 300 * 2 ** 20,
         "inflate_workers": 4, "producer_block_wait_ns": 2 * 10 ** 9,
         "producer_space_wait_ns": 0, "pop_wait_ns": 6 * 10 ** 9,
         "feed_ns": 10 ** 9, "held_bytes_peak": GIB // 2,
         "trace_buffers": 0, "trace_dropped": 0},
        {"inflate_ns": 5 * 10 ** 9, "inflate_out_bytes": 500 * 2 ** 20,
         "inflate_workers": 4, "producer_block_wait_ns": 10 ** 9,
         "producer_space_wait_ns": 0, "pop_wait_ns": 9 * 10 ** 9,
         "feed_ns": 10 ** 9, "held_bytes_peak": 3 * GIB // 4,
         "trace_buffers": 0, "trace_dropped": 0},
    ]
    rss = [5 * GIB, 4 * GIB]
    walls = [10.0, 20.0]
    return {"passes": [{"wall": w, "reads": 1000, "stats": {
        "engine": e, "rss_start_bytes": r}} for w, e, r in
        zip(walls, engine, rss)]}


@pytest.mark.parametrize("name, want, needs", [
    ("feed.engine_wait_share", 100 * 15 / 30, "engine"),
    ("engine.producer_inflate_wait_share", 100 * 3 / 30, "engine"),
    ("engine.inflate_busy_share", 100 * 8 / (4 * 30), "engine"),
    ("engine.inflate_mib_per_s", 800 / 8, "engine"),
    ("engine.held_gib_peak", 0.75, "engine"),
    ("feed.rss_start_gib", 4.0, "rss_start_bytes"),
])
def test_engine_counter_readers(name, want, needs):
    reader = load_file(os.path.join(PKG, "metrics", name + ".py"),
                       "portbench_metric_" + name.replace(".", "_"))
    obs = _obs()
    assert reader.read(obs) == pytest.approx(want)
    # a program without the counters (the parent of the change that added
    # them): nothing to read, and no error
    del obs["passes"][1]["stats"][needs]
    assert reader.read(obs) is None
    assert reader.read({"passes": []}) is None
