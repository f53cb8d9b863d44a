"""The readers of the call's counters (each rank's `stats` of each pass) on
a synthetic window of two passes at two ranks, and their None where a
window lacks what they read (an extract cell's, or a program without the
counters)."""

import os

import pytest

from portbench.run import load_file
from portbench.tests._tiny import PKG


def _rank(setup, broadcast, collect, genotype, wait, work=100):
    return {"span_s": {"setup": setup, "broadcast": broadcast, "replay": 0.5,
                       "collect": collect, "genotype": genotype,
                       "oe_barrier": 0.1, "gather": 0.1, "write": 0.1},
            "collective_wait_s": wait, "work_items": work}


def _obs():
    return {"window_s": 8.0, "passes": [
        {"wall": 3.0, "ranks": [_rank(0.6, 0.1, 1.0, 0.2, 0.3),
                                _rank(0.0, 0.8, 1.4, 0.2, 1.0)]},
        {"wall": 5.0, "ranks": [_rank(0.9, 0.1, 1.2, 0.2, 0.5),
                                _rank(0.0, 1.1, 2.0, 0.2, 1.5)]}]}


@pytest.mark.parametrize("name, want", [
    ("call.loci_per_s", 200 / 8.0),
    ("call.rank0_setup_share", 100 * (0.7 + 1.0) / 8.0),
    ("call.collective_wait_share", 100 * 2.5 / 8.0),
    ("call.shard_imbalance", 3.8 / ((2.6 + 3.8) / 2)),
])
def test_call_counter_readers(name, want):
    reader = load_file(os.path.join(PKG, "metrics", name + ".py"),
                       "portbench_metric_" + name.replace(".", "_"))
    obs = _obs()
    assert reader.read(obs) == pytest.approx(want)
    # an extract cell's window: passes without ranks
    assert reader.read({"window_s": 8.0, "passes": [
        {"wall": 3.0, "reads": 10, "stats": {}}]}) is None
    assert reader.read({"window_s": 8.0, "passes": []}) is None
    # a program without the counters: nothing to read, and no error
    for r in obs["passes"][1]["ranks"]:
        r.clear()
    assert reader.read(obs) is None
