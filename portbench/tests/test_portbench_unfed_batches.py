"""The reader of `feed.unfed_batches_peak` (`stats["unfed_batches_peak"]`
of a pass) on a synthetic window of three passes, and its None where a
pass lacks the counter."""

import os

import pytest

from portbench.run import load_file
from portbench.tests._tiny import PKG

NAME = "feed.unfed_batches_peak"


def _reader():
    return load_file(os.path.join(PKG, "metrics", NAME + ".py"),
                     "portbench_metric_" + NAME.replace(".", "_"))


def _obs():
    return {"passes": [
        {"wall": 10.0, "reads": 1000, "stats": {"unfed_batches_peak": 1}},
        {"wall": 20.0, "reads": 1000, "stats": {"unfed_batches_peak": 2}},
        {"wall": 15.0, "reads": 1000, "stats": {"unfed_batches_peak": 2}},
    ]}


def test_unfed_batches_peak_is_the_largest_over_the_passes():
    assert _reader().read(_obs()) == 2


@pytest.mark.parametrize("which", [0, 2])
def test_unfed_batches_peak_reads_nothing_without_the_counter(which):
    # a program without the counter (the parent of the change that added
    # it): nothing to read, and no error
    reader = _reader()
    obs = _obs()
    del obs["passes"][which]["stats"]["unfed_batches_peak"]
    assert reader.read(obs) is None
    assert reader.read({"passes": []}) is None
    assert reader.read({}) is None
