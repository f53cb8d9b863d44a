"""The reader of `feed.fed_before_median_share` (`stats["engine"]
["fed_before_median"]` over a pass's reads) on a synthetic window of two
passes, and its None where a pass lacks the counter."""

import os

import pytest

from portbench.run import load_file
from portbench.tests._tiny import PKG

NAME = "feed.fed_before_median_share"


def _reader():
    return load_file(os.path.join(PKG, "metrics", NAME + ".py"),
                     "portbench_metric_" + NAME.replace(".", "_"))


def _obs():
    return {"passes": [
        {"wall": 10.0, "reads": 1000,
         "stats": {"engine": {"fed_before_median": 400, "median_patched": 3}}},
        {"wall": 20.0, "reads": 1000,
         "stats": {"engine": {"fed_before_median": 650, "median_patched": 5}}},
    ]}


def test_fed_before_median_share_is_the_largest_pass_share():
    assert _reader().read(_obs()) == pytest.approx(65.0)


@pytest.mark.parametrize("drop", ["counter", "engine", "reads"])
def test_fed_before_median_share_reads_nothing_without_the_counter(drop):
    # a program without the counter (the parent of the change that added
    # it), or a pass that read nothing: nothing to read, and no error
    reader = _reader()
    obs = _obs()
    second = obs["passes"][1]
    if drop == "counter":
        del second["stats"]["engine"]["fed_before_median"]
    elif drop == "engine":
        del second["stats"]["engine"]
    else:
        second["reads"] = 0
    assert reader.read(obs) is None
    assert reader.read({"passes": []}) is None
