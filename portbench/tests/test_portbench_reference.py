"""The reference agrees with the port's plain path (--device cpu) on the
tiny cells, and `correct` comes out false with a break planted under the
timed path: the control and each fault a cell of this entry can have."""

import pytest

from portbench.tests._tiny import run_cell, tiny_checkout


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(str(tmp_path_factory.mktemp("co")))


@pytest.mark.parametrize("cell", ["t150", "t250"])
def test_reference_agrees_with_the_port(checkout, cell):
    rc, res, err = run_cell(checkout, cell, 21)
    assert rc == 0, err[-3000:]
    assert res["correct"], res["checks"]
    assert all(v["value"] == 0 for v in res["checks"].values())


@pytest.mark.parametrize("brk", ["control_no_greedy", "answer_altered",
                                 "half_batch", "stale_result"])
def test_a_planted_break_is_not_correct(checkout, brk):
    rc, res, err = run_cell(checkout, "t150", 21, breaks=(brk,))
    assert rc == 0, err[-3000:]
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())
