"""On the card: a tiny cell through the harness's card path is correct, and
its control is not. Skips without a card.

    python -m pytest --noconftest -p no:cacheprovider -m cuda portbench/tests
"""

import pytest

from portbench.tests._tiny import REPO, tiny_checkout

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _run(root, breaks=()):
    import os

    from portbench.control import run_with_breaks

    rc, res, err = run_with_breaks(
        ["--workload", "t150", "--seed", "31", "--seconds", "1", "--trace", "0"],
        breaks, cwd=root, timeout=1200,
        env=dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}"))
    assert rc == 0, err[-3000:]
    return res


def test_tiny_cell_on_the_card(card, tmp_path):
    root = tiny_checkout(str(tmp_path))
    res = _run(root)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert _run(root, ["control_no_greedy"])["correct"] is False
