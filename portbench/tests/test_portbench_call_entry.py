"""The call entry in a tiny checkout on the CPU, at two Gloo ranks: the cell
added as new files runs and is correct, with its metrics in both kinds of
run; a break planted on rank 0 makes it incorrect; a rank killed in the
window ends the run with an error within seconds; and a program whose
`run_call_dist` counts nothing is refused before any input is made."""

import json
import os
import subprocess
import sys
import time

import pytest

from portbench.tests._tiny import REPO
from portbench.tests._tiny_call import SEED, call_checkout

CHECKS = {"genotype_lines_wrong", "bounds_lines_wrong", "unplaced_lines_wrong",
          "passes_differing"}
CALL_METRICS = {"call.loci_per_s", "call.rank0_setup_share",
                "call.collective_wait_share", "call.shard_imbalance"}

#: one run of `run.main` on the CPU with a patch of the test's own
#: (`PATCH` names one of the functions below, which run in rank 0)
CODE = """
import json, os, signal, sys, time
import portbench.run as run

def allele_too_large():
    # one genotype of rank 0's shard: allele 2 one too large (a missing
    # one read as 0) before rank 0 writes it, every pass
    from strling_tpu_torch.parallel import call_dist
    orig, first = call_dist.genotype_ls, []

    def genotype_ls(b, *a, **k):
        gt = orig(b, *a, **k)
        first[:] = first or [(b.tid, b.left)]
        if first[0] == (b.tid, b.left):
            gt.allele2 = (gt.allele2 if gt.allele2 == gt.allele2 else 0.0) + 1
        return gt
    call_dist.genotype_ls = genotype_ls

def kill_a_rank():
    # SIGKILL the other ranks as the window's first pass starts
    from strling_tpu_torch.parallel import call_dist
    orig, calls = call_dist.run_call_dist, []

    def run_call_dist(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            kids = []
            for t in os.listdir("/proc/self/task"):
                with open(f"/proc/self/task/{t}/children") as fh:
                    kids += [int(x) for x in fh.read().split()]
            with open(os.environ["KILLED_AT"], "w") as fh:
                fh.write(repr(time.time()))
            for pid in kids:
                os.kill(pid, signal.SIGKILL)
        return orig(*a, **k)
    call_dist.run_call_dist = run_call_dist

sys.exit(run.main(sys.argv[2:], device="cpu",
                  patches=[globals()[sys.argv[1]]] if sys.argv[1] else []))
"""


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return call_checkout(str(tmp_path_factory.mktemp("callco")))


def _run(root, patch="", seed=SEED, trace=0, env=None, timeout=600):
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}", **(env or {}))
    r = subprocess.run([sys.executable, "-c", CODE, patch, "--workload",
                        "tcall", "--seed", str(seed), "--seconds", "0.5",
                        "--trace", str(trace)], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    lines = r.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if r.returncode == 0 and lines else None
    return r.returncode, res, r.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_the_call_cell_runs_and_is_correct(checkout, trace):
    rc, res, err = _run(checkout, trace=trace)
    assert rc == 0, err[-3000:]
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == CHECKS
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in res["checks"].values())
    assert res["attempted"] >= 1 and res["failed"] == 0
    if trace:
        assert set(res["metrics"]) == CALL_METRICS
        assert res["metrics"]["call.loci_per_s"]["value"] > 0
        assert res["metrics"]["call.shard_imbalance"]["value"] >= 1
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {"extract_peak_rss_gib", "setup_s"}


def test_a_break_on_rank_0_is_caught(checkout):
    rc, res, err = _run(checkout, "allele_too_large")
    assert rc == 0, err[-3000:]
    assert not res["correct"]
    assert res["checks"]["genotype_lines_wrong"]["value"] == 1
    assert res["checks"]["passes_differing"]["value"] == 0
    assert res["failed"] == res["attempted"]


def test_a_killed_rank_ends_the_run(checkout, tmp_path):
    at = tmp_path / "killed_at"
    rc, res, err = _run(checkout, "kill_a_rank", env={"KILLED_AT": str(at)},
                        timeout=300)
    ended = time.time()
    assert rc != 0 and res is None
    assert ended - float(at.read_text()) < 30
    assert "rank 1" in err


def test_a_program_without_counters_is_refused(monkeypatch):
    from strling_tpu_torch.parallel import call_dist

    from portbench.gen.call_inputs import require_program

    require_program()

    def run_call_dist(bam_path, bin_path, fasta=None, device=None):
        pass

    monkeypatch.setattr(call_dist, "run_call_dist", run_call_dist)
    with pytest.raises(SystemExit):
        require_program()
