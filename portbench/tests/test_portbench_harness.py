"""The harness finds every piece of a cell by its name, runs a cell added
as new files alone, and prints the contract's result line."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.tests._tiny import PKG, REPO, run_cell, tiny_checkout, write_bench

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
                 "breakdown"}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(str(tmp_path_factory.mktemp("co")))


def test_every_cell_finds_its_pieces():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        with open(os.path.join(REPO, configs[w["config"]]["file"])) as fh:
            cfg = json.load(fh)
        assert os.path.exists(os.path.join(PKG, "entries", cfg["entry"] + ".py"))
        with open(os.path.join(PKG, "traffic", w["traffic"] + ".json")) as fh:
            tr = json.load(fh)
        assert os.path.exists(os.path.join(PKG, "gen", tr["generator"] + ".py"))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(PKG, "metrics", m["name"] + ".py"))
        assert m["moves"] in e2e
    assert "setup_s" in e2e


def test_a_cell_added_as_new_files_runs(checkout):
    """A new traffic mix, configuration and per-layer metric, added as
    files, with the cell and the metric named in BENCHMARK.json."""
    pb = os.path.join(checkout, "portbench")
    with open(os.path.join(pb, "traffic", "wgs_2x150.json")) as fh:
        tr = json.load(fh)
    tr.update(read_length=100, insert_mean=300, insert_sd=60)
    with open(os.path.join(pb, "traffic", "wgs_2x100.json"), "w") as fh:
        json.dump(tr, fh)
    with open(os.path.join(pb, "configs", "tiny.json")) as fh:
        cfg = json.load(fh)
    cfg["name"], cfg["coverage"] = "tiny5x", 5
    with open(os.path.join(pb, "configs", "tiny5x.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(pb, "metrics", "feed.batches_per_pass.py"), "w") as fh:
        fh.write("def read(obs):\n"
                 "    p = obs.get('passes') or []\n"
                 "    return sum(x['stats'].get('n_batches', 0) for x in p) / len(p) if p else None\n")
    with open(os.path.join(checkout, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append(dict(bench["configs"][0], name="tiny5x",
                                 file="portbench/configs/tiny5x.json"))
    bench["workloads"].append({"name": "t100", "config": "tiny5x",
                               "traffic": "wgs_2x100", "chips": 1, "why": "new"})
    bench["per_layer"].append({"name": "feed.batches_per_pass", "unit": "batches",
                               "better": "lower", "source": "program_counter",
                               "layer": "feed loop", "moves": "extract_peak_rss_gib",
                               "workloads": ["t100"]})
    write_bench(checkout, bench)
    rc, res, err = run_cell(checkout, "t100", 5, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"], res["checks"]
    assert res["metrics"]["feed.batches_per_pass"]["value"] > 0


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys(checkout, trace):
    rc, res, err = run_cell(checkout, "t150", 11, trace=trace)
    assert rc == 0, err[-3000:]
    keys = list(res)
    assert keys[-1] == "checks"  # the numbers compared come last
    assert set(keys[:-1]) <= CONTRACT_KEYS
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(keys)
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "extract_peak_rss_gib" not in res["metrics"]
        assert res["metrics"]["entry.extract_reads_per_s"]["value"] > 0
    else:
        assert set(res["metrics"]) == {"extract_peak_rss_gib", "setup_s"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    assert "[portbench] check" in err.strip().splitlines()[-1]


def test_no_card_no_result(checkout):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go ahead")
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "t150", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=checkout, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=f"{checkout}{os.pathsep}{REPO}"))
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_files_alone_fail(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    root = str(tmp_path)
    shutil.copytree(PKG, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns(".inputs", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    rc, res, _ = run_cell(root, "extract.wgs30x_150", 1, pythonpath=root)
    assert rc != 0 and res is None
