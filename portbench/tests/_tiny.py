"""A tiny checkout of the benchmark for the CPU tests: the package copied
into a temporary directory with a 400 kb share at 10x (`tiny`), two cells
(`t150`, `t250`) and the repository's metrics, and a way to run a cell
there on the CPU (`control.run_with_breaks`)."""

from __future__ import annotations

import json
import os
import shutil

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)


def tiny_config() -> dict:
    with open(os.path.join(PKG, "configs", "wgs30x.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "tiny"
    cfg["genome"]["length"] = cfg["genome_bases"] = 400_000
    cfg["contigs"][cfg["share_tid"]][1] = 400_000
    cfg["coverage"] = 10
    cfg["expansions"] = [dict(e, share_pos=p) for e, p in
                         zip(cfg["expansions"], (60_000, 150_000, 250_000, 330_000))]
    return cfg


def tiny_checkout(root: str) -> str:
    """A checkout in `root` whose BENCHMARK.json holds the tiny cells."""
    shutil.copytree(PKG, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns(".inputs", "__pycache__"))
    with open(os.path.join(root, "portbench", "configs", "tiny.json"), "w") as fh:
        json.dump(tiny_config(), fh)
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"] = [dict(bench["configs"][0], name="tiny",
                             file="portbench/configs/tiny.json")]
    bench["workloads"] = [
        {"name": "t150", "config": "tiny", "traffic": "wgs_2x150", "chips": 1,
         "why": "tiny"},
        {"name": "t250", "config": "tiny", "traffic": "wgs_2x250", "chips": 1,
         "why": "tiny"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    write_bench(root, bench)
    return root


def write_bench(root: str, bench: dict):
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh, indent=1)


def run_cell(root: str, workload: str, seed: int, trace: int = 0,
             breaks: tuple = (), pythonpath: str | None = None):
    """(exit code, result line or None, stderr) of one CPU run."""
    from portbench.control import run_with_breaks

    env = dict(os.environ, PYTHONPATH=pythonpath or f"{root}{os.pathsep}{REPO}")
    return run_with_breaks(
        ["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
         "--trace", str(trace)], breaks, device="cpu", cwd=root, env=env,
        timeout=900)
