"""The tiny call deployment for the CPU tests: `joint5k`'s keys on `_tiny`'s
400 kb share at 10x, a 50-locus catalog and two ranks, as inputs made in a
directory (`make_inputs`) or as a cell `tcall` of a tiny checkout
(`call_checkout`)."""

from __future__ import annotations

import json
import os

from portbench.tests._tiny import PKG, tiny_checkout, tiny_config, write_bench

SEED = 2147483901


def call_config(loci: int = 50, ranks: int = 2) -> dict:
    cfg = tiny_config()
    with open(os.path.join(PKG, "configs", "joint5k.json")) as fh:
        j = json.load(fh)
    for k in ("entry", "call", "deployment", "guarantee"):
        cfg[k] = j[k]
    cfg.update(name="tinycall", ranks=ranks,
               catalog=dict(j["catalog"], loci=loci))
    return cfg


def make_inputs(out_dir: str, seed: int = SEED, coverage: int = 10) -> dict:
    from portbench.gen import call_inputs

    with open(os.path.join(PKG, "traffic", "call_2x150.json")) as fh:
        tr = json.load(fh)
    cfg = dict(call_config(), coverage=coverage)
    return call_inputs.make(cfg, tr, seed, out_dir, workers=2, device="cpu")


def call_checkout(root: str) -> str:
    """A tiny checkout with the cell `tcall` (config `tinycall`, traffic
    `call_2x150`) added, the call metrics read in it alone."""
    tiny_checkout(root)
    with open(os.path.join(root, "portbench", "configs", "tinycall.json"),
              "w") as fh:
        json.dump(call_config(), fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append(dict(bench["configs"][0], name="tinycall",
                                 file="portbench/configs/tinycall.json"))
    bench["workloads"].append({"name": "tcall", "config": "tinycall",
                               "traffic": "call_2x150", "chips": 1,
                               "why": "tiny"})
    for m in bench["per_layer"]:
        m["workloads"] = (["tcall"] if m["name"].startswith("call.")
                          else ["t150", "t250"])
    write_bench(root, bench)
    return root
