"""Runs of a cell with a break planted under the timed path: the control
and the faults of `portbench.faults`, at the cell's own size.

    python3 -m portbench.control --workload NAME --seeds 1,2,3 [--break control_no_greedy] [--seconds 1]

Each seed runs in a process of its own (a patch stays for the life of the
process) through `run.main`, and prints its result line; the summary gives
each seed's compared numbers. The benchmark's own runs never plant a break.
`run_with_breaks` is the one way the tests run a cell, too.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

CODE = ("import json, sys; import portbench.run as r, portbench.faults as f; "
        "a = json.loads(sys.argv[1]); sys.exit(r.main(sys.argv[2:], "
        "device=a['device'], patches=[f.ALL[b] for b in a['breaks']]))")


def run_with_breaks(args: list, breaks=(), device: str | None = None,
                    **kw) -> tuple[int, dict | None, str]:
    """(exit code, result line or None, standard error) of one run of
    `run.main(args)` in a process of its own, with the named breaks of
    `faults` planted; `device` "cpu" runs the program's plain path. `kw`
    goes to `subprocess.run` (cwd, env, timeout)."""
    r = subprocess.run([sys.executable, "-c", CODE,
                        json.dumps({"device": device, "breaks": list(breaks)}),
                        *args], capture_output=True, text=True, **kw)
    lines = r.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if r.returncode == 0 and lines else None
    return r.returncode, res, r.stderr


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--break", dest="brk", default="control_no_greedy")
    p.add_argument("--seconds", default="1")
    args = p.parse_args(argv)
    rows = []
    for seed in args.seeds.split(","):
        rc, res, err = run_with_breaks(
            ["--workload", args.workload, "--seed", seed, "--seconds",
             args.seconds, "--trace", "0"], [args.brk])
        sys.stderr.write(err[-3000:])
        checks = {k: v["value"] for k, v in res["checks"].items()} if res else None
        rows.append({"seed": int(seed), "rc": rc,
                     "correct": res["correct"] if res else None,
                     "checks": checks})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"break": args.brk, "workload": args.workload,
                      "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
