"""The benchmark of strling_tpu_torch: one cell, one run, one result line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cell, its configuration and its
metrics come from `BENCHMARK.json`; each piece is found by its name:
`portbench/configs/<config>.json` (named by the configuration's `file`),
`portbench/traffic/<traffic>.json`, `portbench/gen/<generator>.py` (named
by the traffic file), `portbench/entries/<entry>.py` (named by the
configuration) and `portbench/metrics/<metric>.py`.

A run makes (or finds in `portbench/.inputs/<cell>/`) the inputs of its
seed, sets up and warms the program on them, then runs whole passes of the
cell's entry back to back until a pass ends after `--seconds`. With
`--trace 0` it reports the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics (a torch.profiler trace of the window). It then checks
what the window produced against the plain reference under
`portbench/reference/`, prints each number compared beside its limit as its
last lines on standard error, and prints the result as one JSON line, last
on standard output. Without a CUDA device, or with fewer than the cell's
chips, it exits 2 and prints no result; so it does when the JAX package or
JAX is in `sys.modules` at the end (both are blocked at start-up).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "strling_tpu")
for _name in FORBIDDEN:
    if _name not in sys.modules:
        sys.modules[_name] = None  # an import of it now raises ImportError

PKG = os.path.dirname(os.path.abspath(__file__))


def loaded_forbidden() -> list[str]:
    """Modules in sys.modules whose top-level name is a forbidden one."""
    return sorted(k for k, v in list(sys.modules.items())
                  if v is not None and k.split(".")[0] in FORBIDDEN)


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _digest(*paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def cell_inputs(cell: str, cfg_path: str, tr_path: str,
                seed: int) -> tuple[dict, float]:
    """The inputs of (cell, seed), generated in a child process unless the
    cell's cache already holds them. Returns (manifest, seconds spent)."""
    gen = os.path.join(PKG, "gen")
    sources = sorted(os.path.join(gen, f) for f in os.listdir(gen)
                     if f.endswith(".py"))
    key = f"{_digest(cfg_path, tr_path, *sources)}-{seed}"
    d = os.path.join(PKG, ".inputs", cell)
    mpath = os.path.join(d, "manifest.json")
    if os.path.exists(mpath):
        m = read_json(mpath)
        if m.get("key") == key and all(os.path.exists(m[f]) for f in
                                       m.get("files", [])):
            return m, 0.0
    t0 = time.perf_counter()
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    subprocess.run([sys.executable, "-m", "portbench.gen", cfg_path, tr_path,
                    str(seed), d, key], check=True, stdout=sys.stderr,
                   cwd=os.path.dirname(PKG))
    return read_json(mpath), time.perf_counter() - t0


class Ctx:
    """What an entry needs from the harness, and what it hands back."""

    def __init__(self, args, cell, config, traffic, inputs, device, patches,
                 gen_s, tmp):
        self.args = args
        self.cell = cell
        self.config = config
        self.traffic = traffic
        self.inputs = inputs
        self.device = device
        self.patches = patches
        self.gen_s = gen_s
        self.tmp = tmp
        self.trace = bool(args.trace)
        from portbench.trace import Spans

        self.spans = Spans()
        self.obs: dict = {}
        self.prof = None
        self.t_start = time.perf_counter()

    def devices(self):
        import torch

        if self.device == "cpu":
            return [torch.device("cpu")]
        return [torch.device("cuda", i) for i in range(self.cell["chips"])]

    def window_open(self):
        import torch

        self.setup_s = time.perf_counter() - T0 - self.gen_s
        self.rss = RssPeak()
        for d in self.devices():
            if d.type == "cuda":
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device != "cpu":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self._win = torch.profiler.record_function("portbench.window")
            self._win.__enter__()
            self.spans.tracing = True
        self.t_open = time.perf_counter()

    def window_close(self):
        import torch

        for d in self.devices():
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        self.window_s = time.perf_counter() - self.t_open
        if self.prof is not None:
            from portbench.trace import read_trace

            self._win.__exit__(None, None, None)
            self.spans.tracing = False
            self.prof.stop()
            path = os.path.join(self.tmp, "window.pt.trace.json")
            self.prof.export_chrome_trace(path)
            self.prof = None
            self.obs["trace"] = read_trace(path)
        self.rss_peak = self.rss.stop()
        self.memory_peak_bytes = max(
            (torch.cuda.max_memory_allocated(d) for d in self.devices()
             if d.type == "cuda"), default=0)


class RssPeak:
    """The process's peak resident set over a window: /proc/self/statm read
    every 100 ms by a thread (the card's machine allows neither a reset of
    VmHWM through clear_refs nor a read of it)."""

    def __init__(self, every: float = 0.1):
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.peak = self._now()
        self.done = threading.Event()
        self.every = every
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _now(self) -> int:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * self.page

    def _loop(self):
        while not self.done.wait(self.every):
            self.peak = max(self.peak, self._now())

    def stop(self) -> int:
        self.done.set()
        self.thread.join()
        return max(self.peak, self._now())


def card_state() -> str:
    q = "name,power.limit,clocks.sm,clocks.max.sm"
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def max_sm_hz(state: str) -> float | None:
    """The first card's maximum SM clock from `card_state()`, in Hz."""
    try:
        return float(state.splitlines()[0].split(",")[3].split()[0]) * 1e6
    except (IndexError, ValueError):
        return None


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str | None = None, patches=()) -> int:
    """Run one cell. `device` "cpu" skips the look for a card and runs the
    program's plain path (for tests); `patches` are callables run once the
    program is imported (tests plant faults through them)."""
    args = parse(argv)
    root = os.getcwd()
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg_path = os.path.join(root, cfg_entry["file"])
    tr_path = os.path.join(PKG, "traffic", cell["traffic"] + ".json")
    config, traffic = read_json(cfg_path), read_json(tr_path)
    if device is None:
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        device = "cuda"

    def mine(m):
        return args.workload in m.get("workloads", [args.workload])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    per_layer = [m for m in bench["per_layer"] if mine(m)]
    inputs, gen_s = cell_inputs(cell["name"], cfg_path, tr_path, args.seed)
    print(f"[portbench] inputs of seed {args.seed}: gen_s {gen_s:.3f} "
          f"({inputs['n_records']} records)", file=sys.stderr)
    entry = load_file(os.path.join(PKG, "entries", config["entry"] + ".py"),
                      f"portbench_entry_{config['entry']}")
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = Ctx(args, cell, config, traffic, inputs, device, patches, gen_s,
                  tmp)
        out = entry.run(ctx)
    state = card_state() if device != "cpu" else ""
    if state:
        print(f"[portbench] card (name, power limit, SM clock, max SM clock): "
              f"{state}", file=sys.stderr)
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in out["checks"].values()),
              "attempted": out["attempted"], "failed": out["failed"]}
    metrics = {}
    if args.trace == 0:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        obs = dict(ctx.obs, window_s=ctx.window_s, sm_hz=max_sm_hz(state))
        for m in per_layer:
            reader = load_file(os.path.join(PKG, "metrics", m["name"] + ".py"),
                               "portbench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    import torch

    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell["chips"] if device != "cpu" else 1,
           "memory_peak_bytes": ctx.memory_peak_bytes}
    if args.trace == 1 and "trace" in ctx.obs:
        dev["busy_s"] = ctx.obs["trace"]["busy_s"]
        dev["window_s"] = ctx.obs["trace"]["window_s"]
        result["breakdown"] = {"device_ops": ctx.obs["trace"]["device_ops"],
                               "idle_gaps": ctx.obs["trace"]["idle_gaps"]}
    result["device"] = dev
    result["checks"] = out["checks"]
    bad = loaded_forbidden()
    if bad:
        print(f"[portbench] refused: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"[portbench] check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
