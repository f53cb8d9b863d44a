"""The call entry: `strling call --distributed -f REF -l LOCI -o OUT BAM BIN`
on the configuration's ranks, one card each, one whole pass per answer.

How a multi-rank entry runs. The harness process is rank 0, on the first
card. It starts ranks 1 to N-1 as processes of their own (this file's
`rank_main`, with the checkout on their path), joined with it in one
torch.distributed group through a `file://` store under the run's
temporary directory (`parallel/mesh.init_distributed`: NCCL on the cards,
Gloo on the CPU), with a timeout on the group. Before each pass rank 0
broadcasts what to run, or that the run is over; every rank then runs
`parallel/call_dist.run_call_dist` on the same inputs, and rank 0 gathers
each rank's `stats` of the pass. A thread of rank 0 watches the others: a
rank that exits before rank 0 has told it to, or with an error, ends the
run at once (non-zero exit, the others killed). Each rank holds a pipe from
rank 0 on its standard input and exits when it closes, so no rank outlives
rank 0.

Set-up imports the port, starts the ranks and the group and runs one warm
pass over the inputs' warm BAM and bin with the same catalog; the window
then runs passes over the sample back to back until one ends after
`--seconds`. Each pass's wall and host statistics are rank 0's.

What the window produced is checked against `reference.call_ref`: rank
0's three files of the last pass against the reference's text, and every
other pass's against the last. The generator computes the reference's text
with the inputs (`gen.call_inputs`), from the records it decodes for the
sample's bin; the check computes it anew only when the reference's sources
have changed since.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time

from portbench import hoststat

#: seconds the group waits in a collective or at its rendezvous
GROUP_TIMEOUT_S = 300.0
#: seconds the ranks are given to leave the group once the run is over
TEARDOWN_S = 60.0
FILES = ("genotype", "bounds", "unplaced")
CHILD = ("import sys; sys.modules['jax'] = sys.modules['strling_tpu'] = None; "
         "import importlib.util as u; "
         "s = u.spec_from_file_location('portbench_call_rank', sys.argv[1]); "
         "m = u.module_from_spec(s); s.loader.exec_module(m); "
         "sys.exit(m.rank_main(sys.argv[2:]))")


def _call_args(ctx_config: dict, fasta: str) -> dict:
    o = ctx_config["call"]
    return {"fasta": fasta, "min_support": int(o["min_support"]),
            "min_clip": int(o["min_clip"]),
            "min_clip_total": int(o["min_clip_total"]),
            "min_mapq": int(o["min_mapq"])}


def _one_pass(cmd: dict, prefix: str, device) -> dict:
    """One rank's pass: run_call_dist on the command's inputs."""
    from strling_tpu_torch.parallel.call_dist import run_call_dist

    stats: dict = {}
    t0 = time.perf_counter()
    run_call_dist(cmd["bam"], cmd["bin"], loci=cmd["loci"],
                  output_prefix=prefix, device=device, stats=stats,
                  **cmd["args"])
    stats["wall_s"] = time.perf_counter() - t0
    return stats


def rank_main(argv) -> int:
    """Ranks 1 to N-1: join the group, run every pass rank 0 broadcasts."""
    rank, world, store, device, tmp = (int(argv[0]), int(argv[1]), argv[2],
                                       argv[3], argv[4])

    def orphaned():
        # the raw descriptor, so that no lock of sys.stdin is held when the
        # interpreter shuts down; EOF: rank 0 has gone
        while os.read(0, 4096):
            pass
        os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    import torch.distributed as dist

    from strling_tpu_torch.parallel.mesh import (broadcast_blob, gather_blobs,
                                                 init_distributed)

    dev = init_distributed(device, "file://" + store, rank, world,
                           timeout=GROUP_TIMEOUT_S)
    prefix = os.path.join(tmp, f"rank{rank}")
    while True:
        cmd = pickle.loads(broadcast_blob(None))
        if cmd is None:
            break
        gather_blobs(pickle.dumps(_one_pass(cmd, prefix, dev)))
    dist.destroy_process_group()
    return 0


class Ranks:
    """Ranks 1 to N-1 as child processes, watched by a thread."""

    def __init__(self, world: int, store: str, device: str, tmp: str):
        here = os.path.abspath(__file__)
        root = os.getcwd()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        self.errs = [tempfile.TemporaryFile() for _ in range(1, world)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", CHILD, here, str(r), str(world), store,
             device, tmp], cwd=root, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=self.errs[r - 1])
            for r in range(1, world)]
        self.over = False         # rank 0 has told the ranks to stop
        self.deadline = None      # and when they must have left the group
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def tail(self, i: int) -> str:
        self.errs[i].seek(0)
        return self.errs[i].read().decode(errors="replace")[-3000:]

    def _fail(self, why: str):
        print(f"[portbench] {why}; the run ends", file=sys.stderr)
        self.kill()
        sys.stderr.flush()
        os._exit(1)

    def _watch(self):
        while not self.done.wait(0.1):
            for i, p in enumerate(self.procs):
                rc = p.poll()
                if rc is not None and (rc != 0 or not self.over):
                    self._fail(f"rank {i + 1} exited with {rc}:\n{self.tail(i)}")
            if self.deadline is not None and time.monotonic() > self.deadline:
                self._fail(f"the group did not close in {TEARDOWN_S:.0f} s")

    def close(self):
        """After the stop: wait for every rank to leave, within the
        teardown's deadline (the watcher ends the run past it); a rank
        that leaves with an error ends the run."""
        for i, p in enumerate(self.procs):
            if p.wait() != 0:
                self._fail(f"rank {i + 1} exited with {p.returncode}:\n"
                           f"{self.tail(i)}")
        self.done.set()
        self.thread.join()
        for p in self.procs:
            p.stdin.close()

    def report(self):
        """Say which ranks have exited, and how."""
        for i, p in enumerate(self.procs):
            if p.poll() is not None:
                print(f"[portbench] rank {i + 1} exited with {p.returncode}:"
                      f"\n{self.tail(i)}", file=sys.stderr)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.stdin.close()
            except OSError:
                pass


def _rss_gib() -> float:
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2 ** 30


def _thread_cpu() -> dict:
    """{thread id: (name, CPU seconds so far)} of this process's threads."""
    out = {}
    hz = os.sysconf("SC_CLK_TCK")
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as fh:
                name = fh.read().strip()
            with open(f"/proc/self/task/{tid}/stat") as fh:
                f = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        out[tid] = (name, (int(f[11]) + int(f[12])) / hz)
    return out


def _process_cpu() -> float:
    t = os.times()
    return t.user + t.system


def _digest(prefix: str) -> str:
    h = hashlib.sha256()
    for k in FILES:
        with open(f"{prefix}-{k}.txt", "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def stored_reference(inp: dict) -> dict | None:
    """The plain reference's three files as the inputs hold them, or None
    when they were made by another reference than the one here."""
    from portbench.gen.call_inputs import reference_source

    if inp.get("reference_source") != reference_source():
        return None
    ref = {"calls": inp["reference_calls"], "times": inp["reference_times"]}
    for k in FILES:
        with open(inp[f"reference_{k}"]) as fh:
            ref[k] = fh.read()
    return ref


def run(ctx) -> dict:
    import torch
    import torch.distributed as dist

    from strling_tpu_torch.parallel.mesh import (broadcast_blob, gather_blobs,
                                                 init_distributed)

    from portbench.gen.call_inputs import require_program

    require_program()
    for patch in ctx.patches:
        patch()
    inp = ctx.inputs
    world = int(ctx.config["ranks"])
    kind = "cpu" if ctx.device == "cpu" else "cuda"
    store = os.path.join(ctx.tmp, "group.store")
    ranks = Ranks(world, store, kind, ctx.tmp)
    try:
        dev = init_distributed(kind, "file://" + store, 0, world,
                               timeout=GROUP_TIMEOUT_S)
        prefix = os.path.join(ctx.tmp, "rank0")
        args = _call_args(ctx.config, inp["fasta"])

        def everyone(bam: str, bin_path: str) -> tuple[dict, list]:
            cmd = {"bam": bam, "bin": bin_path, "loci": inp["catalog"],
                   "args": args}
            broadcast_blob(pickle.dumps(cmd))
            mine = _one_pass(cmd, prefix, dev)
            per_rank = [pickle.loads(b) for b in
                        gather_blobs(pickle.dumps(mine))]
            return mine, per_rank

        h0 = hoststat.snapshot()
        everyone(inp["warm_bam"], inp["warm_bin"])
        warm = hoststat.delta(h0, hoststat.snapshot())
        print(f"[portbench] set-up: {world} ranks on {kind}; warm pass over "
              f"{inp['n_warm_records']} records: {hoststat.line(warm)}; "
              f"{time.perf_counter() - ctx.t_start:.2f} s since the inputs",
              file=sys.stderr)
        passes, digests = [], []
        before = _rss_gib()
        threads0, cpu0 = _thread_cpu(), _process_cpu()
        ctx.window_open()
        print(f"[portbench] rank 0's resident set: {before:.4f} GiB before "
              f"the window opens, {_rss_gib():.4f} GiB once it has "
              f"synchronised the {len(ctx.devices())} device(s)",
              file=sys.stderr)
        while True:
            h0 = hoststat.snapshot()
            mine, per_rank = everyone(inp["bam"], inp["bin"])
            host = hoststat.delta(h0, hoststat.snapshot())
            digests.append(_digest(prefix))
            passes.append({"wall": mine["wall_s"], "ranks": per_rank,
                           "host": host})
            if time.perf_counter() - ctx.t_open >= ctx.args.seconds:
                break
        broadcast_blob(pickle.dumps(None))
        ctx.window_close()
        threads, cpu1 = _thread_cpu(), _process_cpu()
        ranks.over = True
        ranks.deadline = time.monotonic() + TEARDOWN_S
        dist.destroy_process_group()
        ranks.close()
    except BaseException:
        ranks.report()
        ranks.kill()
        raise
    for i, x in enumerate(passes):
        walls = " ".join(f"{r['wall_s']:.3f}" for r in x["ranks"])
        print(f"[portbench] pass {i}: rank walls {walls} s; "
              f"{hoststat.line(x['host'])}", file=sys.stderr)
    for r in range(world):
        spans = {k: sum(x["ranks"][r]["span_s"][k] for x in passes) / len(passes)
                 for k in passes[0]["ranks"][r]["span_s"]}
        wait = sum(x["ranks"][r]["collective_wait_s"] for x in passes)
        print(f"[portbench] rank {r}, seconds a pass: "
              + ", ".join(f"{k} {v:.3f}" for k, v in spans.items())
              + f"; blocked in collectives {wait / len(passes):.3f}",
              file=sys.stderr)
    busy = sorted(((cpu - threads0.get(tid, (name, 0.0))[1], name)
                   for tid, (name, cpu) in threads.items()), reverse=True)
    print("[portbench] rank 0's threads, CPU seconds over the window: "
          + ", ".join(f"{n} {c:.2f}" for c, n in busy[:8])
          + f"; threads that have exited {cpu1 - cpu0 - sum(c for c, _ in busy):.2f}",
          file=sys.stderr)
    work = sum(x["ranks"][0]["work_items"] for x in passes)
    print(f"[portbench] window: {len(passes)} passes, {work} loci and "
          f"clusters in {ctx.window_s:.3f} s", file=sys.stderr)
    ctx.obs.update(passes=passes, world=world, device=dev)
    if kind == "cuda":
        torch.cuda.empty_cache()

    from portbench.reference.call_ref import compare_call

    t0 = time.perf_counter()
    ref, made = stored_reference(inp), "with the inputs"
    if ref is None:
        from portbench.reference.call_ref import reference_call

        o = ctx.config["call"]
        ref = reference_call(inp["bam"], inp["bin"], inp["catalog"],
                             int(o["min_support"]), int(o["min_mapq"]),
                             int(o["min_clip"]), int(o["min_clip_total"]),
                             threads=min(8, os.cpu_count() or 1))
        made = "now"
    got = {}
    for k in FILES:
        with open(f"{prefix}-{k}.txt") as fh:
            got[k] = fh.read()
    checks = compare_call(got, ref)
    checks["passes_differing"] = sum(d != digests[-1] for d in digests)
    stages = ", ".join(f"{k} {v:.1f} s" for k, v in ref["times"].items())
    print(f"[portbench] reference: {ref['calls']} loci and clusters, made "
          f"{made} ({stages}); read and compared in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    last_wrong = any(checks[f"{k}_lines_wrong"] for k in FILES)
    failed = len(passes) if last_wrong else checks["passes_differing"]
    e2e = {"extract_peak_rss_gib": ctx.rss_peak / 2 ** 30}
    return {"e2e": e2e, "attempted": len(passes), "failed": failed,
            "checks": {k: {"value": v, "limit": 0} for k, v in checks.items()}}
