"""Rank processes of one torch.distributed group on this host, for the
scripts (`sim_sweep --dist-check`, `cohort_demo`).

`run_ranks(code, world, init, args)` runs `python -c code` as `world`
processes with argv `[rank, world, init, *args]`, where `init` is the
absolute path of the group's `file://` store (removed first, so a stale one
from an earlier run is never joined). The ranks inherit the caller's working
directory, so relative paths in `args` mean the same to them. Their stderr
goes to temporary files (a rank may write more than a pipe holds). When a
rank fails, the others are stopped at once (a rank waiting on a dead peer
would otherwise sit out the store's timeout) and the error says which.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def run_ranks(code: str, world: int, init: str, args: list[str],
              timeout: float = 1800.0) -> list[str]:
    """Run the ranks to their end; return each rank's stderr."""
    init = os.path.abspath(init)
    if os.path.exists(init):
        os.unlink(init)
    env = dict(os.environ, PYTHONPATH=ROOT)
    errs = [tempfile.TemporaryFile() for _ in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), init, *args],
        env=env, stdout=subprocess.DEVNULL, stderr=errs[r])
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while True:
            rcs = [p.poll() for p in procs]
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                r = bad[0]
                errs[r].seek(0)
                tail = errs[r].read().decode(errors="replace")[-2000:]
                raise RuntimeError(f"rank {r} of {world} exited with "
                                   f"{rcs[r]}:\n{tail}")
            if all(rc == 0 for rc in rcs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout}s")
            time.sleep(0.05)
        out = []
        for f in errs:
            f.seek(0)
            out.append(f.read().decode(errors="replace"))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in errs:
            f.close()
