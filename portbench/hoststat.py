"""What the host did over a stretch of a run, read from /proc: the process's
CPU time (user and system, all threads and the main thread alone), page
faults and involuntary context switches, and the whole machine's CPU time
by kind (busy, I/O wait, stolen by the hypervisor).

    a = snapshot(); ...; d = delta(a, snapshot())

`delta` gives the wall seconds, the process's CPU seconds, its minor and
major faults and involuntary switches, the CPU seconds that every other
process of the machine used (`others_cpu_s`), and the machine's I/O-wait
and steal shares of all its CPU time. Where the host reports nothing (a
sandbox whose /proc/stat reads zero) the value is None. `cpu_probe` times a
fixed piece of single-thread inflate work.
"""

from __future__ import annotations

import os
import time
import zlib

HZ = os.sysconf("SC_CLK_TCK")


def _read(path: str) -> str | None:
    try:
        with open(path) as fh:
            return fh.read()
    except OSError:
        return None


def _fields(stat: str) -> list[str]:
    return stat.rsplit(")", 1)[1].split()  # [0] is field 3 of proc(5)


def _main_thread_cpu_s() -> float | None:
    stat = _read(f"/proc/self/task/{os.getpid()}/stat")
    if not stat:
        return None
    f = _fields(stat)
    return (int(f[11]) + int(f[12])) / HZ


def snapshot() -> dict:
    s: dict = {"t": time.perf_counter()}
    stat = _read("/proc/self/stat")
    if stat:
        f = _fields(stat)
        s.update(minflt=int(f[7]), majflt=int(f[9]), user_s=int(f[11]) / HZ,
                 sys_s=int(f[12]) / HZ, cpu_s=(int(f[11]) + int(f[12])) / HZ)
    s["main_cpu_s"] = _main_thread_cpu_s()
    status = _read("/proc/self/status") or ""
    for line in status.splitlines():
        if line.startswith("nonvoluntary_ctxt_switches:"):
            s["nvcsw"] = int(line.split()[1])
    cpu = (_read("/proc/stat") or "").split("\n", 1)[0].split()
    if cpu[:1] == ["cpu"]:
        # user nice system idle iowait irq softirq steal (guest is in user)
        s["machine"] = [int(x) for x in cpu[1:9]]
    return s


def delta(a: dict, b: dict) -> dict:
    d: dict = {"wall": b["t"] - a["t"]}
    for k in ("minflt", "majflt", "user_s", "sys_s", "cpu_s", "main_cpu_s",
              "nvcsw"):
        d[k] = (b[k] - a[k] if a.get(k) is not None and b.get(k) is not None
                else None)
    d["other_threads_cpu_s"] = (d["cpu_s"] - d["main_cpu_s"]
                                if None not in (d["cpu_s"], d["main_cpu_s"])
                                else None)
    m = []
    if "machine" in a and "machine" in b and len(b["machine"]) == 8:
        m = [y - x for x, y in zip(a["machine"], b["machine"])]
    total = sum(m)
    if total > 0:
        busy_s = (total - m[3] - m[4] - m[7]) / HZ
        d["others_cpu_s"] = busy_s - d["cpu_s"] if d["cpu_s"] is not None else None
        d["iowait"] = m[4] / total
        d["steal"] = m[7] / total
    else:
        d["others_cpu_s"] = d["iowait"] = d["steal"] = None
    return d


def cpu_probe(rounds: int = 12) -> float:
    """Seconds that one thread takes to inflate a fixed 4 MB deflate stream
    `rounds` times: the host's speed at the engine's main kind of work, so
    that runs of the same input can be told apart by the host alone."""
    words = b"".join(b"%08d ACGTTGCA " % (i * 2654435761 % 99991)
                     for i in range(1 << 18))[:1 << 22]
    blob = zlib.compress(words, 4)
    t0 = time.perf_counter()
    for _ in range(rounds):
        zlib.decompress(blob)
    return time.perf_counter() - t0


def line(d: dict) -> str:
    def f(k, fmt):
        return "-" if d.get(k) is None else format(d[k], fmt)

    return (f"wall {d['wall']:.3f} s, cpu {f('cpu_s', '.2f')} s (user "
            f"{f('user_s', '.2f')}, sys {f('sys_s', '.2f')}; main thread "
            f"{f('main_cpu_s', '.2f')}, other threads "
            f"{f('other_threads_cpu_s', '.2f')}), minflt "
            f"{f('minflt', 'd')}, majflt {f('majflt', 'd')}, nvcsw "
            f"{f('nvcsw', 'd')}, others {f('others_cpu_s', '.2f')} cpu-s, "
            f"iowait {f('iowait', '.4f')}, steal {f('steal', '.4f')}")
