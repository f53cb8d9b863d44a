"""The package's repeat-scan kernel against another build of it, in turns,
and a torch.profiler trace of extract on the card (experiment tool).

    python -m strling_tpu_torch.scripts.exp_kernel_compare \\
        --other DIR/repeat_scan.cu [--trace-reads N] [--out FILE]

`--other` is another version of ops/csrc/repeat_scan.cu (a parent commit's,
unpacked with `git archive`) with this one's C interface, or the earlier one
whose launcher does not report its design (no `repeat_scan_stage_cycles`
symbol). It is built with
the package's nvcc flags next to itself. On each shape and modal (pairwise,
then sorted) both kernels must give the same (code, length, count); then
both are timed with `device_ms` (10 launches queued behind a sleeping kernel,
median of 25), twice, the second time in the reverse order, so the calls run
other, this, this, other. Shapes: n8 rows of the bench mix at 4096x152 (an
extract batch), 32768x152 and 65536x152, and ASCII rows at 32768x152.

With --trace-reads N it generates the N-read bench BAM (150bp pairs, every
20th pair's second read a pure STR; cached under .smoke_cache/), runs
`extract_native` on the card once to warm up and once under torch.profiler,
and reports each kernel's device time and launches from the trace, the
device's busy time (kernels and copies) and the wall.

Each result is printed as one JSON line and, with --out, appended to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from strling_tpu_torch.ops import kmer as K
from strling_tpu_torch.ops import kmer_cuda
from strling_tpu_torch.scripts.exp_kernel_timing import bench_batch, device_ms

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CACHE = os.path.join(ROOT, ".smoke_cache")


def bench_bam(path: str, n_pairs: int, seed: int = 7, n_chrom: int = 1):
    """bench.py's _bench_bam: 150bp proper pairs, every 20th pair's second
    read a pure STR, the rest random sequence, on one 50Mb contig.

    With n_chrom > 1 the 50Mb are n_chrom contigs (chrB0, chrB1, ...) and
    one pair in 100 is split across two of them (the second read on the next
    contig, not a proper pair; in every third such pair that read is a pure
    CAG at mapping quality 0): the mate traffic between the shards of a
    distributed extract. The proper pairs are the one-contig BAM's."""
    from strling_tpu_torch.io import BamRecord, write_bam

    rng = np.random.default_rng(seed)
    L, G = 150, 50_000_000
    units = ["CAG", "A", "AT", "AAGGG", "ATTCT"]
    recs = []
    pos = np.sort(rng.integers(0, G - 2000, n_pairs))
    isizes = rng.integers(300, 500, n_pairs)
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n_pairs, 2, L))]
    C = G // n_chrom
    names = ["chrB"] if n_chrom == 1 else [f"chrB{t}" for t in range(n_chrom)]
    for i in range(n_pairs):
        t, p = divmod(int(pos[i]), C)
        p = min(p, C - 2000)
        isz = int(isizes[i])
        s1 = seqs[i, 0].tobytes().decode()
        s2 = seqs[i, 1].tobytes().decode()
        if i % 20 == 0:
            u = units[i % len(units)]
            s2 = (u * (L // len(u) + 1))[:L]
        q = f"r{i}"
        if n_chrom > 1 and i % 100 == 50:
            t2, p2, mq2 = (t + 1) % n_chrom, p + isz, 60
            if i % 300 == 50:
                s2, mq2 = ("CAG" * 50)[:L], 0
            recs.append(BamRecord(q, 0x61, t, p, 60, [(L, 0)], t2, p2, 0, s1))
            recs.append(BamRecord(q, 0x91, t2, p2, mq2, [(L, 0)], t, p, 0,
                                  s2))
            continue
        recs.append(BamRecord(q, 0x63, t, p, 60, [(L, 0)], t, p + isz - L,
                              isz, s1))
        recs.append(BamRecord(q, 0x93, t, p + isz - L, 60, [(L, 0)], t, p,
                              -isz, s2))
    recs.sort(key=lambda r: (r.tid, r.pos))
    hdr = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{C}\n" for n in names)
    write_bam(path + ".tmp", hdr, [(n, C) for n in names], recs)
    os.replace(path + ".tmp.bai", path + ".bai")
    os.replace(path + ".tmp", path)


def build_other(source: str):
    """Build `source` with the package's flags into a library next to it;
    return the loaded library and nvcc's output."""
    out = os.path.join(os.path.dirname(os.path.abspath(source)),
                       "librepeat_scan_other.so")
    proc = subprocess.run([kmer_cuda.nvcc_path(), *kmer_cuda.NVCC_FLAGS, "-o",
                           out, source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    lib.repeat_scan_launch.restype = ctypes.c_int
    argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    if hasattr(lib, "repeat_scan_stage_cycles"):  # reports its design
        argtypes.append(ctypes.POINTER(ctypes.c_int))
    lib.repeat_scan_launch.argtypes = argtypes
    return lib, proc.stdout + proc.stderr


def other_scan(lib, x, layout, lengths=None, te=None, tp=None,
               modal="pairwise"):
    """The other build's full form with `modal` on the current stream."""
    B, width = x.shape
    L = width if layout == "ascii" else K.payload_geometry(width, layout)[0]
    outs = [torch.empty(B, dtype=torch.int32, device=x.device)
            for _ in range(3)]
    ptrs = ([t.data_ptr() for t in (lengths, te, tp)] if layout == "ascii"
            else [None] * 3)
    design = ([ctypes.byref(ctypes.c_int())]
              if len(lib.repeat_scan_launch.argtypes) > 15 else [])
    rc = lib.repeat_scan_launch(
        x.data_ptr(), B, width, {"ascii": 0, "n8": 1}[layout], L, None,
        *ptrs, K.MODALS.index(modal), 0, *(t.data_ptr() for t in outs),
        torch.cuda.current_stream().cuda_stream, *design)
    if rc != 0:
        raise RuntimeError(f"the other kernel's launch failed: {rc}")
    return outs


def compare(lib, dev, emit):
    for layout, B in (("n8", 4096), ("n8", 32768), ("n8", 65536),
                      ("ascii", 32768)):
        bases, lengths = bench_batch(B, 152)
        props = np.full(B, 0.8)
        if layout == "n8":
            payload, got = K.fuse_payload(bases, lengths, props,
                                          return_layout=True)
            assert got == "n8", got
            x, named = torch.from_numpy(payload).to(dev), {}
        else:
            te, tp = K._host_thresholds(lengths, props)
            x = torch.from_numpy(bases).to(dev)
            named = {k: torch.from_numpy(v).to(dev) for k, v in
                     (("lengths", lengths), ("te", te), ("tp", tp))}

        for modal in K.MODALS:
            def this(modal=modal):
                return kmer_cuda.repeat_scan(x, layout, modal=modal, **named)

            def other(modal=modal):
                return other_scan(lib, x, layout, modal=modal, **named)

            mism = sum(int((a != b).sum()) for a, b in zip(this(), other()))
            if mism:
                raise RuntimeError(f"{layout} {B}x152 {modal}: the kernels "
                                   f"disagree on {mism} values")
            first = device_ms({"other": other, "this": this})
            second = device_ms({"this": this, "other": other})
            emit({"shape": f"{layout} {B}x152", "modal": modal,
                  "mismatches": mism,
                  "other_ms": [first["other"], second["other"]],
                  "this_ms": [first["this"], second["this"]]})


def trace_extract(n_reads: int, dev, emit):
    from strling_tpu_torch.core.extract import extract_native
    from strling_tpu_torch.io import Bam

    os.makedirs(CACHE, exist_ok=True)
    bam = os.path.join(CACHE, f"bench_{n_reads // 2}.bam")
    if not os.path.exists(bam):
        bench_bam(bam, n_reads // 2)
    extract_native(Bam(bam), None, None, devices=[dev])  # warm up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        extract_native(Bam(bam), None, None, devices=[dev])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    kernels, spans = {}, []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy",
                                                      "gpu_memset"):
            continue
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += float(e["dur"])
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # the union of the device's intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    emit({"trace": f"extract_native, {n_reads} reads", "wall_s": wall,
          "device_busy_us": busy,
          "idle_share": 1 - busy / (wall * 1e6),
          "kernels": {name: {"launches": n, "us": us, "us_per_launch": us / n}
                      for name, (n, us) in kernels.items()}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="another repeat_scan.cu to build and compare")
    ap.add_argument("--trace-reads", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_kernel_compare needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()

    def emit(rec):
        rec = {"card": smi, **rec}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")

    lib, log = build_other(args.other)
    kmer_cuda.library_path()
    for name, text in (("other", log), ("this", kmer_cuda.build_log)):
        emit({"ptxas": name, "lines": [ln.strip() for ln in text.splitlines()
                                       if "registers" in ln or "spill" in ln
                                       or "Compiling entry" in ln]})
    compare(lib, dev, emit)
    if args.trace_reads:
        trace_extract(args.trace_reads, dev, emit)


if __name__ == "__main__":
    main()
