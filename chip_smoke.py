"""Smoke run of strling_tpu_torch on one CUDA card: build, check, drive.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. environment: the card's name and power limit, CUDA, nvcc, Triton;
  2. build the host engine library and the CUDA repeat-unit kernel from the
     sources in the checkout, timed;
  3. the kernel against its plain PyTorch twin on the card and against the
     detector's pure-Python specification (`ops.oracle.get_repeat`, held
     equal to the JAX package's by the CPU tests), on every input
     layout (n8, w8 with Ns, w16, ASCII with IUPAC bytes) at the production
     batch sizes, plus the F1 (k=3 lane-field carry, 256bp CAG/TTC mixtures)
     and F2 (256bp and 264bp homopolymer) rows; requires 0 mismatches and
     times kernel and twin per batch (CUDA events, median of 25);
  4. the main path through the CLI (simulate -> index -> extract -> call)
     on a planted CAG expansion, an `extract --device cpu` whose bin must be
     byte-identical, and an extract of a 500k-read WGS-like BAM; the
     kernel's launch count over this phase must be > 0.

The second-to-last line is a JSON object describing the kernel; the last
line is {"ok": true, "device": {...}}. Everything it generates goes under
.smoke_cache/ in the checkout. It imports torch, numpy and strling_tpu_torch
only (whose host I/O is the JAX package's JAX-free code).
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".smoke_cache")
KERNEL_SOURCE = "strling_tpu_torch/ops/csrc/repeat_scan.cu"
REPLACES = "strling_tpu/ops/kmer_pallas.py:200"
LOCUS = 20000


def say(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs


def kernel_batch(B: int, L: int):
    """bench.py's _kernel_batch mix: random reads, every 10th a pure STR."""
    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    bases = alphabet[rng.integers(0, 4, (B, L))]
    units = [b"CAG", b"A", b"AT", b"AAGGG", b"ATTCT"]
    for i in range(0, B, 10):
        u = units[i % len(units)]
        bases[i] = np.frombuffer((u * (L // len(u) + 1))[:L], np.uint8)
    return bases, np.full(B, L, np.int32)


def with_short_and_n(bases, lengths, seed):
    """Short-read tails (length 100, zero padded) and N runs (the >20 N
    skip and the w8 N plane)."""
    bases, lengths = bases.copy(), lengths.copy()
    lengths[::17] = 100
    bases[::17, 100:] = 0
    bases[1::50, 40:70] = ord("N")
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, len(bases), len(bases) // 20)
    bases[rows, rng.integers(0, 100, len(rows))] = ord("N")
    return bases, lengths


def f1_tile(L: int = 256):
    """1024-row tile: rows 0-255 short random reads, rows 256-511 full
    length CAG/TTC mixtures (the second 8-bit lane field of the TPU
    kernel's k=3 SWAR modal), the rest random at full length."""
    rng = np.random.default_rng(11)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    bases = alphabet[rng.integers(0, 4, (1024, L))]
    lengths = np.full(1024, L, np.int32)
    lengths[:256] = rng.integers(20, 100, 256)
    for i in range(256):
        bases[i, lengths[i]:] = 0
    for i in range(256, 512):
        p = rng.uniform(0.2, 0.8)
        units = np.where(rng.random(L // 3 + 1) < p, 0, 1)
        s = b"".join((b"CAG", b"TTC")[u] for u in units)[:L]
        bases[i] = np.frombuffer(s, np.uint8)
    return bases, lengths


def f2_rows(L: int = 264):
    rows = [b"A" * 256, b"A" * 264, b"C" * 256, b"T" * 264, b"CA" * 132]
    bases = np.zeros((len(rows), L), np.uint8)
    for i, r in enumerate(rows):
        bases[i, :len(r)] = np.frombuffer(r, np.uint8)
    return bases, np.array([len(r) for r in rows], np.int32)


def bench_bam(path: str, n_pairs: int, seed: int = 7):
    """bench.py's _bench_bam: 150bp proper pairs, every 20th pair's second
    read a pure STR, the rest random sequence, on one 50Mb contig."""
    from strling_tpu_torch.io import BamRecord, write_bam

    rng = np.random.default_rng(seed)
    L, G = 150, 50_000_000
    alphabet = np.array(list("ACGT"))
    units = ["CAG", "A", "AT", "AAGGG", "ATTCT"]
    recs = []
    pos = np.sort(rng.integers(0, G - 2000, n_pairs))
    isizes = rng.integers(300, 500, n_pairs)
    seqs = alphabet[rng.integers(0, 4, (n_pairs, 2, L))]
    for i in range(n_pairs):
        p = int(pos[i])
        isz = int(isizes[i])
        s1 = "".join(seqs[i, 0])
        s2 = "".join(seqs[i, 1])
        if i % 20 == 0:
            u = units[i % len(units)]
            s2 = (u * (L // len(u) + 1))[:L]
        q = f"r{i}"
        recs.append(BamRecord(q, 0x63, 0, p, 60, [(L, 0)], 0, p + isz - L,
                              isz, s1))
        recs.append(BamRecord(q, 0x93, 0, p + isz - L, 60, [(L, 0)], 0, p,
                              -isz, s2))
    recs.sort(key=lambda r: r.pos)
    hdr = "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chrB\tLN:%d\n" % G
    write_bam(path + ".tmp", hdr, [("chrB", G)], recs)
    os.replace(path + ".tmp.bai", path + ".bai")
    os.replace(path + ".tmp", path)


# ------------------------------------------------------------------ phases


def phase_env():
    say("== 1. environment")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs one card")
    say(smi_line())
    say(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}")
    from strling_tpu_torch.ops.kmer_cuda import nvcc_path

    say(subprocess.run([nvcc_path(), "--version"], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[-1])
    try:
        import triton
        say(f"triton {triton.__version__}")
    except ImportError:
        say("triton not installed")


def phase_build():
    say("== 2. build")
    from strling_tpu_torch.io import hostlib
    from strling_tpu_torch.ops import kmer_cuda

    missing = hostlib.missing_headers()
    say("host engine: " + (f"compat build, missing {', '.join(missing)}"
                           if missing else "system libdeflate and liblzma"))
    t0 = time.perf_counter()
    path = hostlib.load()
    say(f"host engine library {path} in {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    path = kmer_cuda.library_path()
    say(f"repeat_scan kernel {path} in {time.perf_counter() - t0:.2f}s")
    say(kmer_cuda.build_log.strip() or "(library was already built)")


def _median_ms(fn, reps=25, warm=3):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def phase_kernel():
    say("== 3. kernel vs plain twin vs oracle")
    from strling_tpu_torch.ops import kmer as K
    from strling_tpu_torch.ops import oracle
    from strling_tpu_torch.ops.kmer_cuda import repeat_scan

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    max_err = 0
    timings = {}

    def check(name, bases, lengths, props, want_layout, oracle_rows):
        nonlocal max_err
        bases = np.ascontiguousarray(bases)
        if want_layout == "ascii":
            te, tp = K._host_thresholds(lengths, props)
            args = [torch.from_numpy(a).to(dev) for a in (bases, lengths, te, tp)]
            x, rest = args[0], args[1:]
        else:
            payload, layout = K.fuse_payload(bases, lengths, props,
                                             return_layout=True)
            if layout != want_layout:
                raise RuntimeError(f"{name}: layout {layout}, want {want_layout}")
            x, rest = torch.from_numpy(payload).to(dev), []
        got = repeat_scan(x, want_layout, *rest)
        twin = K.repeat_codes_plain(x, want_layout, *rest)
        torch.cuda.synchronize()
        got = [t.cpu().numpy() for t in got]
        twin = [t.cpu().numpy() for t in twin]
        mism = int(sum((g != w).sum() for g, w in zip(got, twin)))
        max_err = max(max_err, max(int(np.abs(g.astype(np.int64) - w).max(initial=0))
                                   for g, w in zip(got, twin)))
        units = K.unpack_unit_codes(got[0], got[1])
        bad_oracle = 0
        for i in oracle_rows:
            read = bases[i, :lengths[i]].tobytes().decode()
            if oracle.get_repeat(read, float(props[i])) != (units[i], int(got[2][i])):
                bad_oracle += 1
        say(f"{name}: B={len(bases)} L={bases.shape[1]} layout={want_layout} "
            f"kernel-vs-twin mismatches {mism}, kernel-vs-oracle mismatches "
            f"{bad_oracle}/{len(oracle_rows)}")
        if mism or bad_oracle:
            raise RuntimeError(f"{name}: kernel disagrees")
        return x, rest

    def sample(B, special=()):
        rows = set(rng.choice(B, size=min(B, 2048), replace=False).tolist())
        return sorted(rows | set(special))

    for B in (32768, 65536):
        bases, lengths = kernel_batch(B, 152)
        props = np.full(B, 0.8)
        x, _ = check(f"kernel_batch {B}", bases, lengths, props, "n8", sample(B))
        timings[B] = (_median_ms(lambda: repeat_scan(x, "n8")),
                      _median_ms(lambda: K.repeat_codes_plain(x, "n8")))
        say(f"n8 {B}x152: kernel {timings[B][0]:.4f} ms/batch, plain twin "
            f"{timings[B][1]:.4f} ms/batch (median of 25)")
        nb, nl = with_short_and_n(bases, lengths, B)
        check(f"kernel_batch {B} + N", nb, nl, props, "w8", sample(B))

    bases, lengths = kernel_batch(4096, 256)
    bases, lengths = with_short_and_n(bases, lengths, 3)
    check("kernel_batch 4096 L=256", bases, lengths, np.full(4096, 0.8),
          "w16", sample(4096))
    iu = bases.copy()
    iu[3::40, 10] = ord("R")
    iu[7::40, 60:64] = np.frombuffer(b"YSWK", np.uint8)
    iu[11::200] = np.frombuffer((b"CAR" * 90)[:256], np.uint8)
    check("ascii + IUPAC", iu, lengths, np.full(4096, 0.6), "ascii",
          sample(4096, range(3, 4096, 40)))

    for L, layout in ((256, "w16"), (248, "n8")):
        fb, fl = f1_tile(L)
        check(f"F1 tile L={L}", fb, fl, np.full(1024, 0.8), layout,
              range(1024))
    fb, fl = f2_rows()
    check("F2 homopolymers", fb, fl, np.full(len(fl), 0.8), "w16",
          range(len(fl)))
    return timings, max_err


def phase_main_path(work: str):
    say("== 4. main path: simulate -> index -> extract -> call")
    from strling_tpu_torch import cli
    from strling_tpu_torch.io import Bam, build_fai, write_fasta
    from strling_tpu_torch.core.extract import extract_native
    from strling_tpu_torch.ops import kmer_cuda

    rng = np.random.default_rng(2)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40000)])
    # a short CAG at the simulated locus, and two reference STRs for index
    seq = (seq[:LOCUS] + "CAG" * 10 + seq[LOCUS:30000] + "AT" * 60
           + seq[30000:35000] + "AAGGG" * 30 + seq[35000:])
    fa = os.path.join(work, "ref.fa")
    write_fasta(fa, {"chr1": seq})
    build_fai(fa, fa + ".fai")
    sim = os.path.join(work, "sim")
    cli.main(["simulate", "--fasta", fa, "--flank", "9000", "--depth", "30",
              "--seed", "42", "--output", sim, "normal:400,50",
              f"chr1:{LOCUS}:CAG_0/120"])
    bam = sim + ".bam"

    kmer_cuda.launches = 0
    strbed = os.path.join(work, "ref.str")
    cli.main(["index", "-g", strbed, fa])
    say(f"index: {len(open(strbed).read().splitlines())} regions, kernel "
        f"launches so far {kmer_cuda.launches}")
    binp = os.path.join(work, "sim.bin")
    cli.main(["extract", "-f", fa, "-g", strbed, bam, binp])
    prefix = os.path.join(work, "out")
    cli.main(["call", "-o", prefix, bam, binp])
    bounds = [ln.split("\t") for ln in open(prefix + "-bounds.txt")
              if not ln.startswith("#")]
    near = [b for b in bounds if b[0] == "chr1" and abs(int(b[1]) - LOCUS) < 500]
    if not near:
        raise RuntimeError(f"no bounds line at chr1:{LOCUS}: {bounds}")
    lines = open(prefix + "-genotype.txt").read().splitlines()
    header = lines[0].lstrip("#").split("\t")
    col = header.index("sum_str_counts")
    gts = [ln.split("\t") for ln in lines[1:]]
    at = [g for g in gts if g[0] == "chr1" and abs(int(g[1]) - LOCUS) < 500]
    if not at or int(at[0][col]) <= 0:
        raise RuntimeError(f"no str counts at the locus: {gts}")
    say(f"call: bounds {near[0][:4]}, genotype {at[0]}")

    cpu_bin = os.path.join(work, "sim_cpu.bin")
    subprocess.run([sys.executable, "-m", "strling_tpu_torch.cli", "extract",
                    "--device", "cpu", "-f", fa, "-g", strbed, bam, cpu_bin],
                   check=True, cwd=ROOT)
    if open(binp, "rb").read() != open(cpu_bin, "rb").read():
        raise RuntimeError("extract --device cuda and --device cpu bins differ")
    say(f"extract --device cpu bin is byte-identical ({os.path.getsize(binp)} bytes)")

    big = os.path.join(CACHE, "bench_250000.bam")
    if not os.path.exists(big):
        t0 = time.perf_counter()
        bench_bam(big, 250_000)
        say(f"generated {big} in {time.perf_counter() - t0:.1f}s")
    n_reads = 500_000
    stats = {}
    before = kmer_cuda.launches
    t0 = time.perf_counter()
    tb, _, _ = extract_native(Bam(big), None, None,
                              devices=[torch.device("cuda", 0)], stats=stats)
    wall = time.perf_counter() - t0
    say(f"e2e extract: {n_reads} reads in {wall:.3f}s = {n_reads / wall:.1f} "
        f"reads/s, treads {len(tb)}, kernel launches {kmer_cuda.launches - before}")
    say(f"e2e attribution: batches={stats['n_batches']} "
        f"h2d={stats['h2d_bytes'] / 1e6:.3f}MB d2h={stats['d2h_bytes'] / 1e6:.3f}MB "
        f"device_wait={stats['wait_s']:.3f}s inflight_scan={stats['scan_s']:.3f}s "
        f"host_loop={wall - stats['wait_s']:.3f}s")
    launches = kmer_cuda.launches
    if launches <= 0:
        raise RuntimeError("the main path never launched the repeat_scan kernel")
    return launches


def main():
    phase_env()
    phase_build()
    timings, max_err = phase_kernel()
    os.makedirs(CACHE, exist_ok=True)
    work = os.path.join(CACHE, "work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    launches = phase_main_path(work)
    say(smi_line())
    say(json.dumps({"kernels": [{
        "name": "repeat_scan", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": timings[32768][0], "plain_ms": timings[32768][1],
        "shape": "32768x152 n8",
        "ms_65536": timings[65536][0], "plain_ms_65536": timings[65536][1],
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
