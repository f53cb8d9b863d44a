"""Smoke run of strling_tpu_torch on one CUDA card: build, check, drive.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. environment: the card's name and power limit, CUDA, nvcc, Triton;
  2. build the host engine library and the CUDA repeat-unit kernel (every
     form) from the sources in the checkout, in parallel, timed, with
     ptxas's registers, spills and shared memory per form, and the warps an
     SM holds of each detector form at 152 and 256 bases (the launcher's
     occupancy);
  3. each kernel form against its plain PyTorch version on the card and,
     for the detector's forms, against the detector's pure-Python
     specification (`ops.oracle.get_repeat`, held equal to the JAX
     package's by the CPU tests); requires 0 mismatches:
     - pairwise (the default; one warp per read) on every input layout
       (n8, w8 with Ns, w16, ASCII with IUPAC bytes) at 4096 rows (an
       extract batch), 32768 and 65536 rows, plus the F1 (k=3 lane-field
       carry, 256bp CAG/TTC mixtures), F2 (256bp and 264bp homopolymer) and
       F6 rows; times kernel and plain version per batch:
       the kernel's device time (CUDA events around 10 launches queued back
       to back, median of 25) and events around one launch, which also
       count the host's time to issue it; the plain version's events around
       one call, median of 25;
     - sorted (STRLING_MODAL_IMPL=sorted; one warp per read, as pairwise)
       on n8, w8 with Ns, ASCII with IUPAC bytes and packed rows at 4096,
       32768 and 65536 rows, the w16 batch, the F1, F2 and F6 tiles (1024x256,
       every other read ending in 43-52 x AAT, p = 0.5, 85 windows at k = 3)
       and a batch of ASCII rows of up to 4,000 bases, with sorted and
       pairwise times side by side (taking turns) at each n8 batch size;
     - both detectors on ASCII rows with IUPAC bytes at 32768x152, timed
       with their plain versions;
     - packed (2-bit rows + N bitmask: thresholds outside u16) through
       scan_codes on the card, which must take that entry;
     - the stage-disabled variants (no_greedy, no_modal, winmin_only) on
       ASCII and n8 rows, against their plain versions only (a variant is
       not the detector);
  4. the paths, each with the launch counts set to 0 just before it and
     read just after:
     - the main path through the CLI (simulate -> index -> extract -> call)
       on a planted CAG expansion, an `extract --device cpu` whose bin must
       be byte-identical, and an extract of a 500k-read WGS-like BAM whose
       bin must equal the `--device cpu` one; the pairwise kernel must
       launch;
     - the same index + extract and the 500k-read extract in a subprocess
       with STRLING_MODAL_IMPL=sorted: bed and bins byte-identical to the
       pairwise run's, and the sorted form must launch;
     - `index -p -0.05` with --device cuda and --device cpu: beds
       byte-equal, and the packed form must launch;
     - the stage tool (`strling_tpu_torch.scripts.exp_kernel_timing`), which
       prints its table and the detector's stage split, for each modal, from
       the kernel's clocked form (whose outputs must equal the plain
       version's); every variant and both clocked forms must launch. Its n8
       rows are the variants' kernel times;
     - a cohort through the CLI: the carrier of the main path and four
       samples without the expansion, each extracted with --device cuda,
       then merge, call against the joint bounds, and outliers, which must
       name the carrier as the top outlier at the locus; the pairwise kernel
       must launch;
  5. the parallel layer, the spec path and the profiler, each path with the
     launch counts set to 0 just before it (ranks are fresh processes) and
     read just after:
     - the spec extract (`core.extract.extract`) of the main path's sample
       on the card: its bin byte-equal to the native extract's and to the
       spec extract's with --device cpu; the ASCII form must launch;
     - distributed extract, 2 ranks sharing the card (Gloo), of a
       500k-read 150bp BAM over 4 contigs with 1% of its pairs split
       across two of them (a third of those with a CAG mate), generated
       into .smoke_cache/ in the background from the start: the bin
       byte-equal to one process's --device cuda bin; each rank's wall,
       spills, gathered bytes and launches;
     - in the same 2 ranks: merge --distributed and call --distributed -b
       of the cohort, byte-equal to the cohort's single-process files; and
       `dryrun_multichip` (the sharded step, the merge exchange, the O/E
       barrier, the device forms, extract over the local cards, the golden
       chain byte-equal to tests/golden/);
     - a world of one on NCCL (a subprocess): run_merge_dist and
       run_call_dist of the cohort equal to the single-process files, the
       sharded step on cuda:0 equal to its CPU run at 4096x152, and the
       O/E barrier against the host math;
     - `extract --profile DIR` on the card: the trace names
       repeat_scan_warp_kernel, and the bin is the main path's;
  6. CRAM, the accuracy sweep, the cohort demo and the profiler on two
     ranks, each path with the launch counts set to 0 just before it and
     read just after:
     - the main path's sample written as four CRAMs by the port's writer
       (`io/cramwrite.write_cram`, slice_size=500: CRAM 3.0; 3.1; 3.1 with
       arith and fqzcomp; bzip2 + lzma blocks), in a background process
       from the end of phase 4 on; each extracted on the card through `cli
       extract --device cuda -f ref.fa`, its bin byte-identical to the BAM's
       (phase 4); the spec extract of the 3.1 arith CRAM equal to the BAM's
       spec bin (phase 5); the engine library opened must be the compat
       build (`deflate_on_zlib-lzma_by_soname`: CRAM's gzip, bzip2 and lzma
       blocks decode through the compat layer); both paths must launch;
     - `sim_sweep random --n-samples 4 --flank 3000 --depth 30` on
       `--device cuda` and on `--device cpu`: CSVs and summary.md
       byte-identical; the ASCII form must launch;
     - `cohort_demo --n 4 --procs 2 --device cuda`: two ranks sharing the
       card (Gloo) give bounds byte-identical to one process's run_merge;
       the extracts must launch;
     - `call --distributed --profile DIR` on two ranks (fault F10): one
       trace file a rank, and the files byte-identical to the main path's
       single-process call.

The second-to-last line is a JSON object describing the kernel's forms, each
entry naming its design as the launcher reported it for that form's launches
in this run (warp_per_read), the warps an SM holds of it, how its times
were taken and its bound (`scripts/exp_kernel_timing.scan_bound`: the larger of the bytes
over the card's HBM rate and the integer operations, for the k that the
selection state machine reads on these inputs, over its int32 rate); the
detectors' entries (pairwise and sorted) add their clocked form's time and
stage split on n8 rows; the repeat_scan entry adds the launches of the
phase 5 and 6 paths (`launches_paths`). The last line is {"ok":
true, "device": {...}}. Everything it
generates goes under .smoke_cache/ in the checkout. It imports torch, numpy
and strling_tpu_torch only, with `strling_tpu` and `jax` made unimportable
before the first import of the port (here and in its subprocesses), so the
run proves that the port stands alone: its host I/O, engine build and call
side are its own.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# the port stands alone: neither the JAX package nor JAX may load
GUARD = 'import sys; sys.modules["strling_tpu"] = None; sys.modules["jax"] = None'
sys.modules["strling_tpu"] = None
sys.modules["jax"] = None

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".smoke_cache")
KERNEL_SOURCE = "strling_tpu_torch/ops/csrc/repeat_scan.cu"
PALLAS = "strling_tpu/ops/kmer_pallas.py"
LOCUS = 20000
#: the distributed extract's BAM: 250k pairs (500k reads) over 4 contigs
DIST_BAM = os.path.join(CACHE, "bench4_250000.bam")
VARIANTS = ("no_greedy", "no_modal", "winmin_only")
#: phase 6: the CRAM kinds and their write_cram keywords
CRAM_KINDS = {"v30": {}, "v31": {"v31": True},
              "v31_arith": {"v31": True, "v31_arith": True},
              "bz_lzma": {"bz_lzma": True}}
#: how `ms` is taken (`ms_one_launch`, where given, is CUDA events around one
#: launch, which also count the host's time to issue it)
TIMING = ("device_ms: CUDA events around 10 launches queued behind a "
          "sleeping kernel, per launch, median of 25")
#: name in the kernels line -> (what it replaces, modal, variant)
FORMS = {
    "repeat_scan": (f"{PALLAS}:200", "pairwise", "full"),
    "repeat_scan[sorted]": (f"{PALLAS}:44", "sorted", "full"),
    "repeat_scan[packed]": (f"{PALLAS}:566", "pairwise", "full"),
    **{f"repeat_scan[{v}]": (f"{PALLAS}:201", "pairwise", v)
       for v in VARIANTS},
}


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
    from strling_tpu_torch.scripts.exp_kernel_timing import bench_batch

    return bench_batch(B, L)


def long_rows(B: int, L: int):
    """ASCII rows of up to L bases: the bench mix at full length, a third
    cut to 3,075-L bases (past the 3,074 that the sorted modal's thread
    kernel took), CAG/TTC mixtures, STRs of five units with 1% substituted
    bases, IUPAC bytes and N runs."""
    bases, lengths = kernel_batch(B, L)
    rng = np.random.default_rng(L)
    for i in range(1, B, 7):
        units = np.where(rng.random(L // 3 + 1) < rng.uniform(0.3, 0.9), 0, 1)
        bases[i] = np.frombuffer(
            b"".join((b"CAG", b"TTC")[u] for u in units)[:L], np.uint8)
    for j, i in enumerate(range(3, B, 7)):
        u = (b"AAGGG", b"AT", b"A", b"GGGGCC", b"ATTCT")[j % 5]
        bases[i] = np.frombuffer((u * (L // len(u) + 1))[:L], np.uint8)
        hit = rng.random(L) < 0.01
        bases[i, hit] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(hit.sum()))]
    lengths[::3] = rng.integers(3075, L + 1, len(lengths[::3]))
    for i in range(0, B, 3):
        bases[i, lengths[i]:] = 0
    bases[2::11, 500] = ord("R")
    bases[5::13, 900:915] = ord("N")
    props = rng.choice([0.8, 0.6, 0.4], B)
    return bases, lengths, props


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


def _timed(fn):
    t0 = time.perf_counter()
    return fn(), time.perf_counter() - t0


def phase_build():
    say("== 2. build (host engine and kernel in parallel)")
    from strling_tpu_torch.io import hostlib
    from strling_tpu_torch.ops import kmer_cuda

    missing = hostlib.missing_headers()
    say("host engine: " + (f"compat build, missing {', '.join(missing)}"
                           if missing else "system libdeflate and liblzma"))
    with ThreadPoolExecutor(2) as pool:
        host = pool.submit(_timed, hostlib.lib_path)
        kern = pool.submit(_timed, kmer_cuda.library_path)
        (hpath, ht), (kpath, kt) = host.result(), kern.result()
    say(f"host engine library {hpath} in {ht:.2f}s")
    say(f"repeat_scan kernel {kpath} in {kt:.2f}s")
    log = kmer_cuda.build_log.strip()
    say("\n".join(ln for ln in log.splitlines() if "registers" in ln
                  or "spill" in ln or "Compiling entry" in ln)
        if log else "(library was already built)")
    for L in (152, 256):
        for layout in ("n8", "w8", "w16", "ascii", "packed"):
            say(f"warps an SM holds, {layout} rows of {L} bases: " + ", ".join(
                f"{m} {kmer_cuda.warps_per_sm(layout, L, m)} (clocked "
                f"{kmer_cuda.warps_per_sm(layout, L, m, 'stages')})"
                for m in ("pairwise", "sorted")))


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


class KernelChecks:
    """Phase 3: every kernel form against its plain version (and the
    oracle), with the largest difference and the timings per form."""

    def __init__(self):
        from strling_tpu_torch.ops import kmer as K
        from strling_tpu_torch.ops import kmer_cuda, oracle

        self.K, self.oracle, self.kmer_cuda = K, oracle, kmer_cuda
        self.dev = torch.device("cuda", 0)
        self.rng = np.random.default_rng(5)
        self.max_err = Counter()
        self.timings = {}
        self.bounds = {}

    @staticmethod
    def bound(x, layout, kw):
        """The bound of repeat_scan(x, layout, **kw) on these inputs
        (`exp_kernel_timing.scan_bound`)."""
        from strling_tpu_torch.scripts.exp_kernel_timing import scan_bound

        named = {k: v for k, v in kw.items() if k not in ("modal", "variant")}
        return scan_bound(x, layout, kw.get("variant", "full"), **named)

    def sample(self, B, special=()):
        rows = set(self.rng.choice(B, size=min(B, 2048), replace=False).tolist())
        return sorted(rows | set(special))

    def inputs(self, bases, lengths, props, layout):
        """(x, named tensors) for repeat_scan on the card."""
        K, dev = self.K, self.dev
        if layout in ("ascii", "packed"):
            te, tp = K._host_thresholds(lengths, props)
            named = {"lengths": lengths, "te": te, "tp": tp}
            if layout == "packed":
                x, named["nbits"] = K.pack_bases(bases)
            else:
                x = bases
            return (torch.from_numpy(x).to(dev),
                    {k: torch.from_numpy(v).to(dev) for k, v in named.items()})
        payload, got = K.fuse_payload(bases, lengths, props, return_layout=True)
        if got != layout:
            raise RuntimeError(f"layout {got}, want {layout}")
        return torch.from_numpy(payload).to(dev), {}

    def compare(self, form, got, plain):
        torch.cuda.synchronize()
        got = [t.cpu().numpy() for t in got]
        plain = [t.cpu().numpy() for t in plain]
        mism = int(sum((g != w).sum() for g, w in zip(got, plain)))
        err = max(int(np.abs(g.astype(np.int64) - w).max(initial=0))
                  for g, w in zip(got, plain))
        self.max_err[form] = max(self.max_err[form], err)
        return got, mism

    def oracle_mismatches(self, bases, lengths, props, got, rows):
        units = self.K.unpack_unit_codes(got[0], got[1])
        bad = 0
        for i in rows:
            read = bases[i, :lengths[i]].tobytes().decode()
            if self.oracle.get_repeat(read, float(props[i])) != \
                    (units[i], int(got[2][i])):
                bad += 1
        return bad

    def check(self, name, bases, lengths, props, layout, oracle_rows=(),
              modal="pairwise", variant="full"):
        """Kernel vs plain (and vs the oracle on `oracle_rows`)."""
        form = ("repeat_scan" if modal == "pairwise" and variant == "full"
                else f"repeat_scan[{modal if variant == 'full' else variant}]")
        bases = np.ascontiguousarray(bases)
        x, named = self.inputs(bases, lengths, props, layout)
        kw = dict(modal=modal, variant=variant, **named)
        got, mism = self.compare(
            form, self.kmer_cuda.repeat_scan(x, layout, **kw),
            self.K.repeat_codes_plain(x, layout, **kw))
        bad = self.oracle_mismatches(bases, lengths, props, got, oracle_rows)
        say(f"{name}: B={len(bases)} L={bases.shape[1]} layout={layout} "
            f"modal={modal} variant={variant} kernel-vs-plain mismatches "
            f"{mism}, kernel-vs-oracle mismatches {bad}/{len(oracle_rows)}")
        if mism or bad:
            raise RuntimeError(f"{name}: kernel disagrees")
        return x, kw

    def time_plain(self, form, key, x, layout, kw, reps=25):
        """The plain version's ms per batch: CUDA events around one call,
        median of `reps`."""
        plain = _median_ms(lambda: self.K.repeat_codes_plain(x, layout, **kw),
                           reps=reps, warm=1)
        self.timings.setdefault((form, key), {}).update(
            plain_ms=plain, plain_timing=f"one call, median of {reps}")
        return plain

    def time(self, form, key, x, layout, kw, plain_reps=25):
        """Kernel ms per batch (device time, `device_ms`) and the plain
        version's (`time_plain`)."""
        from strling_tpu_torch.scripts.exp_kernel_timing import device_ms

        ms = device_ms({form: lambda: self.kmer_cuda.repeat_scan(
            x, layout, **kw)})[form]
        self.timings.setdefault((form, key), {})["ms"] = ms
        return ms, self.time_plain(form, key, x, layout, kw, plain_reps)

    def pairwise(self):
        """The default form on every layout."""
        from strling_tpu_torch.scripts.exp_kernel_timing import (
            f1_tile,
            f2_rows,
            f6_tile,
        )

        say("== 3. kernel vs plain version vs oracle: pairwise modal")
        check, sample = self.check, self.sample
        for B in (4096, 32768, 65536):
            bases, lengths = kernel_batch(B, 152)
            props = np.full(B, 0.8)
            x, kw = check(f"kernel_batch {B}", bases, lengths, props, "n8",
                          sample(B))
            ms, plain = self.time("repeat_scan", B, x, "n8", kw,
                                  plain_reps=25 if B == 32768 else 5)
            single = _median_ms(lambda: self.kmer_cuda.repeat_scan(x, "n8"))
            self.timings[("repeat_scan", B)]["ms_one_launch"] = single
            self.bounds[("repeat_scan", B)] = self.bound(x, "n8", kw)
            say(f"n8 {B}x152: kernel {ms:.4f} ms/batch (device time; "
                f"{single:.4f} around one launch), plain version "
                f"{plain:.4f} ms/batch, bound "
                f"{self.bounds[('repeat_scan', B)]['bound_ms']:.4f} ms")
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
        fb, fl = f6_tile()
        check("F6 tile p=0.5", fb, fl, np.full(1024, 0.5), "w16", range(1024))

    def sorted_modal(self):
        from strling_tpu_torch.scripts.exp_kernel_timing import (
            device_ms,
            f1_tile,
            f2_rows,
            f6_tile,
        )

        say("== 3. sorted modal (STRLING_MODAL_IMPL=sorted; one warp per read)")
        check, sample = self.check, self.sample
        scan = self.kmer_cuda.repeat_scan
        form = "repeat_scan[sorted]"
        for B in (4096, 32768, 65536):
            bases, lengths = kernel_batch(B, 152)
            props = np.full(B, 0.8)
            x, kw = check(f"kernel_batch {B}", bases, lengths, props, "n8",
                          sample(B), modal="sorted")
            ms = device_ms({m: (lambda m=m: scan(x, "n8", modal=m))
                            for m in ("sorted", "pairwise")})
            self.timings[(form, B)] = {"ms": ms["sorted"]}
            self.bounds[(form, B)] = self.bound(x, "n8", kw)
            plain = self.time_plain(form, B, x, "n8", kw,
                                    reps=25 if B == 32768 else 5)
            say(f"n8 {B}x152: sorted kernel {ms['sorted']:.4f} ms/batch vs "
                f"pairwise kernel {ms['pairwise']:.4f} ms/batch (device "
                f"times, taking turns); sorted plain version {plain:.4f} "
                f"ms/batch; bound {self.bounds[(form, B)]['bound_ms']:.4f} ms")
            nb, nl = with_short_and_n(bases, lengths, B)
            check(f"kernel_batch {B} + N", nb, nl, props, "w8", sample(B),
                  modal="sorted")
            iu = nb.copy()
            iu[3::40, 10] = ord("R")
            iu[7::40, 60:64] = np.frombuffer(b"YSWK", np.uint8)
            check(f"kernel_batch {B} + N + IUPAC", iu, nl, np.full(B, 0.6),
                  "ascii", sample(B, range(3, B, 400)), modal="sorted")
            pprops = np.where(np.arange(B) % 2 == 0, -0.05, 1000.0)
            check(f"kernel_batch {B} + N, props -0.05 and 1000", nb, nl,
                  pprops, "packed", sample(B), modal="sorted")
        bases, lengths = kernel_batch(4096, 256)
        bases, lengths = with_short_and_n(bases, lengths, 3)
        check("kernel_batch 4096 L=256 (85 k=3 windows)", bases, lengths,
              np.full(4096, 0.8), "w16", sample(4096), modal="sorted")
        for L, layout in ((256, "w16"), (248, "n8")):
            fb, fl = f1_tile(L)
            check(f"F1 tile L={L}", fb, fl, np.full(1024, 0.8), layout,
                  range(1024), modal="sorted")
        fb, fl = f2_rows()
        check("F2 homopolymers", fb, fl, np.full(len(fl), 0.8), "w16",
              range(len(fl)), modal="sorted")
        fb, fl = f6_tile()
        check("F6 tile p=0.5", fb, fl, np.full(1024, 0.5), "w16", range(1024),
              modal="sorted")
        lb, ll, lp = long_rows(256, 4000)
        check("long rows (up to 4000 bases, 1333 k=3 windows)", lb, ll, lp,
              "ascii", range(0, 256, 8), modal="sorted")

    def ascii_entry(self):
        """Both detectors on ASCII rows (the engine's IUPAC fallback
        entry) at 32768x152: kernel, plain version and bound."""
        say("== 3. ASCII entry, both modals")
        B = 32768
        bases, lengths = kernel_batch(B, 152)
        bases[3::40, 10] = ord("R")
        props = np.full(B, 0.8)
        for form, modal in (("repeat_scan", "pairwise"),
                            ("repeat_scan[sorted]", "sorted")):
            x, kw = self.check(f"kernel_batch {B} + IUPAC", bases, lengths,
                               props, "ascii", modal=modal)
            ms, plain = self.time(form, "ascii", x, "ascii", kw, plain_reps=5)
            self.bounds[(form, "ascii")] = self.bound(x, "ascii", kw)
            say(f"ascii {B}x152 {modal}: kernel {ms:.4f} ms/batch, plain "
                f"version {plain:.4f} ms/batch (median of 5), bound "
                f"{self.bounds[(form, 'ascii')]['bound_ms']:.4f} ms")

    def packed(self):
        """Thresholds outside u16: scan_codes must send the batch as 2-bit
        rows with an N bitmask."""
        say("== 3. packed entry (2-bit rows + N bitmask)")
        K, kc = self.K, self.kmer_cuda
        B = 32768
        bases, lengths = kernel_batch(B, 152)
        props = np.where(np.arange(B) % 2 == 0, -0.05, 1000.0)
        nb, nl = with_short_and_n(bases, lengths, 17)
        for name, b, l in (("kernel_batch 32768", bases, lengths),
                           ("kernel_batch 32768 + N", nb, nl)):
            if K.fuse_payload(b, l, props) is not None:
                raise RuntimeError(f"{name}: the payload took the batch")
            before = kc.launches_by[("packed", "pairwise", "full")]
            code, ulen, cnt = K.scan_codes(b, l, props, self.dev)
            if kc.launches_by[("packed", "pairwise", "full")] != before + 1:
                raise RuntimeError(f"{name}: scan_codes did not launch the "
                                   f"packed form: {dict(kc.launches_by)}")
            x, kw = self.inputs(b, l, props, "packed")
            got = [torch.from_numpy(a) for a in (code, ulen, cnt)]
            got, mism = self.compare("repeat_scan[packed]", got,
                                     K.repeat_codes_plain(x, "packed", **kw))
            rows = self.sample(B)
            bad = self.oracle_mismatches(b, l, props, got, rows)
            say(f"{name} through scan_codes: layout=packed, props -0.05 and "
                f"1000, kernel-vs-plain mismatches {mism}, kernel-vs-oracle "
                f"mismatches {bad}/{len(rows)}, reported {int((cnt > 0).sum())}")
            if mism or bad:
                raise RuntimeError(f"{name}: packed kernel disagrees")
        ms, plain = self.time("repeat_scan[packed]", B, x, "packed", kw,
                              plain_reps=5)
        self.bounds[("repeat_scan[packed]", B)] = self.bound(x, "packed", kw)
        say(f"packed {B}x152: kernel {ms:.4f} ms/batch, plain version "
            f"{plain:.4f} ms/batch (median of 5)")

    def variants(self):
        """The kernels' times come from the stage tool (phase 4), which
        times every variant at this shape."""
        say("== 3. stage variants (against their plain versions)")
        B = 32768
        bases, lengths = kernel_batch(B, 152)
        props = np.full(B, 0.8)
        for v in VARIANTS:
            self.check(f"kernel_batch {B}", bases, lengths, props, "ascii",
                       variant=v)
            x, kw = self.check(f"kernel_batch {B}", bases, lengths, props,
                               "n8", variant=v)
            self.bounds[(f"repeat_scan[{v}]", B)] = self.bound(x, "n8", kw)
            plain = self.time_plain(f"repeat_scan[{v}]", B, x, "n8", kw,
                                    reps=5)
            say(f"{v} n8 {B}x152: plain version {plain:.4f} ms/batch "
                "(median of 5)")


def _reset_counts():
    """Launch counts to 0 before a path (launches_by_design keeps the whole
    run's launches: the kernels line's designs come from it)."""
    from strling_tpu_torch.ops import kmer_cuda

    kmer_cuda.launches = 0
    kmer_cuda.launches_by.clear()


def _counts() -> Counter:
    from strling_tpu_torch.ops import kmer_cuda

    return Counter(kmer_cuda.launches_by)


def _same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_main_path(work: str):
    say("== 4. main path: simulate -> index -> extract -> call")
    from strling_tpu_torch import cli
    from strling_tpu_torch.core.extract import extract_native
    from strling_tpu_torch.io import Bam, build_fai, write_bin, write_fasta
    from strling_tpu_torch.ops import kmer_cuda
    from strling_tpu_torch.scripts.exp_kernel_compare import bench_bam

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
    big = os.path.join(CACHE, "bench_250000.bam")
    if not os.path.exists(big):
        t0 = time.perf_counter()
        bench_bam(big, 250_000)
        say(f"generated {big} in {time.perf_counter() - t0:.1f}s")

    _reset_counts()
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
    subprocess.run([sys.executable, "-c",
                    f"{GUARD}; from strling_tpu_torch.cli import main; "
                    "main(sys.argv[1:])", "extract", "--device", "cpu", "-f",
                    fa, "-g", strbed, bam, cpu_bin], check=True, cwd=ROOT)
    if not _same_file(binp, cpu_bin):
        raise RuntimeError("extract --device cuda and --device cpu bins differ")
    say(f"extract --device cpu bin is byte-identical ({os.path.getsize(binp)} bytes)")

    n_reads = 500_000
    stats = {}
    before = kmer_cuda.launches
    t0 = time.perf_counter()
    big_bam = Bam(big)
    tb, frag, _ = extract_native(big_bam, None, None,
                                 devices=[torch.device("cuda", 0)], stats=stats)
    wall = time.perf_counter() - t0
    say(f"e2e extract: {n_reads} reads in {wall:.3f}s = {n_reads / wall:.1f} "
        f"reads/s, treads {len(tb)}, kernel launches {kmer_cuda.launches - before}")
    say(f"e2e attribution: batches={stats['n_batches']} "
        f"h2d={stats['h2d_bytes'] / 1e6:.3f}MB d2h={stats['d2h_bytes'] / 1e6:.3f}MB "
        f"device_wait={stats['wait_s']:.3f}s inflight_scan={stats['scan_s']:.3f}s "
        f"host_loop={wall - stats['wait_s']:.3f}s max_held={stats['max_held']}")
    counts = _counts()
    launches = sum(n for (layout, modal, variant), n in counts.items()
                   if modal == "pairwise" and variant == "full")
    if launches <= 0 or launches != sum(counts.values()):
        raise RuntimeError("the main path did not run on the pairwise "
                           f"repeat_scan kernel alone: {dict(counts)}")
    big_bin = os.path.join(work, "big.bin")
    write_bin(big_bin, tb, frag, big_bam.header_text, 0.8, 40)
    tb_cpu, frag_cpu, _ = extract_native(Bam(big), None, None,
                                         devices=[torch.device("cpu")])
    big_cpu = os.path.join(work, "big_cpu.bin")
    write_bin(big_cpu, tb_cpu, frag_cpu, big_bam.header_text, 0.8, 40)
    if not _same_file(big_bin, big_cpu):
        raise RuntimeError("500k-read extract: cuda and cpu bins differ")
    say(f"500k-read extract --device cpu bin is byte-identical "
        f"({os.path.getsize(big_bin)} bytes)")
    return launches, dict(fa=fa, bam=bam, strbed=strbed, binp=binp, big=big,
                          big_bin=big_bin)


SORTED_SCRIPT = GUARD + """
import json
import torch
from strling_tpu_torch import cli
from strling_tpu_torch.core.extract import extract_native
from strling_tpu_torch.io import Bam, write_bin
from strling_tpu_torch.ops import kmer, kmer_cuda
assert kmer.MODAL_IMPL == "sorted", kmer.MODAL_IMPL
fa, bed, bam, binp, big, big_bin = sys.argv[1:]
kmer_cuda.launches_by.clear()
cli.main(["index", "-g", bed, fa])
cli.main(["extract", "-f", fa, "-g", bed, bam, binp])
b = Bam(big)
tb, frag, _ = extract_native(b, None, None, devices=[torch.device("cuda", 0)])
write_bin(big_bin, tb, frag, b.header_text, 0.8, 40)
print(json.dumps([[list(k), n] for k, n in kmer_cuda.launches_by.items()]))
"""


def phase_sorted_path(work: str, p: dict) -> int:
    say("== 4. sorted modal on the main path (STRLING_MODAL_IMPL=sorted, "
        "subprocess)")
    out = {k: os.path.join(work, f"sorted_{k}") for k in ("str", "bin", "big")}
    env = dict(os.environ, STRLING_MODAL_IMPL="sorted")
    proc = subprocess.run(
        [sys.executable, "-c", SORTED_SCRIPT, p["fa"], out["str"], p["bam"],
         out["bin"], p["big"], out["big"]],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True, check=True)
    counts = Counter({tuple(k): n for k, n in
                      json.loads(proc.stdout.strip().splitlines()[-1])})
    for name, a, b in (("index bed", out["str"], p["strbed"]),
                       ("simulated sample bin", out["bin"], p["binp"]),
                       ("500k-read bin", out["big"], p["big_bin"])):
        if not _same_file(a, b):
            raise RuntimeError(f"sorted modal: {name} differs from the "
                               "pairwise run's")
        say(f"sorted modal: {name} byte-identical to the pairwise run's (and "
            f"so to --device cpu) ({os.path.getsize(a)} bytes)")
    launches = sum(n for (_, modal, _), n in counts.items() if modal == "sorted")
    say(f"sorted path launches: {dict(counts)}")
    if launches <= 0 or launches != sum(counts.values()):
        raise RuntimeError("the sorted path did not run on the sorted form "
                           f"alone: {dict(counts)}")
    return launches


def phase_packed_path(work: str, p: dict) -> int:
    say("== 4. packed entry on the main path: index -p -0.05")
    from strling_tpu_torch import cli

    beds = {d: os.path.join(work, f"neg_{d}.str") for d in ("cuda", "cpu")}
    _reset_counts()
    cli.main(["index", "-p", "-0.05", "-g", beds["cuda"], p["fa"]])
    counts = _counts()
    cli.main(["index", "--device", "cpu", "-p", "-0.05", "-g", beds["cpu"],
              p["fa"]])
    if not _same_file(beds["cuda"], beds["cpu"]):
        raise RuntimeError("index -p -0.05: cuda and cpu beds differ")
    n = len(open(beds["cuda"]).read().splitlines())
    launches = sum(c for (layout, _, _), c in counts.items() if layout == "packed")
    say(f"index -p -0.05: {n} regions, bed byte-equal to --device cpu; "
        f"launches {dict(counts)}")
    if launches <= 0:
        raise RuntimeError("index -p -0.05 did not launch the packed form")
    return launches


def phase_cohort(work: str, p: dict):
    """The main path's carrier and four samples without the expansion,
    each extracted on the card, merged, called against the joint bounds and
    scored by outliers; the carrier must be the top outlier at the locus.
    Returns the kernel launches of the run, and the cohort's files and the
    single-process call wall for phase 5."""
    say("== 4. cohort: simulate -> extract -> merge -> call -> outliers")
    from strling_tpu_torch import cli

    d = os.path.join(work, "cohort")
    os.makedirs(d)
    carrier = "c2"
    bams = {s: os.path.join(d, f"{s}.bam") for s in
            ("c0", "c1", "c2", "c3", "c4")}
    for ext in ("", ".bai"):
        shutil.copyfile(p["bam"] + ext, bams[carrier] + ext)
    for i, (s, bam) in enumerate(bams.items()):
        if s != carrier:
            cli.main(["simulate", "--fasta", p["fa"], "--flank", "9000",
                      "--depth", "30", "--seed", str(100 + i), "--output",
                      bam[:-4], "normal:400,50", f"chr1:{LOCUS}:CAG_0/0"])
    _reset_counts()
    t0 = time.perf_counter()
    for s, bam in bams.items():
        cli.main(["extract", "--device", "cuda", "-f", p["fa"], "-g",
                  p["strbed"], bam, bam[:-4] + ".bin"])
    counts = _counts()
    joint = os.path.join(d, "joint")
    cli.main(["merge", "-f", p["fa"], "-o", joint,
              *(b[:-4] + ".bin" for b in bams.values())])
    tc = time.perf_counter()
    for s, bam in bams.items():
        cli.main(["call", "-f", p["fa"], "-b", joint + "-bounds.txt", "-o",
                  os.path.join(d, s), bam, bam[:-4] + ".bin"])
    call_s = time.perf_counter() - tc
    cli.main(["outliers", "--out", os.path.join(d, "cohort."),
              "--genotypes", *(os.path.join(d, f"{s}-genotype.txt")
                               for s in bams),
              "--unplaced", *(os.path.join(d, f"{s}-unplaced.txt")
                              for s in bams)])
    wall = time.perf_counter() - t0
    lines = open(os.path.join(d, "cohort.STRs.tsv")).read().splitlines()
    header = lines[0].split("\t")
    top = dict(zip(header, lines[1].split("\t")))
    launches = sum(n for (_, modal, variant), n in counts.items()
                   if modal == "pairwise" and variant == "full")
    say(f"cohort of {len(bams)}: extract, merge, call and outliers in "
        f"{wall:.2f}s; top outlier {top['sample']} at {top['chrom']}:"
        f"{top['left']}-{top['right']} {top['repeatunit']} outlier "
        f"{top['outlier']} p_adj {top['p_adj']}; launches {dict(counts)}")
    if top["sample"] != carrier or abs(int(top["left"]) - LOCUS) > 1000:
        raise RuntimeError(f"the top outlier is not the carrier {carrier} at "
                           f"chr1:{LOCUS}: {top}")
    if launches <= 0 or launches != sum(counts.values()):
        raise RuntimeError("the cohort's extracts did not run on the "
                           f"pairwise repeat_scan kernel: {dict(counts)}")
    n_loci = len(open(joint + "-bounds.txt").read().splitlines()) - 1
    say(f"cohort calls (one process): {len(bams)} samples x {n_loci} joint "
        f"loci in {call_s:.3f}s")
    return launches, dict(dir=d, bams=bams, joint=joint, call_s=call_s,
                          n_loci=n_loci)


def phase_stage_tool():
    """Returns the launches by variant and the tool's {(entry, row): ms} and
    stage shares."""
    say("== 4. stage tool: python -m strling_tpu_torch.scripts.exp_kernel_timing")
    from strling_tpu_torch.scripts import exp_kernel_timing

    _reset_counts()
    results = exp_kernel_timing.main([])
    counts = _counts()
    launches = {v: sum(n for (_, _, variant), n in counts.items()
                       if variant == v) for v in (*VARIANTS, "stages")}
    clocked = {m: sum(n for (_, modal, variant), n in counts.items()
                      if (modal, variant) == (m, "stages"))
               for m in ("pairwise", "sorted")}
    say(f"stage tool launches by variant: {launches}; clocked forms by "
        f"modal: {clocked}")
    if min(launches.values()) <= 0 or min(clocked.values()) <= 0:
        raise RuntimeError(f"a variant never launched: {launches}, {clocked}")
    return launches, results


# ------------------------------------------------------------------ phase 5


def start_dist_bam():
    """Generate DIST_BAM in a background process (half a minute or more on
    the card's host; it runs beside the build and the kernel checks).
    Returns the process, or None when the BAM is cached."""
    if os.path.exists(DIST_BAM):
        return None
    os.makedirs(CACHE, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, "-c", f"{GUARD}; from strling_tpu_torch.scripts."
         "exp_kernel_compare import bench_bam; bench_bam(sys.argv[1], "
         "250_000, n_chrom=4)", DIST_BAM], cwd=ROOT)


def _ascii_launches(counts: Counter, kind: str) -> int:
    """The pairwise ASCII form's launches in `counts`; on the card every
    launch of the path must be that form's."""
    n = counts[("ascii", "pairwise", "full")]
    if kind == "cuda" and (n <= 0 or n != sum(counts.values())):
        raise RuntimeError(f"the path did not run on the ASCII form alone: "
                           f"{dict(counts)}")
    return n


def phase_spec_extract(work: str, p: dict, kind: str = "cuda") -> int:
    """The spec extract on the card and on the CPU; both bins must equal
    the native extract's (the main path's CLI bin)."""
    say("== 5. spec extract: core.extract.extract, the kernel's ASCII entry")
    from strling_tpu_torch.core.extract import extract
    from strling_tpu_torch.io import Bam, write_bin

    paths, launches = {}, 0
    for dev in (torch.device(kind, 0) if kind == "cuda" else
                torch.device("cpu"), torch.device("cpu")):
        _reset_counts()
        t0 = time.perf_counter()
        bam = Bam(p["bam"])
        tb, frag, _ = extract(bam, p["fa"], p["strbed"], device=dev)
        wall = time.perf_counter() - t0
        if dev.type == kind:
            launches = _ascii_launches(_counts(), kind)
        path = os.path.join(work, f"spec_{dev.type}.bin")
        write_bin(path, tb, frag, bam.header_text, 0.8, 40)
        paths[dev.type] = path
        say(f"spec extract on {dev}: {len(tb)} treads in {wall:.3f}s")
    for name, other in (("the native extract's", p["binp"]),
                        ("--device cpu's", paths["cpu"])):
        if not _same_file(paths[kind], other):
            raise RuntimeError(f"spec extract bin differs from {name}")
        say(f"spec extract bin byte-identical to {name}")
    say(f"spec extract launches: {launches} (ASCII, pairwise)")
    return launches


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _run_ranks(script: str, args: dict, world: int, timeout: int = 600):
    """`script` as `world` ranks of one torchrun-style group on this host;
    returns the JSON object each rank prints last. Every rank is stopped
    before this returns."""
    env = dict(os.environ, WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, json.dumps(args)], cwd=ROOT,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} failed")
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


RANKS_SCRIPT = GUARD + """
import json, time
import torch
import torch.distributed as dist
from strling_tpu_torch import cli
from strling_tpu_torch.ops import kmer_cuda
from strling_tpu_torch.parallel.dryrun import dryrun_multichip
from strling_tpu_torch.parallel.extract_dist import run_extract_dist
from strling_tpu_torch.parallel.mesh import init_distributed
a = json.loads(sys.argv[1])
dev = init_distributed(a["kind"])
out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
       "device": str(dev)}
kmer_cuda.launches = 0
st = {}
run_extract_dist(a["bam"], output_bin=a["bin"], device=dev, stats=st)
out["extract"] = dict(st, launches=kmer_cuda.launches)
dist.barrier()
t0 = time.perf_counter()
cli.main(["merge", "--distributed", "--device", a["kind"], "-f", a["fa"],
          "-o", a["joint"], *a["bins"]])
out["merge_s"] = time.perf_counter() - t0
t0 = time.perf_counter()
for s, (bam, binp) in a["samples"].items():
    cli.main(["call", "--distributed", "--device", a["kind"], "-f", a["fa"],
              "-b", a["bounds"], "-o", a["prefix"] + s, bam, binp])
out["call_s"] = time.perf_counter() - t0
kmer_cuda.launches = 0
t0 = time.perf_counter()
out["dryrun"] = dryrun_multichip(dev)
out["dryrun_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def _cohort_args(cohort: dict, tag: str) -> dict:
    d, bams = cohort["dir"], cohort["bams"]
    return dict(bins=[b[:-4] + ".bin" for b in bams.values()],
                samples={s: (b, b[:-4] + ".bin") for s, b in bams.items()},
                bounds=cohort["joint"] + "-bounds.txt",
                joint=os.path.join(d, f"{tag}_joint"),
                prefix=os.path.join(d, f"{tag}_"))


def _check_cohort_files(cohort: dict, a: dict, samples, label: str):
    pairs = [(a["joint"] + "-bounds.txt", cohort["joint"] + "-bounds.txt")]
    for s in samples:
        for suffix in ("-genotype.txt", "-bounds.txt", "-unplaced.txt"):
            pairs.append((a["prefix"] + s + suffix,
                          os.path.join(cohort["dir"], s + suffix)))
    for got, want in pairs:
        if not _same_file(got, want):
            raise RuntimeError(f"{label}: {got} differs from {want}")
    say(f"{label}: merge bounds and {len(samples)} samples' genotype, bounds "
        f"and unplaced files byte-identical to the single-process files")


def phase_two_ranks(work: str, p: dict, cohort: dict, gen,
                    kind: str = "cuda") -> dict:
    """Two ranks sharing the card (Gloo): distributed extract of DIST_BAM
    against one process's bin, merge and call of the cohort, and the
    dryrun."""
    say("== 5. two ranks on one card (Gloo): distributed extract, merge, "
        "call, dryrun")
    from strling_tpu_torch.core.extract import extract_native
    from strling_tpu_torch.io import Bam, write_bin

    if gen is not None:
        t0 = time.perf_counter()
        if gen.wait() != 0:
            raise RuntimeError("generating the distributed BAM failed")
        say(f"waited {time.perf_counter() - t0:.1f}s for {DIST_BAM}")
    dev = torch.device(kind, 0) if kind == "cuda" else torch.device("cpu")
    _reset_counts()
    t0 = time.perf_counter()
    bam = Bam(DIST_BAM)
    tb, frag, _ = extract_native(bam, None, None, devices=[dev])
    single_s = time.perf_counter() - t0
    single_launches = sum(_counts().values())
    single = os.path.join(work, "dist_single.bin")
    write_bin(single, tb, frag, bam.header_text, 0.8, 40)
    say(f"one process, --device {kind}: {len(tb)} treads in {single_s:.3f}s, "
        f"{single_launches} launches")
    a = dict(_cohort_args(cohort, "ranks2"), kind=kind, bam=DIST_BAM,
             bin=os.path.join(work, "dist_2ranks.bin"), fa=p["fa"])
    t0 = time.perf_counter()
    outs = _run_ranks(RANKS_SCRIPT, a, 2)
    wall = time.perf_counter() - t0
    if not _same_file(a["bin"], single):
        raise RuntimeError("2-rank extract bin differs from one process's")
    for o in outs:
        e = o["extract"]
        say(f"rank {o['rank']} ({o['backend']}, {o['device']}): tids "
            f"{e['tids']}, extract wall {e['wall_s']:.3f}s, treads "
            f"{e['treads_local']}, spills {e['spills_local']} (of "
            f"{e['spills_total']}), gathered {e['gathered_bytes']} bytes, "
            f"launches {e['launches']}; merge {o['merge_s']:.3f}s, "
            f"{len(a['samples'])} calls {o['call_s']:.3f}s, dryrun "
            f"{o['dryrun_s']:.3f}s ({o['dryrun']['launches']} launches, "
            f"golden chain {o['dryrun']['golden_chain']})")
    say(f"2-rank extract bin byte-identical to one process's "
        f"({os.path.getsize(single)} bytes); ranks' run {wall:.1f}s")
    if outs[0]["backend"] != "gloo":
        raise RuntimeError(f"two ranks on one card must use Gloo: {outs[0]}")
    if kind == "cuda" and min(o["extract"]["launches"] for o in outs) <= 0:
        raise RuntimeError("a rank's extract launched no kernel")
    _check_cohort_files(cohort, a, a["samples"], "2-rank merge and call")
    return dict(extract=[o["extract"]["launches"] for o in outs],
                dryrun=[o["dryrun"]["launches"] for o in outs],
                call_s=max(o["call_s"] for o in outs), single_s=single_s,
                ranks_extract_s=[o["extract"]["wall_s"] for o in outs])


NCCL_SCRIPT = GUARD + """
import json
import numpy as np
import torch
import torch.distributed as dist
from strling_tpu_torch.ops import kmer_cuda
from strling_tpu_torch.parallel.call_dist import rank_oes_on_mesh, run_call_dist
from strling_tpu_torch.parallel.dryrun import sharded_step_on_rank
from strling_tpu_torch.parallel.merge_dist import run_merge_dist
from strling_tpu_torch.parallel.mesh import init_distributed
a = json.loads(sys.argv[1])
dev = init_distributed(a["kind"])
out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
run_merge_dist(a["bins"], fasta=a["fa"], output_prefix=a["joint"])
for s, (bam, binp) in a["samples"].items():
    run_call_dist(bam, binp, fasta=a["fa"], bounds_path=a["bounds"],
                  output_prefix=a["prefix"] + s, device=dev)
kmer_cuda.launches = 0
card = sharded_step_on_rank(dev, B=4096, L=152)
out["step_launches"] = kmer_cuda.launches
cpu = sharded_step_on_rank(torch.device("cpu"), B=4096, L=152)
out["step_equal"] = all(np.array_equal(x, y) for x, y in zip(card, cpu))
out["n_str"] = card[5].tolist()
oes = np.array([0.5, np.nan, 2.0, np.inf, 0.5, -1.0, 3.25], np.float32)
want = (np.searchsorted(np.sort(oes), oes, side="left").astype(np.float32)
        / np.float32(len(oes) - 1))
out["oe_equal"] = rank_oes_on_mesh(oes, dev).tobytes() == want.tobytes()
print(json.dumps(out))
"""


def phase_nccl_world_of_one(p: dict, cohort: dict, kind: str = "cuda"):
    """A world of one on NCCL (no torchrun environment): the only NCCL
    group one card allows."""
    say("== 5. a world of one on NCCL: merge, call, sharded step, O/E barrier")
    samples = {"c2": cohort["bams"]["c2"]}
    a = dict(_cohort_args(cohort, "nccl"), kind=kind, fa=p["fa"])
    a["samples"] = {s: (b, b[:-4] + ".bin") for s, b in samples.items()}
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE")}
    out = subprocess.run([sys.executable, "-c", NCCL_SCRIPT, json.dumps(a)],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True,
                         check=True, timeout=600).stdout
    o = json.loads(out.strip().splitlines()[-1])
    say(f"world of one: backend {o['backend']}, sharded step 4096x152 "
        f"{o['step_launches']} launches, equal to its CPU run "
        f"{o['step_equal']} (n_str {o['n_str']}), O/E barrier equal "
        f"{o['oe_equal']}")
    if kind == "cuda" and o["backend"] != "nccl":
        raise RuntimeError(f"a world of one on the card must be NCCL: {o}")
    if not (o["step_equal"] and o["oe_equal"] and o["world"] == 1):
        raise RuntimeError(f"world of one disagrees: {o}")
    if kind == "cuda" and o["step_launches"] <= 0:
        raise RuntimeError("the sharded step launched no kernel")
    _check_cohort_files(cohort, a, a["samples"], "NCCL world of one")
    return o["step_launches"]


def phase_profile(work: str, p: dict, kind: str = "cuda") -> int:
    """extract --profile on the card: the trace must name the kernel."""
    say("== 5. extract --profile")
    from strling_tpu_torch import cli

    trace = os.path.join(work, "trace")
    binp = os.path.join(work, "profiled.bin")
    _reset_counts()
    cli.main(["extract", "--device", kind, "--profile", trace, "-f", p["fa"],
              "-g", p["strbed"], p["bam"], binp])
    launches = sum(_counts().values())
    with open(os.path.join(trace, "extract.pt.trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    hits = [e for e in events if "repeat_scan_warp_kernel" in e.get("name", "")
            and e.get("cat") == "kernel"]
    say(f"trace: {len(events)} events, {len(hits)} kernel events named "
        f"repeat_scan_warp_kernel ({sum(e.get('dur', 0) for e in hits)} us); "
        f"launches {launches}")
    if kind == "cuda" and (not hits or launches <= 0):
        raise RuntimeError("the profiled extract's trace does not name "
                           "repeat_scan_warp_kernel")
    if not _same_file(binp, p["binp"]):
        raise RuntimeError("the profiled extract's bin differs")
    return launches


# ------------------------------------------------------------------ phase 6


CRAM_SCRIPT = GUARD + """
import json
from strling_tpu_torch.io import Bam, BamRecord
from strling_tpu_torch.io.cramwrite import write_cram
bam_p, fa, out = sys.argv[1:4]
kinds = json.loads(sys.argv[4])
bam = Bam(bam_p)
recs = []
for b in bam.batches():
    for i in range(len(b)):
        cig = [(int(c) >> 4, int(c) & 0xF) for c in b.cigar_of(i)]
        recs.append(BamRecord(b.qname(i), int(b.flag[i]), int(b.tid[i]),
                              int(b.pos[i]), int(b.mapq[i]), cig,
                              int(b.mate_tid[i]), int(b.mate_pos[i]),
                              int(b.isize[i]), b.seq_str(i)))
targets = [(t.name, t.length) for t in bam.targets]
for kind, kw in kinds.items():
    write_cram(f"{out}/sample.{kind}.cram", bam.header_text, targets, recs,
               fasta=fa, slice_size=500, **kw)
print(len(recs))
"""


def start_crams(work: str, p: dict):
    """Write the main path's sample as the four CRAM kinds in a background
    process (the port's writer is pure Python)."""
    return subprocess.Popen(
        [sys.executable, "-c", CRAM_SCRIPT, p["bam"], p["fa"], work,
         json.dumps(CRAM_KINDS)], cwd=ROOT, stdout=subprocess.PIPE, text=True)


def phase_cram(work: str, p: dict, gen, kind: str = "cuda") -> dict:
    """The four CRAM kinds extracted on the card, native (CLI) and spec."""
    say("== 6. CRAM input: the port's writer; extract on the card")
    from strling_tpu_torch import cli
    from strling_tpu_torch.core.extract import extract
    from strling_tpu_torch.io import Bam, write_bin
    from strling_tpu_torch.io import bam as engine

    t0 = time.perf_counter()
    out, _ = gen.communicate(timeout=600)
    if gen.returncode != 0:
        raise RuntimeError("writing the CRAMs failed")
    say(f"waited {time.perf_counter() - t0:.1f}s for the four CRAMs "
        f"({out.strip()} records each)")
    crams = {k: os.path.join(work, f"sample.{k}.cram") for k in CRAM_KINDS}
    _reset_counts()
    for k, cram in crams.items():
        binp = os.path.join(work, f"cram_{k}.bin")
        t0 = time.perf_counter()
        cli.main(["extract", "--device", kind, "-f", p["fa"], "-g",
                  p["strbed"], cram, binp])
        wall = time.perf_counter() - t0
        if not _same_file(binp, p["binp"]):
            raise RuntimeError(f"CRAM {k}: extract bin differs from the BAM's")
        say(f"CRAM {k} ({os.path.getsize(cram)} bytes): extract in "
            f"{wall:.3f}s, bin byte-identical to the BAM's")
    native = _counts()
    _reset_counts()
    dev = torch.device(kind, 0) if kind == "cuda" else torch.device("cpu")
    bam = Bam(crams["v31_arith"], fasta=p["fa"])
    tb, frag, _ = extract(bam, p["fa"], p["strbed"], device=dev)
    spec_bin = os.path.join(work, "cram_spec.bin")
    write_bin(spec_bin, tb, frag, bam.header_text, 0.8, 40)
    spec = _counts()
    if not _same_file(spec_bin, os.path.join(work, f"spec_{dev.type}.bin")):
        raise RuntimeError("CRAM v31_arith: spec extract bin differs from the "
                           "BAM's")
    lib = os.path.basename(engine._lib._name)
    say(f"CRAM v31_arith: spec extract bin byte-identical to the BAM's; "
        f"engine library {lib}")
    say(f"CRAM launches: native extracts {dict(native)}, spec extract "
        f"{dict(spec)}")
    if kind == "cuda":
        if "deflate_on_zlib-lzma_by_soname" not in lib:
            raise RuntimeError(f"the engine is not the compat build: {lib}")
        if sum(native.values()) <= 0 or sum(spec.values()) <= 0:
            raise RuntimeError("a CRAM path launched no kernel")
    return {"cram_extract": sum(native.values()),
            "cram_spec_extract": _ascii_launches(spec, kind)}


def phase_sweep(work: str, kind: str = "cuda") -> int:
    say("== 6. accuracy sweep: sim_sweep random --n-samples 4 --flank 3000 "
        "--depth 30, on the card and on the CPU")
    from strling_tpu_torch.scripts import sim_sweep

    outs, counts = {}, {}
    for dev in (kind, "cpu"):
        outs[dev] = os.path.join(work, f"sweep_{dev}")
        _reset_counts()
        t0 = time.perf_counter()
        sim_sweep.main(["random", "--out", outs[dev], "--n-samples", "4",
                        "--flank", "3000", "--depth", "30", "--device", dev])
        counts[dev] = _counts()
        say(f"sweep --device {dev}: {time.perf_counter() - t0:.2f}s, "
            f"launches {dict(counts[dev])}")
    for name in ("sweep_results.csv", "summary.md"):
        if not _same_file(os.path.join(outs[kind], name),
                          os.path.join(outs["cpu"], name)):
            raise RuntimeError(f"sweep: {name} differs between --device "
                               f"{kind} and cpu")
    say("sweep: CSV and summary.md byte-identical between the card and the "
        "CPU")
    return _ascii_launches(counts[kind], kind)


def phase_cohort_demo(work: str, kind: str = "cuda") -> int:
    say(f"== 6. cohort demo: cohort_demo --n 4 --procs 2 --device {kind}")
    from strling_tpu_torch.scripts import cohort_demo

    out = os.path.join(work, "cohort_demo")
    _reset_counts()
    t0 = time.perf_counter()
    cohort_demo.main(["--out", out, "--n", "4", "--procs", "2", "--device",
                      kind])
    counts = _counts()
    if not _same_file(os.path.join(out, "joint_dp-bounds.txt"),
                      os.path.join(out, "joint_sp-bounds.txt")):
        raise RuntimeError("cohort demo: the ranks' bounds differ")
    launches = sum(counts.values())
    say(f"cohort demo: bounds byte-identical, {time.perf_counter() - t0:.2f}s,"
        f" launches {dict(counts)}")
    if kind == "cuda" and launches <= 0:
        raise RuntimeError("the cohort demo's extracts launched no kernel")
    return launches


F10_SCRIPT = GUARD + """
import json, os
from strling_tpu_torch import cli
a = json.loads(sys.argv[1])
cli.main(["call", "--distributed", "--device", a["kind"], "--profile",
          a["trace"], "-o", a["prefix"], a["bam"], a["bin"]])
print(json.dumps({"rank": int(os.environ["RANK"])}))
"""


def phase_profile_ranks(work: str, p: dict, kind: str = "cuda"):
    """call --distributed --profile on two ranks: a trace each (F10)."""
    say("== 6. call --distributed --profile DIR on two ranks (F10)")
    a = dict(kind=kind, trace=os.path.join(work, "trace_ranks"),
             prefix=os.path.join(work, "profiled_ranks"), bam=p["bam"],
             bin=p["binp"])
    _run_ranks(F10_SCRIPT, a, 2)
    names = sorted(os.listdir(a["trace"]))
    want = ["call.rank0.pt.trace.json", "call.rank1.pt.trace.json"]
    say(f"traces: {names} ({[os.path.getsize(os.path.join(a['trace'], n)) for n in names]} bytes)")
    if names != want:
        raise RuntimeError(f"two ranks wrote {names}, want {want}")
    for suffix in ("-genotype.txt", "-bounds.txt", "-unplaced.txt"):
        if not _same_file(a["prefix"] + suffix,
                          os.path.join(work, "out") + suffix):
            raise RuntimeError(f"profiled 2-rank call: {suffix} differs")
    say("profiled 2-rank call: files byte-identical to the main path's call")


#: background processes, stopped before the script ends
BACKGROUND = []


def main():
    phase_env()
    gen = start_dist_bam()
    BACKGROUND.append(gen)
    try:
        _main(gen)
    finally:
        for proc in BACKGROUND:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def _main(gen):
    phase_build()
    checks = KernelChecks()
    checks.pairwise()
    checks.sorted_modal()
    checks.ascii_entry()
    checks.packed()
    checks.variants()
    os.makedirs(CACHE, exist_ok=True)
    work = os.path.join(CACHE, "work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    launches = {}
    launches["repeat_scan"], paths = phase_main_path(work)
    crams = start_crams(work, paths)
    BACKGROUND.append(crams)
    launches["repeat_scan[sorted]"] = phase_sorted_path(work, paths)
    launches["repeat_scan[packed]"] = phase_packed_path(work, paths)
    stage_launches, stage_ms = phase_stage_tool()
    cohort_launches, cohort = phase_cohort(work, paths)
    t5 = time.perf_counter()
    paths_launches = {"spec_extract": phase_spec_extract(work, paths)}
    ranks = phase_two_ranks(work, paths, cohort, gen)
    paths_launches["dist_extract_ranks"] = ranks["extract"]
    paths_launches["dryrun_ranks"] = ranks["dryrun"]
    paths_launches["nccl_sharded_step"] = phase_nccl_world_of_one(paths,
                                                                  cohort)
    paths_launches["profile_extract"] = phase_profile(work, paths)
    say(f"phase 5 in {time.perf_counter() - t5:.1f}s; cohort calls: one "
        f"process {cohort['call_s']:.3f}s, two ranks {ranks['call_s']:.3f}s "
        f"({len(cohort['bams'])} samples x {cohort['n_loci']} loci); "
        f"distributed extract: one process {ranks['single_s']:.3f}s, ranks "
        f"{ranks['ranks_extract_s']}")
    t6 = time.perf_counter()
    paths_launches.update(phase_cram(work, paths, crams))
    paths_launches["sweep"] = phase_sweep(work)
    paths_launches["cohort_demo"] = phase_cohort_demo(work)
    phase_profile_ranks(work, paths)
    say(f"phase 6 in {time.perf_counter() - t6:.1f}s")
    for v in VARIANTS:
        launches[f"repeat_scan[{v}]"] = stage_launches[v]
        checks.timings[(f"repeat_scan[{v}]", 32768)]["ms"] = stage_ms[("n8", v)]
    say(smi_line())
    from strling_tpu_torch.ops.kmer_cuda import launches_by_design, warps_per_sm

    kernels = []
    for name, (replaces, modal, variant) in FORMS.items():
        t = checks.timings[(name, 32768)]
        b = checks.bounds[(name, 32768)]
        layout = "packed" if "packed" in name else "n8"
        designs = {d for (lay, m, v, d) in launches_by_design
                   if (lay, m, v) == (layout, modal, variant)}
        if len(designs) != 1:
            raise RuntimeError(f"{name}: the launcher reported designs "
                               f"{designs} for ({layout}, {modal}, {variant})")
        entry = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                 "replaces": replaces, "design": designs.pop(),
                 "warps_per_sm": warps_per_sm(layout, 152, modal, variant),
                 "launches": launches[name],
                 "max_abs_err": checks.max_err[name], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": b["bound_ms"],
                 "bound_by": b["bound_by"],
                 # no single PyTorch call computes the repeat unit
                 "library_ms": None,
                 "shape": f"32768x152 {layout}",
                 "timing": TIMING, "plain_timing": t["plain_timing"]}
        if name == "repeat_scan":
            entry["launches_cohort"] = cohort_launches
            entry["launches_paths"] = paths_launches
        if name in ("repeat_scan", "repeat_scan[sorted]"):
            entry["clocked_ms"] = stage_ms[("n8", f"clocked_{modal}")]
            prefix = f"stage_{modal}_"
            entry["stage_split"] = {
                k[1][len(prefix):]: v for k, v in stage_ms.items()
                if k[0] == "n8" and k[1].startswith(prefix)}
        if "ms_one_launch" in t:
            entry["ms_one_launch"] = t["ms_one_launch"]
        for B in (4096, 65536, "ascii"):
            if (name, B) in checks.timings:
                t, b = checks.timings[(name, B)], checks.bounds[(name, B)]
                entry[f"ms_{B}"], entry[f"plain_ms_{B}"] = t["ms"], t["plain_ms"]
                entry[f"bound_ms_{B}"] = b["bound_ms"]
        kernels.append(entry)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
