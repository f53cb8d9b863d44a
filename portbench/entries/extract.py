"""The extract entry: `strling extract -f REF -g REF.str BAM OUT.bin` as
`strling_tpu_torch.cli` runs it, one whole pass per answer.

A pass opens the BAM, runs `core.extract.extract_native` on one card with
the `.str` bed and the configuration's options, and writes the bin with the
port's writer under the run's temporary directory. Set-up imports the port,
builds or loads its two libraries and runs one warm pass over the inputs'
small warm BAM of the same traffic; the window then runs passes over the
sample's BAM back to back until one ends after `--seconds`. Each pass's
wall, CPU time, page faults and the machine's load (`hoststat`) are printed
once the window has closed, with the scan layouts the warm pass and the
window used.

What the window produced is checked against `reference.extract_ref`: the
last pass's bin against the reference's bytes, and every other pass's bin
against the last.
"""

from __future__ import annotations

import gc
import hashlib
import os
import sys
import time

import numpy as np

from portbench import hoststat


def run(ctx) -> dict:
    import torch

    import strling_tpu_torch.io.extract_native as xn
    import strling_tpu_torch.ops.kmer as kmer
    from strling_tpu_torch.core.extract import extract_native
    from strling_tpu_torch.io import Bam, write_bin

    for patch in ctx.patches:
        patch()
    opts = ctx.config["extract"]
    p, mq = float(opts["proportion_repeat"]), int(opts["min_mapq"])
    inp = ctx.inputs
    dev = ctx.devices()[0]
    spans = ctx.spans
    captured: list | None = None
    layouts: dict[str, set] = {"warm": set(), "window": set()}
    phase = "warm"
    scan_on = kmer._scan_on

    def capturing_scan_on(device, layout, x, **named):
        layouts[phase].add(layout)
        if captured is not None:
            captured.append((layout, np.array(x, copy=True),
                             {k: np.array(v, copy=True) for k, v in named.items()}))
        return scan_on(device, layout, x, **named)

    kmer._scan_on = capturing_scan_on
    run_loop = xn.NativeExtractor.run
    read_treads = xn.NativeExtractor.treads

    def timed_run(self, *a, **k):
        with spans("feed loop (engine, scans, feeds)"):
            return run_loop(self, *a, **k)

    def timed_treads(self):
        with spans("treads read back"):
            return read_treads(self)

    xn.NativeExtractor.run = timed_run
    xn.NativeExtractor.treads = timed_treads

    def one_pass(bam_path: str, path: str, stats: dict):
        with spans("pass set-up (BAM open, .str read)"):
            bam = Bam(bam_path, fasta=inp["fasta"])
        tb, frag, _ = extract_native(bam, inp["fasta"], inp["str"],
                                     proportion_repeat=p, min_mapq=mq,
                                     devices=[dev], stats=stats)
        with spans("bin write"):
            write_bin(path, tb, frag, bam.header_text, p, mq)
        bam.close()

    def warm_layouts():
        """Scan two small batches at the traffic's read length, one without
        and one with an N, so that set-up loads every wire layout that a
        pass can use, whatever rows the warm BAM's batches held."""
        n = int(ctx.traffic["read_length"])
        bases = np.tile(np.resize(np.frombuffer(b"CAG", np.uint8),
                                  -(-n // 8) * 8), (4, 1))
        for with_n in (False, True):
            if with_n:
                bases[0, 7] = ord("N")
            payload, layout = kmer.fuse_payload(
                bases, np.full(4, bases.shape[1], np.int32), np.full(4, p),
                return_layout=True)
            kmer.scan_payload(payload, len(bases), layout, dev)

    def digest(path):
        with open(path, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()

    try:
        h0 = hoststat.snapshot()
        one_pass(inp["warm_bam"], os.path.join(ctx.tmp, "warm.bin"), {})
        warm = hoststat.delta(h0, hoststat.snapshot())
        warm_layouts()
        probe = hoststat.cpu_probe()
        print(f"[portbench] set-up: warm pass over {inp['n_warm_records']} "
              f"records: {hoststat.line(warm)}; host probe {probe:.3f} s; "
              f"{time.perf_counter() - ctx.t_start:.2f} s since the inputs",
              file=sys.stderr)
        if ctx.trace:
            captured = []
        phase = "window"
        passes = []
        digests = []
        last = os.path.join(ctx.tmp, "pass.bin")
        ctx.window_open()
        while True:
            stats: dict = {}
            h0 = hoststat.snapshot()
            one_pass(inp["bam"], last, stats)
            host = hoststat.delta(h0, hoststat.snapshot())
            digests.append(digest(last))
            passes.append({"wall": host["wall"], "reads": inp["n_records"],
                           "stats": stats, "host": host})
            if time.perf_counter() - ctx.t_open >= ctx.args.seconds:
                break
        ctx.window_close()
    finally:
        kmer._scan_on = scan_on
        xn.NativeExtractor.run = run_loop
        xn.NativeExtractor.treads = read_treads
    print(f"[portbench] host probe after the window: "
          f"{hoststat.cpu_probe():.3f} s", file=sys.stderr)
    for i, x in enumerate(passes):
        print(f"[portbench] pass {i}: {hoststat.line(x['host'])}", file=sys.stderr)
    print(f"[portbench] scan layouts: warm pass {sorted(layouts['warm'])}, "
          f"window {sorted(layouts['window'])}", file=sys.stderr)
    reads = sum(x["reads"] for x in passes)
    print(f"[portbench] window: {reads} reads in {ctx.window_s:.3f} s, "
          f"{reads / ctx.window_s:.1f} reads/s", file=sys.stderr)
    e2e = {"extract_peak_rss_gib": ctx.rss_peak / 2 ** 30}
    ctx.obs.update(passes=passes, reads=reads, scan_calls=captured or [],
                   device=dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    from portbench.reference.extract_ref import compare_bin, reference_extract

    t0 = time.perf_counter()
    ref = reference_extract(inp["bam"], inp["str"], p, mq, dev)
    with open(last, "rb") as fh:
        got = fh.read()
    checks = compare_bin(got, ref)
    checks["passes_differing"] = sum(d != digests[-1] for d in digests)
    print(f"[portbench] reference: {len(ref['rows'])} treads in "
          f"{time.perf_counter() - t0:.1f} s (BAM decode {ref['times']['bam']:.1f} s,"
          f" treads {ref['times']['treads']:.1f} s)", file=sys.stderr)
    last_wrong = any(checks[k] for k in ("treads_wrong", "frag_bins_wrong",
                                         "head_wrong"))
    failed = len(passes) if last_wrong else checks["passes_differing"]
    return {"e2e": e2e, "attempted": len(passes), "failed": failed,
            "checks": {k: {"value": v, "limit": 0} for k, v in checks.items()}}
