"""`extract` on the native engine, with the repeat-unit scan on torch devices.

Port of `strling_tpu.core.extract.extract_native` and `run_once_exact`. The
C++ engine streams, packs and pairs the reads; the scan runs on the given
devices (`cpu` runs the plain PyTorch form, `cuda` the CUDA kernel). Bins are
byte-identical to the JAX package's.
"""

from __future__ import annotations

import sys
import time

import torch

from strling_tpu_torch.core.genome_index import GenomeIndex, genome_repeats
from strling_tpu_torch.io import Bam
from strling_tpu_torch.io.extract_native import (
    TEE_SKIP,
    TEE_TAKE,
    NativeExtractor,
    native_frag_hist,
    peek_max_len,
)
from strling_tpu_torch.utils import fraglen
from strling_tpu_torch.utils.options import Options


def scan_devices(device: str = "cuda", devices: str | None = None):
    """The torch devices to scan on. `device` is "cpu" or "cuda"; with cuda,
    `devices` is "all" or a count of local cards (default one). Raises if
    cuda is asked for and no card is present: nothing falls back to the
    CPU."""
    if device == "cpu":
        if devices:
            raise ValueError("--devices applies to --device cuda")
        return [torch.device("cpu")]
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch scan)")
    n = torch.cuda.device_count()
    if devices == "all":
        count = n
    elif devices:
        count = int(devices)
        if not 1 <= count <= n:
            raise ValueError(f"--devices {devices}: {n} CUDA devices present")
    else:
        count = 1
    return [torch.device("cuda", i) for i in range(count)]


def extract_native(bam, fasta: str | None, genome_repeats_path: str | None,
                   proportion_repeat: float = 0.8, min_mapq: int = 40,
                   verbose: bool = False, genome_index: GenomeIndex | None = None,
                   devices: list[torch.device] | None = None,
                   stats: dict | None = None):
    """Native-engine extraction: C++ streams/packs/pairs, `devices` scan
    (default: one CUDA card). Returns (TreadBatch, frag_dist, opts).

    The fragment-length pre-pass (utils.nim:86-111) rides the engine's own
    record stream: feeds hold until its 2M-record budget is consumed (scans
    keep flying meanwhile) and the median lands just before the first feed.
    Once the held batches carry `io.extract_native.HOLD_RECORDS` records,
    the histogram comes from its own pass over the file
    (`native_frag_hist`) and feeding resumes.
    The wire width is probed from the first 10k records; if a later read
    turns out longer (it would have been truncated on the wire), extraction
    runs again at the exact width."""
    devs = devices or scan_devices()
    peek_len = peek_max_len(bam)
    opts = Options(
        median_fragment_length=0,
        proportion_repeat=proportion_repeat,
        min_mapq=min_mapq,
    )
    if genome_index is None and fasta:
        genome_index = genome_repeats(fasta, opts, genome_repeats_path or "",
                                      devs[0])

    print("[strling] collecting str-like reads", file=sys.stderr)
    t0 = time.time()
    Lcap = max(32, ((peek_len + 7) // 8) * 8) if peek_len else None
    ne = NativeExtractor(bam, proportion_repeat, min_mapq, 0,
                         genome_index=genome_index, Lmax=Lcap, frag_tee=True)

    def set_median(hist):
        median = fraglen.median(hist)
        ne.set_median(median)
        opts.median_fragment_length = median
        if verbose:
            print(f"Calculated median fragment length:{median}",
                  file=sys.stderr)

    def median_from_own_pass():
        # too many records held waiting for the tee (few pass the
        # histogram's predicate): the standalone pass over a second handle
        # reads the same records with the same predicate and budget, so the
        # median, and the bin, are the ones the tee would have given
        second = Bam(bam.path, fasta=getattr(bam, "fasta", None))
        set_median(native_frag_hist(second, TEE_SKIP, TEE_TAKE))

    tb = ne.run(devs, pre_feed_hook=lambda: set_median(ne.get_hist()[0]),
                stats=stats, hold_drain=lambda: not ne.hist_ready,
                on_hold_cap=median_from_own_pass)
    frag_dist, max_read_len = ne.get_hist()
    # NativeExtractor caps at min(bam.Lmax, Lcap): the effective width is
    # what the retry guard compares against
    eff_cap = min(bam.Lmax, Lcap) if Lcap else bam.Lmax
    true_max = max(ne.max_len_seen, max_read_len)
    if true_max > eff_cap:
        Lcap = max(32, ((true_max + 7) // 8) * 8)
        bam2 = Bam(bam.path, Lmax=Lcap, fasta=getattr(bam, "fasta", None))
        ne, tb = run_once_exact(bam2, Lcap, proportion_repeat, min_mapq,
                                frag_dist, genome_index, devs, opts)
    if verbose:
        dt = max(1e-9, time.time() - t0)
        print(f"[strling] {ne.nreads} reads @ {ne.nreads/dt:.1f} reads/sec",
              file=sys.stderr)
    return tb, frag_dist, opts


def run_once_exact(bam, Lcap, proportion_repeat, min_mapq, frag_dist,
                   genome_index, devices, opts):
    """Exact-width re-run for the rare mixed-read-length case."""
    median = fraglen.median(frag_dist)
    opts.median_fragment_length = median
    ne = NativeExtractor(bam, proportion_repeat, min_mapq, median,
                         genome_index=genome_index, Lmax=Lcap)
    return ne, ne.run(devices)
