"""Stage attribution of the CUDA repeat-unit scan (experiment tool).

Port of scripts/exp_kernel_timing.py. Times the kernel's forms on one batch
of the bench mix (seed 0, every 10th read a pure STR of CAG/A/AT/AAGGG/ATTCT)
at 32768x152 (--smoke: 4096x152), through the ASCII entry (as the JAX tool
does) and through the n8 payload (what extract runs):

  full         the detector (pairwise modal)
  no_greedy    exact recount skipped (the modal count stands in)
  no_modal     modal skipped (the first window's code stands in)
  winmin_only  neither (window codes, selection, N skip, homopolymer)
  sorted       the detector with the sorted modal

full - no_X attributes X's cost; winmin_only bounds the floor of the
encode, window and selection stages.

    python -m strling_tpu_torch.scripts.exp_kernel_timing [--smoke] [--device cuda|cpu]

On cuda (the default; it raises without a card) each row is the device
time of one launch: the median of 25 CUDA-event timings of 10 back-to-back
launches, the rows taking turns (`device_ms`). --device cpu runs the plain
PyTorch forms, timed on the host clock (median of 3): that is a CPU time,
there so that the tool can be tested without a card.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from strling_tpu_torch.ops.kmer import _host_thresholds, fuse_payload
from strling_tpu_torch.ops.kmer_cuda import repeat_scan

#: (row, modal, variant)
ROWS = (("full", "pairwise", "full"),
        ("no_greedy", "pairwise", "no_greedy"),
        ("no_modal", "pairwise", "no_modal"),
        ("winmin_only", "pairwise", "winmin_only"),
        ("sorted", "sorted", "full"))


def bench_batch(B: int, L: int):
    """bench.py's _kernel_batch mix: random reads, every 10th a pure STR."""
    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    bases = alphabet[rng.integers(0, 4, (B, L))]
    units = [b"CAG", b"A", b"AT", b"AAGGG", b"ATTCT"]
    for i in range(0, B, 10):
        u = units[i % len(units)]
        bases[i] = np.frombuffer((u * (L // len(u) + 1))[:L], np.uint8)
    return bases, np.full(B, L, np.int32)


def f6_tile():
    """1024 reads of 256bp, every other one ending in 43-52 x AAT: 85 k = 3
    windows, past the 64 that the TPU sorted modal's 6-bit window field
    holds (scanned at p = 0.5, where the planted counts are reported)."""
    rng = np.random.default_rng(6)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    bases = alphabet[rng.integers(0, 4, (1024, 256))]
    for i in range(1, 1024, 2):
        n = int(rng.integers(43, 53))
        bases[i, 256 - 3 * n:] = np.frombuffer(b"AAT" * n, np.uint8)
    return bases, np.full(1024, 256, np.int32)


def device_ms(fns: dict, launches: int = 10, samples: int = 25) -> dict:
    """Device time per call of each of `fns` (name -> zero-argument call),
    in ms: the median over `samples` of CUDA events around `launches`
    back-to-back calls. Each group is queued behind a sleeping kernel, so
    the calls run with no gaps and the host's time to issue them is not
    counted; the callables take turns, so drift in the card's clocks falls
    on all of them alike."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(samples):
        for name, fn in fns.items():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(4_000_000)  # ~2 ms, longer than the issuing
            e0.record()
            for _ in range(launches):
                fn()
            e1.record()
            e1.synchronize()
            times[name].append(e0.elapsed_time(e1) / launches)
    return {name: statistics.median(t) for name, t in times.items()}


def host_ms(fns: dict, reps: int = 3) -> dict:
    """Host-clock time per call (median of `reps`), for the plain forms on
    the CPU."""
    out = {}
    for name, fn in fns.items():
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    return out


def main(argv=None) -> dict:
    """Print the table and the attribution; return {(entry, row): ms}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="4096x152 batch")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    dev = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (plain PyTorch forms, host clock)")
    B, L = (4096, 152) if args.smoke else (32768, 152)
    bases, lengths = bench_batch(B, L)
    props = np.full(B, 0.8)
    te, tp = _host_thresholds(lengths, props)
    payload, layout = fuse_payload(bases, lengths, props, return_layout=True)
    entries = {
        "ascii": (bases, {"lengths": lengths, "te": te, "tp": tp}),
        layout: (payload, {}),
    }
    results = {}
    for entry, (x, named) in entries.items():
        x = torch.from_numpy(x).to(dev)
        named = {k: torch.from_numpy(v).to(dev) for k, v in named.items()}
        print(f"{entry} entry, {B}x{L}, on {where}", flush=True)
        fns = {row: (lambda m=modal, v=variant: repeat_scan(
            x, entry, modal=m, variant=v, **named)) for row, modal, variant in ROWS}
        ms = device_ms(fns) if dev.type == "cuda" else host_ms(fns)
        for row, _, _ in ROWS:
            results[(entry, row)] = ms[row]
            print(f"  {row:12s} {ms[row]:9.4f} ms/batch "
                  f"{B / ms[row] / 1e3:9.3f} M reads/s", flush=True)
        full = results[(entry, "full")]
        print(f"attribution, {entry} (share of full):")
        print(f"  exact recount (greedy): "
              f"{(full - results[(entry, 'no_greedy')]) / full * 100:5.1f}%")
        print(f"  modal (pairwise):       "
              f"{(full - results[(entry, 'no_modal')]) / full * 100:5.1f}%")
        print(f"  encode+winmin+select:   "
              f"{results[(entry, 'winmin_only')] / full * 100:5.1f}%")
        print(f"  sorted modal detector:  "
              f"{results[(entry, 'sorted')] / full * 100:5.1f}% of the "
              "pairwise one's time", flush=True)
    return results


if __name__ == "__main__":
    main()
