"""Stage attribution of the CUDA repeat-unit scan (experiment tool).

Port of scripts/exp_kernel_timing.py, with the kernel's bound
(`scan_bound`) and the rows of the TPU form's faults (F1, F2, F6) that the
card checks use. Times the kernel's forms on one batch
of the bench mix (seed 0, every 10th read a pure STR of CAG/A/AT/AAGGG/ATTCT)
at 32768x152 (--smoke: 4096x152), through the ASCII entry (as the JAX tool
does) and through the n8 payload (what extract runs):

  full         the detector (pairwise modal)
  no_greedy    exact recount skipped (the modal count stands in)
  no_modal     modal skipped (the first window's code stands in)
  winmin_only  neither (window codes, selection, N skip, homopolymer)
  sorted       the detector with the sorted modal

The variants are the TPU kernel's forms and are timed as such, but their
differences to full are not the stages' costs on the warp-per-read kernel:
it computes a k's modal and recount only when the selection state machine
reads them, and a variant's counts change what it reads (no_modal's count,
the number of windows, keeps every k in play: it runs five recounts where
the detector recounts k = 2 alone on most reads). The stage split comes from
the detector's clocked form instead (`kmer_cuda.stage_cycles`, on the card
only), for each modal: each warp's clock cycles in loading (row, position
codes, N count), window codes, modal, recount and the rest, as shares of
their sum. Each clocked form's outputs must equal the plain detector's, and
its device time is printed (against full's or sorted's: the clock reads'
cost).

    python -m strling_tpu_torch.scripts.exp_kernel_timing [--smoke] [--device cuda|cpu]

On cuda (the default; it raises without a card) each row is the device
time of one launch: the median of 25 CUDA-event timings of 10 back-to-back
launches, the rows taking turns (`device_ms`). --device cpu runs the plain
PyTorch forms, timed on the host clock (median of 3): that is a CPU time,
there so that the tool can be tested without a card; the CPU has no stage
split.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from strling_tpu_torch.ops.kmer import (
    KS,
    MODALS,
    _host_thresholds,
    fuse_payload,
    repeat_codes_plain,
    selection_path_plain,
)
from strling_tpu_torch.ops.kmer_cuda import (
    STAGES,
    repeat_scan,
    repeat_scan_clocked,
    stage_cycles,
)

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


def f1_tile(L: int = 256):
    """1024-row tile: rows 0-255 short random reads, rows 256-511 full
    length CAG/TTC mixtures (the second 8-bit lane field of the TPU
    kernel's k=3 SWAR modal, fault F1), the rest random at full length."""
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
    """Homopolymers of 256 and 264 bases (fault F2: the TPU form's 8-bit
    count field) and a dinucleotide of the same length."""
    rows = [b"A" * 256, b"A" * 264, b"C" * 256, b"T" * 264, b"CA" * 132]
    bases = np.zeros((len(rows), L), np.uint8)
    for i, r in enumerate(rows):
        bases[i, :len(r)] = np.frombuffer(r, np.uint8)
    return bases, np.array([len(r) for r in rows], np.int32)


#: the card's peaks for the bound (H100 SXM): HBM bytes/s, and int32
#: operations/s = 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def scan_ops(lengths, reached, recounted, skip, variant: str = "full") -> int:
    """Integer operations the detector needs on these reads, counting only
    the k that its selection state machine reads (`reached`, `recounted`,
    `skip`: ops.kmer.selection_path_plain on the same inputs and variant):
    per base the unpack and N count (1) and, where some k is recounted, the
    rolling 12-bit code (3); for each reached k, per window the k digit
    shifts and ors (2k), k - 1 rotations (shift, mask, shift, or, min: 5
    each) and, where the variant has a modal, the O(1) modal update (4); for
    each recounted k, where the variant recounts, per base the masked
    compare and the greedy step (5). A read skipped for its Ns needs only
    its N count."""
    greedy = variant in ("full", "no_modal")
    modal = variant in ("full", "no_greedy")
    n = np.asarray(lengths, np.int64)
    reached = np.asarray(reached, bool)
    recounted = np.asarray(recounted, bool) & greedy
    ops = n + 3 * n * recounted.any(axis=1)
    for ki, k in enumerate(KS):
        ops += reached[:, ki] * (n // k) * (2 * k + 5 * (k - 1) + 4 * modal)
        ops += recounted[:, ki] * 5 * n
    return int(np.where(np.asarray(skip, bool), n, ops).sum())


def scan_bound(x: torch.Tensor, layout: str, variant: str = "full",
               **named) -> dict:
    """The least time the card could take for repeat_scan(x, layout,
    variant=variant, **named): the larger of the bytes term (every input
    byte read once, 12 output bytes a read written once, over
    HBM_BYTES_PER_S) and the operations term (`scan_ops` over
    INT32_OPS_PER_S), with the selection's path taken from the plain
    version on the same tensors (on their device)."""
    reached, recounted, skip, lengths = selection_path_plain(
        x, layout, variant=variant, **named)
    row_bytes = x.shape[1] + sum(t[0].numel() * t.element_size()
                                 for t in named.values())
    nbytes = x.shape[0] * (row_bytes + 12)
    ops = scan_ops(*(t.cpu().numpy() for t in (lengths, reached, recounted,
                                                skip)), variant)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "ops": ops}


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
        if dev.type == "cuda":
            for m in MODALS:
                fns[f"clocked_{m}"] = (lambda m=m: repeat_scan_clocked(
                    x, entry, modal=m, **named))
            ms = device_ms(fns)
        else:
            ms = host_ms(fns)
        for row, _, _ in ROWS:
            results[(entry, row)] = ms[row]
            print(f"  {row:12s} {ms[row]:9.4f} ms/batch "
                  f"{B / ms[row] / 1e3:9.3f} M reads/s", flush=True)
        full = results[(entry, "full")]
        print(f"  sorted modal detector: "
              f"{results[(entry, 'sorted')] / full * 100:5.1f}% of the "
              "pairwise one's time", flush=True)
        if dev.type != "cuda":
            print(f"stage split, {entry}: needs the card (the kernel's "
                  "clocked form)", flush=True)
            continue
        for m in MODALS:
            stage_cycles(dev)  # clear the earlier launches' cycles
            got = repeat_scan_clocked(x, entry, modal=m, **named)
            cycles = stage_cycles(dev)
            want = repeat_codes_plain(x, entry, modal=m, **named)
            mism = sum(int((a != b).sum()) for a, b in zip(got, want))
            if mism:
                raise RuntimeError(f"{entry}: the clocked {m} form disagrees "
                                   f"with the plain detector on {mism} values")
            total = sum(cycles.values())
            clocked = ms[f"clocked_{m}"]
            results[(entry, f"clocked_{m}")] = clocked
            for st in STAGES:
                results[(entry, f"stage_{m}_{st}")] = cycles[st] / total
            print(f"stage split, {entry}, {m} modal (the clocked detector, "
                  f"{clocked:.4f} ms/batch, 0 mismatches; share of {total} "
                  "warp cycles):")
            for st in STAGES:
                print(f"  {st:8s} {cycles[st] / total * 100:5.1f}%", flush=True)
    return results


if __name__ == "__main__":
    main()
