"""Genome STR index: find repeat regions of the reference FASTA.

Port of `strling_tpu.core.genome_index` (itself a port of
src/strpkg/genome_strs.nim) with the window scan on a torch device. The JAX
package's module imports its JAX scan at import time, so this module carries
its own copy of the host code; only `repeat_windows` and `genome_repeats`
changed, to take the scan's `device`. The window scan (100bp windows, step
60, genome_strs.nim:122-123) sends the windows that the native exact-zero
mask cannot rule out through the repeat-unit kernel, in batches of up to 32k
windows.

The resulting bed ("chrom\\tstart\\tstop\\trepeat") feeds extract's
skip-fast-path via per-chromosome sorted interval arrays (replacing the
reference's Lapper interval trees, read_bed.nim:30-50).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from strling_tpu.io.fasta import Fasta
from strling_tpu.utils.options import Options
from strling_tpu_torch.io import hostlib
from strling_tpu_torch.ops import oracle
from strling_tpu_torch.ops.kmer import scan_codes, unpack_unit_codes

WINDOW_SIZE = 100  # genome_strs.nim:122
STEP = 60  # genome_strs.nim:123

# Candidate windows are padded to the read-scan width of 150bp data (zero pad
# bases scan as empty), so index batches take the same n8 path as extract's.
SCAN_WIDTH = 152


class Window:
    __slots__ = ("chrom", "start", "stop", "repeat")

    def __init__(self, chrom="", start=0, stop=-1, repeat=""):
        self.chrom = chrom
        self.start = start
        self.stop = stop
        self.repeat = repeat


def _first_slide_code(s: str, k: int) -> int:
    """First min-rotation window code of s (genome_strs.nim:27-29,50-52)."""
    return oracle.slide_by(s, k)[0]


def _slide_codes_np(dna: str, k: int) -> np.ndarray:
    """Vectorized oracle.slide_by: min-rotation codes of the k-mers at
    stride-k positions 0, k, 2k, ... (utils.nim:10-35). Identical values;
    the Python per-character loop costs ~2us/base, which dominated the
    whole index stage at genome scale (trim runs over every merged
    region)."""
    n = len(dna)
    W = (n - k) // k + 1 if k <= n else 0
    if W <= 0:
        return np.zeros(0, np.int64)
    codes = (np.frombuffer(dna.encode(), np.uint8).astype(np.int64) >> 1) & 3
    wpos = np.arange(W, dtype=np.int64) * k
    win = codes[wpos[:, None] + np.arange(k)]
    f = np.zeros(W, np.int64)
    for m in range(k):
        f = (f << 2) | win[:, m]
    mask = (1 << (2 * k)) - 1
    kmin = f.copy()
    for _ in range(k - 1):
        f = ((f << 2) & mask) | (f >> (2 * (k - 1)))
        kmin = np.minimum(kmin, f)
    return kmin


def trim(w: Window, dna: str) -> Window:
    """Trim a merged window to the first/last matching kmer
    (genome_strs.nim:22-59)."""
    assert len(dna) == w.stop - w.start
    k = len(w.repeat)
    expected = _first_slide_code(w.repeat, k)
    # trim left: advance in steps of k up to the first matching kmer
    enc = _slide_codes_np(dna, k)
    hits = np.flatnonzero(enc == expected)
    w.start += int(hits[0]) * k if len(hits) else len(enc) * k
    assert w.start < w.stop, f"repeat {w.repeat} not found in expected region"
    # trim right: reverse both
    dnar = dna[::-1]
    rep_rev = w.repeat[::-1]
    expected = _first_slide_code(rep_rev, k)
    enc = _slide_codes_np(dnar, k)
    hits = np.flatnonzero(enc == expected)
    w.stop -= int(hits[0]) * k if len(hits) else len(enc) * k
    assert w.start < w.stop, f"repeat {w.repeat} not found in expected region"
    return w


def _provably_zero_rows(bases: np.ndarray, lens: np.ndarray,
                        prop: float) -> np.ndarray:
    """Vectorized host prefilter, same bound as extract_engine.cc
    provably_zero: for any k in 2..6 the kernel's exact non-overlapping
    modal-kmer count is <= the max positional count over the 16 dimers, and
    tp[k] = trunc(len*prop/k) (utils.nim:259) is smallest at k=6 — so rows
    with max_dimer <= trunc(len*prop/6) are provably count==0 and need no
    device scan. Pad bytes alias base codes and only OVERcount (sound)."""
    codes = (bases >> 1) & 3
    dimers = (codes[:, :-1] << 2) | codes[:, 1:]
    B, W = dimers.shape
    rowoff = np.arange(B, dtype=np.int64)[:, None] * 16
    counts = np.bincount((dimers.astype(np.int64) + rowoff).ravel(),
                         minlength=B * 16).reshape(B, 16)
    tp6 = (lens.astype(np.float64) * prop / 6.0).astype(np.int64)
    return counts.max(axis=1) <= tp6


def _chrom_zero_mask(chrom_bytes: np.ndarray, window: int, step: int,
                     prop: float) -> np.ndarray:
    """Per-window exact-zero mask for a whole chromosome via the native
    multithreaded scanner (csrc/genome_scan.cc): dimer bound first, then an
    exact get_repeat evaluation on survivors, so the mask is 1 exactly when
    the detector returns count==0 and only repeat-bearing windows travel to
    the device. Falls back to the numpy dimer bound if the library is
    unavailable."""
    try:
        import ctypes as C

        from strling_tpu.io.bam import _load

        hostlib.load()
        lib = _load()
        if not hasattr(lib.sio_genome_scan, "_bound"):
            P = np.ctypeslib.ndpointer
            lib.sio_genome_scan.restype = C.c_int64
            lib.sio_genome_scan.argtypes = [
                P(np.uint8), C.c_int64, C.c_int64, C.c_int64, C.c_double,
                P(np.uint8), C.c_int,
            ]
            lib.sio_genome_scan._bound = True
        L = len(chrom_bytes)
        n_windows = (L + step - 1) // step if L else 0
        mask = np.empty(max(1, n_windows), np.uint8)
        lib.sio_genome_scan(
            np.ascontiguousarray(chrom_bytes), L, window, step, prop, mask, 0
        )
        return mask[:n_windows].astype(bool)
    except Exception:
        return None


def repeat_windows(fai: Fasta, opts: Options, device,
                   window_size: int = WINDOW_SIZE, step: int = STEP,
                   batch_windows: int = 32768):
    """Yield merged, trimmed STR windows over every chromosome
    (genome_strs.nim:61-92), with the per-window repeat detection batched
    through the device kernel (fused 2-bit payload, 32k-window batches —
    a human genome is ~53M windows, so transfer width matters). Windows
    that the dimer-count bound proves repeat-free (the overwhelming
    majority of a real genome) never reach the device."""
    for chrom in fai.names:
        L = fai.chrom_len(chrom)
        if L > 2_000_000:
            print(
                f"[strling] finding STR regions on reference chromosome: {chrom}",
                file=sys.stderr,
            )
        chrom_seq = fai.get(chrom).upper()
        starts_np = np.arange(0, L, step, dtype=np.int64)
        # pack all windows via a strided view over the chromosome bytes —
        # no per-window Python work (53M windows for a human genome)
        cb = np.frombuffer(chrom_seq.encode(), np.uint8)
        pad = np.zeros(window_size, np.uint8)
        cbp = np.concatenate([cb, pad])
        sv = np.lib.stride_tricks.sliding_window_view(cbp, window_size)[::step]
        sv = sv[: len(starts_np)]
        lens_all = np.minimum(L - starts_np, window_size)
        zero_all = _chrom_zero_mask(cb, window_size, step,
                                    opts.proportion_repeat)
        if zero_all is None:
            parts = []
            for b0 in range(0, len(starts_np), batch_windows):
                parts.append(_provably_zero_rows(
                    np.ascontiguousarray(sv[b0:b0 + batch_windows]),
                    lens_all[b0:b0 + batch_windows],
                    opts.proportion_repeat))
            zero_all = np.concatenate(parts) if parts else np.zeros(0, bool)
        # only candidate windows (a tiny fraction of a real genome) are
        # gathered and scanned — in batches, but typically one device call
        cand_all = np.flatnonzero(~zero_all)
        cand_units: list[str] = []
        cand_counts = np.zeros(len(cand_all), np.int64)
        for b0 in range(0, len(cand_all), batch_windows):
            cidx = cand_all[b0 : b0 + batch_windows]
            bases = np.ascontiguousarray(sv[cidx])
            lens = lens_all[cidx].astype(np.int32)
            if bases.shape[1] < SCAN_WIDTH:
                bases = np.pad(bases, ((0, 0), (0, SCAN_WIDTH - bases.shape[1])))
            elif bases.shape[1] % 8:
                padc = 8 - bases.shape[1] % 8
                bases = np.pad(bases, ((0, 0), (0, padc)))
            code_c, ulen_c, count_c = scan_codes(
                bases, lens, np.full(len(lens), opts.proportion_repeat), device
            )
            cand_counts[b0 : b0 + len(cidx)] = count_c
            cand_units.extend(unpack_unit_codes(code_c, ulen_c))

        last_w = Window(stop=-1)
        hits = cand_counts > 0
        for ci in np.flatnonzero(hits):
            s = int(starts_np[cand_all[ci]])
            rep = cand_units[ci]
            stop = min(L, s + window_size)
            w = Window(chrom=chrom, start=s, stop=stop, repeat=rep)
            # merge consecutive same-unit windows; allow skipping 1 window
            if last_w.repeat != w.repeat or w.start > last_w.stop + (
                window_size - step
            ):
                if last_w.stop != -1 and last_w.stop - last_w.start >= (
                    window_size - step
                ):
                    last_w.start = max(0, last_w.start - window_size)
                    last_w.stop = min(last_w.stop + window_size, len(chrom_seq))
                    yield trim(last_w, chrom_seq[last_w.start : last_w.stop])
                last_w = w
            else:
                last_w.stop = w.stop
        if last_w.stop != -1 and last_w.stop - last_w.start >= (window_size - step):
            last_w.start = max(0, last_w.start - window_size)
            last_w.stop = min(last_w.stop + window_size, len(chrom_seq))
            yield trim(last_w, chrom_seq[last_w.start : last_w.stop])


class GenomeIndex:
    """Per-chromosome sorted interval arrays with prefix-max ends, replacing
    the reference's Lapper trees for the extract fast path
    (extract.nim:29-34)."""

    def __init__(self, regions_by_chrom: dict[str, list[tuple[int, int]]]):
        self.by_chrom: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        for chrom, ivs in regions_by_chrom.items():
            ivs = sorted(ivs)
            starts = np.array([a for a, _ in ivs], np.int64)
            ends = np.array([b for _, b in ivs], np.int64)
            pmax = np.maximum.accumulate(ends)
            self.by_chrom[chrom] = (starts, pmax)

    def __contains__(self, chrom: str) -> bool:
        return chrom in self.by_chrom

    def overlaps(self, chrom: str, starts: np.ndarray, stops: np.ndarray) -> np.ndarray:
        """Vectorized: does [start, stop) of each query overlap any STR region?

        Lapper.find semantics (iv.start < stop and iv.stop > start).
        """
        if chrom not in self.by_chrom:
            return np.zeros(len(starts), bool)
        s, pmax = self.by_chrom[chrom]
        idx = np.searchsorted(s, stops, side="left")  # candidates: [0, idx)
        out = np.zeros(len(starts), bool)
        nz = idx > 0
        out[nz] = pmax[idx[nz] - 1] > starts[nz]
        return out


def read_str_bed(path: str) -> GenomeIndex:
    regions: dict[str, list[tuple[int, int]]] = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or line.startswith("track "):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            regions.setdefault(parts[0], []).append((int(parts[1]), int(parts[2])))
    return GenomeIndex(regions)


def genome_repeats(fasta: str, opts: Options, bed_path: str,
                   device) -> GenomeIndex:
    """genome_strs.nim:107-141: build the .str bed if missing, then load it."""
    is_tmp = bed_path in ("", None)
    if is_tmp:
        fd, bed_path = tempfile.mkstemp(suffix=".bed")
        os.close(fd)
        os.unlink(bed_path)
    try:
        if not os.path.exists(bed_path):
            fai = Fasta(fasta)
            n = 0
            with open(bed_path, "w") as fh:
                for w in repeat_windows(fai, opts, device):
                    fh.write(f"{w.chrom}\t{w.start}\t{w.stop}\t{w.repeat}\n")
                    n += 1
            print(f"[strling] found {n} STR-like regions in the genome", file=sys.stderr)
        else:
            print(
                f"[strling] using existing file {bed_path} for genome repeats",
                file=sys.stderr,
            )
        gi = read_str_bed(bed_path)
        print("[strling] got STR repeats from genome into an interval tree", file=sys.stderr)
        return gi
    finally:
        if is_tmp and os.path.exists(bed_path):
            os.unlink(bed_path)
