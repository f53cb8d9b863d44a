"""The benchmark's own `.str` index of a FASTA: the bed that `extract -g`
reads, made as STRling's `index` makes it (genome_strs.nim:22-141) and
independently of the program.

Windows of 100 bp at a step of 60 are scanned by the plain detector
(`portbench.reference.detector`) at the proportion 0.8, after a sound
prefilter: a window whose most frequent dimer occurs no more than
trunc(len * p / 6) times cannot reach the threshold of any k. Hits with the
same unit that follow each other (one window may be skipped) are merged, a
merged run of at least 40 bp is widened by 100 bp on both sides and trimmed
to the first and last window of its unit's code.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.detector import detect

WINDOW, STEP = 100, 60


def _slide_codes(dna: np.ndarray, k: int) -> np.ndarray:
    """Min-rotation codes of the k-mers at 0, k, 2k, ... (utils.nim:10-35)."""
    n = len(dna)
    W = (n - k) // k + 1 if k <= n else 0
    if W <= 0:
        return np.zeros(0, np.int64)
    codes = (dna.astype(np.int64) >> 1) & 3
    win = codes[np.arange(W)[:, None] * k + np.arange(k)]
    f = np.zeros(W, np.int64)
    for m in range(k):
        f = (f << 2) | win[:, m]
    mask = (1 << (2 * k)) - 1
    kmin = f.copy()
    for _ in range(k - 1):
        f = ((f << 2) & mask) | (f >> (2 * (k - 1)))
        kmin = np.minimum(kmin, f)
    return kmin


def _trim(start: int, stop: int, unit: bytes, seq: np.ndarray):
    k = len(unit)
    dna = seq[start:stop]
    expected = _slide_codes(np.frombuffer(unit, np.uint8), k)[0]
    enc = _slide_codes(dna, k)
    hits = np.flatnonzero(enc == expected)
    start += int(hits[0]) * k if len(hits) else len(enc) * k
    rev = dna[::-1]
    expected = _slide_codes(np.frombuffer(unit[::-1], np.uint8), k)[0]
    enc = _slide_codes(rev, k)
    hits = np.flatnonzero(enc == expected)
    stop -= int(hits[0]) * k if len(hits) else len(enc) * k
    return start, stop


def _candidates(seq: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                prop: float) -> np.ndarray:
    """Windows the dimer bound cannot rule out."""
    codes = (seq.astype(np.int64) >> 1) & 3
    keep = []
    for b0 in range(0, len(starts), 1 << 16):
        s = starts[b0:b0 + (1 << 16)]
        idx = np.minimum(s[:, None] + np.arange(WINDOW), len(seq) - 1)
        c = codes[idx]
        valid = np.arange(WINDOW - 1)[None, :] < (lens[b0:b0 + len(s)] - 1)[:, None]
        dim = np.where(valid, (c[:, :-1] << 2) | c[:, 1:], 16)
        rowoff = np.arange(len(s), dtype=np.int64)[:, None] * 17
        cnt = np.bincount((dim + rowoff).ravel(), minlength=len(s) * 17)
        cnt = cnt.reshape(len(s), 17)[:, :16]
        tp6 = (lens[b0:b0 + len(s)].astype(np.float64) * prop / 6.0).astype(np.int64)
        keep.append(cnt.max(axis=1) > tp6)
    return np.flatnonzero(np.concatenate(keep)) if keep else np.zeros(0, np.int64)


def index_contig(name: str, seq: np.ndarray, device, prop: float = 0.8):
    """Bed lines (chrom, start, stop, unit) of one contig, in order."""
    G = len(seq)
    starts = np.arange(0, G, STEP, dtype=np.int64)
    lens = np.minimum(G - starts, WINDOW)
    cand = _candidates(seq, starts, lens, prop)
    padded = np.concatenate([seq, np.zeros(WINDOW + 8, np.uint8)])
    rows = padded[starts[cand][:, None] + np.arange(104)]
    rows = np.where(np.arange(104)[None, :] < lens[cand][:, None], rows, 0)
    unit, ulen, count = detect(rows.astype(np.uint8), lens[cand],
                               np.full(len(cand), prop), device)
    out = []
    last = None  # [start, stop, unit]

    def emit(w):
        if w is not None and w[1] - w[0] >= WINDOW - STEP:
            a, b = max(0, w[0] - WINDOW), min(w[1] + WINDOW, G)
            a, b = _trim(a, b, w[2], seq)
            out.append((name, a, b, w[2].decode()))

    for j in np.flatnonzero(count > 0):
        s = int(starts[cand[j]])
        u = bytes(unit[j, :ulen[j]])
        stop = min(G, s + WINDOW)
        if last is None or last[2] != u or s > last[1] + (WINDOW - STEP):
            emit(last)
            last = [s, stop, u]
        else:
            last[1] = stop
    emit(last)
    return out


def write_index(path: str, contigs: list[tuple[str, np.ndarray]],
                device=None) -> int:
    device = device or torch.device("cpu")
    n = 0
    with open(path, "w") as fh:
        for name, seq in contigs:
            for chrom, a, b, u in index_contig(name, seq, device):
                fh.write(f"{chrom}\t{a}\t{b}\t{u}\n")
                n += 1
    return n
