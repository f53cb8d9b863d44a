"""Pure-Python specification of the repeat-unit detector.

A copy of `strling_tpu.ops.oracle` (itself a line-faithful port of the
reference STRling's hot loop, src/strpkg/utils.nim), on the port's copy of
the encode helpers (`ops.encode`), so the port can hold its kernel to it
without the JAX package. tests/test_torch_kmer.py keeps the two copies
equal. It is not the production path: that is `ops.kmer` and the CUDA
kernel.

- slide_by (utils.nim:10-35): non-overlapping windows of width k at stride
  k; each window contributes the minimum over its k cyclic rotations of the
  2-bit code (A=0, C=1, T=2, G=3, i.e. (ascii >> 1) & 3).
- count (utils.nim:192-211): the modal window code with a running-argmax
  tie-break: a code replaces the current argmax only when its count becomes
  strictly greater, so on final ties the code that reached it first wins.
- get_repeat (utils.nim:236-271): the k=2..6 scan with the k-mer-estimated
  score, early exit, exact substring recount, proportion threshold and
  homopolymer reduction.
"""

from __future__ import annotations

from strling_tpu_torch.ops.encode import decode_kmer, reduce_repeat


def slide_by(s: str, k: int) -> list[int]:
    """Window min-rotation codes (utils.nim:10-35)."""
    out = []
    n = len(s)
    if k > n:
        return out
    mask = (1 << (2 * k)) - 1

    def code(c: str) -> int:
        return (ord(c) >> 1) & 3

    # first window [0, k)
    f = 0
    for c in s[:k]:
        f = ((f << 2) | code(c)) & mask
    kmin = f
    for j in range(k):
        f = ((f << 2) | code(s[j])) & mask
        kmin = min(kmin, f)
    out.append(kmin)

    # subsequent windows at i = k, 2k, ... while i + k <= n
    i = k
    while i + k <= n:
        for m in range(k):
            f = ((f << 2) | code(s[i + m])) & mask
        kmin = f
        for j in range(k):
            f = ((f << 2) | code(s[i + j])) & mask
            kmin = min(kmin, f)
        out.append(kmin)
        i += k
    return out


def modal_window_code(s: str, k: int) -> tuple[int, int]:
    """(modal code, count) with the running-argmax tie-break; (-1, 0) when
    there are no windows (len(s) < k), as count==0 / imax==-1 in
    utils.nim:205-211."""
    counts: dict[int, int] = {}
    imax = -1
    for enc in slide_by(s, k):
        c = counts.get(enc, 0) + 1
        counts[enc] = c
        if imax == -1 or c > counts[imax]:
            imax = enc
    if imax == -1:
        return -1, 0
    return imax, counts[imax]


def get_repeat(read: str, proportion_repeat: float) -> tuple[str, int]:
    """utils.nim:236-271: (repeat_unit, repeat_count). The unit is "" when
    the read is not STR-like; the count includes the homopolymer
    multiplier (utils.nim:271)."""
    if read.count("N") > 20:  # utils.nim:238
        return "", 0

    best_score = -1
    result = ""
    repeat_count = 0
    L = len(read)
    for k in range(2, 7):
        imax, count = modal_window_code(read, k)
        # imax == -1 decodes as all-ones bits -> "G"*k, like Nim's
        # imax.uint64 underflow (utils.nim:197,246)
        s = decode_kmer(imax if imax >= 0 else (1 << (2 * k)) - 1, k)
        score = count * k
        if score <= best_score:
            if count < int(L * 0.12 / k):  # utils.nim:251
                break
            continue
        count = read.count(s)  # non-overlapping, utils.nim:254
        score = count * k
        if score < best_score:  # utils.nim:256
            continue
        best_score = score
        if count > int(L * proportion_repeat / k):  # utils.nim:259
            result = s
            repeat_count = count

    unit, mult = reduce_repeat(result)
    return unit, repeat_count * mult
