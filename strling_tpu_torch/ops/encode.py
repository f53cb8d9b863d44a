"""2-bit DNA encoding and repeat-unit canonicalization: the helpers of
`strling_tpu.ops.encode` that `call`, `simulate` and the detector's
specification (`ops.oracle`) use, copied unchanged.

The reference delegates 2-bit encoding to the external nim `kmer` package
(imported at src/strpkg/utils.nim:1) which uses the classic bit trick

    code = (ascii >> 1) & 3      ->  A=0, C=1, T=2, G=3

with decode table "ACTG". All rotation minima in the reference ("canonical
rotation", utils.nim:10-35; "min_rev_complement", utils.nim:61-80) are minima
over these 2-bit integer codes, i.e. minima under the ordering A < C < T < G
(NOT plain ASCII order). The *final* canonicalization step
(`canonical_repeat`, utils.nim:304-316) compares the forward unit with the
min-rotation of its reverse complement using plain char/ASCII comparison on
the 6-char array.
"""

from __future__ import annotations

DECODE = "ACTG"  # code -> base

COMPLEMENT = {"A": "T", "T": "A", "C": "G", "G": "C"}


def encode_kmer(s: str) -> int:
    """uint64 2-bit encoding of a kmer (nim-kmer `encode`)."""
    v = 0
    for c in s:
        v = (v << 2) | ((ord(c) >> 1) & 3)
    return v


def decode_kmer(v: int, k: int) -> str:
    """Inverse of encode_kmer for ACTG alphabet (nim-kmer `decode`)."""
    out = []
    for i in range(k):
        out.append(DECODE[(v >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


def complement(s: str) -> str:
    """Per-base complement; non-ACGT chars unchanged (utils.nim:37-47,55-59)."""
    return "".join(COMPLEMENT.get(c, c) for c in s)


def reverse_complement(s: str) -> str:
    """utils.nim:49-53."""
    return complement(s)[::-1]


def min_rotation(s: str) -> str:
    """Minimum rotation of ``s`` under the 2-bit code ordering (A<C<T<G).

    Matches the reference's rotate-and-min loop (utils.nim:10-35 applied to a
    doubled string in min_rev_complement, utils.nim:70-76): the minimum is
    taken over encoded uint64 values, so ordering is by 2-bit code.
    """
    if not s:
        return s
    return decode_kmer(min(encode_kmer(s[i:] + s[:i]) for i in range(len(s))), len(s))


def min_rev_complement(s: str) -> str:
    """Min 2-bit-code rotation of the reverse complement (utils.nim:61-80).

    Note the result is decoded through the ACTG table, so any non-ACGT input
    chars are laundered into ACTG — same as the reference.
    """
    return min_rotation(reverse_complement(s))


def canonical_repeat(s: str) -> str:
    """Return the 'canonical' unit used for unplaced reads and repeat grouping.

    utils.nim:304-316: candidate = min-code-rotation of the reverse
    complement; return it if it is smaller than the *unrotated* input by
    6-char-array (ASCII, NUL-padded) comparison, else the input unchanged.
    """
    if not s:
        return s
    cand = min_rev_complement(s)
    # array[6,char] comparison: NUL-padded ASCII lexicographic (utils.nim:291-302)
    a = cand.encode().ljust(6, b"\x00")
    b = s.encode().ljust(6, b"\x00")
    return cand if a < b else s


def reduce_repeat(s: str) -> tuple[str, int]:
    """Collapse homopolymer units: "AA" -> ("A", 2); "CTC" -> ("CTC", 1).

    utils.nim:220-233 — the returned int multiplies the repeat_count.
    """
    if not s:
        return s, 1
    if all(c == s[0] for c in s):
        return s[0], len(s)
    return s, 1
