"""Fault F9: counts of 256 and more spill into the unit length of the JAX
package's packed result word (`cnt | ulen << 8 | code << 11`), so for
homopolymers of 512 bases and more and for long dimer runs its bin holds
`AAA`/`AAC` where the port's holds `A`/`AC`. The oracle is the judge: the
port keeps the oracle's unit, with the count modulo 256 as the bin stores
it, and its engine refuses a unit longer than the 6-byte repeat field.
"""

import numpy as np
import pytest
import torch

from strling_tpu.core.extract import extract_native as ref_extract_native
from strling_tpu.io.bam import Bam as RefBam
from strling_tpu.io.bamwrite import BamRecord, write_bam
from strling_tpu.ops.kmer import unpack_result as ref_unpack_result
from strling_tpu_torch.core.extract import extract_native
from strling_tpu_torch.io import Bam
from strling_tpu_torch.io import extract_native as EN
from strling_tpu_torch.ops import kmer as TK
from strling_tpu_torch.ops import oracle
from strling_tpu_torch.ops.kmer_cuda import repeat_scan

from test_extract import HEADER, TARGETS

torch.set_num_threads(1)
CPU = [torch.device("cpu")]

#: the reads of ROADMAP Queue C, with the JAX package's (unit, count) from
#: its packed word: 512 = 0x200 and 600 = 0x258 set length bit 1 (1 -> 3),
#: 1600 = 0x640 sets bits 1 and 2 (1 -> 7), 299 = 0x12b sets bit 0 (2 -> 3)
F9_READS = [
    ("A" * 512, ("AAA", 0)),
    ("A" * 600, ("AAA", 88)),
    ("A" * 1600, ("AAAAAAA", 64)),
    ("CA" * 300, ("AAC", 43)),
]


def _w16_rows(reads):
    L = -(-max(map(len, reads)) // 8) * 8
    bases = np.zeros((len(reads), L), np.uint8)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    lengths = np.array([len(r) for r in reads], np.int32)
    return bases, lengths, np.full(len(reads), 0.8)


def test_f9_unit_is_the_oracles_count_mod_256():
    """The port's scan on w16 rows gives the oracle's unit, and its count
    modulo 256; the JAX package's packed word of the same result gives the
    spilled unit of the table above."""
    reads = [r for r, _ in F9_READS]
    bases, lengths, props = _w16_rows(reads)
    payload, layout = TK.fuse_payload(bases, lengths, props,
                                      return_layout=True)
    assert layout == "w16"
    code, ulen, cnt = (t.numpy() for t in repeat_scan(
        torch.from_numpy(payload), layout))
    units = TK.unpack_unit_codes(code, ulen)
    want = [oracle.get_repeat(r, 0.8) for r in reads]
    assert want == [("A", 512), ("A", 600), ("A", 1600), ("AC", 299)]
    assert units == [u for u, _ in want]
    assert cnt.tolist() == [c for _, c in want]
    # what the JAX package's word makes of the same exact result
    word = cnt | (ulen << 8) | (code << 11)
    rcode, rlen, rcnt = ref_unpack_result(word)
    ref = [("".join("ACGT"[(int(c) >> (2 * (n - 1 - j))) & 3]
                    for j in range(n)), int(k))
           for c, n, k in zip(rcode, rlen, rcnt)]
    assert ref == [w for _, w in F9_READS]
    assert [(u, c % 256) for u, c in want] == list(zip(units, rcnt.tolist()))


def _f9_bam(path, rng):
    """600-base pairs: three F9 reads (the 512 homopolymer padded with 88
    random bases) and CAG x 200, each with a random anchored mate, among
    background pairs."""
    alphabet = np.array(list("ACGT"))

    def rand(n):
        return "".join(alphabet[rng.integers(0, 4, n)])

    special = {5: "CA" * 300, 15: "A" * 600, 25: "A" * 512 + rand(88),
               35: "CAG" * 200}
    recs = []
    for i in range(120):
        pos = 1000 + i * 97
        s1 = rand(600)
        s2 = special.get(i, rand(600))
        recs.append(BamRecord(f"p{i}", 99, 0, pos, 60, "600M", 0, pos + 200,
                              900, s1))
        recs.append(BamRecord(f"p{i}", 147, 0, pos + 200, 60, "600M", 0, pos,
                              -900, s2))
    recs.sort(key=lambda r: r.pos)
    write_bam(path, HEADER, TARGETS, recs)


def test_f9_bin_differs_from_reference_only_in_the_f9_treads(tmp_path):
    """At the bin: the port's treads equal the JAX package's, row for row,
    except the F9 treads' repeat fields (`AC`/`A` where it writes
    `AAC`/`AAA`). CAG x 200 (count 199) is equal. The unit also feeds
    p_repeat = ((count * unit length) & 255) / align length, which decides
    whether the mate places a tread: for A x 600 the oracle's unit gives
    88 / 88 = 1.0 > 0.8 and the spilled one (264 & 255) / 88 = 0.09, so
    that one tread is also placed by its anchored mate (3,311, where the JAX
    package moves it by half its length to 2,699)."""
    path = str(tmp_path / "f9.bam")
    _f9_bam(path, np.random.default_rng(9))
    tb, frag, _ = extract_native(Bam(path, Lmax=600), None, None,
                                 devices=CPU)
    # opened wide enough that the JAX package takes no width retry (F5)
    rtb, rfrag, _ = ref_extract_native(RefBam(path, Lmax=600), None, None)
    assert np.array_equal(frag, rfrag)
    assert tb.qnames == rtb.qnames
    got, want = tb.data, rtb.data
    assert len(got) == len(want) == 4
    diff = {}
    for i, q in enumerate(tb.qnames):
        diff[q] = {f: (want[f][i], got[f][i]) for f in got.dtype.names
                   if want[f][i] != got[f][i]}
    assert diff == {
        "p5": {"repeat": (b"AAC", b"AC")},
        "p15": {"repeat": (b"AAA", b"A"), "position": (2699, 3311)},
        "p25": {"repeat": (b"AAA", b"A")},
        "p35": {},
    }
    assert got["repeat_count"].tolist() == [43, 88, 8, 199]


def test_engine_refuses_a_unit_longer_than_6(tmp_path, monkeypatch):
    """A scan result with a unit length of 7 (what the JAX package's word
    gives A x 1600) makes the engine raise; nothing is written past the
    repeat field."""
    path = str(tmp_path / "f9.bam")
    _f9_bam(path, np.random.default_rng(9))
    real = EN.scan_payload

    def spilled(payload, rows, layout, dev):
        code, ulen, cnt = real(payload, rows, layout, dev)
        ulen = np.where((ulen == 1) & (cnt >= 512), 7, ulen).astype(np.int32)
        return code, ulen, cnt

    monkeypatch.setattr(EN, "scan_payload", spilled)
    with pytest.raises(IOError, match="unit length of 7"):
        extract_native(Bam(path, Lmax=600), None, None, devices=CPU)
