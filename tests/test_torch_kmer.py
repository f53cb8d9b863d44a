"""strling_tpu_torch repeat-unit scan vs the JAX package and the oracle.

The plain PyTorch twin (the CPU path of the CUDA kernel's wrapper) is held
to the reference's XLA detector, its Pallas kernel in interpret mode and the
pure-Python oracle. All outputs are integers: equality is exact.
"""

import numpy as np
import pytest
import torch

from strling_tpu.ops import kmer as RK
from strling_tpu.ops import oracle
from strling_tpu.ops.kmer_pallas import get_repeat_device_pallas
from strling_tpu_torch.ops import kmer as TK
from strling_tpu_torch.ops import oracle as port_oracle
from strling_tpu_torch.ops.kmer_cuda import repeat_scan

torch.set_num_threads(1)

UNITS = ["AT", "CAG", "AAGGG", "GGGGCC", "A", "ATTCT", "TG"]
ADVERSARIAL = [
    "CAGTTG" * 25, "TTGCAG" * 25, "CAGTTG" * 24 + "CAG", "TTGCAG" * 24 + "TTG",
    "ATGC" * 30, "ACGTAACC" * 15, ("AAGGG" + "CCTTT") * 15,
    "CAGCAG", "CAGCAGC", "ATATAT",
]
IUPAC = [
    "CAG" * 20 + "R" + "CAG" * 20, ("CAR" * 30)[:90],
    "AT" * 30 + "RYSWKM" + "AT" * 30, "R" * 60, "cag" * 40,
]


def _random_reads(seed, n, max_len=153, alphabet="ACGTN"):
    rng = np.random.default_rng(seed)
    alpha = np.array(list(alphabet))
    reads, props = [], []
    for _ in range(n):
        mode = rng.integers(0, 4)
        L = int(rng.integers(1, max_len))
        u = UNITS[rng.integers(0, len(UNITS))]
        if mode == 0:
            read = "".join(alpha[rng.integers(0, 4, L)])
        elif mode == 1:
            ph = int(rng.integers(0, len(u)))
            read = (u * (L // len(u) + 2))[ph: ph + L]
        elif mode == 2:
            r = list((u * (L // len(u) + 2))[:L])
            for _ in range(max(1, L // 12)):
                r[rng.integers(0, L)] = alpha[rng.integers(0, len(alpha))]
            read = "".join(r)
        else:
            h = L // 2
            read = (u * (h // len(u) + 2))[:h] + "".join(
                alpha[rng.integers(0, 4, L - h)])
        reads.append(read)
        props.append(float(rng.choice([0.8, 0.73, 0.6, 0.4])))
    return reads, props


def _batch(reads, props, L=160):
    bases = np.zeros((len(reads), L), np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
        lengths[i] = len(r)
    return bases, lengths, np.asarray(props, np.float64)


def _twin(bases, lengths, props):
    te, tp = TK._host_thresholds(lengths, props)
    out = TK.get_repeat_device(*(torch.from_numpy(a) for a in
                                 (bases, lengths, te, tp)))
    return tuple(t.numpy() for t in out)


def _assert_matches(reads, props, L=160):
    """Twin == reference XLA detector == oracle, read by read."""
    bases, lengths, props = _batch(reads, props, L)
    unit, ulen, cnt = _twin(bases, lengths, props)
    te, tp = RK._host_thresholds(lengths, props)
    want = RK._get_repeat_jit(bases, lengths, te, tp)
    for got, ref in zip((unit, ulen, cnt), want):
        np.testing.assert_array_equal(got, np.asarray(ref))
    units = TK.units_to_strings(unit, ulen)
    for i, (r, p) in enumerate(zip(reads, props)):
        assert (units[i], int(cnt[i])) == oracle.get_repeat(r, float(p)), (i, r)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_twin_matches_xla_and_oracle_random(seed):
    _assert_matches(*_random_reads(seed, 64))


@pytest.mark.parametrize("seed", [1, 2])
def test_port_oracle_is_reference_oracle(seed):
    """The port's copy of the oracle answers as the JAX package's, stage by
    stage, on random reads, the adversarial ties, IUPAC bytes and edge
    lengths."""
    reads, props = _random_reads(seed, 200)
    reads += ADVERSARIAL + IUPAC + ["", "A", "AC", "N" * 21 + "A" * 100]
    props += [0.3] * (len(reads) - len(props))
    for r, p in zip(reads, props):
        for k in range(2, 7):
            assert port_oracle.slide_by(r, k) == oracle.slide_by(r, k)
            assert (port_oracle.modal_window_code(r, k)
                    == oracle.modal_window_code(r, k))
        assert port_oracle.get_repeat(r, p) == oracle.get_repeat(r, p), r


@pytest.mark.parametrize("corpus", ["fixtures", "adversarial", "iupac"])
def test_twin_matches_xla_and_oracle_corpora(corpus):
    if corpus == "fixtures":
        reads = ["A" * 150, "TGC" * 50 + "T", "ACGTAC" * 25,
                 "N" * 30 + "AT" * 60, "A", "", "N" * 21 + "A" * 100]
        props = [0.6, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8]
    elif corpus == "adversarial":
        reads, props = ADVERSARIAL, [0.3] * len(ADVERSARIAL)
    else:
        reads, props = IUPAC, [0.5] * len(IUPAC)
    _assert_matches(reads, props)


def test_twin_fixture_values():
    unit, ulen, cnt = _twin(*_batch(["TGC" * 50 + "T", "A" * 150,
                                     "N" * 30 + "AT" * 60], [0.8, 0.6, 0.8]))
    assert TK.units_to_strings(unit, ulen) == ["CTG", "A", ""]
    assert cnt.tolist() == [49, 150, 0]


def test_twin_matches_pallas_interpret_tile():
    """One tile through the reference Pallas kernel (interpret mode): the
    ASCII entry with random, repeat, adversarial and IUPAC reads."""
    reads, props = _random_reads(7, 40)
    reads += ADVERSARIAL + IUPAC
    props += [0.3] * len(ADVERSARIAL) + [0.5] * len(IUPAC)
    bases, lengths, props = _batch(reads, props)
    te, tp = RK._host_thresholds(lengths, props)
    want = get_repeat_device_pallas(bases, lengths, te, tp, interpret=True)
    got = repeat_scan(torch.from_numpy(bases), "ascii",
                      *(torch.from_numpy(a) for a in (lengths, te, tp)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _f1_tile(L):
    """1024 rows: 0-255 short random, 256-511 full-length CAG/TTC mixtures
    (the second 8-bit lane field of the Pallas k=3 SWAR modal, F1)."""
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (1024, L))]
    lengths = np.full(1024, L, np.int32)
    lengths[:256] = rng.integers(20, 100, 256)
    for i in range(256):
        bases[i, lengths[i]:] = 0
    for i in range(256, 512):
        units = rng.random(L // 3 + 1) < rng.uniform(0.2, 0.8)
        s = b"".join(b"CAG" if u else b"TTC" for u in units)[:L]
        bases[i] = np.frombuffer(s, np.uint8)
    return bases, lengths


@pytest.mark.parametrize("L,layout", [(256, "w16"), (248, "n8")])
def test_f1_tile_matches_xla_and_oracle(L, layout):
    """The F1 corpus is judged by the XLA detector and the oracle (the
    Pallas kernel is what is wrong there)."""
    bases, lengths = _f1_tile(L)
    props = np.full(1024, 0.8)
    payload, got_layout = TK.fuse_payload(bases, lengths, props,
                                          return_layout=True)
    assert got_layout == layout
    code, ulen, cnt = (t.numpy() for t in
                       repeat_scan(torch.from_numpy(payload), layout))
    want = RK.unpack_result(np.asarray(RK._fused_xla_jit(payload, layout)))
    for g, w in zip((code, ulen, cnt), want):
        np.testing.assert_array_equal(g, w)
    units = TK.unpack_unit_codes(code, ulen)
    for i in range(256, 512):
        read = bases[i, :lengths[i]].tobytes().decode()
        assert (units[i], int(cnt[i])) == oracle.get_repeat(read, 0.8), i


def test_f2_homopolymer_count_is_exact():
    """A 256bp homopolymer counts 256 (the oracle's answer); the count is
    never folded into 8 bits, on the payload or the ASCII entry."""
    reads = ["A" * 256, "A" * 264, "C" * 256, "CA" * 132]
    bases, lengths, props = _batch(reads, [0.8] * 4, L=264)
    payload, layout = TK.fuse_payload(bases, lengths, props, return_layout=True)
    assert layout == "w16"
    te, tp = TK._host_thresholds(lengths, props)
    outs = [repeat_scan(torch.from_numpy(payload), layout),
            repeat_scan(torch.from_numpy(bases), "ascii",
                        *(torch.from_numpy(a) for a in (lengths, te, tp)))]
    want = [oracle.get_repeat(r, 0.8) for r in reads]
    assert want[0] == ("A", 256) and want[1] == ("A", 264)
    for code, ulen, cnt in outs:
        units = TK.unpack_unit_codes(code.numpy(), ulen.numpy())
        assert list(zip(units, cnt.tolist())) == want


@pytest.mark.parametrize("L,with_n,layout", [
    (104, False, "n8"), (152, True, "w8"), (152, False, "n8"),
    (256, True, "w16"), (256, False, "w16")])
def test_fused_payload_byte_equal_and_scan_matches(L, with_n, layout):
    reads, props = _random_reads(L, 96, max_len=L + 1,
                                 alphabet="ACGTN" if with_n else "ACGT")
    bases, lengths, props = _batch(reads, props, L)
    payload, got_layout = TK.fuse_payload(bases, lengths, props,
                                          return_layout=True)
    want, want_layout = RK.fuse_payload(bases, lengths, props,
                                        return_layout=True)
    assert got_layout == want_layout == layout
    np.testing.assert_array_equal(payload, want)
    for a, b in zip(TK.pack_bases(bases), RK.pack_bases(bases)):
        np.testing.assert_array_equal(a, b)
    got = [t.numpy() for t in repeat_scan(torch.from_numpy(payload), layout)]
    ref = RK.unpack_result(np.asarray(RK._fused_xla_jit(payload, layout)))
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g, w)
    # the unfused rows are the reference's
    ub, ul, ute, utp = TK.unfuse_payload(torch.from_numpy(payload), layout)
    rb, rl, rte, rtp = RK.unfuse_payload(payload, layout)
    for g, w in zip((ub, ul, ute, utp), (rb, rl, rte, rtp)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fuse_payload_rejects_like_reference():
    bases = np.full((4, 32), ord("A"), np.uint8)
    bases[2, 7] = ord("R")
    lengths = np.full(4, 32, np.int32)
    assert TK.fuse_payload(bases, lengths, np.full(4, 0.8)) is None
    assert TK.pack_bases(bases) is None
    assert TK.fuse_payload(bases[:, :30], lengths, np.full(4, 0.8)) is None
    with pytest.raises(ValueError):
        TK.payload_geometry(35, "auto")


def test_host_helpers_equal_reference():
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, 300, 500).astype(np.int32)
    props = rng.choice([0.8, 0.73, 0.6, 0.53, 1.0], 500)
    for a, b in zip(TK._host_thresholds(lengths, props),
                    RK._host_thresholds(lengths, props)):
        np.testing.assert_array_equal(a, b)
    ulen = rng.integers(0, 7, 500).astype(np.int32)
    code = (rng.integers(0, 4096, 500) & ((1 << (2 * ulen)) - 1)).astype(np.int32)
    unit = TK.codes_to_ascii(code, ulen)
    np.testing.assert_array_equal(unit, RK.codes_to_ascii(code, ulen))
    np.testing.assert_array_equal(TK.ascii_to_codes(unit, ulen), code)
    assert TK.units_to_strings(unit, ulen) == RK.units_to_strings(unit, ulen)
    from strling_tpu.ops.kmer_pallas import unpack_unit_codes

    assert TK.unpack_unit_codes(code, ulen) == unpack_unit_codes(code, ulen)
    packed = rng.integers(0, 1 << 31, 200).astype(np.int32)
    for a, b in zip(TK.unpack_result(packed), RK.unpack_result(packed)):
        np.testing.assert_array_equal(a, b)


def test_scan_codes_and_get_repeat_batch_match_reference():
    """The numpy-level dispatch on the CPU device: fused rows, the ASCII
    fallback (IUPAC bytes) and the unit-ASCII entry."""
    reads, props = _random_reads(9, 120)
    reads += IUPAC
    props += [0.5] * len(IUPAC)
    bases, lengths, props = _batch(reads, props, 152)
    for sl in (slice(0, 120), slice(None)):  # n8/w8 payload, then ASCII
        got = TK.scan_codes(bases[sl], lengths[sl], props[sl], "cpu")
        want = RK.scan_codes(bases[sl], lengths[sl], props[sl],
                             backend="xla", bucket=256)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got = TK.get_repeat_batch(bases, lengths, props, "cpu")
    want = RK.get_repeat_batch(bases, lengths, props, backend="xla")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    empty = TK.scan_codes(bases[:0], lengths[:0], props[:0], "cpu")
    assert all(len(a) == 0 for a in empty)


def test_wrapper_checks_device():
    x = torch.zeros((4, 49), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        repeat_scan(x, "n8")
