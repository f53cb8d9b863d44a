"""The port's CRAM codec encoders (strling_tpu_torch/io/cramwrite.py) against
the JAX package's, and the port's engine decoding them.

Every encoder gives bytes equal to the JAX package's on the same seeded
inputs: rANS4x8 orders 0 and 1, rANSNx16 in every configuration, the name
tokeniser (rANS and arithmetic streams), the adaptive arithmetic coder and
fqzcomp (3.0 and 3.1 forms, and its store_array tables). The port's engine
(`strling_tpu_torch.io.bam._load`, built from the port's own sources) decodes
each of them, fails cleanly on corrupt streams, and decodes the frozen
fqzcomp fixtures of tests/test_fqz_fixtures.py; the port's fixture generator
makes the same bytes as the JAX package's.
"""

import importlib.util
import os
import random

import numpy as np
import pytest

import strling_tpu.io.cramwrite as R
import strling_tpu_torch.io.cramwrite as P
from strling_tpu_torch.io.bam import _load

from test_cram import NX16_CONFIGS, nx16_cases, rans_cases, tok3_name_cases
from test_cram_arith import arith_cases, qual_recs
from test_fqz_fixtures import (FQZ_STREAM_EXPECTED, FQZ_STREAM_FIXTURE,
                               STORE_ARRAY_FIXTURES)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def decode(fn: str, blob: bytes, out_sz: int, with_size: bool = True) -> bytes:
    lib = _load()
    out = np.zeros(max(out_sz, 1), np.uint8)
    if with_size:
        n = getattr(lib, fn)(blob, len(blob), out_sz, out, len(out))
    else:
        n = getattr(lib, fn)(blob, len(blob), out, len(out))
    assert n == out_sz, f"{fn} returned {n}, want {out_sz}"
    return bytes(out[:out_sz])


def both(name, *a, **kw):
    """The JAX package's and the port's encoder on the same input; the
    bytes must be equal."""
    want = getattr(R, name)(*a, **kw)
    got = getattr(P, name)(*a, **kw)
    assert got == want, name
    return got


# ------------------------------------------------------------ rANS4x8


@pytest.mark.parametrize("order", [0, 1])
def test_rans_equal_and_decoded(order):
    for data in rans_cases():
        blob = both(f"rans_encode_o{order}", data)
        assert decode("sio_rans_decode", blob, len(data), False) == data


# ------------------------------------------------------------ rANSNx16


@pytest.mark.parametrize("ci", range(len(NX16_CONFIGS)))
def test_nx16_equal_and_decoded(ci):
    for data in nx16_cases():
        blob = both("nx16_encode", data, **NX16_CONFIGS[ci])
        assert decode("sio_rans_nx16_decode", blob, len(data)) == data


def test_nx16_pack_equal_and_decoded():
    for data in nx16_cases():
        if len(set(data)) > 16:
            continue
        for cfg in (dict(order=0, pack=True), dict(order=1, pack=True),
                    dict(order=0, pack=True, rle=True)):
            blob = both("nx16_encode", data, **cfg)
            assert decode("sio_rans_nx16_decode", blob, len(data)) == data


# ------------------------------------------------------------ tok3


@pytest.mark.parametrize("use_arith", [False, True])
def test_tok3_equal_and_decoded(use_arith):
    for names in tok3_name_cases():
        blob = b"".join(n.encode() + b"\x00" for n in names)
        enc = both("tok3_encode", blob, use_arith=use_arith)
        assert decode("sio_tok3_decode", enc, len(blob)) == blob


# ------------------------------------------------------------ arith


ARITH_CONFIGS = [dict(order=0), dict(order=1), dict(order=0, rle=True),
                 dict(order=1, rle=True), dict(cat=True),
                 dict(order=1, stripe=3)]


@pytest.mark.parametrize("cfg", ARITH_CONFIGS, ids=str)
def test_arith_equal_and_decoded(cfg):
    for data in arith_cases():
        blob = both("arith_encode", data, **cfg)
        assert decode("sio_arith_decode", blob, len(data)) == data


def test_arith_pack_equal_and_decoded():
    rng = random.Random(5)
    for nsym in (1, 2, 3, 4, 7, 16):
        syms = bytes(range(40, 40 + nsym))
        data = bytes(rng.choice(syms) for _ in range(3001))
        for order in (0, 1):
            blob = both("arith_encode", data, order=order, pack=True)
            assert decode("sio_arith_decode", blob, len(data)) == data


# ------------------------------------------------------------ fqzcomp


def _fqz_cases():
    rng = random.Random(11)
    cases = {"basic": (qual_recs(rng, 40), {})}
    rng = random.Random(12)
    cases["fixed_len"] = (qual_recs(rng, 30, lmin=100, lmax=100),
                          dict(do_len=False))
    rng = random.Random(13)
    recs = qual_recs(rng, 20, lmin=80, lmax=80)
    recs = [recs[0]] + [recs[0]] * 2 + recs[1:] + [recs[3]]
    recs[4] = recs[3]
    cases["dedup_tables"] = (recs, dict(
        do_dedup=True, qbits=6, qshift=3, qloc=4, ploc=10, dloc=0,
        qtab=[min(i, 15) for i in range(256)],
        ptab=[min(i // 16, 15) for i in range(1024)],
        dtab=[min(i, 7) for i in range(256)]))
    rng = random.Random(14)
    qmap = bytes([33, 45, 60, 70])
    cases["qmap"] = ([bytes(rng.choice(qmap) for _ in range(120))
                      for _ in range(25)], dict(qmap=qmap, qbits=4, qshift=2))
    return cases


@pytest.mark.parametrize("case", list(_fqz_cases()))
def test_fqz_encode_equal_and_decoded(case):
    recs, kw = _fqz_cases()[case]
    blob = both("fqz_encode", recs, **kw)
    want = b"".join(recs)
    assert decode("sio_fqz_decode", blob, len(want)) == want


def _fqz31_cases():
    rng = np.random.default_rng(1)
    recs, sels = [], []
    for i in range(40):
        if i % 3 == 0:
            recs.append(bytes([40] * 80))
            sels.append(1)
        else:
            recs.append(bytes(rng.integers(33, 73, 80).astype(np.uint8)))
            sels.append(0)
    cases = {"multi_param": (recs, [
        dict(qbits=8, qshift=5, qloc=7, ploc=0, dloc=13, do_sel=True, sloc=0),
        dict(qbits=2, qshift=1, qloc=7, ploc=0, dloc=13, context=0x1234)],
        dict(selectors=sels, stab=[0, 1] + [1] * 254))}
    rng = np.random.default_rng(2)
    recs = [bytes(np.sort(rng.integers(33, 73, 50)).astype(np.uint8))
            for _ in range(30)]
    cases["reverse"] = (recs, [dict()],
                        dict(reverse=[i % 2 == 1 for i in range(30)]))
    rng = np.random.default_rng(3)
    recs, sels, rev = [], [], []
    for i in range(60):
        L = int(rng.integers(20, 120))
        if i % 4 == 0 and recs:
            recs.append(recs[-1])
            sels.append(sels[-1])
        else:
            recs.append(bytes(rng.integers(33, 63, L).astype(np.uint8)))
            sels.append(int(rng.integers(0, 3)))
        rev.append(bool(rng.integers(0, 2)))
    cases["all_shapes"] = (recs, [
        dict(do_dedup=True, do_sel=True, sloc=14,
             qtab=[min(i, 31) for i in range(256)]),
        dict(qbits=4, qshift=2, context=7,
             ptab=[min(i // 32, 15) for i in range(1024)])],
        dict(selectors=sels, stab=[0, 0, 1] + [1] * 253, reverse=rev))
    rng = np.random.default_rng(0)
    t = [0] * 300 + [1] * 700 + [2] * 24
    cases["store_array_runs"] = (
        [bytes(rng.integers(33, 43, 60).astype(np.uint8)) for _ in range(8)],
        [dict(qtab=t[:256], ptab=t[:1024], qbits=5, qshift=2)], {})
    return cases


@pytest.mark.parametrize("case", list(_fqz31_cases()))
def test_fqz_encode31_equal_and_decoded(case):
    recs, params, kw = _fqz31_cases()[case]
    blob = both("fqz_encode31", recs, params, **kw)
    want = b"".join(recs)
    assert decode("sio_fqz_decode", blob, len(want)) == want


def test_fqz_store_array_equal_to_the_frozen_fixtures():
    """The port's store_array writer gives the hand-derived bytes, as the
    JAX package's does, and the port's engine reads them back."""
    import ctypes as C

    lib = _load()
    lib.sio_fqz_read_array_test.restype = C.c_int64
    lib.sio_fqz_read_array_test.argtypes = [
        C.c_char_p, C.c_int64, np.ctypeslib.ndpointer(np.uint8), C.c_int]
    for blob, size, want, why in STORE_ARRAY_FIXTURES:
        table = want().tolist()
        assert bytes(both("fqz_store_array", table)) == blob, why
        out = np.zeros(size, np.uint8)
        assert lib.sio_fqz_read_array_test(blob, len(blob), out, size) \
            == len(blob), why
        assert np.array_equal(out, want()), why
        for cut in range(len(blob)):
            assert lib.sio_fqz_read_array_test(blob[:cut], cut, out, size) \
                == -1, (why, cut)


def test_fqz_full_stream_fixture_on_the_port():
    want = FQZ_STREAM_EXPECTED
    assert decode("sio_fqz_decode", FQZ_STREAM_FIXTURE, len(want)) == want
    lib = _load()
    out = np.zeros(len(want) + 8, np.uint8)
    for cut in (2, 6, 10, 20, len(FQZ_STREAM_FIXTURE) - 6):
        assert lib.sio_fqz_decode(FQZ_STREAM_FIXTURE[:cut], cut, len(want),
                                  out, len(out)) == -1, cut


def _load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gen_fqz_fixture_equals_the_jax_script(capsys):
    """The port's generator builds the JAX script's bytes (the frozen
    fixture), and its check passes on the port's engine."""
    from strling_tpu_torch.scripts import gen_fqz_fixture as port_gen

    ref_gen = _load_script(os.path.join(REPO, "scripts", "gen_fqz_fixture.py"),
                           "ref_gen_fqz_fixture")
    assert port_gen.build() == ref_gen.build() == (FQZ_STREAM_FIXTURE,
                                                   FQZ_STREAM_EXPECTED)
    port_gen.main()
    out = capsys.readouterr().out
    assert "# native decoder agrees" in out
    assert f"FIXTURE = {FQZ_STREAM_FIXTURE!r}" in out


# ------------------------------------------------------------ corrupt input


def _fuzz_cases():
    rng = random.Random(99)
    acgt = bytes(rng.choice(b"ACGT") for _ in range(1500))
    names = b"".join(f"A1:2:{i}:{i*3}".encode() + b"\x00" for i in range(300))
    recs = qual_recs(random.Random(15), 8)
    return {
        "nx16": ("sio_rans_nx16_decode",
                 P.nx16_encode(acgt, order=1, rle=True), len(acgt)),
        "tok3": ("sio_tok3_decode", P.tok3_encode(names), len(names)),
        "arith": ("sio_arith_decode", P.arith_encode(acgt, order=1, rle=True),
                  len(acgt)),
        "fqz": ("sio_fqz_decode", P.fqz_encode(recs), sum(map(len, recs))),
    }


@pytest.mark.parametrize("case", list(_fuzz_cases()))
def test_corrupt_streams_fail_cleanly_on_the_port(case):
    """Truncated and bit-flipped streams return -1 or a count: never a
    crash of the process."""
    fn, blob, usize = _fuzz_cases()[case]
    dec = getattr(_load(), fn)
    rng = random.Random(7)
    out = np.zeros(usize + 1, np.uint8)
    for cut in range(0, len(blob), max(1, len(blob) // 60)):
        dec(blob[:cut], cut, usize, out, len(out))
    for _ in range(100):
        m = bytearray(blob)
        m[rng.randrange(len(m))] ^= 1 << rng.randrange(8)
        dec(bytes(m), len(m), usize, out, len(out))
