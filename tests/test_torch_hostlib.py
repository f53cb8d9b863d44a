"""The host-engine build of strling_tpu_torch: which library a host gets,
the port opening it without the CLI, and the zlib-backed libdeflate shim
held to libdeflate."""

import ctypes as C
import ctypes.util
import os
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest

from strling_tpu.io import build
from strling_tpu_torch.io import hostlib

SHIM = os.path.join(hostlib.COMPAT, "libdeflate_zlib.cc")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = ["libdeflate.h", "lzma.h"]


def test_lib_path_follows_headers(monkeypatch):
    """All headers present: the JAX package's own build. Some missing: the
    compat build, in the port's folder, named by what it linked."""
    monkeypatch.setattr(hostlib, "missing_headers", lambda: [])
    assert hostlib.lib_path() == build.lib_path()
    monkeypatch.setattr(hostlib, "missing_headers", lambda: BOTH)
    path = hostlib.lib_path()
    name = os.path.basename(path)
    assert os.path.dirname(path) == hostlib.BUILD_DIR
    assert name.endswith("-deflate_on_zlib-lzma_by_soname.so")
    assert not os.path.exists(os.path.join(os.path.dirname(build.lib_path()),
                                           name))


@pytest.mark.parametrize("compat", [False, True])
def test_extract_native_fresh_process(compat, tmp_path):
    """A library user's extract in a new process, with no CLI: the port
    opens the engine itself. With the compat build (as on a host without
    libdeflate's and liblzma's headers) the engine, the genome scan and the
    bin writer all run on it, and the bin is the JAX package's."""
    from strling_tpu.core.extract import extract_native as ref_extract_native
    from strling_tpu.io.bam import Bam as RefBam
    from strling_tpu.io.binfmt import write_bin
    from test_extract import _str_bam

    bam = str(tmp_path / "s.bam")
    _str_bam(bam)
    fa = str(tmp_path / "ref.fa")
    with open(fa, "w") as fh:
        fh.write(">chr1\n" + "ACGTTGCA" * 6000 + "CAG" * 40 + "\n")
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        import torch
        torch.set_num_threads(1)
        from strling_tpu_torch.io import hostlib
        if {compat}:
            hostlib.missing_headers = lambda: {BOTH!r}
        from strling_tpu.io import bam as engine
        from strling_tpu.io.binfmt import write_bin
        from strling_tpu_torch.core.extract import extract_native
        from strling_tpu_torch.core.genome_index import genome_repeats
        from strling_tpu_torch.io import Bam
        from strling_tpu.utils.options import Options
        cpu = torch.device("cpu")
        genome_repeats({fa!r}, Options(), {str(tmp_path / "ref.str")!r}, cpu)
        bam = Bam({bam!r})
        tb, frag, _ = extract_native(bam, None, None, devices=[cpu])
        write_bin({str(tmp_path / "port.bin")!r}, tb, frag, bam.header_text,
                  0.8, 40)
        print("engine", engine._lib._name)
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    engine = out.stdout.split("engine ")[-1].strip()
    if compat:
        assert os.path.dirname(engine) == hostlib.BUILD_DIR
        assert "deflate_on_zlib-lzma_by_soname" in engine
    else:
        assert engine == hostlib.lib_path()
    assert "\tAGC" in (tmp_path / "ref.str").read_text()
    rtb, rfrag, _ = ref_extract_native(RefBam(bam), None, None)
    write_bin(str(tmp_path / "ref.bin"), rtb, rfrag, RefBam(bam).header_text,
              0.8, 40)
    assert ((tmp_path / "port.bin").read_bytes()
            == (tmp_path / "ref.bin").read_bytes())


def _bind(lib):
    lib.libdeflate_alloc_decompressor.restype = C.c_void_p
    lib.libdeflate_free_decompressor.argtypes = [C.c_void_p]
    for name in ("libdeflate_deflate_decompress", "libdeflate_gzip_decompress"):
        fn = getattr(lib, name)
        fn.restype = C.c_int
        fn.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t, C.c_void_p,
                       C.c_size_t, C.POINTER(C.c_size_t)]
    fn = lib.libdeflate_gzip_decompress_ex
    fn.restype = C.c_int
    fn.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t, C.c_void_p, C.c_size_t,
                   C.POINTER(C.c_size_t), C.POINTER(C.c_size_t)]
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """(shim, real libdeflate) — the shim built from the compat source."""
    out = str(tmp_path_factory.mktemp("shim") / "libshim.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", SHIM,
                    "-I", os.path.join(hostlib.COMPAT, "libdeflate"),
                    "-o", out, "-lz"], check=True)
    real = ctypes.util.find_library("deflate")
    if real is None:
        pytest.skip("libdeflate is not installed to compare against")
    return _bind(C.CDLL(out)), _bind(C.CDLL(real))


def _run(lib, fn, data, avail, ex=False, want_actual=True):
    d = lib.libdeflate_alloc_decompressor()
    try:
        out = C.create_string_buffer(max(avail, 1))
        a_out = C.c_size_t(0)
        a_in = C.c_size_t(0)
        if ex:
            r = lib.libdeflate_gzip_decompress_ex(
                d, data, len(data), out, avail, C.byref(a_in), C.byref(a_out))
        else:
            r = getattr(lib, fn)(d, data, len(data), out, avail,
                                 C.byref(a_out) if want_actual else None)
        return r, out.raw[: a_out.value], a_in.value
    finally:
        lib.libdeflate_free_decompressor(d)


def _raw(data, level):
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    return c.compress(data) + c.flush()


def _gzip(data, level):
    c = zlib.compressobj(level, zlib.DEFLATED, 16 + 15)
    return c.compress(data) + c.flush()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shim_matches_libdeflate(libs, seed):
    rng = np.random.default_rng(seed)
    payloads = [b"", bytes(rng.integers(0, 4, 70000, dtype=np.uint8) + 65),
                bytes(rng.integers(0, 256, 5000, dtype=np.uint8)),
                b"CAG" * 20000]
    for data in payloads:
        for level in (1, 6, 9):
            for fn, enc in (("libdeflate_deflate_decompress", _raw),
                            ("libdeflate_gzip_decompress", _gzip)):
                comp = enc(data, level)
                cases = [(len(data), True), (len(data) + 100, True),
                         (len(data), False), (len(data) + 100, False)]
                if data:
                    cases.append((len(data) - 1, True))  # insufficient space
                for avail, want in cases:
                    shim, real = (_run(lib, fn, comp, avail, want_actual=want)
                                  for lib in libs)
                    assert shim[:2] == real[:2], (fn, level, avail, want)
                # damaged streams: both refuse (the exact error code of a
                # damaged stream is not part of the contract the engine uses)
                corrupt = bytearray(comp)
                corrupt[len(corrupt) // 2] ^= 0xFF
                for blob in (bytes(corrupt), comp[: len(comp) // 2]):
                    shim, real = (_run(lib, fn, blob, len(data) + 100)
                                  for lib in libs)
                    assert (shim[0] == 0) == (real[0] == 0), (fn, level)


def test_shim_gzip_ex_walks_members(libs):
    members = [_gzip(b"ACGT" * n, 6) for n in (10, 5000, 1)]
    blob = b"".join(members)
    for lib in libs:
        off, got = 0, b""
        while off < len(blob):
            r, out, used = _run(lib, None, blob[off:], 1 << 16, ex=True)
            assert r == 0
            got += out
            off += used
        assert got == b"ACGT" * 5011
    assert _run(libs[0], None, blob, 8, ex=True)[0] == 3  # insufficient space
