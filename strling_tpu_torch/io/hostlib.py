"""The native host engine library, on hosts that lack some of its deps.

The engine is the JAX package's C++ (`strling_tpu/io/csrc`, reused
unedited). Where the compiler finds libdeflate's and liblzma's headers, the
library is the JAX package's own build (`strling_tpu.io.build.lib_path()`,
linked against libdeflate, zlib, liblzma and libbz2). GPU hosts may have
zlib but neither libdeflate nor liblzma's header. There the same unedited
sources are built against the compat layer in `compat/` (libdeflate's
decompression API implemented on zlib; liblzma's one entry point declared
from its public ABI and linked by soname) into this package's own `_build/`,
under a name that records the sources' hash and what was linked. A host
that later gains the headers goes back to the system build.

`load()` makes the library the one this process uses: the reused JAX-package
loaders (`strling_tpu.io.bam._load`, behind `Bam`, the extract engine and the
genome scan, and `strling_tpu.io.binfmt._native_lib`, behind the bin writer)
are opened on it before their first use. Every port entry point that needs
the engine calls it.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

from strling_tpu.io import build

COMPAT = os.path.join(os.path.dirname(__file__), "compat")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
SRC_DIR = os.path.join(os.path.dirname(build.__file__), "csrc")
_LIB_DIRS = ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu", "/lib64",
             "/usr/lib64", "/usr/lib")

_loaded: str | None = None


def _has_header(name: str) -> bool:
    probe = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                           input=f"#include <{name}>\n", text=True,
                           capture_output=True)
    return probe.returncode == 0


def _shared_lib(soname: str) -> str:
    for d in _LIB_DIRS:
        path = os.path.join(d, soname)
        if os.path.exists(path):
            return path
    raise RuntimeError(f"{soname} not found in {_LIB_DIRS}: the host engine "
                       "needs it")


def missing_headers() -> list[str]:
    """The engine's library headers this host's compiler cannot find."""
    return [h for h in ("libdeflate.h", "lzma.h") if not _has_header(h)]


def compat_lib_path(missing: list[str]) -> str:
    """The engine built with the compat layer standing in for the libraries
    whose headers are `missing`, building it if needed."""
    shim_deflate = "libdeflate.h" in missing
    shim_lzma = "lzma.h" in missing
    srcs = sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cc", ".h")))
    compat = sorted(os.path.join(root, f)
                    for root, _, files in os.walk(COMPAT) for f in files)
    h = hashlib.sha256()
    for path in srcs + compat:
        with open(path, "rb") as fh:
            h.update(fh.read())
    link = "-".join(["deflate_on_zlib" if shim_deflate else "libdeflate",
                     "lzma_by_soname" if shim_lzma else "liblzma"])
    out = os.path.join(BUILD_DIR,
                       f"libstrling_io-{h.hexdigest()[:16]}-{link}.so")
    if os.path.exists(out):
        return out
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", *(s for s in srcs if s.endswith(".cc"))]
    libs = ["-lz"]
    if shim_deflate:
        cmd += [os.path.join(COMPAT, "libdeflate_zlib.cc"),
                "-I", os.path.join(COMPAT, "libdeflate")]
    else:
        libs.append("-ldeflate")
    if shim_lzma:
        cmd += ["-I", os.path.join(COMPAT, "lzma")]
        libs.append(_shared_lib("liblzma.so.5"))
    else:
        libs.append("-llzma")
    libs.append(_shared_lib("libbz2.so.1.0"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run([*cmd, "-o", tmp, *libs], check=True)
    os.replace(tmp, out)
    return out


def lib_path() -> str:
    """Path of the host engine library for this host, building it if
    needed: the JAX package's build where the headers are all present, the
    compat build otherwise."""
    missing = missing_headers()
    return compat_lib_path(missing) if missing else build.lib_path()


def load() -> str:
    """Open the engine library for this process (once) and return its
    path. The reused loaders are pointed at it only while they open it, so
    the JAX package's build functions are left as they were. A loader that
    had already opened a library keeps it; the path returned is the one
    `Bam` uses."""
    global _loaded
    if _loaded is None:
        path = lib_path()
        from strling_tpu.io import bam, binfmt

        saved = bam.lib_path, build.lib_path
        bam.lib_path = build.lib_path = lambda: path
        try:
            bam._load()
            binfmt._native_lib()
        finally:
            bam.lib_path, build.lib_path = saved
        _loaded = bam._lib._name
    return _loaded
