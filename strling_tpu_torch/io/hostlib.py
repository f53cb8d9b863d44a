"""Build of the native host engine library (`libstrling_io`).

The engine is the C++ under `csrc/` next to this file (BAM/CRAM decode,
pairing, prefilter, fused payload, bin codec, genome scan, collect helpers),
built as one shared library from all its `.cc` files. Where the compiler
finds libdeflate's and liblzma's headers it links the system libraries. GPU
hosts may have zlib but neither libdeflate nor liblzma's header: there the
same sources are built against the compat layer in `compat/` (libdeflate's
decompression API implemented on zlib; liblzma's one entry point declared
from its public ABI and linked by soname). The library goes to `_build/`,
under a name that records the sources' hash and what was linked, so a host
that later gains the headers builds the system variant beside it.

`io.bam._load()` and `io.binfmt._native_lib()` open `lib_path()`.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

HERE = os.path.dirname(__file__)
SRC_DIR = os.path.join(HERE, "csrc")
COMPAT = os.path.join(HERE, "compat")
BUILD_DIR = os.path.join(HERE, "_build")
_LIB_DIRS = ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu", "/lib64",
             "/usr/lib64", "/usr/lib")


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


def lib_path() -> str:
    """Path of the host engine library for this host, building it if
    needed: linked against the system libdeflate and liblzma where their
    headers are present, against the compat layer for those missing."""
    missing = missing_headers()
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
    # one build per library: processes that ask at once wait for the first
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            subprocess.run([*cmd, "-o", tmp, *libs], check=True)
            os.replace(tmp, out)
    return out
