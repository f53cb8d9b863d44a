"""Wrapper of the hand-written CUDA repeat-unit scan (csrc/repeat_scan.cu).

The kernel replaces the Pallas TPU kernel of `strling_tpu/ops/kmer_pallas.py`
(see the header of the .cu file). It is compiled with nvcc for sm_90a into a
shared library with a plain C interface, at first use, into `_build/` next to
this file (hash-cached on the source and the flags), and loaded with ctypes.
Nothing is built or loaded at import time.

`repeat_scan` is the one entry: on a CPU tensor it runs the plain PyTorch
form (`ops.kmer.repeat_codes_plain`); on a CUDA tensor it launches the kernel
on the current stream, or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from strling_tpu_torch.ops.kmer import (
    KS,
    payload_geometry,
    repeat_codes_plain,
)

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "repeat_scan.cu")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LAYOUT_IDS = {"ascii": 0, "n8": 1, "w8": 2, "w16": 3}
#: longest row the kernel takes: each thread keeps its L/3 window codes in
#: shared memory, and 32 threads of 2 bytes each must fit in 227 KB
MAX_L = 10_000

#: kernel launches since import (or since a caller last reset it)
launches = 0
_lock = threading.Lock()
_lib = None
#: nvcc's output of the build that produced the loaded library (ptxas -v)
build_log = ""


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA repeat "
                           "scan); install the CUDA toolkit or run on --device cpu")
    return path


def library_path() -> str:
    """Build the kernel library if needed; return its path."""
    global build_log
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    out = os.path.join(BUILD_DIR, f"librepeat_scan-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {SOURCE}:\n{build_log}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(library_path())
            fn = lib.repeat_scan_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            _lib = lib
    return _lib


def _check(t, name: str, dtype, shape, device):
    if t is None:
        raise ValueError(f"{name} is required for ASCII rows")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def repeat_scan(x: torch.Tensor, layout: str, lengths=None, te=None, tp=None):
    """Repeat-unit scan -> (code, len, count) int32 tensors of shape [B].

    x: fused payload rows [B, W] uint8 with `layout` in n8/w8/w16, or ASCII
    rows [B, L] uint8 with layout "ascii" and lengths [B] int32, te/tp
    [B, 5] int32 on the same device.
    """
    global launches
    if x.device.type == "cpu":
        return repeat_codes_plain(x, layout, lengths, te, tp)
    if x.device.type != "cuda":
        raise ValueError(f"repeat_scan runs on cpu or cuda tensors, not {x.device}")
    if layout not in _LAYOUT_IDS:
        raise ValueError(f"unknown layout {layout!r}")
    if x.dim() != 2:
        raise ValueError(f"rows must be 2-D, got shape {tuple(x.shape)}")
    B, width = x.shape
    dev = x.device
    _check(x, "rows", torch.uint8, (B, width), dev)
    if layout == "ascii":
        L = width
        _check(lengths, "lengths", torch.int32, (B,), dev)
        _check(te, "te", torch.int32, (B, len(KS)), dev)
        _check(tp, "tp", torch.int32, (B, len(KS)), dev)
        ptrs = [lengths.data_ptr(), te.data_ptr(), tp.data_ptr()]
    else:
        L, meta_off, meta_w = payload_geometry(width, layout)
        if L <= 0 or L % 8 or meta_off + meta_w != width:
            raise ValueError(f"row width {width} is not a {layout} payload")
        ptrs = [None, None, None]
    if L > MAX_L:
        raise ValueError(f"rows of {L} bases exceed the kernel's {MAX_L}")
    code = torch.empty(B, dtype=torch.int32, device=dev)
    ulen = torch.empty(B, dtype=torch.int32, device=dev)
    cnt = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return code, ulen, cnt
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repeat_scan_launch(
            x.data_ptr(), B, width, _LAYOUT_IDS[layout], L, *ptrs,
            code.data_ptr(), ulen.data_ptr(), cnt.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"repeat_scan launch failed: CUDA error {rc}")
    with _lock:
        launches += 1
    return code, ulen, cnt
