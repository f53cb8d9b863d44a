"""Wrapper of the hand-written CUDA repeat-unit scan (csrc/repeat_scan.cu).

The kernel replaces the Pallas TPU kernel of `strling_tpu/ops/kmer_pallas.py`
in all of its forms (see the header of the .cu file): one warp per read for
both modals and every variant. It is compiled with nvcc for sm_90a into a
shared library with a plain C interface, at first use, into `_build/` next
to this file (hash-cached on the source and the flags), and loaded with
ctypes. Nothing is built or
loaded at import time.

`repeat_scan` is the one entry: on a CPU tensor it runs the plain PyTorch
form (`ops.kmer.repeat_codes_plain`); on a CUDA tensor it launches the kernel
on the current stream, or raises. `repeat_scan_clocked` and `stage_cycles`
run the detector in the kernel's clocked form and read its cycles by stage,
for the stage tool, on the card only; `warps_per_sm` says how many warps of
a form an SM holds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter

import torch

from strling_tpu_torch.ops.kmer import (
    KS,
    VARIANTS,
    check_variant,
    payload_geometry,
    repeat_codes_plain,
    resolve_modal,
)

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "repeat_scan.cu")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LAYOUT_IDS = {"ascii": 0, "n8": 1, "w8": 2, "w16": 3, "packed": 4}
_MODAL_IDS = {"pairwise": 0, "sorted": 1}
_VARIANT_IDS = {v: i for i, v in enumerate(VARIANTS)}
#: the clocked form of the detector (the kernel's STAGES variant)
_STAGES_ID = len(VARIANTS)
#: the stages the clocked form counts cycles in, in the kernel's order:
#: loading the row and its position codes (and the N count), the window
#: codes, the modal (with the count table's reset), the exact recount, and
#: the rest (the selection state machine, the output, the loop)
STAGES = ("load", "windows", "modal", "recount", "select")
#: how the kernel splits the work, by the launcher's report (its Design enum)
DESIGNS = ("warp_per_read",)
#: longest row the kernel takes: each warp keeps 4 bytes a base (the read,
#: its position codes, its window codes) and a count table of up to 8 KB in
#: shared memory (the sorted modal: 3 bytes a base and up to 16 KB of sort
#: keys), and a block's four warps must fit in 227 KB
MAX_L = 10_000

#: kernel launches since import (or since a caller last reset it)
launches = 0
#: the same launches by form: (layout, modal, variant) -> count
launches_by: Counter = Counter()
#: the same launches by form and the design of the kernel the launcher
#: reported it launched: (layout, modal, variant, design) -> count
launches_by_design: Counter = Counter()
#: the same launches by card: CUDA device index -> count
launches_by_device: Counter = Counter()
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
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ]
            cycles = lib.repeat_scan_stage_cycles
            cycles.restype = ctypes.c_int
            cycles.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                               ctypes.c_void_p]
            warps = lib.repeat_scan_warps_per_sm
            warps.restype = ctypes.c_int
            warps.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
            _lib = lib
    return _lib


def _check(t, name: str, dtype, shape, device, layout: str):
    if t is None:
        raise ValueError(f"{name} is required for {layout} rows")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def repeat_scan(x: torch.Tensor, layout: str, lengths=None, te=None, tp=None,
                *, nbits=None, modal: str | None = None,
                variant: str = "full"):
    """Repeat-unit scan -> (code, len, count) int32 tensors of shape [B].

    x: fused payload rows [B, W] uint8 with `layout` in n8/w8/w16; ASCII
    rows [B, L] uint8 with layout "ascii"; or 2-bit rows [B, L/4] uint8 with
    layout "packed" and their N bitmask `nbits` [B, L/8] uint8 (pack_bases'
    pair). ASCII and packed rows take lengths [B] int32 and te/tp [B, 5]
    int32 on the same device. `modal` is "pairwise" or "sorted" (None:
    ops.kmer.MODAL_IMPL, from STRLING_MODAL_IMPL); `variant` one of
    ops.kmer.VARIANTS (the TPU kernel's stage-disabled forms, timed by the
    stage tool).
    """
    modal = resolve_modal(modal)
    check_variant(variant)
    if x.device.type == "cpu":
        return repeat_codes_plain(x, layout, lengths, te, tp, nbits=nbits,
                                  modal=modal, variant=variant)
    if x.device.type != "cuda":
        raise ValueError(f"repeat_scan runs on cpu or cuda tensors, not {x.device}")
    return _launch(x, layout, lengths, te, tp, nbits, modal, variant)


def repeat_scan_clocked(x: torch.Tensor, layout: str, lengths=None,
                        te=None, tp=None, *, nbits=None,
                        modal: str | None = None):
    """The detector with the `modal` form (as for repeat_scan) in the
    kernel's clocked form, on CUDA tensors only: repeat_scan's outputs, and
    each warp adds its clock cycles in each of STAGES to the card's
    counters, which `stage_cycles` reads."""
    modal = resolve_modal(modal)
    if x.device.type != "cuda":
        raise ValueError("the clocked form counts the card's clock cycles: "
                         f"it needs a CUDA tensor, not {x.device}")
    return _launch(x, layout, lengths, te, tp, nbits, modal, "stages")


def warps_per_sm(layout: str, L: int, modal: str = "pairwise",
                 variant: str = "full") -> int:
    """Warps of a form (`variant` "stages": the clocked detector) on rows of
    L bases that an SM of the current card holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor with the form's registers
    and shared memory)."""
    lib = _load()
    warps = ctypes.c_int(0)
    _check_rc(lib.repeat_scan_warps_per_sm(
        _LAYOUT_IDS[layout], L, _MODAL_IDS[resolve_modal(modal)],
        _STAGES_ID if variant == "stages"
        else _VARIANT_IDS[check_variant(variant)],
        ctypes.byref(warps)), f"occupancy ({layout}, {modal}, {variant})")
    return warps.value


def stage_cycles(device) -> dict:
    """{stage: cycles} that the clocked form's warps on `device` spent in
    each of STAGES since the last call (lane 0's clock, summed over warps:
    shares of the warps' time, not of the kernel's wall), after waiting for
    the current stream; the counters are cleared."""
    lib = _load()
    out = (ctypes.c_ulonglong * len(STAGES))()
    device = torch.device(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check_rc(lib.repeat_scan_stage_cycles(out, stream), "stage read")
    return dict(zip(STAGES, (int(v) for v in out)))


def _check_rc(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"repeat_scan {what} failed: CUDA error {rc}")


def _launch(x, layout, lengths, te, tp, nbits, modal: str, variant: str):
    """Launch the kernel's form on CUDA tensors (`variant` "stages": the
    clocked detector) and count the launch."""
    global launches
    if layout not in _LAYOUT_IDS:
        raise ValueError(f"unknown layout {layout!r}")
    if x.dim() != 2:
        raise ValueError(f"rows must be 2-D, got shape {tuple(x.shape)}")
    B, width = x.shape
    dev = x.device
    _check(x, "rows", torch.uint8, (B, width), dev, layout)
    if layout in ("ascii", "packed"):
        L = width if layout == "ascii" else 4 * width
        for name, t, shape in (("lengths", lengths, (B,)),
                               ("te", te, (B, len(KS))),
                               ("tp", tp, (B, len(KS)))):
            _check(t, name, torch.int32, shape, dev, layout)
        ptrs = [lengths.data_ptr(), te.data_ptr(), tp.data_ptr()]
        if layout == "packed":
            if L % 8:
                raise ValueError(f"packed rows of {L} bases: L must be a "
                                 "multiple of 8")
            _check(nbits, "nbits", torch.uint8, (B, L // 8), dev, layout)
    else:
        L, meta_off, meta_w = payload_geometry(width, layout)
        if L <= 0 or L % 8 or meta_off + meta_w != width:
            raise ValueError(f"row width {width} is not a {layout} payload")
        ptrs = [None, None, None]
    if layout != "packed" and nbits is not None:
        raise ValueError(f"nbits applies to packed rows, not {layout}")
    if L > MAX_L:
        raise ValueError(f"rows of {L} bases exceed the kernel's {MAX_L}")
    code = torch.empty(B, dtype=torch.int32, device=dev)
    ulen = torch.empty(B, dtype=torch.int32, device=dev)
    cnt = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return code, ulen, cnt
    lib = _load()
    design = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repeat_scan_launch(
            x.data_ptr(), B, width, _LAYOUT_IDS[layout], L,
            nbits.data_ptr() if layout == "packed" else None, *ptrs,
            _MODAL_IDS[modal], _STAGES_ID if variant == "stages"
            else _VARIANT_IDS[variant],
            code.data_ptr(), ulen.data_ptr(), cnt.data_ptr(), stream,
            ctypes.byref(design))
    _check_rc(rc, f"launch ({layout}, {modal}, {variant}, L={L})")
    with _lock:
        launches += 1
        launches_by[(layout, modal, variant)] += 1
        launches_by_design[(layout, modal, variant,
                            DESIGNS[design.value])] += 1
        launches_by_device[dev.index] += 1
    return code, ulen, cnt
