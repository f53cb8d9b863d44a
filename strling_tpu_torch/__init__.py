"""strling_tpu_torch — the STR-expansion engine on PyTorch and CUDA.

A port of `strling_tpu` (the JAX/TPU package, which stays the reference)
for NVIDIA Hopper GPUs. The per-read repeat-unit scan, the only stage of
`index -> extract -> call` that runs on the accelerator, is a hand-written
CUDA kernel (ops/csrc/repeat_scan.cu) with a plain PyTorch twin for the CPU
(ops/kmer.py). The host engine (C++ BAM ingest, pairing, bin writing) and the
call/merge/outliers stages are the reference's own JAX-free code.

This package never imports JAX.
"""

from strling_tpu.version import BIN_FMT_VERSION, STRLING_VERSION, __version__

__all__ = ["__version__", "STRLING_VERSION", "BIN_FMT_VERSION"]
