"""BAM/CRAM reader of the port: the JAX package's `Bam`, opened on the
engine library that `hostlib.load()` chose for this host."""

from __future__ import annotations

from strling_tpu.io import bam as _ref
from strling_tpu_torch.io import hostlib


class Bam(_ref.Bam):
    def __init__(self, *args, **kwargs):
        hostlib.load()
        super().__init__(*args, **kwargs)
