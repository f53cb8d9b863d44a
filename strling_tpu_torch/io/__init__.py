"""Host I/O of the port. The readers and writers are the JAX package's
JAX-free host code, reused unchanged; `Bam` opens files on the engine
library `hostlib` builds for this host."""

from strling_tpu.io.bamwrite import BamRecord, write_bam
from strling_tpu.io.fasta import build_fai, write_fasta
from strling_tpu_torch.io.bam import Bam

__all__ = ["Bam", "BamRecord", "build_fai", "write_bam", "write_fasta"]
