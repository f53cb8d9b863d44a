"""Host I/O of the port: BAM/CRAM reading, BAM and FASTA writing and the
bin format, on the engine library that `hostlib` builds for this host."""

from strling_tpu_torch.io.bam import Bam
from strling_tpu_torch.io.bamwrite import BamRecord, write_bam
from strling_tpu_torch.io.binfmt import write_bin
from strling_tpu_torch.io.fasta import build_fai, write_fasta

__all__ = ["Bam", "BamRecord", "build_fai", "write_bam", "write_bin",
           "write_fasta"]
