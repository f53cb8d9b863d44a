"""SAM text utilities: header target parsing and record parsing.

Record parsing stands in for hts-nim's Header.from_string / Record.from_string
used throughout the reference tests (e.g. tests/test_strling.nim:46-89,
tests/test_collect.nim:8-74) — SAM lines become the same light record objects
the pipelines use.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from strling_tpu_torch.io.bam import Target
from strling_tpu_torch.io.bamwrite import parse_cigar, ref_span


def parse_header_targets(text: str) -> list[Target]:
    targets = []
    tid = 0
    for line in text.splitlines():
        if not line.startswith("@SQ"):
            continue
        name = None
        length = 0
        for f in line.split("\t")[1:]:
            if f.startswith("SN:"):
                name = f[3:]
            elif f.startswith("LN:"):
                length = int(f[3:])
        if name is not None:
            targets.append(Target(tid=tid, name=name, length=length))
            tid += 1
    return targets


@dataclass
class Record:
    """A light alignment record (protocol shared by SAM parsing and the
    per-row views over native ReadBatch arrays)."""

    qname: str = ""
    flag: int = 0
    tid: int = -1
    pos: int = -1          # 0-based
    mapq: int = 0
    cigar: list = field(default_factory=list)  # [(length, op_index)]
    mate_tid: int = -1
    mate_pos: int = -1
    isize: int = 0
    seq: str = ""

    @property
    def start(self) -> int:
        return self.pos

    @property
    def stop(self) -> int:
        """htslib bam_endpos semantics."""
        if (self.flag & 4) or not self.cigar:
            return self.pos + 1
        span = ref_span(self.cigar)
        return self.pos + (span if span > 0 else 1)

    # flag helpers (hts-nim Flag)
    @property
    def paired(self):
        return bool(self.flag & 0x1)

    @property
    def proper_pair(self):
        return bool(self.flag & 0x2)

    @property
    def unmapped(self):
        return bool(self.flag & 0x4)

    @property
    def mate_unmapped(self):
        return bool(self.flag & 0x8)

    @property
    def reverse(self):
        return bool(self.flag & 0x10)

    @property
    def mate_reverse(self):
        return bool(self.flag & 0x20)

    @property
    def read1(self):
        return bool(self.flag & 0x40)

    @property
    def secondary(self):
        return bool(self.flag & 0x100)

    @property
    def dup(self):
        return bool(self.flag & 0x400)

    @property
    def supplementary(self):
        return bool(self.flag & 0x800)


def record_from_string(line: str, targets: list[Target]) -> Record:
    """Parse one SAM alignment line (tabs required, like hts-nim)."""
    f = line.rstrip("\n").split("\t")
    name_to_tid = {t.name: t.tid for t in targets}

    def tid_of(chrom, self_tid=None):
        if chrom == "*":
            return -1
        if chrom == "=":
            return self_tid
        return name_to_tid[chrom]

    tid = tid_of(f[2])
    return Record(
        qname=f[0],
        flag=int(f[1]),
        tid=tid,
        pos=int(f[3]) - 1,
        mapq=int(f[4]),
        cigar=parse_cigar(f[5]),
        mate_tid=tid_of(f[6], tid),
        mate_pos=int(f[7]) - 1,
        isize=int(f[8]),
        seq="" if f[9] == "*" else f[9],
    )
