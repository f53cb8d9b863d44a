"""The `tread` evidence-read model.

Mirrors reference src/strpkg/cluster.nim:12-36: a compact record per
STR-evidence read. The production pipelines carry treads as numpy
structure-of-arrays (TreadBatch) for vectorized clustering; the scalar Tread
dataclass exists for tests and for the bin (de)serializer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np


class Soft(IntEnum):
    """cluster.nim:14-20."""

    left = 0  # left-clipped portion of the read is repetitive
    right = 1  # right-clipped portion is repetitive
    both = 2
    none = 3
    none_right = 4  # main part of read, soft-clipped on the right
    none_left = 5  # main part of read, soft-clipped on the left


# BAM flag bits used across the pipeline
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class Tread:
    """cluster.nim:23-32."""

    tid: int = 0
    position: int = 0
    repeat: str = ""  # <= 6 chars; "" == the reference's all-NUL array
    flag: int = 0
    split: Soft = Soft.none
    mapping_quality: int = 0
    repeat_count: int = 0
    align_length: int = 0
    qname: str = ""

    @property
    def repeat_length(self) -> int:
        return len(self.repeat)

    @property
    def p_repeat(self) -> float:
        """Proportion of the read that is repeat (extract.nim:56-58).

        Note the reference multiplies two uint8s — repeat_count *
        repeat_length wraps mod 256! Reproduced deliberately.
        """
        return ((self.repeat_count * self.repeat_length) % 256) / max(
            1, self.align_length
        )

    def tostring(self, targets) -> str:
        """extract.nim:43-49 (debug output)."""
        chrom = "unknown" if self.tid == -1 else targets[self.tid].name
        return (
            f"{chrom}\t{self.position}\t{self.repeat}\t{self.split.name}\t"
            f"{self.repeat_count}\t{self.qname}"
        )


TREAD_DTYPE = np.dtype(
    [
        ("tid", np.int32),
        ("position", np.uint32),
        ("repeat", "S6"),
        ("flag", np.uint16),
        ("split", np.uint8),
        ("mapping_quality", np.uint8),
        ("repeat_count", np.uint8),
        ("align_length", np.uint8),
        ("sample", np.int32),  # merge's per-sample tag (qname in the reference)
    ]
)


@dataclass
class TreadBatch:
    """Structure-of-arrays tread storage with qnames kept out-of-row."""

    data: np.ndarray  # TREAD_DTYPE records
    qnames: list[str] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i: int) -> Tread:
        r = self.data[i]
        return Tread(
            tid=int(r["tid"]),
            position=int(r["position"]),
            repeat=r["repeat"].decode(),
            flag=int(r["flag"]),
            split=Soft(int(r["split"])),
            mapping_quality=int(r["mapping_quality"]),
            repeat_count=int(r["repeat_count"]),
            align_length=int(r["align_length"]),
            qname=self.qnames[i] if self.qnames else "",
        )

    @classmethod
    def from_treads(cls, treads: list[Tread]) -> "TreadBatch":
        data = np.zeros(len(treads), TREAD_DTYPE)
        qnames = []
        for i, t in enumerate(treads):
            data[i]["tid"] = t.tid
            data[i]["position"] = t.position
            data[i]["repeat"] = t.repeat.encode()
            data[i]["flag"] = t.flag
            data[i]["split"] = int(t.split)
            data[i]["mapping_quality"] = t.mapping_quality
            data[i]["repeat_count"] = t.repeat_count
            data[i]["align_length"] = t.align_length
            qnames.append(t.qname)
        return cls(data=data, qnames=qnames)

    def to_treads(self) -> list[Tread]:
        return [self[i] for i in range(len(self))]
