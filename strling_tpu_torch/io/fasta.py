"""FASTA access with .fai indexing (stands in for htslib's faidx).

Covers the reference's Fai usage: whole-chromosome fetch for the genome STR
index (genome_strs.nim:66-73), range fetch for simulation
(simulate_reads.nim:31), and target listing for merge (merge.nim:27-34).
"""

from __future__ import annotations

import os


class Fasta:
    def __init__(self, path: str):
        self.path = path
        fai = path + ".fai"
        if not os.path.exists(fai):
            build_fai(path, fai)
        self.index: dict[str, tuple[int, int, int, int]] = {}
        self.names: list[str] = []
        with open(fai) as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 5:
                    continue
                name = parts[0]
                self.index[name] = (
                    int(parts[1]), int(parts[2]), int(parts[3]), int(parts[4])
                )
                self.names.append(name)
        self.fh = open(path, "rb")

    def __len__(self) -> int:
        return len(self.names)

    def chrom_len(self, name: str) -> int:
        return self.index[name][0]

    def get(self, name: str, start: int | None = None, stop: int | None = None) -> str:
        """0-based inclusive start, inclusive stop (hts-nim fai.get semantics).

        With no bounds, the whole chromosome. Out-of-range stop is clamped.
        """
        length, offset, linebases, linewidth = self.index[name]
        if start is None:
            start = 0
        if stop is None:
            stop = length - 1
        stop = min(stop, length - 1)
        if start > stop:
            return ""
        # file position of base `start`
        fpos = offset + (start // linebases) * linewidth + start % linebases
        self.fh.seek(fpos)
        need = stop - start + 1
        # read enough bytes to cover newlines
        approx = need + need // max(1, linebases) * (linewidth - linebases) + linewidth
        raw = self.fh.read(approx)
        out = raw.replace(b"\n", b"").replace(b"\r", b"")[:need]
        return out.decode()


def build_fai(path: str, fai_path: str):
    entries = []
    with open(path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        pos = 0
        for line in fh:
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, linebases, linewidth))
                name = line[1:].split()[0].decode()
                pos += len(line)
                offset = pos
                length = 0
                linebases = 0
                linewidth = 0
            else:
                bases = len(line.rstrip(b"\r\n"))
                if linebases == 0:
                    linebases = bases
                    linewidth = len(line)
                length += bases
                pos += len(line)
        if name is not None:
            entries.append((name, length, offset, linebases, linewidth))
    with open(fai_path, "w") as out:
        for name, length, offset, linebases, linewidth in entries:
            out.write(f"{name}\t{length}\t{offset}\t{linebases}\t{linewidth}\n")


def write_fasta(path: str, chroms: dict[str, str], width: int = 60):
    with open(path, "w") as fh:
        for name, seq in chroms.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")
