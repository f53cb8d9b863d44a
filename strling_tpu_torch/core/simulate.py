"""Read simulator for STR expansions (src/strpkg/simulate_reads.nim).

The reference writes FASTQ and shells out to `bwa mem | samtools sort`
(simulate_reads.nim:178-179). This environment has neither, so the simulator
emits a coordinate-sorted BAM directly: read positions/CIGARs are computed by
projecting haplotype coordinates back to the reference around the simulated
insertion/deletion, emulating how an aligner represents them:

- reads fully outside the event: full-length M, mapq 60
- reads straddling an insertion boundary with >= MIN_ANCHOR mapped bases:
  soft-clipped (nMmS / mSnM), mapq 60
- reads mostly/entirely inside a large insertion: mapped at the locus with
  full-length M and mapq 0 (a mismapped pure-STR read, as bwa produces)
- reads straddling a deletion: nM<R>DmM

Mismapping realism (`decoys` + `mismap_rate`): bwa does not leave pure-STR
reads at the event — it multi-maps them to OTHER same-unit repeat sites in
the genome at mapq 0 (the hard case STRling's mate-rescue exists for,
README.md:9; the reference gets these from real bwa, simulate_reads.nim:
178-179). With decoys provided, each mismapped read is placed at a random
same-unit decoy site (possibly another chromosome) with full-length M and
mapq 0; its anchored mate's mate-position then points at the decoy — the
wrong-mate placement adjust_by must see through (extract.nim:141-179).
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass

import numpy as np

from strling_tpu_torch.io.bamwrite import BamRecord, write_bam
from strling_tpu_torch.io.fasta import Fasta
from strling_tpu_torch.ops.encode import reverse_complement

MIN_ANCHOR = 20


@dataclass
class Allele:
    chrom: str
    position: int
    counts: tuple[int, int]
    repeat_unit: str


def parse_allele(s: str) -> Allele:
    """simulate_reads.nim:16-26: '{chrom}:{pos}:{unit}_{c1}/{c2}'."""
    toks = s.split(":")
    assert len(toks) == 3, f"error incorrect allele format:{s}"
    chrom, pos, rest = toks
    unit, counts = rest.split("_")
    c1, c2 = counts.split("/")
    return Allele(chrom, int(pos), (int(c1), int(c2)), unit)


def read_hist(path: str) -> np.ndarray:
    out = np.zeros(4096, np.uint32)
    with open(path) as fh:
        for i, line in enumerate(fh):
            if i >= 4096:
                break
            out[i] = int(line.strip())
    return out


def write_hist(h: np.ndarray, path: str):
    with open(path, "w") as fh:
        for v in h:
            fh.write(f"{int(v)}\n")


def normal_hist(mean: float, sd: float, n: int = 1_000_000) -> np.ndarray:
    x = np.arange(4096)
    p = np.exp(-0.5 * ((x - mean) / sd) ** 2)
    return (p / p.sum() * n).astype(np.uint32)


def _align_back(s: int, e: int, off: int, delta: int, rl: int):
    """Project haplotype read [s, e) to reference coords around an event at
    reference offset `off` with length change `delta` (ins > 0, del < 0).

    Returns (ref_pos, cigar, mapq) in *local* reference coordinates, or None
    for a read inside the insertion (caller emulates a mismapped read).
    """
    if delta > 0:
        ins_lo, ins_hi = off, off + delta
        if e <= ins_lo:
            return s, f"{rl}M", 60
        if s >= ins_hi:
            return s - delta, f"{rl}M", 60
        if s < ins_lo:
            left = ins_lo - s
            if e <= ins_hi:
                # right part inside insertion
                if left >= MIN_ANCHOR:
                    return s, f"{left}M{rl - left}S", 60
                return None
            # spans the whole insertion: aligner represents as insertion op
            mid = delta
            right = e - ins_hi
            if left >= MIN_ANCHOR and right >= MIN_ANCHOR:
                return s, f"{left}M{mid}I{right}M", 60
            if left >= MIN_ANCHOR:
                return s, f"{left}M{rl - left}S", 60
            if right >= MIN_ANCHOR:
                return off, f"{rl - right}S{right}M", 60
            return None
        # s inside insertion
        right = e - ins_hi
        if right >= MIN_ANCHOR:
            return off, f"{rl - right}S{right}M", 60
        return None
    else:
        dlen = -delta
        if e <= off:
            return s, f"{rl}M", 60
        if s >= off:
            return s + dlen, f"{rl}M", 60
        left = off - s
        right = e - off
        return s, f"{left}M{dlen}D{right}M", 60


def simulate_allele(fai: Fasta, allele: Allele, frag_hist: np.ndarray,
                    flank: int, depth: int, read_length: int, rng,
                    records: list[BamRecord], tid: int, ref_start: int,
                    decoy_sites: list[tuple[int, int]] | None = None,
                    mismap_rate: float = 0.0):
    """simulate_reads.nim:30-99, emitting aligned records instead of FASTQ."""
    win_start = max(0, allele.position - flank)
    reference = fai.get(
        allele.chrom, win_start, allele.position + flank + 4096 - 1,
    ).upper()
    # index of the locus inside the fetched window — equals `flank` except
    # near the chromosome start, where the window is clipped at 0 (searching
    # from flank-1 there would scan an unrelated region and can latch onto a
    # spurious unit match outside the read-sampling range)
    anchor = allele.position - win_start
    off = reference.find(
        allele.repeat_unit, max(0, anchor - 1),
        anchor + 1 + 2 * (1 + len(allele.repeat_unit)) + len(allele.repeat_unit),
    )
    if off == -1:
        rc = reverse_complement(allele.repeat_unit)
        off = reference.find(rc, max(0, anchor - 1),
                             anchor + 1 + 2 * (1 + len(rc)) + len(rc))
        if off == -1:
            print(
                f"warning: couldn't find {allele.repeat_unit} around "
                f"{allele.chrom}:{allele.position}",
                file=sys.stderr,
            )
            off = anchor
        else:
            allele.repeat_unit = rc

    haplotypes = []
    deltas = []
    for c in allele.counts:
        if c == 0:
            haplotypes.append(reference)
            deltas.append(0)
        elif c > 0:
            rep = allele.repeat_unit * c
            haplotypes.append(reference[:off] + rep + reference[off:])
            deltas.append(len(rep))
        else:
            rep = allele.repeat_unit * (-c)
            if reference.find(rep, off) != off:
                print(
                    f"couldn't find {c} units of {allele.repeat_unit} around "
                    f"{allele.chrom}:{allele.position} to remove",
                    file=sys.stderr,
                )
                haplotypes.append(reference)
                deltas.append(0)
            else:
                haplotypes.append(reference[:off] + reference[off + len(rep):])
                deltas.append(-len(rep))

    L = max(len(h) for h in haplotypes) - 2 * 4096
    n_total = int(depth * L / read_length)
    n_frag = n_total // 2

    sizes = np.arange(4096)
    probs = frag_hist.astype(np.float64)
    probs = probs / probs.sum()
    frag_lens = rng.choice(sizes, size=max(1, n_frag), p=probs)
    r1_starts = rng.integers(0, max(1, L), size=max(1, n_frag))

    for i in range(n_frag):
        frag_len = int(frag_lens[i])
        r1s = int(r1_starts[i])
        r2s = r1s + frag_len - read_length
        if r2s < 0:
            continue
        ihap = int(rng.integers(0, 2))
        hap = haplotypes[ihap]
        delta = deltas[ihap]
        if r2s + read_length > len(hap):
            continue
        # BAM SEQ is stored in reference (aligned) orientation for both mates;
        # the FASTQ writer reverse-complements read2 back to read orientation
        r1 = hap[r1s : r1s + read_length]
        r2 = hap[r2s : r2s + read_length]
        qname = f"{r1s + allele.position}_{r2s + allele.position}_{i}_{ihap}"

        a1 = _align_back(r1s, r1s + read_length, off, delta, read_length)
        a2 = _align_back(r2s, r2s + read_length, off, delta, read_length)
        # mismapped pure-STR reads: bwa multi-maps them to some same-unit
        # repeat site at mapq 0 — a random decoy when provided, else the
        # event itself
        mis1 = a1 is None
        mis2 = a2 is None

        def place_mismapped():
            if decoy_sites and float(rng.random()) < mismap_rate:
                dtid, dpos = decoy_sites[int(rng.integers(len(decoy_sites)))]
                return dtid, dpos, f"{read_length}M", 0
            return tid, off + ref_start, f"{read_length}M", 0

        if mis1:
            t1, p1, c1, q1 = place_mismapped()
        else:
            p1, c1, q1 = a1
            p1 += ref_start
            t1 = tid
        if mis2:
            t2, p2, c2, q2 = place_mismapped()
        else:
            p2, c2, q2 = a2
            p2 += ref_start
            t2 = tid
        proper = 0x2 if (not mis1 and not mis2) else 0
        isize = ((p2 + read_length) - p1) if t1 == t2 else 0
        f1 = 0x1 | proper | 0x20 | 0x40  # paired, mate-reverse, read1
        f2 = 0x1 | proper | 0x10 | 0x80  # paired, reverse, read2
        records.append(BamRecord(qname, f1, t1, p1, q1, c1, t2, p2, isize, r1))
        records.append(BamRecord(qname, f2, t2, p2, q2, c2, t1, p1, -isize, r2))


def simulate_str_bam(fasta: str, alleles: list[Allele], out_bam: str,
                     frag_hist: np.ndarray, depth: int = 30, flank: int = 20000,
                     read_length: int = 150, seed: int = 42,
                     fastq_prefix: str | None = None,
                     decoys: dict[str, list[tuple[str, int]]] | None = None,
                     mismap_rate: float = 0.0):
    """decoys: repeat unit -> [(chrom, pos)] same-unit genomic STR sites
    (e.g. from the genome index) where mismapped pure-STR reads land with
    probability mismap_rate."""
    fai = Fasta(fasta)
    rng = np.random.default_rng(seed)
    targets = [(name, fai.chrom_len(name)) for name in fai.names]
    tid_of = {name: i for i, name in enumerate(fai.names)}
    records: list[BamRecord] = []
    for allele in alleles:
        ref_start = max(0, allele.position - flank)
        decoy_sites = None
        if decoys:
            decoy_sites = [
                (tid_of[c], p) for c, p in decoys.get(allele.repeat_unit, [])
                if c in tid_of
            ] or None
        simulate_allele(
            fai, allele, frag_hist, flank, depth, read_length, rng, records,
            tid_of[allele.chrom], ref_start, decoy_sites=decoy_sites,
            mismap_rate=mismap_rate,
        )
    if fastq_prefix:
        # reference-style paired FASTQ output (simulate_reads.nim:92-99), for
        # users aligning with their own bwa/minimap
        qual = "I" * read_length
        with open(fastq_prefix + "_r1.fastq", "w") as f1, open(
            fastq_prefix + "_r2.fastq", "w"
        ) as f2:
            for r in records:
                if r.flag & 0x40:
                    f1.write(f"@{r.qname}\n{r.seq}\n+\n{qual[:len(r.seq)]}\n")
                else:
                    f2.write(
                        f"@{r.qname}\n{reverse_complement(r.seq)}\n+\n"
                        f"{qual[:len(r.seq)]}\n"
                    )
    records.sort(key=lambda r: (r.tid if r.tid >= 0 else 1 << 30, r.pos))
    header = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in targets
    ) + "@RG\tID:sim\tSM:sim\n"
    write_bam(out_bam, header, targets, records)


def simulate_main(argv):
    p = argparse.ArgumentParser("strling simulate")
    p.add_argument("--fasta", required=True)
    p.add_argument("--flank", type=int, default=20000)
    p.add_argument("--depth", type=int, default=30)
    p.add_argument("--read-length", type=int, default=150)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fastq", action="store_true",
                   help="also write <prefix>_r1/_r2.fastq (reference-style)")
    p.add_argument("--output", required=True, help="output prefix (<prefix>.bam)")
    p.add_argument(
        "bam_or_hist",
        help="bam/.hist for fragment lengths, or 'normal:MEAN,SD'",
    )
    p.add_argument(
        "allele", nargs="+",
        help="{chrom}:{start}:{unit}_{c1}/{c2} or a .bed with such rows",
    )
    args = p.parse_args(argv)

    if args.bam_or_hist.startswith("normal:"):
        mean, sd = args.bam_or_hist[len("normal:"):].split(",")
        frag_hist = normal_hist(float(mean), float(sd))
    elif args.bam_or_hist.endswith(".hist"):
        frag_hist = read_hist(args.bam_or_hist)
    else:
        from strling_tpu_torch.io.bam import Bam
        from strling_tpu_torch.utils.fraglen import fragment_length_distribution

        frag_hist = fragment_length_distribution(Bam(args.bam_or_hist))
        write_hist(frag_hist, args.output + ".hist")

    alleles = []
    for a in args.allele:
        if a.endswith(".bed"):
            with open(a) as fh:
                for line in fh:
                    if line.startswith("#"):
                        continue
                    toks = line.strip().split("\t")
                    alleles.append(parse_allele(f"{toks[0]}:{toks[1]}:{toks[3]}"))
        else:
            alleles.append(parse_allele(a))

    out_bam = args.output if args.output.endswith(".bam") else args.output + ".bam"
    simulate_str_bam(
        args.fasta, alleles, out_bam, frag_hist,
        depth=args.depth, flank=args.flank, read_length=args.read_length,
        seed=args.seed, fastq_prefix=args.output if args.fastq else None,
    )
    print(f"wrote {out_bam}", file=sys.stderr)
