"""`pull_region` — debug read extraction (src/strpkg/extract_region.nim)."""

from __future__ import annotations

import argparse
import sys

from strling_tpu_torch.io.bam import Bam
from strling_tpu_torch.io.bamwrite import BamRecord, write_bam
from strling_tpu_torch.core.collect import batch_records
from strling_tpu_torch.core.tread import FLAG_READ1, FLAG_SECONDARY, FLAG_SUPPLEMENTARY


def _parse_region(region: str, targets):
    if ":" in region:
        chrom, rng = region.rsplit(":", 1)
        beg, end = rng.replace(",", "").split("-")
        beg, end = int(beg) - 1, int(end)
    else:
        chrom, beg, end = region, 0, 1 << 31
    for t in targets:
        if t.name == chrom:
            return t.tid, beg, end
    raise SystemExit(f"unknown chromosome in region: {region}")


def _get_mate(rec, bam: Bam):
    """extract_region.nim:7-20."""
    if rec.mate_tid == -1:
        it = bam.query_unmapped()
    else:
        it = bam.query(rec.mate_tid, max(0, rec.mate_pos - 1), rec.mate_pos + 1)
    for batch in it:
        for o in batch_records(batch):
            if o.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY):
                continue
            if (o.flag & FLAG_READ1) == (rec.flag & FLAG_READ1):
                continue
            if o.qname == rec.qname:
                return o
    print(f"skipping pair. mate not found for {rec.qname}", file=sys.stderr)
    return None


def pull_region_main(argv):
    p = argparse.ArgumentParser("strling pull_region")
    p.add_argument("-f", "--fasta", default="", help="only required for cram")
    p.add_argument("-o", "--output-bam", default="extracted.bam")
    p.add_argument("bam")
    p.add_argument("region")
    a = p.parse_args(argv)

    bam = Bam(a.bam, fasta=a.fasta or None)
    tid, beg, end = _parse_region(a.region, bam.targets)

    records = []
    counts: dict[str, int] = {}
    for batch in bam.query(tid, beg, end):
        for rec in batch_records(batch):
            if rec.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY):
                continue
            records.append(rec)
            counts[rec.qname] = counts.get(rec.qname, 0) + 1
    print(
        f"extracted {len(records)} alignments. now checking for mates",
        file=sys.stderr,
    )

    mates = []
    for i, r in enumerate(records):
        if i % 10000 == 0:
            print(f"extracting mates. on records {i} of {len(records)}", file=sys.stderr)
        if counts.get(r.qname, 0) == 2:
            continue
        m = _get_mate(r, bam)
        if m is not None:
            mates.append(m)
    records.extend(mates)
    records.sort(key=lambda r: (r.tid if r.tid >= 0 else 1 << 30, r.pos))

    out = [
        BamRecord(
            r.qname, r.flag, r.tid, r.pos, r.mapq,
            r.cigar, r.mate_tid, r.mate_pos, r.isize, r.seq,
        )
        for r in records
    ]
    write_bam(a.output_bam, bam.header_text, [(t.name, t.length) for t in bam.targets], out)
    print(f"wrote {len(out)} records to {a.output_bam}", file=sys.stderr)
