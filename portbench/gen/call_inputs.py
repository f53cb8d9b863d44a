"""The generator of a `call` deployment's inputs: the sample of `wgs_reads`,
its bins and an STR catalog.

`make(config, traffic, seed, out_dir)` writes what `wgs_reads.make` writes
(the share's FASTA and `.str` index, `sample.bam` and `warm.bam` with their
indexes), then:
- `catalog.bed`: the loci `call -l` genotypes, five fields a line
  (chrom, start, end, unit, name; cluster.nim:111-134), sorted by position:
  the configuration's expanded disease loci (named, and with the unit
  written, as `catalog.disease_units` gives them), then the longest planted
  loci whose unit has 2-6 bases, ties by position, up to `catalog.loci`
  rows;
- `sample.bin` and `warm.bin`: each BAM's bin as the plain reference's
  extract makes it (`reference.extract_ref`), with the configuration's
  extract options, so that the call's inputs never come from the program
  it measures;
- `reference-genotype.txt`, `reference-bounds.txt` and
  `reference-unplaced.txt`: what the plain reference's call
  (`reference.call_ref`) writes for the sample's BAM, bin and catalog with
  the configuration's call options, computed from the records decoded for
  the sample's bin, so that the BAM is decoded once. The manifest names
  them with a digest of the reference's sources (`reference_source`); a
  run whose reference has changed since computes them anew.

The records are written with `min(8, cores)` workers, as `wgs_reads`
writes them: past a few workers the main process, which hands out the
chunks and writes their blocks, sets the pace. The files are the same for
one seed whatever the number.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

from portbench.gen import wgs_reads

#: the plain reference's sources, whose digest the stored call is made under
REFERENCE_SOURCES = ("call_ref.py", "extract_ref.py", "bamread.py",
                     "detector.py")
FILES = ("genotype", "bounds", "unplaced")


def require_program():
    """Stop before any input is made when the program cannot run the cell:
    `run_call_dist` must count a pass (`stats`)."""
    import inspect

    from strling_tpu_torch.parallel.call_dist import run_call_dist

    if "stats" not in inspect.signature(run_call_dist).parameters:
        raise SystemExit("strling_tpu_torch.parallel.call_dist.run_call_dist "
                         "takes no stats: this program cannot run a call cell")


def catalog_rows(cfg: dict, seed: int) -> list[tuple]:
    """(start, end, unit, name) of the catalog's loci, by position."""
    _, loci, _ = wgs_reads.make_genome(cfg, seed)
    want = int(cfg["catalog"]["loci"])
    units = cfg["catalog"].get("disease_units", {})
    rows = [(int(x["share_pos"]),
             int(x["share_pos"]) + len(x["unit"]) * int(x["ref_copies"]),
             units.get(x["name"], x["unit"]), x["name"])
            for x in cfg["expansions"]]
    taken = {r[0] for r in rows}
    planted = sorted((s - e, s, e, u.decode()) for s, e, u in loci
                     if 2 <= len(u) <= 6 and s not in taken)
    for n, (_, s, e, u) in enumerate(planted[:want - len(rows)]):
        rows.append((s, e, u, f"STR{n + 1:05d}_{u}"))
    return sorted(rows)


def write_catalog(path: str, chrom: str, rows: list[tuple]):
    with open(path, "w") as fh:
        for s, e, u, name in rows:
            fh.write(f"{chrom}\t{s}\t{e}\t{u}\t{name}\n")


def reference_source() -> str:
    """A digest of the plain reference's sources."""
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "reference")
    h = hashlib.sha256()
    for name in REFERENCE_SOURCES:
        with open(os.path.join(here, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def reference_bin(records: tuple, str_bed: str, opts: dict,
                  device) -> tuple[bytes, int]:
    """The bin of `extract -g str_bed` over decoded records (`read_bam`'s
    text, refs and Records) by the plain reference: (its bytes, its
    treads)."""
    from portbench.reference import extract_ref as X

    text, refs, R = records
    p, mq = float(opts["proportion_repeat"]), int(opts["min_mapq"])
    R.ref_names = [n for n, _ in refs]
    hist = X.fragment_histogram(R)
    rows = X.reference_treads(R, X.read_bed(str_bed), p, mq, X.median(hist),
                              device)
    return (X.bin_head(hist, text, p, mq, len(rows))
            + b"".join(X.tread_bytes(r) for r in rows)), len(rows)


def make(cfg: dict, tr: dict, seed: int, out_dir: str, workers: int | None = None,
         device: str | None = None) -> dict:
    """Write the inputs of one seed into `out_dir`; returns the manifest."""
    import torch

    from portbench.reference.bamread import read_bam
    from portbench.reference.call_ref import reference_call

    require_program()
    t0 = time.perf_counter()
    workers = workers or min(8, os.cpu_count() or 1)
    m = wgs_reads.make(cfg, tr, seed, out_dir, workers=workers, device=device)
    times = {"reads": time.perf_counter() - t0}
    t = time.perf_counter()
    rows = catalog_rows(cfg, seed)
    catalog = os.path.join(out_dir, "catalog.bed")
    write_catalog(catalog, cfg["contigs"][cfg["share_tid"]][0], rows)
    times["catalog"] = time.perf_counter() - t
    dev = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    for key, bam in (("warm_bin", m["warm_bam"]), ("bin", m["bam"])):
        t = time.perf_counter()
        records = read_bam(bam, workers)
        t1 = time.perf_counter()
        data, n = reference_bin(records, m["str"], cfg["extract"], dev)
        path = os.path.join(out_dir, "warm.bin" if key == "warm_bin"
                            else "sample.bin")
        with open(path, "wb") as fh:
            fh.write(data)
        m[key] = path
        m["n_warm_treads" if key == "warm_bin" else "n_treads"] = n
        times[f"{key}_decode"] = t1 - t
        times[key] = time.perf_counter() - t1
    del data
    t = time.perf_counter()
    o = cfg["call"]
    ref = reference_call(m["bam"], m["bin"], catalog, int(o["min_support"]),
                         int(o["min_mapq"]), int(o["min_clip"]),
                         int(o["min_clip_total"]), records=records[1:])
    del records
    for k in FILES:
        m[f"reference_{k}"] = os.path.join(out_dir, f"reference-{k}.txt")
        with open(m[f"reference_{k}"], "w") as fh:
            fh.write(ref[k])
    times["reference_call"] = time.perf_counter() - t
    print("[portbench] call inputs, seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in times.items()), file=sys.stderr)
    m.update(catalog=catalog, n_catalog=len(rows),
             catalog_min_bp=int(min(e - s for s, e, _, _ in rows)),
             reference_source=reference_source(),
             reference_calls=ref["calls"], reference_times=ref["times"],
             gen_s=time.perf_counter() - t0)
    return m
