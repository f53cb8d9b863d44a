"""CRAM on the port: its writer (strling_tpu_torch/io/cramwrite.py) against
the JAX package's, its reader against the BAM, and extract -> merge -> call
on CRAM input against the BAM path and the JAX package.

- `write_cram` in every mode gives `.cram` bytes equal to the JAX writer's
  (the `.crai` is gzip with an mtime: compared decompressed).
- The port's engine reads each mode back to the records of the BAM,
  including region and unmapped queries, and fails cleanly on malformed
  CRAMs (one reader process per case, with the JAX package blocked).
- The four kinds the card's host decodes through the compat layer (CRAM 3.0,
  3.1, 3.1 with arith and fqzcomp, bzip2 + lzma blocks) give bins equal to
  the BAM's and to the JAX package's, through the native and the spec
  extract, on the system build and on the forced compat build; the joint
  merge and call on CRAM equal the BAM path's.

Records are built for each package from the same tuples: a JAX package
`BamRecord` or `Bam` is never handed to port code.
"""

import gzip
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import strling_tpu.io.cramwrite as RW
from strling_tpu.core.call import run_call as ref_run_call
from strling_tpu.core.extract import extract as ref_extract
from strling_tpu.core.extract import extract_native as ref_extract_native
from strling_tpu.core.merge import run_merge as ref_run_merge
from strling_tpu.core.simulate import Allele, normal_hist, simulate_str_bam
from strling_tpu.io.bam import Bam as RefBam
from strling_tpu.io.bamwrite import BamRecord as RefBamRecord
from strling_tpu.io.binfmt import write_bin as ref_write_bin
from strling_tpu_torch.core.call import run_call
from strling_tpu_torch.core.extract import extract, extract_native
from strling_tpu_torch.core.merge import run_merge
from strling_tpu_torch.io import Bam, BamRecord, build_fai, write_bam, write_bin
from strling_tpu_torch.io import hostlib
from strling_tpu_torch.io.cramwrite import write_cram

from test_cram import HEADER, TARGETS, collect, make_records, make_ref

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCUS = 20000


def _fields(r):
    return (r.qname, r.flag, r.tid, r.pos, r.mapq, list(r.cigar), r.mate_tid,
            r.mate_pos, r.isize, r.seq)


def port_records(recs):
    return [BamRecord(*_fields(r), qual=r.qual) for r in recs]


def ref_records(recs):
    return [RefBamRecord(*_fields(r), qual=r.qual) for r in recs]


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("tcram")
    ref = make_ref()
    fa = str(d / "ref.fa")
    from strling_tpu_torch.io import write_fasta

    write_fasta(fa, ref)
    build_fai(fa, fa + ".fai")
    recs = make_records(ref)
    rng = random.Random(21)
    qual = [RefBamRecord(*_fields(r), qual=bytes(rng.randrange(0, 42)
                                                 for _ in r.seq))
            for r in recs]
    bam = str(d / "t.bam")
    write_bam(bam, HEADER, TARGETS, port_records(recs))
    qbam = str(d / "q.bam")
    write_bam(qbam, HEADER, TARGETS, port_records(qual))
    return {"dir": d, "ref": ref, "fa": fa, "recs": recs, "qual": qual,
            "bam": bam, "qbam": qbam}


#: name -> (records key, write_cram keywords; "fa"/"ref" name the fixture's
#: FASTA path or its dict of sequences, None writes no reference)
MODES = {
    "ref_based": ("recs", dict(fasta="fa", slice_size=37)),
    "verbatim": ("recs", dict(fasta=None, slice_size=64)),
    "embedded_ref": ("recs", dict(fasta="ref", slice_size=50, embed_ref=True)),
    "ap_non_delta": ("recs", dict(fasta="ref", slice_size=1000,
                                  ap_delta=False)),
    "core_codecs": ("recs", dict(fasta="fa", slice_size=23, core_codecs=True)),
    "v31": ("recs", dict(fasta="fa", slice_size=43, v31=True)),
    "v31_arith": ("qual", dict(fasta="fa", slice_size=57, v31=True,
                               v31_arith=True)),
    "bz_lzma": ("recs", dict(fasta="fa", slice_size=41, bz_lzma=True)),
    "stored_quals": ("qual", dict(fasta="fa")),
}


def _write_both(paths, mode, d):
    key, kw = MODES[mode]
    kw = dict(kw)
    if kw["fasta"] is not None:
        kw["fasta"] = paths[kw["fasta"]]
    recs = paths[key]
    got, want = str(d / f"port_{mode}.cram"), str(d / f"ref_{mode}.cram")
    write_cram(got, HEADER, TARGETS, port_records(recs), **kw)
    RW.write_cram(want, HEADER, TARGETS, ref_records(recs), **kw)
    return got, want, key


@pytest.mark.parametrize("mode", list(MODES))
def test_write_cram_equals_jax_writer_and_reads_back(paths, mode, tmp_path):
    got, want, key = _write_both(paths, mode, tmp_path)
    assert _read(got) == _read(want)
    with gzip.open(got + ".crai") as a, gzip.open(want + ".crai") as b:
        assert a.read() == b.read()
    if mode.startswith("v31"):
        assert _read(got)[:6] == b"CRAM\x03\x01"
    if mode == "bz_lzma":
        blob = _read(got)
        assert b"BZh9" in blob and b"\xfd7zXZ\x00" in blob
    fa = None if mode in ("verbatim", "embedded_ref") else paths["fa"]
    bam = paths["bam" if key == "recs" else "qbam"]
    b, c = Bam(bam), Bam(got, fasta=fa)
    assert c.header_text == b.header_text
    assert [(t.name, t.length) for t in c.targets] == [
        (t.name, t.length) for t in b.targets]
    assert collect(c.batches()) == collect(b.batches())


def test_region_and_unmapped_queries(paths, tmp_path):
    p = str(tmp_path / "q.cram")
    write_cram(p, HEADER, TARGETS, port_records(paths["recs"]),
               fasta=paths["fa"], slice_size=16)
    b, c = Bam(paths["bam"]), Bam(p, fasta=paths["fa"])
    assert c.has_index
    for tid, beg, end in [(0, 1500, 2500), (0, 0, 100000), (0, 40310, 40320),
                          (1, 600, 900), (1, 0, 50000), (0, 99000, 100000)]:
        assert collect(c.query(tid, beg, end)) == collect(b.query(tid, beg, end))
    got = collect(c.query_unmapped())
    assert [g[0] for g in got] == ["u1", "u1"]
    assert got == collect(b.query_unmapped())


#: the port's reader in a process of its own: a crash shows as a signal
FUZZ_READER = """
import sys
sys.modules["jax"] = None
sys.modules["strling_tpu"] = None
from strling_tpu_torch.io.bam import Bam
fasta = sys.argv[1]
for path in sys.argv[2:]:
    try:
        b = Bam(path, fasta=fasta)
        sum(len(x) for x in b.batches())
        print(path, "ok", flush=True)
    except (OSError, IOError):
        print(path, "refused", flush=True)
"""


def test_malformed_cram_fails_cleanly(paths, tmp_path):
    """Truncated and bit-flipped CRAMs raise, never crash the process: each
    case runs in a reader process of its own."""
    p = str(tmp_path / "fuzz.cram")
    write_cram(p, HEADER, TARGETS, port_records(paths["recs"][:40]),
               fasta=paths["fa"], slice_size=16)
    blob = _read(p)
    rng = random.Random(9)
    cases = [blob[: int(len(blob) * f)] for f in (0.1, 0.3, 0.5, 0.7, 0.9,
                                                   0.99)]
    for _ in range(12):
        m = bytearray(blob)
        for _ in range(rng.randrange(1, 8)):
            m[rng.randrange(30, len(m))] ^= 1 << rng.randrange(8)
        cases.append(bytes(m))
    files = []
    for i, data in enumerate(cases):
        fp = tmp_path / f"m{i}.cram"
        fp.write_bytes(data)
        files.append(str(fp))
    procs = [subprocess.Popen([sys.executable, "-c", FUZZ_READER, paths["fa"],
                               f], cwd=REPO, env=dict(os.environ,
                                                      PYTHONPATH=REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for f in files]
    try:
        outs = [(p.communicate(timeout=120), p.returncode) for p in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for i, ((out, err), rc) in enumerate(outs):
        assert rc == 0 and out.split()[-1] in (b"ok", b"refused"), (
            f"case {i}: rc={rc} (crash?)\n{err.decode()[-500:]}")
    assert sum(out.split()[-1] == b"refused" for (out, _), _ in outs) >= 6


def test_corrupt_bzip2_block_rejected(paths, tmp_path):
    p = str(tmp_path / "bzlz.cram")
    write_cram(p, HEADER, TARGETS, port_records(paths["recs"]),
               fasta=paths["fa"], slice_size=1000, bz_lzma=True)
    blob = bytearray(_read(p))
    i = blob.find(b"BZh9")
    assert i > 0
    blob[i + 10] ^= 0xFF
    bad = str(tmp_path / "flip.cram")
    with open(bad, "wb") as fh:
        fh.write(bytes(blob))
    with pytest.raises(Exception):
        collect(Bam(bad, fasta=paths["fa"]).batches())


# ------------------------------------------------------------ the pipeline


#: the four kinds: CRAM 3.0, 3.1, 3.1 with arith + fqzcomp, bzip2 + lzma
KINDS = {"v30": {}, "v31": dict(v31=True),
         "v31_arith": dict(v31=True, v31_arith=True),
         "bz_lzma": dict(bz_lzma=True)}


def _records_of(bam):
    recs = []
    for batch in bam.batches():
        for i in range(len(batch)):
            cig = [(int(c) >> 4, int(c) & 0xF) for c in batch.cigar_of(i)]
            recs.append(BamRecord(
                batch.qname(i), int(batch.flag[i]), int(batch.tid[i]),
                int(batch.pos[i]), int(batch.mapq[i]), cig,
                int(batch.mate_tid[i]), int(batch.mate_pos[i]),
                int(batch.isize[i]), batch.seq_str(i)))
    return recs


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """tests/test_e2e_cram.py's two samples (CAG 0/100 and 0/0), each as a
    BAM and as the four CRAM kinds; the JAX package's bins of the BAMs
    (native and spec extract), its merge and its calls."""
    d = tmp_path_factory.mktemp("tcram_e2e")
    rng = np.random.default_rng(21)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40000)])
    seq = seq[:LOCUS] + "CAG" * 10 + seq[LOCUS:]
    fa = str(d / "ref.fa")
    from strling_tpu_torch.io import write_fasta

    write_fasta(fa, {"chr1": seq})
    build_fai(fa, fa + ".fai")
    for s, counts, seed in [("s1", (0, 100), 1), ("s2", (0, 0), 2)]:
        bam_p = str(d / f"{s}.bam")
        simulate_str_bam(fa, [Allele("chr1", LOCUS, counts, "CAG")], bam_p,
                         normal_hist(400, 50), depth=30, flank=6000, seed=seed)
        bam = Bam(bam_p)
        recs = _records_of(bam)
        targets = [(t.name, t.length) for t in bam.targets]
        for kind, kw in KINDS.items():
            write_cram(str(d / f"{s}.{kind}.cram"), bam.header_text, targets,
                       recs, fasta=fa, slice_size=500, **kw)
        rbam = RefBam(bam_p)
        tb, frag, _ = ref_extract_native(rbam, None, None)
        ref_write_bin(str(d / f"ref_native_{s}.bin"), tb, frag,
                      rbam.header_text, 0.8, 40)
        tb, frag, _ = ref_extract(RefBam(bam_p), None, None)
        ref_write_bin(str(d / f"ref_spec_{s}.bin"), tb, frag,
                      rbam.header_text, 0.8, 40)
    bins = [str(d / f"ref_native_{s}.bin") for s in ("s1", "s2")]
    ref_run_merge(bins, output_prefix=str(d / "ref_joint"))
    for s in ("s1", "s2"):
        ref_run_call(str(d / f"{s}.bam"), str(d / f"ref_native_{s}.bin"),
                     fasta=fa, bounds_path=str(d / "ref_joint-bounds.txt"),
                     output_prefix=str(d / f"ref_{s}"))
    return d, fa


def _port_bin(path, fa, out, spec=False):
    h = Bam(path, fasta=fa)
    if spec:
        tb, frag, _ = extract(h, None, None, device=CPU)
    else:
        tb, frag, _ = extract_native(h, None, None, devices=[CPU])
    write_bin(out, tb, frag, h.header_text, 0.8, 40)
    return _read(out)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("path", ["native", "spec"])
def test_cram_bin_equals_bam_bin_and_reference(samples, kind, path,
                                               tmp_path):
    d, fa = samples
    spec = path == "spec"
    for s in ("s1", "s2"):
        got = _port_bin(str(d / f"{s}.{kind}.cram"), fa,
                        str(tmp_path / f"{s}.cram.bin"), spec)
        bam_bin = _port_bin(str(d / f"{s}.bam"), fa,
                            str(tmp_path / f"{s}.bam.bin"), spec)
        assert got == bam_bin == _read(str(d / f"ref_{path}_{s}.bin")), s


def test_joint_pipeline_cram_equals_bam(samples, tmp_path):
    """extract -> merge -> call -f on CRAM (3.1 with arith and fqzcomp) is
    byte-identical to the BAM path, and to the JAX package's."""
    d, fa = samples
    out = {}
    for fmt in ("bam", "v31_arith.cram"):
        bins = []
        for s in ("s1", "s2"):
            b = str(tmp_path / f"{fmt}_{s}.bin")
            _port_bin(str(d / f"{s}.{fmt}"), fa, b)
            bins.append(b)
        run_merge(bins, output_prefix=str(tmp_path / f"{fmt}_joint"))
        for s in ("s1", "s2"):
            run_call(str(d / f"{s}.{fmt}"), str(tmp_path / f"{fmt}_{s}.bin"),
                     fasta=fa,
                     bounds_path=str(tmp_path / f"{fmt}_joint-bounds.txt"),
                     output_prefix=str(tmp_path / f"{fmt}_{s}"))
        out[fmt] = [_read(str(tmp_path / f"{fmt}_joint-bounds.txt"))] + [
            _read(str(tmp_path / f"{fmt}_{s}{sfx}")) for s in ("s1", "s2")
            for sfx in ("-genotype.txt", "-bounds.txt", "-unplaced.txt")]
    want = [_read(str(d / "ref_joint-bounds.txt"))] + [
        _read(str(d / f"ref_{s}{sfx}")) for s in ("s1", "s2")
        for sfx in ("-genotype.txt", "-bounds.txt", "-unplaced.txt")]
    assert out["bam"] == out["v31_arith.cram"] == want
    assert b"AGC" in want[0] or b"CAG" in want[0]


COMPAT_SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["strling_tpu"] = None
import torch
torch.set_num_threads(1)
from strling_tpu_torch.io import hostlib
hostlib.missing_headers = lambda: ["libdeflate.h", "lzma.h"]
from strling_tpu_torch.core.extract import extract, extract_native
from strling_tpu_torch.io import Bam, write_bin
from strling_tpu_torch.io import bam as engine
cpu = torch.device("cpu")
fa, out = sys.argv[1], sys.argv[2]
for path in sys.argv[3:]:
    name = path.rsplit("/", 1)[-1]
    h = Bam(path, fasta=fa)
    tb, frag, _ = extract_native(h, None, None, devices=[cpu])
    write_bin(f"{out}/native_{name}.bin", tb, frag, h.header_text, 0.8, 40)
tb, frag, _ = extract(Bam(sys.argv[3], fasta=fa), None, None, device=cpu)
write_bin(f"{out}/spec.bin", tb, frag, h.header_text, 0.8, 40)
print("engine", engine._lib._name)
"""


def test_four_kinds_on_the_forced_compat_build(samples, tmp_path):
    """As on the card's host: the engine built on the compat layer
    (libdeflate's API on zlib, liblzma and libbz2 by soname) in a fresh
    process decodes the four kinds to the JAX package's bins."""
    d, fa = samples
    crams = [str(d / f"s1.{kind}.cram") for kind in KINDS]
    out = subprocess.run(
        [sys.executable, "-c", COMPAT_SCRIPT, fa, str(tmp_path), *crams],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    engine = out.stdout.split("engine ")[-1].strip()
    assert os.path.dirname(engine) == hostlib.BUILD_DIR
    assert engine.endswith("-deflate_on_zlib-lzma_by_soname.so")
    want = _read(str(d / "ref_native_s1.bin"))
    for c in crams:
        name = c.rsplit("/", 1)[-1]
        assert _read(str(tmp_path / f"native_{name}.bin")) == want, name
    assert _read(str(tmp_path / "spec.bin")) == _read(
        str(d / "ref_spec_s1.bin"))
