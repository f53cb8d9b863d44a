"""The port's own host I/O (BAM reader and writer, FASTA, bin codec, the
engine's fragment histogram) against the JAX package's, on the test BAMs of
tests/test_bamio.py and tests/test_extract.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from strling_tpu.io import bam as ref_bam
from strling_tpu.io import bamwrite as ref_bamwrite
from strling_tpu.io import binfmt as ref_binfmt
from strling_tpu.io import fasta as ref_fasta
from strling_tpu.io.extract_native import native_frag_hist as ref_frag_hist
from strling_tpu_torch.core.extract import extract_native
from strling_tpu_torch.io import bam as port_bam
from strling_tpu_torch.io import bamwrite as port_bamwrite
from strling_tpu_torch.io import binfmt as port_binfmt
from strling_tpu_torch.io import fasta as port_fasta
from strling_tpu_torch.io.extract_native import native_frag_hist

from test_bamio import HEADER, TARGETS, make_records
from test_extract import _str_bam

torch.set_num_threads(1)
KINDS = ["bamio", "str"]


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("hostio")
    paths = {"bamio": str(d / "bamio.bam"), "str": str(d / "str.bam")}
    ref_bamwrite.write_bam(paths["bamio"], HEADER, TARGETS, make_records())
    _str_bam(paths["str"])
    return paths


def _batch_fields(batches):
    out = []
    for b in batches:
        out.append({f.name: getattr(b, f.name) for f in dataclasses.fields(b)})
    return out


def _assert_same_batches(got, want):
    got, want = _batch_fields(got), _batch_fields(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name in g:
            if isinstance(w[name], np.ndarray):
                assert g[name].dtype == w[name].dtype, name
                np.testing.assert_array_equal(g[name], w[name], err_msg=name)
            else:
                assert g[name] == w[name], name


@pytest.mark.parametrize("kind", KINDS)
def test_bam_reader_matches_reference(bams, kind):
    """Header, targets, every batch of a full pass, a region query and the
    no-coordinate query give the reference's arrays."""
    port, ref = port_bam.Bam(bams[kind], batch_size=37), \
        ref_bam.Bam(bams[kind], batch_size=37)
    assert port.header_text == ref.header_text
    assert [(t.name, t.tid, t.length) for t in port.targets] == \
        [(t.name, t.tid, t.length) for t in ref.targets]
    assert port.has_index == ref.has_index
    _assert_same_batches(list(port.batches()), list(ref.batches()))
    _assert_same_batches(list(port.query(0, 1000, 60000)),
                         list(ref.query(0, 1000, 60000)))
    _assert_same_batches(list(port.query_unmapped()),
                         list(ref.query_unmapped()))


@pytest.mark.parametrize("kind", KINDS)
def test_native_frag_hist_matches_reference(bams, kind):
    for skip, take in ((0, 2_000_000), (10, 50)):
        np.testing.assert_array_equal(
            native_frag_hist(port_bam.Bam(bams[kind]), skip, take),
            ref_frag_hist(ref_bam.Bam(bams[kind]), skip, take))


@pytest.mark.parametrize("kind", KINDS)
def test_bam_writer_matches_reference(tmp_path, kind):
    """The same records give the same BAM and index bytes."""
    if kind == "bamio":
        header, targets, recs = HEADER, TARGETS, make_records()
        port_recs = [port_bamwrite.BamRecord(**vars(r)) for r in recs]
    else:
        _str_bam(str(tmp_path / "src.bam"))
        src = ref_bam.Bam(str(tmp_path / "src.bam"))
        header = src.header_text
        targets = [(t.name, t.length) for t in src.targets]
        recs, port_recs = [], []
        for b in src.batches():
            for i in range(len(b)):
                fields = dict(
                    qname=b.qname(i), flag=int(b.flag[i]), tid=int(b.tid[i]),
                    pos=int(b.pos[i]), mapq=int(b.mapq[i]),
                    cigar=[(int(c) >> 4, int(c) & 15) for c in b.cigar_of(i)],
                    mate_tid=int(b.mate_tid[i]), mate_pos=int(b.mate_pos[i]),
                    isize=int(b.isize[i]), seq=b.seq_str(i))
                recs.append(ref_bamwrite.BamRecord(**fields))
                port_recs.append(port_bamwrite.BamRecord(**fields))
    ref_bamwrite.write_bam(str(tmp_path / "ref.bam"), header, targets, recs)
    port_bamwrite.write_bam(str(tmp_path / "port.bam"), header, targets,
                            port_recs)
    for ext in ("", ".bai"):
        assert ((tmp_path / f"port.bam{ext}").read_bytes()
                == (tmp_path / f"ref.bam{ext}").read_bytes())


@pytest.mark.parametrize("kind", KINDS)
def test_bin_codec_matches_reference(bams, tmp_path, kind):
    """The port's write_bin gives the reference's bytes (native and Python
    writers), and its read_bin the reference's values on that bin."""
    bam = port_bam.Bam(bams[kind])
    tb, frag, _ = extract_native(bam, None, None,
                                 devices=[torch.device("cpu")])
    for native in (True, False):
        got, want = tmp_path / f"port{native}.bin", tmp_path / f"ref{native}.bin"
        port_binfmt.write_bin(str(got), tb, frag, bam.header_text, 0.8, 40,
                              native=native)
        ref_binfmt.write_bin(str(want), tb, frag, bam.header_text, 0.8, 40,
                             native=native)
        assert got.read_bytes() == want.read_bytes()
    for native in (True, False):
        for kw in ({}, {"drop_unplaced": True}, {"requested_tid": 0}):
            p = port_binfmt.read_bin(str(got), native=native, **kw)
            r = ref_binfmt.read_bin(str(got), native=native, **kw)
            assert p.reads.data.tobytes() == r.reads.data.tobytes()
            assert p.reads.qnames == r.reads.qnames
            np.testing.assert_array_equal(p.fragment_distribution,
                                          r.fragment_distribution)
            assert [(t.name, t.length) for t in p.targets] == \
                [(t.name, t.length) for t in r.targets]
            assert (p.proportion_repeat, p.min_mapq) == \
                (r.proportion_repeat, r.min_mapq)


@pytest.mark.parametrize("width", [60, 70])
def test_fasta_matches_reference(tmp_path, width):
    rng = np.random.default_rng(width)
    chroms = {f"c{i}": "".join(np.array(list("ACGTN"))[
        rng.integers(0, 5, int(n))]) for i, n in enumerate((1000, 61, 4321))}
    port_fasta.write_fasta(str(tmp_path / "port.fa"), chroms, width=width)
    ref_fasta.write_fasta(str(tmp_path / "ref.fa"), chroms, width=width)
    assert ((tmp_path / "port.fa").read_bytes()
            == (tmp_path / "ref.fa").read_bytes())
    port_fasta.build_fai(str(tmp_path / "port.fa"), str(tmp_path / "p.fai"))
    ref_fasta.build_fai(str(tmp_path / "ref.fa"), str(tmp_path / "r.fai"))
    assert (tmp_path / "p.fai").read_bytes() == (tmp_path / "r.fai").read_bytes()
    port, ref = (port_fasta.Fasta(str(tmp_path / "port.fa")),
                 ref_fasta.Fasta(str(tmp_path / "ref.fa")))
    assert port.names == ref.names and len(port) == len(ref)
    for name in chroms:
        assert port.chrom_len(name) == ref.chrom_len(name)
        assert port.get(name) == ref.get(name) == chroms[name]
        for a, b in ((0, 10), (55, 130), (7, None)):
            assert port.get(name, a, b) == ref.get(name, a, b)
    assert os.path.exists(str(tmp_path / "port.fa.fai"))


UNITS = ["A", "C", "AT", "TA", "CAG", "AGC", "GCA", "CTG", "AAGGG", "GGGAA",
         "ATTCT", "GGGGCC", "CCCCGG", "TG", "AAAG", "CGG", "AN", "ACGTNR"]


@pytest.mark.parametrize("unit", UNITS)
def test_encode_helpers_match_reference(unit):
    """The port's copies of the encode helpers that call, simulate and the
    oracle use answer as the JAX package's."""
    from strling_tpu.ops import encode as ref
    from strling_tpu_torch.ops import encode as port

    for name in ("canonical_repeat", "reverse_complement", "complement",
                 "min_rotation", "min_rev_complement", "reduce_repeat",
                 "encode_kmer"):
        assert getattr(port, name)(unit) == getattr(ref, name)(unit), name
    k = len(unit)
    for v in (0, 1, (1 << (2 * k)) - 1, port.encode_kmer(unit)):
        assert port.decode_kmer(v, k) == ref.decode_kmer(v, k)
