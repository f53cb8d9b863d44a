"""The port's spec extract path (`core.extract.extract` / `Extractor`, the
reference's per-batch state machine in Python with the scan on a torch
device) against the JAX package's `strling_tpu.core.extract.extract`: bins
byte for byte on the extract test BAMs and the golden simulations, the
golden flows reproduced through it, and the F2 stop at the same place; plus
`utils.profiling.maybe_trace`."""

import json
import os

import numpy as np
import pytest
import torch

import test_torch_golden
from strling_tpu.core.extract import extract as ref_extract
from strling_tpu.core.genome_index import GenomeIndex as RefGenomeIndex
from strling_tpu.io.bam import Bam as RefBam
from strling_tpu.io.binfmt import write_bin as ref_write_bin
from strling_tpu_torch.core.extract import Extractor, extract, extract_native
from strling_tpu_torch.core.genome_index import GenomeIndex
from strling_tpu_torch.io import Bam, write_bin
from strling_tpu_torch.utils.profiling import maybe_trace

from test_extract import _str_bam
from test_golden import _check
from test_torch_extract import _golden_sim, _pairs_bam, _str_mutate

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _port_bin(path, bam_path, gi=None, spec=True):
    bam = Bam(bam_path)
    if spec:
        tb, frag, _ = extract(bam, None, None, genome_index=gi, device=CPU)
    else:
        tb, frag, _ = extract_native(bam, None, None, genome_index=gi,
                                     devices=[CPU])
    write_bin(path, tb, frag, bam.header_text, 0.8, 40)
    with open(path, "rb") as fh:
        return fh.read(), tb


def _ref_bin(path, bam_path, gi=None):
    bam = RefBam(bam_path)
    tb, frag, _ = ref_extract(bam, None, None, genome_index=gi)
    ref_write_bin(path, tb, frag, bam.header_text, 0.8, 40)
    with open(path, "rb") as fh:
        return fh.read()


def _assert_spec_bin(tmp_path, bam_path, ref_gi=None, port_gi=None):
    got, tb = _port_bin(str(tmp_path / "spec.bin"), bam_path, port_gi)
    assert got == _ref_bin(str(tmp_path / "ref.bin"), bam_path, ref_gi)
    return got, tb


@pytest.fixture(scope="module")
def str_bam(tmp_path_factory):
    p = tmp_path_factory.mktemp("tspec") / "str.bam"
    _str_bam(str(p))
    return str(p)


def test_spec_bin_equal_str_bam(str_bam, tmp_path):
    """The anchored STR pair, the soft-clipped read and the unplaced pair;
    the spec bin also equals the port's native-engine bin."""
    got, tb = _assert_spec_bin(tmp_path, str_bam)
    assert {"str1", "clip1", "unp1"} <= set(tb.qnames)
    assert got == _port_bin(str(tmp_path / "native.bin"), str_bam,
                            spec=False)[0]


def test_spec_bin_equal_with_genome_index(str_bam, tmp_path):
    regions = {"chr1": [(49000, 52000)]}
    _assert_spec_bin(tmp_path, str_bam, RefGenomeIndex(regions),
                     GenomeIndex(regions))


@pytest.mark.parametrize("kind", ["iupac", "n_plane", "w16"])
def test_spec_bin_equal_read_kinds(kind, tmp_path):
    """IUPAC bytes, N runs and reads over 248bp through the ASCII scan."""
    rng = np.random.default_rng(3)

    def mutate(i, s1, s2):
        s1, s2 = _str_mutate(i, s1, s2)
        if kind == "iupac" and i % 8 == 0:
            s2 = s2[:50] + "R" + s2[51:]
        if kind == "n_plane" and i % 8 == 4:
            s2 = s2[:30] + "NNN" + s2[33:]
        return s1, s2

    L = 256 if kind == "w16" else 104
    path = _pairs_bam(str(tmp_path / f"{kind}.bam"), 60, L, rng, mutate)
    _, tb = _assert_spec_bin(tmp_path, path)
    assert len(tb) > 0


def test_spec_extract_stops_where_the_reference_stops(tmp_path):
    """F2: a 256bp homopolymer counts 256 (the kernel's count is exact, as
    the reference's spec scan is); both spec paths stop at their
    `assert count < 256`."""
    rng = np.random.default_rng(8)

    def mutate(i, s1, s2):
        if i == 7:
            s2 = "A" * 256
        return s1, s2

    path = _pairs_bam(str(tmp_path / "wide.bam"), 30, 256, rng, mutate)
    with pytest.raises(AssertionError):
        ref_extract(RefBam(path), None, None)
    with pytest.raises(AssertionError):
        extract(Bam(path), None, None, device=CPU)


def test_spec_bin_equal_golden_sim(tmp_path):
    _assert_spec_bin(tmp_path, _golden_sim(str(tmp_path)))


def test_extractor_chunks_batches(str_bam, tmp_path):
    """A device chunk smaller than a batch's scan rows gives the same
    treads as one chunk."""
    bam = Bam(str_bam)
    want, _, opts = extract(bam, None, None, device=CPU)
    ex = Extractor(opts, None, bam.targets, Lmax=bam.Lmax, device_chunk=16,
                   device=CPU)
    for batch in Bam(str_bam).batches():
        ex.process_batch(batch)
    for batch in Bam(str_bam).query_unmapped():
        ex.process_batch(batch)
    got = [(t.tid, t.position, t.repeat, t.qname) for t in ex.cache.out]
    assert got == [(t.tid, t.position, t.repeat, t.qname)
                   for t in want.to_treads()]


def _spec_extract(bam_path: str, bin_path: str):
    bam = Bam(bam_path)
    treads, frag_dist, _ = extract(bam, None, None, device=CPU)
    write_bin(bin_path, treads, frag_dist, bam.header_text, 0.8, 40)


@pytest.mark.parametrize("flow", ["_run", "_run_joint", "_run_loci"],
                         ids=["single", "joint", "loci"])
def test_golden_flows_through_spec_extract(tmp_path, monkeypatch, flow):
    """tests/test_torch_golden.py's flows with every bin made by the spec
    path reproduce tests/golden/."""
    monkeypatch.setattr(test_torch_golden, "_extract", _spec_extract)
    outputs = getattr(test_torch_golden, flow)(str(tmp_path))
    assert len(outputs) >= 2
    _check(outputs)


def test_maybe_trace_writes_a_chrome_trace(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    with maybe_trace(str(trace_dir), "extract"):
        torch.ones(64).cumsum(0)
    path = trace_dir / "extract.pt.trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    assert "profiler trace written to" in capsys.readouterr().err


def test_maybe_trace_without_a_directory_is_a_no_op(tmp_path, capsys):
    with maybe_trace(None, "extract"):
        pass
    assert capsys.readouterr().err == ""
    assert os.listdir(tmp_path) == []
