"""strling_tpu_torch extract vs the JAX package: bins byte for byte.

The port's extract (the reference C++ engine, the scan on the CPU device
through the plain PyTorch twin) must write the same bin files as
`strling_tpu.core.extract.extract_native`, and the reference call on the
port's bins must reproduce tests/golden/.
"""

import os

import numpy as np
import pytest
import torch

from strling_tpu.core.extract import extract_native as ref_extract_native
from strling_tpu.core.extract import run_once_exact as ref_run_once_exact
from strling_tpu.core.genome_index import GenomeIndex as RefGenomeIndex
from strling_tpu.io.bam import Bam
from strling_tpu.io.bamwrite import BamRecord, write_bam
from strling_tpu.io.binfmt import write_bin
from strling_tpu_torch.core.extract import extract_native, scan_devices
from strling_tpu_torch.core.genome_index import GenomeIndex
from strling_tpu_torch.io import Bam as PortBam

from test_extract import HEADER, TARGETS, _str_bam

torch.set_num_threads(1)
CPU = [torch.device("cpu")]
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
LOCUS = 20000


def _bin_bytes(path, tb, frag, bam):
    write_bin(path, tb, frag, bam.header_text, 0.8, 40)
    with open(path, "rb") as fh:
        return fh.read()


def _assert_same_bins(tmp_path, bam_path, ref_gi=None, port_gi=None):
    bam = PortBam(bam_path)
    tb, frag, _ = extract_native(bam, None, None, genome_index=port_gi,
                                 devices=CPU)
    rtb, rfrag, _ = ref_extract_native(Bam(bam_path), None, None,
                                       genome_index=ref_gi)
    got = _bin_bytes(str(tmp_path / "port.bin"), tb, frag, bam)
    want = _bin_bytes(str(tmp_path / "ref.bin"), rtb, rfrag, bam)
    assert got == want
    return tb


@pytest.fixture(scope="module")
def str_bam(tmp_path_factory):
    p = tmp_path_factory.mktemp("texn") / "str.bam"
    _str_bam(str(p))
    return str(p)


def test_bin_equal_str_bam(str_bam, tmp_path):
    tb = _assert_same_bins(tmp_path, str_bam)
    assert len(tb) > 0


def test_bin_equal_with_genome_index(str_bam, tmp_path):
    regions = {"chr1": [(49000, 52000)]}
    _assert_same_bins(tmp_path, str_bam, RefGenomeIndex(regions),
                      GenomeIndex(regions))


def _pairs_bam(path, n, L, rng, mutate=None, first_len=None):
    alphabet = np.array(list("ACGT"))
    recs = []
    for i in range(n):
        pos = 1000 + i * 53
        lf = first_len(i) if first_len else L
        s1 = "".join(alphabet[rng.integers(0, 4, lf)])
        s2 = "".join(alphabet[rng.integers(0, 4, L)])
        if mutate:
            s1, s2 = mutate(i, s1, s2)
        recs.append(BamRecord(f"p{i}", 99, 0, pos, 60, f"{len(s1)}M", 0,
                              pos + 200, 300, s1))
        recs.append(BamRecord(f"p{i}", 147, 0, pos + 200, 60 if i % 3 else 0,
                              f"{len(s2)}M", 0, pos, -300, s2))
    recs.sort(key=lambda r: r.pos)
    write_bam(path, HEADER, TARGETS, recs)
    return path


def _str_mutate(i, s1, s2):
    if i % 4 == 0:
        s2 = (["CAG", "AT", "AAGGG", "A"][i % 16 // 4] * 200)[:len(s2)]
    return s1, s2


@pytest.mark.parametrize("kind", ["iupac", "n_plane", "n_free", "w16"])
def test_bin_equal_wire_layouts(kind, tmp_path):
    """The engine's ASCII fallback (an IUPAC byte in the batch), the w8 N
    plane, the N-free n8 layout and reads over 248bp (w16)."""
    rng = np.random.default_rng(3)

    def mutate(i, s1, s2):
        s1, s2 = _str_mutate(i, s1, s2)
        # on repeat reads, so the prefilter keeps them on the wire
        if kind == "iupac" and i % 8 == 0:
            s2 = s2[:50] + "R" + s2[51:]
        if kind == "n_plane" and i % 8 == 4:
            s2 = s2[:30] + "NNN" + s2[33:]
        return s1, s2

    L = 256 if kind == "w16" else 104
    path = _pairs_bam(str(tmp_path / f"{kind}.bam"), 60, L, rng, mutate)
    tb = _assert_same_bins(tmp_path, path)
    assert len(tb) > 0


def test_bin_equal_wide_count(tmp_path, capsys):
    """F2 at the bin: a 256bp homopolymer counts 256 in the port's scan; the
    bin keeps 8 bits, as the reference engine stores it, and the port says
    so on stderr."""
    rng = np.random.default_rng(8)

    def mutate(i, s1, s2):
        if i == 7:
            s2 = "A" * 256
        return s1, s2

    path = _pairs_bam(str(tmp_path / "wide.bam"), 30, 256, rng, mutate)
    _assert_same_bins(tmp_path, path)
    assert "repeat count above 255" in capsys.readouterr().err


def test_late_long_read_retry_matches_reference(tmp_path):
    """Reads past the first 10k records are longer than the probed width:
    the port re-runs at the exact width (the reference's retry path names
    `Bam` without importing it), matching the reference's run_once_exact."""
    rng = np.random.default_rng(12)
    n = 5300  # 10600 records; the first 10k are 60bp

    def mutate(i, s1, s2):
        if i >= 5100 and i % 4 == 0:
            s1 = ("CAG" * 60)[:len(s1)]
        return _str_mutate(i, s1, s2) if i >= 5000 else (s1, s2)

    path = _pairs_bam(str(tmp_path / "late.bam"), n, 60, rng, mutate,
                      first_len=lambda i: 150 if i >= 5100 else 60)
    bam = PortBam(path)
    tb, frag, opts = extract_native(bam, None, None, devices=CPU)
    from strling_tpu.utils.options import Options

    ropts = Options(median_fragment_length=0, proportion_repeat=0.8,
                    min_mapq=40)
    _, rtb = ref_run_once_exact(Bam(path, Lmax=152), 152, 0.8, 40, frag,
                                None, "auto", None, ropts)
    got = _bin_bytes(str(tmp_path / "port.bin"), tb, frag, bam)
    want = _bin_bytes(str(tmp_path / "ref.bin"), rtb, frag, bam)
    assert got == want and len(tb) > 0
    assert tb.data["align_length"].max() == 150  # the exact-width re-run
    assert opts.median_fragment_length == ropts.median_fragment_length


def _golden_sim(tmp):
    from strling_tpu.core.simulate import Allele, normal_hist, simulate_str_bam
    from strling_tpu.io.fasta import write_fasta

    rng = np.random.default_rng(1234)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40000)])
    seq = seq[:LOCUS] + "CAG" * 10 + seq[LOCUS:]
    write_fasta(os.path.join(tmp, "ref.fa"), {"chr1": seq})
    bam = os.path.join(tmp, "g.bam")
    simulate_str_bam(os.path.join(tmp, "ref.fa"),
                     [Allele("chr1", LOCUS, (0, 100), "CAG")], bam,
                     normal_hist(400, 50), depth=30, flank=8000, seed=99)
    return bam


def test_golden_sim_bin_and_call(tmp_path):
    """The golden simulation: bins equal the reference's, and the reference
    call on the port's bin reproduces tests/golden/."""
    from strling_tpu.core.call import run_call

    bam = _golden_sim(str(tmp_path))
    _assert_same_bins(tmp_path, bam)
    prefix = str(tmp_path / "g")
    run_call(bam, str(tmp_path / "port.bin"), output_prefix=prefix)
    for name in ("genotype.txt", "bounds.txt", "unplaced.txt"):
        with open(f"{prefix}-{name}") as got, \
                open(os.path.join(GOLDEN, name)) as want:
            assert got.read() == want.read(), name


def test_golden_joint_sample_bins(tmp_path):
    """The joint golden's three samples (two loci, mixed alleles)."""
    from strling_tpu.core.simulate import Allele, normal_hist, simulate_str_bam
    from strling_tpu.io.fasta import write_fasta

    rng = np.random.default_rng(77)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 60000)])
    seq = seq[:LOCUS] + "CAG" * 10 + seq[LOCUS:30000] + "AT" * 12 + seq[30000:]
    ref = str(tmp_path / "ref.fa")
    write_fasta(ref, {"chr1": seq})
    samples = [
        [Allele("chr1", LOCUS, (0, 80), "CAG")],
        [Allele("chr1", LOCUS, (10, 40), "CAG"),
         Allele("chr1", 30030, (0, 60), "AT")],
        [Allele("chr1", 30030, (30, 30), "AT")],
    ]
    for s, alleles in enumerate(samples):
        bam = str(tmp_path / f"s{s}.bam")
        simulate_str_bam(ref, alleles, bam, normal_hist(400, 50), depth=24,
                         flank=8000, seed=100 + s)
        _assert_same_bins(tmp_path, bam)


def test_small_batches_many_workers(str_bam):
    """Tiny batches, more workers than cores and a short switch interval:
    feeds stay FIFO (treads equal the reference's) and no stats update is
    lost (every batch counted once)."""
    import sys

    from strling_tpu.io.extract_native import NativeExtractor as RefNE
    from strling_tpu.io.extract_native import native_frag_hist
    from strling_tpu.utils import fraglen
    from strling_tpu_torch.io.extract_native import NativeExtractor

    med = fraglen.median(native_frag_hist(Bam(str_bam)))
    want = RefNE(Bam(str_bam), 0.8, 40, med, batch_records=64).run(
        buckets=(256,))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        stats = {}
        # prefilter off: every read is a scan row, so batches are many
        ne = NativeExtractor(Bam(str_bam), 0.8, 40, med, batch_records=64,
                             rows_per_batch=48, prefilter=False)
        got = ne.run(CPU * 3, depth=24, stats=stats)
    finally:
        sys.setswitchinterval(old)
    assert got.to_treads() == want.to_treads() and len(got) > 0
    # the same engine drained without scans gives the batch and row counts
    probe = NativeExtractor(Bam(str_bam), 0.8, 40, med, batch_records=64,
                            rows_per_batch=48, prefilter=False)
    n_batches = n_rows = 0
    while True:
        rows, n_records, *_ = probe._next_fused()
        if n_records > 0:
            n_batches += rows > 0
            n_rows += rows
            z = np.zeros(rows, np.int32)
            probe.lib.sio_ex_feed(probe._e, z, z, z, rows)
        elif probe.lib.sio_ex_done(probe._e):
            break
    assert n_batches >= 8
    assert stats["n_batches"] == n_batches
    assert stats["d2h_bytes"] == 12 * n_rows


def test_stats_attribution(str_bam):
    stats = {}
    extract_native(PortBam(str_bam), None, None, devices=CPU, stats=stats)
    assert stats["n_batches"] >= 1
    assert stats["h2d_bytes"] > 0 and stats["d2h_bytes"] > 0
    assert stats["scan_s"] > 0 and stats["wait_s"] >= 0


def test_scan_devices():
    assert scan_devices("cpu") == CPU
    with pytest.raises(ValueError):
        scan_devices("tpu")
    with pytest.raises(ValueError):
        scan_devices("cpu", "all")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scan_devices("cuda")
