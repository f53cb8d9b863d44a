"""strling_tpu_torch `index` vs the JAX package: the .str bed byte for byte."""

import numpy as np
import pytest
import torch

from strling_tpu.core import genome_index as R
from strling_tpu.io.fasta import Fasta, write_fasta
from strling_tpu.utils.options import Options
from strling_tpu_torch.core import genome_index as T

torch.set_num_threads(1)


def _planted_fasta(path, seed):
    """Random chromosomes with planted STRs of every unit size, interrupted
    and phase-shifted runs, N runs, lowercase and a chromosome-edge run."""
    rng = np.random.default_rng(seed)
    alpha = np.array(list("ACGT"))

    def rand(n):
        return "".join(alpha[rng.integers(0, 4, n)])

    units = ["A", "AT", "CAG", "AAGG", "AAGGG", "GGGGCC", "ATTCT", "TTC"]
    chroms = {}
    for c in range(3):
        parts = [rand(int(rng.integers(200, 600)))]
        for _ in range(12):
            u = units[rng.integers(0, len(units))]
            run = list((u * 80)[: int(rng.integers(30, 300))])
            for _ in range(int(rng.integers(0, 4))):
                run[rng.integers(0, len(run))] = alpha[rng.integers(0, 4)]
            parts.append("".join(run))
            parts.append(rand(int(rng.integers(50, 700))))
            if rng.random() < 0.2:
                parts.append("N" * int(rng.integers(10, 200)))
        if c == 1:
            parts.append("CAG" * 50)  # run to the chromosome end
        if c == 2:
            parts[0] = parts[0].lower()
        chroms[f"chr{c + 1}"] = "".join(parts)
    write_fasta(path, chroms)
    return path


@pytest.mark.parametrize("seed", [1, 2])
def test_index_bed_byte_equal(tmp_path, seed):
    fa = _planted_fasta(str(tmp_path / "ref.fa"), seed)
    opts = Options(proportion_repeat=0.8)
    got, want = str(tmp_path / "port.str"), str(tmp_path / "ref.str")
    gi = T.genome_repeats(fa, opts, got, torch.device("cpu"))
    R.genome_repeats(fa, opts, want)
    with open(got, "rb") as g, open(want, "rb") as w:
        text = g.read()
        assert text == w.read()
    assert len(text.splitlines()) >= 10
    # the loaded index answers overlap queries like the reference's
    rgi = R.read_str_bed(want)
    rng = np.random.default_rng(seed)
    for chrom in ("chr1", "chr2", "chr3", "chrX"):
        starts = rng.integers(0, 20000, 300).astype(np.int64)
        stops = starts + rng.integers(1, 300, 300)
        np.testing.assert_array_equal(gi.overlaps(chrom, starts, stops),
                                      rgi.overlaps(chrom, starts, stops))


@pytest.mark.parametrize("prop", [0.8, 0.6])
def test_repeat_windows_match_reference(tmp_path, prop):
    fa = _planted_fasta(str(tmp_path / "ref.fa"), 3)
    opts = Options(proportion_repeat=prop)
    got = [(w.chrom, w.start, w.stop, w.repeat) for w in
           T.repeat_windows(Fasta(fa), opts, torch.device("cpu"))]
    want = [(w.chrom, w.start, w.stop, w.repeat) for w in
            R.repeat_windows(Fasta(fa), opts)]
    assert got == want and got
