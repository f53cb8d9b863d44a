"""The generator: deterministic by seed, and the shares it states."""

import hashlib
import json
import os

import numpy as np
import pytest

from portbench.gen import wgs_reads
from portbench.reference.bamread import read_bam
from portbench.tests._tiny import PKG, tiny_config


def _traffic(name="wgs_2x150"):
    with open(os.path.join(PKG, "traffic", name + ".json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    out = {}
    for key, seed in (("a", 3), ("b", 3), ("c", 4)):
        d = str(tmp_path_factory.mktemp(key))
        out[key] = wgs_reads.make(tiny_config(), _traffic(), seed, d, workers=2)
    return out


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def test_same_seed_same_inputs(made):
    for f in ("bam", "warm_bam", "str", "fasta"):
        assert _sha(made["a"][f]) == _sha(made["b"][f])
    assert _sha(made["a"]["bam"] + ".bai") == _sha(made["b"]["bam"] + ".bai")
    assert _sha(made["a"]["bam"]) != _sha(made["c"]["bam"])


def test_stated_shares(made):
    tr = _traffic()
    m = made["a"]
    text, refs, R = read_bam(m["bam"])
    assert len(R) == m["n_records"]
    assert "@RG\t" in text and len(refs) == 25
    f = R.flag
    dup = ((f & 0x400) != 0).mean()
    assert abs(dup - tr["duplicate_share"]) < 0.015
    mapped = (f & 4) == 0
    assert abs((R.mapq[mapped] == 0).mean() - tr["mapq0_share"]) < 0.015
    disc = mapped & ((f & 8) == 0) & (R.tid != R.mtid)
    assert abs(disc.mean() - tr["discordant_share"]) < 0.006
    unm = (~mapped).mean()
    assert 0.5 * tr["mate_unmapped_share"] < unm
    assert (R.tid < 0).sum() > 0  # pairs with both mates unmapped, at the end
    clipped = (R.lclip > 0) | (R.rclip > 0)
    assert abs(clipped.mean() - tr["clip_share"]) < 0.015
    assert m["shares"]["indel"] > 0.5 * tr["indel_share"]
    assert m["shares"]["expanded_allele_reads"] > 100
    assert m["n_str_regions"] > 0
    q = R.buf[(R.seq_at[:1000, None] + (R.lseq[:1000, None] + 1) // 2
               + np.arange(150)).ravel()]
    assert set(np.unique(q)) <= set(tr["qual_values"] + [tr["error_qual"]])
    for tag in (b"RGZ", b"MCZ", b"MQC", b"ASC", b"NMC"):
        assert tag in R.buf[:200000].tobytes()


def test_the_port_reads_the_bam_and_its_index(made):
    from strling_tpu_torch.io import Bam

    m = made["a"]
    _, refs, R = read_bam(m["bam"])
    bam = Bam(m["bam"])
    assert bam.has_index
    n = sum(len(b) for b in bam.batches())
    assert n == len(R)
    tid = 21
    for beg, end in ((0, 5000), (100_000, 100_300), (399_000, 400_000)):
        got = sum(len(b) for b in bam.query(tid, beg, end))
        want = int(((R.tid == tid) & (R.pos < end) & (R.end_pos > beg)).sum())
        assert got == want
    assert sum(len(b) for b in bam.query_unmapped()) == int((R.tid < 0).sum())
