"""The port's scripts against the JAX package's, on the CPU.

- `sim_sweep random` and `disease` (two configs, with `--dist-check` on two
  Gloo ranks): the CSV and summary.md byte-equal to the JAX script's on the
  same arguments.
- `cohort_demo`: bins equal to the JAX script's cohort, and the two-rank
  bounds byte-identical to the port's and the JAX package's `run_merge`;
  the `--synthetic-treads` bins byte-equal to the JAX script's.
- `sanitize.sh` (marked slow; tier-1 does not run it): TSAN and ASAN+UBSAN
  over the port's native code, on the system and the compat build.
"""

import argparse
import importlib.util
import os
import subprocess
import time

import pytest
import torch

from strling_tpu.core.merge import run_merge as ref_run_merge
from strling_tpu_torch.scripts import cohort_demo, sim_sweep
from strling_tpu_torch.scripts.ranks import run_ranks

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_sweep():
    return _jax_script("sim_sweep")


@pytest.fixture(scope="module")
def jax_cohort():
    return _jax_script("cohort_demo")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_sweep_random_equals_the_jax_script(jax_sweep, tmp_path):
    small = dict(n_samples=3, min_units=0, max_units=600, fixed=0,
                 unit="CAG", depth=20, flank=2500, seed=7, mismap=0.0)
    ref = tmp_path / "ref"
    jax_sweep.run_random(argparse.Namespace(out=str(ref), **small))
    port = tmp_path / "port"
    sim_sweep.main(["random", "--out", str(port), "--n-samples", "3",
                    "--depth", "20", "--flank", "2500", "--device", "cpu"])
    for name in ("sweep_results.csv", "summary.md"):
        assert _read(port / name) == _read(ref / name), name
    assert _read(port / "sweep_results.csv").count(b"\n") == 4


def test_sweep_disease_dist_check_equals_the_jax_script(jax_sweep, tmp_path,
                                                       monkeypatch):
    """Two configs (a deletion allele and an expansion); the port's
    --dist-check runs each config's call on two Gloo ranks and asserts the
    three outputs byte-identical to one process."""
    configs = [("CAG", -5, 12), ("CGG", 0, 60)]
    monkeypatch.setattr(jax_sweep, "DISEASE_CONFIGS", configs)
    monkeypatch.setattr(sim_sweep, "DISEASE_CONFIGS", configs)
    ref = tmp_path / "ref"
    jax_sweep.run_disease(argparse.Namespace(
        out=str(ref), depth=20, flank=2500, seed=11, mismap=0.0,
        dist_check=False))
    port = tmp_path / "port"
    sim_sweep.main(["disease", "--out", str(port), "--depth", "20",
                    "--flank", "2500", "--device", "cpu", "--dist-check"])
    for name in ("sweep_results.csv", "summary.md"):
        assert _read(port / name) == _read(ref / name), name
    for d in ("cfg00_CAG_-5_12", "cfg01_CGG_0_60"):
        assert (port / d / "dist-genotype.txt").exists()


def test_sweep_needs_a_card_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_sweep.main(["random", "--out", str(tmp_path), "--n-samples", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cohort_demo.main(["--out", str(tmp_path), "--n", "1"])


def test_cohort_demo_bounds_equal_both_merges(jax_cohort, tmp_path, capsys,
                                              monkeypatch):
    """Three simulated samples, two ranks: the script asserts the ranks'
    bounds byte-identical to its one-process run_merge; they also equal the
    JAX package's run_merge, and the bins the JAX script's. --out is given
    relative to the working directory, as the ranks must read it too."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "port"
    cohort_demo.main(["--out", "port", "--n", "3", "--procs", "2",
                      "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "[cohort] OK: 3 samples" in printed
    assert "2-process distributed merge" in printed
    bins = [str(out / f"s{s:03d}.bin") for s in range(3)]
    ref_run_merge(bins, output_prefix=str(tmp_path / "ref"))
    dp = _read(out / "joint_dp-bounds.txt")
    assert dp == _read(out / "joint_sp-bounds.txt") == _read(
        tmp_path / "ref-bounds.txt")
    assert dp.count(b"\n") >= 2
    ref_bins = jax_cohort.build_cohort(str(tmp_path), 3, 3)
    for a, b in zip(bins, ref_bins):
        assert _read(a) == _read(b), a


def test_cohort_synthetic_bins_equal_the_jax_script(jax_cohort, tmp_path,
                                                   capsys):
    out = tmp_path / "port"
    cohort_demo.main(["--out", str(out), "--n", "3", "--procs", "2",
                      "--synthetic-treads", "400", "--loci", "40",
                      "--device", "cpu"])
    assert "[cohort] OK: 3 samples" in capsys.readouterr().out
    ref_bins = jax_cohort.build_cohort_synthetic(str(tmp_path), 3, 400, 40, 3)
    for s, b in enumerate(ref_bins):
        assert _read(out / f"y{s:03d}.bin") == _read(b), s


def test_run_ranks_stops_the_others_when_a_rank_fails(tmp_path):
    """Rank 1 fails at once; rank 0 would wait a minute: run_ranks raises
    naming rank 1 and stops rank 0 without waiting for it."""
    code = ("import sys, time\n"
            "if sys.argv[1] == '1':\n"
            "    sys.exit('rank one gives up')\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with 1"
                       "(.|\n)*rank one gives up"):
        run_ranks(code, 2, str(tmp_path / "init"), [])
    assert time.monotonic() - t0 < 30


SAMPLE = """
import sys
sys.modules["jax"] = None
sys.modules["strling_tpu"] = None
import numpy as np
from strling_tpu_torch.core.simulate import Allele, normal_hist, simulate_str_bam
from strling_tpu_torch.io import Bam, BamRecord, build_fai, write_fasta
from strling_tpu_torch.io.cramwrite import write_cram
d = sys.argv[1]
rng = np.random.default_rng(5)
seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 30000)])
seq = seq[:15000] + "CAG" * 10 + seq[15000:]
write_fasta(d + "/ref.fa", {"chr1": seq})
build_fai(d + "/ref.fa", d + "/ref.fa.fai")
simulate_str_bam(d + "/ref.fa", [Allele("chr1", 15000, (0, 100), "CAG")],
                 d + "/s.bam", normal_hist(400, 50), depth=20, flank=5000,
                 seed=1)
bam = Bam(d + "/s.bam")
recs = []
for b in bam.batches():
    for i in range(len(b)):
        cig = [(int(c) >> 4, int(c) & 0xF) for c in b.cigar_of(i)]
        recs.append(BamRecord(b.qname(i), int(b.flag[i]), int(b.tid[i]),
                              int(b.pos[i]), int(b.mapq[i]), cig,
                              int(b.mate_tid[i]), int(b.mate_pos[i]),
                              int(b.isize[i]), b.seq_str(i)))
write_cram(d + "/s.cram", bam.header_text,
           [(t.name, t.length) for t in bam.targets], recs,
           fasta=d + "/ref.fa", slice_size=500)
"""


@pytest.mark.slow
def test_sanitize_sh_runs_clean(tmp_path):
    """TSAN and ASAN+UBSAN over the port's engine, its codecs and the
    extract producer thread, on both builds (a few minutes)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run(["python", "-c", SAMPLE, str(tmp_path)], cwd=REPO,
                   env=env, check=True, timeout=300)
    out = subprocess.run(
        [os.path.join(REPO, "strling_tpu_torch", "scripts", "sanitize.sh"),
         str(tmp_path / "s.bam"), str(tmp_path / "s.cram"),
         str(tmp_path / "ref.fa")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=3000)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "[sanitize] OK: system compat" in out.stderr
