"""strling_tpu_torch CLI vs strling_tpu's, and the port's freedom from JAX."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from strling_tpu import cli as ref_cli
from strling_tpu_torch import cli

torch.set_num_threads(1)
LOCUS = 20000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from strling_tpu.io.fasta import build_fai, write_fasta

    d = tmp_path_factory.mktemp("tcli")
    rng = np.random.default_rng(2)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40000)])
    seq = (seq[:LOCUS] + "CAG" * 10 + seq[LOCUS:30000] + "AT" * 60
           + seq[30000:])
    fa = str(d / "ref.fa")
    write_fasta(fa, {"chr1": seq})
    build_fai(fa, fa + ".fai")
    bam = str(d / "s.bam")
    cli.main(["simulate", "--fasta", fa, "--flank", "9000", "--depth", "30",
              "--output", bam, "normal:400,50", f"chr1:{LOCUS}:CAG_0/100"])
    return d, fa, bam


def _read(path, mode="r"):
    with open(path, mode) as fh:
        return fh.read()


def test_cli_index_extract_call_match_reference(workdir):
    d, fa, bam = workdir
    for name, main, dev in (("port", cli.main, ["--device", "cpu"]),
                            ("ref", ref_cli.main, [])):
        main(["index", *dev, "-g", str(d / f"{name}.str"), fa])
        main(["extract", *dev, "-f", fa, "-g", str(d / f"{name}.str"), bam,
              str(d / f"{name}.bin")])
        main(["call", "-o", str(d / name), bam, str(d / f"{name}.bin")])
    assert _read(d / "port.str") == _read(d / "ref.str") != ""
    assert _read(d / "port.bin", "rb") == _read(d / "ref.bin", "rb")
    for suffix in ("genotype.txt", "bounds.txt", "unplaced.txt"):
        assert _read(d / f"port-{suffix}") == _read(d / f"ref-{suffix}")
    assert "AGC" in _read(d / "port-bounds.txt")


@pytest.mark.parametrize("argv", [
    ["extract", "--profile", "x", "a.bam", "a.bin"],
    ["extract", "--distributed", "a.bam", "a.bin"],
    ["call", "--distributed", "a.bam", "a.bin"],
    ["merge", "--profile=x", "a.bin"],
])
def test_cli_unported_flags_exit(argv):
    """The JAX package's --profile and --distributed are ported: on a host
    with no card they run on the default --device cuda and so raise, never
    falling back to the CPU; merge has no --profile (nor has the JAX
    package's) and argparse refuses it."""
    if argv[0] == "merge":
        with pytest.raises(SystemExit):
            cli.main(argv)
        return
    if torch.cuda.is_available():
        pytest.skip("a card is present: the flags would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_cli_unknown_command():
    with pytest.raises(SystemExit):
        cli.main(["frobnicate"])


def test_port_never_imports_jax(tmp_path):
    """With `jax` and the JAX package made unimportable, every
    strling_tpu_torch module imports and a tiny `extract --device cpu` runs;
    `--device cuda` on a host with no card raises instead of running on the
    CPU."""
    from test_extract import _str_bam

    bam = str(tmp_path / "s.bam")
    _str_bam(bam)
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["strling_tpu"] = None
        import torch
        torch.set_num_threads(1)
        import strling_tpu_torch
        for m in pkgutil.walk_packages(strling_tpu_torch.__path__,
                                       "strling_tpu_torch."):
            importlib.import_module(m.name)
        import strling_tpu_torch.scripts.exp_kernel_timing
        from strling_tpu_torch.cli import main
        main(["extract", "--device", "cpu", {bam!r}, {str(tmp_path / 'x.bin')!r}])
        assert not any(k.split(".")[0] in ("jax", "strling_tpu")
                       for k, v in sys.modules.items() if v is not None)
        if not torch.cuda.is_available():
            try:
                main(["extract", {bam!r}, {str(tmp_path / 'y.bin')!r}])
            except RuntimeError as e:
                assert "no CUDA device" in str(e)
                print("cuda refused")
            else:
                raise AssertionError("--device cuda ran without a card")
        print("jax-free ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "jax-free ok" in out.stdout
    assert os.path.getsize(tmp_path / "x.bin") > 0
    assert not (tmp_path / "y.bin").exists()
