"""strling_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports the JAX package or JAX; the engine library is built
from the port's own sources; and with both packages made unimportable every
port module imports and all seven subcommands of the port's CLI run on the
CPU, with `extract`/`merge`/`call --distributed` (a world of one) and
`extract`/`call --profile`."""

import ast
import os
import subprocess
import sys

import pytest

from strling_tpu_torch.io import hostlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "strling_tpu_torch")
FORBIDDEN = ("strling_tpu", "jax", "jaxlib")
SOURCES = sorted(
    os.path.relpath(os.path.join(root, f), REPO)
    for root, _, files in os.walk(PORT) for f in files if f.endswith(".py")
) + ["chip_smoke.py"]


def _imported_roots(tree):
    """Top-level package of every import, and of every name given to
    importlib.import_module / __import__ as a string."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0], node.lineno


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_neither_reference_nor_jax(path):
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read(), path)
    bad = [(root, line) for root, line in _imported_roots(tree)
           if root in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_engine_builds_from_the_port_sources(tmp_path, monkeypatch):
    """Every file the engine build reads or compiles lies in the port, with
    the system libraries and with the compat layer."""
    assert os.path.commonpath([hostlib.SRC_DIR, PORT]) == PORT
    monkeypatch.setattr(hostlib, "BUILD_DIR", str(tmp_path))
    commands = []

    def fake_run(cmd, **kw):
        commands.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()

    monkeypatch.setattr(hostlib.subprocess, "run", fake_run)
    for missing in ([], ["libdeflate.h", "lzma.h"]):
        monkeypatch.setattr(hostlib, "missing_headers", lambda m=missing: m)
        hostlib.lib_path()
    assert len(commands) == 2
    engine = {f for f in os.listdir(hostlib.SRC_DIR) if f.endswith(".cc")}
    for cmd in commands:
        srcs = [a for a in cmd if a.endswith(".cc")]
        incs = [cmd[i + 1] for i, a in enumerate(cmd) if a == "-I"]
        assert engine <= {os.path.basename(a) for a in srcs}
        for a in srcs + incs + [hostlib.COMPAT]:
            assert os.path.commonpath([os.path.abspath(a), PORT]) == PORT, a


SCRIPT = """
import importlib, os, pkgutil, sys
sys.modules["strling_tpu"] = None
sys.modules["jax"] = None
REF = os.path.join({repo!r}, "strling_tpu") + os.sep
touched = []

def audit(event, args):
    if event == "open" and isinstance(args[0], str):
        if os.path.abspath(args[0]).startswith(REF):
            touched.append(args[0])
    elif event == "subprocess.Popen":
        touched.extend(str(a) for a in (args[1] or ())
                       if str(a).startswith(REF))

sys.addaudithook(audit)
import torch
torch.set_num_threads(1)
import strling_tpu_torch
for m in pkgutil.walk_packages(strling_tpu_torch.__path__, "strling_tpu_torch."):
    importlib.import_module(m.name)
from strling_tpu_torch.cli import main
from strling_tpu_torch.io import build_fai, write_fasta
import numpy as np
d = {work!r}
rng = np.random.default_rng(2)
seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 30000)])
seq = seq[:15000] + "CAG" * 60 + seq[15000:25000] + "AT" * 60 + seq[25000:]
fa = os.path.join(d, "ref.fa")
write_fasta(fa, {{"chr1": seq}})
build_fai(fa, fa + ".fai")
bam = os.path.join(d, "s")
main(["simulate", "--fasta", fa, "--flank", "6000", "--depth", "20",
      "--output", bam, "normal:400,50", "chr1:15000:CAG_0/100"])
bam += ".bam"
main(["index", "--device", "cpu", "-g", os.path.join(d, "ref.str"), fa])
main(["extract", "--device", "cpu", "-f", fa, "-g", os.path.join(d, "ref.str"),
      bam, os.path.join(d, "s.bin")])
main(["merge", "-o", os.path.join(d, "joint"), os.path.join(d, "s.bin")])
main(["call", "-o", os.path.join(d, "s1"), bam, os.path.join(d, "s.bin")])
main(["outliers", "--genotypes", os.path.join(d, "s1-genotype.txt"),
      "--unplaced", os.path.join(d, "s1-unplaced.txt"), "--out", d + "/"])
main(["pull_region", "-o", os.path.join(d, "region.bam"), bam,
      "chr1:14500-15500"])
# the parallel layer as a world of one (Gloo), and the profiler
j = lambda name: os.path.join(d, name)
same = lambda a, b: open(j(a), "rb").read() == open(j(b), "rb").read()
main(["extract", "--distributed", "--device", "cpu", "-f", fa, "-g",
      j("ref.str"), bam, j("dist.bin")])
main(["merge", "--distributed", "--device", "cpu", "-o", j("joint_dist"),
      j("s.bin")])
main(["call", "--distributed", "--device", "cpu", "-o", j("s1_dist"), bam,
      j("s.bin")])
assert same("dist.bin", "s.bin")
assert same("joint_dist-bounds.txt", "joint-bounds.txt")
for suffix in ("-genotype.txt", "-bounds.txt", "-unplaced.txt"):
    assert same("s1_dist" + suffix, "s1" + suffix), suffix
main(["extract", "--device", "cpu", "--profile", j("trace"), bam,
      j("prof.bin")])
main(["call", "--profile", j("ctrace"), "-o", j("s1_prof"), bam, j("s.bin")])
assert same("s1_prof-genotype.txt", "s1-genotype.txt")
loaded = sorted(k for k, v in sys.modules.items() if v is not None and
                k.split(".")[0] in ("strling_tpu", "jax", "jaxlib"))
assert not loaded, loaded
assert not touched, touched
print("standalone ok")
"""


def test_port_cli_runs_with_reference_and_jax_blocked(tmp_path):
    script = SCRIPT.format(repo=REPO, work=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "standalone ok" in out.stdout
    for name in ("ref.str", "s.bin", "joint-bounds.txt", "s1-genotype.txt",
                 "s1-bounds.txt", "STRs.tsv", "region.bam",
                 "trace/extract.pt.trace.json", "ctrace/call.pt.trace.json"):
        assert os.path.getsize(tmp_path / name) > 0, name
    assert "AGC" in (tmp_path / "ref.str").read_text()
    assert "chr1" in (tmp_path / "s1-bounds.txt").read_text()
