"""The plain reference of `call` is plain: it imports nothing of the port,
of the JAX package or of JAX, in its source or once run, and its sources
bind no native code and read no BAM index; what it imports of the
benchmark is the reference's own."""

import ast
import os
import subprocess
import sys

from portbench.tests._tiny import PKG, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "strling_tpu", "strling_tpu_torch",
             "ctypes", "cffi"}


def _imports(path):
    """Every module a file imports (`from pkg import mod` names pkg.mod)."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            if node.module == "portbench.reference":
                for a in node.names:
                    yield f"{node.module}.{a.name}"
            else:
                yield node.module


def test_call_ref_imports_only_the_reference():
    seen, todo = set(), ["portbench.reference.call_ref"]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = os.path.join(os.path.dirname(PKG), *mod.split(".")) + ".py"
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, (mod, name)
            if top == "portbench":
                assert name.startswith("portbench.reference."), (mod, name)
                todo.append(name)
    assert "portbench.reference.bamread" in seen
    with open(os.path.join(PKG, "reference", "call_ref.py")) as fh:
        text = fh.read().lower()
    assert ".bai" not in text and "csrc" not in text


def test_call_ref_runs_with_the_port_and_jax_blocked(tmp_path):
    code = ("import sys\n"
            "for m in ('jax', 'strling_tpu', 'strling_tpu_torch'):\n"
            "    sys.modules[m] = None\n"
            "from portbench.reference import call_ref\n"
            "from portbench.tests._tiny_call import make_inputs\n")
    # the inputs are made by the benchmark's generator, which checks the
    # port first: make them in a process of their own
    out = str(tmp_path / "in")
    subprocess.run([sys.executable, "-c",
                    "import sys; from portbench.tests._tiny_call import "
                    "make_inputs; make_inputs(sys.argv[1])", out],
                   cwd=REPO, check=True, capture_output=True, timeout=300)
    r = subprocess.run(
        [sys.executable, "-c", code +
         "import json, os\n"
         "d = sys.argv[1]\n"
         "ref = call_ref.reference_call(os.path.join(d, 'sample.bam'),\n"
         "                              os.path.join(d, 'sample.bin'),\n"
         "                              os.path.join(d, 'catalog.bed'))\n"
         "bad = sorted(k for k, v in sys.modules.items() if v is not None\n"
         "             and k.split('.')[0] in ('jax', 'strling_tpu',\n"
         "                                     'strling_tpu_torch'))\n"
         "print(json.dumps([ref['calls'], bad]))\n", out],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    calls, bad = __import__("json").loads(r.stdout.strip().splitlines()[-1])
    assert calls > 50 and bad == []
