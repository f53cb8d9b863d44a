"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
import glob
import os
import sys
import types

from portbench import run
from portbench.tests._tiny import PKG

FORBIDDEN = {"jax", "jaxlib", "flax", "strling_tpu"}


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources(sub=""):
    return [p for p in glob.glob(os.path.join(PKG, sub, "**", "*.py"),
                                 recursive=True) if "/tests/" not in p]


def test_no_jax_and_no_jax_package():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top != "strling_tpu_torch", (path, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), (path, name)


def test_the_run_check_compares_whole_names():
    mod = types.ModuleType("strling_tpu.core")
    sys.modules["strling_tpu_torch_probe"] = types.ModuleType("x")
    sys.modules["strling_tpu.core"] = mod
    try:
        found = run.loaded_forbidden()
        assert "strling_tpu.core" in found
        assert "strling_tpu_torch_probe" not in found
    finally:
        del sys.modules["strling_tpu.core"]
        del sys.modules["strling_tpu_torch_probe"]
