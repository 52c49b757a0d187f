"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program: module names are compared by
their whole top-level name (the port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

import pytest

from gpubench.run import FORBIDDEN_MODULES, HERE, ROOT

PROGRAM = "fypraytracer_tpu_torch"


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def sources(sub=""):
    base = os.path.join(HERE, sub)
    for dirpath, _, files in os.walk(base):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def test_no_file_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported_tops(path) & set(FORBIDDEN_MODULES), path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert PROGRAM not in imported_tops(path), path
        assert not imported_tops(path) & set(FORBIDDEN_MODULES), path


def test_a_run_loads_neither():
    code = ("import sys; sys.path.insert(0, '.'); from gpubench import run; "
            "run.run_cell('cornell-nee-1080p', 5, 0.1, False, 'cpu', size=(8, 8)); "
            "print(','.join(run.forbidden_loaded()) or 'none')")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "none"


@pytest.mark.parametrize("name,bad", [("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
                                      ("fypraytracer_tpu", True), ("fypraytracer_tpu.render", True),
                                      ("fypraytracer_tpu_torch", False), ("jaxtyping", False)])
def test_names_are_compared_whole(name, bad, monkeypatch):
    from gpubench import run

    monkeypatch.setitem(sys.modules, name, sys)
    assert (name.split(".")[0] in run.forbidden_loaded()) is bad
