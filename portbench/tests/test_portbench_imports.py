"""What the benchmark may load: no module of JAX, of the JAX package
(``repro``) or of its benchmarks, anywhere under ``portbench``; nothing of
the program under test in the reference.  Top-level names are compared
whole, so ``repro_torch`` is not ``repro``."""
import ast
import json
import os
import subprocess
import sys

import pytest

import cases
from portbench import harness as H

PKG = cases.ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path, whole=False):
    """Top-level names of the modules ``path`` imports (``whole``: the
    modules' full names)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name if whole else a.name.split(".")[0]
                        for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module if whole else node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_of_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    """Nothing of the program, and of the benchmark only the reference's
    own files (a family's file reads the shared layers)."""
    for path in (PKG / "reference").rglob("*.py"):
        names = set(_imports(path))
        assert not names & (FORBIDDEN | {"repro_torch"}), path
        assert all(n == "portbench.reference"
                   or n.startswith("portbench.reference.")
                   for n in _imports(path, whole=True)
                   if n.split(".")[0] == "portbench"), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    mods = {"os": os, "repro_torch": None, "repro_torch.models": None,
            "jaxtools_fake": None, "benchmarks_fake.x": None}
    monkeypatch.setattr(sys, "modules", mods)
    assert H.forbidden_modules() == []
    mods["repro.core"] = None
    mods["jax.numpy"] = None
    assert H.forbidden_modules() == ["jax", "repro"]


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, json; sys.path[:0] = [%r, %r, %r];"
        "import cases; from portbench import harness as H;"
        "out = H.measure(cases.bench(), cases.cell('granite-moe-1b-a400m'),"
        " 5, 0.1, False, 'cpu', time.perf_counter());"
        "print(json.dumps([out['correct'], H.forbidden_modules()]))"
    ) % (str(cases.ROOT), str(cases.ROOT / "src"), str(PKG / "tests"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    correct, found = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct and found == []


def test_the_command_refuses_without_a_card_and_prints_no_result():
    res = subprocess.run(
        [sys.executable, str(PKG / "run.py"), "--workload", "qwen05-doc",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cases.ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert res.returncode == 2 and res.stdout == ""
