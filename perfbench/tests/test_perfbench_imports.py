"""The import guard: nothing the benchmark runs imports JAX or the JAX
package, and the reference imports nothing of the program. Top-level
names are compared whole: the part of a module's name before its first
dot (``spintorque_tpu_torch`` is not ``spintorque_tpu``)."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest
from conftest import ROOT, TINY

BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "spintorque_tpu"}
# Every module run.py can load: itself, its library, the drivers, the
# metrics' readers, the roofline and the reference.
MODULES = sorted([BENCH / "run.py", *(p for d in ("lib", "drivers", "metrics", "roofline",
                                                   "reference")
                                      for p in (BENCH / d).glob("*.py"))])


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "spintorque_tpu_torch" not in names and not names & FORBIDDEN
    assert names <= {"__future__", "dataclasses", "math", "typing", "numpy", "torch",
                     "perfbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith(
                "perfbench"):
            assert node.module.startswith("perfbench.reference")


def test_the_guard_compares_whole_top_level_names():
    assert "spintorque_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    assert "jax.numpy".split(".", 1)[0] in FORBIDDEN


def test_a_run_leaves_no_forbidden_module_loaded():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "from perfbench.lib import runner\n"
            f"runner.run_cell('gym-det-b1', 3, 0.2, False, device='cpu', overrides={TINY!r})\n"
            "print(runner.forbidden_modules())")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
