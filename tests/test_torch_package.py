"""The port stands alone and exports the JAX package's names.

No module of ``spintorque_tpu_torch``, no example of ``examples/torch/``,
no program of ``scripts/torch/`` and not ``chip_smoke.py`` imports JAX or the JAX package (the card's
machine has neither); the port's
``physics``, ``deployment``, ``visualization`` and ``utils`` and top-level
namespaces carry every name the JAX package exports from the modules
ported so far, and every module of the shell has its JAX counterpart's
public names. The ``quantum`` and ``research`` namespaces, and each of the
quantum tier's modules, export exactly the JAX package's names.
"""

import ast
import importlib
import pathlib

import pytest

import spintorque_tpu
import spintorque_tpu.physics as jax_physics
import spintorque_tpu_torch
import spintorque_tpu_torch.physics as physics

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "spintorque_tpu")


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_import():
    examples = sorted((ROOT / "examples" / "torch").glob("*.py"))
    assert len(examples) == 6
    scripts = sorted((ROOT / "scripts" / "torch").glob("*.py"))
    assert len(scripts) == 9
    files = (sorted((ROOT / "spintorque_tpu_torch").rglob("*.py")) + examples + scripts
             + [ROOT / "chip_smoke.py"])
    assert len(files) > 40
    bad = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p)) & set(FORBIDDEN))
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_physics_exports_every_jax_name():
    missing = sorted(set(jax_physics.__all__) - set(physics.__all__))
    assert not missing
    for name in jax_physics.__all__:
        assert hasattr(physics, name), name


def test_package_exports_the_jax_packages_names():
    missing = sorted(set(spintorque_tpu.__all__) - set(spintorque_tpu_torch.__all__))
    assert not missing


@pytest.mark.parametrize("package", ["deployment", "visualization", "utils", "quantum",
                                     "research"])
def test_subpackage_exports_every_jax_name(package):
    ours = importlib.import_module(f"spintorque_tpu_torch.{package}")
    theirs = importlib.import_module(f"spintorque_tpu.{package}")
    assert not sorted(set(theirs.__all__) - set(ours.__all__))
    for name in theirs.__all__:
        assert hasattr(ours, name), name


@pytest.mark.parametrize("package", ["quantum", "research"])
def test_quantum_and_research_exports_equal_the_jax_packages(package):
    """The quantum tier's 23 names and the research tier's (its six quantum
    names included): the same set as the JAX package's ``__all__``."""
    ours = importlib.import_module(f"spintorque_tpu_torch.{package}")
    theirs = importlib.import_module(f"spintorque_tpu.{package}")
    assert sorted(ours.__all__) == sorted(theirs.__all__)
    if package == "quantum":
        assert len(ours.__all__) == 23


QUANTUM_MODULES = [
    "quantum.statevector", "quantum.circuits", "quantum.error_correction",
    "quantum.optimization", "quantum.energy_landscape", "quantum.hybrid_computing",
    "quantum.advantage_verification", "quantum.benchmarking",
    "research.quantum_machine_learning", "research.quantum_spintronics",
    "research.validation_framework",
]


@pytest.mark.parametrize("module", QUANTUM_MODULES)
def test_quantum_module_has_the_jax_names(module):
    ours = importlib.import_module(f"spintorque_tpu_torch.{module}")
    theirs = importlib.import_module(f"spintorque_tpu.{module}")
    assert sorted(ours.__all__) == sorted(theirs.__all__)
    assert not [n for n in theirs.__all__ if not hasattr(ours, n)]


SHELL_MODULES = [
    "cli", "deployment.compliance", "deployment.manager", "deployment.server",
    "utils.error_handling", "utils.validation", "utils.security", "utils.cache",
    "utils.logging_config", "utils.performance", "utils.health", "utils.concurrency",
    "utils.scaling", "utils.scalable_environment", "visualization.plots",
    "visualization.research_plots",
]


@pytest.mark.parametrize("module", SHELL_MODULES)
def test_shell_module_has_the_jax_public_names(module):
    ours = importlib.import_module(f"spintorque_tpu_torch.{module}")
    theirs = importlib.import_module(f"spintorque_tpu.{module}")
    public = getattr(theirs, "__all__", None) or [
        n for n, v in vars(theirs).items()
        if not n.startswith("_") and getattr(v, "__module__", None) == theirs.__name__]
    assert public
    assert not [n for n in public if not hasattr(ours, n)]
