"""The port stands alone and exports the JAX package's names.

No module of ``spintorque_tpu_torch`` and not ``chip_smoke.py`` imports JAX
or the JAX package (the card's machine has neither); the port's
``physics`` and top-level namespaces carry every name the JAX package
exports from the modules ported so far.
"""

import ast
import pathlib

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
    files = sorted((ROOT / "spintorque_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
