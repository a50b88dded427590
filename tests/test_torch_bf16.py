"""The bf16 stage-arithmetic variant (K6) of the port against the JAX package.

The port's plain bf16 version rounds every stage op to bf16 as a torch bf16
op does; the JAX package's bf16 Pallas kernel, run in interpret mode on the
CPU as its own tests run it, lets XLA keep some bf16 intermediates in
float32. So the two are held to each other in distribution and by angular
bounds, not bit for bit (the card holds K6 to the plain version bit for
bit: tests/test_torch_cuda.py, chip_smoke.py). The setup is that of the JAX
package's ``test_bf16_rhs_variant_accuracy_and_gating``: zero current
(precession and damping, no attractor that would snap both variants onto
the same fixed point), RK4, +z axis, at most 300 substeps.

Bounds:
  * engagement: bf16 against float32 of the port, max angle > 1e-3 deg;
  * the JAX package's bounds, bf16 of the port against JAX float32:
    mean < 6 deg and max < 25 deg, n_substeps equal, nothing failed;
  * bf16 of the port against the JAX bf16 kernel: mean angle < 2 deg
    (measured 1.00 deg, max 6.4 deg, on this setup; a wiring fault such as
    a stage left in float32 moves it toward the bf16-vs-float32 distance,
    3.96 deg).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spintorque_tpu.ops.pallas_integrator import integrate_pulse_pallas
from spintorque_tpu.physics import IntegratorConfig as JConfig
from spintorque_tpu.physics import LLGSParams as JParams
from spintorque_tpu_torch.envs import SpinTorqueEnv
from spintorque_tpu_torch.physics import IntegratorConfig, LLGSParams, integrate_pulse

torch.set_num_threads(1)

PARAMS = dict(
    saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
    volume=1e-23, polarization=0.7, easy_axis=np.array([0.0, 0.0, 1.0]),
)


def _setup(B=64, seed=3, cur=0.0, axis=(0.0, 0.0, 1.0)):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(B, 3))
    m = (m / np.linalg.norm(m, axis=-1, keepdims=True)).T.astype(np.float32)
    spans = rng.uniform(5e-11, 2.9e-10, B).astype(np.float32)
    current = rng.uniform(-cur, cur, B).astype(np.float32)
    p = {**PARAMS, "easy_axis": np.asarray(axis)}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    return m, spans, current, p


def _port(m, spans, current, p, **cfg):
    out = integrate_pulse(
        tuple(torch.tensor(c) for c in m), torch.tensor(spans), torch.tensor(current),
        LLGSParams(**{k: torch.tensor(v) for k, v in p.items()}),
        IntegratorConfig(**cfg), seed=7 if cfg.get("thermal") else None,
    )
    return np.stack([x.numpy() for x in out.m], -1), out.n_substeps.numpy(), out.failed.numpy()


def _jax(m, spans, current, p, **cfg):
    with pltpu.force_tpu_interpret_mode():
        (x, y, z), n, _, failed = integrate_pulse_pallas(
            tuple(jnp.asarray(c) for c in m), jnp.asarray(spans), jnp.asarray(current),
            JParams(**{k: jnp.asarray(v) for k, v in p.items()}), JConfig(**cfg),
        )
    return np.stack([np.asarray(x), np.asarray(y), np.asarray(z)], -1), np.asarray(n), np.asarray(failed)


def _angles(a, b):
    cos = np.clip(np.sum(a.astype(np.float64) * b, axis=-1), -1.0, 1.0)
    return np.degrees(np.arccos(cos))


@pytest.fixture(scope="module")
def precession():
    """Port f32, port bf16, JAX f32 and JAX bf16 on the same inputs."""
    inputs = _setup()
    cfg = dict(method="rk4", max_substeps=512)
    return dict(
        port32=_port(*inputs, **cfg), port16=_port(*inputs, **cfg, bf16_rhs=True),
        jax32=_jax(*inputs, **cfg), jax16=_jax(*inputs, **cfg, bf16_rhs=True),
    )


def test_bf16_engages(precession):
    m16, n16, f16 = precession["port16"]
    m32, n32, _ = precession["port32"]
    assert _angles(m16, m32).max() > 1e-3, "bf16_rhs produced float32 results"
    np.testing.assert_array_equal(n16, n32)
    assert not f16.any()


def test_bf16_within_the_jax_bounds(precession):
    m16, n16, f16 = precession["port16"]
    mj, nj, _ = precession["jax32"]
    assert int(n16.max()) <= 300
    ang = _angles(m16, mj)
    assert ang.mean() < 6.0, ang.mean()
    assert ang.max() < 25.0, ang.max()
    np.testing.assert_array_equal(n16, nj)
    assert not f16.any()


def test_bf16_close_to_the_jax_bf16_kernel(precession):
    m16, n16, _ = precession["port16"]
    mj16, nj16, fj16 = precession["jax16"]
    np.testing.assert_array_equal(n16, nj16)
    assert not fj16.any()
    assert _angles(m16, mj16).mean() < 2.0


@pytest.mark.parametrize("axis", [(0.0, 0.0, 1.0), (0.6, 0.0, 0.8)], ids=["plus_z", "tilted"])
@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_bf16_every_method_finite_unit_norm(method, axis):
    m, spans, current, p = _setup(B=32, seed=11, axis=axis)
    out, n, failed = _port(m, spans, current, p, method=method, max_substeps=512, bf16_rhs=True)
    assert np.isfinite(out).all() and not failed.any()
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-6)
    ref, _, _ = _port(m, spans, current, p, method=method, max_substeps=512)
    assert _angles(out, ref).max() > 1e-3


def test_bf16_thermal_runs():
    m, spans, current, p = _setup(B=32, seed=12)
    out, _, failed = _port(m, spans, current, p, method="rk4", max_substeps=512, thermal=True,
                           rk4_noise="per_stage", bf16_rhs=True)
    assert np.isfinite(out).all() and not failed.any()
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-6)


def test_env_step_with_bf16_rhs_on_cpu():
    env = SpinTorqueEnv(batch_size=16, device="cpu", max_duration=1e-10, bf16_rhs=True)
    state, obs = env.reset(seed=4)
    g = torch.Generator().manual_seed(4)
    for _ in range(2):
        action = torch.stack([4e6 * torch.rand(16, generator=g) - 2e6,
                              1e-10 * torch.rand(16, generator=g)], -1)
        state, ts = env.step(state, action)
    assert torch.isfinite(ts.obs).all()
    np.testing.assert_allclose(torch.linalg.vector_norm(state.m, dim=-1).numpy(), 1.0, atol=1e-6)
