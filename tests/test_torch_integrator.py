"""The port's pulse integrator against the JAX package's.

The plain PyTorch loop (the CUDA kernel's plain version, which the CPU runs)
is held to JAX's XLA ``integrate_pulse`` and to its Pallas kernel, run in
interpret mode as the JAX package's own tests run it, on the same seeded
numpy inputs. Tolerances: float64 at rtol 1e-9 (the repo's parity
tolerance), float32 at rtol/atol 2e-6 (the ``_assert_close`` contract of
tests/unit/test_pallas_integrator.py); ``n_substeps`` and ``failed`` must be
identical.

The XLA reference runs op by op (``jax.disable_jit``) unless a test says
otherwise: a jitted program lets XLA's CPU backend contract a*b+c into fused
multiply-adds, which the port's eager ops and its CUDA kernel (built with
--fmad=false) do not. The last-bit differences that makes grow to ~1e-5 in
float32 over a few hundred substeps, and without bound where the
spin-transfer torque makes the dynamics chaotic. The jitted program is held
to the port in float64 on inputs where the dynamics are not chaotic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spintorque_tpu.ops.pallas_integrator import integrate_pulse_pallas
from spintorque_tpu.physics import IntegratorConfig as JConfig
from spintorque_tpu.physics import LLGSParams as JParams
from spintorque_tpu.physics import integrate_pulse as jax_integrate_pulse
from spintorque_tpu.physics import substep_counts as jax_substep_counts
from spintorque_tpu_torch.ops.cuda_integrator import (
    cuda_supported,
    integrate_pulse_cuda,
    is_plus_z,
)
from spintorque_tpu_torch.physics import IntegratorConfig, LLGSParams, integrate_pulse
from spintorque_tpu_torch.physics import integrate_pulse_plain, max_substeps_for, substep_counts

torch.set_num_threads(1)

PARAMS = dict(
    saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
    volume=1e-23, polarization=0.7, easy_axis=np.array([0.0, 0.0, 1.0]),
)


def _setup(B, seed, dtype, cur=200.0, lo=5e-11, hi=1.5e-10):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(B, 3))
    m = m / np.linalg.norm(m, axis=-1, keepdims=True)
    spans = rng.uniform(lo, hi, B)
    current = rng.uniform(-cur, cur, B)
    return m.T.astype(dtype), spans.astype(dtype), current.astype(dtype)


def _params(p, dtype):
    cast = {k: np.asarray(v, dtype) for k, v in p.items()}
    return (
        JParams(**{k: jnp.asarray(v) for k, v in cast.items()}),
        LLGSParams(**{k: torch.tensor(v) for k, v in cast.items()}),
    )


def _run_both(m, spans, cur, params, dtype, method, max_substeps, jit=False):
    jp, tp = _params(params, dtype)
    with jax.disable_jit(not jit):
        ref = jax_integrate_pulse(
            tuple(jnp.asarray(c) for c in m), jnp.asarray(spans), jnp.asarray(cur), jp,
            JConfig(method=method, max_substeps=max_substeps),
        )
    out = integrate_pulse(
        tuple(torch.tensor(c) for c in m), torch.tensor(spans), torch.tensor(cur), tp,
        IntegratorConfig(method=method, max_substeps=max_substeps),
    )
    return out, ref


def _assert_close(out, ref_m, ref_n, ref_failed, dtype):
    tol = 1e-9 if dtype == np.float64 else 2e-6
    for c in range(3):
        got = out.m[c].numpy()
        assert got.dtype == dtype
        np.testing.assert_allclose(got, np.asarray(ref_m[c]), rtol=tol, atol=tol)
    np.testing.assert_array_equal(out.n_substeps.numpy(), np.asarray(ref_n))
    np.testing.assert_array_equal(out.failed.numpy(), np.asarray(ref_failed))


DTYPES = [np.float64, np.float32]
DTYPE_IDS = ["float64", "float32"]


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_substep_counts_bit_equal_on_boundaries(dtype):
    """Spans on and one ulp around the integer boundaries of span/dt0, on
    both sides of the span = 100 max_step switch of the dt law."""
    k = np.arange(1, 2001, dtype=np.float64)
    exact = np.concatenate([k * 1e-12, k * 1e-14, np.array([1e-10, 5e-9])]).astype(dtype)
    spans = np.concatenate([
        exact,
        np.nextafter(exact, np.asarray(np.inf, dtype)),
        np.nextafter(exact, np.asarray(0.0, dtype)),
    ])
    jdt, jn = jax_substep_counts(jnp.asarray(spans), 1e-12)
    tdt, tn = substep_counts(torch.tensor(spans), 1e-12)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tdt.numpy(), np.asarray(jdt))
    assert tn.dtype == torch.int32


def test_max_substeps_for_matches():
    from spintorque_tpu.physics import max_substeps_for as jax_max_substeps_for

    for d in (1e-12, 2e-10, 1e-9, 5e-9, 3.3e-8):
        assert max_substeps_for(d) == jax_max_substeps_for(d)
    assert max_substeps_for(5e-9) == 5001


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_plain_matches_xla_deterministic(method, dtype):
    m, spans, cur = _setup(64, 0, dtype)
    out, ref = _run_both(m, spans, cur, PARAMS, dtype, method, 512)
    _assert_close(out, ref.m, ref.n_substeps, ref.failed, dtype)
    np.testing.assert_array_equal(out.dt.numpy(), np.asarray(ref.dt))


@pytest.mark.parametrize("cur", [0.0, 200.0], ids=["precession", "stt"])
@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_plain_matches_jitted_xla_float64(method, cur):
    dtype = np.float64
    m, spans, cur = _setup(128, 2, dtype, cur=cur, hi=3e-10)
    out, ref = _run_both(m, spans, cur, PARAMS, dtype, method, 512, jit=True)
    _assert_close(out, ref.m, ref.n_substeps, ref.failed, dtype)


@pytest.mark.parametrize("B", [5, 200])
def test_plain_matches_pallas_interpret(B):
    dtype = np.float32
    m, spans, cur = _setup(B, 11, dtype)
    jp, tp = _params(PARAMS, dtype)
    with pltpu.force_tpu_interpret_mode():
        (px, py, pz), n, dt, failed = integrate_pulse_pallas(
            tuple(jnp.asarray(c) for c in m), jnp.asarray(spans), jnp.asarray(cur), jp,
            JConfig(method="rk4", max_substeps=256),
        )
    out = integrate_pulse(
        tuple(torch.tensor(c) for c in m), torch.tensor(spans), torch.tensor(cur), tp,
        IntegratorConfig(method="rk4", max_substeps=256),
    )
    _assert_close(out, (px, py, pz), n, failed, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_freeze_flags_match(dtype):
    """Half the envs at 1e6 A/m^2, half spread over 1e-4..1e3 A/m^2, where
    an RK4 substep's squared norm overflows (float32 near 1e-3, float64
    above ~60): the failed flags (the reference's freeze) must match the
    XLA path's exactly."""
    B = 128
    m, _, _ = _setup(B, 3, dtype)
    spans = np.full(B, 1e-10, dtype)
    cur = np.where(np.arange(B) % 2 == 0, 1e6, np.logspace(-4, 3, B)).astype(dtype)
    out, ref = _run_both(m, spans, cur, PARAMS, dtype, "rk4", 128)
    _assert_close(out, ref.m, ref.n_substeps, ref.failed, dtype)
    assert out.failed.any()


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_per_env_params_with_per_env_axis(dtype):
    B = 96
    rng = np.random.default_rng(99)
    m, spans, cur = _setup(B, 11, dtype)
    axes = rng.normal(size=(B, 3))
    params = dict(
        saturation_magnetization=rng.uniform(4e5, 1.2e6, B),
        damping=rng.uniform(0.005, 0.05, B),
        uniaxial_anisotropy=rng.uniform(3e5, 2e6, B),
        volume=rng.uniform(5e-24, 5e-23, B),
        polarization=rng.uniform(0.3, 0.9, B),
        easy_axis=axes / np.linalg.norm(axes, axis=-1, keepdims=True),
    )
    out, ref = _run_both(m, spans, cur, params, dtype, "rk4", 512)
    _assert_close(out, ref.m, ref.n_substeps, ref.failed, dtype)


def test_clamped_pulses_integrate_full_span():
    """n is clamped to max_substeps and dt recomputed from it."""
    dtype = np.float64
    m, spans, cur = _setup(16, 5, dtype, lo=1e-10, hi=4e-10)
    out, ref = _run_both(m, spans, cur, PARAMS, dtype, "heun", 64)
    assert int(out.n_substeps.max()) == 64
    _assert_close(out, ref.m, ref.n_substeps, ref.failed, dtype)
    np.testing.assert_array_equal(out.dt.numpy(), np.asarray(ref.dt))


def test_thermal_sigma_rides_with_env():
    """T = 0 envs integrate exactly as the deterministic loop; T = 500 K
    envs deviate."""
    B = 64
    m, spans, _ = _setup(B, 5, np.float32)
    m0 = tuple(torch.tensor(c) for c in m)
    cur = torch.full((B,), 150.0)
    temp = torch.where(torch.arange(B) % 2 == 0, 0.0, 500.0)
    _, tp = _params(PARAMS, np.float32)
    det = integrate_pulse(m0, torch.tensor(spans), cur, tp, IntegratorConfig(method="heun"))
    hot = integrate_pulse(
        m0, torch.tensor(spans), cur, tp,
        IntegratorConfig(method="heun", thermal=True, noise_mode="physical"),
        seed=42, temperature=temp,
    )
    cold = (torch.arange(B) % 2 == 0)
    for c in range(3):
        assert torch.equal(hot.m[c][cold], det.m[c][cold])
    assert (hot.m[2][~cold] - det.m[2][~cold]).abs().max() > 1e-5


def test_dispatch_and_config_errors():
    m, spans, cur = _setup(4, 1, np.float32)
    m0 = tuple(torch.tensor(c) for c in m)
    _, tp = _params(PARAMS, np.float32)
    args = (m0, torch.tensor(spans), torch.tensor(cur), tp)
    bf16 = integrate_pulse(*args, IntegratorConfig(bf16_rhs=True))  # runs the plain bf16 version
    assert all(torch.isfinite(x).all() and x.dtype == torch.float32 for x in bf16.m)
    with pytest.raises(ValueError):
        integrate_pulse(*args, IntegratorConfig(method="dop853"))
    with pytest.raises(ValueError):
        integrate_pulse(*args, IntegratorConfig(thermal=True))  # no seed
    with pytest.raises(ValueError):
        integrate_pulse(*args, IntegratorConfig(thermal=True, noise_mode="bogus"), seed=1)
    meta = tuple(torch.empty(4, device="meta") for _ in range(3))
    with pytest.raises(ValueError):
        integrate_pulse(meta, *args[1:], IntegratorConfig())
    # The kernel's wrapper takes only CUDA tensors; a CPU tensor raises
    # before anything is built.
    with pytest.raises(ValueError):
        integrate_pulse_cuda(*args, IntegratorConfig())
    # The CPU path is the plain version.
    a = integrate_pulse(*args, IntegratorConfig(method="euler"))
    b = integrate_pulse_plain(*args, IntegratorConfig(method="euler"))
    for x, y in zip(a.m, b.m):
        assert torch.equal(x, y)


def test_cuda_supported_gate():
    _, tp = _params(PARAMS, np.float32)
    cfg = IntegratorConfig(method="rk4")
    assert cuda_supported(tp, cfg, torch.float32)
    assert not cuda_supported(tp, cfg, torch.float64)
    assert cuda_supported(tp, cfg._replace(bf16_rhs=True), torch.float32)
    assert not cuda_supported(tp, IntegratorConfig(method="dop853"), torch.float32)
    assert cuda_supported(tp, IntegratorConfig(method="heun"), torch.float32)
    tilted = LLGSParams(**{**PARAMS, "easy_axis": torch.tensor([1.0, 0.0, 0.0])})
    assert cuda_supported(tilted, cfg, torch.float32)
    per_env = LLGSParams(**{**PARAMS, "easy_axis": torch.tensor([[0.6, 0.0, 0.8]] * 16)})
    assert cuda_supported(per_env, cfg, torch.float32)
    bad = LLGSParams(**{**PARAMS, "easy_axis": torch.zeros(3)})
    assert not cuda_supported(bad, cfg, torch.float32)
    assert is_plus_z(torch.tensor([0.0, 0.0, 1.0]))
    assert is_plus_z(torch.tensor([[0.0, 0.0, 2.0]] * 3))
    assert not is_plus_z(torch.tensor([0.0, 0.0, -1.0]))
    assert not is_plus_z(torch.tensor([[0.0, 0.0, 1.0], [0.6, 0.0, 0.8]]))
