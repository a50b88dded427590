"""The port's thermal-noise sampler (ops/philox.py), which the CUDA kernel
draws bit for bit the same.

Philox4x32-10 is held to Random123's published known-answer vectors, the
folded (cos, sin) of 2 pi u to the JAX package's ``_cos_sin_2pi`` and to
libm, the normals to the statistics the JAX package's Pallas sampler test
checks, and the thermal integrator to the JAX package's in distribution
(the two draw from different streams, so only distributions can agree).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from spintorque_tpu.ops.pallas_integrator import _cos_sin_2pi as jax_cos_sin_2pi
from spintorque_tpu.physics import IntegratorConfig as JConfig
from spintorque_tpu.physics import LLGSParams as JParams
from spintorque_tpu.physics import integrate_pulse as jax_integrate_pulse
from spintorque_tpu_torch.constants import KB_SOLVER, MU0
from spintorque_tpu_torch.ops import philox
from spintorque_tpu_torch.physics import IntegratorConfig, LLGSParams, integrate_pulse

torch.set_num_threads(1)

M32 = 0xFFFFFFFF


@pytest.mark.parametrize(
    "counter,key,expected",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((M32, M32, M32, M32), (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
    ids=["zeros", "ones", "pi"],
)
def test_philox_known_answers(counter, key, expected):
    words = philox.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in counter], key)
    assert tuple(int(w) for w in words) == expected


def test_mulhilo_matches_python_integers():
    rng = np.random.default_rng(0)
    b = np.concatenate([rng.integers(0, 2**32, 1000), [0, 1, M32, 2**31, 2**16 - 1]])
    for a in (philox.PHILOX_M0, philox.PHILOX_M1, M32):
        hi, lo = philox._mulhilo(a, torch.tensor(b, dtype=torch.int64))
        full = [a * int(x) for x in b]
        assert hi.tolist() == [p >> 32 for p in full]
        assert lo.tolist() == [p & M32 for p in full]


def test_seed_helpers():
    assert philox.seed_key(0x0123456789ABCDEF) == (0x89ABCDEF, 0x01234567)
    seeds = {philox.derive_seed(7, k) for k in range(1000)}
    assert len(seeds) == 1000 and all(0 <= s < 2**64 for s in seeds)
    assert philox.derive_seed(7, 3) == philox.derive_seed(7, 3)


def _grid():
    return np.concatenate([
        np.linspace(0.0, 1.0, 200_001, dtype=np.float64)[:-1],
        np.asarray([0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0 - 2**-24]),
    ]).astype(np.float32)


def test_cos_sin_2pi_matches_jax_and_libm():
    """The JAX package's accuracy bound (4e-7 absolute against libm over
    the whole domain, quadrant boundaries and the wrap at u -> 1 included),
    and agreement with its ``_cos_sin_2pi`` to float32 rounding."""
    u = _grid()
    c, s = philox.cos_sin_2pi(torch.tensor(u))
    jc, js = jax_cos_sin_2pi(jnp.asarray(u))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1.2e-7)
    theta = 2.0 * np.pi * u.astype(np.float64)
    assert np.abs(c.numpy().astype(np.float64) - np.cos(theta)).max() < 4e-7
    assert np.abs(s.numpy().astype(np.float64) - np.sin(theta)).max() < 4e-7
    norm = c.numpy().astype(np.float64) ** 2 + s.numpy().astype(np.float64) ** 2
    assert np.abs(norm - 1.0).max() < 1e-6


def test_uniform_from_bits_is_the_mantissa_rule():
    w = torch.tensor([0, 1, 0x7FFFFF, 0x800000, M32, 0x3F800001], dtype=torch.int64)
    u = philox.uniform_from_bits(w, torch.float32)
    ref = ((w.numpy() & 0x7FFFFF) | 0x3F800000).astype(np.uint32).view(np.float32) - 1.0
    np.testing.assert_array_equal(u.numpy(), ref)
    assert float(u.max()) < 1.0 and float(u.min()) == 0.0


def test_noise_statistics():
    """Moments, KS against N(0, 1) and half-to-half independence of 16384
    normals, with the bounds of the JAX package's Pallas sampler test."""
    normals = philox.substep_normals(
        1234, torch.arange(2048), torch.arange(2), 1, torch.float32
    ).numpy()  # (2, 4, 2048)
    samples = normals.ravel().astype(np.float64)
    n = samples.size
    assert n == 16384
    assert np.all(np.isfinite(samples))
    assert abs(samples.mean()) < 5.0 / math.sqrt(n)
    assert abs(samples.std() - 1.0) < 5.0 / math.sqrt(2 * n)
    assert abs(stats.skew(samples)) < 0.12
    assert abs(stats.kurtosis(samples)) < 0.25
    ks = stats.kstest(samples, "norm")
    assert ks.pvalue > 1e-4, f"KS test rejects normality: {ks}"
    # cos and sin halves of the same Box-Muller transforms are uncorrelated.
    cos_half = normals[:, 0::2].ravel()
    sin_half = normals[:, 1::2].ravel()
    assert abs(np.corrcoef(cos_half, sin_half)[0, 1]) < 0.05


def test_stream_depends_on_env_index_not_layout():
    """Counters carry the env's own index, so a subset or a reordering of
    the batch draws the same numbers for each env (the kernel's sort relies
    on it)."""
    full = philox.substep_normals(99, torch.arange(300), torch.arange(5), 3, torch.float64)
    idx = torch.tensor([299, 7, 150, 0])
    part = philox.substep_normals(99, idx, torch.arange(5), 3, torch.float64)
    assert torch.equal(part, full[..., idx])
    other = philox.substep_normals(100, idx, torch.arange(5), 3, torch.float64)
    assert not torch.equal(part, other)


MS, VOL, TEMP = 800e3, 1e-25, 300.0


def _strong_noise_params():
    """A small-barrier macrospin (Delta_eff = 1.5 kT) where the physical
    noise dominates the dynamics, as in the JAX package's Boltzmann gate."""
    kt = KB_SOLVER * TEMP
    k_u = 1.5 * kt / VOL + 0.5 * MU0 * MS**2
    return dict(
        saturation_magnetization=MS, damping=0.3, uniaxial_anisotropy=k_u,
        volume=VOL, polarization=0.7, easy_axis=np.array([0.0, 0.0, 1.0]),
    )


@pytest.mark.parametrize(
    "method,rk4_noise", [("heun", "per_stage"), ("rk4", "per_substep")], ids=["heun", "rk4"]
)
def test_thermal_matches_jax_in_distribution(method, rk4_noise):
    """Mean and variance of each final m component over B=4096 envs agree
    with the JAX package's within 5 standard errors."""
    B, dt, steps = 4096, 4e-13, 100
    span = dt * steps
    rng = np.random.default_rng(3)
    m = rng.normal(size=(B, 3))
    m = (m / np.linalg.norm(m, axis=-1, keepdims=True)).T.astype(np.float32)
    p = {k: np.asarray(v, np.float32) for k, v in _strong_noise_params().items()}
    kw = dict(method=method, max_step=dt, max_substeps=steps + 10, thermal=True,
              noise_mode="physical", rk4_noise=rk4_noise)
    ref = jax_integrate_pulse(
        tuple(jnp.asarray(c) for c in m), jnp.full((B,), span, jnp.float32),
        jnp.zeros((B,), jnp.float32), JParams(**{k: jnp.asarray(v) for k, v in p.items()}),
        JConfig(**kw), key=jax.random.PRNGKey(5), temperature=TEMP,
    )
    out = integrate_pulse(
        tuple(torch.tensor(c) for c in m), torch.full((B,), span), torch.zeros(B),
        LLGSParams(**{k: torch.tensor(v) for k, v in p.items()}), IntegratorConfig(**kw),
        seed=5, temperature=TEMP,
    )
    assert not bool(out.failed.any()) and not bool(np.asarray(ref.failed).any())
    for c in range(3):
        a = out.m[c].numpy().astype(np.float64)
        b = np.asarray(ref.m[c], np.float64)
        se_mean = math.sqrt(a.var() / B + b.var() / B)
        assert abs(a.mean() - b.mean()) < 5 * se_mean, (c, a.mean(), b.mean())
        # s.e. of a sample variance ~ sqrt((mu4 - var^2) / B)
        se_var = math.sqrt(
            (((a - a.mean()) ** 4).mean() - a.var() ** 2) / B
            + (((b - b.mean()) ** 4).mean() - b.var() ** 2) / B
        )
        assert abs(a.var() - b.var()) < 5 * se_var, (c, a.var(), b.var())
    # ...and the noise did move the state (it is not the deterministic run).
    det = integrate_pulse(
        tuple(torch.tensor(c) for c in m), torch.full((B,), span), torch.zeros(B),
        LLGSParams(**{k: torch.tensor(v) for k, v in p.items()}),
        IntegratorConfig(**{**kw, "thermal": False}),
    )
    assert (out.m[2] - det.m[2]).abs().mean() > 0.05
