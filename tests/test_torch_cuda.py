"""The CUDA pulse kernel against its plain version, on the card.

Every test here carries the ``cuda`` marker and skips where torch sees no
CUDA device. This file imports no JAX, so it also runs where the JAX
package is not installed; run it on a GPU machine with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Deterministic results must agree at rtol/atol 2e-6 with n_substeps and
failed identical (the kernel is built with --fmad=false and mirrors the
plain version op for op, so they usually agree to the bit).
"""

import pytest
import torch

from spintorque_tpu_torch.envs import SpinTorqueEnv
from spintorque_tpu_torch.ops import cuda_integrator as ci
from spintorque_tpu_torch.physics import IntegratorConfig, LLGSParams, integrate_pulse
from spintorque_tpu_torch.physics import integrate_pulse_plain
from spintorque_tpu_torch.utils import measure_env_throughput

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert ci.cuda_kernel_available()
    return torch.device("cuda")


def _params(device, axis=(0.0, 0.0, 1.0)):
    vals = dict(saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
                volume=1e-23, polarization=0.7)
    p = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in vals.items()}
    return LLGSParams(**p, easy_axis=torch.tensor(axis, dtype=torch.float32, device=device))


def _setup(B, device, seed=0, cur=200.0):
    g = torch.Generator().manual_seed(seed)
    m = torch.randn(B, 3, generator=g, dtype=torch.float64)
    m = m / m.norm(dim=-1, keepdim=True)
    spans = 5e-11 + 2.5e-10 * torch.rand(B, generator=g, dtype=torch.float64)
    current = cur * (2 * torch.rand(B, generator=g, dtype=torch.float64) - 1)

    def f(x):
        return x.float().to(device).contiguous()

    return (f(m[:, 0]), f(m[:, 1]), f(m[:, 2])), f(spans), f(current)


def _assert_close(a, b, tol=2e-6):
    for x, y in zip(a.m, b.m):
        torch.testing.assert_close(x, y, rtol=tol, atol=tol)
    assert torch.equal(a.n_substeps, b.n_substeps)
    assert torch.equal(a.failed, b.failed)


@pytest.mark.parametrize("axis", [(0.0, 0.0, 1.0), (0.6, 0.0, 0.8)], ids=["plus_z", "tilted"])
@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_kernel_matches_plain_deterministic(cuda, method, axis):
    m0, spans, cur = _setup(200, cuda)
    p = _params(cuda, axis)
    cfg = IntegratorConfig(method=method, max_substeps=256)
    _assert_close(integrate_pulse(m0, spans, cur, p, cfg),
                  integrate_pulse_plain(m0, spans, cur, p, cfg))


@pytest.mark.parametrize(
    "cfg",
    [
        IntegratorConfig(method="rk4", max_substeps=256, thermal=True, rk4_noise="per_substep"),
        IntegratorConfig(method="rk4", max_substeps=256, thermal=True, rk4_noise="per_stage"),
        IntegratorConfig(method="heun", max_substeps=256, thermal=True, noise_mode="physical"),
    ],
    ids=["rk4_per_substep", "rk4_per_stage", "heun_physical"],
)
def test_kernel_matches_plain_thermal(cuda, cfg):
    """Same Philox stream: only the card's logf and the plain version's log
    may differ in the last bit, so 1e-5 bounds the difference."""
    m0, spans, cur = _setup(512, cuda, seed=3)
    p = _params(cuda)
    _assert_close(integrate_pulse(m0, spans, cur, p, cfg, seed=77),
                  integrate_pulse_plain(m0, spans, cur, p, cfg, seed=77), tol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    m0, spans, cur = _setup(8, cuda)
    p = _params(cuda)
    cfg = IntegratorConfig(max_substeps=64)
    with pytest.raises(TypeError):
        integrate_pulse(tuple(x.double() for x in m0), spans.double(), cur.double(),
                        p.to(dtype=torch.float64), cfg)
    with pytest.raises(NotImplementedError):
        integrate_pulse(m0, spans, cur, p, cfg._replace(bf16_rhs=True))
    with pytest.raises(ValueError):
        integrate_pulse(m0, spans, cur, p, cfg._replace(method="dop853"))
    strided = torch.stack(m0, -1)
    with pytest.raises(ValueError):
        integrate_pulse((strided[:, 0], strided[:, 1], strided[:, 2]), spans, cur, p, cfg)
    with pytest.raises(ValueError):
        integrate_pulse(m0, spans.cpu(), cur, p, cfg)


def test_env_step_launches_the_kernel_without_host_sync(cuda):
    env = SpinTorqueEnv(batch_size=256, device=cuda, max_duration=1e-10)
    before = ci.PULSE_LAUNCHES.count
    measure_env_throughput(env, n_inner=4, warmup=1, blocks=1, iters_per_block=1,
                           sync_debug_mode="error")
    assert ci.PULSE_LAUNCHES.count - before == 8
    with pytest.raises(ValueError):
        SpinTorqueEnv(batch_size=4, device=cuda, dtype="float64")
