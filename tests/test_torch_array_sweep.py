"""The array env's sequential sweep kernel (``ops/array_sweep.py``,
``csrc/array_sweep.cu``) on the CPU: the route each env takes, the C
interface, the plain version against the env method it was moved from, and
the kernel's source compiled for the host against the plain version.

There is no nvcc here, but the kernel's arithmetic and control flow are
plain C++: ``array_sweep.cu`` (up to its launch) and the flush it includes
from ``llgs_substep.cuh`` compile with the host's C++ compiler
(``-ffp-contract=off``, as the library builds with ``--fmad=false``), the
device qualifiers defined away, the intrinsics given host forms, and a host
loop runs the kernel body once for every (block, thread). It must give the
plain version's energies and every unmoved device's input bit for bit, and
each moved device within 1e-6: the CPU's PyTorch sums the einsum, the dot
and |m|^2 in its own orders and rounds sqrt its own way, where the kernel
follows the card's PyTorch. The same host build is held to the JAX
package's sequential sweep (its ``lax.scan`` inside the jitted
``SpinTorqueArrayEnv.step``, float32) on the same pattern and action: m
within 1e-6, the step energy within a relative 1e-6. The card tests
(``test_torch_array_sweep_cuda.py``) hold the built kernel to the plain
version on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import shutil
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from spintorque_tpu.envs.array import ArrayEnvConfig as JConfig
from spintorque_tpu.envs.array import SpinTorqueArrayEnv as JEnv

from spintorque_tpu_torch import convert
from spintorque_tpu_torch.constants import GAMMA, MU0
from spintorque_tpu_torch.devices.resistance import pulse_energy, resistance
from spintorque_tpu_torch.envs import ArrayEnvConfig, SpinTorqueArrayEnv
from spintorque_tpu_torch.envs import array as array_module
from spintorque_tpu_torch.ops import _build
from spintorque_tpu_torch.ops import array_sweep as aw
from spintorque_tpu_torch.physics.integrator import flush_subnormal
from spintorque_tpu_torch.utils.profiling import counter

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "spintorque_tpu_torch" / "csrc"
MODES = ("individual", "row", "column", "global")
COUPLINGS = ("dipolar", "exchange", "stray_field")
DEVICE_TYPES = ("stt_mram", "sot_mram", "vcma_mram")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _inputs(cfg: ArrayEnvConfig, B: int, seed: int, zero_share: float = 0.2):
    """A CPU env of ``cfg`` at B, its reset pattern and a decoded action
    (index uniform over the mode's range, I uniform +-2e6 with a share set
    to 0, dt uniform 1 ps-5 ns)."""
    env = SpinTorqueArrayEnv(batch_size=B, config=cfg, device="cpu")
    state, _ = env.reset(seed)
    rng = np.random.default_rng(seed)
    hi = {"individual": cfg.n_devices, "row": cfg.rows, "column": cfg.cols,
          "global": 1}[cfg.action_mode]
    act = np.stack([rng.integers(0, hi, B), rng.uniform(-2e6, 2e6, B),
                    rng.uniform(1e-12, 5e-9, B)], -1).astype(np.float32)
    act[rng.random(B) < zero_share, 1] = 0.0
    mask, current, duration = env._decode_action(torch.from_numpy(act))
    return env, state.pattern, mask, current, duration


def _args(env, pattern, mask, current, duration):
    return (pattern, mask, current, duration, env.coupling, env._easy_axis, env.device_params,
            env.config.device_type)


def _subnormal_poles(env, pattern, mask, current):
    """Rows 0-2 at the poles with subnormal transverse parts (either sign),
    row 3 with |J| at float32's 1e-12 and row 4 just above it."""
    least = float(np.finfo(np.float32).smallest_subnormal)
    pattern = pattern.clone()
    n = pattern.shape[1]
    signs = torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0)
    for b, (x, y) in enumerate(((1e-39, -3e-40), (-least, least), (-1e-45, 0.0))):
        pattern[b, :, 0], pattern[b, :, 1], pattern[b, :, 2] = x, y, signs
    current = current.clone()
    current[:3] = torch.tensor([2e6, -2e6, 1.5e6])
    threshold = torch.tensor(1e-12, dtype=torch.float32)
    current[3] = threshold
    current[4] = torch.nextafter(threshold, torch.tensor(1.0))
    return pattern, current


# ------------------------------------------------------------------- route


def test_sweep_route_is_the_kernel_only_for_float32_sequential_on_the_card(monkeypatch):
    probes = []
    monkeypatch.setattr(array_module, "cuda_kernel_available", lambda: probes.append(1) or True)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    base = ArrayEnvConfig()
    assert array_module.sweep_kernel_route(cuda, base)
    assert probes == [1]
    for device, cfg in ((cpu, base), (cuda, base._replace(dtype="bfloat16")),
                        (cuda, base._replace(dtype="float64")),
                        (cuda, base._replace(coupling_update="simultaneous"))):
        assert not array_module.sweep_kernel_route(device, cfg)
    assert probes == [1]  # no probe where the route is decided without it
    monkeypatch.setattr(array_module, "cuda_kernel_available", lambda: False)
    assert not array_module.sweep_kernel_route(cuda, base)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_envs_run_the_plain_version_and_count_it(dtype):
    cfg = ArrayEnvConfig(rows=2, cols=3, dtype=dtype)
    env = SpinTorqueArrayEnv(batch_size=4, config=cfg, device="cpu")
    assert env._sweep is aw.sequential_sweep_plain
    state, _ = env.reset(2)
    kernels, eager = counter("array.sweep_kernels").count, counter("array.sweep_eager").count
    action = torch.tensor([[1.0, 1e6, 1e-9]] * 4)
    for _ in range(3):
        state, _ = env.step(state, action)
    assert counter("array.sweep_eager").count == eager + 3
    assert counter("array.sweep_kernels").count == kernels


def test_simultaneous_envs_count_no_sequential_sweep():
    env = SpinTorqueArrayEnv(batch_size=4, device="cpu",
                             config=ArrayEnvConfig(rows=2, cols=2,
                                                   coupling_update="simultaneous"))
    state, _ = env.reset(2)
    eager = counter("array.sweep_eager").count
    env.step(state, torch.tensor([[1.0, 1e6, 1e-9]] * 4))
    assert counter("array.sweep_eager").count == eager


def test_the_kernel_wrapper_raises_on_cpu_tensors():
    env, pattern, mask, current, duration = _inputs(ArrayEnvConfig(rows=2, cols=2), 4, 1)
    before = counter("array.sweep_kernels").count
    with pytest.raises(ValueError, match="CUDA tensors; pattern"):
        aw.sequential_sweep(*_args(env, pattern, mask, current, duration))
    assert counter("array.sweep_kernels").count == before


# ----------------------------------------------------------- C interface


def test_bind_knows_the_sweep_entry_point():
    from spintorque_tpu_torch.utils import compare_kernel_sources as cks

    names = ["spintorque_pulse_integrate", "spintorque_probe_add_one", "spintorque_check_div6",
             "spintorque_check_bf16_ops", "spintorque_op_chain", "spintorque_array_sweep"]
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in names})
    _build._bind(lib)
    c = ctypes
    assert lib.spintorque_array_sweep.argtypes == (
        [c.c_void_p] * 11 + [c.c_int, c.c_int, c.c_float, c.c_float, c.c_void_p])
    assert lib.spintorque_array_sweep.restype is c.c_int
    # A base checkout older than the kernel still binds for the comparison.
    assert "spintorque_array_sweep" in cks.BASE_MAY_LACK
    del lib.spintorque_array_sweep
    _build._bind(lib, optional=cks.BASE_MAY_LACK)
    with pytest.raises(AttributeError, match="spintorque_array_sweep"):
        _build._bind(lib)


# ----------------------------------- the plain version against the old method


class _OldMethod:
    """``SpinTorqueArrayEnv._sequential_sweep`` and its helpers as
    ``envs/array.py`` had them before the kernel, verbatim but for
    ``self``'s attributes read from the env."""

    def __init__(self, env):
        self.config = env.config
        self.device_params = env.device_params
        self.coupling = env.coupling
        self._easy_axis = env._easy_axis
        self._p_hat = torch.tensor([0.0, 0.0, 1.0], dtype=env.config.torch_dtype)

    def _anisotropy_field(self):
        p = self.device_params
        return 2.0 * p.uniaxial_anisotropy / (MU0 * p.saturation_magnetization)

    def _device_field(self, pattern, d):
        e = self._easy_axis
        cos_t = pattern[:, d, :] @ e
        h = self._anisotropy_field() * cos_t[:, None] * e[None, :]
        return h + torch.einsum("n,bnc->bc", self.coupling[d], pattern)

    def _device_update(self, m, h_eff, current, duration):
        def norm(v):
            return torch.sqrt((v * v).sum(-1, keepdim=True))

        def cross(a, b):
            return torch.linalg.cross(a, b, dim=-1)

        tau = 0.1 * current[:, None] * cross(m, cross(m, self._p_hat.expand_as(m)))
        dmdt = -GAMMA * cross(m, h_eff)
        dmdt = dmdt + 0.01 * cross(m, dmdt)
        dmdt = dmdt + tau
        dt = (duration / 10.0)[:, None]
        out = m
        for _ in range(10):
            out = out + dmdt * dt
            out = out / norm(out)
        return torch.where((current.abs() > 1e-12)[:, None], out, m)

    def _sequential_sweep(self, pattern, mask, current, duration):
        cfg = self.config
        held = pattern
        pattern = flush_subnormal(pattern)
        energy = torch.zeros_like(current)
        for d in range(cfg.n_devices):
            m_d = pattern[:, d, :]
            h = self._device_field(pattern, d)
            m_new = self._device_update(m_d, h, current, duration)
            active = mask[:, d]
            m_out = torch.where(active[:, None], m_new, m_d)
            r = resistance(cfg.device_type, m_d[:, 0], m_d[:, 1], m_d[:, 2], self.device_params)
            e = pulse_energy(current, duration, r, self.device_params.area)
            energy = energy + torch.where(active, e, 0.0)
            pattern[:, d, :] = m_out
        moved = mask & (current.abs() > 1e-12)[:, None]
        return torch.where(moved[..., None], pattern, held), energy


PLAIN_CASES = (
    [dict(action_mode=m, coupling_type=c) for m in MODES for c in COUPLINGS]
    + [dict(device_type=t) for t in DEVICE_TYPES[1:]]
    + [dict(rows=3, cols=5, dtype="float64"), dict(rows=2, cols=2, dtype="bfloat16"),
       dict(include_coupling=False)]
)


@pytest.mark.parametrize("over", PLAIN_CASES, ids=lambda o: "-".join(map(str, o.values())))
def test_plain_version_gives_the_old_methods_bits(over):
    cfg = ArrayEnvConfig(**over)
    env, pattern, mask, current, duration = _inputs(cfg, 37, 5)
    if cfg.dtype == "float32":
        pattern, current = _subnormal_poles(env, pattern, mask, current)
    got = aw.sequential_sweep_plain(*_args(env, pattern, mask, current, duration))
    want = _OldMethod(env)._sequential_sweep(pattern, mask, current, duration)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.view(torch.uint8), w.view(torch.uint8))


# ---------------------------------------- the kernel's source on the host

PRELUDE = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct HostIndex { unsigned x = 0, y = 0, z = 0; };
static HostIndex threadIdx, blockIdx;
static inline float __ldg(const float* p) { return *p; }
static inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
static inline float __uint_as_float(uint32_t b) { float f; memcpy(&f, &b, 4); return f; }
static inline uint32_t __float_as_uint(float f) { uint32_t b; memcpy(&b, &f, 4); return b; }
namespace spintorque {
"""

DRIVER = r"""
// The launch as a host loop: every (block, thread) of the grid in turn.
extern "C" void host_array_sweep(const float* pattern, const uint8_t* mask, const float* current,
                                 const float* duration, const float* energies,
                                 const float* coupling, const float* easy_axis,
                                 const float* anisotropy, const float* saturation, float* out,
                                 float* energy, int batch, int n, float neg_gamma, float mu0) {
  using namespace spintorque;
  const SweepArgs a{pattern, mask, current, duration, energies, coupling, easy_axis,
                    anisotropy, saturation, out, energy, batch, n, neg_gamma, mu0};
  for (int b = 0; b < (batch + kSweepBlock - 1) / kSweepBlock; ++b) {
    for (int t = 0; t < kSweepBlock; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      array_sweep_kernel(a);
    }
  }
}
"""


def _host_source() -> str:
    header = (CSRC / "llgs_substep.cuh").read_text()
    start = header.index("// x * +0 for a finite x, the zero of x's sign")
    zero_of = header[start:header.index("template <typename T>\nstruct Coeffs {", start)]
    start = header.index("__device__ __forceinline__ float flush_subnormal(float x) {")
    flush = header[start:header.index("}\n", start) + 2]
    text = (CSRC / "array_sweep.cu").read_text()
    body = text[text.index("namespace spintorque {") + len("namespace spintorque {"):
                text.index('extern "C" int spintorque_array_sweep')]
    return PRELUDE + zero_of + flush + body + DRIVER


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        pytest.skip("needs a host C++ compiler")
    tmp = tmp_path_factory.mktemp("array_sweep")
    src, lib = tmp / "array_sweep_host.cpp", tmp / "array_sweep_host.so"
    src.write_text(_host_source())
    subprocess.run([compiler, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    str(src), "-o", str(lib)], check=True, capture_output=True, text=True,
                   timeout=180)
    fn = ctypes.CDLL(str(lib)).host_array_sweep
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                            ctypes.c_float]
    fn.restype = None

    def sweep(pattern, mask, current, duration, coupling, easy_axis, params, device_type):
        """``sequential_sweep``'s host side, with the host loop as its launch."""
        flushed = flush_subnormal(pattern)
        r = resistance(device_type, flushed[..., 0], flushed[..., 1], flushed[..., 2], params)
        energies = pulse_energy(current[:, None], duration[:, None], r, params.area).contiguous()
        out, energy = torch.empty_like(pattern), torch.empty_like(current)
        mask = mask.contiguous()
        fn(pattern.data_ptr(), mask.data_ptr(), current.data_ptr(), duration.data_ptr(),
           energies.data_ptr(), coupling.data_ptr(), easy_axis.data_ptr(),
           params.uniaxial_anisotropy.data_ptr(), params.saturation_magnetization.data_ptr(),
           out.data_ptr(), energy.data_ptr(), pattern.shape[0], pattern.shape[1], -GAMMA, MU0)
        return out, energy

    return sweep


HOST_CASES = (
    [((4, 4), m, c, "stt_mram", 67) for m in MODES for c in COUPLINGS]
    + [((4, 4), "individual", "dipolar", t, 67) for t in DEVICE_TYPES[1:]]
    + [(s, "individual", "dipolar", "stt_mram", B)
       for s in ((1, 1), (2, 2), (3, 5), (8, 8)) for B in (1, 130)]
    + [((5, 5), "global", "exchange", "sot_mram", 9)]
)


@pytest.mark.parametrize("shape,mode,coupling,device_type,B", HOST_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_kernel_source_on_the_host_matches_the_plain_version(host_kernel, shape, mode, coupling,
                                                             device_type, B):
    cfg = ArrayEnvConfig(rows=shape[0], cols=shape[1], action_mode=mode, coupling_type=coupling,
                         device_type=device_type)
    env, pattern, mask, current, duration = _inputs(cfg, B, 7)
    if B >= 5:
        pattern, current = _subnormal_poles(env, pattern, mask, current)
    args = _args(env, pattern, mask, current, duration)
    out, energy = host_kernel(*args)
    want_out, want_energy = aw.sequential_sweep_plain(*args)
    moved = mask & (current.abs() > 1e-12)[:, None]
    assert torch.equal(_bits(energy), _bits(want_energy))
    assert torch.equal(_bits(out[~moved]), _bits(pattern[~moved]))
    assert float((out - want_out).abs().max()) <= 1e-6
    if moved.any():  # the harness swept something
        assert not torch.equal(out[moved], pattern[moved])
    if B >= 5:  # the subnormal poles stayed exactly at their poles
        assert torch.equal(_bits(out[:3, :, :2]), _bits(want_out[:3, :, :2]))
        assert torch.equal(out[:3, :, 2].abs(), torch.ones_like(out[:3, :, 2]))


JAX_CASES = (
    [((4, 4), m, c, "stt_mram") for m, c in zip(MODES, COUPLINGS + ("dipolar",))]
    + [((4, 4), "individual", "dipolar", t) for t in DEVICE_TYPES[1:]]
    + [((3, 5), "row", "exchange", "stt_mram"), ((8, 8), "individual", "dipolar", "stt_mram")]
)


def _jax_state_to_numpy(js):
    leaves = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    stats = leaves.pop("reward_stats")
    d = jax.tree.map(np.asarray, leaves)
    d["reward_stats"] = {
        name: jax.tree.map(np.asarray,
                           {f.name: getattr(st, f.name) for f in dataclasses.fields(st)})
        for name, st in stats.items()}
    return d


@pytest.mark.parametrize("shape,mode,coupling,device_type", JAX_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_kernel_source_on_the_host_matches_the_jax_sweep(host_kernel, shape, mode, coupling,
                                                         device_type):
    kw = dict(rows=shape[0], cols=shape[1], action_mode=mode, coupling_type=coupling,
              device_type=device_type, dtype="float32", autoreset=False)
    B = 67
    jenv = JEnv(batch_size=B, config=JConfig(**kw))
    jstate, _ = jenv.reset(jax.random.PRNGKey(3))
    env = SpinTorqueArrayEnv(batch_size=B, config=ArrayEnvConfig(**kw), device="cpu")
    pattern = convert.array_state_from_numpy(_jax_state_to_numpy(jstate), device="cpu").pattern
    rng = np.random.default_rng(4)
    hi = {"individual": env.config.n_devices, "row": shape[0], "column": shape[1],
          "global": 1}[mode]
    action = np.stack([rng.integers(0, hi, B), rng.uniform(-2e6, 2e6, B),
                       rng.uniform(1e-12, 5e-9, B)], -1).astype(np.float32)
    action[rng.random(B) < 0.2, 1] = 0.0
    mask, current, duration = env._decode_action(torch.from_numpy(action))
    out, energy = host_kernel(*_args(env, pattern.contiguous(), mask, current, duration))
    jnext, jts = jenv.step(jstate, jnp.asarray(action))
    want, want_energy = np.asarray(jnext.pattern), np.asarray(jts.info["step_energy"])
    assert want.dtype == np.float32 and want_energy.dtype == np.float32
    moved = (mask & (current.abs() > 1e-12)[:, None]).numpy()
    assert moved.any() and not np.array_equal(want[moved], pattern.numpy()[moved])
    assert float(np.abs(out.numpy() - want).max()) <= 1e-6
    np.testing.assert_allclose(energy.numpy(), want_energy, rtol=1e-6, atol=0.0)
