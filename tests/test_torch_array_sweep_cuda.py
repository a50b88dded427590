"""The array env's sequential sweep kernel (``csrc/array_sweep.cu`` via
``ops/array_sweep.py``) against its plain version, on the card.

Every test here carries the ``cuda`` marker and skips where torch sees no
CUDA device. This file imports no JAX; run it on a GPU machine with

    python -m pytest --noconftest -p no:cacheprovider -s -m cuda -q \
        tests/test_torch_array_sweep_cuda.py

The kernel takes the plain version's op order, and where PyTorch leaves
the order open (the cross products' contraction, the dot with the easy
axis, the coupling einsum, |m|^2) the one PyTorch 2.11 takes on an H100,
where every case here is bit for bit. Another PyTorch or cuBLAS may take
others, so a moved device is held to 1e-6, and each test prints its
largest difference and share of equal bits. The step energies and every
device the sweep does not move (unflushed, signed zeros included) must be
equal in bits.
"""

import numpy as np
import pytest
import torch

from spintorque_tpu_torch.envs import ArrayEnvConfig, SpinTorqueArrayEnv
from spintorque_tpu_torch.ops import array_sweep as aw
from spintorque_tpu_torch.ops import cuda_integrator as ci
from spintorque_tpu_torch.utils.profiling import counter

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

M_TOL = 1e-6
MODES = ("individual", "row", "column", "global")
COUPLINGS = ("dipolar", "exchange", "stray_field")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert ci.cuda_kernel_available()
    return torch.device("cuda")


def _bits(x):
    return x.contiguous().view(torch.int32)


def _inputs(cfg, B, seed, device, zero_share=0.1):
    env = SpinTorqueArrayEnv(batch_size=B, config=cfg, device=device)
    assert env._sweep is aw.sequential_sweep
    state, _ = env.reset(seed)
    rng = np.random.default_rng(seed)
    hi = {"individual": cfg.n_devices, "row": cfg.rows, "column": cfg.cols,
          "global": 1}[cfg.action_mode]
    act = np.stack([rng.integers(0, hi, B), rng.uniform(-2e6, 2e6, B),
                    rng.uniform(1e-12, 5e-9, B)], -1).astype(np.float32)
    act[rng.random(B) < zero_share, 1] = 0.0
    mask, current, duration = env._decode_action(torch.from_numpy(act).to(device))
    return env, state.pattern, mask, current, duration


def _args(env, pattern, mask, current, duration):
    return (pattern, mask, current, duration, env.coupling, env._easy_axis, env.device_params,
            env.config.device_type)


def _compare(label, env, pattern, mask, current, duration):
    """Kernel against plain version on the same inputs; returns the largest
    |difference| of a moved device's component."""
    args = _args(env, pattern, mask, current, duration)
    launches = counter("array.sweep_kernels").count
    out, energy = aw.sequential_sweep(*args)
    assert counter("array.sweep_kernels").count == launches + 1
    want_out, want_energy = aw.sequential_sweep_plain(*args)
    torch.cuda.synchronize()
    moved = mask & (current.abs() > 1e-12)[:, None]
    assert torch.equal(_bits(energy), _bits(want_energy)), label
    assert torch.equal(_bits(out[~moved]), _bits(pattern[~moved])), label
    diff = float((out - want_out).abs().max())
    equal = float((_bits(out) == _bits(want_out)).float().mean())
    print(f"array sweep {label}: kernel vs plain m {diff:.3g}, {equal:.4f} of components "
          f"equal in bits; energies equal in bits")
    assert diff <= M_TOL, label
    return diff


@pytest.mark.parametrize("coupling", COUPLINGS)
@pytest.mark.parametrize("mode", MODES)
def test_every_action_mode_and_coupling(cuda, mode, coupling):
    cfg = ArrayEnvConfig(action_mode=mode, coupling_type=coupling)
    _compare(f"4x4 {mode} {coupling} B=4096", *_inputs(cfg, 4096, 3, cuda))


@pytest.mark.parametrize("device_type", ["stt_mram", "sot_mram", "vcma_mram"])
def test_every_device_type(cuda, device_type):
    cfg = ArrayEnvConfig(device_type=device_type)
    _compare(f"4x4 {device_type} B=4096", *_inputs(cfg, 4096, 4, cuda))


@pytest.mark.parametrize("B", [1, 4096, 4099])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 4), (3, 5), (8, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_shape_and_batch(cuda, shape, B):
    cfg = ArrayEnvConfig(rows=shape[0], cols=shape[1])
    _compare(f"{shape[0]}x{shape[1]} B={B}", *_inputs(cfg, B, 5, cuda))


@pytest.mark.parametrize("mode", ["individual", "global"])
def test_subnormal_poles_zero_current_and_the_threshold(cuda, mode):
    """Rows at the poles with subnormal transverse parts of either sign
    stay at their poles with the plain version's signed zeros; rows at zero
    current and at |J| = float32(1e-12) keep their unflushed input; the row
    just above the threshold moves."""
    cfg = ArrayEnvConfig(action_mode=mode)
    env, pattern, mask, current, duration = _inputs(cfg, 4096, 6, cuda)
    least = float(np.finfo(np.float32).smallest_subnormal)
    n = cfg.n_devices
    pattern = pattern.clone()
    signs = torch.where(torch.arange(n, device=cuda) % 2 == 0, 1.0, -1.0)
    for b, (x, y) in enumerate(((1e-39, -3e-40), (-least, least), (-1e-45, 0.0), (0.0, -0.0))):
        pattern[b, :, 0], pattern[b, :, 1], pattern[b, :, 2] = x, y, signs
    threshold = torch.tensor(1e-12, dtype=torch.float32, device=cuda)
    current = current.clone()
    current[:4] = torch.tensor([2e6, -2e6, 1.5e6, -1e6], device=cuda)
    current[4:6] = torch.tensor([0.0, -0.0], device=cuda)
    current[6] = threshold
    current[7] = -threshold
    current[8] = torch.nextafter(threshold, torch.ones_like(threshold))
    args = _args(env, pattern, mask, current, duration)
    out, _ = aw.sequential_sweep(*args)
    want, _ = aw.sequential_sweep_plain(*args)
    assert torch.equal(_bits(out[:4]), _bits(want[:4]))
    assert torch.equal(out[:4, :, 2].abs(), torch.ones_like(out[:4, :, 2]))
    assert torch.equal(_bits(out[4:8]), _bits(pattern[4:8]))
    assert not torch.equal(out[8][mask[8]], pattern[8][mask[8]])
    _compare(f"4x4 {mode} subnormal poles and thresholds", env, pattern, mask, current, duration)


def test_200_steps_of_the_array_cell_traffic(cuda):
    """SpinTorqueArray-v0 at B=4096 as ``array-4x4`` drives it (index
    uniform over the 16 devices, I uniform +-2e6, dt uniform 1 ps-5 ns,
    auto-reset): each step from the same state through the kernel's env
    and through one on the plain version, then on from the kernel's."""
    B = 4096
    kernel_env = SpinTorqueArrayEnv(batch_size=B, device=cuda)
    plain_env = SpinTorqueArrayEnv(batch_size=B, device=cuda)
    plain_env._sweep = aw.sequential_sweep_plain
    state, _ = kernel_env.reset(2**31 + 7)
    g = torch.Generator(device=cuda).manual_seed(11)
    worst = dict(m=0.0, energy=0.0, obs=0.0, reward=0.0)
    launches = counter("array.sweep_kernels").count
    for _ in range(200):
        u = torch.rand((3, B), generator=g, device=cuda)
        action = torch.stack([torch.floor(u[0] * 16), -2e6 + 4e6 * u[1],
                              1e-12 + (5e-9 - 1e-12) * u[2]], -1)
        nxt, ts = kernel_env.step(state, action)
        _, want = plain_env.step(state, action)
        for key, got, ref in (("m", ts.info["final_observation"][..., :3],
                               want.info["final_observation"][..., :3]),
                              ("energy", ts.info["step_energy"], want.info["step_energy"]),
                              ("obs", ts.obs, want.obs), ("reward", ts.reward, want.reward)):
            diff = (got - ref).abs().max()
            if key == "energy":
                diff = diff / ref.abs().max().clamp_min(1e-30)
            worst[key] = max(worst[key], float(diff))
        assert torch.equal(ts.terminated, want.terminated)
        state = nxt
    assert counter("array.sweep_kernels").count == launches + 200
    print("array-4x4 traffic, 200 steps, kernel vs plain (energy relative): "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    assert worst["m"] <= M_TOL and worst["obs"] <= M_TOL and worst["energy"] == 0.0
    assert worst["reward"] <= 1e-4


def test_the_env_counts_one_launch_a_step(cuda):
    env = SpinTorqueArrayEnv(batch_size=64, device=cuda)
    state, _ = env.reset(1)
    kernels, eager = counter("array.sweep_kernels").count, counter("array.sweep_eager").count
    for _ in range(5):
        state, _ = env.step(state, torch.tensor([[3.0, 1e6, 1e-9]] * 64, device=cuda))
    assert counter("array.sweep_kernels").count == kernels + 5
    assert counter("array.sweep_eager").count == eager


def test_a_bf16_env_on_the_card_runs_the_plain_version(cuda):
    env = SpinTorqueArrayEnv(batch_size=8, device=cuda, config=ArrayEnvConfig(dtype="bfloat16"))
    assert env._sweep is aw.sequential_sweep_plain
    state, _ = env.reset(1)
    kernels, eager = counter("array.sweep_kernels").count, counter("array.sweep_eager").count
    env.step(state, torch.tensor([[3.0, 1e6, 1e-9]] * 8, device=cuda))
    assert counter("array.sweep_kernels").count == kernels
    assert counter("array.sweep_eager").count == eager + 1


def test_the_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    env, pattern, mask, current, duration = _inputs(ArrayEnvConfig(), 64, 8, cuda)
    good = dict(pattern=pattern, mask=mask, current=current, duration=duration)
    bad = [
        ("CUDA tensors; pattern", dict(pattern=pattern.cpu())),
        ("CUDA tensors; mask", dict(mask=mask.cpu())),
        ("float32 pattern", dict(pattern=pattern.double())),
        ("bool mask", dict(mask=mask.to(torch.uint8))),
        ("float32 current", dict(current=current.half())),
        ("contiguous pattern", dict(pattern=pattern.transpose(0, 1).contiguous().transpose(0, 1))),
        ("contiguous current", dict(current=torch.stack([current, current], -1)[:, 0])),
        ("nonempty", dict(pattern=pattern[..., :0].reshape(64, 0, 3))),
        ("(B, N, 3)", dict(pattern=pattern[..., :2].contiguous())),
        ("mask has shape", dict(mask=mask[:, :8].contiguous())),
        ("duration has shape", dict(duration=duration[:32])),
    ]
    launches = counter("array.sweep_kernels").count
    for match, change in bad:
        kw = {**good, **change}
        with pytest.raises(ValueError, match=match.replace("(", r"\(").replace(")", r"\)")):
            aw.sequential_sweep(kw["pattern"], kw["mask"], kw["current"], kw["duration"],
                                env.coupling, env._easy_axis, env.device_params, "stt_mram")
    with pytest.raises(ValueError, match="coupling has shape"):
        aw.sequential_sweep(pattern, mask, current, duration, env.coupling[:8, :8].contiguous(),
                            env._easy_axis, env.device_params, "stt_mram")
    assert counter("array.sweep_kernels").count == launches


def test_the_sweep_replays_in_a_cuda_graph(cuda):
    """The wrapper reads nothing back and synchronizes nothing: a captured
    sweep replays with the eager call's bits."""
    env, pattern, mask, current, duration = _inputs(ArrayEnvConfig(), 4096, 9, cuda)
    args = _args(env, pattern, mask, current, duration)
    want = aw.sequential_sweep(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        aw.sequential_sweep(*args)  # warm-up on the side stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = aw.sequential_sweep(*args)
    graph.replay()
    torch.cuda.synchronize()
    for g_, w in zip(got, want):
        assert torch.equal(_bits(g_), _bits(w))
