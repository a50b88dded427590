"""The port's measurement program (utils/benchmark.py) runs end to end.

On the CPU this is a smoke run of the control flow at B=8, n_inner=2; rates
measured here are CPU numbers and say nothing about the GPU.
"""

import pytest
import torch

from spintorque_tpu_torch.envs import SpinTorqueEnv
from spintorque_tpu_torch.utils import measure_env_throughput

torch.set_num_threads(1)


def _env(**kw):
    return SpinTorqueEnv(batch_size=8, device="cpu", max_duration=1e-10, **kw)


def test_measure_env_throughput_cpu_smoke():
    rates, steps = measure_env_throughput(_env(), n_inner=2, warmup=1, blocks=2, iters_per_block=1)
    assert steps == 1 * 2 * 8
    assert len(rates) == 2 and all(r > 0 for r in rates)


def test_measure_env_throughput_final_obs_and_custom_actions():
    env = _env(action_mode="discrete")
    calls = []

    def make_action(generator, batch_size):
        calls.append(batch_size)
        return torch.randint(0, env.num_actions, (batch_size,), generator=generator)

    rates, steps, obs = measure_env_throughput(
        env, n_inner=2, warmup=0, blocks=1, iters_per_block=2,
        make_action=make_action, return_final=True,
    )
    assert obs.shape == (8, env.observation_size) and torch.isfinite(obs).all()
    assert calls == [8] * 4 and steps == 32


def test_sync_debug_mode_needs_a_cuda_env():
    with pytest.raises(ValueError):
        measure_env_throughput(_env(), n_inner=1, warmup=0, sync_debug_mode="error")


def test_headline_scan_length_matches_production_rollout():
    """The measured program's 16-step block is the production PPO rollout
    length (tests/unit/test_bench_harness.py): the two cannot drift apart."""
    import inspect

    from spintorque_tpu_torch.rl import PPOConfig

    default_n_inner = inspect.signature(measure_env_throughput).parameters["n_inner"].default
    assert default_n_inner == PPOConfig().rollout_steps == 16
