"""The random-policy rollout of the JAX package's end-to-end training
workflow (``tests/e2e/test_training_workflow.py::test_random_policy_training_loop``)
on the port, on the CPU: B=32 envs of the fixture's STT-MRAM device, thermal
off, 40 steps of ``parallel.random_policy`` through ``parallel.rollout``,
summarized by ``parallel.summarize``. The JAX key becomes a
``torch.Generator``; the policy draws from torch's stream, so the rollout is
held to the JAX test's own assertions, not to JAX's numbers. The workflow's
other tests are in ``tests/test_torch_training_workflow.py``.
"""

import torch

from tests.fixtures.device_configs import get_device_config

from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu_torch.parallel import random_policy, rollout, summarize

torch.set_num_threads(1)


def test_random_policy_training_loop():
    """Random-policy rollout produces sane statistics end to end."""
    env = SpinTorqueEnv(
        batch_size=32,
        device_params=get_device_config("stt_mram"),
        config=SpinTorqueEnvConfig(include_thermal=False, max_duration=1e-9,
                                   max_steps=20, dtype="float32"),
        device="cpu",
    )
    state, obs = env.reset(0)
    state, obs, traj = rollout(env, random_policy(env), None, state, obs,
                               torch.Generator().manual_seed(1), num_steps=40)
    stats = summarize(traj)
    assert int(stats["episodes"]) > 0  # auto-reset cycled episodes
    assert 0.0 <= float(stats["success_rate"]) <= 1.0
