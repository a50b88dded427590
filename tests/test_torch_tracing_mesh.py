"""The mesh's counters and spans on two gloo ranks: a train step issues the
collectives it should, each inside ``mesh.all_reduce`` under the trainer's
phase that asked for it, and ``mesh.initialize`` is recorded with tracing
off. One spawn of two ranks serves every test."""

from __future__ import annotations

import pytest
import torch

from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu_torch.parallel import make_mesh, spawn_ranks
from spintorque_tpu_torch.rl import PPOConfig, PPOTrainer
from spintorque_tpu_torch.utils.profiling import PROFILER, tracing

W = 2
CONFIG = PPOConfig(rollout_steps=2, hidden_sizes=(16, 16))  # 4 epochs x 4 minibatches


def _train_rank():
    torch.set_num_threads(1)
    initialized = [r.name for r in PROFILER.spans()]
    mesh = make_mesh(device="cpu")
    env = SpinTorqueEnv(batch_size=64, config=SpinTorqueEnvConfig(max_duration=2e-11),
                        mesh=mesh)
    trainer = PPOTrainer(env, CONFIG)
    ts = trainer.init(0)
    since, before = len(PROFILER.spans()), PROFILER.counters()
    with tracing():
        ts, _ = trainer.train_step(ts)
    after = PROFILER.counters()
    return dict(
        initialized=initialized,
        counts={k: after[k] - before.get(k, 0) for k in after},
        spans=[(r.name, r.parent) for r in PROFILER.spans()[since:]],
        params=sum(p.numel() for p in ts.network.parameters()),
    )


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(_train_rank, W, timeout=240)


def test_mesh_initialize_is_recorded_with_tracing_off(ranks):
    assert all(r["initialized"] == ["mesh.initialize"] for r in ranks)


def test_a_train_step_counts_its_all_reduces(ranks):
    # Two for the advantage statistics, one gradient average a minibatch,
    # the losses', the metric means' and the episode count's.
    want = 2 + CONFIG.num_epochs * CONFIG.num_minibatches + 1 + 1 + 1
    for r in ranks:
        c = r["counts"]
        assert c["mesh.all_reduces"] == want
        assert c["ppo.minibatches"] == 16 and c["env.steps"] == CONFIG.rollout_steps
        assert c["mesh.model_all_reduces"] == 0
        # float64 sums and counts (2 + 2 + 4 values), the gradients in
        # float32, 4 x 16 float32 losses and auxes, one int64 count.
        assert c["mesh.all_reduce_bytes"] == (8 * 8 + 16 * 4 * r["params"] + 4 * 4 * 16 + 8)


def test_each_all_reduce_lies_under_the_phase_that_issued_it(ranks):
    for r in ranks:
        parents = [p for name, p in r["spans"] if name == "mesh.all_reduce"]
        assert sorted(parents) == sorted(["ppo.normalize"] * 2 + ["ppo.average_grads"] * 16
                                         + ["ppo.metrics"] * 3)
