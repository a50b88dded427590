"""The port's shell: ``config``, ``utils.checkpoint`` and
``utils.profiling``, against the JAX package's where it has a result to
compare.

  * ``config``: the same dataclass defaults, the same environment
    mappings, the same precedence (defaults < file < environment) and
    validation as ``spintorque_tpu.config``; ``make_env`` builds the port's
    env from them, on the card unless the caller asks for the CPU.
  * ``utils.checkpoint``: trees, parameters and rolling checkpoints round
    trip exactly; a saved env state (each of the three envs, thermal and
    auto-reset on) or trainer state resumes bit for bit: save, load, then
    k more steps equal k uninterrupted steps.
  * ``utils.profiling``: the JAX package's profiler test, and the two
    helpers on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import spintorque_tpu.config as jax_config
from spintorque_tpu_torch import config
from spintorque_tpu_torch.envs import (
    ArrayEnvConfig,
    SkyrmionEnvConfig,
    SkyrmionRacetrackEnv,
    SpinTorqueArrayEnv,
    SpinTorqueEnv,
    SpinTorqueEnvConfig,
)
from spintorque_tpu_torch.rl import PPOConfig, PPOTrainer
from spintorque_tpu_torch.utils import (
    CheckpointManager,
    PerformanceProfiler,
    block_and_time,
    device_trace,
    load_env_state,
    load_params,
    load_pytree,
    load_train_state,
    save_env_state,
    save_params,
    save_pytree,
    save_train_state,
)

torch.set_num_threads(1)


# ------------------------------------------------------------------ config


def test_config_tree_and_mappings_are_the_jax_packages():
    assert config.SpinTorqueConfig().to_dict() == jax_config.SpinTorqueConfig().to_dict()
    assert config._ENV_MAPPINGS == jax_config._ENV_MAPPINGS
    for name in ("PhysicsConfig", "DeviceConfig", "EnvironmentConfig", "TrainingConfig",
                 "ComputeConfig", "LoggingConfig", "SpinTorqueConfig"):
        ours = [f.name for f in dataclasses.fields(getattr(config, name))]
        assert ours == [f.name for f in dataclasses.fields(getattr(jax_config, name))], name


def test_config_precedence(tmp_path, monkeypatch):
    config.reset_config()
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"environment": {"max_steps": 55}}))
    monkeypatch.setenv("SPIN_TORQUE_MAX_STEPS", "77")
    monkeypatch.setenv("SPIN_TORQUE_DEVICE_TYPE", "sot_mram")
    monkeypatch.setenv("SPIN_TORQUE_INCLUDE_THERMAL", "no")
    m = config.ConfigManager(str(cfg_file))
    assert m.config.environment.max_steps == 77  # env beats file
    assert m.config.device.device_type == "sot_mram"
    assert m.config.physics.include_thermal is False
    assert m.config.to_dict() == jax_config.ConfigManager(str(cfg_file)).config.to_dict()
    monkeypatch.delenv("SPIN_TORQUE_MAX_STEPS")
    assert config.ConfigManager(str(cfg_file)).config.environment.max_steps == 55


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_config_save_and_load(tmp_path, suffix):
    m = config.ConfigManager()
    m.config.environment.batch_size = 64
    m.config.physics.method = "heun"
    path = tmp_path / f"cfg{suffix}"
    m.save(path)
    back = config.ConfigManager(str(path))
    assert back.config.environment.batch_size == 64 and back.config.physics.method == "heun"
    theirs = jax_config.ConfigManager(str(path))
    assert theirs.config.environment.batch_size == 64 and theirs.config.physics.method == "heun"


@pytest.mark.parametrize("section,field,value", [
    ("environment", "max_steps", -1), ("environment", "max_current", 0.0),
    ("environment", "success_threshold", 1.5), ("physics", "temperature", -1.0),
    ("physics", "method", "rk45"), ("physics", "noise_mode", "loud"),
    ("physics", "rk4_noise", "per_call"), ("compute", "dtype", "float16"),
])
def test_config_validation(section, field, value):
    c = config.ConfigManager()
    setattr(getattr(c.config, section), field, value)
    with pytest.raises(ValueError):
        c.validate()
    with pytest.raises(ValueError, match="Unknown config"):
        c._merge({"nonsense": {}})


def test_global_accessors():
    config.reset_config()
    assert config.get_config().environment.max_steps == 100
    config.update_config({"environment": {"max_steps": 12}})
    assert config.get_config().environment.max_steps == 12
    with pytest.raises(ValueError):
        config.update_config({"environment": {"max_steps": 0}})
    config.reset_config()
    assert config.get_config().environment.max_steps == 100


def test_config_make_env():
    m = config.ConfigManager()
    m.config.environment.batch_size = 4
    m.config.physics.include_thermal = False
    env = m.make_env(device="cpu")
    assert isinstance(env, SpinTorqueEnv) and env.device.type == "cpu"
    assert env.batch_size == 4
    assert env.config.include_thermal is False
    assert env.config == SpinTorqueEnvConfig(include_thermal=False, max_substeps=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m.make_env()


# -------------------------------------------------------------- checkpoints


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": np.arange(5.0), "b": {"c": np.ones((2, 3), np.float32)},
            "t": torch.arange(3), "n": 7, "s": (1.5, "x")}
    save_pytree(tmp_path / "ckpt", tree)
    out = load_pytree(tmp_path / "ckpt")
    np.testing.assert_array_equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"]["c"], tree["b"]["c"])
    assert torch.equal(out["t"], tree["t"]) and out["n"] == 7 and out["s"] == (1.5, "x")
    typed = load_pytree(tmp_path / "ckpt", target=tree)
    assert isinstance(typed["a"], np.ndarray) and typed["b"]["c"].dtype == np.float32
    assert isinstance(typed["t"], torch.Tensor)


def test_params_roundtrip_and_manager(tmp_path):
    net = torch.nn.Linear(4, 3)
    save_params(tmp_path / "p.pt", net)
    other = load_params(tmp_path / "p.pt", torch.nn.Linear(4, 3))
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                 other.state_dict().values()))
    mgr = CheckpointManager(tmp_path / "rolling", max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (1, 5, 9):
        mgr.save(step, {"w": torch.full((2,), float(step))})
    assert mgr.all_steps() == [5, 9] and mgr.latest_step() == 9
    assert torch.equal(mgr.restore()["w"], torch.full((2,), 9.0))
    assert torch.equal(mgr.restore(5)["w"], torch.full((2,), 5.0))


def _envs():
    B = 16
    return {
        "spin_torque": (SpinTorqueEnv(batch_size=B, device="cpu", config=SpinTorqueEnvConfig(
            max_steps=3, max_duration=2e-10)),
            lambda g: torch.stack([4e6 * torch.rand(B, generator=g) - 2e6,
                                   2e-10 * torch.rand(B, generator=g)], -1)),
        "array": (SpinTorqueArrayEnv(batch_size=B, device="cpu", config=ArrayEnvConfig(
            rows=2, cols=2, max_steps=3)),
            lambda g: torch.stack([torch.randint(0, 4, (B,), generator=g).float(),
                                   4e6 * torch.rand(B, generator=g) - 2e6,
                                   1e-9 * torch.rand(B, generator=g)], -1)),
        "racetrack": (SkyrmionRacetrackEnv(batch_size=B, device="cpu", config=SkyrmionEnvConfig(
            max_steps=3)),
            lambda g: torch.cat([2e11 * torch.rand(B, 4, generator=g) - 1e11,
                                 1e-9 * torch.rand(B, 1, generator=g)], -1)),
    }


@pytest.mark.parametrize("name", ["spin_torque", "array", "racetrack"])
def test_env_state_resumes_bit_for_bit(tmp_path, name):
    env, act = _envs()[name]
    g = torch.Generator().manual_seed(4)
    actions = [act(g) for _ in range(6)]
    state, _ = env.reset(seed=2**63 + 11)
    for a in actions[:2]:
        state, _ = env.step(state, a)
    save_env_state(tmp_path / "state.pt", state)
    straight = [env.step(state, actions[2])]
    for a in actions[3:]:
        straight.append(env.step(straight[-1][0], a))
    resumed = load_env_state(tmp_path / "state.pt", "cpu")
    assert type(resumed) is type(state) and resumed.counter == 2 and resumed.seed == state.seed
    for a, (want_state, want_ts) in zip(actions[2:], straight):
        resumed, ts = env.step(resumed, a)
        for f in dataclasses.fields(want_state):
            x, y = getattr(resumed, f.name), getattr(want_state, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f.name
        assert torch.equal(ts.obs, want_ts.obs) and torch.equal(ts.reward, want_ts.reward)


def _trainer():
    env = SpinTorqueEnv(batch_size=8, device="cpu", max_steps=4, max_duration=1e-10)
    return PPOTrainer(env, PPOConfig(rollout_steps=4, num_epochs=2, num_minibatches=2,
                                     hidden_sizes=(16, 16)))


def test_train_state_resumes_bit_for_bit(tmp_path):
    trainer = _trainer()
    ts = trainer.init(0)
    ts, _ = trainer.train_step(ts)
    save_train_state(tmp_path / "train.pt", ts)
    for _ in range(2):
        ts, metrics = trainer.train_step(ts)
    resumed = load_train_state(tmp_path / "train.pt", _trainer())
    assert resumed.update_count == 1
    for _ in range(2):
        resumed, again = trainer.train_step(resumed)
    for a, b in zip(ts.network.parameters(), resumed.network.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(ts.obs, resumed.obs)
    assert torch.equal(ts.env_state.m, resumed.env_state.m)
    assert torch.equal(ts.generator.get_state(), resumed.generator.get_state())
    for k in metrics:
        assert torch.equal(torch.as_tensor(metrics[k]), torch.as_tensor(again[k])), k


def test_ppo_params_roundtrip(tmp_path):
    """The JAX package's trainer checkpoint test (tests/unit/test_rollout_rl.py)."""
    trainer = _trainer()
    ts, _ = trainer.train_step(trainer.init(0))
    save_params(tmp_path / "params", ts.network)
    restored = load_params(tmp_path / "params")
    orig = list(ts.network.state_dict().values())
    assert len(orig) == len(restored)
    for a, b in zip(orig, restored.values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# --------------------------------------------------------------- profiling


def test_profiler():
    p = PerformanceProfiler()
    with p.time_operation("op"):
        pass
    p.increment_counter("calls")
    stats = p.get_stats()
    assert stats["timers"]["op"]["count"] == 1
    assert stats["counters"]["calls"] == 1
    assert p.end_timer("never started") == 0.0
    p.reset()
    assert p.get_stats() == {"counters": {}, "timers": {}}


def test_block_and_time_and_device_trace(tmp_path):
    calls = []
    seconds, out = block_and_time(lambda x: calls.append(x) or x * 2, torch.ones(3), iters=4,
                                  warmup=2)
    assert len(calls) == 6 and seconds >= 0.0 and torch.equal(out, torch.full((3,), 2.0))
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    assert (tmp_path / "trace" / "trace.json").is_file()
    assert len(prof.key_averages()) > 0
