"""The port's command line against the JAX package's.

Counterpart of tests/unit/test_cli_benchmark.py (benchmark, the fake
stable-baselines3 cases over the port's namespaced Gymnasium ids, sweep)
and the CLI parts of tests/unit/test_utils_config.py (info, config, eval),
on the CPU (``--device cpu``). Parity:

  * ``config show`` prints the JAX CLI's JSON, key for key;
  * ``sweep`` at ``--temperature 0`` on a small grid gives the JAX CLI's
    ``p_switch`` and ``failed_fraction`` exactly (JAX op by op under
    ``jax.disable_jit``, as tests/test_torch_sweeps.py runs it), and its
    grid at float32 rtol 1e-7;
  * ``eval`` prints the JAX CLI's keys, and ``train --output`` followed by
    ``eval --model`` round-trips;
  * ``--device cuda`` without a card raises: nothing falls back to the CPU;
  * under two gloo ranks, ``train`` trains on a mesh and both ranks end
    with equal parameters; with ``compute.mesh_model = 2`` it trains the
    tensor-parallel policy, writes the gathered parameters once, and
    ``eval --model`` loads them in one process.
"""

import json
import os
import subprocess
import sys
import types

import gymnasium
import jax
import numpy as np
import pytest
import torch

from spintorque_tpu.cli import build_parser as jax_build_parser
from spintorque_tpu.cli import main as jax_main
from spintorque_tpu_torch.cli import build_parser, main
from spintorque_tpu_torch.parallel import spawn_ranks

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A small training configuration: 64 envs, short pulses, a narrow network.
SMALL = {
    "environment": {"batch_size": 64, "max_duration": 1e-10},
    "physics": {"include_thermal": False},
    "training": {"rollout_steps": 4, "num_epochs": 2, "num_minibatches": 2,
                 "hidden_sizes": [16, 16], "total_timesteps": 512, "seed": 3},
}


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("SPIN_TORQUE_"):
            monkeypatch.delenv(k)


def _config(tmp_path, **extra):
    cfg = {**SMALL, **extra}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# info, config, benchmark


def test_cli_info(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "spintorque-tpu-torch" in out and "stt_mram" in out
    for name in ("SpinTorque-v0", "SpinTorqueArray-v0", "SkyrmionRacetrack-v0"):
        assert f"spintorque_torch/{name}" in out
    assert f"cuda devices: {torch.cuda.device_count()}" in out


def test_cli_config_show_equals_jax(capsys):
    assert main(["config", "show"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jax_main(["config", "show"]) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert ours == theirs
    assert ours["environment"]["max_steps"] == 100


def test_cli_config_save_and_validate(tmp_path, capsys):
    out = tmp_path / "saved.json"
    assert main(["config", "save", "--config", _config(tmp_path), "--output", str(out)]) == 0
    assert json.loads(out.read_text())["training"]["hidden_sizes"] == [16, 16]
    assert main(["config", "validate", "--config", str(out)]) == 0
    assert "configuration valid" in capsys.readouterr().out
    assert main(["config", "save"]) == 1


def test_cli_benchmark(capsys):
    rc = main(["benchmark", "--batch-size", "32", "--iters", "1", "--inner", "1",
               "--no-thermal", "--device", "cpu"])
    assert rc == 0
    data = _last_json(capsys)
    assert data["batch_size"] == 32 and data["backend"] == "cpu" and data["devices"] == 1
    assert data["env_steps_per_s"] > 0
    assert data["env_steps_per_s_per_chip"] == data["env_steps_per_s"]
    assert data["ms_per_batched_step"] == pytest.approx(32 / data["env_steps_per_s"] * 1e3)


@pytest.mark.parametrize("argv", [
    ["benchmark", "--batch-size", "32"],
    ["eval", "--episodes-steps", "1"],
    ["train", "--timesteps", "1"],
    ["sweep", "--n-currents", "1", "--n-durations", "1", "--ensemble", "1"],
], ids=["benchmark", "eval", "train", "sweep"])
def test_cli_defaults_to_the_card_without_fallback(argv):
    args = build_parser().parse_args(argv)
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_cli_subcommands_and_flags_cover_jax():
    ours, theirs = build_parser(), jax_build_parser()

    def flags(parser):
        sub = parser._subparsers._group_actions[0]
        return {name: {opt for a in p._actions for opt in a.option_strings}
                for name, p in sub.choices.items()}

    mine, ref = flags(ours), flags(theirs)
    assert set(mine) == set(ref)
    for name in ref:
        assert ref[name] <= mine[name], name


# ---------------------------------------------------------------------------
# the sb3 backend, with a fake stable-baselines3


class _FakeAlgo:
    """Records the env it was constructed with; .learn is a no-op."""

    instances = []

    def __init__(self, policy, env, **kwargs):
        self.env = env
        type(self).instances.append(self)

    def learn(self, total_timesteps):
        self.learned = total_timesteps

    def save(self, path):
        pass


def _run_sb3_train(monkeypatch, algorithm):
    fake = types.ModuleType("stable_baselines3")
    for name in ("PPO", "SAC", "TD3", "DQN"):
        setattr(fake, name, type(name, (_FakeAlgo,), {"instances": []}))
    monkeypatch.setitem(sys.modules, "stable_baselines3", fake)
    rc = main(["train", "--backend", "sb3", "--algorithm", algorithm, "--timesteps", "1",
               "--device", "cpu"])
    return rc, fake


def test_cli_sb3_dqn_gets_discrete_action_space(monkeypatch):
    rc, fake = _run_sb3_train(monkeypatch, "dqn")
    assert rc == 0
    (inst,) = fake.DQN.instances
    assert isinstance(inst.env.action_space, gymnasium.spaces.Discrete)
    assert inst.env.spec.id == "spintorque_torch/SpinTorque-v0"
    assert inst.learned == 1


def test_cli_sb3_ppo_keeps_continuous_action_space(monkeypatch):
    rc, fake = _run_sb3_train(monkeypatch, "ppo")
    assert rc == 0
    (inst,) = fake.PPO.instances
    assert isinstance(inst.env.action_space, gymnasium.spaces.Box)
    assert inst.env.spec.id == "spintorque_torch/SpinTorque-v0"


def test_cli_sb3_unknown_algorithm(monkeypatch):
    rc, _ = _run_sb3_train(monkeypatch, "a2c")
    assert rc == 1


def test_cli_sb3_not_installed(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "stable_baselines3", None)
    assert main(["train", "--backend", "sb3", "--device", "cpu"]) == 1
    assert "stable-baselines3 not installed" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# sweep


def test_cli_sweep_writes_diagram(tmp_path):
    """The sweep subcommand runs a tiny thermal grid end to end and writes
    JSON (the JAX test's grid and physics checks)."""
    out = tmp_path / "sweep.json"
    args = build_parser().parse_args(
        ["sweep", "--n-currents", "3", "--n-durations", "2", "--ensemble", "4",
         "--duration-max", "3e-10", "--output", str(out), "--device", "cpu"])
    assert args.func(args) == 0
    d = json.loads(out.read_text())
    assert len(d["p_switch"]) == 3 and len(d["p_switch"][0]) == 2
    assert all(0.0 <= v <= 1.0 for row in d["p_switch"] for v in row)
    # Physics: strong negative J switches, zero J does not.
    assert d["p_switch"][0][0] > 0.9 and d["p_switch"][-1][-1] < 0.1


def test_cli_sweep_matches_jax_at_zero_temperature(tmp_path):
    grid = ["sweep", "--n-currents", "3", "--n-durations", "2", "--ensemble", "2",
            "--current-min=-4e6", "--current-max=0",
            "--duration-min", "5e-11", "--duration-max", "1.5e-10", "--temperature", "0"]
    ours, theirs = tmp_path / "ours.json", tmp_path / "jax.json"
    assert main(grid + ["--output", str(ours), "--device", "cpu"]) == 0
    with jax.disable_jit():
        assert jax_main(grid + ["--output", str(theirs)]) == 0
    a, b = json.loads(ours.read_text()), json.loads(theirs.read_text())
    assert a["p_switch"] == b["p_switch"]
    assert a["failed_fraction"] == b["failed_fraction"]
    assert {k: a[k] for k in ("device_type", "temperature", "ensemble")} == {
        k: b[k] for k in ("device_type", "temperature", "ensemble")}
    for k in ("currents", "durations"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-7, atol=0)
    flat = [v for row in a["p_switch"] for v in row]
    assert 0.0 in flat and 1.0 in flat  # the grid spans both outcomes


def test_cli_sweep_writes_null_for_all_failed_points(tmp_path, capsys, monkeypatch):
    import spintorque_tpu_torch.research.sweeps as sweeps

    real = sweeps.switching_probability_diagram

    def all_failed(*args, **kwargs):
        out = real(*args, **kwargs)
        out["p_switch"][0, 0] = float("nan")
        return out

    monkeypatch.setattr(sweeps, "switching_probability_diagram", all_failed)
    assert main(["sweep", "--n-currents", "2", "--n-durations", "1", "--ensemble", "1",
                 "--duration-max", "1e-10", "--temperature", "0", "--device", "cpu"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["p_switch"][0][0] is None and d["p_switch"][1][0] is not None


# ---------------------------------------------------------------------------
# eval and train


def test_cli_eval_random_keys_equal_jax(capsys, monkeypatch):
    monkeypatch.setenv("SPIN_TORQUE_BATCH_SIZE", "8")
    monkeypatch.setenv("SPIN_TORQUE_INCLUDE_THERMAL", "false")
    monkeypatch.setenv("SPIN_TORQUE_MAX_DURATION", "1e-10")
    assert main(["eval", "--episodes-steps", "4", "--device", "cpu"]) == 0
    stats = _last_json(capsys)
    assert stats["steps"] == 8 * 4
    assert jax_main(["eval", "--episodes-steps", "4"]) == 0
    assert set(stats) == set(_last_json(capsys))
    assert all(np.isfinite(v) for v in stats.values())


def test_cli_train_output_then_eval_model(tmp_path, capsys):
    cfg = _config(tmp_path)
    policy = tmp_path / "policy.pt"
    assert main(["train", "--config", cfg, "--output", str(policy), "--log-every", "1",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("update ") == 2  # 512 steps / (4 x 64) updates, each logged
    summary = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    assert summary["updates"] == 2 and summary["timesteps"] == 512
    assert policy.is_file()

    from spintorque_tpu_torch.config import ConfigManager
    from spintorque_tpu_torch.rl import PPOConfig, PPOTrainer
    from spintorque_tpu_torch.utils import load_params

    env = ConfigManager(cfg).make_env(device="cpu")
    trainer = PPOTrainer(env, PPOConfig(hidden_sizes=(16, 16)))
    fresh = trainer.make_network()
    loaded = load_params(policy, target=trainer.make_network())
    assert any(not torch.equal(a, b) for a, b in zip(fresh.parameters(), loaded.parameters()))

    assert main(["eval", "--config", cfg, "--model", str(policy), "--episodes-steps", "3",
                 "--output", str(tmp_path / "eval.json"), "--device", "cpu"]) == 0
    stats = _last_json(capsys)
    assert stats == json.loads((tmp_path / "eval.json").read_text())
    assert stats["steps"] == 64 * 3 and np.isfinite(stats["mean_reward"])


def test_python_dash_m_entry_point():
    proc = subprocess.run([sys.executable, "-m", "spintorque_tpu_torch.cli", "config", "show"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items()
                               if not k.startswith("SPIN_TORQUE_")})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["compute"]["dtype"] == "float32"


def test_console_script_is_declared():
    text = open(os.path.join(ROOT, "pyproject.toml")).read()
    assert 'spintorque-tpu-torch = "spintorque_tpu_torch.cli:main"' in text


# ---------------------------------------------------------------------------
# train on a mesh of two gloo ranks


def _train_rank(argv):
    from spintorque_tpu_torch import cli
    from spintorque_tpu_torch.rl import PPOTrainer

    torch.set_num_threads(1)
    captured = {}
    train = PPOTrainer.train

    def recording_train(self, *args, **kwargs):
        ts, summary = train(self, *args, **kwargs)
        captured.update(mesh=dict(self.mesh.shape), rows=self.env.local_batch_size,
                        params=[p.detach().clone() for p in ts.network.parameters()])
        return ts, summary

    PPOTrainer.train = recording_train
    return cli.main(argv), captured


def test_cli_train_on_a_two_rank_mesh(tmp_path):
    cfg = _config(tmp_path)
    out = spawn_ranks(_train_rank, 2, args=(["train", "--config", cfg, "--device", "cpu",
                                             "--output", str(tmp_path / "p.pt")],),
                      workdir=str(tmp_path))
    (rc0, r0), (rc1, r1) = out
    assert rc0 == rc1 == 0
    assert r0["mesh"] == r1["mesh"] == {"data": 2, "model": 1}
    assert r0["rows"] == r1["rows"] == 32
    for a, b in zip(r0["params"], r1["params"]):
        assert torch.equal(a, b)
    assert (tmp_path / "p.pt").is_file()  # written once, by rank 0


def test_cli_train_model_axis_is_not_ported(tmp_path, capsys):
    """``compute.mesh_model = 2`` on two ranks: the 'model' axis trains (a
    (1, 2) mesh, each rank holding its half of the even hidden layers),
    rank 0 writes the gathered whole parameters once, and ``eval --model``
    in one process without a mesh loads them."""
    cfg = _config(tmp_path, compute={"mesh_model": 2})
    policy = tmp_path / "tp.pt"
    out = spawn_ranks(_train_rank, 2, args=(["train", "--config", cfg, "--device", "cpu",
                                             "--output", str(policy)],),
                      workdir=str(tmp_path))
    (rc0, r0), (rc1, r1) = out
    assert rc0 == rc1 == 0
    assert r0["mesh"] == r1["mesh"] == {"data": 1, "model": 2}
    assert r0["rows"] == r1["rows"] == 64
    # Parameter 1 is trunks.actor.0.weight: 8 of its 16 rows on each rank.
    w0, w1 = r0["params"][1], r1["params"][1]
    assert w0.shape == w1.shape == (8, 12) and not torch.equal(w0, w1)
    saved = torch.load(policy, weights_only=True)
    assert torch.equal(saved["trunks.actor.0.weight"], torch.cat([w0, w1]))
    assert main(["eval", "--config", cfg, "--model", str(policy), "--episodes-steps", "3",
                 "--device", "cpu"]) == 0
    stats = _last_json(capsys)
    assert stats["steps"] == 64 * 3 and np.isfinite(stats["mean_reward"])


def test_cli_train_on_a_data_and_model_mesh(tmp_path):
    """Four ranks, ``compute.mesh_data = 2`` and ``mesh_model = 2``: each
    data coordinate holds 32 of the 64 envs, each model rank its half of the
    hidden layers; every rank ends with the same whole network, which rank
    0 writes once."""
    cfg = _config(tmp_path, compute={"mesh_data": 2, "mesh_model": 2})
    policy = tmp_path / "tp.pt"
    out = spawn_ranks(_train_rank, 4, args=(["train", "--config", cfg, "--device", "cpu",
                                             "--output", str(policy)],),
                      workdir=str(tmp_path))
    assert [rc for rc, _ in out] == [0, 0, 0, 0]
    for _, r in out:
        assert r["mesh"] == {"data": 2, "model": 2} and r["rows"] == 32
    halves = [r["params"][1] for _, r in out]  # trunks.actor.0.weight
    assert torch.equal(halves[0], halves[2]) and torch.equal(halves[1], halves[3])
    saved = torch.load(policy, weights_only=True)
    assert torch.equal(saved["trunks.actor.0.weight"], torch.cat(halves[:2]))
