"""The data-parallel path over torch.distributed: two gloo ranks on the CPU.

Counterpart of tests/integration/test_sharding.py and the two-process
tests/integration/distributed_worker.py. Each test spawns its ranks with
``parallel.spawn_ranks`` (a ``file://`` rendezvous in a fresh temporary
directory, so parallel test workers never share a port), joins them within
120 s or kills them and fails, and checks what they return in this process.

A sharded env step must equal the one-process step bit for bit (obs,
reward, m), thermal noise and auto-reset included. One PPO update on two
ranks, at float64, is held to the JAX trainer's ``update_from_traj`` from
the same flax parameters and trajectory, run on the global permutation
whose minibatches are the union of the ranks' local minibatches (rank r's
local row t*B/W + b is global row t*B + r*B/W + b): rtol 1e-8, as
tests/test_torch_ppo.py, for the order of the sums is the only difference.
Both ranks must end with equal parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from spintorque_tpu.envs import SpinTorqueEnv as JEnv
from spintorque_tpu.envs import SpinTorqueEnvConfig as JEnvConfig
from spintorque_tpu.rl import PPOConfig as JPPOConfig
from spintorque_tpu.rl import PPOTrainer as JPPOTrainer
from spintorque_tpu_torch import convert
from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu_torch.parallel import (
    initialize,
    is_multihost,
    local_batch_size,
    make_mesh,
    pmean_metrics,
    process_info,
    random_policy,
    rollout,
    shard_batch,
    shard_env_state,
    spawn_ranks,
    summarize,
)
from spintorque_tpu_torch.rl import PPOConfig, PPOTrainer
from spintorque_tpu_torch.utils import measure_env_throughput, measure_train_throughput

torch.set_num_threads(1)

W = 2
TIMEOUT = 120.0


def _run(fn, *args):
    return spawn_ranks(fn, W, args=args, timeout=TIMEOUT)


def _env(batch, mesh=None, **kw):
    cfg = dict(max_duration=1e-10, max_steps=3)
    cfg.update(kw)
    return SpinTorqueEnv(batch_size=batch, config=SpinTorqueEnvConfig(**cfg), device="cpu",
                         mesh=mesh)


# ------------------------------------------------------------ rank bodies


def _info_rank():
    mesh = make_mesh(device="cpu")
    return dict(info=process_info(), multihost=is_multihost(), shape=mesh.shape,
                data_rank=mesh.data_rank, backend=mesh.backend)


def _mesh_rank():
    out = {"default": make_mesh(device="cpu").shape,
           "model": make_mesh(n_data=1, n_model=2, device="cpu").shape}
    mesh = make_mesh(device="cpu")
    out["local_64"] = local_batch_size(64, mesh)
    for name, call in (("bad_mesh", lambda: make_mesh(n_data=3, device="cpu")),
                       ("bad_batch", lambda: local_batch_size(63, mesh))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    # A batch that does not divide the data axis is replicated, as JAX's is.
    odd = _env(63, mesh)
    out["odd_env"] = (odd.local_batch_size, odd.replicated)
    tp = make_mesh(n_data=1, n_model=2, device="cpu")
    out["tp_ranks"] = (tp.data_rank, tp.model_rank)
    network = PPOTrainer(_env(16, tp), PPOConfig(hidden_sizes=(8,))).init(0).network
    out["tp"] = tuple(network.trunks["actor"][0].weight.shape)
    return out


def _rows_rank(batch):
    mesh = make_mesh(device="cpu")
    env = _env(batch, mesh, include_thermal=False)
    state, obs = env.reset(seed=0)
    ref = shard_env_state(_env(batch).reset(seed=0)[0], mesh)
    same = all(torch.equal(getattr(state, k), getattr(ref, k))
               for k in ("m", "target", "step", "total_energy", "episode_return"))
    action = shard_batch(torch.tile(torch.tensor([[1e5, 1e-10]]), (batch, 1)), mesh)
    state, ts = env.step(state, action)
    return dict(rows=state.m.shape[0], obs_rows=ts.obs.shape[0], reward_rows=ts.reward.shape[0],
                same_as_sharded_global=same, m=state.m)


def _pmean_rank():
    mesh = make_mesh(device="cpu")
    x = shard_batch(torch.arange(64, dtype=torch.float32), mesh)
    y = shard_batch(torch.ones((32, 3)) * 2.0, mesh)
    out = pmean_metrics({"reward": x, "nested": {"m": y}, "count": torch.tensor(3)}, mesh)
    return {"reward": out["reward"], "m": out["nested"]["m"], "count": out["count"]}


def _step_rank(batch, actions, thermal):
    mesh = make_mesh(device="cpu")
    env = _env(batch, mesh, include_thermal=thermal)
    state, obs = env.reset(seed=5)
    obs_seq, rew, ms = [obs], [], []
    for a in actions:
        state, ts = env.step(state, shard_batch(torch.tensor(a), mesh))
        obs_seq.append(ts.obs)
        rew.append(ts.reward)
        ms.append(state.m)
    return dict(obs=torch.stack(obs_seq), reward=torch.stack(rew), m=torch.stack(ms))


def _update_rank(params, traj, last_obs, perms):
    mesh = make_mesh(device="cpu")
    env = _env(16, mesh, dtype="float64", include_thermal=False)
    trainer = PPOTrainer(env, PPOConfig(rollout_steps=4, hidden_sizes=(32, 32),
                                        compute_dtype=None))
    r, n = mesh.data_rank, env.local_batch_size
    net = convert.actor_critic_params_from_numpy(params, trainer.make_network().to(torch.float64))
    local = {k: torch.tensor(v[:, r * n:(r + 1) * n]) for k, v in traj.items()}
    losses, auxes = trainer.update_from_traj(
        net, trainer.make_optimizer(net), local, torch.tensor(last_obs[r * n:(r + 1) * n]),
        torch.tensor(perms[r]))
    return dict(params=convert.actor_critic_params_to_numpy(net), losses=losses,
                auxes=auxes)


def _train_rank():
    mesh = make_mesh(device="cpu")
    env = _env(64, mesh)
    trainer = PPOTrainer(env, PPOConfig(rollout_steps=4, num_epochs=2, num_minibatches=2,
                                        hidden_sizes=(32, 32)))
    ts = trainer.init(0)
    flat0 = torch.cat([p.detach().reshape(-1) for p in ts.network.parameters()])
    root = flat0.clone()
    dist.broadcast(root, src=0)
    ts, metrics = trainer.train_step(ts)
    flat1 = torch.cat([p.detach().reshape(-1) for p in ts.network.parameters()])
    root1 = flat1.clone()
    dist.broadcast(root1, src=0)
    state, obs, traj = rollout(env, random_policy(env), None, ts.env_state, ts.obs,
                               torch.Generator().manual_seed(1 + mesh.data_rank), 3)
    stats = summarize(traj, env)
    timing = measure_train_throughput(trainer, warmup=0, steps=1)
    rates, steps = measure_env_throughput(env, n_inner=2, warmup=1, blocks=1, iters_per_block=1)
    return dict(
        init_equal=torch.equal(flat0, root), final_equal=torch.equal(flat1, root1),
        moved=not torch.equal(flat0, flat1), metrics=metrics, stats=stats,
        local_reward_mean=traj.reward.mean(), timing={k: timing[k] for k in
                                                       ("world_size", "backend", "rates")},
        env_rates=rates, env_steps=steps,
    )


# ------------------------------------------------------------------ tests


def test_single_process_initialize_and_mesh():
    """One process: ``initialize`` does nothing and the mesh is 1 x 1."""
    initialize()
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_rank == 0
    assert mesh.backend is None
    with pytest.raises(ValueError):
        make_mesh(n_data=2, device="cpu")
    assert process_info()["process_count"] == 1 and not is_multihost()
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError):
            make_mesh()


def test_process_info_two_ranks():
    out = _run(_info_rank)
    assert [o["info"]["process_index"] for o in out] == [0, 1]
    for o in out:
        assert o["info"]["process_count"] == 2 and o["info"]["global_device_count"] == 2
        assert o["info"]["backend"] == "gloo" and o["backend"] == "gloo"
        assert o["multihost"] and o["shape"] == {"data": 2, "model": 1}
    assert [o["data_rank"] for o in out] == [0, 1]


def test_mesh_shapes_and_errors():
    out = _run(_mesh_rank)
    for o in out:
        assert o["default"] == {"data": 2, "model": 1}
        assert o["model"] == {"data": 1, "model": 2}
        assert o["local_64"] == 32
        assert "3x1" in o["bad_mesh"]
        assert "not divisible" in o["bad_batch"]
        assert o["odd_env"] == (63, True)
        assert o["tp"] == (4, 12)  # the trainer holds its half of the hidden layer
    assert [o["tp_ranks"] for o in out] == [(0, 0), (0, 1)]


def test_each_rank_holds_its_rows():
    """Every batch-major tensor holds B/W rows on each rank, before and
    after a step, and together the ranks hold the global batch."""
    B = 64
    out = _run(_rows_rank, B)
    for o in out:
        assert o["rows"] == o["obs_rows"] == o["reward_rows"] == B // W
        assert o["same_as_sharded_global"]
    env = _env(B, include_thermal=False)
    state, _ = env.reset(seed=0)
    state, _ = env.step(state, torch.tile(torch.tensor([[1e5, 1e-10]]), (B, 1)))
    assert torch.equal(torch.cat([o["m"] for o in out]), state.m)


def test_pmean_metrics_reduces_across_ranks():
    out = _run(_pmean_rank)
    for o in out:
        assert float(o["reward"]) == pytest.approx(31.5)
        assert float(o["m"]) == pytest.approx(2.0)
        assert float(o["count"]) == 3.0
    assert torch.equal(out[0]["reward"], out[1]["reward"])


@pytest.mark.parametrize("thermal", [False, True], ids=["deterministic", "thermal"])
def test_sharded_env_steps_equal_one_process(thermal):
    """Six steps with max_steps=3, so done envs auto-reset from the global
    draws, at B=128 (64 rows per rank)."""
    B, steps = 128, 6
    rng = np.random.default_rng(3)
    actions = np.stack([rng.uniform(-2e6, 2e6, (steps, B)),
                        rng.uniform(1e-12, 1e-10, (steps, B))], -1).astype(np.float32)
    out = _run(_step_rank, B, actions, thermal)
    env = _env(B, include_thermal=thermal)
    state, obs = env.reset(seed=5)
    obs_seq, rew, ms = [obs], [], []
    for a in actions:
        state, ts = env.step(state, torch.tensor(a))
        obs_seq.append(ts.obs)
        rew.append(ts.reward)
        ms.append(state.m)
    assert bool((ts.terminated | ts.truncated).any())  # the last step auto-reset envs
    for key, ref in (("obs", torch.stack(obs_seq)), ("reward", torch.stack(rew)),
                     ("m", torch.stack(ms))):
        got = torch.cat([o[key] for o in out], dim=1)
        assert torch.equal(got, ref), key


def _jax_rollout(T=4, B=16):
    """A float64 JAX trainer and a rollout of its policy, as numpy."""
    jenv = JEnv(batch_size=B, config=JEnvConfig(
        include_thermal=False, max_duration=1e-10, dtype="float64", max_steps=3))
    trainer = JPPOTrainer(jenv, JPPOConfig(rollout_steps=T, hidden_sizes=(32, 32),
                                           compute_dtype=None))
    ts = trainer.init(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: np.asarray(x, np.float64), ts.params)
    params["log_std"] = np.asarray([-0.5, -0.2])
    env_state, obs = ts.env_state, ts.obs
    steps = []
    for key in jax.random.split(jax.random.PRNGKey(1), T):
        env_action, raw, log_prob, value = trainer._policy(params, obs, key)
        env_state, out = jenv.step(env_state, env_action)
        steps.append(dict(obs=obs, raw_action=raw, reward=out.reward,
                          done=out.terminated | out.truncated, log_prob=log_prob, value=value))
        obs = out.obs
    traj = {k: np.stack([np.asarray(s[k]) for s in steps]) for k in steps[0]}
    return trainer, params, traj, np.asarray(obs)


def test_two_rank_ppo_update_matches_jax(monkeypatch):
    T, B, n_mb, epochs = 4, 16, 4, 4
    jtr, params, traj, last_obs = _jax_rollout(T, B)
    assert traj["done"].any() and not traj["done"].all()
    n_local, b_local = T * B // W, B // W
    rng = np.random.default_rng(11)
    perms = np.stack([np.stack([rng.permutation(n_local) for _ in range(epochs)])
                      for _ in range(W)])  # (W, epochs, n_local)
    size = n_local // n_mb

    def global_row(r, local):
        return (local // b_local) * B + r * b_local + local % b_local

    union = np.stack([
        np.concatenate([global_row(r, perms[r, e, i * size:(i + 1) * size])
                        for i in range(n_mb) for r in range(W)])
        for e in range(epochs)])
    k_perm = jax.random.PRNGKey(2)
    by_key = {np.asarray(k).tobytes(): union[e]
              for e, k in enumerate(jax.random.split(k_perm, epochs))}
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n: jnp.asarray(by_key[np.asarray(key).tobytes()]))
    with jax.disable_jit():  # concrete epoch keys, so the permutation is looked up
        jparams, _, jlosses, jauxes = jtr.update_from_traj(
            params, jtr.tx.init(params), {k: jnp.asarray(v) for k, v in traj.items()},
            jnp.asarray(last_obs), k_perm)

    out = _run(_update_rank, params, traj, last_obs, perms)
    for o in out:
        np.testing.assert_allclose(o["losses"].numpy(), np.asarray(jlosses), rtol=1e-8,
                                   atol=1e-12)
        for k in ("pg_loss", "v_loss", "entropy"):
            np.testing.assert_allclose(o["auxes"][k].numpy(), np.asarray(jauxes[k]),
                                       rtol=1e-8, atol=1e-12, err_msg=k)
        for name, leaf in jax.tree.map(np.asarray, jparams).items():
            pairs = leaf.items() if isinstance(leaf, dict) else [("", leaf)]
            for k, want in pairs:
                have = o["params"][name][k] if k else o["params"][name]
                np.testing.assert_allclose(have, want, rtol=1e-8, atol=1e-12,
                                           err_msg=f"{name}.{k}")
    for name, leaf in out[0]["params"].items():
        pairs = leaf.items() if isinstance(leaf, dict) else [("", leaf)]
        for k, have in pairs:
            other = out[1]["params"][name][k] if k else out[1]["params"][name]
            np.testing.assert_array_equal(have, other)


def test_two_rank_train_step_keeps_ranks_equal():
    """Equal initial weights (a broadcast checksum), a full train step that
    moves them and leaves them equal, global metrics, and the measurement
    programs' global rates."""
    out = _run(_train_rank)
    for o in out:
        assert o["init_equal"] and o["final_equal"] and o["moved"]
        assert all(np.isfinite(float(v)) for v in o["metrics"].values())
        assert o["stats"]["steps"] == 3 * 64
        assert o["timing"]["world_size"] == 2 and o["timing"]["backend"] == "gloo"
        assert o["timing"]["rates"][0] > 0
        assert o["env_rates"][0] > 0 and o["env_steps"] == 2 * 64
    for k, v in out[0]["metrics"].items():
        assert torch.equal(v, out[1]["metrics"][k]), k
    for k in ("mean_reward", "episodes", "success_rate"):
        assert torch.equal(out[0]["stats"][k], out[1]["stats"][k]), k
    local = (float(out[0]["local_reward_mean"]) + float(out[1]["local_reward_mean"])) / 2
    assert float(out[0]["stats"]["mean_reward"]) == pytest.approx(local, rel=1e-5)
