"""The port's PPO training path against the JAX package's.

Networks, log-probs and one full ``update_from_traj`` (4 epochs x 4
minibatches) are held to the JAX package on the same inputs: the flax
parameters are carried across with ``convert``, trajectories come from a
JAX rollout as numpy, and the minibatch permutations are JAX's. Tolerances:
float64 rtol 1e-10 for the networks and 1e-12 for the log-prob helpers
(the same formulas op for op), rtol 1e-8 for the update (Adam and the
global-norm clip in another op order, 16 steps); float32 1e-6; the bfloat16
compute dtype atol 0.05, as the JAX package's own bf16 test uses. The
rollout itself draws from other streams than JAX (torch generators and
Philox against JAX keys), so the trainer tests below are the JAX package's
trainer tests ported: shapes, running, learning, modes.
"""

import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spintorque_tpu.envs import SpinTorqueEnv as JEnv
from spintorque_tpu.envs import SpinTorqueEnvConfig as JEnvConfig
from spintorque_tpu.rl import networks as jnet
from spintorque_tpu.rl import PPOConfig as JPPOConfig
from spintorque_tpu.rl import PPOTrainer as JPPOTrainer
from spintorque_tpu_torch import convert
from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu_torch.parallel import random_policy, rollout, summarize
from spintorque_tpu_torch.rl import ActorCritic, PPOConfig, PPOTrainer, networks
from spintorque_tpu_torch.utils import measure_train_throughput

torch.set_num_threads(1)


def make_env(batch=16, **kw):
    defaults = dict(include_thermal=False, max_duration=1e-10, dtype="float32")
    defaults.update(kw)
    return SpinTorqueEnv(batch_size=batch, config=SpinTorqueEnvConfig(**defaults), device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flax_params(discrete, shared, hidden, compute_dtype, dtype, seed=0):
    """(flax module, its params as numpy in ``dtype``, observations)."""
    module = jnet.ActorCritic(
        action_dim=20 if discrete else 2, discrete=discrete, hidden_sizes=hidden,
        compute_dtype=compute_dtype, shared_trunk=shared,
    )
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(24, 12)).astype(dtype)
    params = nn.meta.unbox(module.init(jax.random.PRNGKey(seed), jnp.asarray(obs[:1])))["params"]
    params = jax.tree.map(lambda x: np.asarray(x, dtype), _np(params))
    if not discrete:  # a nonzero log_std exercises the std path
        params["log_std"] = np.asarray([-0.3, 0.2], dtype)
    return module, params, obs


def _port_network(params, discrete, shared, hidden, compute_dtype, dtype):
    net = ActorCritic(12, 20 if discrete else 2, discrete=discrete, hidden_sizes=hidden,
                      compute_dtype=compute_dtype, shared_trunk=shared)
    net = net.to(dtype)
    return convert.actor_critic_params_from_numpy(params, net)


# ------------------------------------------------------------------ networks


@pytest.mark.parametrize("shared", [False, True], ids=["separate", "shared"])
@pytest.mark.parametrize("discrete", [False, True], ids=["continuous", "discrete"])
@pytest.mark.parametrize(
    "compute_dtype,np_dtype,torch_dtype,tol",
    [(None, np.float64, torch.float64, dict(rtol=1e-10, atol=1e-12)),
     ("float32", np.float32, torch.float32, dict(rtol=1e-6, atol=1e-6)),
     ("bfloat16", np.float32, torch.float32, dict(rtol=0, atol=0.05))],
    ids=["float64", "float32", "bfloat16"],
)
def test_network_matches_flax(discrete, shared, compute_dtype, np_dtype, torch_dtype, tol):
    hidden = (32, 16)
    module, params, obs = _flax_params(discrete, shared, hidden, compute_dtype, np_dtype)
    ref = module.apply({"params": params}, jnp.asarray(obs))
    net = _port_network(params, discrete, shared, hidden, compute_dtype, torch_dtype)
    with torch.no_grad():
        out = net(torch.tensor(obs))
    assert len(out) == len(ref)
    for got, want in zip(out, ref):
        if compute_dtype is not None:
            assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    if compute_dtype == "bfloat16":
        assert all(p.dtype == torch.float32 for p in net.parameters())


def test_convert_round_trips_actor_critic_params():
    _, params, _ = _flax_params(False, False, (8, 8), None, np.float32)
    net = _port_network(params, False, False, (8, 8), None, torch.float32)
    back = convert.actor_critic_params_to_numpy(net)
    assert set(back) == set(params)
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            for k in leaf:
                np.testing.assert_array_equal(back[name][k], leaf[k], err_msg=f"{name}.{k}")
        else:
            np.testing.assert_array_equal(back[name], leaf)


def test_fresh_network_init_matches_flax_statistics():
    """Orthogonal init: trunk W^T W = 2 I (gain sqrt 2), heads at 0.01 and 1,
    zero biases and log_std, as the flax module initializes them."""
    net = ActorCritic(12, 2, hidden_sizes=(32, 32), generator=torch.Generator().manual_seed(0))
    net.requires_grad_(False)
    w = net.trunks["actor"][1].weight.double()
    torch.testing.assert_close(w @ w.T, 2.0 * torch.eye(32, dtype=torch.float64), atol=1e-5, rtol=0)
    assert float(net.actor_mean.weight.abs().max()) <= 0.01 + 1e-7
    assert all(float(l.bias.abs().max()) == 0.0 for t in net.trunks.values() for l in t)
    assert float(net.log_std.abs().max()) == 0.0
    same = ActorCritic(12, 2, hidden_sizes=(32, 32), generator=torch.Generator().manual_seed(0))
    assert torch.equal(same.critic_value.weight, net.critic_value.weight)


def test_log_prob_entropy_and_action_transform_match_jax():
    rng = np.random.default_rng(5)
    mean = rng.normal(size=(64, 2))
    log_std = np.array([-0.4, 0.3])
    raw = np.tanh(rng.normal(size=(64, 2)) * 2.0)
    raw[0] = [1.0, -1.0]  # the clip at +-(1 - 1e-6)
    ref = jnet.gaussian_log_prob(jnp.asarray(mean), jnp.asarray(log_std), jnp.asarray(raw))
    got = networks.gaussian_log_prob(torch.tensor(mean), torch.tensor(log_std), torch.tensor(raw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
    ref_ent = (jnp.asarray(log_std) + 0.5 * jnp.log(2 * jnp.pi * jnp.e)).sum(-1)
    got_ent = networks.gaussian_entropy(torch.tensor(log_std), (64,))
    np.testing.assert_allclose(got_ent.numpy(), np.broadcast_to(np.asarray(ref_ent), (64,)),
                               rtol=1e-12)
    ref_a = jnet.continuous_action_transform(jnp.asarray(raw), 2e6, 5e-9)
    got_a = networks.continuous_action_transform(torch.tensor(raw), 2e6, 5e-9)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ref_a), rtol=1e-12, atol=0)


def test_samplers_draw_on_the_generator():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    mean, log_std = torch.zeros(4096, 2), torch.tensor([-1.0, 0.5])
    raw, logp = networks.sample_continuous(g1, mean, log_std)
    raw2, _ = networks.sample_continuous(g2, mean, log_std)
    assert torch.equal(raw, raw2) and raw.abs().max() < 1
    np.testing.assert_allclose(logp.numpy(), networks.gaussian_log_prob(mean, log_std, raw).numpy())
    pre = torch.atanh(raw.double())
    np.testing.assert_allclose(pre.std(0).numpy(), np.exp([-1.0, 0.5]), rtol=0.05)
    logits = torch.log(torch.tensor([0.1, 0.2, 0.7])).repeat(20000, 1)
    counts = torch.bincount(networks.sample_discrete(g1, logits), minlength=3).double() / 20000
    np.testing.assert_allclose(counts.numpy(), [0.1, 0.2, 0.7], atol=0.015)


# ------------------------------------------------------------------ the update


def _jax_rollout(discrete, T=4, B=16):
    """A JAX trainer in float64 and a rollout of its policy, as numpy."""
    jenv = JEnv(batch_size=B, config=JEnvConfig(
        include_thermal=False, max_duration=1e-10, dtype="float64", max_steps=3,
        action_mode="discrete" if discrete else "continuous"))
    cfg = JPPOConfig(rollout_steps=T, hidden_sizes=(32, 32), compute_dtype=None)
    trainer = JPPOTrainer(jenv, cfg)
    ts = trainer.init(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: np.asarray(x, np.float64), _np(ts.params))
    if not discrete:
        params["log_std"] = np.asarray([-0.5, -0.2])
    env_state, obs = ts.env_state, ts.obs
    keys = jax.random.split(jax.random.PRNGKey(1), T)
    steps = []
    for t in range(T):
        env_action, raw, log_prob, value = trainer._policy(params, obs, keys[t])
        env_state, out = jenv.step(env_state, env_action)
        steps.append(dict(obs=obs, raw_action=raw, reward=out.reward,
                          done=out.terminated | out.truncated, terminated=out.terminated,
                          log_prob=log_prob, value=value, success=out.info["is_success"]))
        obs = out.obs
    traj = {k: np.stack([np.asarray(s[k]) for s in steps]) for k in steps[0]}
    return trainer, params, traj, np.asarray(obs)


@pytest.mark.parametrize("discrete", [False, True], ids=["continuous", "discrete"])
def test_update_from_traj_matches_jax(discrete):
    jtr, params, traj, last_obs = _jax_rollout(discrete)
    assert traj["done"].any() and not traj["done"].all()
    n = traj["reward"].size
    k_perm = jax.random.PRNGKey(2)
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in jax.random.split(k_perm, jtr.config.num_epochs)])
    jparams, _, jlosses, jauxes = jtr.update_from_traj(
        params, jtr.tx.init(params), {k: jnp.asarray(v) for k, v in traj.items()},
        jnp.asarray(last_obs), k_perm)

    env = make_env(batch=16, dtype="float64", action_mode="discrete" if discrete else "continuous")
    trainer = PPOTrainer(env, PPOConfig(rollout_steps=4, hidden_sizes=(32, 32), compute_dtype=None))
    net = convert.actor_critic_params_from_numpy(params, trainer.make_network().to(torch.float64))
    losses, auxes = trainer.update_from_traj(
        net, trainer.make_optimizer(net), {k: torch.tensor(v) for k, v in traj.items()},
        torch.tensor(last_obs), torch.tensor(perms))

    assert losses.shape == (4, 4)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-8, atol=1e-12)
    for k in ("pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(auxes[k].numpy(), np.asarray(jauxes[k]), rtol=1e-8, atol=1e-12,
                                   err_msg=k)
    got = convert.actor_critic_params_to_numpy(net)
    moved = False
    for name, leaf in _np(jparams).items():
        pairs = leaf.items() if isinstance(leaf, dict) else [("", leaf)]
        for k, want in pairs:
            have = got[name][k] if k else got[name]
            np.testing.assert_allclose(have, want, rtol=1e-8, atol=1e-12, err_msg=f"{name}.{k}")
            ref = params[name][k] if k else params[name]
            moved = moved or not np.array_equal(want, ref)
    assert moved


def test_gae_on_a_hand_made_trajectory():
    T, B, gamma, lam = 5, 3, 0.9, 0.8
    rng = np.random.default_rng(0)
    reward, value = rng.normal(size=(T, B)), rng.normal(size=(T, B))
    done = np.zeros((T, B), bool)
    done[1, 0] = done[4, 1] = done[2, 2] = done[3, 2] = True
    env = make_env(batch=B, dtype="float64")
    trainer = PPOTrainer(env, PPOConfig(rollout_steps=T, gamma=gamma, gae_lambda=lam,
                                        hidden_sizes=(8,), compute_dtype=None))
    net = trainer.make_network().to(torch.float64)
    last_obs = torch.tensor(rng.normal(size=(B, 12)))
    with torch.no_grad():
        last_value = net(last_obs)[-1].numpy()
    traj = dict(reward=torch.tensor(reward), value=torch.tensor(value), done=torch.tensor(done))
    adv, ret = trainer.advantages(net, traj, last_obs)
    want = np.zeros((T, B))
    gae, next_value = np.zeros(B), last_value
    for t in reversed(range(T)):
        nd = 1.0 - done[t]
        delta = reward[t] + gamma * next_value * nd - value[t]
        gae = delta + gamma * lam * nd * gae
        want[t], next_value = gae, value[t]
    np.testing.assert_allclose(adv.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ret.numpy(), want + value, rtol=1e-12, atol=1e-12)
    # A done step bootstraps nothing from the step after it.
    np.testing.assert_allclose(adv.numpy()[4, 1], reward[4, 1] - value[4, 1], rtol=1e-12)


def test_clip_is_optax_global_norm():
    """Above max_norm: g * max / norm exactly (no 1e-6 in the norm)."""
    env = make_env(batch=2, dtype="float64")
    trainer = PPOTrainer(env, PPOConfig(hidden_sizes=(4,), compute_dtype=None, max_grad_norm=0.5))
    net = trainer.make_network().to(torch.float64)
    for i, p in enumerate(net.parameters()):
        p.grad = torch.full_like(p, float(i + 1))
    grads = [p.grad.clone() for p in net.parameters()]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    trainer.clip_grads(net)
    for g, p in zip(grads, net.parameters()):
        torch.testing.assert_close(p.grad, g / norm * 0.5, rtol=1e-15, atol=0)
    for p in net.parameters():
        p.grad = torch.full_like(p, 1e-3)
    trainer.clip_grads(net)
    assert all(torch.equal(p.grad, torch.full_like(p, 1e-3)) for p in net.parameters())


# ------------------------------------------- the JAX package's trainer tests


def test_rollout_shapes_and_summary():
    env = make_env(batch=8)
    state, obs = env.reset(seed=0)
    state, obs, traj = rollout(env, random_policy(env), None, state, obs,
                               torch.Generator().manual_seed(1), num_steps=12)
    assert traj.obs.shape == (12, 8, 12)
    assert traj.reward.shape == (12, 8)
    stats = summarize(traj)
    assert int(stats["steps"]) == 12 * 8
    assert np.isfinite(float(stats["mean_reward"]))


def test_rollout_discrete_policy():
    env = make_env(batch=4, action_mode="discrete")
    state, obs = env.reset(seed=0)
    state, obs, traj = rollout(env, random_policy(env), None, state, obs,
                               torch.Generator().manual_seed(1), num_steps=5)
    a = traj.action.numpy()
    assert a.shape == (5, 4)
    assert (a >= 0).all() and (a < env.num_actions).all()


def test_ppo_trainer_improves_or_at_least_runs():
    env = make_env(batch=32, max_steps=8)
    trainer = PPOTrainer(
        env, PPOConfig(rollout_steps=8, num_epochs=2, num_minibatches=2, hidden_sizes=(32, 32))
    )
    ts = trainer.init(0)
    for _ in range(3):
        ts, metrics = trainer.train_step(ts)
    assert np.isfinite(float(metrics["loss"]))
    assert ts.update_count == 3


def test_ppo_actually_learns_switching():
    """The JAX package's learning gate, on the CPU plain path: the
    deterministic easy-switching regime (polarization 1e-12, damping 0.1:
    the current's sign selects the final pole within one 0.1 ns pulse).
    PPO must reach >= 90% rollout success within 30 updates and gain >= 0.3
    over its first updates."""
    cfg = SpinTorqueEnvConfig(include_thermal=False, max_duration=1e-10, max_steps=4,
                              dtype="float32")
    env = SpinTorqueEnv(batch_size=64, config=cfg, device="cpu",
                        device_params={"polarization": 1e-12, "damping": 0.1})
    trainer = PPOTrainer(
        env,
        PPOConfig(rollout_steps=8, num_epochs=4, num_minibatches=4,
                  hidden_sizes=(64, 64), learning_rate=1e-3, ent_coef=0.01),
    )
    ts = trainer.init(0)
    rates = []
    for _ in range(30):
        ts, metrics = trainer.train_step(ts)
        rates.append(float(metrics["success_rate"]))
    baseline = np.mean(rates[:3])
    trained = np.mean(rates[-5:])
    assert trained >= 0.9, f"PPO failed to learn: final success {trained:.3f}"
    assert trained - baseline >= 0.3, (
        f"no improvement over initial policy: {baseline:.3f} -> {trained:.3f}"
    )


def test_ppo_discrete_mode():
    env = make_env(batch=16, action_mode="discrete", max_steps=8)
    trainer = PPOTrainer(
        env, PPOConfig(rollout_steps=4, num_epochs=1, num_minibatches=2, hidden_sizes=(16, 16))
    )
    ts = trainer.init(0)
    ts, metrics = trainer.train_step(ts)
    assert np.isfinite(float(metrics["loss"]))


def test_ppo_rejects_dict_obs():
    env = make_env(batch=4, observation_mode="dict")
    with pytest.raises(ValueError, match="vector"):
        PPOTrainer(env, PPOConfig())


def test_ppo_bfloat16_compute_dtype():
    env = make_env(batch=32, max_steps=8)
    cfg = dict(rollout_steps=8, num_epochs=2, num_minibatches=2, hidden_sizes=(32, 32))
    tr16 = PPOTrainer(env, PPOConfig(compute_dtype="bfloat16", **cfg))
    ts = tr16.init(0)
    assert all(p.dtype == torch.float32 for p in ts.network.parameters())
    with torch.no_grad():
        mean, log_std, value = ts.network(ts.obs)
    assert mean.dtype == torch.float32 and value.dtype == torch.float32

    tr32 = PPOTrainer(env, PPOConfig(compute_dtype="float32", **cfg))
    net32 = tr32.make_network()
    net32.load_state_dict(ts.network.state_dict())
    with torch.no_grad():
        mean32, _, value32 = net32(ts.obs)
    np.testing.assert_allclose(mean.numpy(), mean32.numpy(), atol=0.05)
    np.testing.assert_allclose(value.numpy(), value32.numpy(), atol=0.05)

    for _ in range(2):
        ts, metrics = tr16.train_step(ts)
    assert np.isfinite(float(metrics["loss"]))


def test_ppo_shared_trunk():
    env = make_env(batch=32, max_steps=8)
    cfg = dict(rollout_steps=8, num_epochs=2, num_minibatches=2, hidden_sizes=(32, 32))
    tr_shared = PPOTrainer(env, PPOConfig(shared_trunk=True, **cfg))
    tr_sep = PPOTrainer(env, PPOConfig(shared_trunk=False, **cfg))
    ts_shared = tr_shared.init(0)
    ts_sep = tr_sep.init(0)
    n_shared = sum(p.numel() for p in ts_shared.network.parameters())
    n_sep = sum(p.numel() for p in ts_sep.network.parameters())
    assert n_shared < 0.7 * n_sep, (n_shared, n_sep)
    assert "shared_dense_0" in convert.actor_critic_params_to_numpy(ts_shared.network)
    for _ in range(2):
        ts_shared, metrics = tr_shared.train_step(ts_shared)
    assert np.isfinite(float(metrics["loss"]))


def test_train_loop_and_its_measurement():
    env = make_env(batch=8, max_steps=4, bf16_rhs=True)
    trainer = PPOTrainer(env, PPOConfig(rollout_steps=2, num_epochs=1, num_minibatches=2,
                                        hidden_sizes=(8,)))
    logged = []
    ts, summary = trainer.train(total_timesteps=48, seed=1, log_every=1,
                                callback=lambda i, m: logged.append((i, m)))
    assert summary["updates"] == 3 and ts.update_count == 3
    assert [i for i, _ in logged] == [0, 1, 2] and np.isfinite(summary["loss"])
    out = measure_train_throughput(trainer, warmup=1, steps=2)
    assert out["device"] == "cpu" and out["env_steps_per_step"] == 16
    assert len(out["rates"]) == 2 and all(r > 0 for r in out["rates"])
    assert all(ms > 0 for ms in out["rollout_ms"] + out["update_ms"])
    assert out["state"].update_count == 3
    with pytest.raises(ValueError):
        measure_train_throughput(trainer, steps=1, sync_debug_mode="error")


def test_import_loads_no_jax():
    code = (
        "import sys, spintorque_tpu_torch, spintorque_tpu_torch.rl, spintorque_tpu_torch.convert;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'spintorque_tpu')]; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
