"""The 'model' mesh axis: the tensor-parallel policy over gloo ranks on the CPU.

Counterpart of tests/integration/test_sharding.py's tensor-parallel PPO
test. Each mesh, (data 1, model 2) and (data 2, model 2), is spawned once
(``parallel.spawn_ranks``, a ``file://`` rendezvous in a fresh temporary
directory) by a module fixture; every rank runs all the checks below and
the tests read what they return. Tolerances:

  * the sharded network's forward and gradients against the unsharded
    network with the same seed, float64: rtol 1e-12, atol 1e-14 (the
    row-parallel sum adds the two halves' partial products in another
    order); the gathered parameters equal the unsharded ones bit for bit
    (both draw whole weights from one generator);
  * under compute_dtype='bfloat16': the partial products are all-reduced in
    float32 and the outputs agree with the unsharded network within 2^-6
    of their largest magnitude (a few bf16 ulps: both round the row-
    parallel layer's output once, from different sums);
  * one ``update_from_traj`` on a fixed float64 trajectory against the
    world-size-1 trainer and against the JAX trainer's ``update_from_traj``
    with its parameters placed by their PartitionSpecs on a (data 4, model
    2) mesh of the 8 fake CPU devices, both on the global permutation whose
    minibatches are the union of the data ranks' (as
    tests/test_torch_distributed.py holds the data-parallel update): rtol
    1e-8, atol 1e-12, the order of the sums being the only difference;
  * the clip's global norm against the unsharded network's: rtol 1e-12;
  * two train steps on a (1, 2) mesh against a world-size-1 trainer from
    the same seed, float32 as a trainer runs, thermal off, short pulses
    (not chaotic): rtol 1e-5, atol 1e-6 on the env state and every
    parameter (3e-8 seen: the row-parallel sums' rounding); model ranks of
    one data coordinate hold the same env states bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding

from spintorque_tpu.envs import SpinTorqueEnv as JEnv
from spintorque_tpu.envs import SpinTorqueEnvConfig as JEnvConfig
from spintorque_tpu.parallel import make_mesh as jax_make_mesh
from spintorque_tpu.rl import PPOConfig as JPPOConfig
from spintorque_tpu.rl import PPOTrainer as JPPOTrainer
from spintorque_tpu_torch import convert
from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu_torch.parallel import MODEL_ALL_REDUCES, make_mesh, spawn_ranks
from spintorque_tpu_torch.rl import ActorCritic, PPOConfig, PPOTrainer
from spintorque_tpu_torch.utils import (
    load_params,
    load_train_state,
    save_params,
    save_train_state,
)

torch.set_num_threads(1)

T, B, N_MB, EPOCHS = 4, 16, 4, 4
CFG = dict(rollout_steps=T, hidden_sizes=(32, 32), compute_dtype=None)
# (hidden sizes, shared trunk, discrete): two and three hidden layers (the
# odd count ends on a sharded activation, gathered for the heads), a shared
# trunk, and both heads.
CASES = [((8, 8), False, False), ((8, 8, 8), False, False), ((8, 8), True, True),
         ((16, 8, 16), True, False), ((8,), False, True)]
TRAIN_B = 32


def _env(batch, mesh=None, dtype="float64"):
    return SpinTorqueEnv(batch_size=batch, device="cpu", mesh=mesh, config=SpinTorqueEnvConfig(
        include_thermal=False, max_duration=1e-10, dtype=dtype, max_steps=3))


# The train steps run as a trainer runs: float32 env, network and compute.
TRAIN_CFG = PPOConfig(rollout_steps=4, num_epochs=2, num_minibatches=2, hidden_sizes=(16, 16, 16))


def _net(mesh=None, dtype=torch.float64, hidden=(8, 8), shared=False, discrete=False,
         compute_dtype=None):
    net = ActorCritic(12, 5 if discrete else 2, discrete=discrete, hidden_sizes=hidden,
                      shared_trunk=shared, compute_dtype=compute_dtype, mesh=mesh,
                      generator=torch.Generator().manual_seed(3))
    return net.to(dtype)


def _outputs_loss(outs):
    g = torch.Generator().manual_seed(5)
    return sum((o * torch.randn(o.shape, generator=g, dtype=o.dtype)).sum() for o in outs)


def _network_checks(mesh, obs):
    """Forward, backward and layout of each case against the unsharded
    network; bf16 partial sums; the divisibility check."""
    out = {"cases": []}
    x = torch.tensor(obs)
    for hidden, shared, discrete in CASES:
        ref = _net(None, hidden=hidden, shared=shared, discrete=discrete)
        tp = _net(mesh, hidden=hidden, shared=shared, discrete=discrete)
        want, got = ref(x), tp(x)
        _outputs_loss(want).backward()
        _outputs_loss(got).backward()
        out["cases"].append(dict(
            want=[o.detach() for o in want], got=[o.detach() for o in got],
            full=tp.full_state_dict(), ref=ref.state_dict(),
            grads={n: tp.gather_shard(n, p.grad) for n, p in tp.named_parameters()},
            ref_grads={n: p.grad for n, p in ref.named_parameters()},
            shapes={n: tuple(p.shape) for n, p in tp.named_parameters()},
            ref_shapes={n: tuple(p.shape) for n, p in ref.named_parameters()}))

    seen = []
    all_reduce = dist.all_reduce

    def spy(t, *args, **kwargs):
        if kwargs.get("group") is mesh.model_group:
            seen.append(t.dtype)
        return all_reduce(t, *args, **kwargs)

    dist.all_reduce = spy
    try:
        tp = _net(mesh, torch.float32, hidden=(16, 16), compute_dtype="bfloat16")
        got = tp(x.float())
    finally:
        dist.all_reduce = all_reduce
    want = _net(None, torch.float32, hidden=(16, 16), compute_dtype="bfloat16")(x.float())
    out["bf16"] = dict(got=[o.detach() for o in got], want=[o.detach() for o in want],
                       dtypes=seen)
    out["errors"] = {}
    for name, hidden in (("even", (7, 8)), ("third", (8, 8, 5))):
        try:
            _net(mesh, hidden=hidden)
            out["errors"][name] = None
        except ValueError as e:
            out["errors"][name] = str(e)
    out["odd_layer_output"] = tuple(_net(mesh, hidden=(8, 7)).critic_value.weight.shape)
    return out


def _update_checks(mesh, params, traj, last_obs, perms, mb_rows):
    trainer = PPOTrainer(_env(B, mesh), PPOConfig(**CFG))
    r, n = mesh.data_rank, trainer.env.local_batch_size
    net = convert.actor_critic_params_from_numpy(params, trainer.make_network().double())
    local = {k: torch.tensor(v[:, r * n:(r + 1) * n]) for k, v in traj.items()}

    # The clip's norm on one minibatch of the same rows on every rank.
    ref = convert.actor_critic_params_from_numpy(
        params, PPOTrainer(_env(B), PPOConfig(**CFG)).make_network().double())
    flat = {k: torch.tensor(v.reshape((-1,) + v.shape[2:])[mb_rows]) for k, v in traj.items()}
    mb = dict(obs=flat["obs"], raw_action=flat["raw_action"], log_prob=flat["log_prob"],
              value=flat["value"], advantage=flat["reward"], ret=flat["reward"] + 1.0)
    norms = []
    for network in (net, ref):
        trainer.loss(network, mb)[0].backward()
        norms.append(trainer.grad_norm(network))
        trainer.clip_grads(network)
    clipped = {k: net.gather_shard(k, p.grad) for k, p in net.named_parameters()}
    ref_clipped = {k: p.grad.clone() for k, p in ref.named_parameters()}
    net.zero_grad(set_to_none=True)

    MODEL_ALL_REDUCES.reset()
    losses, auxes = trainer.update_from_traj(
        net, trainer.make_optimizer(net), local,
        torch.tensor(last_obs[r * n:(r + 1) * n]), torch.tensor(perms[r]))
    count = MODEL_ALL_REDUCES.count
    return dict(params=convert.actor_critic_params_to_numpy(net), losses=losses, auxes=auxes,
                norm=norms[0].detach(), ref_norm=norms[1].detach(), clipped=clipped,
                ref_clipped=ref_clipped, model_all_reduces=count)


def _train_checks(mesh, workdir):
    trainer = PPOTrainer(_env(TRAIN_B, mesh, "float32"), TRAIN_CFG)
    ts = trainer.init(0)
    states = []
    for _ in range(2):
        ts, metrics = trainer.train_step(ts)
        states.append(dict(m=ts.env_state.m.clone(), obs=ts.obs.clone()))
    rank = dist.get_rank()
    path = f"{workdir}/train_state_{mesh.shape['data']}_{rank}.pt"
    save_train_state(path, ts)
    params_path = f"{workdir}/params_{mesh.shape['data']}_{rank}.pt"
    save_params(params_path, ts.network)
    back = load_train_state(path, trainer)
    same_shards = all(torch.equal(a, b) for a, b in zip(back.network.parameters(),
                                                        ts.network.parameters()))
    moments = [(s["exp_avg"], s["exp_avg_sq"]) for s in ts.optimizer.state_dict()["state"].values()]
    back_moments = [(s["exp_avg"], s["exp_avg_sq"])
                    for s in back.optimizer.state_dict()["state"].values()]
    same_moments = all(torch.equal(a, c) and torch.equal(b, d)
                       for (a, b), (c, d) in zip(moments, back_moments))
    return dict(states=states, metrics=metrics, full=ts.network.full_state_dict(),
                shard_numel=sum(p.numel() for p in ts.network.parameters()),
                path=path, params_path=params_path, same_shards=same_shards,
                same_moments=same_moments)


def _tp_rank(n_data, obs, params, traj, last_obs, perms, mb_rows, workdir):
    mesh = make_mesh(n_data=n_data, n_model=2, device="cpu")
    return dict(ranks=(mesh.data_rank, mesh.model_rank),
                network=_network_checks(mesh, obs),
                update=_update_checks(mesh, params, traj, last_obs, perms, mb_rows),
                train=_train_checks(mesh, workdir))


# ------------------------------------------------------------------ fixtures


def _jax_trainer(mesh=None):
    jenv = JEnv(batch_size=B, config=JEnvConfig(
        include_thermal=False, max_duration=1e-10, dtype="float64", max_steps=3))
    return JPPOTrainer(jenv, JPPOConfig(**CFG), mesh=mesh)


@pytest.fixture(scope="module")
def rollout():
    """A float64 JAX trainer's parameters and a rollout of its policy, as
    numpy."""
    trainer = _jax_trainer()
    ts = trainer.init(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: np.asarray(x, np.float64), ts.params)
    params["log_std"] = np.asarray([-0.5, -0.2])
    env_state, obs = ts.env_state, ts.obs
    steps = []
    for key in jax.random.split(jax.random.PRNGKey(1), T):
        env_action, raw, log_prob, value = trainer._policy(params, obs, key)
        env_state, out = trainer.env.step(env_state, env_action)
        steps.append(dict(obs=obs, raw_action=raw, reward=out.reward,
                          done=out.terminated | out.truncated, log_prob=log_prob, value=value))
        obs = out.obs
    traj = {k: np.stack([np.asarray(s[k]) for s in steps]) for k in steps[0]}
    return params, traj, np.asarray(obs)


def _union(perms):
    """The global permutation per epoch whose minibatches are the union of
    the data ranks' local minibatches (rank r's local row t*B/W + b is
    global row t*B + r*B/W + b)."""
    w = perms.shape[0]
    b_local, size = B // w, T * B // w // N_MB

    def global_row(r, local):
        return (local // b_local) * B + r * b_local + local % b_local

    return np.stack([
        np.concatenate([global_row(r, perms[r, e, i * size:(i + 1) * size])
                        for i in range(N_MB) for r in range(w)])
        for e in range(EPOCHS)])


_RUNS = {}


def _spawn(n_data, rollout, tmp_path_factory):
    """Every rank's checks on the (n_data, 2) mesh, spawned once per mesh."""
    if n_data in _RUNS:
        return _RUNS[n_data]
    params, traj, last_obs = rollout
    rng = np.random.default_rng(11)
    n_local = T * B // n_data
    perms = np.stack([np.stack([rng.permutation(n_local) for _ in range(EPOCHS)])
                      for _ in range(n_data)])
    obs = np.random.default_rng(4).normal(size=(6, 12))
    workdir = tmp_path_factory.mktemp(f"tp{n_data}")
    out = spawn_ranks(_tp_rank, 2 * n_data, timeout=240.0, workdir=str(workdir),
                      args=(n_data, obs, params, traj, last_obs, perms, np.arange(8),
                            str(workdir)))
    _RUNS[n_data] = dict(n_data=n_data, perms=perms, union=_union(perms), out=out)
    return _RUNS[n_data]


@pytest.fixture(params=[1, 2], ids=["mesh_1x2", "mesh_2x2"])
def tp(request, rollout, tmp_path_factory):
    return _spawn(request.param, rollout, tmp_path_factory)


@pytest.fixture
def tp_1x2(rollout, tmp_path_factory):
    return _spawn(1, rollout, tmp_path_factory)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# --------------------------------------------------------------------- tests


def test_ranks_lie_on_the_mesh(tp):
    got = sorted(o["ranks"] for o in tp["out"])
    assert got == [(d, m) for d in range(tp["n_data"]) for m in range(2)]


def test_sharded_forward_equals_unsharded(tp):
    for o in tp["out"]:
        for case, c in zip(CASES, o["network"]["cases"]):
            assert len(c["got"]) == len(c["want"]), case
            for got, want in zip(c["got"], c["want"]):
                _close(got, want, rtol=1e-12, atol=1e-14, err_msg=str(case))


def test_sharded_gradients_equal_unsharded(tp):
    for o in tp["out"]:
        for case, c in zip(CASES, o["network"]["cases"]):
            for name, want in c["ref_grads"].items():
                _close(c["grads"][name], want, rtol=1e-12, atol=1e-14,
                       err_msg=f"{case} {name}")


def test_gathered_init_equals_unsharded_bit_for_bit(tp):
    for o in tp["out"]:
        for case, c in zip(CASES, o["network"]["cases"]):
            assert c["full"].keys() == c["ref"].keys()
            for name, want in c["ref"].items():
                assert torch.equal(c["full"][name], want), f"{case} {name}"


def test_each_rank_holds_only_its_shard(tp):
    """Even layers: half the rows (output features) and half the bias; odd
    layers: half the columns (input features) and the whole bias; heads
    whole. The two model ranks of a data coordinate hold different halves."""
    by_model = {}
    for o in tp["out"]:
        for case, c in zip(CASES, o["network"]["cases"]):
            for name, full in c["ref_shapes"].items():
                shape = c["shapes"][name]
                if name.startswith("trunks."):
                    i = int(name.split(".")[2])
                    if i % 2 == 0:
                        assert shape == (full[0] // 2,) + full[1:], (case, name)
                    elif name.endswith("weight"):
                        assert shape == (full[0], full[1] // 2), (case, name)
                    else:
                        assert shape == full, (case, name)
                else:
                    assert shape == full, (case, name)
        by_model.setdefault(o["ranks"][1], o["train"]["shard_numel"])
    total = sum(v.numel() for v in tp["out"][0]["train"]["full"].values())
    assert by_model[0] == by_model[1] < total


def test_bf16_partial_sums_run_in_float32(tp):
    for o in tp["out"]:
        b = o["network"]["bf16"]
        # Two trunks of (16, 16): one row-parallel all-reduce each.
        assert b["dtypes"] == [torch.float32, torch.float32]
        for got, want in zip(b["got"], b["want"]):
            assert got.dtype == torch.float32
            scale = float(want.abs().max())
            _close(got, want, rtol=0, atol=2.0**-6 * scale)


def test_indivisible_hidden_size_raises(tp):
    for o in tp["out"]:
        errors = o["network"]["errors"]
        assert "[7]" in errors["even"] and "[5]" in errors["third"]
        assert o["network"]["odd_layer_output"] == (1, 7)  # an odd layer's output is whole


def test_clip_norm_is_the_global_norm(tp):
    for o in tp["out"]:
        u = o["update"]
        _close(u["norm"], u["ref_norm"], rtol=1e-12, atol=0)
        assert float(u["ref_norm"]) > PPOConfig().max_grad_norm  # the clip acts
        for name, want in u["ref_clipped"].items():
            _close(u["clipped"][name], want, rtol=1e-12, atol=1e-14, err_msg=name)


def _flat_params(tree):
    out = {}
    for name, leaf in tree.items():
        for k, v in (leaf.items() if isinstance(leaf, dict) else [("", leaf)]):
            out[f"{name}.{k}"] = np.asarray(v)
    return out


def test_update_equals_world_size_one_trainer(tp, rollout):
    params, traj, last_obs = rollout
    trainer = PPOTrainer(_env(B), PPOConfig(**CFG))
    net = convert.actor_critic_params_from_numpy(params, trainer.make_network().double())
    losses, auxes = trainer.update_from_traj(
        net, trainer.make_optimizer(net), {k: torch.tensor(v) for k, v in traj.items()},
        torch.tensor(last_obs), torch.tensor(tp["union"]))
    want = _flat_params(convert.actor_critic_params_to_numpy(net))
    for o in tp["out"]:
        u = o["update"]
        _close(u["losses"], losses, rtol=1e-8, atol=1e-12)
        for k in auxes:
            _close(u["auxes"][k], auxes[k], rtol=1e-8, atol=1e-12, err_msg=k)
        got = _flat_params(u["params"])
        for k, v in want.items():
            _close(got[k], v, rtol=1e-8, atol=1e-12, err_msg=k)
    first = _flat_params(tp["out"][0]["update"]["params"])
    for o in tp["out"][1:]:  # every rank gathers the same whole network
        for k, v in _flat_params(o["update"]["params"]).items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)


def test_update_equals_jax_on_a_data_model_mesh(tp, rollout, monkeypatch):
    params, traj, last_obs = rollout
    mesh = jax_make_mesh(n_data=4, n_model=2)
    jtr = _jax_trainer(mesh)
    jtr.init(jax.random.PRNGKey(0))  # the parameters' PartitionSpecs
    placed = jax.tree.map(lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
                          params, jtr.param_specs)
    assert len(placed["actor_dense_0"]["kernel"].sharding.device_set) == 8
    k_perm = jax.random.PRNGKey(2)
    by_key = {np.asarray(k).tobytes(): tp["union"][e]
              for e, k in enumerate(jax.random.split(k_perm, EPOCHS))}
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n: jnp.asarray(by_key[np.asarray(key).tobytes()]))
    with jax.disable_jit():  # concrete epoch keys, so the permutation is looked up
        jparams, _, jlosses, jauxes = jtr.update_from_traj(
            placed, jtr.tx.init(placed), {k: jnp.asarray(v) for k, v in traj.items()},
            jnp.asarray(last_obs), k_perm)
    want = _flat_params(jax.tree.map(np.asarray, jparams))
    for o in tp["out"]:
        u = o["update"]
        _close(u["losses"], jlosses, rtol=1e-8, atol=1e-12)
        for k in ("pg_loss", "v_loss", "entropy"):
            _close(u["auxes"][k], jauxes[k], rtol=1e-8, atol=1e-12, err_msg=k)
        got = _flat_params(u["params"])
        for k, v in want.items():
            _close(got[k], v, rtol=1e-8, atol=1e-12, err_msg=k)


def test_model_all_reduces_per_update(tp):
    """Per minibatch step: one row-parallel all-reduce per trunk in the
    forward, none in the backward of a (32, 32) trunk (its column-parallel
    layer's input is the observation), one for the clip's norm; plus the
    bootstrap value's forward."""
    for o in tp["out"]:
        assert o["update"]["model_all_reduces"] == EPOCHS * N_MB * 3 + 2


def test_model_ranks_step_the_same_envs(tp):
    """Model ranks of one data coordinate draw the same actions and hold
    the same env rows bit for bit; data coordinates hold different rows."""
    by_data = {}
    for o in tp["out"]:
        by_data.setdefault(o["ranks"][0], []).append(o["train"]["states"])
    for states in by_data.values():
        a, b = states
        for sa, sb in zip(a, b):
            assert torch.equal(sa["m"], sb["m"]) and torch.equal(sa["obs"], sb["obs"])
            assert sa["m"].shape[0] == TRAIN_B // tp["n_data"]
    if tp["n_data"] == 2:
        assert not torch.equal(by_data[0][0][-1]["m"], by_data[1][0][-1]["m"])
    first = tp["out"][0]["train"]
    for o in tp["out"]:
        for k, v in o["train"]["full"].items():
            assert torch.equal(v, first["full"][k]), k
        for k, v in o["train"]["metrics"].items():
            assert torch.equal(v, first["metrics"][k]), k


def test_checkpoints_reshard_on_the_mesh(tp):
    """Each rank saves the gathered whole state; loaded on the mesh it gives
    back each rank's shards and Adam moments bit for bit."""
    for o in tp["out"]:
        assert o["train"]["same_shards"] and o["train"]["same_moments"]


def test_checkpoints_load_in_one_process(tp_1x2):
    """One process without a mesh loads a (1, 2) rank's train state (whole
    parameters and Adam moments) and its saved parameters, and trains on."""
    trainer = PPOTrainer(_env(TRAIN_B, dtype="float32"), TRAIN_CFG)
    rank0 = tp_1x2["out"][0]["train"]
    ts = load_train_state(rank0["path"], trainer)
    for k, v in ts.network.state_dict().items():
        assert torch.equal(v, rank0["full"][k]), k
    for p, s in zip(ts.network.parameters(), ts.optimizer.state_dict()["state"].values()):
        assert s["exp_avg"].shape == p.shape
    ts, metrics = trainer.train_step(ts)  # training resumes without a mesh
    assert all(np.isfinite(float(v)) for v in metrics.values())
    net = load_params(rank0["params_path"], target=trainer.make_network())
    for k, v in net.state_dict().items():
        assert torch.equal(v, rank0["full"][k]), k


def test_train_steps_equal_world_size_one_trainer(tp_1x2):
    """A (1, 2) mesh holds the whole batch and draws as one process: its
    two train steps equal the unsharded trainer's from the same seed."""
    trainer = PPOTrainer(_env(TRAIN_B, dtype="float32"), TRAIN_CFG)
    ts = trainer.init(0)
    for _ in range(2):
        ts, _ = trainer.train_step(ts)
    got = tp_1x2["out"][0]["train"]
    _close(got["states"][-1]["m"], ts.env_state.m, rtol=1e-5, atol=1e-6)
    for k, v in ts.network.state_dict().items():
        _close(got["full"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
