"""A global batch that does not divide the data axis, on two gloo ranks.

The JAX package replicates such a batch: ``shard_env_state`` places every
array whose leading dimension is 1 or does not divide the data axis
replicated (``spintorque_tpu/parallel/mesh.py:66``), and
``integrate_pulse_pallas(mesh=...)`` runs it through the unsharded kernel
(``spintorque_tpu/ops/pallas_integrator.py:639-646``), which the sweeps rely
on (``spintorque_tpu/research/sweeps.py:51-63``). The port does the same:
every rank holds all B rows (``parallel.local_rows``) and runs them as one
process does, at env offset 0.

Held against JAX, B = 5, 7 and 9 on a data axis of 2:

  * ``integrate_pulse(mesh=split_mesh(B, mesh))`` on a deterministic RK4
    pulse, against ``integrate_pulse_pallas(mesh=...)`` on two of the 8 fake
    devices in interpret mode: float32 rtol = atol = 2e-6 (the Pallas
    path's tolerance of tests/test_torch_integrator.py, tighter than the
    1e-5 of tests/test_torch_subnormal_parity.py), n and failed identical.
    Thermal, each rank's draws are the unsharded stream's: bit for bit with
    ``integrate_pulse_plain`` at env offset 0.
  * The placement: ``shard_env_state`` replicates the arrays JAX's
    replicates (an indivisible and a size-1 leading dimension) and splits
    the rest; an env of 5 holds all 5 rows on each rank and steps them as
    one process does, thermal noise and auto-reset included.
  * The sweeps: ``switching_probability_diagram`` and
    ``parameter_ladder_sweep`` without thermal noise against JAX's sweeps
    through ``integrate_pulse_pallas`` in interpret mode (p_switch and the
    failed fraction equal, final m_z at 2e-6); with thermal noise, bit for
    bit with the one-process sweep on both ranks.
  * The rollout statistics: ``compare_policies`` and ``summarize`` on the
    replicated env of 5 count each row once, as the one-process run does
    (an all-reduce over the ranks would count it twice).
  * The callers whose JAX counterparts need a divisible batch raise as
    those do, naming the JAX line: ``PPOTrainer`` (``rl/ppo.py:120``),
    ``measure_env_throughput`` (``utils/benchmark.py:86``),
    ``local_batch_size`` (``parallel/mesh.py:97``) and ``shard_batch``
    (``parallel/mesh.py:75``).

One spawn of two ranks runs every part (~15 s); each test reads its part,
so a failing part fails only its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import PartitionSpec as P

from spintorque_tpu.envs import SpinTorqueEnv as JEnv
from spintorque_tpu.envs import SpinTorqueEnvConfig as JEnvConfig
from spintorque_tpu.ops.pallas_integrator import integrate_pulse_pallas
from spintorque_tpu.parallel import local_batch_size as jax_local_batch_size
from spintorque_tpu.parallel import make_mesh as jax_make_mesh
from spintorque_tpu.parallel import shard_batch as jax_shard_batch
from spintorque_tpu.parallel import shard_env_state as jax_shard_env_state
from spintorque_tpu.physics import IntegratorConfig as JConfig
from spintorque_tpu.physics import LLGSParams as JParams
from spintorque_tpu.research import parameter_ladder_sweep as jax_ladder
from spintorque_tpu.research import switching_probability_diagram as jax_diagram
from spintorque_tpu.rl import PPOConfig as JPPOConfig
from spintorque_tpu.rl import PPOTrainer as JPPOTrainer
from spintorque_tpu.utils.benchmark import measure_env_throughput as jax_measure_env
from spintorque_tpu_torch import parallel
from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu_torch.parallel import (
    local_batch_size,
    make_mesh,
    shard_batch,
    shard_env_state,
    spawn_ranks,
)
from spintorque_tpu_torch.physics import IntegratorConfig, LLGSParams, integrate_pulse
from spintorque_tpu_torch.physics import integrate_pulse_plain
from spintorque_tpu_torch.research import parameter_ladder_sweep, switching_probability_diagram
from spintorque_tpu_torch.research.benchmarking import compare_policies
from spintorque_tpu_torch.rl import PPOConfig, PPOTrainer
from spintorque_tpu_torch.utils import measure_env_throughput

torch.set_num_threads(1)

W = 2
TOL = 2e-6
PULSE_BATCHES = (5, 7)
PARAMS = dict(saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
              volume=1e-23, polarization=0.7, easy_axis=np.array([0.0, 0.0, 1.0]))
DET = dict(method="rk4", max_substeps=512)
THERMAL = dict(method="rk4", max_substeps=512, thermal=True, rk4_noise="per_stage")
# The sweeps' device (tests/unit/test_research_sweeps.py), 3 currents x 1
# duration x 3 trajectories = 9 rows; the ladder 3 points x 3 = 9 rows.
SWEEP_PARAMS = dict(PARAMS, damping=0.05, volume=1e-22)
SWEEP = dict(currents=np.array([-2e11, 0.0, 2e11]), durations=np.array([2e-10]), n_ensemble=3)
LADDER = dict(vary={"damping": np.array([0.01, 0.05, 0.1])}, current=2e11, duration=2e-10,
              n_ensemble=3)
ENV_BATCH, ENV_STEPS = 5, 4


def _setup(B, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(B, 3))
    m = m / np.linalg.norm(m, axis=-1, keepdims=True)
    spans = rng.uniform(5e-11, 1.5e-10, B)
    cur = rng.uniform(-200.0, 200.0, B)
    return m.T.astype(np.float32), spans.astype(np.float32), cur.astype(np.float32)


def _torch_params(p=PARAMS):
    return LLGSParams(**{k: torch.tensor(np.asarray(v, np.float32)) for k, v in p.items()})


def _jax_params(p=PARAMS):
    return JParams(**{k: jnp.asarray(np.asarray(v, np.float32)) for k, v in p.items()})


def _pulse_args(B):
    m, spans, cur = _setup(B, seed=B)
    return (tuple(torch.from_numpy(x) for x in m), torch.from_numpy(spans),
            torch.from_numpy(cur), _torch_params())


def _env(batch, mesh=None, **kw):
    cfg = dict(max_duration=1e-10, max_steps=3)
    cfg.update(kw)
    return SpinTorqueEnv(batch_size=batch, config=SpinTorqueEnvConfig(**cfg), device="cpu",
                         mesh=mesh)


def _env_actions():
    rng = np.random.default_rng(3)
    return np.stack([rng.uniform(-2e6, 2e6, (ENV_STEPS, ENV_BATCH)),
                     rng.uniform(1e-12, 1e-10, (ENV_STEPS, ENV_BATCH))], -1).astype(np.float32)


def _env_block(env, actions, mesh=None):
    state, obs = env.reset(seed=5)
    out = {"obs": [obs], "reward": [], "m": []}
    for a in actions:
        a = torch.from_numpy(a)
        state, ts = env.step(state, a if mesh is None else a[parallel.local_rows(len(a), mesh)])
        out["obs"].append(ts.obs)
        out["reward"].append(ts.reward)
        out["m"].append(state.m)
    return {k: torch.stack(v) for k, v in out.items()}


def _tree():
    rng = np.random.default_rng(1)
    return {"odd": rng.normal(size=(5, 3)).astype(np.float32),
            "one": rng.normal(size=(1, 3)).astype(np.float32),
            "even": rng.normal(size=(4, 2)).astype(np.float32),
            "scalar": np.float32(2.5)}


# ------------------------------------------------------------ rank bodies


def _pulse_part(mesh):
    out = {}
    for B in PULSE_BATCHES:
        args = _pulse_args(B)
        split = parallel.split_mesh(B, mesh)
        det = integrate_pulse(*args, IntegratorConfig(**DET), mesh=split)
        thermal = integrate_pulse(*args, IntegratorConfig(**THERMAL), seed=9, mesh=split)
        out[B] = {name: (torch.stack(r.m), r.n_substeps, r.failed)
                  for name, r in (("det", det), ("thermal", thermal))}
    return out


def _placement_part(mesh):
    placed = shard_env_state({k: torch.tensor(v) for k, v in _tree().items()}, mesh)
    env = _env(ENV_BATCH, mesh)
    state, _ = env.reset(seed=0)
    ref = shard_env_state(_env(ENV_BATCH).reset(seed=0)[0], mesh)
    same = all(torch.equal(getattr(state, k), getattr(ref, k))
               for k in ("m", "target", "step", "total_energy", "episode_return"))
    return dict(placed=placed, rows=env.local_batch_size, replicated=env.replicated,
                same_as_placed_global=same,
                block=_env_block(_env(ENV_BATCH, mesh), _env_actions(), mesh))


def _sweep_part(mesh):
    p = _torch_params(SWEEP_PARAMS)
    out = {}
    for temperature in (0.0, 300.0):
        out[temperature] = dict(
            diagram=switching_probability_diagram(p, **SWEEP, temperature=temperature, seed=3,
                                                  mesh=mesh),
            ladder=parameter_ladder_sweep(p, **LADDER, temperature=temperature, seed=3,
                                          mesh=mesh))
    return out


def _policies_part(mesh):
    env = _env(ENV_BATCH, mesh)
    state, obs = env.reset(seed=2)
    _, _, traj = parallel.rollout(env, parallel.random_policy(env), None, state, obs,
                                  torch.Generator().manual_seed(4), ENV_STEPS)
    return dict(compare=compare_policies(env, _policies(env), horizon=ENV_STEPS, seed=1),
                summary=parallel.summarize(traj, env))


def _policies(env):
    return {"random": parallel.random_policy(env),
            "constant": lambda params, obs, generator: torch.tensor([5e5, 5e-11]).expand(
                obs.shape[0], 2)}


def _raising_part(mesh):
    calls = {
        "ppo": lambda: PPOTrainer(_env(ENV_BATCH, mesh), PPOConfig(hidden_sizes=(8,))),
        "measure_env_throughput": lambda: measure_env_throughput(
            _env(ENV_BATCH, mesh), n_inner=1, warmup=0, blocks=1, iters_per_block=1),
        "local_batch_size": lambda: local_batch_size(ENV_BATCH, mesh),
        "shard_batch": lambda: shard_batch(torch.zeros(ENV_BATCH, 3), mesh),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


PARTS = {"pulse": _pulse_part, "placement": _placement_part, "sweep": _sweep_part,
         "policies": _policies_part, "raising": _raising_part}


def _rank():
    mesh = make_mesh(device="cpu")
    out = {"data_rank": mesh.data_rank}
    for name, part in PARTS.items():
        try:
            out[name] = part(mesh)
        except Exception as e:  # noqa: BLE001 - reported by the part's test
            out[name] = f"{type(e).__name__}: {e}"
    return out


@pytest.fixture(scope="module")
def ranks():
    out = spawn_ranks(_rank, W, timeout=240.0)
    return sorted(out, key=lambda o: o["data_rank"])


def _part(ranks, name):
    parts = [o[name] for o in ranks]
    for p in parts:
        assert not isinstance(p, str), p
    return parts


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(n_data=W, devices=jax.devices()[:W])


# ------------------------------------------------------------------ tests


def test_helpers_replicate_what_jax_replicates():
    """One process, a mesh of 2 laid out by hand: which batches replicate."""
    mesh = parallel.Mesh({"data": 2, "model": 1}, torch.device("cpu"))
    replicates, local_rows = parallel.replicates, parallel.local_rows
    assert [replicates(b, mesh) for b in (1, 2, 5, 8)] == [True, False, True, False]
    assert local_rows(5, mesh) == slice(0, 5) and local_rows(8, mesh) == slice(0, 4)
    assert not replicates(5, None) and local_rows(5, None) == slice(0, 5)


@pytest.mark.parametrize("B", PULSE_BATCHES)
def test_pulse_on_an_indivisible_batch_matches_jax(ranks, jax_mesh, B):
    m, spans, cur = _setup(B, seed=B)
    with pltpu.force_tpu_interpret_mode():
        (jx, jy, jz), jn, _, jfailed = integrate_pulse_pallas(
            tuple(jnp.asarray(x) for x in m), jnp.asarray(spans), jnp.asarray(cur),
            _jax_params(), JConfig(**DET), mesh=jax_mesh)
    want = np.stack([np.asarray(x) for x in (jx, jy, jz)])
    thermal = integrate_pulse_plain(*_pulse_args(B), IntegratorConfig(**THERMAL), seed=9,
                                    env_offset=0)
    for o in _part(ranks, "pulse"):
        got_m, got_n, got_failed = o[B]["det"]
        np.testing.assert_allclose(got_m.numpy(), want, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(got_failed.numpy(), np.asarray(jfailed))
        got_m, got_n, got_failed = o[B]["thermal"]
        assert torch.equal(got_m, torch.stack(thermal.m))
        assert torch.equal(got_n, thermal.n_substeps)
        assert torch.equal(got_failed, thermal.failed)


def test_placement_replicates_indivisible_and_size_one_arrays(ranks, jax_mesh):
    tree = _tree()
    placed = jax_shard_env_state({k: jnp.asarray(v) for k, v in tree.items()}, jax_mesh)
    replicated = {k: v.sharding.spec == P() for k, v in placed.items()}
    assert replicated == {"odd": True, "one": True, "even": False, "scalar": True}
    for r, o in enumerate(_part(ranks, "placement")):
        for k, v in tree.items():
            want = v if replicated[k] or np.ndim(v) == 0 else np.split(v, W)[r]
            np.testing.assert_array_equal(o["placed"][k].numpy(), want, err_msg=k)
        assert o["rows"] == ENV_BATCH and o["replicated"] and o["same_as_placed_global"]
    ref = _env_block(_env(ENV_BATCH), _env_actions())
    for o in _part(ranks, "placement"):
        for k, v in ref.items():
            assert torch.equal(o["block"][k], v), k


def test_sweeps_on_an_indivisible_batch_match_jax(ranks, jax_mesh):
    with pltpu.force_tpu_interpret_mode():
        jd = jax_diagram(_jax_params(SWEEP_PARAMS), **SWEEP, temperature=0.0, mesh=jax_mesh,
                         use_pallas=True)
        jl = jax_ladder(_jax_params(SWEEP_PARAMS), **LADDER, temperature=0.0, mesh=jax_mesh)
    assert np.asarray(jd["p_switch"]).ravel().tolist() == [1.0, 0.0, 1.0]
    p = _torch_params(SWEEP_PARAMS)
    one = dict(diagram=switching_probability_diagram(p, **SWEEP, temperature=300.0, seed=3,
                                                     device="cpu"),
               ladder=parameter_ladder_sweep(p, **LADDER, temperature=300.0, seed=3,
                                             device="cpu"))
    for o in _part(ranks, "sweep"):
        d, ladder = o[0.0]["diagram"], o[0.0]["ladder"]
        for k in ("p_switch", "failed_fraction"):
            np.testing.assert_array_equal(d[k].numpy(), np.asarray(jd[k]), err_msg=k)
            np.testing.assert_array_equal(ladder[k].numpy(), np.asarray(jl[k]), err_msg=k)
        np.testing.assert_allclose(d["final_mz"].numpy(), np.asarray(jd["final_mz"]), rtol=TOL,
                                   atol=TOL)
        for name, want in one.items():
            for k, v in want.items():
                assert torch.equal(o[300.0][name][k], v), (name, k)


def test_rollout_statistics_on_a_replicated_env_count_each_row_once(ranks):
    """``compare_policies`` and ``summarize`` on the replicated env equal the
    one-process run: every rank holds all rows and reduces nothing."""
    env = _env(ENV_BATCH)
    want = compare_policies(env, _policies(env), horizon=ENV_STEPS, seed=1)
    state, obs = env.reset(seed=2)
    _, _, traj = parallel.rollout(env, parallel.random_policy(env), None, state, obs,
                                  torch.Generator().manual_seed(4), ENV_STEPS)
    summary = parallel.summarize(traj)
    assert summary["steps"] == ENV_STEPS * ENV_BATCH
    for o in _part(ranks, "policies"):
        assert o["compare"] == want
        assert o["summary"]["steps"] == summary["steps"]
        for k, v in summary.items():
            assert torch.equal(torch.as_tensor(o["summary"][k]), torch.as_tensor(v)), k


def test_callers_that_need_a_divisible_batch_raise_as_jax_does(ranks, jax_mesh):
    jenv = JEnv(batch_size=ENV_BATCH, config=JEnvConfig(max_duration=1e-10, max_steps=3))
    jax_calls = {
        "ppo": lambda: JPPOTrainer(jenv, JPPOConfig(hidden_sizes=(8,)), mesh=jax_mesh).init(
            jax.random.PRNGKey(0)),
        "measure_env_throughput": lambda: jax_measure_env(
            jenv, n_inner=1, warmup=0, blocks=1, iters_per_block=1, mesh=jax_mesh),
        "local_batch_size": lambda: jax_local_batch_size(ENV_BATCH, jax_mesh),
        "shard_batch": lambda: jax_shard_batch(jnp.zeros((ENV_BATCH, 3)), jax_mesh),
    }
    lines = {"ppo": "spintorque_tpu/rl/ppo.py:120",
             "measure_env_throughput": "spintorque_tpu/utils/benchmark.py:86",
             "local_batch_size": "spintorque_tpu/parallel/mesh.py:97",
             "shard_batch": "spintorque_tpu/parallel/mesh.py:75"}
    for name, call in jax_calls.items():
        with pytest.raises(ValueError):
            call()
    for o in _part(ranks, "raising"):
        for name, line in lines.items():
            assert o[name] is not None and line in o[name], (name, o[name])
