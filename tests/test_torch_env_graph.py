"""The vectorized env step replayed as one CUDA graph (``envs.step_graph``).

The CPU tests hold what runs anywhere: the CPU env steps eagerly and never
captures, the arena's pack and views round-trip bit for bit into memory of
their own, the tree flattening round-trips, the cache key tells apart each
input it names, and each setter of what a capture bakes in raises the
env's version. The tests marked ``cuda`` hold the graphed step to the eager
body on the card, bit for bit; they skip where torch sees no CUDA device,
and this file imports no JAX, so on a GPU machine run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_env_graph.py -m cuda -q
"""

from __future__ import annotations

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from spintorque_tpu_torch.devices import make_device_params
from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu_torch.envs import step_graph as sg
from spintorque_tpu_torch.ops import cuda_integrator as ci
from spintorque_tpu_torch.ops.philox import RESET_STREAM, as_int64, derive_seed, step_seed
from spintorque_tpu_torch.parallel.mesh import Mesh
from spintorque_tpu_torch.utils.profiling import counter, held_counts

torch.set_num_threads(1)

COUNTERS = ("env.steps", "env.eager_steps", "env.graph_replays", "env.graph_captures",
            "pulse.launches", "pulse.bf16_launches", "pulse.sharded_launches")


def _counts():
    return {name: counter(name).count for name in COUNTERS}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits: floats as same-width integers (so -0.0 and NaN
    payloads count), bools as integers."""
    t = t.detach().contiguous()
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t.to(torch.int64) if t.dtype == torch.bool else t


def assert_same_bits(a, b):
    """Two trees of tensors (states, TimeSteps) hold the same structure, the
    same other values and the same bits."""
    la, lb = [], []
    assert sg.flatten(a, la) == sg.flatten(b, lb)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and x.dtype == y.dtype, i
        assert torch.equal(_as_bits(x), _as_bits(y)), i


def _config(thermal=True, action_mode="continuous", observation_mode="vector", autoreset=True,
            **over):
    # Short pulses (at most 200 substeps) and episodes of 7 steps, so that
    # auto-resets come often.
    base = dict(max_duration=2e-10, max_steps=7, include_thermal=thermal,
                action_mode=action_mode, observation_mode=observation_mode, autoreset=autoreset)
    base.update(over)
    return SpinTorqueEnvConfig(**base)


def _actions(n, batch, action_mode, host, device, seed=3, max_duration=2e-10):
    """``n`` actions for ``batch`` envs: numpy arrays from the host, or
    tensors on ``device``. Continuous currents mix small ones (integrated
    torques) with the configuration's levels (most of which end on the +z
    fallback); durations uniform over 1 ps .. max."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if action_mode == "continuous":
            small = rng.uniform(-300.0, 300.0, batch)
            levels = rng.choice(np.linspace(-2e6, 2e6, 5), batch)
            current = np.where(rng.random(batch) < 0.5, small, levels)
            a = np.stack([current, rng.uniform(1e-12, max_duration, batch)], -1)
            a = a.astype(np.float32)
        else:
            a = rng.integers(0, 20, batch)
        out.append(a if host else torch.as_tensor(a, device=device))
    return out


# ----------------------------------------------------------------- CPU tests


def test_cpu_env_steps_eagerly_and_never_captures():
    env = SpinTorqueEnv(batch_size=32, config=_config(), device="cpu")
    assert env._graphs is None
    state, _ = env.reset(5)
    before = _counts()
    for a in _actions(4, 32, "continuous", host=False, device="cpu"):
        nxt, ts = env.step(state, a)
        eager, ets = env._step(state, a)
        assert_same_bits((nxt, ts), (eager, ets))
        state = nxt
    d = _delta(before)
    assert d["env.graph_captures"] == d["env.graph_replays"] == 0
    assert d["env.eager_steps"] == d["env.steps"] == 4


def _leaves_for_arena():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 3, generator=g)
    x[0, 0], x[0, 1], x[0, 2] = float("nan"), -0.0, 1e-40  # a NaN, a -0, a subnormal
    return [
        x,
        x[:, 1],  # a strided view
        torch.arange(6, dtype=torch.int32),
        torch.tensor([True, False, True]),
        torch.tensor(2.5, dtype=torch.float64),  # 0-dim
        torch.randn(4, generator=g),
        torch.randint(0, 9, (2, 2), generator=g),
    ]


def test_arena_pack_and_views_round_trip_bit_for_bit():
    leaves = _leaves_for_arena()
    leaves.append(leaves[0])  # one tensor given twice
    arenas, layout = sg.pack(leaves)
    assert set(arenas) == {torch.float32, torch.int32, torch.bool, torch.float64, torch.int64}
    assert arenas[torch.float32].numel() == 18 + 6 + 4  # the repeat packed once
    views = sg.unpack(arenas, layout)
    assert len(views) == len(leaves)
    for got, want in zip(views, leaves):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(_as_bits(got), _as_bits(want))
    assert views[0].data_ptr() == views[-1].data_ptr()


def test_arena_clones_share_no_memory_with_the_arena():
    arenas, layout = sg.pack(_leaves_for_arena())
    clones = {dtype: a.clone() for dtype, a in arenas.items()}
    views = sg.unpack(clones, layout)
    spans = [(a.data_ptr(), a.data_ptr() + a.numel() * a.element_size())
             for a in arenas.values()]
    for v in views:
        assert not any(lo <= v.data_ptr() < hi for lo, hi in spans)
        assert v.untyped_storage().data_ptr() in {c.data_ptr() for c in clones.values()}
    want = [v.clone() for v in views]
    for a in arenas.values():
        a.zero_()  # a later replay overwriting the graph's arena
    for got, w in zip(views, want):
        assert torch.equal(_as_bits(got), _as_bits(w))


@pytest.mark.parametrize("observation_mode", ["vector", "dict"])
def test_a_step_flattens_and_rebuilds(observation_mode):
    components = {"alignment": {"weight": 1.0, "function": "alignment",
                                "normalize": "running_std"}}
    env = SpinTorqueEnv(batch_size=8, config=_config(observation_mode=observation_mode),
                        reward_components=components, device="cpu")
    state, _ = env.reset(1)
    assert set(state.reward_stats) == {"alignment"}
    tree = env.step(state, _actions(1, 8, "continuous", False, "cpu")[0])
    leaves = []
    spec = sg.flatten(tree, leaves)
    rebuilt = sg.unflatten(spec, iter(leaves))
    assert_same_bits(rebuilt, tree)
    assert type(rebuilt[0]) is type(tree[0]) and type(rebuilt[1]) is type(tree[1])
    assert rebuilt[0].seed == tree[0].seed and rebuilt[0].counter == tree[0].counter == 1


def _key(env, state, action):
    graphs = sg.StepGraphs(env)
    host = not isinstance(action, torch.Tensor)
    inputs = []
    sg.flatten(state, inputs)
    inputs.append(env._action_tensor(action))
    return graphs.key(env, inputs, state, host)


def test_the_cache_key_tells_apart_each_input_it_names():
    env = SpinTorqueEnv(batch_size=8, config=_config(), device="cpu")
    state, _ = env.reset(1)
    card = torch.zeros(8, 2)
    base = _key(env, state, card)
    # Neither the values nor the state's host words (seed, counter) matter.
    assert _key(env, state, card + 1.0) == base
    assert _key(env, dataclasses.replace(state, seed=9, counter=4), card) == base
    components = {"alignment": {"weight": 1.0, "function": "alignment",
                                "normalize": "running_mean"}}
    stats_env = SpinTorqueEnv(batch_size=8, config=_config(), reward_components=components,
                              device="cpu")
    stats_state, _ = stats_env.reset(1)
    differing = {
        "host action": _key(env, state, np.zeros((8, 2), np.float32)),
        "action shape": _key(env, state, torch.zeros(8)),
        "state dtype": _key(env, dataclasses.replace(state, m=state.m.double()), card),
        "state shape": _key(env, dataclasses.replace(state, m=state.m[:, :2]), card),
        "reward stats": _key(env, stats_state, card),
    }
    for name, key in differing.items():
        assert key != base, name
    discrete = SpinTorqueEnv(batch_size=8, config=_config(action_mode="discrete"), device="cpu")
    assert (_key(discrete, state, torch.zeros(8, dtype=torch.int64))
            != _key(discrete, state, torch.zeros(8, dtype=torch.int32)))
    # The env's own part: its device, local batch and mesh split.
    own = sg.StepGraphs(env)._static_key
    assert own == ("cpu", 8, None)
    assert sg.StepGraphs(SpinTorqueEnv(batch_size=16, config=_config(),
                                       device="cpu"))._static_key != own
    sharded = SpinTorqueEnv(batch_size=16, config=_config(),
                            mesh=Mesh({"data": 2, "model": 1}, torch.device("cpu")))
    assert sharded.local_batch_size == 8
    assert sg.StepGraphs(sharded)._static_key == ("cpu", 8, (2, 0))


def test_an_envs_graphs_hold_no_reference_to_it():
    """No env <-> graphs cycle: an env's graphs are freed with it, not by
    the collector at some later point (inside another capture, say)."""
    env = SpinTorqueEnv(batch_size=8, config=_config(), device="cpu")
    graphs = sg.StepGraphs(env)
    assert not any(x is env for x in gc.get_referents(*gc.get_referents(graphs)))
    ref = weakref.ref(env)
    del env
    assert ref() is None


def test_each_setter_of_what_a_capture_bakes_in_raises_the_version():
    env = SpinTorqueEnv(batch_size=8, config=_config(), device="cpu")
    seen = [env.graph_version()]

    def changed():
        seen.append(env.graph_version())
        return seen[-1] != seen[-2]

    env.device_params = make_device_params("stt_mram", {"damping": 0.02}, device="cpu")
    assert changed()
    env.target_states = env.target_states.flip(0)
    assert changed()
    env.reward.update_weight("success", 2.0)
    assert changed()
    env.reward.add_component("speed", 0.5, "speed")
    assert changed()
    env.reward.remove_component("speed")
    assert changed()
    env.reward = type(env.reward)({"success": {"weight": 1.0, "function": "success"}})
    assert changed()
    assert not changed()


def test_held_counts_count_nothing_until_added():
    c = counter("pulse.launches")
    before = c.count
    with held_counts() as held:
        c.add()
        c.add(2)
    assert c.count == before and held == {c: 3}
    for k, amount in held.items():
        k.add(amount)
    assert c.count == before + 3


def test_the_keys_a_replay_sets_are_the_eager_steps():
    rng = np.random.default_rng(0)
    for seed in [0, 2**63, 2**64 - 1] + [int(s) for s in rng.integers(0, 2**63, 8)]:
        w = as_int64(seed)
        assert -(2**63) <= w < 2**63 and w & (2**64 - 1) == seed
        assert step_seed(seed, 5, RESET_STREAM) == derive_seed(derive_seed(seed, 5),
                                                               RESET_STREAM)
    assert torch.tensor(as_int64(2**64 - 1)).item() == -1
    # A key tensor must be a 0-dim int64 on the kernel's device.
    with pytest.raises(ValueError):
        ci.pulse_key(torch.zeros((), dtype=torch.int64), torch.device("cuda"))
    with pytest.raises(TypeError):
        ci.pulse_key(torch.zeros((), dtype=torch.int32), torch.device("cpu"))
    with pytest.raises(ValueError):
        ci.pulse_key(torch.zeros(2, dtype=torch.int64), torch.device("cpu"))


# ---------------------------------------------------------------- card tests


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert ci.cuda_kernel_available()
    return torch.device("cuda")


# thermal, batch, action mode, observation mode, auto-reset, host actions, bf16_rhs
CASES = [
    (True, 4096, "continuous", "vector", True, False, False),
    (False, 1, "continuous", "vector", True, True, False),
    (True, 4097, "discrete", "dict", True, False, False),
    (False, 4096, "discrete", "vector", False, False, False),
    (True, 1, "continuous", "dict", False, True, False),
    (True, 4097, "continuous", "vector", True, True, False),
    (False, 4097, "continuous", "dict", True, False, False),
    (True, 1, "discrete", "vector", True, True, False),
    (True, 4096, "continuous", "vector", True, False, True),
]


def _case_id(case):
    thermal, batch, action, obs, autoreset, host, bf16 = case
    return "-".join([("thermal" if thermal else "det"), f"b{batch}", action, obs,
                     "reset" if autoreset else "noreset", "host" if host else "card"]
                    + (["bf16"] if bf16 else []))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_graphed_step_equals_the_eager_step_over_300_steps(cuda, case):
    thermal, batch, action_mode, obs_mode, autoreset, host, bf16 = case
    env = SpinTorqueEnv(batch_size=batch, device=cuda, config=_config(
        thermal, action_mode, obs_mode, autoreset, bf16_rhs=bf16))
    state, _ = env.reset(2**63 + 11)
    eager = state
    before = _counts()
    resets = 0
    for a in _actions(300, batch, action_mode, host, cuda):
        state, ts = env.step(state, a)
        eager, ets = env._step(eager, a)
        assert_same_bits((state, ts), (eager, ets))
        resets += int((ts.terminated | ts.truncated).sum())
    d = _delta(before)
    assert (d["env.graph_captures"], d["env.eager_steps"], d["env.graph_replays"]) == (1, 1, 299)
    launches = d["pulse.bf16_launches" if bf16 else "pulse.launches"]
    assert launches == 600  # 300 graphed, 300 eager
    assert resets > 0


@pytest.mark.cuda
def test_the_collector_is_off_during_a_capture(cuda, monkeypatch):
    """A collection inside a capture may free another env's graph, whose
    destructor calls CUDA and invalidates the capture: the warm-up runs
    with the collector as it was, the capture without it."""
    env = SpinTorqueEnv(batch_size=64, device=cuda, config=_config())
    state, _ = env.reset(4)
    seen = []
    body = env._step

    def spy(*args):
        seen.append(gc.isenabled())
        return body(*args)

    monkeypatch.setattr(env, "_step", spy)
    assert gc.isenabled()
    for a in _actions(3, 64, "continuous", False, cuda):
        state, _ = env.step(state, a)
    assert seen == [True, False] and gc.isenabled()


@pytest.mark.cuda
def test_stepping_one_state_twice_gives_the_same_bits(cuda):
    env = SpinTorqueEnv(batch_size=4096, device=cuda, config=_config())
    state, _ = env.reset(7)
    actions = _actions(4, 4096, "continuous", False, cuda)
    for a in actions[:3]:
        state, _ = env.step(state, a)
    first = env.step(state, actions[3])
    second = env.step(state, actions[3])
    assert_same_bits(first, second)
    assert counter("env.graph_captures").count >= 1


@pytest.mark.cuda
def test_tensors_returned_by_a_step_survive_later_replays(cuda):
    env = SpinTorqueEnv(batch_size=4096, device=cuda, config=_config())
    state, _ = env.reset(8)
    actions = _actions(12, 4096, "continuous", False, cuda)
    held = None
    for k, a in enumerate(actions):
        state, ts = env.step(state, a)
        if k == 3:
            held = (state, ts)
            leaves = []
            sg.flatten(held, leaves)
            copies = [t.clone() for t in leaves]
    leaves = []
    sg.flatten(held, leaves)
    for got, want in zip(leaves, copies):
        assert torch.equal(_as_bits(got), _as_bits(want))


@pytest.mark.cuda
def test_setters_force_a_new_capture_that_equals_the_eager_step(cuda):
    env = SpinTorqueEnv(batch_size=4096, device=cuda, config=_config())
    state, _ = env.reset(9)
    actions = _actions(9, 4096, "continuous", False, cuda)
    captures = counter("env.graph_captures")

    def run(steps):
        nonlocal state
        for a in steps:
            nxt, ts = env.step(state, a)
            eager, ets = env._step(state, a)
            assert_same_bits((nxt, ts), (eager, ets))
            state = nxt

    run(actions[:3])
    n = captures.count
    damping = torch.linspace(0.005, 0.02, 4096, device=cuda)
    env.device_params = dataclasses.replace(env.device_params, damping=damping)
    run(actions[3:6])
    assert captures.count == n + 1
    env.reward.update_weight("success", 3.0)
    run(actions[6:])
    assert captures.count == n + 2


@pytest.mark.cuda
def test_replays_carry_the_steps_and_the_profiler_sees_their_kernels(cuda):
    from torch.profiler import ProfilerActivity, profile

    env = SpinTorqueEnv(batch_size=4096, device=cuda, config=_config())
    state, _ = env.reset(10)
    actions = _actions(108, 4096, "continuous", False, cuda)
    before = _counts()
    for a in actions[:100]:
        state, _ = env.step(state, a)
    d = _delta(before)
    assert d["env.graph_replays"] / d["env.steps"] >= 0.95
    assert d["pulse.launches"] == 100
    torch.cuda.synchronize()
    launches = counter("pulse.launches").count
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for a in actions[100:]:
            state, _ = env.step(state, a)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    pulses = [e for e in kernels if "pulse_kernel" in e.name]
    assert len(pulses) == counter("pulse.launches").count - launches == 8
    # Every kernel of the eager body, and the replay's copies, appear.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as eager_prof:
        env._step(state, actions[0])
        torch.cuda.synchronize()
    eager_kernels = [e for e in eager_prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) >= 8 * len(eager_kernels)


def _mesh_rank(batch, steps, seed):
    from spintorque_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    env = SpinTorqueEnv(batch_size=batch, config=_config(), mesh=mesh)
    state, _ = env.reset(seed)
    rows = env._local_rows
    out = []
    for a in _actions(steps, batch, "continuous", False, env.device):
        state, ts = env.step(state, a[rows])
        out.append((state.m.cpu(), ts.obs.cpu(), ts.reward.cpu(), ts.terminated.cpu()))
    return dict(rows=(rows.start, rows.stop), out=out,
                sharded=counter("pulse.sharded_launches").count,
                replays=counter("env.graph_replays").count)


@pytest.mark.cuda
def test_each_ranks_graphed_sharded_step_equals_the_one_process_step(cuda, tmp_path):
    from spintorque_tpu_torch.parallel import spawn_ranks

    batch, steps, seed = 4096, 12, 21
    ranks = spawn_ranks(_mesh_rank, 2, args=(batch, steps, seed), backend="gloo",
                        timeout=600.0, workdir=str(tmp_path))
    env = SpinTorqueEnv(batch_size=batch, device=cuda, config=_config())
    state, _ = env.reset(seed)
    want = []
    for a in _actions(steps, batch, "continuous", False, cuda):
        state, ts = env.step(state, a)
        want.append((state.m.cpu(), ts.obs.cpu(), ts.reward.cpu(), ts.terminated.cpu()))
    for r in ranks:
        lo, hi = r["rows"]
        assert hi - lo == batch // 2
        assert r["sharded"] == steps and r["replays"] == steps - 1
        for got, ref in zip(r["out"], want):
            for x, y in zip(got, ref):
                assert torch.equal(_as_bits(x), _as_bits(y[lo:hi]))
