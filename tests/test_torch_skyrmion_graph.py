"""The racetrack env's step (SkyrmionRacetrack-v0) replayed as one CUDA graph
(``envs.step_graph``, through ``SkyrmionRacetrackEnv._graph_hook``).

The CPU tests hold what runs anywhere: the CPU env steps eagerly and never
captures, a step's state and TimeStep flatten and rebuild bit for bit, the
cache key tells apart each input it names, each assignment of what a
capture bakes in raises the env's version, and the keys a replay sets draw
the eager step's thermal kicks and auto-reset. The tests marked ``cuda``
hold the graphed racetrack step to the eager body on the card, bit for bit;
they skip where torch sees no CUDA device, and this file imports no JAX, so
on a GPU machine run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_skyrmion_graph.py -m cuda -q
"""

from __future__ import annotations

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from spintorque_tpu_torch.envs import SkyrmionEnvConfig, SkyrmionRacetrackEnv
from spintorque_tpu_torch.envs import step_graph as sg
from spintorque_tpu_torch.ops.philox import KICK_STREAM, RESET_STREAM, step_seed
from spintorque_tpu_torch.utils.profiling import PROFILER, counter, tracing

torch.set_num_threads(1)

COUNTERS = ("racetrack.steps", "racetrack.eager_steps", "racetrack.graph_replays",
            "racetrack.graph_captures")


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


def _env(batch=8, device="cpu", seed=3, **over):
    return SkyrmionRacetrackEnv(batch_size=batch, device=device, seed=seed,
                                config=SkyrmionEnvConfig(**over))


def _actions(mode, n, batch, device, seed=3, host=False):
    """``n`` steps of actions: Discrete(45) indices uniform over 0-44 (the
    ``racetrack-b4096`` cell's traffic), or (B, 5) Box actions with a
    current on half the tracks; numpy arrays from the host, or tensors on
    ``device``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if mode == "discrete":
            a = rng.integers(0, 45, batch)
        else:
            j = rng.uniform(-1e12, 1e12, (batch, 2)) * (rng.random((batch, 1)) < 0.5)
            a = np.concatenate([j, rng.uniform(-1e18, 1e18, (batch, 2)),
                                rng.uniform(0.0, 2e-9, (batch, 1))], -1).astype(np.float32)
        out.append(a if host else torch.as_tensor(a, device=device))
    return out


# ----------------------------------------------------------------- CPU tests


@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_cpu_racetrack_env_steps_eagerly_and_never_captures(mode):
    env = _env(action_mode=mode, max_steps=2)
    assert env._graphs is None
    state, _ = env.reset(5)
    before = _counts()
    for a in _actions(mode, 3, 8, "cpu"):
        nxt, ts = env.step(state, a)
        assert_same_bits((nxt, ts), env._step(state, a))
        state = nxt
    d = _delta(before)
    assert d["racetrack.graph_captures"] == d["racetrack.graph_replays"] == 0
    assert d["racetrack.eager_steps"] == d["racetrack.steps"] == 3


@pytest.mark.parametrize("observation_mode", ["vector", "dict"])
@pytest.mark.parametrize("autoreset", [True, False])
def test_a_racetrack_step_flattens_and_rebuilds_bit_for_bit(observation_mode, autoreset):
    components = {"alignment": {"weight": 1.0, "function": "alignment",
                                "normalize": "running_std"}}
    env = SkyrmionRacetrackEnv(batch_size=8, device="cpu", reward_components=components,
                               config=SkyrmionEnvConfig(observation_mode=observation_mode,
                                                        autoreset=autoreset, max_steps=1))
    state, _ = env.reset(1)
    assert set(state.reward_stats) == {"alignment"}
    tree = env.step(state, _actions("continuous", 1, 8, "cpu")[0])
    leaves = []
    spec = sg.flatten(tree, leaves)
    rebuilt = sg.unflatten(spec, iter(leaves))
    assert_same_bits(rebuilt, tree)
    assert type(rebuilt[0]) is type(tree[0]) and type(rebuilt[1]) is type(tree[1])
    assert rebuilt[0].seed == tree[0].seed and rebuilt[0].counter == tree[0].counter == 1
    assert ("final_observation" in rebuilt[1].info) == autoreset
    # Packed into arenas and back, as a replay returns them.
    arenas, layout = sg.pack(leaves)
    assert_same_bits(sg.unflatten(spec, iter(sg.unpack(arenas, layout))), tree)


def _key(env, state, action):
    graphs = sg.StepGraphs(env)
    host = not isinstance(action, torch.Tensor)
    inputs = []
    sg.flatten(state, inputs)
    inputs.append(env._action_tensor(action))
    return graphs.key(env, inputs, state, host)


def test_the_racetrack_cache_key_tells_apart_each_input_it_names():
    env = _env()
    state, _ = env.reset(1)
    card = torch.zeros(8, 5)
    base = _key(env, state, card)
    # Neither the values nor the state's host words (seed, counter) matter.
    assert _key(env, state, card + 1.0) == base
    assert _key(env, dataclasses.replace(state, seed=9, counter=4), card) == base
    # A float64 Box action is converted to the env's dtype before the key.
    assert _key(env, state, card.double()) == base
    discrete = _env(action_mode="discrete")
    d_state, _ = discrete.reset(1)
    d_base = _key(discrete, d_state, torch.zeros(8, dtype=torch.int64))
    differing = {
        "host action": _key(env, state, np.zeros((8, 5), np.float32)),
        "action shape": _key(env, state, torch.zeros(8, 4)),
        "state dtype": _key(env, dataclasses.replace(state, positions=state.positions.double()),
                            card),
        "state shape": _key(env, dataclasses.replace(state, velocities=state.velocities[:4]),
                            card),
        "index dtype": _key(discrete, d_state, torch.zeros(8, dtype=torch.int32)),
    }
    for name, key in differing.items():
        assert key != (d_base if name == "index dtype" else base), name
    # Discrete indices keep their dtype; a single track's Box action is one row.
    assert discrete._action_tensor(np.array([3, 44])).dtype == torch.int64
    assert _env(batch=1)._action_tensor(np.array([1e11, 0.0, 0.0, 0.0, 1e-9])).shape == (1, 5)
    # The env's own part: its device and batch.
    assert sg.StepGraphs(env)._static_key == ("cpu", 8)
    assert sg.StepGraphs(_env(batch=16))._static_key == ("cpu", 16)


def test_a_racetrack_envs_graphs_hold_no_reference_to_it():
    env = _env()
    graphs = sg.StepGraphs(env)
    assert not any(x is env for x in gc.get_referents(*gc.get_referents(graphs)))
    ref = weakref.ref(env)
    del env
    assert ref() is None


def test_each_assignment_of_what_a_racetrack_capture_bakes_in_raises_the_version():
    env = _env()
    seen = [env.graph_version()]

    def changed():
        seen.append(env.graph_version())
        return seen[-1] != seen[-2]

    env.set_targets([3e-7])
    assert changed()
    env.pin_x = env.pin_x * 0.5
    assert changed()
    env.pin_strength = env.pin_strength * 2.0
    assert changed()
    env.action_tables = tuple(t.clone() for t in env.action_tables)
    assert changed()
    env.reward.update_weight("energy", -0.2)
    assert changed()
    env.reward = type(env.reward)({"success": {"weight": 1.0, "function": "success"}})
    assert changed()
    assert not changed()


@pytest.mark.parametrize("thermal", [True, False])
@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_the_keys_a_replay_sets_draw_the_eager_steps_kicks_and_reset(mode, thermal):
    """The hook's generators, seeded by its ``set_keys`` as before a
    replay, give the body the draws of the generators it derives itself,
    over steps that end episodes (max_steps 2) and a state stepped twice."""
    env = _env(action_mode=mode, include_thermal=thermal, max_steps=2)
    hook = env._graph_hook()
    args, set_keys = hook.keys(env.device)
    assert len(args) == 2 and all(isinstance(g, torch.Generator) for g in args)
    state, _ = env.reset(2**63 + 5)
    for k, a in enumerate(_actions(mode, 5, 8, "cpu", seed=11)):
        set_keys(state)
        if thermal:
            assert args[0].initial_seed() == step_seed(state.seed, state.counter, KICK_STREAM)
        assert args[1].initial_seed() == step_seed(state.seed, state.counter, RESET_STREAM)
        keyed = env._step(state, a, *args)
        eager = env.step(state, a)
        assert_same_bits(keyed, eager)
        if k == 2:
            set_keys(state)
            assert_same_bits(env._step(state, a, *args), eager)
        state = eager[0]


def test_the_racetrack_hook_names_its_own_span_and_counters():
    env = _env()
    hook = env._graph_hook()
    assert hook.span == "racetrack.replay"
    assert (hook.captures, hook.replays, hook.eager_steps) == (
        counter("racetrack.graph_captures"), counter("racetrack.graph_replays"),
        counter("racetrack.eager_steps"))
    assert hook.static_key == ("cpu", 8)


# ---------------------------------------------------------------- card tests


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# action mode, observation mode, dtype, thermal, batch, host actions
CASES = [
    ("discrete", "vector", "float32", True, 4096, False),
    ("continuous", "vector", "float32", True, 4096, False),
    ("discrete", "dict", "float32", True, 4096, False),
    ("discrete", "vector", "bfloat16", True, 4096, False),
    ("continuous", "vector", "bfloat16", True, 4096, False),
    ("discrete", "vector", "float32", False, 4096, False),
    ("continuous", "dict", "float32", False, 4096, False),
    ("discrete", "vector", "float32", True, 1, True),
    ("continuous", "vector", "float32", True, 64, True),
]


def _case_id(case):
    mode, obs, dtype, thermal, batch, host = case
    return "-".join([mode, obs, dtype, "thermal" if thermal else "det", f"b{batch}",
                     "host" if host else "card"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_graphed_racetrack_step_equals_the_eager_step_over_300_steps(cuda, case):
    mode, obs_mode, dtype, thermal, batch, host = case
    env = _env(batch, cuda, action_mode=mode, observation_mode=obs_mode, dtype=dtype,
               include_thermal=thermal)
    state, _ = env.reset(2**63 + 11)
    eager = state
    before = _counts()
    resets = 0
    for a in _actions(mode, 300, batch, cuda, host=host):
        state, ts = env.step(state, a)
        eager, ets = env._step(eager, a)
        assert_same_bits((state, ts), (eager, ets))
        resets += int((ts.terminated | ts.truncated).sum())
    d = _delta(before)
    assert (d["racetrack.graph_captures"], d["racetrack.eager_steps"],
            d["racetrack.graph_replays"], d["racetrack.steps"]) == (1, 1, 299, 300)
    assert resets >= batch  # every track truncated at step 150, at least


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_the_gym_adapters_step_replays_the_eager_step_on_the_card(cuda, mode):
    """The single-env path ``GymSkyrmionRacetrackEnv`` takes (one track, no
    auto-reset, a host action with a batch axis of 1), replayed against the
    eager body over 300 steps with a reset at each episode's end."""
    env = _env(1, cuda, action_mode=mode, autoreset=False)
    state, _ = env.reset(21)
    before = _counts()
    for k, a in enumerate(_actions(mode, 300, 1, "cpu", seed=5, host=True)):
        nxt, ts = env.step(state, a)
        assert_same_bits((nxt, ts), env._step(state, a))
        state = env.reset(100 + k)[0] if bool(ts.terminated | ts.truncated) else nxt
    d = _delta(before)
    assert d["racetrack.graph_captures"] == 1 and d["racetrack.graph_replays"] == 299


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_the_gym_racetrack_env_replays_the_eager_step_on_the_card(cuda, mode):
    """Two adapters of one seed, one stepping through the graph and one
    eagerly, over 300 host actions with a reset at each episode's end."""
    pytest.importorskip("gymnasium")
    from spintorque_tpu_torch.envs.gym_adapter import GymSkyrmionRacetrackEnv

    graphed = GymSkyrmionRacetrackEnv(action_mode=mode, seed=4, device=cuda)
    eager = GymSkyrmionRacetrackEnv(action_mode=mode, seed=4, device=cuda)
    eager._env._graphs = None
    for env in (graphed, eager):
        env.reset(seed=21)
    before = _counts()
    for a in _actions(mode, 300, 1, "cpu", seed=5, host=True):
        got = graphed.step(a[0])
        want = eager.step(a[0])
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:4] == want[1:4]
        for k, v in want[4].items():
            np.testing.assert_array_equal(got[4][k], v)
        if got[2] or got[3]:
            graphed.reset()
            eager.reset()
    d = _delta(before)
    assert d["racetrack.graph_captures"] == 1 and d["racetrack.graph_replays"] == 299
    assert d["racetrack.eager_steps"] == 301


@pytest.mark.cuda
def test_stepping_one_racetrack_state_twice_gives_the_same_bits(cuda):
    env = _env(4096, cuda, action_mode="discrete", max_steps=4)
    state, _ = env.reset(7)
    actions = _actions("discrete", 6, 4096, cuda)
    for a in actions[:5]:
        state, _ = env.step(state, a)
    first = env.step(state, actions[5])
    second = env.step(state, actions[5])
    assert_same_bits(first, second)
    assert_same_bits(first, env._step(state, actions[5]))


@pytest.mark.cuda
def test_tensors_returned_by_a_racetrack_step_survive_later_replays(cuda):
    env = _env(4096, cuda, action_mode="discrete")
    state, _ = env.reset(8)
    held = None
    for k, a in enumerate(_actions("discrete", 12, 4096, cuda)):
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
def test_new_targets_force_a_new_capture_that_equals_the_eager_step(cuda):
    env = _env(4096, cuda, action_mode="discrete")
    state, _ = env.reset(9)
    actions = _actions("discrete", 6, 4096, cuda)
    captures = counter("racetrack.graph_captures")

    def run(steps):
        nonlocal state
        for a in steps:
            nxt, ts = env.step(state, a)
            assert_same_bits((nxt, ts), env._step(state, a))
            state = nxt

    run(actions[:3])
    n = captures.count
    env.set_targets([7e-7])
    run(actions[3:])
    assert captures.count == n + 1


@pytest.mark.cuda
def test_64_racetrack_replays_count_their_steps_and_trace_the_replay(cuda):
    """After the capture's step, 64 replays count 64 steps, and a traced
    replay records ``racetrack.replay`` under ``racetrack.step`` with no
    phase span."""
    env = _env(4096, cuda, action_mode="discrete")
    state, _ = env.reset(13)
    actions = _actions("discrete", 66, 4096, cuda)
    state, _ = env.step(state, actions[0])  # the capture
    before = _counts()
    for a in actions[1:65]:
        state, _ = env.step(state, a)
    d = _delta(before)
    assert (d["racetrack.graph_replays"], d["racetrack.steps"]) == (64, 64)
    assert d["racetrack.graph_captures"] == d["racetrack.eager_steps"] == 0
    since = len(PROFILER.spans())
    with tracing():
        env.step(state, actions[65])
    spans = sorted((r.name, r.parent or "") for r in PROFILER.spans()[since:])
    assert spans == [("racetrack.replay", "racetrack.step"), ("racetrack.step", "")]
