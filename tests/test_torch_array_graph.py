"""The array env's step (SpinTorqueArray-v0) replayed as one CUDA graph
(``envs.step_graph``, through ``SpinTorqueArrayEnv._graph_hook``).

The CPU tests hold what runs anywhere: the CPU env steps eagerly and never
captures, a step's state and TimeStep flatten and rebuild bit for bit, the
cache key tells apart each input it names, each setter of what a capture
bakes in raises the env's version, the keys a replay sets draw the eager
step's auto-reset, and SpinTorque-v0's hook gives the key, span and
counters its graphs had before the body was shared. The tests marked
``cuda`` hold the graphed array step to the eager body on the card, bit for
bit; they skip where torch sees no CUDA device, and this file imports no
JAX, so on a GPU machine run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_array_graph.py -m cuda -q
"""

from __future__ import annotations

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from spintorque_tpu_torch.devices import make_device_params
from spintorque_tpu_torch.envs import (
    ArrayEnvConfig,
    SpinTorqueArrayEnv,
    SpinTorqueEnv,
    SpinTorqueEnvConfig,
)
from spintorque_tpu_torch.envs import step_graph as sg
from spintorque_tpu_torch.ops.philox import RESET_STREAM, as_int64, derive_seed, step_seed
from spintorque_tpu_torch.utils.profiling import PROFILER, counter, tracing

torch.set_num_threads(1)

COUNTERS = ("array.steps", "array.eager_steps", "array.graph_replays", "array.graph_captures",
            "array.sweep_kernels", "array.sweep_eager", "array.device_updates")


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


def _env(batch=8, device="cpu", **over):
    return SpinTorqueArrayEnv(batch_size=batch, device=device, config=ArrayEnvConfig(**over))


def _actions(n, batch, device, seed=3, host=False):
    """``n`` steps of the ``array-4x4`` cell's traffic: (B, 3) float32
    ``[index, I, dt]``, index uniform over the 16 devices, I uniform over
    +-2e6 A/m^2, dt uniform over 1 ps-5 ns; numpy arrays from the host, or
    tensors on ``device``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = np.stack([rng.integers(0, 16, batch).astype(np.float64),
                      rng.uniform(-2e6, 2e6, batch), rng.uniform(1e-12, 5e-9, batch)], -1)
        a = a.astype(np.float32)
        out.append(a if host else torch.as_tensor(a, device=device))
    return out


# ----------------------------------------------------------------- CPU tests


@pytest.mark.parametrize("coupling_update", ["sequential", "simultaneous"])
def test_cpu_array_env_steps_eagerly_and_never_captures(coupling_update):
    env = _env(coupling_update=coupling_update, max_steps=2)
    assert env._graphs is None
    state, _ = env.reset(5)
    before = _counts()
    for a in _actions(3, 8, "cpu"):
        nxt, ts = env.step(state, a)
        eager, ets = env._step(state, a)
        assert_same_bits((nxt, ts), (eager, ets))
        state = nxt
    d = _delta(before)
    assert d["array.graph_captures"] == d["array.graph_replays"] == 0
    assert d["array.eager_steps"] == d["array.steps"] == 3


@pytest.mark.parametrize("observation_mode", ["array", "vector", "dict"])
@pytest.mark.parametrize("autoreset", [True, False])
def test_an_array_step_flattens_and_rebuilds_bit_for_bit(observation_mode, autoreset):
    components = {"similarity": {"weight": 1.0, "function": "alignment",
                                 "normalize": "running_std"}}
    env = SpinTorqueArrayEnv(batch_size=8, device="cpu", reward_components=components,
                             config=ArrayEnvConfig(observation_mode=observation_mode,
                                                   autoreset=autoreset, max_steps=1))
    state, _ = env.reset(1)
    assert set(state.reward_stats) == {"similarity"}
    tree = env.step(state, _actions(1, 8, "cpu")[0])
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


def test_the_array_cache_key_tells_apart_each_input_it_names():
    env = _env()
    state, _ = env.reset(1)
    card = torch.zeros(8, 3)
    base = _key(env, state, card)
    # Neither the values nor the state's host words (seed, counter) matter,
    # nor the target's strides (an expanded view at reset, an arena's after).
    assert _key(env, state, card + 1.0) == base
    assert _key(env, dataclasses.replace(state, seed=9, counter=4), card) == base
    assert _key(env, dataclasses.replace(state, target=state.target.contiguous()), card) == base
    # A float64 action is converted to the env's dtype before the key.
    assert _key(env, state, card.double()) == base
    components = {"similarity": {"weight": 1.0, "function": "alignment",
                                 "normalize": "running_mean"}}
    stats_env = SpinTorqueArrayEnv(batch_size=8, device="cpu", reward_components=components)
    stats_state, _ = stats_env.reset(1)
    differing = {
        "host action": _key(env, state, np.zeros((8, 3), np.float32)),
        "action shape": _key(env, state, torch.zeros(8, 2)),
        "state dtype": _key(env, dataclasses.replace(state, pattern=state.pattern.double()),
                            card),
        "state shape": _key(env, dataclasses.replace(state, pattern=state.pattern[:4]), card),
        "reward stats": _key(stats_env, stats_state, card),
    }
    for name, key in differing.items():
        assert key != base, name
    # A single array's 1-D action becomes one row, as the eager decode reads it.
    one = _env(batch=1)
    assert one._action_tensor(np.array([3.0, 1e6, 1e-9])).shape == (1, 3)
    # The env's own part: its device and batch.
    assert sg.StepGraphs(env)._static_key == ("cpu", 8)
    assert sg.StepGraphs(_env(batch=16))._static_key == ("cpu", 16)


def test_an_array_envs_graphs_hold_no_reference_to_it():
    env = _env()
    graphs = sg.StepGraphs(env)
    assert not any(x is env for x in gc.get_referents(*gc.get_referents(graphs)))
    ref = weakref.ref(env)
    del env
    assert ref() is None


def test_each_array_setter_of_what_a_capture_bakes_in_raises_the_version():
    env = _env()
    seen = [env.graph_version()]

    def changed():
        seen.append(env.graph_version())
        return seen[-1] != seen[-2]

    env.device_params = make_device_params("stt_mram", {"damping": 0.02}, device="cpu")
    assert changed()
    env.coupling = env.coupling * 0.5
    assert changed()
    env.reward.update_weight("energy", -0.2)
    assert changed()
    env.reward.add_component("speed", 0.5, "speed")
    assert changed()
    env.reward.remove_component("speed")
    assert changed()
    env.reward = type(env.reward)({"success": {"weight": 1.0, "function": "success"}})
    assert changed()
    assert not changed()
    # The easy axis the sweeps read follows the parameters, normalized.
    env.device_params = make_device_params("stt_mram", {"easy_axis": np.array([0.0, 3.0, 4.0])},
                                           device="cpu")
    assert torch.allclose(env._easy_axis, torch.tensor([0.0, 0.6, 0.8]))


@pytest.mark.parametrize("coupling_update", ["sequential", "simultaneous"])
def test_the_keys_a_replay_sets_draw_the_eager_steps_reset(coupling_update):
    """The hook's generator, seeded by its ``set_keys`` as before a replay,
    gives the body the draws of the generator it builds itself, over steps
    that end episodes (max_steps 2) and a state stepped twice."""
    env = _env(coupling_update=coupling_update, max_steps=2)
    hook = env._graph_hook()
    args, set_keys = hook.keys(env.device)
    assert len(args) == 1 and isinstance(args[0], torch.Generator)
    state, _ = env.reset(2**63 + 5)
    for k, a in enumerate(_actions(5, 8, "cpu", seed=11)):
        set_keys(state)
        assert args[0].initial_seed() == step_seed(state.seed, state.counter, RESET_STREAM)
        keyed = env._step(state, a, *args)
        eager = env._step(state, a)
        assert_same_bits(keyed, eager)
        if k == 2:
            set_keys(state)
            assert_same_bits(env._step(state, a, *args), eager)
        state = eager[0]


def test_the_array_hook_names_its_own_span_and_counters():
    env = _env()
    hook = env._graph_hook()
    assert hook.span == "array.replay"
    assert (hook.captures, hook.replays, hook.eager_steps) == (
        counter("array.graph_captures"), counter("array.graph_replays"),
        counter("array.eager_steps"))
    assert hook.static_key == ("cpu", 8)


@pytest.mark.parametrize("thermal", [True, False])
def test_the_spin_torque_hook_gives_the_key_span_and_counters_it_had(thermal):
    env = SpinTorqueEnv(batch_size=8, device="cpu",
                        config=SpinTorqueEnvConfig(include_thermal=thermal))
    hook = env._graph_hook()
    assert hook.static_key == ("cpu", 8, None) == sg.StepGraphs(env)._static_key
    assert hook.span == "spin_torque.replay"
    assert (hook.captures, hook.replays, hook.eager_steps) == (
        counter("env.graph_captures"), counter("env.graph_replays"), counter("env.eager_steps"))
    (key, generator), set_keys = hook.keys(torch.device("cpu"))
    assert key.shape == () and key.dtype == torch.int64 and int(key) == 0
    state, _ = env.reset(2**64 - 3)
    state = dataclasses.replace(state, counter=7)
    set_keys(state)
    want = as_int64(derive_seed(state.seed, state.counter)) if thermal else 0
    assert int(key) == want
    assert generator.initial_seed() == step_seed(state.seed, state.counter, RESET_STREAM)
    # The keys hold nothing of the env: an env is freed with its graphs.
    ref = weakref.ref(env)
    del env, hook
    assert ref() is None


# ---------------------------------------------------------------- card tests


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from spintorque_tpu_torch.ops.cuda_integrator import cuda_kernel_available

    assert cuda_kernel_available()
    return torch.device("cuda")


# coupling update, dtype, batch, observation mode, host actions
CASES = [
    ("sequential", "float32", 4096, "array", False),
    ("simultaneous", "float32", 4096, "array", False),
    ("sequential", "bfloat16", 4096, "array", False),
    ("simultaneous", "bfloat16", 4096, "array", False),
    ("sequential", "float32", 1, "dict", True),
    ("sequential", "float32", 4096, "vector", False),
]


def _case_id(case):
    coupling, dtype, batch, obs, host = case
    return "-".join([coupling, dtype, f"b{batch}", obs, "host" if host else "card"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_graphed_array_step_equals_the_eager_step_over_300_steps(cuda, case):
    coupling, dtype, batch, obs_mode, host = case
    env = _env(batch, cuda, coupling_update=coupling, dtype=dtype, observation_mode=obs_mode)
    state, _ = env.reset(2**63 + 11)
    eager = state
    before = _counts()
    resets = 0
    for a in _actions(300, batch, cuda, host=host):
        state, ts = env.step(state, a)
        eager, ets = env._step(eager, a)
        assert_same_bits((state, ts), (eager, ets))
        resets += int((ts.terminated | ts.truncated).sum())
    d = _delta(before)
    assert (d["array.graph_captures"], d["array.eager_steps"], d["array.graph_replays"]) == (
        1, 1, 299)
    kernel = coupling == "sequential" and dtype == "float32"
    sweeps = 600 if coupling == "sequential" else 0  # 300 graphed, 300 eager
    assert d["array.sweep_kernels"] == (sweeps if kernel else 0)
    assert d["array.sweep_eager"] == (0 if kernel else sweeps)
    assert d["array.device_updates"] == 600 * env.config.n_devices
    assert resets >= batch  # every array truncated at step 200, at least


@pytest.mark.cuda
def test_array_capture_runs_with_the_collector_off(cuda, monkeypatch):
    env = _env(64, cuda)
    state, _ = env.reset(4)
    seen = []
    body = env._step

    def spy(*args):
        seen.append(gc.isenabled())
        return body(*args)

    monkeypatch.setattr(env, "_step", spy)
    assert gc.isenabled()
    for a in _actions(3, 64, cuda):
        state, _ = env.step(state, a)
    assert seen == [True, False] and gc.isenabled()


@pytest.mark.cuda
def test_stepping_one_array_state_twice_gives_the_same_bits(cuda):
    env = _env(4096, cuda, max_steps=4)
    state, _ = env.reset(7)
    actions = _actions(6, 4096, cuda)
    for a in actions[:5]:
        state, _ = env.step(state, a)
    first = env.step(state, actions[5])
    second = env.step(state, actions[5])
    assert_same_bits(first, second)
    assert_same_bits(first, env._step(state, actions[5]))


@pytest.mark.cuda
def test_tensors_returned_by_an_array_step_survive_later_replays(cuda):
    env = _env(4096, cuda)
    state, _ = env.reset(8)
    held = None
    for k, a in enumerate(_actions(12, 4096, cuda)):
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


def _altered(sweep):
    def altered(*args):
        out, energy = sweep(*args)
        out = out.clone()
        out[0, 0, 0] += 0.05
        return out, energy
    return altered


@pytest.mark.cuda
def test_a_fault_patched_before_the_first_step_is_in_the_capture(cuda):
    sound, faulty = _env(4096, cuda), _env(4096, cuda)
    faulty._sequential_sweep = _altered(faulty._sequential_sweep)
    state, _ = sound.reset(12)
    for a in _actions(4, 4096, cuda):
        got, ts = faulty.step(state, a)
        assert_same_bits((got, ts), faulty._step(state, a))
        want, _ = sound.step(state, a)
        diff = (got.pattern - want.pattern).abs()
        assert diff[0, 0, 0] > 0.04 and diff.flatten()[1:].max() == 0
        state = want
    assert counter("array.graph_captures").count >= 2


@pytest.mark.cuda
def test_a_setter_forces_a_new_capture_that_equals_the_eager_step(cuda):
    env = _env(4096, cuda)
    state, _ = env.reset(9)
    actions = _actions(6, 4096, cuda)
    captures = counter("array.graph_captures")

    def run(steps):
        nonlocal state
        for a in steps:
            nxt, ts = env.step(state, a)
            assert_same_bits((nxt, ts), env._step(state, a))
            state = nxt

    run(actions[:3])
    n = captures.count
    env.coupling = env.coupling * 3.0
    run(actions[3:])
    assert captures.count == n + 1


@pytest.mark.cuda
def test_64_replays_count_their_sweeps_updates_and_steps(cuda):
    """After the capture's step, 64 replays: the counters raised inside the
    body (held at the capture) count 64 steps' worth, as ``array.steps``,
    and a traced replay records ``array.replay`` under ``array.step`` with
    no phase span."""
    env = _env(4096, cuda)
    state, _ = env.reset(13)
    actions = _actions(66, 4096, cuda)
    state, _ = env.step(state, actions[0])  # the capture
    before = _counts()
    for a in actions[1:65]:
        state, _ = env.step(state, a)
    d = _delta(before)
    n = env.config.n_devices
    assert (d["array.sweep_kernels"], d["array.graph_replays"], d["array.steps"]) == (64, 64, 64)
    assert d["array.device_updates"] == 64 * n
    assert d["array.graph_captures"] == d["array.eager_steps"] == d["array.sweep_eager"] == 0
    since = len(PROFILER.spans())
    with tracing():
        env.step(state, actions[65])
    spans = sorted((r.name, r.parent or "") for r in PROFILER.spans()[since:])
    assert spans == [("array.replay", "array.step"), ("array.step", "")]
