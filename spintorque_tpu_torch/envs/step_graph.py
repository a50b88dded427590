"""A vectorized env's step replayed as one CUDA graph.

``SpinTorqueEnv.step``, ``SpinTorqueArrayEnv.step`` and
``SkyrmionRacetrackEnv.step`` on a CUDA device replay a captured
``torch.cuda.CUDAGraph`` of their eager body (``_step``: SpinTorque-v0's
decode, the pulse's host side and launch, finish, energy, observe, reward,
auto-reset, ~150 eager launches; SpinTorqueArray-v0's decode, the sweep,
reward, observe, auto-reset, ~100; SkyrmionRacetrack-v0's decode, forces
with the thermal kick, ten Euler substeps, reward, observe, auto-reset,
~400) in place of the eager launches. The graph holds the same kernels in the same order, so its
outputs are the eager step's bit for bit. A replay costs the host about
ten launches:

- the state's tensors and the action are copied into the graph's static
  inputs, one ``torch._foreach_copy_`` per dtype. A host action (a numpy
  array) is converted to a device tensor before, as the eager step does;
- the step's random keys are set in stream order by the env's
  ``GraphHook.keys``: SpinTorque-v0's pulse key is filled into a device
  tensor the kernel reads (``ops.cuda_integrator``'s ``pulse_key``), and
  each env's auto-reset draws (and SkyrmionRacetrack-v0's thermal kicks)
  come from generators registered with the graph, each seeded anew
  (``philox.step_seed``), so its Philox offset starts at 0 as a fresh
  eager generator's does;
- the graph writes every returned tensor into one flat arena per dtype
  (``pack``); each replay clones the arenas and returns views into the clones
  (``unpack``), so a later replay never overwrites a tensor the caller holds.

A graph is captured once per key (``StepGraphs.key``): what the env can
observe in its input (the state's tensors' shapes, dtypes and devices, its
reward statistics' names, the action's shape and dtype after conversion and
whether it came from the host), the env's own part (``GraphHook.static_key``:
its device and local batch, and SpinTorque-v0's mesh split), and the
versions of what a capture bakes in as a tensor address or a Python number
(the env's ``graph_version()``). The first step of a key runs the eager body
on a side stream (the warm-up ``torch.cuda.graphs`` asks for, whose outputs
are that step's result), then captures it. ``StepGraphs`` keeps the last
``CACHE_SIZE`` graphs and drops all of them when a version changes.

Each env class gives the shared body a ``GraphHook``: its static key, its
keys, its replay span and its counters (captures, replays, eager steps;
every step is a replay or an eager step, the capture's warm-up included).
A capture's launches are held (``profiling.held_counts``) and added on each
replay, so the kernel counters count the kernels that ran. With tracing on,
a replay runs in the hook's span under the env's step span; the spans inside
the body are recorded only by the warm-up and the capture.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from ..utils.profiling import LaunchCounter, held_counts, span

Tensor = torch.Tensor

# Graphs kept per env: one per key, the least recently used dropped first.
CACHE_SIZE = 4


class GraphHook(NamedTuple):
    """What an env class gives the shared capture and replay: the env's own
    part of the cache key (``static_key``), the span a replay runs in, the
    counters of captures, replays and eager steps, and ``keys(device)``,
    which makes one graph's keys: (the arguments ``_step`` takes after the
    state and the action, a function of the state that sets them before the
    warm-up and each replay, in stream order). Every ``torch.Generator``
    among the arguments is registered with the graph. ``keys`` must hold no
    reference to the env (the env holds its graphs)."""

    static_key: Tuple
    span: str
    captures: LaunchCounter
    replays: LaunchCounter
    eager_steps: LaunchCounter
    keys: Callable[[torch.device], Tuple[Tuple, Callable[[Any], None]]]


# ------------------------------------------------------------ trees of tensors

_TENSOR = object()  # the spec of a tensor leaf


def flatten(tree, leaves: List[Tensor]):
    """Appends the tensors of ``tree`` (dataclasses, dicts, tuples and named
    tuples of tensors and other values) to ``leaves`` in a fixed order and
    returns the spec that ``unflatten`` rebuilds it from; other values are
    kept in the spec as they are."""
    if isinstance(tree, Tensor):
        leaves.append(tree)
        return _TENSOR
    if isinstance(tree, dict):
        return (dict, tuple((k, flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, tuple):
        return (type(tree), tuple(flatten(v, leaves) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree), tuple((f.name, flatten(getattr(tree, f.name), leaves))
                                  for f in dataclasses.fields(tree)), None)
    return ("value", tree)


def unflatten(spec, leaves) -> Any:
    """The tree of ``spec`` with its tensors taken in order from the
    iterator ``leaves``."""
    if spec is _TENSOR:
        return next(leaves)
    kind, items = spec[0], spec[1]
    if kind == "value":
        return items
    if kind is dict:
        return {k: unflatten(v, leaves) for k, v in items}
    if len(spec) == 3:  # a dataclass
        return kind(**{k: unflatten(v, leaves) for k, v in items})
    values = [unflatten(v, leaves) for v in items]
    return kind(*values) if hasattr(kind, "_fields") else kind(values)


# --------------------------------------------------------------------- arenas


class Layout(NamedTuple):
    """Where ``pack`` put each leaf: per dtype the numel of each distinct
    tensor in arena order and the (index, shape) of those that are not
    1-D, and per leaf its (dtype, index)."""

    sizes: Dict[torch.dtype, List[int]]
    shapes: Dict[torch.dtype, List[Tuple[int, Tuple[int, ...]]]]
    slots: List[Tuple[torch.dtype, int]]


def pack(leaves: List[Tensor]) -> Tuple[Dict[torch.dtype, Tensor], Layout]:
    """Copies ``leaves`` into one flat arena per dtype, a tensor given twice
    (by identity) once, by one ``torch.cat`` per dtype. Returns the arenas
    and their ``Layout``."""
    groups: Dict[torch.dtype, List[Tensor]] = {}
    layout = Layout({}, {}, [])
    seen: Dict[int, Tuple[torch.dtype, int]] = {}
    for t in leaves:
        slot = seen.get(id(t))
        if slot is None:
            group = groups.setdefault(t.dtype, [])
            slot = seen[id(t)] = (t.dtype, len(group))
            group.append(t.reshape(-1))
            layout.sizes.setdefault(t.dtype, []).append(t.numel())
            shapes = layout.shapes.setdefault(t.dtype, [])
            if t.dim() != 1:
                shapes.append((slot[1], tuple(t.shape)))
        layout.slots.append(slot)
    return {dtype: torch.cat(group) for dtype, group in groups.items()}, layout


def unpack(arenas: Dict[torch.dtype, Tensor], layout: Layout) -> List[Tensor]:
    """The leaves ``pack`` laid out, as views into ``arenas``: one split a
    dtype, and a view of each piece that is not 1-D."""
    pieces = {}
    for dtype, arena in arenas.items():
        p = pieces[dtype] = list(arena.split_with_sizes(layout.sizes[dtype]))
        for i, shape in layout.shapes[dtype]:
            p[i] = p[i].view(shape)
    return [pieces[dtype][i] for dtype, i in layout.slots]


# --------------------------------------------------------------------- graphs


class StepGraph:
    """One captured step of ``env`` for the inputs of one key, with the
    keys that ``keys`` (``GraphHook.keys``) makes.

    Built from the step it first serves: ``first`` holds that step's
    result, computed by the eager warm-up on a side stream."""

    def __init__(self, env, keys, state, action: Tensor):
        device = env.device
        inputs: List[Tensor] = []
        state_spec = flatten(state, inputs)
        inputs.append(action)
        current = torch.cuda.current_stream(device)
        self.static = [torch.clone(t, memory_format=torch.contiguous_format) for t in inputs]
        # One _foreach_copy_ a dtype: (indices into the inputs, static tensors).
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(inputs):
            by_dtype.setdefault(t.dtype, []).append(i)
        self.copies = [(idx, [self.static[i] for i in idx]) for idx in by_dtype.values()]
        args, self._set_keys = keys(device)
        self._set_keys(state)
        static_state = unflatten(state_spec, iter(self.static))
        static_action = self.static[-1]

        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            # The warm-up is this step: its outputs, packed as a replay's,
            # so that none is a view of a static input.
            leaves: List[Tensor] = []
            spec = flatten(env._step(static_state, static_action, *args), leaves)
            arenas, layout = pack(leaves)
            del leaves
            self.graph = torch.cuda.CUDAGraph()
            for generator in args:
                if isinstance(generator, torch.Generator):
                    self.graph.register_generator_state(generator)
            # No garbage collection during the capture: a graph it freed
            # there (another env's, held in a reference cycle) would call
            # CUDA on this thread and invalidate the capture.
            collecting = gc.isenabled()
            gc.disable()
            try:
                with held_counts() as self.held:
                    self.graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        leaves = []
                        self.spec = flatten(env._step(static_state, static_action, *args),
                                            leaves)
                        self.arenas, self.layout = pack(leaves)
                    finally:
                        self.graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
        current.wait_stream(side)
        for arena in arenas.values():
            arena.record_stream(current)
        self.first = unflatten(spec, iter(unpack(arenas, layout)))
        # The stream of the last replay, and its raw handle (read as
        # ops._build.launch reads it: a Stream object costs a few us).
        self.device = current.device
        self._index = self.device.index
        self.stream = current
        self._raw_stream = current.cuda_stream

    def replay(self, inputs: List[Tensor], state):
        """The step's (next state, TimeStep) for ``inputs`` (the state's
        tensors, then the action), in fresh tensors, on the current stream
        (which first waits for the last replay's, where it differs)."""
        raw = torch._C._cuda_getCurrentRawStream(self._index)
        if raw != self._raw_stream:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_stream(self.stream)
            self.stream, self._raw_stream = stream, raw
        for idx, static in self.copies:
            torch._foreach_copy_(static, [inputs[i] for i in idx])
        self._set_keys(state)
        self.graph.replay()
        arenas = {dtype: arena.clone() for dtype, arena in self.arenas.items()}
        for c, amount in self.held.items():
            c.add(amount)
        return unflatten(self.spec, iter(unpack(arenas, self.layout)))


class StepGraphs:
    """The captured steps of one CUDA env, by key (``CACHE_SIZE`` of them,
    least recently used dropped first, all of them when the env's version
    changes), with the env's ``GraphHook`` (``env._graph_hook()``)."""

    def __init__(self, env):
        # Holds no reference to the env, which holds this: without the
        # cycle, an env's graphs are freed when it is.
        hook = env._graph_hook()
        self._static_key = hook.static_key
        self._keys, self._span = hook.keys, hook.span
        self._captures, self._replays, self._eager = (hook.captures, hook.replays,
                                                      hook.eager_steps)
        self._graphs: "collections.OrderedDict[Any, StepGraph]" = collections.OrderedDict()
        self._version = None

    def key(self, env, inputs: List[Tensor], state, host_action: bool):
        """What a capture depends on: the env's version
        (``env.graph_version()``), its own part (``GraphHook.static_key``),
        the state's reward statistics' names, each input tensor's shape,
        dtype and device (the state's, then the action's after its
        conversion), and whether the action came from the host."""
        return (env.graph_version(), self._static_key, tuple(state.reward_stats),
                host_action, tuple((t.shape, t.dtype, t.device) for t in inputs))

    def step(self, env, state, action):
        """``env.step`` by a graph's replay (a capture at a new key)."""
        host_action = not (isinstance(action, Tensor) and action.device.type == env.device.type)
        action = env._action_tensor(action)
        inputs: List[Tensor] = []
        flatten(state, inputs)
        inputs.append(action)
        key = self.key(env, inputs, state, host_action)
        if key[0] != self._version:
            self._graphs.clear()
            self._version = key[0]
        graph = self._graphs.get(key)
        if graph is None:
            graph = StepGraph(env, self._keys, state, action)
            while len(self._graphs) >= CACHE_SIZE:
                self._graphs.popitem(last=False)
            self._graphs[key] = graph
            self._captures.add()
            self._eager.add()
            (next_state, ts), graph.first = graph.first, None
        else:
            self._graphs.move_to_end(key)
            with span(self._span):
                next_state, ts = graph.replay(inputs, state)
            self._replays.add()
        return dataclasses.replace(next_state, seed=state.seed, counter=state.counter + 1), ts
