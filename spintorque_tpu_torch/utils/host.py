"""Reading an env step's outputs back to the host in one wait, the seeds
of a host loop's resets, and tensors as host arrays for host-side code."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def next_seed(seeds: np.random.SeedSequence) -> int:
    """The next functional reset's seed: a fresh child of ``seeds``, 63
    bits."""
    return int(seeds.spawn(1)[0].generate_state(1, np.uint64)[0] >> np.uint64(1))


def _map(fn: Callable, x: Any) -> Any:
    """``fn`` applied to every leaf of nested dicts, lists and tuples
    (named tuples included)."""
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(fn, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, v) for v in x)
    return fn(x)


def to_host(tree: Any) -> Any:
    """``tree`` with every tensor as a numpy array. Tensors on a card are
    copied with ``non_blocking`` and read after a single
    ``torch.cuda.synchronize()``, where a ``.numpy()`` or ``.item()`` per
    tensor would wait once each. Tensors on the CPU are copied too, so no
    returned array shares memory with the env's state."""
    cards = set()

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.device.type == "cpu":
            return x.detach().clone()
        cards.add(x.device)
        return x.detach().to("cpu", non_blocking=True)

    copied = _map(copy, tree)
    for device in cards:
        torch.cuda.synchronize(device)
    return _map(lambda x: x.numpy() if isinstance(x, torch.Tensor) else x, copied)


def as_numpy(x: Any) -> Any:
    """``x`` as a host value: a tensor (on any device) as a numpy array,
    anything else as it is. Host-side checks and plots call it on their
    inputs, so that they take tensors from the card."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x
