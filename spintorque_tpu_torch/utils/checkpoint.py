"""Checkpoint and resume for env states, trainers and parameters.

PyTorch counterpart of ``spintorque_tpu/utils/checkpoint.py``, on
``torch.save`` / ``torch.load(weights_only=True)`` in place of orbax. A
tree is nested dicts, lists and tuples of tensors, numpy arrays and Python
numbers and strings; it is written with every tensor on the CPU and numpy
arrays as tensors, and loaded back with tensors (on the CPU) unless a
``target`` template gives each leaf's kind, dtype and device.

An env step is a function of its state (the state's host ``seed`` and
``counter`` key every draw of the step), so a saved state resumes bit for
bit: ``save_env_state`` writes the state's tensors, seed and counter. A
trainer additionally carries its network, its optimizer and the
generator that draws its actions and minibatches; ``save_train_state``
writes their ``state_dict``s and the generator's state.

A network that is tensor-parallel over a mesh's 'model' axis is written
whole: ``save_params`` and ``save_train_state`` gather its shards (and its
Adam moments') first, so one process without a mesh loads the file, and
``load_train_state`` for a trainer on a mesh slices them to its shards
again. The gather is a collective: every rank of the model group calls
the save (each with a path of its own, or one writing and the rest
gathering through ``rl.ActorCritic.full_state_dict``).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def _to_saveable(tree):
    if isinstance(tree, Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, dict):
        return {k: _to_saveable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_saveable(v) for v in tree)
    return tree


def _like(loaded, target):
    """``loaded`` in the form of ``target``: a numpy leaf as numpy of its
    dtype, a tensor leaf as a tensor of its dtype on its device."""
    if isinstance(target, Tensor):
        return torch.as_tensor(loaded).to(device=target.device, dtype=target.dtype)
    if isinstance(target, (np.ndarray, np.generic)):
        return np.asarray(torch.as_tensor(loaded).numpy(), dtype=target.dtype)
    if isinstance(target, dict):
        return {k: _like(loaded[k], v) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_like(a, b) for a, b in zip(loaded, target))
    return loaded


def save_pytree(path, tree: Any) -> None:
    """Save a tree (state dicts, parameters, arrays) to the file ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_to_saveable(tree), path)


def load_pytree(path, target: Optional[Any] = None) -> Any:
    """Load a tree; ``target`` (a template tree) restores each leaf's kind,
    dtype and device."""
    tree = torch.load(Path(path), map_location="cpu", weights_only=True)
    return tree if target is None else _like(tree, target)


def _full_state(module: torch.nn.Module) -> dict:
    """A module's whole ``state_dict``: gathered over 'model' for a
    tensor-parallel ``rl.ActorCritic``."""
    full = getattr(module, "full_state_dict", None)
    return full() if full is not None else module.state_dict()


def save_params(path, params: Any) -> None:
    """Save parameters: a module's whole ``state_dict`` (a tensor-parallel
    network's gathered, on every rank of its model group), or any tree."""
    save_pytree(path, _full_state(params) if isinstance(params, torch.nn.Module) else params)


def load_params(path, target: Optional[Any] = None) -> Any:
    """Load parameters; a module ``target`` takes them in place (a
    tensor-parallel network its shards of them) and is returned, any other
    target is a template tree."""
    if isinstance(target, torch.nn.Module):
        load = getattr(target, "load_full_state_dict", target.load_state_dict)
        load(load_pytree(path))
        return target
    return load_pytree(path, target)


def _optimizer_state(network, state: dict, move) -> dict:
    """An optimizer ``state_dict`` with each per-parameter tensor of a
    parameter's shape (Adam's moments) passed through ``move(name, t)``:
    the network's gather (``gather_shard``) or slice (``take_shard``) of
    that parameter."""
    names = [name for name, _ in network.named_parameters()]
    return dict(state, state={
        i: {k: move(names[i], v) if isinstance(v, Tensor) and v.dim() else v
            for k, v in s.items()}
        for i, s in state["state"].items()})


def _state_tree(state) -> dict:
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
              if f.name != "reward_stats"}
    stats = {name: dataclasses.asdict(st) for name, st in state.reward_stats.items()}
    return {"type": type(state).__name__, "fields": fields, "reward_stats": stats}


def _state_from_tree(tree: dict, device):
    # Imported here: ``utils`` is imported by the low layers (``ops``, for
    # ``utils.profiling``), so its package imports nothing of the envs.
    from ..envs.array import ArrayEnvState
    from ..envs.skyrmion import SkyrmionEnvState
    from ..envs.spin_torque import EnvState
    from ..rewards.composite import RunningStat

    cls = {c.__name__: c for c in (EnvState, ArrayEnvState, SkyrmionEnvState)}[tree["type"]]

    def on(x):
        return x.to(device) if isinstance(x, Tensor) else x

    stats = {name: RunningStat(**{k: on(v) for k, v in st.items()})
             for name, st in tree["reward_stats"].items()}
    return cls(**{k: on(v) for k, v in tree["fields"].items()}, reward_stats=stats)


def save_env_state(path, state) -> None:
    """Save an ``EnvState``, ``ArrayEnvState`` or ``SkyrmionEnvState``: its
    tensors, reward statistics, seed and step counter."""
    save_pytree(path, _state_tree(state))


def load_env_state(path, device):
    """The env state saved at ``path``, its tensors on ``device``."""
    return _state_from_tree(load_pytree(path), torch.device(device))


def save_train_state(path, ts) -> None:
    """Save a ``rl.TrainState``: the network's and the optimizer's
    ``state_dict``s (whole: a tensor-parallel network's gathered, so every
    rank of its model group calls this), the env state (this rank's rows),
    the last observation, the generator's state and the update count."""
    network = ts.network
    save_pytree(path, {
        "network": network.full_state_dict(),
        "optimizer": _optimizer_state(network, ts.optimizer.state_dict(), network.gather_shard),
        "env_state": _state_tree(ts.env_state),
        "obs": ts.obs,
        "generator": ts.generator.get_state(),
        "update_count": ts.update_count,
    })


def load_train_state(path, trainer):
    """The ``rl.TrainState`` saved at ``path``, rebuilt for ``trainer``
    (its network and optimizer, on its env's device; on a 'model' axis
    this rank's shards of them): training resumes from it as it would have
    gone on from the saved state."""
    from ..rl.ppo import TrainState

    tree = load_pytree(path)
    device = trainer.env.device
    network = trainer.make_network()
    network.load_full_state_dict(tree["network"])
    optimizer = trainer.make_optimizer(network)
    optimizer.load_state_dict(_optimizer_state(network, tree["optimizer"], network.take_shard))
    generator = torch.Generator(device=device)
    generator.set_state(tree["generator"])
    return TrainState(
        network=network, optimizer=optimizer,
        env_state=_state_from_tree(tree["env_state"], device),
        obs=tree["obs"].to(device), generator=generator, update_count=tree["update_count"],
    )


class CheckpointManager:
    """Rolling checkpoints with retention: ``step_<n>.pt`` files in
    ``directory``, the newest ``max_to_keep`` kept."""

    def __init__(self, directory, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def all_steps(self):
        if not self.directory.is_dir():
            return []
        steps = (re.fullmatch(r"step_(\d+)\.pt", p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in steps if m)

    def save(self, step: int, tree: Any) -> None:
        save_pytree(self._path(step), tree)
        for old in self.all_steps()[:-self.max_to_keep]:
            self._path(old).unlink()

    def restore(self, step: Optional[int] = None, target: Optional[Any] = None):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self.directory}")
        return load_pytree(self._path(step), target)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None
