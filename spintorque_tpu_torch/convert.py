"""Carry state across from the JAX package, and back for comparisons.

The JAX side is seen only as numpy dicts of its dataclass fields (flax
``struct.dataclass`` leaves), so this module never sees a JAX object:

  * ``LLGSParams`` / ``DeviceParams`` fields -> the port's dataclasses;
  * ``EnvState`` leaves (m, target, step, total_energy, last_current,
    last_duration, episode_return, key, reward_stats) -> the port's EnvState,
    and likewise the array env's ``ArrayEnvState`` (pattern, target, ...)
    and the skyrmion env's ``SkyrmionEnvState`` (positions, velocities, ...);
  * the flax ``ActorCritic`` parameter tree -> ``rl.ActorCritic`` and back;
  * the quantum tier's parameters: the (n_blocks, n_qubits, 2) angles of
    ``QuantumNeuralNetwork`` / ``QuantumReinforcementLearning`` and the
    surrogate MLP's ``[(w, b), ...]`` of ``QuantumMLDeviceOptimizer``.

A JAX PRNG key (two uint32 words) maps to the port's 64-bit seed as
(key[0] << 32) | key[1], and back; the host step counter, which with the
seed keys a step's draws, starts at 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .devices.params import DeviceParams
from .envs.array import ArrayEnvState
from .envs.skyrmion import SkyrmionEnvState
from .envs.spin_torque import EnvState
from .physics.llgs import LLGSParams
from .rewards.composite import RunningStat
from .rl.networks import ActorCritic

_LLGS_FIELDS = [f.name for f in dataclasses.fields(LLGSParams) if f.name != "plus_z"]
_STATE_TENSORS = (
    "m", "target", "step", "total_energy", "last_current", "last_duration", "episode_return",
)
_ARRAY_STATE_TENSORS = ("pattern", "target", "step", "total_energy", "episode_return")
_SKYRMION_STATE_TENSORS = ("positions", "velocities", "step", "total_energy", "episode_return")


def _tensor(x, device, dtype=None):
    return torch.as_tensor(np.array(x), device=device, dtype=dtype)


def llgs_params_from_numpy(d: Dict[str, Any], *, device, dtype=None) -> LLGSParams:
    """LLGSParams from a dict of numpy arrays (its six tensor fields)."""
    return LLGSParams(**{k: _tensor(d[k], device, dtype) for k in _LLGS_FIELDS})


def device_params_from_numpy(d: Dict[str, Any], *, device, dtype=None) -> DeviceParams:
    """DeviceParams from a dict of numpy arrays (every field)."""
    return DeviceParams(**{
        f.name: _tensor(d[f.name], device, dtype) for f in dataclasses.fields(DeviceParams)
    })


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """The tensor fields of LLGSParams or DeviceParams as numpy arrays."""
    return {
        f.name: getattr(params, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(params)
        if isinstance(getattr(params, f.name), torch.Tensor)
    }


def seed_from_key(key) -> int:
    k = np.asarray(key, dtype=np.uint32).reshape(-1)
    return (int(k[0]) << 32) | int(k[1])


def key_from_seed(seed: int) -> np.ndarray:
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def _state_fields(d: Dict[str, Any], names, device, dtype) -> Dict[str, Any]:
    """The tensor leaves ``names``, the seed, a step counter of 0 and the
    reward statistics of a state, from a JAX state's numpy leaves.
    ``dtype`` casts the floating leaves (``step`` stays int32)."""
    device = torch.device(device)
    seed = seed_from_key(d["key"])
    fields = {k: _tensor(d[k], device, torch.int32 if k == "step" else dtype) for k in names}
    stats = {
        name: RunningStat(**{k: _tensor(v, device, dtype) for k, v in st.items()})
        for name, st in d.get("reward_stats", {}).items()
    }
    return dict(fields, seed=seed, counter=0, reward_stats=stats)


def _state_to_numpy(state, names) -> Dict[str, Any]:
    """A JAX state's leaves from a port state (the key carries the seed)."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in names}
    out["key"] = key_from_seed(state.seed)
    out["reward_stats"] = {
        name: {f.name: getattr(st, f.name).detach().cpu().numpy()
               for f in dataclasses.fields(RunningStat)}
        for name, st in state.reward_stats.items()
    }
    return out


def env_state_from_numpy(d: Dict[str, Any], *, device, dtype=None) -> EnvState:
    """EnvState from the JAX EnvState's leaves as numpy arrays.

    ``dtype`` casts the floating leaves (``step`` stays int32)."""
    return EnvState(**_state_fields(d, _STATE_TENSORS, device, dtype))


def env_state_to_numpy(state: EnvState) -> Dict[str, Any]:
    """The JAX EnvState's leaves from the port's EnvState (the host step
    counter has no JAX counterpart: the JAX state's key advances instead)."""
    return _state_to_numpy(state, _STATE_TENSORS)


def array_state_from_numpy(d: Dict[str, Any], *, device, dtype=None) -> ArrayEnvState:
    """ArrayEnvState from the JAX ArrayEnvState's leaves as numpy arrays."""
    return ArrayEnvState(**_state_fields(d, _ARRAY_STATE_TENSORS, device, dtype))


def array_state_to_numpy(state: ArrayEnvState) -> Dict[str, Any]:
    """The JAX ArrayEnvState's leaves from the port's ArrayEnvState."""
    return _state_to_numpy(state, _ARRAY_STATE_TENSORS)


def skyrmion_state_from_numpy(d: Dict[str, Any], *, device, dtype=None) -> SkyrmionEnvState:
    """SkyrmionEnvState from the JAX SkyrmionEnvState's leaves as numpy
    arrays."""
    return SkyrmionEnvState(**_state_fields(d, _SKYRMION_STATE_TENSORS, device, dtype))


def skyrmion_state_to_numpy(state: SkyrmionEnvState) -> Dict[str, Any]:
    """The JAX SkyrmionEnvState's leaves from the port's SkyrmionEnvState."""
    return _state_to_numpy(state, _SKYRMION_STATE_TENSORS)


def _actor_critic_layers(module: ActorCritic):
    """(flax layer name, ``state_dict`` prefix) pairs of an ActorCritic."""
    for name, trunk in module.trunks.items():
        for i in range(len(trunk)):
            yield f"{name}_dense_{i}", f"trunks.{name}.{i}"
    head = "actor_logits" if module.discrete else "actor_mean"
    yield head, head
    yield "critic_value", "critic_value"


def actor_critic_params_from_numpy(flax_params: Dict[str, Any], module: ActorCritic) -> ActorCritic:
    """Copy the flax ActorCritic's parameters (a nested dict of numpy
    arrays) into ``module`` in place, in its dtype and on its device; a
    module that is tensor-parallel over its mesh's 'model' axis takes this
    rank's shard of each. A flax Dense kernel is (in, out) and an
    nn.Linear weight (out, in), so the kernel is transposed. Returns
    ``module``."""
    full = {}
    for name, prefix in _actor_critic_layers(module):
        full[f"{prefix}.weight"] = torch.tensor(np.asarray(flax_params[name]["kernel"]).T)
        full[f"{prefix}.bias"] = torch.tensor(np.asarray(flax_params[name]["bias"]))
    if not module.discrete:
        full["log_std"] = torch.tensor(np.asarray(flax_params["log_std"]))
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(module.take_shard(name, full[name]))
    return module


def actor_critic_params_to_numpy(module: ActorCritic) -> Dict[str, Any]:
    """The flax ActorCritic's parameter tree from ``module``: whole, its
    shards gathered over 'model' on every rank (a collective of the model
    group when the module is tensor-parallel)."""
    full = {k: v.cpu().numpy() for k, v in module.full_state_dict().items()}
    out: Dict[str, Any] = {
        name: {"kernel": full[f"{prefix}.weight"].T.copy(), "bias": full[f"{prefix}.bias"]}
        for name, prefix in _actor_critic_layers(module)
    }
    if not module.discrete:
        out["log_std"] = full["log_std"]
    return out


def variational_params_from_numpy(params, module):
    """Copy the JAX model's (n_blocks, n_qubits, 2) rotation angles (a numpy
    array) into ``module.params`` (of a ``QuantumNeuralNetwork`` or a
    ``QuantumReinforcementLearning``) in place, on its device. Returns
    ``module``."""
    with torch.no_grad():
        module.params.copy_(torch.as_tensor(np.array(params)))
    return module


def variational_params_to_numpy(module) -> np.ndarray:
    """The (n_blocks, n_qubits, 2) rotation angles of ``module``."""
    return module.params.detach().cpu().numpy()


def mlp_params_from_numpy(params: Sequence[Tuple[Any, Any]], *, device,
                          dtype=torch.float32) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The surrogate MLP's ``[(w, b), ...]`` (w (in, out), as in the JAX
    package) from numpy arrays, as tensors on ``device``."""
    return [(_tensor(w, device, dtype), _tensor(b, device, dtype)) for w, b in params]


def mlp_params_to_numpy(params) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The surrogate MLP's ``[(w, b), ...]`` as numpy arrays."""
    return [(w.detach().cpu().numpy(), b.detach().cpu().numpy()) for w, b in params]
