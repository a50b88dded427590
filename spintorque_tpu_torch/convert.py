"""Carry state across from the JAX package, and back for comparisons.

The JAX side is seen only as numpy dicts of its dataclass fields (flax
``struct.dataclass`` leaves), so this module never sees a JAX object:

  * ``LLGSParams`` / ``DeviceParams`` fields -> the port's dataclasses;
  * ``EnvState`` leaves (m, target, step, total_energy, last_current,
    last_duration, episode_return, key, reward_stats) -> the port's EnvState.

A JAX PRNG key (two uint32 words) maps to the port's 64-bit seed as
(key[0] << 32) | key[1], and back; the port's reset generator is seeded with
it and its host step counter starts at 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .devices.params import DeviceParams
from .envs.spin_torque import EnvState
from .physics.llgs import LLGSParams
from .rewards.composite import RunningStat

_LLGS_FIELDS = [f.name for f in dataclasses.fields(LLGSParams) if f.name != "plus_z"]
_STATE_TENSORS = (
    "m", "target", "step", "total_energy", "last_current", "last_duration", "episode_return",
)


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


def env_state_from_numpy(d: Dict[str, Any], *, device, dtype=None) -> EnvState:
    """EnvState from the JAX EnvState's leaves as numpy arrays.

    ``dtype`` casts the floating leaves (``step`` stays int32)."""
    device = torch.device(device)
    seed = seed_from_key(d["key"])
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    fields = {}
    for k in _STATE_TENSORS:
        fields[k] = _tensor(d[k], device, torch.int32 if k == "step" else dtype)
    stats = {
        name: RunningStat(**{k: _tensor(v, device, dtype) for k, v in st.items()})
        for name, st in d.get("reward_stats", {}).items()
    }
    return EnvState(**fields, seed=seed, counter=0, generator=generator, reward_stats=stats)


def env_state_to_numpy(state: EnvState) -> Dict[str, Any]:
    """The JAX EnvState's leaves from the port's EnvState (the key carries
    the seed; the host step counter has no JAX counterpart)."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in _STATE_TENSORS}
    out["key"] = key_from_seed(state.seed)
    out["reward_stats"] = {
        name: {f.name: getattr(st, f.name).detach().cpu().numpy()
               for f in dataclasses.fields(RunningStat)}
        for name, st in state.reward_stats.items()
    }
    return out
