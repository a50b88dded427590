"""Gymnasium registration of the port's envs.

The JAX package registers the bare ids (SpinTorque-v0, SpinTorqueArray-v0,
SkyrmionRacetrack-v0) in gymnasium's registry, of which a process has one.
The port registers the same three names, episode limits and kwargs under
the namespace ``spintorque_torch`` (``spintorque_torch/SpinTorque-v0``, ...)
and never registers or removes a bare id, so both packages can be imported
in one process:

    import gymnasium as gym
    import spintorque_tpu_torch

    env = gym.make("spintorque_torch/SpinTorque-v0", device="cpu")
"""

from __future__ import annotations

NAMESPACE = "spintorque_torch"

_SPECS = [
    ("SpinTorque-v0", "spintorque_tpu_torch.envs.gym_adapter:GymSpinTorqueEnv", 100,
     {"device_type": "stt_mram"}),
    ("SpinTorqueArray-v0", "spintorque_tpu_torch.envs.gym_adapter:GymSpinTorqueArrayEnv", 200,
     {"array_size": (4, 4)}),
    ("SkyrmionRacetrack-v0", "spintorque_tpu_torch.envs.gym_adapter:GymSkyrmionRacetrackEnv",
     150, {}),
]

_REGISTERED = False


def register_envs(force: bool = False) -> None:
    """Register the ids ``spintorque_torch/<name>``.

    ``force=True`` re-registers an id of the namespace that another package
    has taken over since; ids outside the namespace are never touched.
    """
    global _REGISTERED
    if _REGISTERED and not force:
        return
    from gymnasium.envs.registration import register, registry

    for name, entry_point, max_steps, kwargs in _SPECS:
        env_id = f"{NAMESPACE}/{name}"
        existing = registry.get(env_id)
        if existing is not None:
            entry = getattr(existing, "entry_point", None)
            ours = isinstance(entry, str) and entry.startswith("spintorque_tpu_torch.")
            if ours or not force:
                continue
            del registry[env_id]
        register(id=env_id, entry_point=entry_point, max_episode_steps=max_steps, kwargs=kwargs)
    _REGISTERED = True
