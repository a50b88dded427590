"""Structured health checks: physics, device, environment, system.

PyTorch counterpart of ``spintorque_tpu/utils/health.py``. The checks run
the real subsystems on ``device`` (the card unless the caller asks for
"cpu"): a short pulse through ``integrate_pulse`` (the pulse kernel K1 on
the card), every device type of the factory, a one-step env of four envs
(K1 again, with the probe kernel K2 on the process's first use) and the
host's backend and memory. They feed ``utils.monitoring.HealthMonitor``,
so ``get_health_monitor().run()`` reports as in the JAX package.
"""

from __future__ import annotations

import threading
import time
from abc import ABC, abstractmethod
from typing import Dict, Tuple

import numpy as np
import torch

from .monitoring import HealthMonitor

__all__ = [
    "HealthCheck",
    "PhysicsHealthCheck",
    "DeviceHealthCheck",
    "EnvironmentHealthCheck",
    "SystemHealthCheck",
    "build_full_health_monitor",
    "get_health_monitor",
]


def _device(device) -> torch.device:
    from ..parallel.mesh import resolve_device

    return resolve_device(device, None)


class HealthCheck(ABC):
    """One named check; __call__ returns (ok, detail) for the aggregator.
    ``device`` is where the check runs: "cuda" unless the caller asks for
    "cpu"."""

    name = "health_check"

    def __init__(self, device=None):
        self.device = device

    @abstractmethod
    def check(self) -> Tuple[bool, str]:
        ...

    def __call__(self) -> Tuple[bool, str]:
        t0 = time.perf_counter()
        ok, detail = self.check()
        return ok, f"{detail} ({(time.perf_counter() - t0) * 1e3:.0f} ms)"


class PhysicsHealthCheck(HealthCheck):
    """A 10 ps RK4 pulse of one env (10 substeps): finite, unit-norm output."""

    name = "physics"

    def check(self) -> Tuple[bool, str]:
        from ..physics.integrator import IntegratorConfig, integrate_pulse
        from ..physics.solver import params_from_dict

        dev = _device(self.device)
        params = params_from_dict(dict(volume=1e-24), device=dev)

        def t(v):
            return torch.tensor([v], dtype=torch.float32, device=dev)

        res = integrate_pulse(
            (t(0.1), t(0.0), t(0.995)), t(1e-11), t(0.0), params,
            IntegratorConfig(method="rk4", max_substeps=32),
        )
        m = torch.stack(res.m).cpu().numpy().ravel()
        norm = float(np.linalg.norm(m))
        ok = bool(np.isfinite(m).all() and abs(norm - 1.0) < 1e-4)
        return ok, f"|m|={norm:.6f}"


class DeviceHealthCheck(HealthCheck):
    """Device factory + resistance sanity for every registered type."""

    name = "devices"

    def check(self) -> Tuple[bool, str]:
        from ..devices import device_factory

        dev = _device(self.device)
        plus_z = torch.tensor([0.0, 0.0, 1.0], device=dev)
        problems = []
        for dev_type in device_factory.get_available_devices():
            try:
                d = device_factory.create_default_device(dev_type, device=dev)
                r = float(d.compute_resistance(plus_z))
                if not (np.isfinite(r) and r > 0):
                    problems.append(f"{dev_type}: R={r}")
            except Exception as exc:  # noqa: BLE001
                problems.append(f"{dev_type}: {exc!r}")
        return (not problems), (", ".join(problems) or "all device types OK")


class EnvironmentHealthCheck(HealthCheck):
    """One step of a vectorized env: finite obs and reward."""

    name = "environment"

    def __init__(self, batch_size: int = 4, device=None):
        super().__init__(device)
        self.batch_size = batch_size

    def check(self) -> Tuple[bool, str]:
        from ..envs import SpinTorqueEnv, SpinTorqueEnvConfig

        env = SpinTorqueEnv(
            batch_size=self.batch_size,
            config=SpinTorqueEnvConfig(max_duration=1e-11, max_substeps=32),
            device=_device(self.device),
        )
        state, obs = env.reset(0)
        action = torch.tensor([1e5, 5e-12], dtype=obs.dtype, device=env.device)
        state, ts = env.step(state, action.expand(self.batch_size, 2))
        obs_ok = bool(torch.isfinite(ts.obs).all())
        rew_ok = bool(torch.isfinite(ts.reward).all())
        return obs_ok and rew_ok, f"obs finite={obs_ok}, reward finite={rew_ok}"


class SystemHealthCheck(HealthCheck):
    """The device present (``cuda x<count>`` or ``cpu``) and host memory
    headroom."""

    name = "system"

    def __init__(self, min_free_fraction: float = 0.05, device=None):
        super().__init__(device)
        self.min_free_fraction = min_free_fraction

    def check(self) -> Tuple[bool, str]:
        dev = _device(self.device)
        n = torch.cuda.device_count() if dev.type == "cuda" else 0
        detail = f"cuda x{n}" if dev.type == "cuda" else "cpu"
        try:
            info: Dict[str, int] = {}
            with open("/proc/meminfo") as fh:
                for line in fh:
                    name, _, rest = line.partition(":")
                    fields = rest.split()
                    if fields:
                        info[name.strip()] = int(fields[0])
            free = info.get("MemAvailable", 0) / max(info.get("MemTotal", 1), 1)
            detail += f", mem free {free:.0%}"
            mem_ok = free > self.min_free_fraction
        except (OSError, ValueError):
            mem_ok = True  # non-Linux host: skip the memory probe
        return (dev.type == "cpu" or n > 0) and mem_ok, detail


def build_full_health_monitor(device=None) -> HealthMonitor:
    """HealthMonitor preloaded with the physics/device/env/system checks,
    each on ``device``."""
    hm = HealthMonitor()
    for check in (
        PhysicsHealthCheck(device),
        DeviceHealthCheck(device),
        EnvironmentHealthCheck(device=device),
        SystemHealthCheck(device=device),
    ):
        hm.register(check.name, check)
    return hm


_monitors: Dict[str, HealthMonitor] = {}
_monitor_lock = threading.Lock()


def get_health_monitor(device=None) -> HealthMonitor:
    """The process-global full monitor of ``device``, one per device."""
    key = str(_device(device))
    with _monitor_lock:
        if key not in _monitors:
            _monitors[key] = build_full_health_monitor(device)
        return _monitors[key]
