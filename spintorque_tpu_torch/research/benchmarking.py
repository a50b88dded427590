"""Benchmark and validation harness.

PyTorch counterpart of ``spintorque_tpu/research/benchmarking.py``: a
registry of benchmark scenarios with a JSON report, statistics with
bootstrap confidence intervals and Welch tests, and policy comparisons on
identical env resets. The statistics are a numpy/scipy copy of the JAX
module's, equal value for value.

The scenarios run on the card (``device``, "cuda" unless the caller asks
for "cpu"): the env scenario is 32 eager env steps (each a pulse-kernel
launch) ending in one synchronize, in place of the JAX package's jitted
``lax.scan``; the solver scenario is one launch over B=4096 pulses of 1000
RK4 substeps. A report names the card and its power limit (``nvidia-smi``)
in place of the JAX package's backend fields.
"""

from __future__ import annotations

import json
import platform
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from ..utils.host import card_line


@dataclass
class BenchmarkResult:
    name: str
    value: float
    unit: str
    std: float = 0.0
    ci95: tuple = (0.0, 0.0)
    extra: Dict[str, Any] = field(default_factory=dict)


def bootstrap_ci(samples: np.ndarray, n_boot: int = 1000, seed: int = 0):
    """95% bootstrap CI of the mean."""
    rng = np.random.default_rng(seed)
    samples = np.asarray(samples, float)
    means = rng.choice(samples, size=(n_boot, samples.size), replace=True).mean(1)
    return float(np.percentile(means, 2.5)), float(np.percentile(means, 97.5))


def significance_test(a, b) -> Dict[str, float]:
    """Welch's t-test with Cohen's d."""
    from scipy import stats

    t, p = stats.ttest_ind(np.asarray(a, float), np.asarray(b, float), equal_var=False)
    pooled = np.sqrt((np.var(a, ddof=1) + np.var(b, ddof=1)) / 2)
    cohens_d = (np.mean(a) - np.mean(b)) / pooled if pooled > 0 else 0.0
    return {"t_statistic": float(t), "p_value": float(p), "cohens_d": float(cohens_d)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BenchmarkSuite:
    """Registry of benchmark scenarios producing a JSON report."""

    def __init__(self, name: str = "spintorque_tpu_torch", device=None):
        self.name = name
        self.device = resolve_device(device, None)
        self._scenarios: Dict[str, Callable[[], BenchmarkResult]] = {}

    def register(self, name: str, fn: Callable[[], BenchmarkResult]) -> None:
        self._scenarios[name] = fn

    def run(self, names: Optional[List[str]] = None) -> Dict[str, Any]:
        selected = names or list(self._scenarios)
        results = {}
        for n in selected:
            t0 = time.perf_counter()
            res = self._scenarios[n]()
            res.extra["wall_s"] = round(time.perf_counter() - t0, 3)
            results[n] = asdict(res)
        cuda = self.device.type == "cuda"
        return {
            "suite": self.name,
            "backend": self.device.type,
            "devices": torch.cuda.device_count() if cuda else 1,
            "card": card_line() if cuda else None,
            "platform": platform.platform(),
            "results": results,
        }

    def run_and_save(self, path: str | Path, **kwargs) -> Dict[str, Any]:
        report = self.run(**kwargs)
        Path(path).write_text(json.dumps(report, indent=2))
        return report


def _rates(run, work: int, device: torch.device) -> np.ndarray:
    """``work`` units over the seconds of each of three timed calls of
    ``run`` (after one warm-up call), each ending in a synchronize."""
    run()
    _sync(device)
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        run(i)
        _sync(device)
        times.append(work / (time.perf_counter() - t0))
    return np.asarray(times)


def _throughput_scenario(batch_size: int, thermal: bool, steps: int = 32, device=None):
    def run() -> BenchmarkResult:
        from ..envs import SpinTorqueEnv, SpinTorqueEnvConfig
        from ..parallel import random_policy

        env = SpinTorqueEnv(batch_size=batch_size, device=device,
                            config=SpinTorqueEnvConfig(include_thermal=thermal, dtype="float32"))
        policy = random_policy(env)
        state, obs = env.reset(0)
        carry = [state, obs]

        def loop(i=-1):
            generator = torch.Generator(device=env.device).manual_seed(i + 1)
            for _ in range(steps):
                carry[0], ts = env.step(carry[0], policy(None, carry[1], generator))
                carry[1] = ts.obs

        arr = _rates(loop, steps * batch_size, env.device)
        return BenchmarkResult(
            name=f"env_steps_per_s_B{batch_size}_thermal={thermal}",
            value=float(arr.mean()), unit="env-steps/s", std=float(arr.std()),
            ci95=bootstrap_ci(arr),
        )

    return run


def _solver_scenario(batch_size: int = 4096, substeps: int = 1000, device=None):
    def run() -> BenchmarkResult:
        from ..physics import IntegratorConfig, integrate_pulse
        from ..physics.solver import params_from_dict

        dev = resolve_device(device, None)
        p = params_from_dict(
            dict(volume=1e-23, saturation_magnetization=800e3, damping=0.01,
                 uniaxial_anisotropy=1.2e6, polarization=0.7,
                 easy_axis=np.array([0.0, 0.0, 1.0])), device=dev)
        m = torch.randn((batch_size, 3), generator=torch.Generator().manual_seed(0))
        m = (m / torch.linalg.vector_norm(m, dim=-1, keepdim=True)).to(dev)
        m0 = tuple(m[:, c].contiguous() for c in range(3))
        spans = torch.full((batch_size,), substeps * 1e-12, device=dev)
        cur = torch.full((batch_size,), 1e2, device=dev)
        cfg = IntegratorConfig(method="rk4", max_substeps=substeps + 16)

        arr = _rates(lambda i=-1: integrate_pulse(m0, spans, cur, p, cfg), batch_size, dev)
        return BenchmarkResult(
            name=f"solver_pulses_per_s_B{batch_size}_{substeps}substeps",
            value=float(arr.mean()), unit="pulses/s", std=float(arr.std()),
            ci95=bootstrap_ci(arr),
        )

    return run


def create_standard_benchmark_suite(device=None) -> BenchmarkSuite:
    """The standard suite: the solver at B=4096 x 1000 RK4 substeps and the
    env at B=4096, thermal and deterministic, on ``device``."""
    suite = BenchmarkSuite(device=device)
    suite.register("solver_4096x1000", _solver_scenario(4096, 1000, suite.device))
    suite.register("env_4096_thermal", _throughput_scenario(4096, True, device=suite.device))
    suite.register("env_4096_det", _throughput_scenario(4096, False, device=suite.device))
    return suite


def compare_policies(
    env,
    policies: Dict[str, Callable],
    horizon: int = 100,
    seed: int = 0,
) -> Dict[str, Any]:
    """Run several policies on identical env resets and report per-policy
    return statistics and pairwise Welch tests. A policy is
    ``policy(params, obs, generator)`` (``parallel.rollout``'s contract,
    called with params None); each starts from ``env.reset(seed)`` and
    draws from a generator on the env's device seeded with ``seed + 1``."""
    from ..parallel import rollout, summarize

    out: Dict[str, Any] = {"policies": {}}
    returns: Dict[str, np.ndarray] = {}
    for name, policy in policies.items():
        state, obs = env.reset(seed)
        generator = torch.Generator(device=env.device).manual_seed(seed + 1)
        state, obs, traj = rollout(env, policy, None, state, obs, generator, horizon)
        ep_returns = traj.info["episode_return"][-1].cpu().numpy()
        returns[name] = ep_returns
        stats = {k: float(v) for k, v in summarize(traj, env).items()}
        stats["mean_return"] = float(ep_returns.mean())
        out["policies"][name] = stats
    names = list(policies)
    out["significance"] = {
        f"{a}_vs_{b}": significance_test(returns[a], returns[b])
        for i, a in enumerate(names)
        for b in names[i + 1:]
    }
    return out
