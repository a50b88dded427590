"""Device-parameter and pulse-protocol optimization on batched physics.

PyTorch counterpart of ``spintorque_tpu/research/optimizers.py``: classical
population methods whose whole population evaluates in one objective call,
which for ``switching_objective`` is one launch of the pulse kernel over the
population (K1 on the card, its plain version on the CPU):

  * ``grid_search``          - the full cartesian grid in one call;
  * ``cross_entropy``        - CEM over continuous parameters;
  * ``simulated_annealing``  - chains advancing in lockstep;
  * ``optimize_switching_pulse`` - the (J, dt) pulse minimizing miss
    distance plus energy.

Candidates are float64 tensors on ``device`` (the card unless the caller
asks for "cpu"; ``optimize_switching_pulse`` takes its parameters'
device), as the JAX package's are float64 under x64. The random draws come
from a ``torch.Generator`` on that device seeded with ``seed``: another
stream than the JAX package's, so seeded results agree with it in outcome,
not draw for draw.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from ..physics import IntegratorConfig, LLGSParams, integrate_pulse

Tensor = torch.Tensor
Space = Dict[str, Tuple[float, float]]


class OptimizationResult(NamedTuple):
    best_params: Dict[str, float]
    best_value: float
    history: np.ndarray  # per-iteration best objective
    n_evaluations: int
    method: str


def _bounds(space: Space, device, dtype=torch.float64):
    lo = torch.tensor([lo for lo, _ in space.values()], dtype=dtype, device=device)
    hi = torch.tensor([hi for _, hi in space.values()], dtype=dtype, device=device)
    return lo, hi


def _columns(names, x: Tensor) -> Dict[str, Tensor]:
    return {n: x[:, i] for i, n in enumerate(names)}


def grid_search(
    objective: Callable[[Dict[str, Tensor]], Tensor],
    space: Space,
    points_per_dim: int = 16,
    *,
    device=None,
) -> OptimizationResult:
    """Exhaustive sweep: the full cartesian grid evaluates in ONE call."""
    device = resolve_device(device, None)
    names = list(space)
    axes = [torch.linspace(lo, hi, points_per_dim, dtype=torch.float64, device=device)
            for lo, hi in space.values()]
    flat = {n: g.reshape(-1) for n, g in zip(names, torch.meshgrid(*axes, indexing="ij"))}
    values = objective(flat)
    idx = int(torch.argmin(values))
    best_value = float(values[idx])
    return OptimizationResult(
        best_params={n: float(flat[n][idx]) for n in names},
        best_value=best_value,
        history=np.asarray([best_value]),
        n_evaluations=int(values.shape[0]),
        method="grid_search",
    )


def cross_entropy(
    objective: Callable[[Dict[str, Tensor]], Tensor],
    space: Space,
    population: int = 1024,
    elites: int = 64,
    iterations: int = 20,
    seed: int = 0,
    smoothing: float = 0.5,
    *,
    device=None,
) -> OptimizationResult:
    """Cross-entropy method; one objective call per generation."""
    device = resolve_device(device, None)
    names = list(space)
    lo, hi = _bounds(space, device)
    mean = (lo + hi) / 2.0
    std = (hi - lo) / 2.0
    generator = torch.Generator(device=device).manual_seed(seed)
    history = []
    best_val = torch.tensor(float("inf"), dtype=torch.float64, device=device)
    best_x = mean

    for _ in range(iterations):
        noise = torch.randn((population, len(names)), generator=generator, dtype=torch.float64,
                            device=device)
        samples = torch.clamp(mean + std * noise, lo, hi)
        values = objective(_columns(names, samples))
        order = torch.argsort(values)
        elite = samples[order[:elites]]
        gen_best = values[order[0]].to(torch.float64)
        better = gen_best < best_val
        best_val = torch.where(better, gen_best, best_val)
        best_x = torch.where(better, samples[order[0]], best_x)
        mean = smoothing * elite.mean(0) + (1 - smoothing) * mean
        std = smoothing * elite.std(0, correction=0) + (1 - smoothing) * std + 1e-12
        history.append(float(gen_best))

    return OptimizationResult(
        best_params={n: float(best_x[i]) for i, n in enumerate(names)},
        best_value=float(best_val),
        history=np.asarray(history),
        n_evaluations=population * iterations,
        method="cross_entropy",
    )


def simulated_annealing(
    objective: Callable[[Dict[str, Tensor]], Tensor],
    space: Space,
    chains: int = 256,
    iterations: int = 100,
    t_start: float = 1.0,
    t_end: float = 1e-3,
    seed: int = 0,
    *,
    device=None,
) -> OptimizationResult:
    """Batched annealing: ``chains`` independent walkers advance in
    lockstep, one objective call per iteration."""
    device = resolve_device(device, None)
    names = list(space)
    lo, hi = _bounds(space, device)
    span = hi - lo
    generator = torch.Generator(device=device).manual_seed(seed)

    def draw(fn, shape):
        return fn(shape, generator=generator, dtype=torch.float64, device=device)

    x = lo + span * draw(torch.rand, (chains, len(names)))
    v = objective(_columns(names, x))

    history = []
    for t in np.geomspace(t_start, t_end, iterations):
        prop = torch.clamp(x + 0.1 * span * draw(torch.randn, x.shape), lo, hi)
        pv = objective(_columns(names, prop))
        accept = (pv < v) | (draw(torch.rand, v.shape) < torch.exp(-(pv - v) / float(t)))
        x = torch.where(accept[:, None], prop, x)
        v = torch.where(accept, pv, v)
        history.append(float(v.min()))

    idx = int(torch.argmin(v))
    return OptimizationResult(
        best_params={n: float(x[idx, i]) for i, n in enumerate(names)},
        best_value=float(v[idx]),
        history=np.asarray(history),
        n_evaluations=chains * (iterations + 1),
        method="simulated_annealing",
    )


def _unit(v: Sequence[float]) -> np.ndarray:
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


def switching_objective(
    base_params: LLGSParams,
    m_initial: Sequence[float] = (0.1, 0.0, 0.995),
    target: Sequence[float] = (0.0, 0.0, -1.0),
    energy_weight: float = 0.1,
    resistance: float = 1e3,
    area: float = 5e-15,
    config: Optional[IntegratorConfig] = None,
) -> Callable[[Dict[str, Tensor]], Tensor]:
    """Objective over (current, duration) pulses: miss distance to the
    target plus an energy penalty, one pulse per candidate in one call of
    the integrator on ``base_params``' device (float32, as the JAX
    package's objective)."""
    cfg = config or IntegratorConfig(method="rk4", max_substeps=2048)
    m0, tgt = _unit(m_initial), _unit(target)
    device = base_params.saturation_magnetization.device
    params = base_params.to(dtype=torch.float32)

    def objective(candidates: Dict[str, Tensor]) -> Tensor:
        current = torch.as_tensor(candidates["current"]).to(device, torch.float32).contiguous()
        duration = torch.as_tensor(candidates["duration"]).to(device, torch.float32)
        duration = torch.clamp_min(duration, 1e-12).contiguous()
        B = current.shape[0]
        start = tuple(torch.full((B,), float(c), device=device) for c in m0)
        res = integrate_pulse(start, duration, current, params, cfg)
        align = res.m[0] * float(tgt[0]) + res.m[1] * float(tgt[1]) + res.m[2] * float(tgt[2])
        energy = current**2 * area**2 * resistance * duration
        return (1.0 - align) + energy_weight * energy / 1e-12

    return objective


def optimize_switching_pulse(
    base_params: LLGSParams,
    method: str = "cross_entropy",
    max_current: float = 2e6,
    max_duration: float = 2e-9,
    **kwargs,
) -> OptimizationResult:
    """Optimize a (current, duration) pulse with ``method`` on the device of
    ``base_params``."""
    objective = switching_objective(base_params)
    space = {"current": (-max_current, max_current), "duration": (1e-11, max_duration)}
    kwargs.setdefault("device", base_params.saturation_magnetization.device)
    if method == "grid_search":
        return grid_search(objective, space, **kwargs)
    if method == "simulated_annealing":
        return simulated_annealing(objective, space, **kwargs)
    return cross_entropy(objective, space, **kwargs)
