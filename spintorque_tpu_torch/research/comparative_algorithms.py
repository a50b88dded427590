"""Comparative baselines for switching-protocol control.

PyTorch counterpart of ``spintorque_tpu/research/comparative_algorithms.py``.
``OptimalControlBaseline`` is GRAPE-style optimal control: the piecewise-
constant current protocol is optimized by Adam with gradients taken through
the batched LLGS integrator. The JAX package vmaps ``jax.grad`` through its
trajectory scan over the random restarts; here the restarts are the batch
axis of one plain pulse per segment (``physics.integrator.
integrate_pulse_plain``, differentiable, on the parameters' device), the
segments run one after another, and one ``backward()`` of the summed loss
gives every restart its own gradient, since rows are independent. The
pulse kernel takes no gradient; the JAX package too differentiates plain
XLA here, not its Pallas kernel. On the card this path is eager and
host-bound: each substep's forward and backward ops are launches of their
own.

``ComparativeAnalysis.register_default_controllers`` passes
``iterations=60`` to ``optimize``; the JAX package passes it to the
constructor, which takes no such argument, and its default
``optimal_control`` controller (and with it ``run_comprehensive_benchmark``)
raises ``TypeError``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..physics.integrator import IntegratorConfig, integrate_pulse_plain
from ..physics.llgs import LLGSParams, energy_density
from .benchmarking import bootstrap_ci, significance_test
from .optimizers import _unit

__all__ = [
    "OptimalControlBaseline",
    "PhysicsInformedRL",
    "ComparativeAnalysis",
    "run_comprehensive_benchmark",
]

Tensor = torch.Tensor


def _scalar(x) -> float:
    return float(torch.as_tensor(x).reshape(-1)[0])


class OptimalControlBaseline:
    """GRAPE-style gradient optimal control of segmented current protocols.

    The protocol is ``n_segments`` piecewise-constant current densities of
    equal duration; the loss is the miss distance to the target orientation
    plus an energy penalty. ``n_restarts`` protocols optimize at once as the
    rows of one batch, on the device of ``params`` (float32 physics, as the
    JAX package's; float64 protocol parameters and Adam)."""

    def __init__(
        self,
        params: LLGSParams,
        n_segments: int = 4,
        segment_duration: float = 2.5e-10,
        max_current: Optional[float] = None,
        energy_weight: float = 0.1,
        resistance: float = 1e3,
        area: float = 5e-15,
        method: str = "rk4",
        max_substeps: int = 512,
    ):
        self.params = params.to(dtype=torch.float32)
        self.device = self.params.saturation_magnetization.device
        self.n_segments = n_segments
        self.segment_duration = segment_duration
        if max_current is None:
            # The simplified STT coefficient P*J/(Ms*V) is astronomically
            # stiff at env-scale currents (the gradient is NaN there, in the
            # JAX package too); gradient-based control needs the smooth
            # regime: the current whose torque rate matches the anisotropy
            # precession rate gamma*H_k.
            from ..constants import GAMMA, MU0

            ms = _scalar(params.saturation_magnetization)
            ku = _scalar(params.uniaxial_anisotropy)
            vol = _scalar(params.volume)
            pol = _scalar(params.polarization)
            h_k = 2.0 * ku / (MU0 * ms)
            max_current = 2.0 * GAMMA * h_k * ms * vol / max(pol, 1e-3)
        self.max_current = max_current
        self.energy_weight = energy_weight
        self.resistance = resistance
        self.area = area
        self.config = IntegratorConfig(method=method, max_substeps=max_substeps)

    def _propagate(self, currents: Tensor, m0) -> Tuple[Tensor, Tensor, Tensor]:
        """Run protocols: currents (R, n_segments), m0 (3,) -> the final
        components, each (R,), differentiable in ``currents``."""
        R = currents.shape[0]
        m0 = np.asarray(m0, np.float32)
        m = tuple(torch.full((R,), float(c), device=self.device) for c in m0)
        span = torch.full((R,), self.segment_duration, device=self.device)
        for s in range(currents.shape[1]):
            m = integrate_pulse_plain(m, span, currents[:, s], self.params, self.config).m
        return m

    def loss(self, currents: Tensor, m0, target) -> Tensor:
        """Miss distance + NORMALIZED drive energy, per protocol: currents
        (n_segments,) gives a scalar, (R, n_segments) an (R,) tensor.

        The energy term uses sum((J/J_max)^2)/n_segments so its gradient is
        meaningful at any current scale: switching success is nearly binary
        in this bistable physics, and the continuous signal GRAPE descends
        is "keep the switch, shrink the drive"."""
        single = currents.dim() == 1
        currents = currents.reshape(-1, currents.shape[-1])
        tgt = np.asarray(target, np.float32)
        m = self._propagate(currents, m0)
        align = m[0] * float(tgt[0]) + m[1] * float(tgt[1]) + m[2] * float(tgt[2])
        energy_norm = torch.mean((currents / self.max_current) ** 2, dim=-1)
        out = (1.0 - align) + self.energy_weight * energy_norm
        return out[0] if single else out

    def pulse_energy_joules(self, currents: np.ndarray) -> float:
        """Physical dissipation E = sum J^2 A^2 R dt (the env's formula)."""
        return float(
            np.sum(np.asarray(currents) ** 2) * self.area**2 * self.resistance
            * self.segment_duration
        )

    def optimize(
        self,
        m_initial: Sequence[float] = (0.1, 0.0, 0.995),
        target: Sequence[float] = (0.0, 0.0, -1.0),
        n_restarts: int = 32,
        iterations: int = 150,
        learning_rate: float = 0.1,
        seed: int = 0,
    ) -> Dict[str, Any]:
        """Adam on theta, currents = max_current * tanh(theta) (bounded),
        from 0.5 * N(0, 1) draws of a generator seeded with ``seed``. Each
        iteration is one forward and one backward of every restart; the
        loss history (the best restart's loss after each update) reads the
        next iteration's forward, so no extra pass is run for it."""
        m0, tgt = _unit(m_initial), _unit(target)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        theta = 0.5 * torch.randn((n_restarts, self.n_segments), generator=generator,
                                  dtype=torch.float64, device=self.device)

        def restart_loss(th):
            return self.loss(self.max_current * torch.tanh(th), m0, tgt)

        m = torch.zeros_like(theta)
        v = torch.zeros_like(theta)
        history = []
        for t in range(iterations):
            theta.requires_grad_(True)
            losses = restart_loss(theta)
            (g,) = torch.autograd.grad(losses.sum(), theta)
            if t:
                history.append(losses.detach().min())
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1 - 0.9 ** (t + 1))
            vh = v / (1 - 0.999 ** (t + 1))
            theta = (theta - learning_rate * mh / (torch.sqrt(vh) + 1e-8)).detach()
        with torch.no_grad():
            losses = restart_loss(theta)
            history.append(losses.min())
            best = int(torch.argmin(losses))
            currents = self.max_current * torch.tanh(theta[best])
            m_final = torch.stack(self._propagate(currents[None], m0)).reshape(3)
        currents, m_final = currents.cpu().numpy(), m_final.cpu().numpy()
        return {
            "currents": currents,
            "segment_duration": self.segment_duration,
            "total_duration": self.segment_duration * self.n_segments,
            "final_m": m_final,
            "alignment": float(m_final @ tgt),
            "loss": float(losses[best]),
            "loss_history": torch.stack(history).cpu().numpy(),
            "energy_J": self.pulse_energy_joules(currents),
            "energy_norm": float(np.mean((currents / self.max_current) ** 2)),
            "n_evaluations": int(n_restarts * iterations),
            "method": "grape_adam",
        }


class PhysicsInformedRL:
    """Physics-informed reward shaping for the PPO trainer: the shaping
    potential is the normalized single-domain energy (the landscape the
    integrator uses) plus the alignment with the target, turned into the
    potential-based term F = gamma*phi(s') - phi(s), which preserves the
    optimal policy."""

    def __init__(self, params: LLGSParams, gamma: float = 0.99, weight: float = 0.5):
        self.params = params
        self.gamma = gamma
        self.weight = weight
        self._energy = energy_density

    def potential(self, m: Tensor, target: Tensor) -> Tensor:
        """Alignment with the target minus the weighted normalized energy."""
        align = torch.sum(m * target, dim=-1)
        e = self._energy(m[..., 0], m[..., 1], m[..., 2], self.params)
        e_scale = torch.clamp_min(torch.abs(e).max(), 1e-30)
        return align - self.weight * e / e_scale

    def shaping(self, m, m_next, target) -> Tensor:
        return self.gamma * self.potential(m_next, target) - self.potential(m, target)

    def reward_components(self) -> Dict[str, Dict[str, Any]]:
        """Composite-reward config with the shaping term added."""
        shaper = self

        def shaping_fn(obs, action, next_obs, info):
            return shaper.shaping(info["m_prev"], info["m"], info["target"])

        return {
            "success": {"weight": 10.0, "function": "success"},
            "energy": {"weight": -0.1, "function": "energy"},
            "physics_shaping": {"weight": 1.0, "function": shaping_fn},
        }


class ComparativeAnalysis:
    """Run several controllers on the same switching tasks and compare.

    Controllers are callables ``(task) -> {'alignment', 'energy_J', ...}``;
    tasks are (m_initial, target) tuples. Statistics use Welch tests and
    bootstrap CIs from ``research.benchmarking``."""

    def __init__(self, params: LLGSParams, seed: int = 0):
        self.params = params
        self.seed = seed
        self.controllers: Dict[str, Callable] = {}

    def register(self, name: str, controller: Callable) -> None:
        self.controllers[name] = controller

    def register_default_controllers(self) -> None:
        params = self.params

        def optimal_control(task):
            m0, tgt = task
            oc = OptimalControlBaseline(params, n_segments=3)
            out = oc.optimize(m0, tgt, n_restarts=16, iterations=60)
            return {"alignment": out["alignment"], "energy_J": out["energy_J"]}

        def single_pulse_grid(task):
            from .optimizers import grid_search, switching_objective

            m0, tgt = task
            j_max = OptimalControlBaseline(params, n_segments=1).max_current
            obj = switching_objective(params, m_initial=m0, target=tgt, energy_weight=0.0)
            res = grid_search(
                obj, {"current": (-j_max, j_max), "duration": (1e-11, 2e-9)},
                points_per_dim=24, device=params.saturation_magnetization.device,
            )
            return {
                "alignment": 1.0 - res.best_value,  # energy_weight=0 -> miss
                "energy_J": res.best_params["current"] ** 2 * (5e-15) ** 2
                * 1e3 * res.best_params["duration"],
            }

        def do_nothing(task):
            m0, tgt = task
            align = float(np.dot(np.asarray(m0) / np.linalg.norm(m0),
                                 np.asarray(tgt) / np.linalg.norm(tgt)))
            return {"alignment": align, "energy_J": 0.0}

        self.register("optimal_control", optimal_control)
        self.register("single_pulse_grid", single_pulse_grid)
        self.register("do_nothing", do_nothing)

    def default_tasks(self, n_tasks: int = 5) -> List[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        tasks = []
        for _ in range(n_tasks):
            m0 = np.array([0.0, 0.0, 1.0]) + 0.2 * rng.normal(size=3)
            m0 /= np.linalg.norm(m0)
            tasks.append((m0.astype(np.float32), np.array([0.0, 0.0, -1.0], np.float32)))
        return tasks

    def run(self, tasks: Optional[List] = None) -> Dict[str, Any]:
        if not self.controllers:
            self.register_default_controllers()
        tasks = tasks if tasks is not None else self.default_tasks()
        per_method: Dict[str, Dict[str, List[float]]] = {}
        for name, controller in self.controllers.items():
            rows = [controller(t) for t in tasks]
            per_method[name] = {k: [float(r[k]) for r in rows] for k in rows[0]}

        report: Dict[str, Any] = {"methods": {}, "comparisons": {}}
        for name, metrics in per_method.items():
            aligns = np.asarray(metrics["alignment"])
            report["methods"][name] = {
                "mean_alignment": float(aligns.mean()),
                "alignment_ci95": bootstrap_ci(aligns) if aligns.size > 1 else
                (float(aligns[0]), float(aligns[0])),
                "mean_energy_J": float(np.mean(metrics["energy_J"])),
                "success_rate": float(np.mean(aligns > 0.9)),
            }
        names = list(per_method)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                xa = np.asarray(per_method[a]["alignment"])
                xb = np.asarray(per_method[b]["alignment"])
                if xa.size > 1 and xb.size > 1 and (xa.std() + xb.std()) > 0:
                    report["comparisons"][f"{a}_vs_{b}"] = significance_test(xa, xb)
        return report


def run_comprehensive_benchmark(
    params: Optional[LLGSParams] = None,
    n_tasks: int = 5,
    seed: int = 0,
    device=None,
) -> Dict[str, Any]:
    """One-call comparative benchmark across all default controllers, on
    the device of ``params`` (the default device's, on ``device``: the
    card unless the caller asks for "cpu")."""
    if params is None:
        from ..physics.solver import params_from_dict

        params = params_from_dict(
            dict(volume=1e-24, saturation_magnetization=800e3, damping=0.01,
                 uniaxial_anisotropy=8e5, polarization=0.7,
                 easy_axis=np.array([0.0, 0.0, 1.0])),
            device=device,
        )
    analysis = ComparativeAnalysis(params, seed=seed)
    analysis.register_default_controllers()
    report = analysis.run(analysis.default_tasks(n_tasks))
    report["config"] = {"n_tasks": n_tasks, "seed": seed}
    return report
