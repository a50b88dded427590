"""QAOA-style and ML-surrogate device-parameter optimizers.

PyTorch counterpart of ``spintorque_tpu/quantum/optimization.py``.
``IterationFreeQAOA`` evaluates the whole (gamma, beta) angle grid as ONE
batch of state vectors (grid^2 circuit executions, the batch dimension the
JAX package's vmap), and the returned angles are exact-expectation optima,
not samples.

``QuantumMLDeviceOptimizer``: an MLP surrogate fitted by full-batch Adam
(autograd, an eager loop where the JAX package scans) on one batched call
of the real objective, refined by gradient descent THROUGH the surrogate
from many starts at once (the gradient of the summed surrogate over the
starts: its rows do not interact), re-ranked with the real objective. On
the card, a physics objective such as ``research.switching_objective`` is
one pulse-kernel launch per call.

Both run on ``device`` (the card unless the caller asks for "cpu") in
float32; random draws come from a ``torch.Generator`` there seeded with
``seed``: seeded results agree with the JAX package's in outcome, not draw
for draw. The Adam loops keep the JAX package's update formula op by op.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from ..research.optimizers import OptimizationResult
from . import statevector as sv

Tensor = torch.Tensor

__all__ = ["IterationFreeQAOA", "QuantumMLDeviceOptimizer", "OptimizationResult"]


def _bits(n: int, device) -> Tensor:
    """(2^n, n) float32: row k holds the bits of k, wire 0 first."""
    idx = torch.arange(2**n, device=device)
    return ((idx[:, None] >> torch.arange(n, device=device)[None, :]) & 1).to(torch.float32)


class IterationFreeQAOA:
    """Depth-p QAOA for QUBO problems with grid-batch angle selection.

    minimize  x^T Q x  over x in {0,1}^n

    The cost Hamiltonian is diagonal, so cost expectations come from the
    probability vector directly; the mixer is a product of RX gates. All
    ``grid_points**2`` angle settings evaluate in one batch.
    """

    def __init__(self, n_layers: int = 1, grid_points: int = 24, max_qubits: int = 14,
                 device=None):
        if n_layers < 1:
            raise ValueError("n_layers >= 1")
        self.n_layers = n_layers
        self.grid_points = grid_points
        self.max_qubits = max_qubits
        self.device = resolve_device(device, None)

    # -- problem encoding ---------------------------------------------------
    @staticmethod
    def qubo_cost_vector(Q, device=None) -> Tensor:
        """Cost of every bitstring: c[k] = x_k^T Q x_k, computed as one
        (2^n, n) @ (n, n) @ (n, 2^n) contraction on ``device`` (the card
        unless the caller asks for "cpu")."""
        device = resolve_device(device, None)
        Q = torch.as_tensor(np.asarray(Q), dtype=torch.float32, device=device)
        bits = _bits(Q.shape[0], device)
        return torch.einsum("ki,ij,kj->k", bits, Q, bits)

    def _evolve(self, angles: Tensor, cost: Tensor, n: int) -> Tensor:
        """|gamma,beta> for a (..., 2p) batch of angle settings [gammas,
        betas]: a (..., 2, 2^n) batch of states.

        Real-pair state: the diagonal phase e^{-i gamma c} is a 2x2 real
        rotation of the (Re, Im) planes, elementwise."""
        amp = 1.0 / math.sqrt(2.0**n)
        lead = angles.shape[:-1]
        re = torch.full(lead + (2**n,), amp, dtype=torch.float32, device=cost.device)
        im = torch.zeros_like(re)
        gammas, betas = angles[..., : self.n_layers], angles[..., self.n_layers:]
        for layer in range(self.n_layers):
            # cost layer: (re + i im) * (cos phi - i sin phi), phi = gamma*c
            phi = gammas[..., layer, None] * cost
            c, s = torch.cos(phi), torch.sin(phi)
            re, im = re * c + im * s, im * c - re * s
            # mixer: RX(2 beta) on every wire, one gate per state
            state = torch.stack([re, im], -2)
            gate = sv.rx(2.0 * betas[..., layer])
            for w in range(n):
                state = sv.apply_gate(state, gate, (w,))
            re, im = state[..., 0, :], state[..., 1, :]
        return torch.stack([re, im], -2)

    def angle_grid(self, seed: int = 0) -> Tensor:
        """The (grid^2, 2p) angle settings ``optimize`` evaluates: the full
        (gamma, beta) grid for p = 1; for p > 1 (grid^2p explodes) as many
        uniform draws from a generator seeded with ``seed``."""
        p = self.n_layers
        if p == 1:
            g = torch.linspace(0.0, math.pi, self.grid_points, device=self.device)
            b = torch.linspace(0.0, math.pi / 2, self.grid_points, device=self.device)
            gg, bb = torch.meshgrid(g, b, indexing="ij")
            return torch.stack([gg.reshape(-1), bb.reshape(-1)], dim=-1)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        hi = torch.tensor([math.pi] * p + [math.pi / 2] * p, device=self.device)
        u = torch.rand((self.grid_points**2, 2 * p), generator=generator, device=self.device)
        return u * hi

    def grid_values(self, cost: Tensor, angle_batch: Tensor) -> Tensor:
        """The cost expectation of every angle setting, in one batch."""
        n = int(round(math.log2(cost.shape[-1])))
        psi = self._evolve(angle_batch, cost, n)
        return (sv.probabilities(psi) * cost).sum(-1)

    def optimize(self, Q, seed: int = 0) -> OptimizationResult:
        Q = np.asarray(Q, np.float64)
        n = Q.shape[0]
        if n > self.max_qubits:
            raise ValueError(
                f"{n} variables > max_qubits={self.max_qubits} for exact simulation"
            )
        cost = self.qubo_cost_vector(Q, self.device)
        p = self.n_layers
        angle_batch = self.angle_grid(seed)
        values = self.grid_values(cost, angle_batch)
        best_idx = int(torch.argmin(values))
        best_angles = angle_batch[best_idx]

        # most-likely bitstring under the best angles = solution readout
        psi = self._evolve(best_angles, cost, n)
        best_bit = int(torch.argmax(sv.probabilities(psi)))
        x = np.array([(best_bit >> i) & 1 for i in range(n)], np.float64)
        angles = best_angles.tolist()

        return OptimizationResult(
            best_params={
                **{f"x{i}": float(x[i]) for i in range(n)},
                **{f"gamma{l}": angles[l] for l in range(p)},
                **{f"beta{l}": angles[p + l] for l in range(p)},
            },
            best_value=float(x @ Q @ x),
            history=np.asarray([float(values[best_idx])]),
            n_evaluations=int(values.shape[0]),
            method=f"iteration_free_qaoa_p{p}",
        )

    def approximation_ratio(self, Q, result: OptimizationResult) -> float:
        """Achieved cost / exact optimum (1.0 = optimal; guards zero optimum)."""
        exact = float(self.qubo_cost_vector(np.asarray(Q), self.device).min())
        achieved = result.best_value
        if abs(exact) < 1e-12:
            return 1.0 if abs(achieved) < 1e-12 else 0.0
        return achieved / exact


def _mlp_init(generator: torch.Generator, sizes: Sequence[int], device) -> List[Tuple[Tensor, Tensor]]:
    params = []
    for kin, kout in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((kin, kout), generator=generator, device=device) * math.sqrt(2.0 / kin)
        params.append((w, torch.zeros((kout,), device=device)))
    return params


def _mlp_apply(params, x: Tensor) -> Tensor:
    for w, b in params[:-1]:
        x = torch.tanh(x @ w + b)
    w, b = params[-1]
    return (x @ w + b)[..., 0]


def _adam(flat: List[Tensor], grads, m, v, t: int, lr: float):
    """One Adam update of the JAX package's loops, op by op: returns the new
    (params, m, v); ``t`` counts from 0."""
    out, new_m, new_v = [], [], []
    for f, g, mi, vi in zip(flat, grads, m, v):
        mi = 0.9 * mi + 0.1 * g
        vi = 0.999 * vi + 0.001 * g * g
        mhat = mi / (1 - 0.9 ** (t + 1.0))
        vhat = vi / (1 - 0.999 ** (t + 1.0))
        out.append((f - lr * mhat / (torch.sqrt(vhat) + 1e-8)).detach())
        new_m.append(mi)
        new_v.append(vi)
    return out, new_m, new_v


def adam_descent(loss_fn: Callable[[List[Tensor]], Tensor], flat: List[Tensor], steps: int,
                 lr: float) -> Tuple[List[Tensor], Tensor]:
    """``steps`` full-batch Adam updates of the tensors ``flat`` under
    ``loss_fn`` (the JAX package's scanned loops): returns the final tensors
    and the loss after each update. The loss after update t is the forward
    of update t + 1, so one forward a step (and one more at the end)."""
    if not steps:
        return flat, torch.zeros(0)
    m = [torch.zeros_like(f) for f in flat]
    v = [torch.zeros_like(f) for f in flat]
    history = []
    for t in range(steps):
        flat = [f.detach().requires_grad_(True) for f in flat]
        loss = loss_fn(flat)
        if t:
            history.append(loss.detach())
        grads = torch.autograd.grad(loss, flat)
        flat, m, v = _adam(flat, grads, m, v, t, lr)
    with torch.no_grad():
        history.append(loss_fn(flat))
    return flat, torch.stack(history)


class QuantumMLDeviceOptimizer:
    """Surrogate-model device-parameter optimizer.

    1. Sample ``n_train`` parameter vectors; evaluate the TRUE objective in
       one batched call.
    2. Fit an MLP surrogate by full-batch Adam.
    3. Descend THROUGH the surrogate from many random starts at once.
    4. Re-rank candidate minima with the true objective; return the best.
    """

    def __init__(
        self,
        hidden_sizes: Sequence[int] = (64, 64),
        n_train: int = 2048,
        train_steps: int = 500,
        refine_starts: int = 256,
        refine_steps: int = 100,
        learning_rate: float = 1e-2,
        device=None,
    ):
        self.hidden_sizes = tuple(hidden_sizes)
        self.n_train = n_train
        self.train_steps = train_steps
        self.refine_starts = refine_starts
        self.refine_steps = refine_steps
        self.learning_rate = learning_rate
        self.device = resolve_device(device, None)

    def optimize(
        self,
        objective: Callable[[Dict[str, Tensor]], Tensor],
        space: Dict[str, Tuple[float, float]],
        seed: int = 0,
    ) -> OptimizationResult:
        device = self.device
        names = list(space)
        lo = torch.tensor([space[n][0] for n in names], dtype=torch.float32, device=device)
        hi = torch.tensor([space[n][1] for n in names], dtype=torch.float32, device=device)
        dim = len(names)
        generator = torch.Generator(device=device).manual_seed(seed)

        def to_dict(x01):  # (B, dim) in [0,1] -> parameter dict
            x = lo + (hi - lo) * x01
            return {n: x[:, i] for i, n in enumerate(names)}

        # 1. training data from the real physics, one batched call
        x_train = torch.rand((self.n_train, dim), generator=generator, device=device)
        y_train = torch.as_tensor(objective(to_dict(x_train)), device=device).to(torch.float32)
        y_mean, y_std = y_train.mean(), y_train.std(correction=0) + 1e-8
        y_norm = (y_train - y_mean) / y_std

        # 2. surrogate fit
        layers = _mlp_init(generator, (dim, *self.hidden_sizes, 1), device)

        def loss_fn(flat):
            pred = _mlp_apply(list(zip(flat[0::2], flat[1::2])), x_train)
            return torch.mean((pred - y_norm) ** 2)

        flat, losses = adam_descent(loss_fn, [t for wb in layers for t in wb],
                                    self.train_steps, self.learning_rate)
        params = list(zip(flat[0::2], flat[1::2]))

        # 3. multi-start descent through the surrogate: the gradient of the
        # sum over starts is each start's own gradient
        x = torch.rand((self.refine_starts, dim), generator=generator, device=device)
        for _ in range(self.refine_steps):
            x.requires_grad_(True)
            (g,) = torch.autograd.grad(_mlp_apply(params, x).sum(), x)
            x = torch.clamp(x.detach() - 0.05 * g, 0.0, 1.0)

        # 4. re-rank with the REAL objective
        candidates = torch.cat([x, x_train[torch.argsort(y_train)[:32]]])
        true_vals = torch.as_tensor(objective(to_dict(candidates)), device=device)
        best = int(torch.argmin(true_vals))
        x_best = (lo + (hi - lo) * candidates[best]).tolist()

        return OptimizationResult(
            best_params={n: x_best[i] for i, n in enumerate(names)},
            best_value=float(true_vals[best]),
            history=losses.cpu().numpy(),
            n_evaluations=int(self.n_train + candidates.shape[0]),
            method="quantum_ml_surrogate",
        )
