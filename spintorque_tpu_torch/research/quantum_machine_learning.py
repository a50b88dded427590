"""Variational quantum machine learning on the batched state-vector core.

PyTorch counterpart of ``spintorque_tpu/research/quantum_machine_learning.py``.
Every model is a differentiable torch program over real-pair states
(``quantum/statevector.py``), the samples of a batch one batch of states:
QNN training is full-batch Adam with exact autograd gradients, and the
quantum RL policy trains with REINFORCE over exact expectation values. The
Adam loops are eager loops under autograd where the JAX package scans, with
its update formula op by op.

``QuantumNeuralNetwork`` is an ``nn.Module`` holding its (n_blocks,
n_qubits, 2) rotation angles as a parameter; ``QuantumReinforcementLearning``
holds the same angles as a plain ``params`` tensor (a plain class: its
JAX-named ``train`` is the REINFORCE loop, which an ``nn.Module``'s
``train(mode)`` would collide with). The angles are drawn from a
``torch.Generator`` seeded with ``seed`` on ``device`` (the card unless the
caller asks for "cpu"): another stream than the JAX package's
``jax.random``, so seeded results agree with it in outcome, not draw for
draw (``convert.variational_params_from_numpy`` carries the JAX parameters
across for comparisons). ``QuantumSpinOptimizer`` holds no parameters of
its own: it minimizes an Ising cost with the VQE.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import resolve_device
from ..quantum import statevector as sv
from ..quantum.energy_landscape import SymmetryEnhancedVQE
from ..quantum.optimization import _adam, adam_descent

Tensor = torch.Tensor

__all__ = [
    "QuantumSpinOptimizer",
    "QuantumNeuralNetwork",
    "QuantumReinforcementLearning",
]


class QuantumSpinOptimizer:
    """Spin-configuration optimizer: Ising energies via VQE.

    Maps an Ising problem (couplings J_ij, fields h_i over classical spins
    s in {-1, +1}) to a diagonal Hamiltonian and minimizes it with the
    symmetry-enhanced VQE. Exact cost enumeration is one (2^n, n) @ (n, n)
    batched contraction, for n <= 14.
    """

    def __init__(self, n_layers: int = 3, iterations: int = 300, seed: int = 0, device=None):
        self.n_layers = n_layers
        self.iterations = iterations
        self.seed = seed
        self.device = resolve_device(device, None)

    @staticmethod
    def ising_cost_vector(J, h=None, device=None) -> Tensor:
        """The Ising energy of every spin configuration, on ``device`` (the
        card unless the caller asks for "cpu")."""
        device = resolve_device(device, None)
        J = torch.as_tensor(np.triu(np.asarray(J), 1), dtype=torch.float32, device=device)
        n = J.shape[0]
        h = (torch.zeros((n,), device=device) if h is None
             else torch.as_tensor(np.asarray(h), dtype=torch.float32, device=device))
        idx = torch.arange(2**n, device=device)
        bits = (idx[:, None] >> torch.arange(n, device=device)[None, :]) & 1
        spins = 1.0 - 2.0 * bits.to(torch.float32)
        return torch.einsum("ki,ij,kj->k", spins, J, spins) + spins @ h

    def optimize(self, J, h=None) -> Dict[str, Any]:
        cost = self.ising_cost_vector(J, h, self.device)
        n = int(np.log2(cost.shape[0]))
        vqe = SymmetryEnhancedVQE(
            n, n_layers=self.n_layers, iterations=self.iterations, seed=self.seed,
            device=self.device,
        )
        res = vqe.minimize_diagonal(cost)
        idx = res["ground_state_index"]
        res["spins"] = np.asarray([1 - 2 * ((idx >> i) & 1) for i in range(n)])
        res["spin_energy"] = float(cost[idx])
        return res


def _reupload_circuit(x: Tensor, params: Tensor, n_qubits: int) -> Tensor:
    """Data-reuploading VQC: alternating feature encodings and trainable
    rotations with chain entanglement; params (n_blocks, n_qubits, 2).
    ``x`` is one (F,) sample or a (..., F) batch: a (..., 2, 2**n) batch of
    states, one a sample."""
    state = sv.zero_state(n_qubits, device=params.device)
    cz = sv._fixed_pair("CZ", params.device)
    for b in range(params.shape[0]):
        for w in range(n_qubits):
            # encode feature w (cycled) then trainable RY/RZ
            state = sv.apply_gate(state, sv.ry(x[..., w % x.shape[-1]]), (w,))
            state = sv.apply_gate(state, sv.ry(params[b, w, 0]), (w,))
            state = sv.apply_gate(state, sv.rz(params[b, w, 1]), (w,))
        for w in range(n_qubits - 1):
            state = sv.apply_gate(state, cz, (w, w + 1))
    return state


def _angles(generator: torch.Generator, shape, device) -> Tensor:
    return 0.1 * torch.randn(shape, generator=generator, device=device)


class QuantumNeuralNetwork(nn.Module):
    """Data-reuploading variational quantum classifier/regressor.

    Output is <Z_0> of the final state in [-1, 1]. Training: full-batch Adam
    with exact autograd gradients; the samples are one batch of states, so
    a training step is one forward and one backward over all of them.
    """

    def __init__(
        self,
        n_qubits: int = 4,
        n_blocks: int = 3,
        learning_rate: float = 0.05,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        self.n_qubits = n_qubits
        self.n_blocks = n_blocks
        self.learning_rate = learning_rate
        self.device = resolve_device(device, None)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = nn.Parameter(_angles(generator, (n_blocks, n_qubits, 2), self.device))

    def forward(self, params: Tensor, x: Tensor) -> Tensor:
        """<Z_0> for one (F,) sample or a (B, F) batch of them."""
        state = _reupload_circuit(x, params, self.n_qubits)
        return sv.expectation_z(state, 0)

    def _samples(self, X) -> Tensor:
        return torch.as_tensor(X, device=self.device).to(torch.float32)

    def predict(self, X) -> Tensor:
        with torch.no_grad():
            return self.forward(self.params, self._samples(X))

    def fit(self, X, y, epochs: int = 100) -> Dict[str, Any]:
        X, y = self._samples(X), self._samples(y)

        def loss_fn(flat):
            return torch.mean((self.forward(flat[0], X) - y) ** 2)

        (params,), history = adam_descent(loss_fn, [self.params.detach()], epochs,
                                          self.learning_rate)
        with torch.no_grad():
            self.params.copy_(params)
        return {
            "loss_history": history.cpu().numpy(),
            "final_loss": float(history[-1]),
            "n_parameters": int(self.params.numel()),
        }

    def accuracy(self, X, y) -> float:
        """Binary accuracy with sign(output) labels in {-1, +1}."""
        preds = np.sign(self.predict(X).cpu().numpy())
        return float(np.mean(preds == np.sign(np.asarray(y))))


class QuantumReinforcementLearning:
    """VQC softmax policy trained with REINFORCE on a bandit-style
    switching task.

    The task: choose one of ``n_actions`` pulse settings given a (small)
    observation; reward from a user-supplied function (e.g. switching
    success from the physics engine). Policy logits are per-action Pauli-Z
    expectations of a reuploading circuit; gradients are exact.
    """

    def __init__(
        self,
        n_obs_features: int,
        n_actions: int,
        n_qubits: Optional[int] = None,
        n_blocks: int = 2,
        learning_rate: float = 0.1,
        seed: int = 0,
        device=None,
    ):
        self.n_actions = n_actions
        self.n_qubits = n_qubits or max(n_actions.bit_length(), n_obs_features, 2)
        if self.n_qubits < n_actions.bit_length():
            raise ValueError("need >= log2(n_actions) qubits")
        self.n_blocks = n_blocks
        self.learning_rate = learning_rate
        self.device = resolve_device(device, None)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = _angles(generator, (n_blocks, self.n_qubits, 2), self.device)

    def logits(self, params: Tensor, obs: Tensor) -> Tensor:
        """(..., n_actions) logits of one (F,) observation or a batch."""
        state = _reupload_circuit(obs, params, self.n_qubits)
        zs = torch.stack(
            [sv.expectation_z(state, w % self.n_qubits) for w in range(self.n_actions)], -1
        )
        return 3.0 * zs  # scale expectations into a usable logit range

    def act(self, obs, generator: torch.Generator) -> int:
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            p = torch.softmax(self.logits(self.params, obs), -1)
        return int(torch.multinomial(p, 1, generator=generator))

    def train(
        self,
        sample_obs: Callable[[torch.Generator, int], Tensor],
        reward_fn: Callable[[np.ndarray, int], float],
        episodes: int = 200,
        batch: int = 32,
        seed: int = 0,
    ):
        """REINFORCE with a mean baseline: each episode draws ``batch``
        observations with ``sample_obs(generator, batch)`` (a (batch, F)
        tensor; the JAX package maps its ``sample_obs(key)`` over split
        keys), every action in one batched draw from the policy, and the
        rewards ``reward_fn(obs, action)`` on the host, then takes one Adam
        step."""
        lr = self.learning_rate
        generator = torch.Generator(device=self.device).manual_seed(seed)
        rewards_hist: List[float] = []
        params = self.params.detach()
        m = torch.zeros_like(params)
        v = torch.zeros_like(params)
        rows = torch.arange(batch, device=self.device)

        for ep in range(episodes):
            obs_b = torch.as_tensor(sample_obs(generator, batch), device=self.device).to(
                torch.float32)
            with torch.no_grad():
                p_b = torch.softmax(self.logits(params, obs_b), -1)
            act_b = torch.multinomial(p_b, 1, generator=generator)[:, 0]
            obs_host, act_host = obs_b.cpu().numpy(), act_b.tolist()
            rew_b = torch.tensor([reward_fn(o, a) for o, a in zip(obs_host, act_host)],
                                 dtype=torch.float32, device=self.device)
            adv_b = rew_b - rew_b.mean()
            params.requires_grad_(True)
            logp = torch.log_softmax(self.logits(params, obs_b), -1)[rows, act_b]
            (g,) = torch.autograd.grad(-torch.mean(logp * adv_b), params)
            (params,), (m,), (v,) = _adam([params], [g], [m], [v], ep, lr)
            rewards_hist.append(float(rew_b.mean()))

        self.params = params.detach()
        return {
            "reward_history": np.asarray(rewards_hist),
            "final_mean_reward": float(np.mean(rewards_hist[-10:])),
            "episodes": episodes,
        }
