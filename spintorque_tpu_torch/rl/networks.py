"""Policy/value networks for the PPO trainer.

PyTorch counterpart of ``spintorque_tpu/rl/networks.py``. The MLPs are plain
matrix products (``torch.nn.functional.linear``), as the JAX package leaves
its flax ``nn.Dense`` layers to XLA. Layer names follow the flax module's
parameter tree (``actor_dense_0`` ... ``critic_value``, ``log_std``), so
``convert.actor_critic_params_from_numpy`` carries its parameters across.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    # flax's nn.gelu defaults to the tanh approximation.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


class ActorCritic(nn.Module):
    """MLP actor-critic.

    Continuous mode: ``forward`` returns (mean, log_std, value), the
    parameters of a tanh-squashed Gaussian in [-1, 1]^action_dim plus the
    value estimate. Discrete mode: (logits, value).

    ``compute_dtype`` is the layers' compute dtype. None keeps the input's
    dtype (the parameters must share it). 'float32' or 'bfloat16' casts the
    input, weights and bias of every layer to it, and the heads' outputs
    back to float32, so probabilities and losses stay in full precision;
    parameters and the optimizer stay float32. ``shared_trunk`` feeds both
    heads from one trunk instead of separate actor and critic MLPs.
    ``generator`` draws the initial weights (orthogonal, gain sqrt(2) in the
    trunk, 0.01 in the actor head, 1 in the value head; zero biases).
    """

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        discrete: bool = False,
        hidden_sizes: Sequence[int] = (256, 256),
        activation: str = "tanh",
        compute_dtype: Optional[str] = None,
        shared_trunk: bool = False,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"Unknown activation: {activation}")
        self.discrete = discrete
        self.activation = activation
        self.compute_dtype = None if compute_dtype is None else getattr(torch, compute_dtype)
        self.shared_trunk = shared_trunk

        def linear(n_in, n_out):
            return nn.Linear(n_in, n_out, device=device, dtype=torch.float32)

        def trunk():
            sizes = (obs_dim, *hidden_sizes)
            return nn.ModuleList(linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))

        names = ("shared",) if shared_trunk else ("actor", "critic")
        self.trunks = nn.ModuleDict({name: trunk() for name in names})
        width = hidden_sizes[-1] if hidden_sizes else obs_dim
        if discrete:
            self.actor_logits = linear(width, action_dim)
        else:
            self.actor_mean = linear(width, action_dim)
            self.log_std = nn.Parameter(torch.zeros(action_dim, device=device, dtype=torch.float32))
        self.critic_value = linear(width, 1)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Orthogonal weights and zero biases (the flax module's init)."""
        with torch.no_grad():
            for trunk in self.trunks.values():
                for layer in trunk:
                    _init(layer, math.sqrt(2.0), generator)
            _init(self.actor_logits if self.discrete else self.actor_mean, 0.01, generator)
            _init(self.critic_value, 1.0, generator)
            if not self.discrete:
                self.log_std.zero_()

    def _dense(self, layer: nn.Linear, x: Tensor) -> Tensor:
        w, b = layer.weight, layer.bias
        if self.compute_dtype is not None:
            x, w, b = x.to(self.compute_dtype), w.to(self.compute_dtype), b.to(self.compute_dtype)
        return F.linear(x, w, b)

    def _out(self, x: Tensor) -> Tensor:
        return x if self.compute_dtype is None else x.to(torch.float32)

    def _trunk(self, name: str, obs: Tensor) -> Tensor:
        act = _ACTIVATIONS[self.activation]
        x = obs
        for layer in self.trunks[name]:
            x = act(self._dense(layer, x))
        return x

    def forward(self, obs: Tensor) -> Tuple[Tensor, ...]:
        if self.shared_trunk:
            pi = v = self._trunk("shared", obs)
        else:
            pi = self._trunk("actor", obs)
            v = self._trunk("critic", obs)
        if self.discrete:
            head: Tuple[Tensor, ...] = (self._out(self._dense(self.actor_logits, pi)),)
        else:
            head = (self._out(self._dense(self.actor_mean, pi)), self.log_std)
        value = self._dense(self.critic_value, v)
        return head + (self._out(value.squeeze(-1)),)


def _init(layer: nn.Linear, gain: float, generator: Optional[torch.Generator]) -> None:
    nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
    nn.init.zeros_(layer.bias)


def continuous_action_transform(raw: Tensor, max_current: float, max_duration: float) -> Tensor:
    """Map tanh-squashed [-1, 1]^2 network output to the env's action space
    [(-J_max, J_max), (1e-12, dur_max)]."""
    current = raw[..., 0] * max_current
    duration = (raw[..., 1] + 1.0) * 0.5 * (max_duration - 1e-12) + 1e-12
    return torch.stack([current, duration], dim=-1)


_LOG_2PI = math.log(2 * math.pi)


def gaussian_log_prob(mean: Tensor, log_std: Tensor, raw_action: Tensor) -> Tensor:
    """Diagonal Gaussian log-prob with the tanh correction."""
    std = torch.exp(log_std)
    pre_tanh = torch.atanh(torch.clamp(raw_action, -1 + 1e-6, 1 - 1e-6))
    logp = -0.5 * (((pre_tanh - mean) / std) ** 2 + 2 * log_std + _LOG_2PI)
    logp = logp.sum(-1)
    # tanh change of variables
    return logp - torch.log(1 - raw_action**2 + 1e-6).sum(-1)


def gaussian_entropy(log_std: Tensor, shape) -> Tensor:
    """Entropy of the (pre-tanh) diagonal Gaussian, broadcast to ``shape``."""
    entropy = (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)
    return torch.broadcast_to(entropy, shape)


def sample_continuous(generator: torch.Generator, mean: Tensor, log_std: Tensor):
    """(raw action in [-1, 1], its log-prob); ``generator`` lives on
    ``mean``'s device, so sampling reads nothing back."""
    std = torch.exp(log_std)
    noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
    raw = torch.tanh(mean + std * noise)
    return raw, gaussian_log_prob(mean, log_std, raw)


def sample_discrete(generator: torch.Generator, logits: Tensor) -> Tensor:
    """Categorical draw by the Gumbel-max trick, as ``jax.random.categorical``
    draws it: elementwise ops and an argmax, no host read."""
    tiny = torch.finfo(logits.dtype).tiny
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype, device=logits.device)
    gumbel = -torch.log(-torch.log(tiny + (1.0 - tiny) * u))
    return torch.argmax(logits + gumbel, dim=-1)
