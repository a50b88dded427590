"""Policy/value networks for the PPO trainer.

PyTorch counterpart of ``spintorque_tpu/rl/networks.py``. The MLPs are plain
matrix products (``torch.nn.functional.linear``), as the JAX package leaves
its flax ``nn.Dense`` layers to XLA. Layer names follow the flax module's
parameter tree (``actor_dense_0`` ... ``critic_value``, ``log_std``), so
``convert.actor_critic_params_from_numpy`` carries its parameters across.

Tensor parallel over a mesh's 'model' axis (``ActorCritic(mesh=...)``),
the layout of the flax module's PartitionSpecs (Megatron's): even hidden
layers are column-parallel (each rank holds 1/n_model of the output
features: ``weight[out_slice]`` and its bias, flax ``P(None, "model")``
and ``P("model")``), odd ones row-parallel (1/n_model of the input
features, ``weight[:, in_slice]``; flax ``P("model", None)``) with a
replicated bias, added once after the sum of the partial products. The
heads and ``log_std`` are replicated. The collectives are autograd
functions over ``parallel.mesh.model_all_reduce``, an all-reduce, the one
collective gloo runs on CUDA tensors as NCCL does:

  * ``_CopyToModel`` (Megatron's f) before a column-parallel layer: the
    identity forward, an all-reduce of the input's gradient backward;
  * ``_ReduceFromModel`` (g) after a row-parallel layer's product: an
    all-reduce forward, the identity backward;
  * ``_GatherFromModel`` after a trunk that ends on a column-parallel
    layer (an odd count of hidden layers): the full activation forward
    (each rank's slice placed in zeros, then the all-reduce: exact), and
    this rank's slice of the gradient backward, which the replicated
    heads make the same on every rank.

Initial weights are drawn whole from the generator, exactly as an
unsharded network's, and then sliced: the gathered parameters of a sharded
network equal the unsharded network's bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import model_all_reduce

Tensor = torch.Tensor

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    # flax's nn.gelu defaults to the tanh approximation.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


class _CopyToModel(torch.autograd.Function):
    """The identity; its backward sums the gradient over 'model'."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return model_all_reduce(grad, ctx.mesh).to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over 'model' (in float32 for a narrower input); its backward
    is the identity, in the input's dtype."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.dtype = x.dtype
        return model_all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


class _GatherFromModel(torch.autograd.Function):
    """Every rank's slice of the last dim, in rank order; its backward
    takes this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        n, r, w = mesh.shape["model"], mesh.model_rank, x.shape[-1]
        ctx.cols = slice(r * w, (r + 1) * w)
        full = x.new_zeros(x.shape[:-1] + (n * w,))
        full[..., ctx.cols] = x
        return model_all_reduce(full, mesh).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.cols], None


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

    ``mesh`` (a ``parallel.Mesh`` with n_model > 1) makes the trunks
    tensor-parallel over its 'model' axis (the module docstring): this
    rank holds only its shard of each hidden layer, and every hidden size
    that is sharded (the even layers' outputs) must divide by n_model,
    else ``ValueError``, as JAX's ``device_put`` raises. Under
    'bfloat16' the row-parallel partial products are summed in float32
    and the bias is added before one rounding to bfloat16.
    ``full_state_dict`` and ``load_full_state_dict`` move whole
    parameters in and out (gathering and slicing the shards).
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
        mesh=None,
    ):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"Unknown activation: {activation}")
        self.discrete = discrete
        self.activation = activation
        self.compute_dtype = None if compute_dtype is None else getattr(torch, compute_dtype)
        self.shared_trunk = shared_trunk
        self.mesh = mesh if mesh is not None and mesh.shape["model"] > 1 else None
        n = 1 if self.mesh is None else self.mesh.shape["model"]
        sizes = (obs_dim, *hidden_sizes)
        bad = [h for i, h in enumerate(hidden_sizes) if i % 2 == 0 and h % n]
        if bad:
            raise ValueError(f"hidden sizes {bad} do not divide over the 'model' axis of {n}")
        # Trunk layer i: its whole (out, in) weight shape, and the rows and
        # columns of it that this rank holds.
        r = 0 if self.mesh is None else self.mesh.model_rank
        self._cuts = []
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            rows, cols = slice(None), slice(None)
            if n > 1 and i % 2 == 0:
                rows = slice(r * b // n, (r + 1) * b // n)
            elif n > 1:
                cols = slice(r * a // n, (r + 1) * a // n)
            self._cuts.append(((b, a), rows, cols))

        def linear(n_in, n_out):
            return nn.Linear(n_in, n_out, device=device, dtype=torch.float32)

        def trunk():
            return nn.ModuleList(linear(len(range(a)[cols]), len(range(b)[rows]))
                                 for (b, a), rows, cols in self._cuts)

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
        """Orthogonal weights and zero biases (the flax module's init),
        each weight drawn whole and sliced to this rank's shard."""
        with torch.no_grad():
            for trunk in self.trunks.values():
                for layer, (shape, rows, cols) in zip(trunk, self._cuts):
                    _init(layer, math.sqrt(2.0), generator, shape, rows, cols)
            for layer, gain in ((self.actor_logits if self.discrete else self.actor_mean, 0.01),
                                (self.critic_value, 1.0)):
                _init(layer, gain, generator, tuple(layer.weight.shape))
            if not self.discrete:
                self.log_std.zero_()

    def _shard_dims(self) -> Dict[str, Tuple[int, slice]]:
        """``state_dict`` name -> (dim, slice) of each sharded tensor."""
        if self.mesh is None:
            return {}
        out = {}
        for name in self.trunks:
            for i, (_, rows, cols) in enumerate(self._cuts):
                key = f"trunks.{name}.{i}"
                if i % 2 == 0:
                    out[f"{key}.weight"] = out[f"{key}.bias"] = (0, rows)
                else:
                    out[f"{key}.weight"] = (1, cols)
        return out

    def sharded_parameters(self):
        """The parameters that hold a slice over 'model' (none unsharded)."""
        dims = self._shard_dims()
        return [p for name, p in self.named_parameters() if name in dims]

    def gather_shard(self, name: str, t: Tensor) -> Tensor:
        """The whole tensor of parameter ``name`` (a ``state_dict`` key) from
        each rank's shard ``t`` of it, exactly (``t`` itself when ``name``
        is not sharded). Sharded, a collective of the model group."""
        dims = self._shard_dims()
        if name not in dims:
            return t
        dim = dims[name][0]
        full = _GatherFromModel.apply(t.detach().movedim(dim, -1), self.mesh)
        return full.movedim(-1, dim).contiguous()

    def take_shard(self, name: str, t: Tensor) -> Tensor:
        """This rank's shard of the whole tensor ``t`` of parameter ``name``."""
        dims = self._shard_dims()
        if name not in dims:
            return t
        dim, cut = dims[name]
        return t.narrow(dim, cut.start, cut.stop - cut.start)

    def full_state_dict(self) -> Dict[str, Tensor]:
        """The whole network's ``state_dict`` (every shard gathered over
        'model', exactly): the unsharded network's. Sharded, it is a
        collective that every rank of the model group must join."""
        return {name: self.gather_shard(name, t.detach())
                for name, t in self.state_dict().items()}

    def load_full_state_dict(self, state: Dict[str, Tensor]) -> None:
        """Load a whole network's ``state_dict`` (an unsharded network's, or
        ``full_state_dict``'s), each sharded tensor sliced to this rank."""
        self.load_state_dict({name: self.take_shard(name, t) for name, t in state.items()})

    def _dense(self, layer: nn.Linear, x: Tensor) -> Tensor:
        w, b = layer.weight, layer.bias
        if self.compute_dtype is not None:
            x, w, b = x.to(self.compute_dtype), w.to(self.compute_dtype), b.to(self.compute_dtype)
        return F.linear(x, w, b)

    def _out(self, x: Tensor) -> Tensor:
        return x if self.compute_dtype is None else x.to(torch.float32)

    def _row_dense(self, layer: nn.Linear, x: Tensor) -> Tensor:
        """A row-parallel layer: this rank's partial product, summed over
        'model', then the replicated bias once."""
        w, b = layer.weight, layer.bias
        if self.compute_dtype is not None:
            x, w = x.to(self.compute_dtype), w.to(self.compute_dtype)
        y = _ReduceFromModel.apply(F.linear(x, w), self.mesh)
        y = y + b.to(y.dtype)
        return y if self.compute_dtype is None else y.to(self.compute_dtype)

    def _trunk(self, name: str, obs: Tensor) -> Tensor:
        act = _ACTIVATIONS[self.activation]
        x = obs
        trunk = self.trunks[name]
        for i, layer in enumerate(trunk):
            if self.mesh is None:
                x = act(self._dense(layer, x))
            elif i % 2 == 0:
                x = act(self._dense(layer, _CopyToModel.apply(x, self.mesh)))
            else:
                x = act(self._row_dense(layer, x))
        if self.mesh is not None and len(trunk) % 2:
            x = _GatherFromModel.apply(x, self.mesh)
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


def _init(layer: nn.Linear, gain: float, generator: Optional[torch.Generator], shape,
          rows=slice(None), cols=slice(None)) -> None:
    """Draw the whole (out, in) = ``shape`` orthogonal weight and keep this
    rank's [rows, cols]; zero the bias."""
    full = torch.empty(shape, dtype=layer.weight.dtype, device=layer.weight.device)
    nn.init.orthogonal_(full, gain=gain, generator=generator)
    layer.weight.copy_(full[rows, cols])
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
