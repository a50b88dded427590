"""Plain reference of the PPO train step's policy and update, in PyTorch.

A frozen copy of the arithmetic the trainer is specified to perform: an
actor and a critic MLP (tanh, float32) with orthogonal weights drawn on the
CPU from the seed (gain sqrt(2) in the trunks, 0.01 in the actor head, 1
in the value head, zero biases, log_std 0), a tanh-squashed Gaussian policy
whose noise comes from a generator on the device, GAE bootstrapped from the
last observation, the advantage normalized by its mean and population std,
one permutation of the rows per epoch, the clipped surrogate and clipped
value loss, optax's clip by global norm and Adam (eps 1e-8).

It imports nothing but torch. It builds its own network and generator from
the seed; it follows the program's rollout from the program's own
observations, rewards and ends of episodes (the env's step is checked
apart), and recomputes the policy's draws and every number of the update.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference.spintorque import derive_seed

Tensor = torch.Tensor
LOG_2PI = math.log(2 * math.pi)


class PPO(NamedTuple):
    """The trainer's configuration (``PPOConfig``'s defaults in the cell)."""

    rollout_steps: int
    num_epochs: int
    num_minibatches: int
    learning_rate: float
    gamma: float
    gae_lambda: float
    clip_eps: float
    vf_coef: float
    ent_coef: float
    max_grad_norm: float
    hidden_sizes: Sequence[int]


def network_seed(seed: int) -> int:
    return derive_seed(seed, 1 << 32)


def draw_seed(seed: int) -> int:
    return derive_seed(seed, (1 << 32) + 1)


def init_params(obs_dim: int, act_dim: int, hidden: Sequence[int], seed: int,
                device) -> Dict[str, Tensor]:
    """Named parameters in the trainer's order, drawn on the CPU."""
    g = torch.Generator().manual_seed(network_seed(seed))
    out: Dict[str, Tensor] = {}
    sizes = (obs_dim, *hidden)

    def orthogonal(shape, gain):
        w = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.orthogonal_(w, gain=gain, generator=g)
        return w

    # log_std first: the order in which the global norm sums the squares.
    out["log_std"] = torch.zeros(act_dim)
    for trunk in ("actor", "critic"):
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            out[f"trunks.{trunk}.{i}.weight"] = orthogonal((b, a), math.sqrt(2.0))
            out[f"trunks.{trunk}.{i}.bias"] = torch.zeros(b)
    width = sizes[-1]
    out["actor_mean.weight"] = orthogonal((act_dim, width), 0.01)
    out["actor_mean.bias"] = torch.zeros(act_dim)
    out["critic_value.weight"] = orthogonal((1, width), 1.0)
    out["critic_value.bias"] = torch.zeros(1)
    return {k: v.to(device).requires_grad_() for k, v in out.items()}


def forward(p: Dict[str, Tensor], obs: Tensor, layers: int):
    """(mean, log_std, value)."""
    pi = v = obs
    for i in range(layers):
        pi = torch.tanh(F.linear(pi, p[f"trunks.actor.{i}.weight"], p[f"trunks.actor.{i}.bias"]))
    for i in range(layers):
        v = torch.tanh(F.linear(v, p[f"trunks.critic.{i}.weight"], p[f"trunks.critic.{i}.bias"]))
    mean = F.linear(pi, p["actor_mean.weight"], p["actor_mean.bias"])
    value = F.linear(v, p["critic_value.weight"], p["critic_value.bias"]).squeeze(-1)
    return mean, p["log_std"], value


def log_prob(mean: Tensor, log_std: Tensor, raw: Tensor) -> Tensor:
    """Diagonal Gaussian log-density of the pre-tanh action, with the tanh
    change of variables."""
    std = torch.exp(log_std)
    pre_tanh = torch.atanh(torch.clamp(raw, -1 + 1e-6, 1 - 1e-6))
    logp = -0.5 * (((pre_tanh - mean) / std) ** 2 + 2 * log_std + LOG_2PI)
    logp = logp.sum(-1)
    return logp - torch.log(1 - raw**2 + 1e-6).sum(-1)


def sample(generator: torch.Generator, mean: Tensor, log_std: Tensor):
    std = torch.exp(log_std)
    noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
    raw = torch.tanh(mean + std * noise)
    return raw, log_prob(mean, log_std, raw)


def _pmean(xs: List[Tensor]) -> Tensor:
    """The mean of every rank's elements in float64 (each rank's sum, then
    their sum in rank order), rounded once to float32."""
    total = xs[0].to(torch.float64).sum()
    for x in xs[1:]:
        total = total + x.to(torch.float64).sum()
    count = torch.full((), float(sum(x.numel() for x in xs)), dtype=torch.float64,
                       device=xs[0].device)
    return (total / count).to(torch.float32)


class StepResult(NamedTuple):
    raw: List[Tensor]  # each rank's (T, B, 2) draws
    log_prob: List[Tensor]  # (T, B)
    value: List[Tensor]  # (T, B)
    loss: float  # mean over the step's minibatches (and the ranks)


class Trainer:
    """The reference trainer: its own parameters, Adam and a generator for
    each of the ``ranks`` data ranks the program runs on (rank r's seeded
    from the draw seed and r when there are several). On several ranks
    each minibatch step averages the ranks' gradients, summed in rank
    order, before the clip."""

    def __init__(self, cfg: PPO, obs_dim: int, act_dim: int, seed: int, device,
                 ranks: int = 1):
        self.cfg = cfg
        self.layers = len(cfg.hidden_sizes)
        self.params = init_params(obs_dim, act_dim, cfg.hidden_sizes, seed, device)
        self.optimizer = torch.optim.Adam(list(self.params.values()), lr=cfg.learning_rate,
                                          eps=1e-8)
        self.generators = []
        for r in range(ranks):
            g = torch.Generator(device=device)
            g.manual_seed(draw_seed(seed) if ranks == 1 else derive_seed(draw_seed(seed), r))
            self.generators.append(g)

    def step(self, obs: List[Tensor], raw_taken: List[Tensor], reward: List[Tensor],
             done: List[Tensor], last_obs: List[Tensor]) -> StepResult:
        """One train step along the program's rollout, given each rank's
        ``obs`` (T, B, 12), the raw actions it took (T, B, 2), its rewards
        and ends of episodes (T, B) and the observation after it."""
        cfg = self.cfg
        draws, old, perms = [], [], []
        for r, g in enumerate(self.generators):
            raws, logps, values, taken = [], [], [], []
            with torch.no_grad():
                for t in range(cfg.rollout_steps):
                    mean, log_std, value = forward(self.params, obs[r][t], self.layers)
                    raw, logp = sample(g, mean, log_std)
                    raws.append(raw)
                    logps.append(logp)
                    values.append(value)
                    # The update takes the actions the program took, at
                    # their log-densities under this network.
                    taken.append(log_prob(mean, log_std, raw_taken[r][t]))
            draws.append([torch.stack(x) for x in (raws, logps, values)])
            old.append((torch.stack(taken), draws[-1][2]))
            n = old[-1][0].numel()
            perms.append(torch.stack([torch.randperm(n, generator=g, device=obs[r].device)
                                      for _ in range(cfg.num_epochs)]))
        loss = self.update(obs, raw_taken, reward, done, old, last_obs, perms)
        return StepResult(*([d[k] for d in draws] for k in range(3)), loss)

    def _batch(self, obs, raw, reward, done, old_logp, old_value, last_obs):
        """One rank's flattened batch with its GAE advantages and returns."""
        cfg = self.cfg
        with torch.no_grad():
            last_value = forward(self.params, last_obs, self.layers)[-1]
        not_done = 1.0 - done.to(reward.dtype)
        gae = torch.zeros_like(last_value)
        next_value = last_value
        out: List[Tensor] = [None] * cfg.rollout_steps
        for t in range(cfg.rollout_steps - 1, -1, -1):
            delta = reward[t] + cfg.gamma * next_value * not_done[t] - old_value[t]
            gae = delta + cfg.gamma * cfg.gae_lambda * not_done[t] * gae
            out[t] = gae
            next_value = old_value[t]
        adv = torch.stack(out)

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        return dict(obs=flat(obs), raw=flat(raw), logp=flat(old_logp), value=flat(old_value),
                    adv=flat(adv), ret=flat(adv + old_value))

    def _loss(self, mb) -> Tensor:
        cfg = self.cfg
        mean_a, log_std, value = forward(self.params, mb["obs"], self.layers)
        logp = log_prob(mean_a, log_std, mb["raw"])
        entropy = torch.broadcast_to(
            (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1), logp.shape)
        ratio = torch.exp(logp - mb["logp"])
        pg1 = ratio * mb["adv"]
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * mb["adv"]
        pg_loss = -torch.minimum(pg1, pg2).mean()
        v_clipped = mb["value"] + torch.clamp(value - mb["value"], -cfg.clip_eps, cfg.clip_eps)
        v_loss = 0.5 * torch.maximum((value - mb["ret"]) ** 2,
                                     (v_clipped - mb["ret"]) ** 2).mean()
        return pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy.mean()

    def update(self, obs, raw, reward, done, old, last_obs, perms) -> float:
        cfg = self.cfg
        ranks = len(obs)
        batches = [self._batch(obs[r], raw[r], reward[r], done[r], old[r][0], old[r][1],
                               last_obs[r]) for r in range(ranks)]
        adv = [b["adv"] for b in batches]
        mean = _pmean(adv)
        std = torch.sqrt(_pmean([(a - mean) ** 2 for a in adv]))
        for b in batches:
            b["adv"] = (b["adv"] - mean) / (std + 1e-8)
        size = batches[0]["logp"].shape[0] // cfg.num_minibatches
        params = list(self.params.values())
        losses = []
        for e in range(cfg.num_epochs):
            for i in range(cfg.num_minibatches):
                self.optimizer.zero_grad(set_to_none=True)
                totals = []
                for r, b in enumerate(batches):
                    idx = perms[r][e, i * size:(i + 1) * size]
                    total = self._loss({k: v.index_select(0, idx) for k, v in b.items()})
                    grads = torch.autograd.grad(total, params)
                    for q, gr in zip(params, grads):
                        q.grad = gr if q.grad is None else q.grad + gr
                    totals.append(total.detach())
                if ranks > 1:
                    for q in params:
                        q.grad = q.grad / ranks
                norm = torch.sqrt(sum(torch.sum(q.grad * q.grad) for q in params))
                for q in params:
                    q.grad.copy_(torch.where(norm < cfg.max_grad_norm, q.grad,
                                             q.grad / norm * cfg.max_grad_norm))
                self.optimizer.step()
                loss = totals[0]
                for t in totals[1:]:
                    loss = loss + t
                losses.append(loss / ranks if ranks > 1 else loss)
        return float(torch.stack(losses).mean())

    def first_moments(self) -> Dict[str, Tensor]:
        """Adam's first moment of each parameter, by name."""
        return {k: self.optimizer.state[p]["exp_avg"] for k, p in self.params.items()}
