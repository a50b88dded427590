"""PPO trainer over the vectorized SpinTorqueEnv.

PyTorch counterpart of ``spintorque_tpu/rl/ppo.py``. One train step is one
eager program on the env's device: a rollout of ``rollout_steps`` env steps
with the policy (each launching the pulse kernel on CUDA), the bootstrap
value and GAE, advantage normalization, and ``num_epochs`` x
``num_minibatches`` clipped-surrogate updates with value clipping, each
followed by the global-norm clip and Adam. The step reads nothing back to
the host: random draws come from a ``torch.Generator`` on the device,
minibatches are gathered with ``index_select``, and the metrics stay
device tensors until ``train`` logs them.

Held to the JAX package's update: the clip is optax's
``clip_by_global_norm`` (``where(norm < max, g, g / norm * max)``, not
``clip_grad_norm_``'s ``max / (norm + 1e-6)``), Adam is ``optax.adam``
(``torch.optim.Adam`` with eps 1e-8, the same formula in another op order),
and the advantage std is the population std. The trainer sets no global
flags: float32 matmuls run without TF32, PyTorch's default.

On a mesh (the env's ``SpinTorqueEnv(mesh=...)``) each rank collects its own
rows and draws its own actions and minibatch permutations (its generator
is folded with its data rank when there is more than one); the initial
weights, drawn on the CPU from the seed, are the same on every rank. The
advantage mean and population std are global (two ``all_reduce(SUM)``
passes), each minibatch takes
``n_local // num_minibatches`` rows of every rank, and its gradients are
averaged over the ranks by one flattened ``all_reduce(SUM) / W`` before the
clip, so the clip sees the global norm and Adam runs identically on every
rank. The minibatches are thus stratified by rank: the same estimator as
the JAX trainer's global permutation, another draw of it. Metrics are
global means (``parallel.pmean_metrics``); ``episodes`` is a global sum.

A mesh with a 'model' axis (n_model > 1) makes the network tensor-parallel
(``ActorCritic(mesh=...)``): each rank holds its shard of the hidden
layers. Every draw is keyed by the 'data' rank only, so the model ranks of
one data coordinate draw the same actions and permutations and step the
same env rows, as the JAX package replicates the batch across 'model'.
The gradient average runs over 'data' on each rank's shard; the clip's
global norm sums the sharded gradients' squares over 'model' and counts
the replicated ones once; Adam then runs on each shard, as on the whole
network up to the order of the row-parallel sums.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..envs.spin_torque import EnvState, SpinTorqueEnv
from ..ops.philox import derive_seed
from ..parallel.mesh import all_reduce, model_all_reduce, pmean_metrics
from ..utils.profiling import counter, span
from .networks import (
    ActorCritic,
    continuous_action_transform,
    gaussian_entropy,
    gaussian_log_prob,
    sample_continuous,
    sample_discrete,
)

Tensor = torch.Tensor

# Every minibatch step of the process's updates.
MINIBATCHES = counter("ppo.minibatches")


class PPOConfig(NamedTuple):
    rollout_steps: int = 16
    num_epochs: int = 4
    num_minibatches: int = 4
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    hidden_sizes: Tuple[int, ...] = (256, 256)
    # Layer compute dtype: 'float32' | 'bfloat16' (float32 parameters,
    # optimizer and loss math either way), or None for the input's dtype.
    compute_dtype: Optional[str] = "float32"
    # One trunk for both heads (networks.ActorCritic.shared_trunk).
    shared_trunk: bool = False


@dataclasses.dataclass
class TrainState:
    """Trainer state. ``network`` and ``optimizer`` are updated in place by
    ``train_step``; ``generator`` (on the env's device) draws actions and
    minibatch permutations and advances in place."""

    network: ActorCritic
    optimizer: torch.optim.Optimizer
    env_state: EnvState
    obs: Tensor
    generator: torch.Generator
    update_count: int


# Trajectory keys: each a (T, B, ...) tensor.
_TRAJ_KEYS = ("obs", "raw_action", "reward", "done", "terminated", "log_prob", "value", "success")


class PPOTrainer:
    """PPO over a vectorized SpinTorqueEnv on the env's device, on one rank
    or, with the env's mesh, on every rank of it."""

    def __init__(self, env: SpinTorqueEnv, config: PPOConfig = PPOConfig(), mesh=None):
        if mesh is None:
            mesh = env.mesh
        elif env.mesh is not mesh:
            raise ValueError(
                "PPOTrainer(mesh=...) takes an env built on the same mesh "
                "(SpinTorqueEnv(mesh=...)), which holds this rank's rows"
            )
        if env.replicated:
            raise ValueError(
                f"PPOTrainer on a mesh needs a global batch that divides the data axis, not "
                f"{env.batch_size} over {mesh.shape['data']}: the JAX trainer's device_put of "
                "the observations onto the batch sharding raises too "
                "(spintorque_tpu/rl/ppo.py:120)")
        self.env = env
        self.config = config
        self.mesh = mesh
        if env.config.observation_mode != "vector":
            raise ValueError(
                "PPOTrainer requires observation_mode='vector' (dict "
                "observations need a custom network; see rl/networks.py)"
            )
        self.discrete = env.config.action_mode == "discrete"
        self.action_dim = env.num_actions if self.discrete else 2

    # ------------------------------------------------------------------ setup

    def make_network(self, seed: int = 0) -> ActorCritic:
        """A freshly initialized network on the env's device; its weights
        are drawn on the CPU from ``seed``, so they do not depend on the
        device (nor, sliced to a rank's shard on a 'model' axis, on the
        mesh)."""
        cfg = self.config
        network = ActorCritic(
            self.env.observation_size, self.action_dim, discrete=self.discrete,
            hidden_sizes=cfg.hidden_sizes, compute_dtype=cfg.compute_dtype,
            shared_trunk=cfg.shared_trunk, generator=torch.Generator().manual_seed(seed),
            mesh=self.mesh,
        )
        return network.to(self.env.device)

    def make_optimizer(self, network: ActorCritic) -> torch.optim.Optimizer:
        return torch.optim.Adam(network.parameters(), lr=self.config.learning_rate, eps=1e-8)

    def init(self, seed: int) -> TrainState:
        env_state, obs = self.env.reset(seed)
        network = self.make_network(derive_seed(seed, 1 << 32))
        draw_seed = derive_seed(seed, (1 << 32) + 1)
        # Each data coordinate draws its own actions and minibatches; the
        # model ranks of one coordinate draw the same, and a mesh of one
        # data coordinate (the whole batch) draws as one process does.
        if self.mesh is not None and self.mesh.shape["data"] > 1:
            draw_seed = derive_seed(draw_seed, self.mesh.data_rank)
        generator = torch.Generator(device=self.env.device)
        generator.manual_seed(draw_seed)
        return TrainState(
            network=network,
            optimizer=self.make_optimizer(network),
            env_state=env_state,
            obs=obs,
            generator=generator,
            update_count=0,
        )

    # ------------------------------------------------------------------ policy

    def policy(self, network: ActorCritic, obs: Tensor, generator: torch.Generator):
        """(env action, raw action, log-prob, value) for a batch of obs."""
        out = network(obs)
        if self.discrete:
            logits, value = out
            action = sample_discrete(generator, logits)
            log_prob = torch.log_softmax(logits, -1).gather(-1, action[..., None]).squeeze(-1)
            return action, action, log_prob, value
        mean, log_std, value = out
        raw, log_prob = sample_continuous(generator, mean, log_std)
        cfg = self.env.config
        env_action = continuous_action_transform(raw, cfg.max_current, cfg.max_duration)
        return env_action, raw, log_prob, value

    def evaluate_actions(self, network: ActorCritic, obs: Tensor, raw_actions: Tensor):
        """(log-prob, entropy, value) of given actions."""
        out = network(obs)
        if self.discrete:
            logits, value = out
            logp_all = torch.log_softmax(logits, -1)
            log_prob = logp_all.gather(-1, raw_actions[..., None].long()).squeeze(-1)
            entropy = -(torch.exp(logp_all) * logp_all).sum(-1)
            return log_prob, entropy, value
        mean, log_std, value = out
        log_prob = gaussian_log_prob(mean, log_std, raw_actions)
        return log_prob, gaussian_entropy(log_std, log_prob.shape), value

    # ------------------------------------------------------------------ train

    @torch.no_grad()
    def collect(self, ts: TrainState) -> Tuple[TrainState, Dict[str, Tensor]]:
        """The rollout: ``rollout_steps`` env steps with the policy. Returns
        the advanced state and the trajectory, a dict of (T, B, ...)
        tensors."""
        with span("ppo.collect"):
            env_state, obs = ts.env_state, ts.obs
            steps = {k: [] for k in _TRAJ_KEYS}
            for _ in range(self.config.rollout_steps):
                with span("ppo.policy"):
                    env_action, raw_action, log_prob, value = self.policy(ts.network, obs,
                                                                          ts.generator)
                env_state, out = self.env.step(env_state, env_action)
                record = dict(
                    obs=obs, raw_action=raw_action, reward=out.reward,
                    done=out.terminated | out.truncated, terminated=out.terminated,
                    log_prob=log_prob, value=value, success=out.info["is_success"],
                )
                for k, v in record.items():
                    steps[k].append(v)
                obs = out.obs
            traj = {k: torch.stack(v) for k, v in steps.items()}
            return dataclasses.replace(ts, env_state=env_state, obs=obs), traj

    def advantages(self, network: ActorCritic, traj: Dict[str, Tensor], last_obs: Tensor):
        """GAE over the trajectory, bootstrapped from the value of
        ``last_obs``; done steps (auto-reset) cut the bootstrap. Returns
        (advantages, returns), each (T, B)."""
        cfg = self.config
        with torch.no_grad():
            last_value = network(last_obs)[-1]
        reward, value = traj["reward"], traj["value"]
        not_done = 1.0 - traj["done"].to(reward.dtype)
        gae = torch.zeros_like(last_value)
        next_value = last_value
        out = [None] * cfg.rollout_steps
        for t in range(cfg.rollout_steps - 1, -1, -1):
            delta = reward[t] + cfg.gamma * next_value * not_done[t] - value[t]
            gae = delta + cfg.gamma * cfg.gae_lambda * not_done[t] * gae
            out[t] = gae
            next_value = value[t]
        advantages = torch.stack(out)
        return advantages, advantages + value

    def loss(self, network: ActorCritic, mb: Dict[str, Tensor]):
        """Clipped surrogate + clipped value loss - entropy bonus."""
        cfg = self.config
        log_prob, entropy, value = self.evaluate_actions(network, mb["obs"], mb["raw_action"])
        ratio = torch.exp(log_prob - mb["log_prob"])
        pg1 = ratio * mb["advantage"]
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * mb["advantage"]
        pg_loss = -torch.minimum(pg1, pg2).mean()
        v_clipped = mb["value"] + torch.clamp(value - mb["value"], -cfg.clip_eps, cfg.clip_eps)
        v_loss = 0.5 * torch.maximum((value - mb["ret"]) ** 2, (v_clipped - mb["ret"]) ** 2).mean()
        ent = entropy.mean()
        total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
        return total, dict(pg_loss=pg_loss, v_loss=v_loss, entropy=ent)

    def average_grads(self, network: ActorCritic) -> None:
        """The gradients' mean over the ranks, in place: one flattened
        ``all_reduce(SUM)``, then / W. Nothing without a mesh."""
        if self.mesh is None:
            return
        grads = [p.grad for p in network.parameters() if p.grad is not None]
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), self.mesh)
        flat /= self.mesh.shape["data"]
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def grad_norm(self, network: ActorCritic) -> Tensor:
        """The global L2 norm of the network's gradients, the same on every
        rank. On a 'model' axis: the sharded gradients' squares summed over
        'model' (one all-reduce), the replicated ones' counted once."""
        sharded = {id(p) for p in network.sharded_parameters()}
        total = sum(torch.sum(p.grad * p.grad) for p in network.parameters()
                    if p.grad is not None and id(p) not in sharded)
        squares = [torch.sum(p.grad * p.grad) for p in network.parameters()
                   if p.grad is not None and id(p) in sharded]
        if squares:
            total = total + model_all_reduce(torch.stack(squares).sum(), network.mesh)
        return torch.sqrt(total)

    def clip_grads(self, network: ActorCritic) -> None:
        """optax.clip_by_global_norm on the gradients, in place, by the
        whole network's norm (``grad_norm``)."""
        grads = [p.grad for p in network.parameters() if p.grad is not None]
        norm = self.grad_norm(network)
        max_norm = self.config.max_grad_norm
        for g in grads:
            g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))

    def update_from_traj(
        self,
        network: ActorCritic,
        optimizer: torch.optim.Optimizer,
        traj: Dict[str, Tensor],
        last_obs: Tensor,
        perms: Tensor,
    ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The post-rollout update: bootstrap value, GAE, flatten, advantage
        normalization, then for each epoch e the minibatches of
        ``n // num_minibatches`` rows taken in the order of ``perms[e]``
        (the remainder dropped), each a gradient step. ``network`` and
        ``optimizer`` are updated in place. Returns (losses, auxes), each
        (num_epochs, num_minibatches).

        On a mesh ``traj`` and ``perms`` are this rank's (n = its T x B/W
        rows); the advantage statistics, gradients, losses and auxes are
        global, so every rank ends with the same parameters."""
        cfg = self.config
        with span("ppo.gae"):
            advantages, returns = self.advantages(network, traj, last_obs)

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        with span("ppo.normalize"):
            batch = dict(
                obs=flat(traj["obs"]), raw_action=flat(traj["raw_action"]),
                log_prob=flat(traj["log_prob"]), value=flat(traj["value"]),
                advantage=flat(advantages), ret=flat(returns),
            )
            adv = batch["advantage"]
            mean = pmean_metrics(adv, self.mesh)  # over every rank's rows
            std = torch.sqrt(pmean_metrics((adv - mean) ** 2, self.mesh))  # population std
            batch["advantage"] = (adv - mean) / (std + 1e-8)
        size = batch["log_prob"].shape[0] // cfg.num_minibatches

        losses, auxes = [], {k: [] for k in ("pg_loss", "v_loss", "entropy")}
        for e in range(cfg.num_epochs):
            for i in range(cfg.num_minibatches):
                MINIBATCHES.add()
                with span("ppo.minibatch"):
                    with span("ppo.forward"):
                        idx = perms[e, i * size:(i + 1) * size]
                        mb = {k: v.index_select(0, idx) for k, v in batch.items()}
                        optimizer.zero_grad(set_to_none=True)
                        total, aux = self.loss(network, mb)
                    with span("ppo.backward"):
                        total.backward()
                    with span("ppo.average_grads"):
                        self.average_grads(network)
                    with span("ppo.clip"):
                        self.clip_grads(network)
                    with span("ppo.adam"):
                        optimizer.step()
                    losses.append(total.detach())
                    for k, v in aux.items():
                        auxes[k].append(v.detach())
        shape = (cfg.num_epochs, cfg.num_minibatches)
        with span("ppo.metrics"):
            stacked = torch.stack([torch.stack(losses)]
                                  + [torch.stack(v) for v in auxes.values()])
            if self.mesh is not None:
                stacked = all_reduce(stacked, self.mesh) / self.mesh.shape["data"]
        losses, *rest = (x.reshape(shape) for x in stacked.unbind())
        return losses, dict(zip(auxes, rest))

    def update(self, ts: TrainState, traj: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The update phase of a train step on a collected trajectory
        (``ts`` already advanced by ``collect``); returns the step's
        metrics as device tensors."""
        with span("ppo.update"):
            n = traj["log_prob"].numel()
            perms = torch.stack([  # one permutation per epoch
                torch.randperm(n, generator=ts.generator, device=ts.obs.device)
                for _ in range(self.config.num_epochs)
            ])
            losses, auxes = self.update_from_traj(ts.network, ts.optimizer, traj, ts.obs, perms)
            dtype = traj["reward"].dtype
            with span("ppo.metrics"):
                return {
                    "loss": losses.mean(),
                    "pg_loss": auxes["pg_loss"].mean(),
                    "v_loss": auxes["v_loss"].mean(),
                    "entropy": auxes["entropy"].mean(),
                    **pmean_metrics({"mean_reward": traj["reward"],
                                     "success_rate": traj["success"].to(dtype)}, self.mesh),
                    "episodes": all_reduce(traj["done"].sum().reshape(1), self.mesh)[0],
                }

    def train_step(self, ts: TrainState) -> Tuple[TrainState, Dict[str, Tensor]]:
        """One rollout and its update; metrics stay on the device."""
        ts, traj = self.collect(ts)
        metrics = self.update(ts, traj)
        return dataclasses.replace(ts, update_count=ts.update_count + 1), metrics

    def train(
        self,
        total_timesteps: int,
        seed: int = 0,
        log_every: int = 10,
        callback: Optional[Callable[[int, Dict[str, Any]], None]] = None,
    ) -> Tuple[TrainState, Dict[str, Any]]:
        """Host training loop; returns the final state and a summary
        (steps/s and the last step's metrics)."""
        ts = self.init(seed)
        steps_per_update = self.config.rollout_steps * self.env.batch_size
        num_updates = max(1, total_timesteps // steps_per_update)
        t0 = time.perf_counter()
        metrics: Dict[str, Tensor] = {}
        for i in range(num_updates):
            ts, metrics = self.train_step(ts)
            if callback is not None and (i % log_every == 0 or i == num_updates - 1):
                callback(i, {k: float(v) for k, v in metrics.items()})
        if self.env.device.type == "cuda":
            torch.cuda.synchronize(self.env.device)
        elapsed = time.perf_counter() - t0
        summary = {
            "updates": num_updates,
            "timesteps": num_updates * steps_per_update,
            "elapsed_s": elapsed,
            "steps_per_s": num_updates * steps_per_update / elapsed,
            **{k: float(v) for k, v in metrics.items()},
        }
        return ts, summary
