"""Driver ``train``: the port's ``PPOTrainer`` on the vectorized env, train
steps back to back (a rollout by ``trainer.collect``, then
``trainer.update``), each ended by a synchronize.

Set-up builds one trainer and drives it from the seed through its first
``check.steps`` train steps, by the same calls as the window; the check
follows those steps. Then the window runs the same trainer on.

On several cards (``ctx.world`` ranks, one process a card) the env is
the port's data mesh over every rank: ``batch`` envs a card, the global
batch ``batch`` x W, each rank stepping its rows and the trainer averaging
the gradients over the ranks. The ranks agree after each train step
whether the window is over (one all-reduce of the slowest rank's clock),
so every rank runs the same steps, and the window is the slowest rank's.

Workload keys: ``batch`` (envs a card), ``ppo`` (``PPOConfig`` fields),
``trace_steps`` and ``check`` (``steps``, the train steps the check
follows, and ``every``, the rollout's env steps it compares row by row).

Records: ``setup_s``; ``window`` (its ``seconds``, train ``steps`` and
global ``env_steps``); ``rollout_ms`` and ``update_ms`` (CUDA events
around ``trainer.collect`` and ``trainer.update`` on rank 0, each train
step of the window); ``trace`` with the trace on, else ``busy``: the
train steps traced after the window, replayed from the state set-up left
(see ``lib/profile.py``; ``busy_s``
and ``work_s`` averaged over the ranks;
``collective_s`` the sum over the traced collectives of each one's least
NCCL kernel time over the ranks: the rank that arrives last waits least,
so that is its transfer; ``collective_rank0_s`` rank 0's NCCL time, wait
included).
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from perfbench.lib import check, profile, program
from perfbench.reference import ppo as ref_ppo


def _reduce(x: float, ctx, op) -> float:
    """``x`` reduced over the ranks (itself on one card)."""
    if ctx.world == 1:
        return x
    t = torch.tensor([x], dtype=torch.float64, device=ctx.device)
    dist.all_reduce(t, op=op)
    return float(t[0])


def run(ctx):
    wl = ctx.workload
    batch = wl["batch"] * ctx.world
    mesh = program.make_mesh(ctx.device) if ctx.world > 1 else None
    env = program.make_env(ctx.config, batch, ctx.device, control=ctx.control, mesh=mesh)
    trainer = program.make_trainer(env, wl["ppo"], control=ctx.control)
    if ctx.patch is not None:
        ctx.patch(trainer)
    ts = trainer.init(ctx.env_seed)
    start = ts.env_state
    network = ts.network
    params0 = {k: p.detach().clone() for k, p in network.named_parameters()}

    # The env steps of the followed train steps that the check compares.
    kept, count = [], [0]
    step = env.step

    def recorded(state, action):
        nxt, out = step(state, action)
        if ctx.sampled(count[0]):
            kept.append(check.Sample(state, action, nxt, out))
        count[0] += 1
        return nxt, out

    env.step = recorded
    followed = []
    for i in range(wl["check"]["steps"]):
        ts, traj = trainer.collect(ts)
        metrics = trainer.update(ts, traj)
        ts = dataclasses.replace(ts, update_count=ts.update_count + 1)
        followed.append(dict(traj=traj, last_obs=ts.obs, loss=metrics["loss"]))
        if i == 0:
            state = ts.optimizer.state
            moments = {k: (state[p]["exp_avg"] if p in state else torch.zeros_like(p)).clone()
                       for k, p in network.named_parameters()}
    del env.step
    params = {k: p.detach().clone() for k, p in network.named_parameters()}
    resume = (ts, ts.generator.get_state(), copy.deepcopy(ts.optimizer.state_dict()))
    ctx.sync()
    setup_s = time.time() - ctx.process_start

    cuda = ctx.device.type == "cuda"
    rollout_ms, update_ms, done = [], [], 0
    t0 = time.perf_counter()
    while True:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else None
        if cuda:
            marks[0].record()
        ts, traj = trainer.collect(ts)
        if cuda:
            marks[1].record()
        trainer.update(ts, traj)
        ts = dataclasses.replace(ts, update_count=ts.update_count + 1)
        if cuda:
            marks[2].record()
        ctx.sync()
        done += 1
        if cuda:
            rollout_ms.append(marks[0].elapsed_time(marks[1]))
            update_ms.append(marks[1].elapsed_time(marks[2]))
        elapsed = _reduce(time.perf_counter() - t0, ctx, dist.ReduceOp.MAX)
        if elapsed >= ctx.seconds:
            break
    env_steps = trainer.config.rollout_steps * batch
    records = dict(
        setup_s=setup_s,
        window=dict(seconds=elapsed, steps=done, env_steps=done * env_steps),
        rollout_ms=rollout_ms,
        update_ms=update_ms,
        attempted=done * env_steps,
        failed=0,
        memory_peak_bytes=_reduce(torch.cuda.max_memory_allocated(ctx.device) if cuda else 0,
                                  ctx, dist.ReduceOp.MAX),
    )
    # Every run traces ``trace_steps`` train steps after the window: the
    # device seconds a train step (the end-to-end ``train_step_busy_ms``)
    # come from them, and with the trace on the per-layer metrics too. They
    # replay the train steps that follow set-up's, from the state set-up
    # left, so that their work depends on the seed alone and not on how far
    # the window got: the policy's pulses, and with them the kernel's work,
    # drift as training goes on.
    ts, generator_state, optimizer_state = resume
    with torch.no_grad():
        for k, p in network.named_parameters():
            p.copy_(params[k])
    ts.optimizer.load_state_dict(optimizer_state)
    ts.generator.set_state(generator_state)
    box = [ts]

    def traced():
        with record_function("trainer.collect"):
            box[0], traj = trainer.collect(box[0])
        with record_function("trainer.update"):
            trainer.update(box[0], traj)
        return np.zeros(0, np.float32)

    t = records["trace" if ctx.trace else "busy"] = profile.profiled(ctx, traced,
                                                                      wl["trace_steps"])
    t["collective_rank0_s"] = t["collective_s"]
    t["collective_s"] = _least_collectives(t.pop("collective_durations"), t["collective_s"], ctx)
    for k in ("busy_s", "work_s"):
        t[k] = _reduce(t[k], ctx, dist.ReduceOp.SUM) / ctx.world
    t["window_s"] = _reduce(t["window_s"], ctx, dist.ReduceOp.MAX)
    follow = dict(params0=params0, params=params, moments=moments, followed=followed,
                  env_samples=kept, start=start)
    return records, start, follow


def _leaf_gap(got, want, keep=None):
    """The worst leaf's | |got| - |want| | over the larger of |want| and the
    median leaf's |want| (norms of each named tensor)."""
    g = {k: float(torch.linalg.vector_norm(v.double())) for k, v in got.items()}
    w = {k: float(torch.linalg.vector_norm(v.double())) for k, v in want.items()}
    names = [k for k in w if keep is None or k in keep]
    median = float(np.median([w[k] for k in names]))
    return max(abs(g[k] - w[k]) / max(w[k], median) for k in names)


def _least_collectives(durations: list, total: float, ctx) -> float:
    """The sum over the collectives of each one's least kernel seconds over
    the ranks (the i-th NCCL kernel of every rank is the same collective);
    where the ranks traced different numbers of them, the least ``total``."""
    if ctx.world == 1:
        return total
    n = len(durations)
    least, most = _reduce(n, ctx, dist.ReduceOp.MIN), _reduce(n, ctx, dist.ReduceOp.MAX)
    if least != most or n == 0:
        return _reduce(total, ctx, dist.ReduceOp.MIN)
    d = torch.tensor(durations, dtype=torch.float64, device=ctx.device)
    return float(torch.stack(_gathered(d, ctx)).min(dim=0).values.sum())


def _gathered(x: torch.Tensor, ctx) -> list:
    """Every rank's ``x`` (the same shape on each), in rank order."""
    if ctx.world == 1:
        return [x]
    out = [torch.empty_like(x) for _ in range(ctx.world)]
    dist.all_gather(out, x.contiguous())
    return out


def check_run(ctx, start, follow):
    """The training check's numbers: the env's step over the followed
    rollouts' sampled env steps (``check.compare``, each rank its rows, the
    worst over the ranks), and the reference trainer along the followed
    train steps (on rank 0, from every rank's rollout)."""
    wl = ctx.workload
    local = wl["batch"]
    rows = torch.arange(ctx.rank * local, (ctx.rank + 1) * local, device=ctx.device)
    out = check.compare(ctx.config, start, follow["env_samples"], local * ctx.world,
                        ctx.env_seed, graph=ctx.device.type == "cuda", rows=rows)
    numbers = {k: _reduce(v, ctx, dist.ReduceOp.MAX) for k, v in out["numbers"].items()}
    keys = ("obs", "raw_action", "reward", "done", "log_prob", "value")
    gathered = [{k: _gathered(f["traj"][k], ctx) for k in keys} | {
        "last_obs": _gathered(f["last_obs"], ctx)} for f in follow["followed"]]
    if ctx.rank != 0:  # rank 0 alone follows the trainer and prints the result
        numbers.update(dict.fromkeys(("policy_err", "loss_gap", "grad_gap", "change_gap"), 0.0))
        return dict(numbers=numbers, steps=out["steps"], rows=out["rows"])
    cfg = ref_ppo.PPO(**{k: wl["ppo"][k] for k in ref_ppo.PPO._fields})
    trainer = ref_ppo.Trainer(cfg, 12, 2, ctx.env_seed, ctx.device, ranks=ctx.world)
    init = {k: p.detach().clone() for k, p in trainer.params.items()}
    policy, losses = 0.0, 0.0
    for i, (f, g) in enumerate(zip(follow["followed"], gathered)):
        res = trainer.step(g["obs"], g["raw_action"], g["reward"], g["done"], g["last_obs"])
        for r in range(ctx.world):
            policy = max(policy,
                         check._scaled(g["raw_action"][r].reshape(-1, 2),
                                       res.raw[r].reshape(-1, 2)),
                         check._scaled(g["log_prob"][r].reshape(-1),
                                       res.log_prob[r].reshape(-1)),
                         check._scaled(g["value"][r].reshape(-1), res.value[r].reshape(-1)))
        losses = max(losses, abs(float(f["loss"]) - res.loss) / abs(res.loss))
        if i == 0:
            moments = trainer.first_moments()
            # Leaves whose gradient is nought to rounding move by round-off
            # alone under Adam: the change leaves them out.
            norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in moments.items()}
            median = float(np.median(list(norms.values())))
            moving = {k for k, v in norms.items() if v >= 1e-3 * median}
            numbers["grad_gap"] = _leaf_gap(follow["moments"], moments)
    p0 = follow["params0"]
    change = {k: follow["params"][k] - p0[k] for k in p0}
    want = {k: trainer.params[k].detach() - init[k] for k in p0}
    numbers["policy_err"] = policy
    numbers["loss_gap"] = losses
    numbers["change_gap"] = _leaf_gap(change, want, moving)
    return dict(numbers=numbers, steps=out["steps"] + len(follow["followed"]),
                rows=out["rows"])
