"""PPO train-step breakdown: where does the train step's time go?

PyTorch counterpart of scripts/bench_ppo.py. Measures in steady state
(10 warm-up calls each, then timed blocks of 8 calls with one synchronize
a block):

  * the full ``PPOTrainer.train_step`` (the production program);
  * the SAME step with ``update_from_traj`` replaced by a pass-through
    that still reads every trajectory tensor and the last obs with one
    cheap reduction each and leaves the network and the optimizer
    untouched -> the update's IN-SITU marginal (eager torch prunes
    nothing, but the reads keep the program the JAX ablation times);
  * env steps alone under random actions (no policy network), ``rollout``
    steps a call -> the policy's in-situ marginal;
  * rollout-only (``trainer.collect``) and update-only (``trainer.update``
    on one frozen trajectory), kept as REFERENCE diagnostics as in JAX:
    separate programs are not an additive split.

The first three are timed in turns, forth and back (two blocks each,
``turns_ms``), where the JAX program times one block each after the
other: the step is host-bound, and a drift of the host's speed between
programs timed apart would land in the marginals. The in-situ marginals
are additive BY CONSTRUCTION:
env_only + policy_marginal + update_marginal == train_step
(``identity_rel_err`` is the relative miss, float rounding only). The
program fails (``ok`` false, exit 1) when the identity misses by more
than 1e-9, when the ablated step moved a parameter or the optimizer's
state, or when the full step moved none. ``use_cuda_kernel`` stands where
the JAX record has ``use_pallas``: the env on the card launches K1 each
step. The env is the default SpinTorque-v0 configuration in float32
(thermal, RK4, 5 ns pulses); ``--max-duration`` shortens its pulses.

Run: python scripts/torch/bench_ppo.py [--batch 4096] [--rollout 16]
                                       [--compute-dtype bfloat16] [--device cpu]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from _bench_util import add_device_arg, timed, where, write_json  # noqa: E402
from spintorque_tpu_torch.parallel import resolve_device  # noqa: E402
from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig  # noqa: E402
from spintorque_tpu_torch.parallel import random_policy  # noqa: E402
from spintorque_tpu_torch.rl import PPOConfig, PPOTrainer  # noqa: E402

IDENTITY_RTOL = 1e-9


def snapshot(ts):
    """Copies of the network's parameters and of the optimizer's state tensors."""
    state = ts.optimizer.state_dict()["state"]
    return ([p.detach().clone() for p in ts.network.parameters()],
            [v.detach().clone() for k in sorted(state) for v in state[k].values()
             if isinstance(v, torch.Tensor)])


def equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=4)
    ap.add_argument("--compute-dtype", default="float32", choices=("float32", "bfloat16"),
                    help="network matmul dtype (PPOConfig.compute_dtype)")
    ap.add_argument("--shared-trunk", action="store_true",
                    help="one trunk for both heads (PPOConfig.shared_trunk)")
    ap.add_argument("--max-duration", type=float, default=SpinTorqueEnvConfig().max_duration,
                    help="the env's longest pulse (s)")
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--out", default=None, help="also write the record here")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device, None)

    env = SpinTorqueEnv(batch_size=args.batch, device=dev,
                        config=SpinTorqueEnvConfig(dtype="float32",
                                                   max_duration=args.max_duration))
    cfg = PPOConfig(rollout_steps=args.rollout, num_epochs=args.epochs,
                    num_minibatches=args.minibatches, compute_dtype=args.compute_dtype,
                    shared_trunk=args.shared_trunk)
    trainer = PPOTrainer(env, cfg)
    state = {"ts": trainer.init(0)}

    def run(fn, label):
        t0 = time.perf_counter()
        t = timed(fn, iters=args.iters, warmup=args.warmup, device=dev)
        print(f"# {label}: {t * 1e3:.3f} ms a call ({time.perf_counter() - t0:.1f} s with "
              f"warm-up)", file=_sys.stderr, flush=True)
        return t

    results = {
        "batch": args.batch,
        "rollout_steps": args.rollout,
        "compute_dtype": args.compute_dtype,
        "shared_trunk": args.shared_trunk,
        "use_cuda_kernel": dev.type == "cuda",
        "backend": dev.type,
        "card": where(dev),
    }
    steps_per_update = args.rollout * args.batch

    # --- the three programs of the in-situ split ------------------------------
    def full():
        state["ts"], _ = trainer.train_step(state["ts"])

    def no_update(network, optimizer, traj, last_obs, perms):
        keep = sum(v.float().mean() for v in traj.values()) + last_obs.float().mean()
        losses = torch.zeros((args.epochs, args.minibatches), device=dev) + keep * 1e-30
        return losses, dict(pg_loss=losses, v_loss=losses, entropy=losses)

    def ablated():  # the same step, the update ablated in place
        trainer.update_from_traj = no_update  # the instance's attribute shadows the method
        try:
            full()
        finally:
            del trainer.update_from_traj

    policy = random_policy(env)
    generator = torch.Generator(device=dev).manual_seed(1)

    def env_only():  # env steps alone (no policy network), random actions
        ts = state["ts"]
        env_state, obs, rewards = ts.env_state, ts.obs, []
        for _ in range(args.rollout):
            env_state, out = env.step(env_state, policy(None, obs, generator))
            obs = out.obs
            rewards.append(out.reward.mean())
        state["ts"] = dataclasses.replace(ts, env_state=env_state, obs=obs)
        return torch.stack(rewards).mean()

    # Each warmed up, then timed in turns, forth and back (ABC CBA): a drift
    # of the host's speed over the run cancels from the marginals.
    programs = {"train_step": full, "ablated": ablated, "env_only": env_only}
    moved = {name: [] for name in programs}  # per run: (parameters changed, Adam changed)
    blocks = {name: [] for name in programs}

    def block(name, iters):
        before = snapshot(state["ts"])
        t = timed(programs[name], iters=iters, warmup=0, device=dev)
        after = snapshot(state["ts"])
        moved[name].append((not equal(before[0], after[0]), not equal(before[1], after[1])))
        return t

    for name in programs:
        if args.warmup:
            block(name, args.warmup)
    for name in [*programs, *reversed(list(programs))]:
        blocks[name].append(block(name, args.iters))
    t_full, t_noupd, t_env = (sum(blocks[n]) / len(blocks[n]) for n in programs)
    for name, label in (("train_step", "train_step"), ("ablated", "train_step(update ablated)"),
                        ("env_only", "env_only")):
        print(f"# {label}: {[round(t * 1e3, 3) for t in blocks[name]]} ms a call in turns",
              file=_sys.stderr, flush=True)
    full_moves = all(params for params, _ in moved["train_step"])
    ablated_still = not any(any(run) for run in moved["ablated"])
    results["train_step_ms"] = t_full * 1e3
    results["train_env_steps_per_s"] = steps_per_update / t_full
    results["train_step_update_ablated_ms"] = t_noupd * 1e3
    results["update_in_situ_ms"] = (t_full - t_noupd) * 1e3
    results["env_only_ms"] = t_env * 1e3
    results["env_only_steps_per_s"] = steps_per_update / t_env
    results["turns_ms"] = {n: [t * 1e3 for t in blocks[n]] for n in programs}

    # --- rollout only --------------------------------------------------------
    def rollout_only():
        state["ts"], _ = trainer.collect(state["ts"])

    t_roll = run(rollout_only, "rollout")
    results["rollout_ms"] = t_roll * 1e3
    results["rollout_env_steps_per_s"] = steps_per_update / t_roll

    # --- update only: the production post-rollout program on one frozen
    # trajectory (it moves the network; nothing after it is timed) -----------
    frozen, traj = trainer.collect(state["ts"])
    t_upd = run(lambda: trainer.update(frozen, traj), "update_only")
    results["update_only_isolated_ms"] = t_upd * 1e3

    # The additive in-situ split (sums to train_step_ms by construction; the
    # isolated rollout and update above are separate programs, not a split).
    results["phases_in_situ_ms"] = {
        "env_steps": results["env_only_ms"],
        "policy_marginal": (t_noupd - t_env) * 1e3,
        "update_marginal": results["update_in_situ_ms"],
    }
    results["phases_sum_ms"] = sum(results["phases_in_situ_ms"].values())
    results["phases_sum_vs_full_pct"] = 100.0 * results["phases_sum_ms"] / results["train_step_ms"]
    results["train_vs_rollout_only_pct"] = 100.0 * t_roll / t_full
    results["identity_rel_err"] = (abs(results["phases_sum_ms"] - results["train_step_ms"])
                                   / results["train_step_ms"])
    results["ablated_step_leaves_network_and_optimizer"] = ablated_still
    results["full_step_moves_parameters"] = full_moves
    results["recorded"] = time.strftime("%Y-%m-%d")
    print(json.dumps(results), flush=True)
    if args.out:
        write_json(args.out, results)
    results["ok"] = (results["identity_rel_err"] <= IDENTITY_RTOL and ablated_still
                     and full_moves)
    return results


if __name__ == "__main__":
    _sys.exit(0 if main()["ok"] else 1)
