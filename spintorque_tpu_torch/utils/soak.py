"""Soak run of the headline env: the default SpinTorqueEnv at B=4096 under
full-range random actions for a set wall time, with health invariants
checked in every block.

PyTorch counterpart of ``scripts/soak_test.py``. Blocks of 16 eager steps
of ``parallel.random_policy`` (a ``torch.Generator`` on the env's device),
with one host read a block. Per block: observations and rewards finite,
every |m| within 1e-3 of 1 (a block that breaks either is a bad block), the
failed-solve fraction of each step (``~info["simulation_success"]``), and
the terminated and truncated counts. Failed solves are expected at a small
rate under full-range random actions: extreme (J, duration) pulses blow up
RK4 and the reference semantics keep the pre-step state (``failed``); the
invariant is that this path keeps the state finite and unit-norm. The run
is healthy with no bad block and a mean failed fraction under 5%.

    python -m spintorque_tpu_torch.utils.soak --seconds 60 [--device cpu]

writes its record (the JAX record's keys, plus the card) to
``build/soak.json`` and exits 1 when the run is unhealthy. The default
device is the card; without one it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional, Sequence

import torch

from ..envs.spin_torque import EnvState, SpinTorqueEnv, SpinTorqueEnvConfig
from ..parallel import random_policy
from .host import card_line

N_INNER = 16
HEALTHY_FAILED_FRACTION = 0.05


def _block(env: SpinTorqueEnv, policy, state: EnvState, obs, generator):
    """N_INNER steps on the device; returns the state, the obs and one
    (4 + N_INNER,) float64 tensor of the block's health numbers: ok, the
    terminated and truncated counts, the mean reward over the block, then
    the failed fraction of each step."""
    ok = torch.ones((), dtype=torch.bool, device=env.device)
    failed, rewards, term, trunc = [], [], 0, 0
    for _ in range(N_INNER):
        state, ts = env.step(state, policy(None, obs, generator))
        obs = ts.obs
        norm = torch.linalg.vector_norm(state.m, dim=-1)
        ok = (ok & torch.isfinite(ts.obs).all() & torch.isfinite(ts.reward).all()
              & ((norm - 1.0).abs() < 1e-3).all())
        failed.append((~ts.info["simulation_success"]).to(torch.float64).mean())
        rewards.append(ts.reward.to(torch.float64).mean())
        term = term + ts.terminated.sum()
        trunc = trunc + ts.truncated.sum()
    head = torch.stack([ok.to(torch.float64), term.to(torch.float64), trunc.to(torch.float64),
                        torch.stack(rewards).mean()])
    return state, obs, torch.cat([head, torch.stack(failed)])


def soak(
    env: SpinTorqueEnv,
    seconds: float = 60.0,
    warmup_blocks: int = 6,
    max_blocks: Optional[int] = None,
    state: Optional[EnvState] = None,
) -> Dict[str, Any]:
    """Run blocks of ``env`` for ``seconds`` of wall time (or ``max_blocks``
    blocks, whichever ends first) after ``warmup_blocks`` unchecked ones.
    Starts from ``env.reset(0)``, or from ``state`` when given. Returns
    the record; ``record["healthy"]`` is the verdict."""
    policy = random_policy(env)
    generator = torch.Generator(device=env.device).manual_seed(1)
    if state is None:
        state, obs = env.reset(0)
    else:
        obs = env.observe(state)
    for _ in range(warmup_blocks):
        state, obs, _ = _block(env, policy, state, obs, generator)
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)

    t0 = time.perf_counter()
    blocks = terms = truncs = bad_blocks = 0
    failed_fracs = []
    reward_mean = float("nan")
    while time.perf_counter() - t0 < seconds and (max_blocks is None or blocks < max_blocks):
        state, obs, health = _block(env, policy, state, obs, generator)
        ok, term, trunc, reward_mean, *per_step = health.tolist()  # the block's host read
        if not ok:
            bad_blocks += 1
            print(f"BAD BLOCK {blocks}: finite/unit-norm invariant violated", flush=True)
        failed_fracs.extend(per_step)
        terms += int(term)
        truncs += int(trunc)
        blocks += 1
    wall = time.perf_counter() - t0
    steps = blocks * N_INNER * env.batch_size
    failed_mean = sum(failed_fracs) / len(failed_fracs) if failed_fracs else float("nan")
    return {
        "backend": env.device.type,
        "card": card_line() if env.device.type == "cuda" else None,
        "batch": env.batch_size,
        "recorded": time.strftime("%Y-%m-%d"),
        "wall_s": wall,
        "blocks": blocks,
        "env_steps": steps,
        "env_steps_per_s": steps / wall if wall > 0 else float("nan"),
        "episodes_terminated": terms,
        "episodes_truncated": truncs,
        "bad_blocks": bad_blocks,
        "failed_solve_fraction_mean": failed_mean,
        "failed_solve_fraction_max": max(failed_fracs, default=float("nan")),
        "final_reward_mean": reward_mean,
        "healthy": blocks > 0 and bad_blocks == 0 and failed_mean < HEALTHY_FAILED_FRACTION,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join("build", "soak.json"))
    args = ap.parse_args(argv)

    env = SpinTorqueEnv(batch_size=4096, config=SpinTorqueEnvConfig(dtype="float32"),
                        device=args.device)
    record = soak(env, args.seconds)
    print(json.dumps(record), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=2)
    print("wrote", args.out)
    return 0 if record["healthy"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
