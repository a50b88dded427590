"""Quickstart: the vectorized functional API at batch 4096, on the card.

PyTorch counterpart of examples/quickstart_functional.py: the default
SpinTorqueEnv (thermal, RK4) steps 4096 envs through random pulses of
0.1-2 ns and times 10 steps.

Run: python examples/torch/quickstart_functional.py [--device cpu]
"""

import os as _os
import sys as _sys

_ROOT = _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
_sys.path.insert(0, _ROOT)

import argparse
import time

import torch

from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu_torch.utils.host import card_line


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--max-pulse", type=float, default=2e-9, help="longest pulse (s)")
    args = ap.parse_args(argv)

    B = args.batch
    env = SpinTorqueEnv(batch_size=B, config=SpinTorqueEnvConfig(), device=args.device)
    dev = env.device
    state, obs = env.reset(0)
    print(f"reset: obs {tuple(obs.shape)} on {dev}")

    g = torch.Generator(device=dev).manual_seed(1)
    u = torch.rand((2, B), generator=g, device=dev)
    actions = torch.stack([-2e6 + 4e6 * u[0], 1e-10 + (args.max_pulse - 1e-10) * u[1]], dim=-1)
    state, ts = env.step(state, actions)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, ts = env.step(state, actions)
    _sync(dev)
    dt = (time.perf_counter() - t0) / args.steps
    where = card_line() if dev.type == "cuda" else "cpu"
    reward = float(ts.reward.mean())
    success = float(ts.info["is_success"].float().mean())
    print(f"step: {dt * 1e3:.2f} ms for {B} envs -> {B / dt:,.0f} env-steps/s  [{where}]")
    print(f"mean reward {reward:.4f}, success rate {success:.4f}")
    return {"batch": B, "steps": args.steps, "ms_per_step": dt * 1e3,
            "env_steps_per_s": B / dt, "mean_reward": reward, "success_rate": success,
            "where": where}


if __name__ == "__main__":
    main()
