"""Quickstart: the Gymnasium-compatible adapter.

PyTorch counterpart of examples/quickstart_gymnasium.py. Needs gymnasium;
the port's ids live under ``spintorque_torch/``.

Run: python examples/torch/quickstart_gymnasium.py [--device cpu]
"""

import os as _os
import sys as _sys

_ROOT = _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
_sys.path.insert(0, _ROOT)

import argparse

import gymnasium as gym

import spintorque_tpu_torch  # noqa: F401  (registers the spintorque_torch/ ids)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--max-duration", type=float, default=5e-9, help="longest pulse (s)")
    args = ap.parse_args(argv)

    env = gym.make("spintorque_torch/SpinTorque-v0", include_thermal_fluctuations=False,
                   max_duration=args.max_duration, device=args.device)
    obs, info = env.reset(seed=0)
    env.action_space.seed(0)
    total = 0.0
    for step in range(20):
        action = env.action_space.sample()
        obs, reward, terminated, truncated, info = env.step(action)
        total += reward
        if terminated or truncated:
            break
    print(f"episode finished after {step + 1} steps, return {total:.3f}, "
          f"alignment {info['current_alignment']:.3f}")
    return {"steps": step + 1, "return": float(total),
            "alignment": float(info["current_alignment"]),
            "terminated": bool(terminated), "truncated": bool(truncated)}


if __name__ == "__main__":
    main()
