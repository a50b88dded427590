"""Train a PPO policy on the card and record the learning curve.

PyTorch counterpart of examples/train_ppo.py. The device config is the
deterministic easy-switching regime (polarization=1e-12, damping=0.1: the
simplified-STT term is comparable to precession, so the current's sign
selects the final pole). The learned policy reads the target's sign out of
the observation; success climbs from ~30% (random) to ~100% within a
handful of updates.

Run: python examples/torch/train_ppo.py [--updates N] [--batch B] [--out FILE] [--device cpu]
"""

import os as _os
import sys as _sys

_ROOT = _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
_sys.path.insert(0, _ROOT)

import argparse
import json

from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu_torch.rl import PPOConfig, PPOTrainer
from spintorque_tpu_torch.utils.host import card_line

ROLLOUT_STEPS = 8
LOG_EVERY = 2


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--updates", type=int, default=40)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--compute-dtype", default="float32", choices=("float32", "bfloat16"),
                    help="network matmul dtype (the bf16 learning gate)")
    ap.add_argument("--shared-trunk", action="store_true",
                    help="one trunk for both heads (the shared-trunk gate)")
    ap.add_argument("--out", default="", help="where to write the curve (under build/)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    env = SpinTorqueEnv(
        batch_size=args.batch,
        config=SpinTorqueEnvConfig(include_thermal=False, max_duration=1e-10, max_steps=4,
                                   dtype="float32"),
        device_params={"polarization": 1e-12, "damping": 0.1},
        device=args.device,
    )
    trainer = PPOTrainer(
        env,
        PPOConfig(rollout_steps=ROLLOUT_STEPS, num_epochs=4, num_minibatches=4,
                  hidden_sizes=(64, 64), learning_rate=1e-3, ent_coef=0.01,
                  compute_dtype=args.compute_dtype, shared_trunk=args.shared_trunk),
    )
    curve = []

    def log(i, m):
        curve.append({"update": i, "success_rate": m["success_rate"],
                      "mean_reward": m["mean_reward"]})
        print(f"update {i:3d}: reward={m['mean_reward']:8.3f} "
              f"success={m['success_rate']:.3f}")

    _, summary = trainer.train(total_timesteps=args.updates * ROLLOUT_STEPS * args.batch,
                               log_every=LOG_EVERY, callback=log)
    where = card_line() if env.device.type == "cuda" else "cpu"
    print(f"{summary['steps_per_s']:,.0f} train env-steps/s  [{where}]")
    print(summary)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"curve": curve, "summary": summary, "where": where}, f, indent=1)
        print(f"learning curve -> {args.out}")
    return {"batch": args.batch, "curve": curve, "summary": summary, "where": where}


if __name__ == "__main__":
    main()
