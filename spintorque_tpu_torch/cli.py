"""Command-line interface: info / train / eval / benchmark / sweep / config /
serve.

PyTorch counterpart of ``spintorque_tpu/cli.py``, with the same
subcommands, flags and output keys, plus ``--device {cuda,cpu}`` on the
subcommands that compute (default ``cuda``; without a card it raises and
does not fall back to the CPU). ``train`` runs the port's PPO trainer (the
pulse kernel on the card), across the ranks of a process group when
started under ``torchrun`` with more than one rank; ``--backend sb3``
trains stable-baselines3 through the Gymnasium adapter when it is
installed.

    spintorque-tpu-torch benchmark --batch-size 4096
    python -m spintorque_tpu_torch.cli train --timesteps 200000 --output policy.pt
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np


def _world_size() -> int:
    from .parallel import process_info

    return process_info()["process_count"]


def _rank() -> int:
    from .parallel import process_info

    return process_info()["process_index"]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_info(args) -> int:
    import torch

    from . import __version__
    from .devices import DEVICE_TYPES
    from .envs import SpinTorqueEnvConfig
    from .registration import _SPECS, NAMESPACE

    print(f"spintorque-tpu-torch {__version__}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = ", ".join(torch.cuda.get_device_name(i) for i in range(n))
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  cuda devices: {n}"
          + (f" ({names})" if n else ""))
    print("\nRegistered environments:")
    for name, _, steps, _ in _SPECS:
        print(f"  {NAMESPACE + '/' + name:40s} max_episode_steps={steps}")
    print("\nDevice types:", ", ".join(DEVICE_TYPES))
    cfg = SpinTorqueEnvConfig()
    print("\nSpinTorque-v0 defaults:")
    for k, v in cfg._asdict().items():
        print(f"  {k:24s} {v}")
    return 0


def _ppo_config(c):
    """The ``PPOConfig`` of a configuration's training section."""
    from .rl import PPOConfig

    t = c.training
    return PPOConfig(
        rollout_steps=t.rollout_steps,
        num_epochs=t.num_epochs,
        num_minibatches=t.num_minibatches,
        learning_rate=t.learning_rate,
        gamma=t.gamma,
        gae_lambda=t.gae_lambda,
        clip_eps=t.clip_eps,
        hidden_sizes=tuple(t.hidden_sizes),
    )


def cmd_train(args) -> int:
    from .config import ConfigManager
    from .rl import PPOTrainer

    manager = ConfigManager(args.config)
    c = manager.config
    if args.timesteps:
        c.training.total_timesteps = args.timesteps
    if args.batch_size:
        c.environment.batch_size = args.batch_size
    if args.env and args.env != "SpinTorque-v0":
        print(f"train currently targets SpinTorque-v0 (got {args.env})", file=sys.stderr)

    if args.backend == "sb3":
        return _train_sb3(args, c)

    # torchrun's ranks (WORLD_SIZE > 1) join without a flag; a
    # coordinator address is a TCP rendezvous for the ranks torchrun's
    # environment (or the caller's) numbers.
    if (c.compute.distributed or c.compute.coordinator_address
            or int(os.environ.get("WORLD_SIZE", "1")) > 1):
        from .parallel import initialize

        address = c.compute.coordinator_address
        initialize(init_method=f"tcp://{address}" if address else None)

    # One card per rank: a mesh over the ranks when there is more than one.
    mesh = None
    if _world_size() > 1:
        from .parallel import make_mesh

        mesh = make_mesh(
            n_data=c.compute.mesh_data or None,
            n_model=max(1, c.compute.mesh_model),
            device=args.device,
        )
    env = manager.make_env(device=None if mesh is not None else args.device, mesh=mesh)
    trainer = PPOTrainer(env, _ppo_config(c), mesh=mesh)

    def log(i, metrics):
        line = " ".join(f"{k}={v:.4g}" for k, v in sorted(metrics.items()))
        print(f"update {i}: {line}")

    ts, summary = trainer.train(
        c.training.total_timesteps, seed=c.training.seed,
        log_every=args.log_every, callback=log,
    )
    print(json.dumps({k: v for k, v in summary.items()}, default=float))

    if args.output:
        from .utils.checkpoint import save_params

        # Every rank joins the gather of a tensor-parallel network's
        # shards; then global rank 0 writes the whole parameters.
        state = ts.network.full_state_dict()
        if _rank() == 0:
            save_params(args.output, state)
            print(f"saved policy parameters to {args.output}")
    return 0


def _train_sb3(args, c) -> int:
    try:
        import gymnasium as gym
        import stable_baselines3 as sb3
    except ImportError:
        print("stable-baselines3 not installed; use --backend native", file=sys.stderr)
        return 1
    import spintorque_tpu_torch  # noqa: F401  (registers env ids)
    from .registration import NAMESPACE

    algo = {"ppo": sb3.PPO, "sac": sb3.SAC, "td3": sb3.TD3,
            "dqn": sb3.DQN}.get(args.algorithm)
    if algo is None:
        print(f"Unknown sb3 algorithm {args.algorithm}", file=sys.stderr)
        return 1
    # DQN needs a discrete action space (the adapter's discrete mode).
    kwargs = {"action_mode": "discrete"} if args.algorithm == "dqn" else {}
    env = gym.make(f"{NAMESPACE}/{args.env or 'SpinTorque-v0'}", device=args.device, **kwargs)
    model = algo("MlpPolicy", env, verbose=1)
    t0 = time.time()
    model.learn(total_timesteps=c.training.total_timesteps)
    elapsed = time.time() - t0
    if args.output:
        model.save(args.output)
    print(f"trained {c.training.total_timesteps} steps in {elapsed:.1f}s "
          f"({c.training.total_timesteps / elapsed:.1f} steps/s)")
    return 0


def cmd_eval(args) -> int:
    import torch

    from .config import ConfigManager
    from .parallel import random_policy, rollout, summarize

    manager = ConfigManager(args.config)
    if args.batch_size:
        manager.config.environment.batch_size = args.batch_size
    env = manager.make_env(device=args.device)

    if args.model:
        from .rl import PPOTrainer
        from .utils.checkpoint import load_params

        trainer = PPOTrainer(env, _ppo_config(manager.config))
        network = load_params(args.model, target=trainer.make_network())

        def policy(net, obs, generator):
            env_action, _, log_prob, value = trainer.policy(net, obs, generator)
            return env_action, log_prob, value

        policy_params = network
    else:
        policy = random_policy(env)
        policy_params = None

    state, obs = env.reset(args.seed)
    generator = torch.Generator(device=env.device)
    generator.manual_seed(args.seed + 1)
    _sync(env.device)
    t0 = time.perf_counter()
    state, obs, traj = rollout(env, policy, policy_params, state, obs, generator,
                               args.episodes_steps)
    _sync(env.device)
    elapsed = time.perf_counter() - t0
    stats = {k: float(v) for k, v in summarize(traj).items()}
    stats["elapsed_s"] = elapsed
    stats["env_steps_per_s"] = traj.reward.numel() / elapsed
    print(json.dumps(stats))
    if args.output:
        Path(args.output).write_text(json.dumps(stats, indent=2))
    return 0


def _cmd_benchmark(args) -> int:
    from .envs import SpinTorqueEnv, SpinTorqueEnvConfig
    from .utils.benchmark import measure_env_throughput

    B = args.batch_size or 4096
    env = SpinTorqueEnv(
        batch_size=B,
        config=SpinTorqueEnvConfig(dtype="float32",
                                   include_thermal=not args.no_thermal),
        device=args.device,
    )
    # The same measurement program as chip_smoke.py's main path
    # (utils/benchmark.py): steady-state warmup, one device synchronize per
    # block of eager steps.
    rates, _ = measure_env_throughput(
        env,
        n_inner=args.inner,
        warmup=min(12, 2 * args.iters),
        blocks=1,
        iters_per_block=args.iters,
    )
    steps_per_s = rates[0]
    world = _world_size()
    result = {
        "batch_size": B,
        "backend": env.device.type,
        "devices": world,
        "env_steps_per_s": steps_per_s,
        "env_steps_per_s_per_chip": steps_per_s / world,
        "ms_per_batched_step": B / steps_per_s * 1e3,
    }
    print(json.dumps(result))
    return 0


def cmd_config(args) -> int:
    from .config import ConfigManager

    manager = ConfigManager(args.config)
    if args.action == "show":
        print(json.dumps(manager.config.to_dict(), indent=2, default=str))
    elif args.action == "validate":
        manager.validate()
        print("configuration valid")
    elif args.action == "save":
        if not args.output:
            print("--output required for save", file=sys.stderr)
            return 1
        manager.save(args.output)
        print(f"saved to {args.output}")
    return 0


def cmd_serve(args) -> int:
    from .deployment import ServingEndpoint

    ep = ServingEndpoint(
        host=args.host,
        port=args.port,
        refresh_interval=args.refresh_interval,
        run_device_checks=not args.no_device_checks,
        device=args.device,
    )
    print(f"serving health endpoint on {args.host}:{ep.port} "
          f"(/healthz /readiness /metrics /info)")
    try:
        ep.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_sweep(args) -> int:
    """Switching-probability phase diagram over a (current, duration) grid
    (research/sweeps.py): one batch through the pulse integrator, sharded
    over the ranks when there is more than one."""
    import torch

    from .devices import make_device_params
    from .parallel.mesh import resolve_device
    from .research.sweeps import switching_probability_diagram

    mesh = None
    if _world_size() > 1:
        from .parallel import make_mesh

        mesh = make_mesh(device=args.device)
    device = resolve_device(args.device, mesh)
    params = make_device_params(args.device_type, None, dtype=torch.float32,
                                device=device).llgs()
    currents = np.linspace(args.current_min, args.current_max, args.n_currents)
    durations = np.linspace(args.duration_min, args.duration_max, args.n_durations)
    out = switching_probability_diagram(
        params, currents, durations, n_ensemble=args.ensemble,
        temperature=args.temperature, seed=args.seed, mesh=mesh, device=device,
    )

    def _host(t):
        return t.cpu().numpy()

    def _jsonable(a):
        # NaN marks a grid point whose whole ensemble failed; bare NaN
        # tokens are invalid strict JSON, so emit null there.
        return np.where(np.isfinite(a), a.astype(object), None).tolist()

    result = {
        "device_type": args.device_type,
        "temperature": args.temperature,
        "ensemble": args.ensemble,
        "currents": _host(out["currents"]).tolist(),
        "durations": _host(out["durations"]).tolist(),
        "p_switch": _jsonable(_host(out["p_switch"])),
        "failed_fraction": _host(out["failed_fraction"]).tolist(),
    }
    if _rank() != 0:  # every rank holds the same diagram
        return 0
    text = json.dumps(result, indent=2)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text)
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def _add_device(sp) -> None:
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where to compute (default cuda; no fallback to the CPU)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spintorque-tpu-torch",
        description="Spintronic RL environment engine: PyTorch with CUDA kernels",
    )
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("info", help="environment and backend info")
    sp.set_defaults(func=cmd_info)

    sp = sub.add_parser("train", help="train an RL agent")
    sp.add_argument("--env", default="SpinTorque-v0")
    sp.add_argument("--algorithm", default="ppo")
    sp.add_argument("--backend", choices=["native", "sb3"], default="native")
    sp.add_argument("--timesteps", type=int, default=None)
    sp.add_argument("--batch-size", type=int, default=None)
    sp.add_argument("--config", default=None)
    sp.add_argument("--output", default=None)
    sp.add_argument("--log-every", type=int, default=10)
    _add_device(sp)
    sp.set_defaults(func=cmd_train)

    sp = sub.add_parser("eval", help="evaluate a policy (or random)")
    sp.add_argument("--model", default=None)
    sp.add_argument("--episodes-steps", type=int, default=200,
                    help="rollout horizon in env steps")
    sp.add_argument("--batch-size", type=int, default=None)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--config", default=None)
    sp.add_argument("--output", default=None)
    _add_device(sp)
    sp.set_defaults(func=cmd_eval)

    sp = sub.add_parser("benchmark", help="measure env throughput")
    sp.add_argument("--batch-size", type=int, default=4096)
    sp.add_argument("--iters", type=int, default=5)
    sp.add_argument("--inner", type=int, default=16)
    sp.add_argument("--no-thermal", action="store_true")
    _add_device(sp)
    sp.set_defaults(func=_cmd_benchmark)

    sp = sub.add_parser(
        "sweep",
        help="switching-probability phase diagram over a (J, duration) grid",
    )
    sp.add_argument("--device-type", default="stt_mram")
    sp.add_argument("--current-min", type=float, default=-4e6)
    sp.add_argument("--current-max", type=float, default=0.0)
    sp.add_argument("--n-currents", type=int, default=16)
    sp.add_argument("--duration-min", type=float, default=1e-10)
    sp.add_argument("--duration-max", type=float, default=2e-9)
    sp.add_argument("--n-durations", type=int, default=16)
    sp.add_argument("--ensemble", type=int, default=64)
    sp.add_argument("--temperature", type=float, default=300.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--output", default=None, help="write JSON here")
    _add_device(sp)
    sp.set_defaults(func=cmd_sweep)

    sp = sub.add_parser("config", help="show/validate/save configuration")
    sp.add_argument("action", choices=["show", "validate", "save"])
    sp.add_argument("--config", default=None)
    sp.add_argument("--output", default=None)
    sp.set_defaults(func=cmd_config)

    sp = sub.add_parser(
        "serve", help="HTTP health/readiness/metrics endpoint"
    )
    sp.add_argument("--host", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=8080)
    sp.add_argument("--refresh-interval", type=float, default=60.0)
    sp.add_argument("--no-device-checks", action="store_true",
                    help="skip device-touching health probes (CI/sidecar)")
    _add_device(sp)
    sp.set_defaults(func=cmd_serve)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
