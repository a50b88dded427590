"""Headline benchmark: env-steps/s/chip on the vectorized SpinTorque-v0 env.

PyTorch counterpart of bench.py. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

The configuration follows BASELINE.json's north-star metric: 4096
vectorized SpinTorque-v0 envs (default physics: STT-MRAM, thermal on, RK4,
max_duration 5 ns), random continuous actions over the whole action space,
in steady state on the card. The measured program is
``utils.measure_env_throughput``'s: programs of 16 eager env steps (the
PPO rollout length), 12 warm-up programs, then 3 blocks of 8 programs with
one synchronize a block, the same program as chip_smoke.py's main-path
rate, so the two agree when they come from one process.

Where bench.py takes the median over 3 fresh compiles (Mosaic's schedules
vary between compiles), this program takes it over 3 fresh envs at ONE
fixed seed: eager torch compiles nothing, and K1's time moves ~30% between
input draws, which a fixed seed holds still. ``per_compile_medians``, the
JAX key, holds each fresh env's median block rate. ``use_cuda_kernel``
stands where bench.py has ``use_pallas``: whether the pulse kernel library
built and its probe passed (``cuda_kernel_available``; the env on the card
launches K1 and never falls back). Under torchrun every rank steps its
rows of the global batch on ``make_mesh()`` (the pulse is then K5), and
the global rate over the slowest rank is divided by the world size, as
bench.py divides by ``jax.device_count()``. A batch that does not divide
the ranks raises, as bench.py's does
(``spintorque_tpu/utils/benchmark.py:86``).

Baseline: the reference's measured 1.802 s/step single env on CPU
(quality_gates_report.json "Performance") = 0.555 env-steps/s.

Run: python scripts/torch/bench.py [--device cpu]
     torchrun --nproc_per_node N scripts/torch/bench.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from _bench_util import add_device_arg, where  # noqa: E402
from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig  # noqa: E402
from spintorque_tpu_torch.ops.cuda_integrator import cuda_kernel_available  # noqa: E402
from spintorque_tpu_torch.parallel import initialize, make_mesh, resolve_device  # noqa: E402
from spintorque_tpu_torch.utils import measure_env_throughput  # noqa: E402

METRIC = "env_steps_per_s_per_chip_4096envs_SpinTorque-v0"
REFERENCE_STEPS_PER_S = 1.0 / 1.802  # reference quality-gate measurement
FRESH_ENVS = 3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--batch", type=int, default=4096, help="global env batch")
    ap.add_argument("--max-duration", type=float, default=SpinTorqueEnvConfig().max_duration,
                    help="longest pulse of the action space (s)")
    ap.add_argument("--warmup", type=int, default=12, help="warm-up programs per env")
    ap.add_argument("--blocks", type=int, default=3, help="timed blocks per env")
    ap.add_argument("--iters-per-block", type=int, default=8, help="16-step programs a block")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    initialize()  # joins torchrun's process group; nothing in one process
    mesh = make_mesh(device=args.device) if dist.is_initialized() else None
    dev = resolve_device(args.device, mesh)
    use_cuda_kernel = dev.type == "cuda" and cuda_kernel_available()
    cfg = SpinTorqueEnvConfig(dtype="float32", max_duration=args.max_duration)

    per_env = []
    for _ in range(FRESH_ENVS):
        env = SpinTorqueEnv(batch_size=args.batch, config=cfg, device=dev, mesh=mesh)
        rates, _ = measure_env_throughput(env, warmup=args.warmup, blocks=args.blocks,
                                          iters_per_block=args.iters_per_block, seed=0)
        rates.sort()
        per_env.append(rates[len(rates) // 2])
    per_env.sort()
    n_chips = 1 if mesh is None else mesh.shape["data"] * mesh.shape["model"]
    value = per_env[len(per_env) // 2] / n_chips
    out = {
        "metric": METRIC,
        "value": value,
        "unit": "env-steps/s/chip",
        "vs_baseline": value / REFERENCE_STEPS_PER_S,
        "use_cuda_kernel": use_cuda_kernel,
        "backend": dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "per_compile_medians": [r / n_chips for r in per_env],
        "batch": args.batch,
        "chips": n_chips,
        "card": where(dev),
    }
    if mesh is None or dist.get_rank() == 0:
        print(json.dumps(out), flush=True)
    out["ok"] = value > 0
    return out


if __name__ == "__main__":
    _sys.exit(0 if main()["ok"] else 1)
