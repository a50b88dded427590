"""K6 (bf16 stage arithmetic, ``IntegratorConfig.bf16_rhs``) against K1:
speed, and deterministic accuracy as the angle between their final states.

PyTorch counterpart of scripts/bench_bf16.py, with its workload: B=4096
random unit states, every pulse 1 ns (1000 substeps), RK4 with
``max_substeps`` 1024, ``noise_mode`` reference, ``rk4_noise``
per_substep (seed 7 when thermal). Speed at -1e6 A/m^2, deterministic and
thermal, float32 (K1) and bf16_rhs (K6), 3 timed rounds each (12 warm-up
and 20 timed calls a round; the JAX program recompiles before each round,
eager torch has nothing to recompile). Accuracy at J=0 (precession and
damping: strong torque would snap both onto the pole and hide the
rounding): mean, p99 and max angle between the deterministic K1 and K6
states. ``thermal_speedup_bf16_over_f32`` is the best f32 round over the
best bf16 round. On the CPU both are the plain loop (its bf16 branch for
K6).

Run: python scripts/torch/bench_bf16.py [--device cpu]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _bench_util import (  # noqa: E402
    add_device_arg, bench_params, setup_pulse_inputs, timed, where, write_json,
)
from spintorque_tpu_torch.parallel import resolve_device  # noqa: E402
from spintorque_tpu_torch.physics import IntegratorConfig, integrate_pulse  # noqa: E402

THERMAL_SEED = 7
ROUNDS = 3


def angles_deg(a, b) -> np.ndarray:
    """Angle (degrees) between the rows of two (B, 3) arrays of unit states."""
    cos = np.clip(np.sum(np.asarray(a, np.float64) * np.asarray(b, np.float64), axis=-1),
                  -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def final_state(result) -> np.ndarray:
    return torch.stack(result.m, dim=-1).cpu().numpy()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--span", type=float, default=1e-9, help="every pulse's span (s)")
    ap.add_argument("--warmup", type=int, default=12)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the record here")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device, None)
    p = bench_params(dev)
    B = args.batch
    m0, _, _ = setup_pulse_inputs(B, 0, device=dev)
    spans = torch.full((B,), args.span, dtype=torch.float32, device=dev)
    cur = torch.full((B,), -1e6, dtype=torch.float32, device=dev)
    cur0 = torch.zeros((B,), dtype=torch.float32, device=dev)

    results, finals = {}, {}
    for thermal in (False, True):
        seed = THERMAL_SEED if thermal else None
        for bf16 in (False, True):
            cfg = IntegratorConfig(method="rk4", max_substeps=1024, thermal=thermal,
                                   noise_mode="reference", rk4_noise="per_substep",
                                   bf16_rhs=bf16)
            trials = [timed(lambda: integrate_pulse(m0, spans, cur, p, cfg, seed=seed),
                            iters=args.iters, warmup=args.warmup, device=dev)
                      for _ in range(ROUNDS)]
            label = f"{'thermal' if thermal else 'det'}_{'bf16' if bf16 else 'f32'}"
            if not thermal:
                finals[label] = final_state(integrate_pulse(m0, spans, cur0, p, cfg))
            results[label] = {"ms_per_pulse_batch_trials": [t * 1e3 for t in trials]}
            print(label, [round(t * 1e3, 4) for t in trials], "ms", flush=True)

    ang = angles_deg(finals["det_f32"], finals["det_bf16"])
    accuracy = {
        "workload": f"deterministic J=0 precession, {args.span:g} s pulse, B={B}",
        "mean_angular_error_deg": float(ang.mean()),
        "p99_angular_error_deg": float(np.percentile(ang, 99)),
        "max_angular_error_deg": float(ang.max()),
    }
    print("accuracy:", accuracy, flush=True)
    best = {k: min(v["ms_per_pulse_batch_trials"]) for k, v in results.items()}
    record = {
        "backend": dev.type,
        "card": where(dev),
        "batch": B,
        "recorded": time.strftime("%Y-%m-%d"),
        "results": results,
        "accuracy_det_bf16_vs_f32": accuracy,
        "thermal_speedup_bf16_over_f32": best["thermal_f32"] / best["thermal_bf16"],
        "det_speedup_bf16_over_f32": best["det_f32"] / best["det_bf16"],
    }
    print(json.dumps(record), flush=True)
    if args.out:
        write_json(args.out, record)
    record["ok"] = bool(np.isfinite(ang).all())
    return record


if __name__ == "__main__":
    _sys.exit(0 if main()["ok"] else 1)
