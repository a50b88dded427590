"""Verification on the card of the pulse kernel's thermal distribution.

PyTorch counterpart of scripts/verify_pallas_thermal.py, with its setup:
Heun with the ``physical`` noise mode (it scales with 1/sqrt(dt): visible
deflections), B=4096 envs from +z, 0.1 ns pulses at zero current,
``max_substeps`` 256, 300 K, V = 1e-24 m^3, seed 0. It checks the final
states are finite, two-sided in x and in y, of mean ~ 0 in x (under
3 std / sqrt(B)), isotropic (x / y std ratio in [0.8, 1.25]), and not all
silently reset to the pole; any failure exits 1. Where the JAX program
prints SKIP and exits 0 without its device, this one raises without a
card unless ``--device cpu`` is given (it then checks the kernel's plain
version, which draws the same Philox stream).

Run: python scripts/torch/verify_thermal.py [--device cpu]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _bench_util import add_device_arg, bench_params, where  # noqa: E402
from spintorque_tpu_torch.parallel import resolve_device  # noqa: E402
from spintorque_tpu_torch.physics import IntegratorConfig, integrate_pulse  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--temperature", type=float, default=300.0, help="K")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device, None)
    B = args.batch
    params = bench_params(dev, volume=1e-24)
    cfg = IntegratorConfig(method="heun", thermal=True, noise_mode="physical", max_substeps=256)
    ones, zeros = (torch.full((B,), v, dtype=torch.float32, device=dev) for v in (1.0, 0.0))
    res = integrate_pulse((zeros, zeros.clone(), ones), torch.full_like(ones, 1e-10), zeros, params,
                          cfg, seed=0, temperature=args.temperature)
    px, py, pz = (c.cpu().numpy() for c in res.m)

    checks = {
        "finite": bool(np.isfinite(px).all() and np.isfinite(py).all()),
        "two-sided x": bool((px > 1e-5).any() and (px < -1e-5).any()),
        "two-sided y": bool((py > 1e-5).any() and (py < -1e-5).any()),
        "mean ~ 0 (|mean| < 3 std/sqrt(B))":
            bool(abs(px.mean()) < 3 * px.std() / np.sqrt(B) + 1e-9),
        "x/y isotropy (std ratio in [0.8, 1.25])":
            bool(0.8 < px.std() / max(py.std(), 1e-12) < 1.25),
        "no silent pole resets": not bool((pz == 1.0).all()),
    }
    for name, ok in checks.items():
        print(f"  {name}: {'OK' if ok else 'FAIL'}")
    ok = all(checks.values())
    record = dict(backend=dev.type, card=where(dev), batch=B, temperature=args.temperature,
                  substeps=int(res.n_substeps.max()), checks=checks,
                  thermal_tilt_std=float(px.std()), std_ratio_x_over_y=float(px.std() / py.std())
                  if py.std() > 0 else None, failed_envs=int(res.failed.sum()), ok=ok)
    print("thermal tilt std:", record["thermal_tilt_std"])
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    _sys.exit(0 if main()["ok"] else 1)
