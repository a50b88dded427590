"""Adaptive-solver analysis: explicit RK45 against the order-5 Radau IIA path.

PyTorch counterpart of examples/stiff_analysis.py. A high-damping
relaxation whose fast precession caps the explicit solver's step size,
while Radau's dt grows to dt_max once the transient decays: a batch of
random initial conditions integrating in lockstep, each with its own
(t, dt). Plain torch on the card: the adaptive loops launch no kernel of
the port's own.

Run: python examples/torch/stiff_analysis.py [--device cpu]
"""

import os as _os
import sys as _sys

_ROOT = _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
_sys.path.insert(0, _ROOT)

import argparse
import time

import numpy as np
import torch

from spintorque_tpu_torch.parallel import resolve_device
from spintorque_tpu_torch.physics import integrate_adaptive, params_from_dict

DEVICE = dict(saturation_magnetization=800e3, damping=0.5,  # overdamped: stiff
              uniaxial_anisotropy=1.2e6, volume=1e-23, polarization=0.7,
              easy_axis=[0.0, 0.0, 1.0])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--span", type=float, default=5e-9)
    ap.add_argument("--rtol", type=float, default=1e-6)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device, None)
    dtype = torch.float32
    params = params_from_dict(DEVICE, dtype=dtype, device=dev)
    g = torch.Generator().manual_seed(0)
    m = torch.randn((args.batch, 3), generator=g, dtype=dtype)
    m = (m / m.norm(dim=-1, keepdim=True)).to(dev)
    m0 = (m[:, 0], m[:, 1], m[:, 2])
    spans = torch.full((args.batch,), args.span, dtype=dtype, device=dev)
    cur = torch.zeros((args.batch,), dtype=dtype, device=dev)

    results, out = {}, {}
    for method in ("rk45", "radau"):
        t0 = time.perf_counter()
        res = integrate_adaptive(m0, spans, cur, params, rtol=args.rtol,
                                 atol=args.rtol * 1e-3, dt_max=5e-10, method=method)
        steps = res.n_steps.cpu().numpy()  # waits for the card
        wall = time.perf_counter() - t0
        ok = bool(res.success.all())
        results[method] = res
        out[method] = {"success": ok, "steps_mean": float(steps.mean()),
                       "rejected_mean": float(res.n_rejected.float().mean()),
                       "iterations": res.iterations, "wall_s": wall}
        print(f"{method:6s}: accepted steps mean {steps.mean():7.1f} "
              f"(min {steps.min()}, max {steps.max()}), "
              f"rejected {out[method]['rejected_mean']:.1f}, success={ok}, wall {wall:.2f}s")

    a = torch.stack(results["rk45"].m, dim=-1).cpu().numpy()
    b = torch.stack(results["radau"].m, dim=-1).cpu().numpy()
    diff = float(np.abs(a - b).max())
    # Everything relaxes to the easy axis; the two steppers must agree.
    frac_up = float((b[:, 2] > 0).mean())
    print(f"\nmax |rk45 - radau| over the batch: {diff:.2e}")
    print(f"relaxed to +z: {frac_up:.0%}, to -z: {1 - frac_up:.0%} "
          f"(basin split of the random initial conditions)")
    ratio = out["rk45"]["steps_mean"] / max(1.0, out["radau"]["steps_mean"])
    print(f"explicit/implicit accepted-step ratio: {ratio:.1f}x (the A-stability payoff)")
    return {**out, "max_diff": diff, "frac_up": frac_up, "step_ratio": ratio}


if __name__ == "__main__":
    main()
