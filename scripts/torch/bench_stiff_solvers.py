"""Stiff-solver quality ladder: Radau IIA (order 5) against the implicit
midpoint (order 2) and explicit RK5(4), with scipy's Radau as the external
baseline.

PyTorch counterpart of scripts/bench_stiff_solvers.py, on its case: the
stiff high-damping LLGS (Ms 800e3, alpha 0.5, Ku 1.2e6, V 1e-23, P 0.7,
+z), m0 (0.6, 0, 0.8), J = 0, a 5e-11 s span inside the precessional
transient (the post-transient state is an attractor, which would flatter
every method). In float64 on the program's device
(``physics.integrate_adaptive``, dt_max 5e-10, atol = rtol x 1e-3), it
records for each method and each rtol of ``--rtols`` (default 1e-6, 1e-8,
1e-10) the accepted and rejected steps and the TRUE error, the distance
from Radau at ``--ref-rtol`` (default 1e-12). scipy's
``solve_ivp(method="Radau")`` integrates the port's ``llgs_solver_rhs`` as
a float64 callback on the CPU at the first two rtols. The adaptive loops
are plain torch: no kernel of the port's own runs. A solve that does not
reach its span fails the program (``ok`` false, exit 1).

Run: python scripts/torch/bench_stiff_solvers.py [--device cpu]
         [--rtols 1e-6 1e-8] [--ref-rtol 1e-12]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _bench_util import add_device_arg, sync, where, write_json  # noqa: E402
from spintorque_tpu_torch.parallel import resolve_device  # noqa: E402
from spintorque_tpu_torch.physics import (  # noqa: E402
    integrate_adaptive, llgs_solver_rhs, params_from_dict,
)

STIFF = dict(saturation_magnetization=800e3, damping=0.5, uniaxial_anisotropy=1.2e6,
             volume=1e-23, polarization=0.7, easy_axis=[0.0, 0.0, 1.0])
M0 = np.array([0.6, 0.0, 0.8])
SPAN = 5e-11  # inside the precessional transient (see the docstring)
RTOLS = (1e-6, 1e-8, 1e-10)
METHODS = ("radau", "midpoint", "rk45")


def run_ours(method, rtol, atol, device):
    """(final m, accepted, rejected, success, wall s) of one float64 solve."""
    params = params_from_dict(STIFF, dtype=torch.float64, device=device)
    m0 = tuple(torch.tensor([M0[c]], dtype=torch.float64, device=device) for c in range(3))
    sync(device)
    t0 = time.perf_counter()
    r = integrate_adaptive(m0, torch.full((1,), SPAN, dtype=torch.float64, device=device),
                           torch.zeros((1,), dtype=torch.float64, device=device), params,
                           rtol=rtol, atol=atol, dt_max=5e-10, max_steps=2_000_000,
                           method=method)
    m = np.array([float(c[0]) for c in r.m])  # waits for the device
    return (m, int(r.n_steps[0]), int(r.n_rejected[0]), bool(r.success.all()),
            time.perf_counter() - t0)


def run_scipy_radau(rtol, atol):
    """(accepted steps, RHS evaluations, success) of scipy's Radau on the
    port's RHS, a float64 callback on the CPU."""
    from scipy.integrate import solve_ivp

    params = params_from_dict(STIFF, dtype=torch.float64, device="cpu")
    zero = torch.zeros((), dtype=torch.float64)

    def rhs(t, y):
        n = np.linalg.norm(y)
        y = y / n if n > 1e-12 else np.array([0.0, 0.0, 1.0])
        m = torch.from_numpy(np.ascontiguousarray(y, np.float64))
        return torch.stack(llgs_solver_rhs(m[0], m[1], m[2], zero, params)).numpy()

    sol = solve_ivp(rhs, (0.0, SPAN), M0, method="Radau", rtol=rtol, atol=atol, max_step=5e-10)
    return sol.t.size - 1, int(sol.nfev), bool(sol.success)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--rtols", type=float, nargs="+", default=list(RTOLS))
    ap.add_argument("--ref-rtol", type=float, default=1e-12,
                    help="rtol of the Radau reference the true errors are measured against")
    ap.add_argument("--out", default=None, help="also write the record here")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device, None)

    m_ref, n_ref, _, ok, wall = run_ours("radau", args.ref_rtol, args.ref_rtol * 1e-3, dev)
    failed = [] if ok else [("radau", args.ref_rtol)]
    print(f"reference radau rtol={args.ref_rtol:g}: acc={n_ref} ({wall:.2f} s)", flush=True)
    entries = []
    for method in METHODS:
        for rtol in args.rtols:
            m, nacc, nrej, ok, wall = run_ours(method, rtol, rtol * 1e-3, dev)
            if not ok:
                failed.append((method, rtol))
            entries.append({"method": method, "rtol": rtol, "accepted_steps": nacc,
                            "rejected_steps": nrej, "true_error": float(np.linalg.norm(m - m_ref)),
                            "success": ok, "wall_s": wall})
            print(f"{method:9s} rtol={rtol:g}: acc={nacc:6d} rej={nrej:4d} "
                  f"true_err={entries[-1]['true_error']:.3e} ({wall:.2f} s)", flush=True)
    scipy_rows = []
    for rtol in args.rtols[:2]:
        nacc, nfev, ok = run_scipy_radau(rtol, rtol * 1e-3)
        if not ok:
            failed.append(("scipy radau", rtol))
        scipy_rows.append({"rtol": rtol, "accepted_steps": nacc, "nfev": nfev})
        print(f"scipy Radau rtol={rtol:g}: acc={nacc} nfev={nfev}", flush=True)

    by = {(e["method"], e["rtol"]): e for e in entries}
    summary = {}
    if ("radau", 1e-6) in by:
        summary.update(radau_rtol1e6_steps=by[("radau", 1e-6)]["accepted_steps"],
                       radau_rtol1e6_true_error=by[("radau", 1e-6)]["true_error"])
    if ("midpoint", 1e-10) in by:
        summary.update(midpoint_rtol1e10_steps=by[("midpoint", 1e-10)]["accepted_steps"],
                       midpoint_rtol1e10_true_error=by[("midpoint", 1e-10)]["true_error"])
    record = {
        "bench": "stiff_solver_quality_ladder",
        "case": {
            "params": "Ms=800e3, alpha=0.5, Ku=1.2e6, V=1e-23, P=0.7",
            "m0": M0.tolist(), "span_s": SPAN, "current": 0.0,
            "reference": f"our radau @ rtol={args.ref_rtol:g} ({n_ref} steps)",
        },
        "platform": dev.type,
        "card": where(dev),
        "ladder": entries,
        "scipy_radau_baseline": scipy_rows,
        "summary": summary,
        "failed": [f"{m} rtol={r:g}" for m, r in failed],
    }
    print(json.dumps(record), flush=True)
    if args.out:
        write_json(args.out, record)
    record["ok"] = not failed
    return record


if __name__ == "__main__":
    _sys.exit(0 if main()["ok"] else 1)
