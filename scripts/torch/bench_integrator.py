"""Integrator micro-benchmark: the plain torch loop against the pulse kernel.

PyTorch counterpart of scripts/bench_integrator.py, whose "XLA" rows are
the plain loop here (``physics.integrator.integrate_pulse_plain``) and
whose "PALLAS" rows are the CUDA kernel K1 (``physics.integrate_pulse`` on
the card; on the CPU it runs the plain loop too). The workload is the JAX
program's: B=4096 random unit states, every pulse 1 ns (1000 substeps) at
1e2 A/m^2, RK4 with ``max_substeps`` 1024, deterministic and thermal
(seed 0); ms per batch and pulses/s for each, the deterministic max
|plain - kernel|, and the kernel thermal at B=16384 and 65536 (10 timed
calls each). Each row takes one untimed call, then ``--iters`` timed calls
(``--plain-iters`` for the plain loop, ~3 s a call on the card).

Run: python scripts/torch/bench_integrator.py [--device cpu]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from _bench_util import (  # noqa: E402
    add_device_arg, bench_params, setup_pulse_inputs, sync, timed, where,
)
from spintorque_tpu_torch.parallel import resolve_device  # noqa: E402
from spintorque_tpu_torch.physics import IntegratorConfig, integrate_pulse  # noqa: E402
from spintorque_tpu_torch.physics import integrate_pulse_plain  # noqa: E402

SEED = 0


def max_abs_diff(a, b) -> float:
    """The largest |a - b| over the three components of two PulseResults."""
    return max(float((x - y).abs().max()) for x, y in zip(a.m, b.m))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--span", type=float, default=1e-9, help="every pulse's span (s)")
    ap.add_argument("--large-batches", type=int, nargs="*", default=[16384, 65536])
    ap.add_argument("--iters", type=int, default=30, help="timed kernel calls a row")
    ap.add_argument("--plain-iters", type=int, default=30, help="timed plain calls a row")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device, None)
    p = bench_params(dev)
    B = args.batch
    m0, _, _ = setup_pulse_inputs(B, SEED, device=dev)
    spans = torch.full((B,), args.span, dtype=torch.float32, device=dev)
    cur = torch.full((B,), 1e2, dtype=torch.float32, device=dev)
    det = IntegratorConfig(method="rk4", max_substeps=1024)
    therm = det._replace(thermal=True)

    def row(fn, iters, batch):
        first = fn()  # the untimed call; its result is the row's output
        sync(dev)
        t = timed(fn, iters=iters, warmup=0, device=dev)
        return dict(ms_per_batch=t * 1e3, pulses_per_s=batch / t), first

    results, outs = {}, {}
    for label, fn, iters in (
        ("plain_det_rk4", lambda: integrate_pulse_plain(m0, spans, cur, p, det), args.plain_iters),
        ("kernel_det_rk4", lambda: integrate_pulse(m0, spans, cur, p, det), args.iters),
        ("plain_thermal_rk4", lambda: integrate_pulse_plain(m0, spans, cur, p, therm, seed=SEED),
         args.plain_iters),
        ("kernel_thermal_rk4", lambda: integrate_pulse(m0, spans, cur, p, therm, seed=SEED),
         args.iters),
    ):
        results[label], outs[label] = row(fn, iters, B)
        r = results[label]
        print(f"{label:18s}: {r['ms_per_batch']:.3f} ms / batch of {B} -> "
              f"{r['pulses_per_s']:,.0f} pulse/s", flush=True)
    d = max_abs_diff(outs["plain_det_rk4"], outs["kernel_det_rk4"])
    print(f"max |plain - kernel| deterministic: {d}", flush=True)

    large = {}
    for BB in args.large_batches:
        mb, _, _ = setup_pulse_inputs(BB, SEED, device=dev)
        sp = torch.full((BB,), args.span, dtype=torch.float32, device=dev)
        cb = torch.full((BB,), 1e2, dtype=torch.float32, device=dev)
        large[str(BB)], _ = row(lambda: integrate_pulse(mb, sp, cb, p, therm, seed=SEED), 10, BB)
        print(f"kernel thermal B={BB}: {large[str(BB)]['ms_per_batch']:.3f} ms -> "
              f"{large[str(BB)]['pulses_per_s']:,.0f} pulse/s", flush=True)

    record = dict(batch=B, span_s=args.span, substeps=int(outs["kernel_det_rk4"].n_substeps.max()),
                  results=results, max_abs_diff_deterministic=d, kernel_thermal_large=large,
                  backend=dev.type, card=where(dev))
    print(json.dumps(record), flush=True)
    # The kernel's deterministic contract with its plain version (rtol = atol
    # = 2e-6 on m; the port's kernels usually agree to the bit).
    record["ok"] = d <= 2e-6
    return record


if __name__ == "__main__":
    _sys.exit(0 if main()["ok"] else 1)
