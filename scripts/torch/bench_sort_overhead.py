"""What the descending-n sort costs on the pulse's critical path.

PyTorch counterpart of scripts/bench_sort_overhead.py. The pulse call
(``ops.cuda_integrator.launch_pulse``) argsorts the envs by descending
substep count on the device and the kernel reads and writes env
``perm[t]`` from thread t, so a warp runs to its own longest env. The JAX
program's two variants, on B=4096 random unit states at -1e6 A/m^2, thermal
RK4 (``noise_mode`` reference, ``rk4_noise`` per_substep, seed 7),
``max_substeps`` 5101:

  (a) random spans, 1 ps - 5 ns (seed 0): the real sort;
  (c) uniform 2.5 ns spans: the sort is trivial, at the same mean substeps.

(a) - (c) bounds the argsort, the permuted reads and writes, and the
spread of substep counts within a warp. The argsort itself is also timed
alone on (a)'s counts (``argsort_ms``). 12 warm-up calls and 20 timed
calls each.

Run: python scripts/torch/bench_sort_overhead.py [--device cpu]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from _bench_util import (  # noqa: E402
    add_device_arg, bench_params, setup_pulse_inputs, timed, where,
)
from spintorque_tpu_torch.parallel import resolve_device  # noqa: E402
from spintorque_tpu_torch.physics import IntegratorConfig, integrate_pulse  # noqa: E402
from spintorque_tpu_torch.physics.integrator import clamped_substep_counts  # noqa: E402

THERMAL_SEED = 7


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--max-span", type=float, default=5e-9,
                    help="(a)'s longest span (s); (c) takes half of it")
    ap.add_argument("--warmup", type=int, default=12)
    ap.add_argument("--iters", type=int, default=20)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device, None)
    p = bench_params(dev)
    B = args.batch
    m0, spans_rand, _ = setup_pulse_inputs(B, 0, span_lo=1e-12, span_hi=args.max_span,
                                           device=dev)
    spans_uni = torch.full((B,), args.max_span / 2, dtype=torch.float32, device=dev)
    cur = torch.full((B,), -1e6, dtype=torch.float32, device=dev)
    cfg = IntegratorConfig(method="rk4", max_substeps=5101, thermal=True,
                           noise_mode="reference", rk4_noise="per_substep")

    def run(spans):
        return timed(lambda: integrate_pulse(m0, spans, cur, p, cfg, seed=THERMAL_SEED),
                     iters=args.iters, warmup=args.warmup, device=dev)

    t_sorted = run(spans_rand)
    print(f"(a) random spans, real sort:      {t_sorted * 1e3:8.3f} ms", flush=True)
    t_uni = run(spans_uni)
    print(f"(c) uniform spans, trivial sort:  {t_uni * 1e3:8.3f} ms", flush=True)
    _, n_rand = clamped_substep_counts(spans_rand, cfg)
    _, n_uni = clamped_substep_counts(spans_uni, cfg)
    t_argsort = timed(lambda: torch.argsort(-n_rand, stable=True), iters=args.iters,
                      warmup=args.warmup, device=dev)
    print(f"(a)-(c) = {(t_sorted - t_uni) * 1e3:7.3f} ms = argsort + permuted reads and "
          f"writes + within-warp substep spread at matched mean substeps; the argsort alone "
          f"{t_argsort * 1e3:.4f} ms", flush=True)
    record = dict(
        backend=dev.type, card=where(dev), batch=B,
        sorted_random_ms=t_sorted * 1e3, uniform_ms=t_uni * 1e3,
        sort_overhead_ms=(t_sorted - t_uni) * 1e3, argsort_ms=t_argsort * 1e3,
        mean_substeps_random=float(n_rand.double().mean()),
        mean_substeps_uniform=float(n_uni.double().mean()),
        max_substeps_random=int(n_rand.max()),
    )
    print(json.dumps(record), flush=True)
    record["ok"] = t_sorted > 0 and t_uni > 0
    return record


if __name__ == "__main__":
    _sys.exit(0 if main()["ok"] else 1)
