"""Measured roofline and utilization of the pulse kernel K1.

PyTorch counterpart of scripts/bench_roofline.py. The workload is the JAX
program's: B=4096 random unit states at -1e6 A/m^2, RK4 with
``max_substeps`` 5120 (one configuration for every point), deterministic
and thermal (``noise_mode`` reference, ``rk4_noise`` per_substep, seed 7),
every pulse of a call equally long: spans of 10, 1000 and 5000 ps, timed
with 12 warm-up calls and 20 timed calls (10 at 5000).

A least-squares line through (substeps, time) splits a call into its
**marginal µs per substep batch** (the slope) and its **fixed ms a call**
(the intercept). The line is fitted over the substeps the kernel ran
(``PulseResult.n_substeps``), not over the nominal spans: the dt law takes
dt = span / 100 below 100 ps, so the 10 ps point runs 100 substeps. The
times are host-clock times of back-to-back calls between two synchronizes:
a call is the host side of ``integrate_pulse_cuda`` (the dt law, the
per-env coefficients, the descending-n argsort, the launch) and the
kernel, so the intercept holds whichever of the host's time per call and
the kernel's fixed device time is the longer, not a compile artefact.
Uniform spans make the sort trivial.

Operations and bytes per call come from ``ops.cuda_integrator.pulse_work``
(a lower bound: a transcendental counts one), and are set against the
card's peaks in ``utils.benchmark``: the JAX keys ``vpu_*`` become
``fp32_*`` (the float32 instruction rate, 33.5 T/s, the rate the kernels'
bounds use; and the FMA flop rate, 67 TFLOP/s), and ``*_tflop_*`` count
these operations. On the card the marginal stands beside the chain floor
per substep: ``pulse_chain_depth`` priced at the dependent-op latencies
that ``ops.op_chain.measure_op_costs`` (K7) measures in the same run, on
the normalization's fallback path for thermal calls and its finite path
for deterministic ones (chip_smoke.py prices K1's floors the same way).
On the card the same fit runs over the kernel's own device time (the
profiler's, ``KERNEL_REPS`` calls a point: ``kernel_*``), which no host
time enters; a point whose launches the profiler did not all see is None
and left out of that fit (None with fewer than two points). On the CPU
the chain floor, the kernel's device times and the shares of the card's
peaks are not measured (None).

Run: python scripts/torch/bench_roofline.py [--device cpu] [--out PATH]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _bench_util import (  # noqa: E402
    add_device_arg, bench_params, setup_pulse_inputs, timed, where, write_json,
)
from spintorque_tpu_torch.parallel import resolve_device  # noqa: E402
from spintorque_tpu_torch.ops import cuda_integrator as ci  # noqa: E402
from spintorque_tpu_torch.physics import IntegratorConfig, integrate_pulse  # noqa: E402
from spintorque_tpu_torch.utils.benchmark import (  # noqa: E402
    PEAK_BYTES, PEAK_FLOPS, PEAK_FP32_INSTR,
)

SPAN_POINTS = (10, 1000, 5000)  # ps; one substep a ps from 100 ps on
THERMAL_SEED = 7
KERNEL_REPS = 5  # profiled calls a point


def fit(substeps, seconds):
    """(slope s/substep, intercept s): the least-squares line."""
    slope, intercept = np.polyfit(np.asarray(substeps, float), np.asarray(seconds, float), 1)
    return float(slope), float(intercept)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--spans-ps", type=int, nargs="+", default=list(SPAN_POINTS),
                    help="the uniform spans of the fit, in ps; the middle one is the reference")
    ap.add_argument("--warmup", type=int, default=12)
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls a point (default 20, 10 above 1000 ps)")
    ap.add_argument("--out", default=None, help="also write the record here")
    return ap.parse_args(argv)


def kernel_ms(call, reps, tries=3):
    """(ms, calls): the pulse kernel's mean device time over ``reps`` calls,
    by the profiler (the kernel alone, apart from the host side of the
    call), and the calls made. A profile whose trace lacks one of the
    ``reps`` launches is taken again, up to ``tries`` times; the time is
    None when none saw them all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "pulse_kernel" in e.key]
        if sum(e.count for e in seen) == reps:
            return sum(e.self_device_time_total for e in seen) / reps / 1e3, attempt * reps
    return None, tries * reps


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device, None)
    p = bench_params(dev)
    B = args.batch
    m0, _, _ = setup_pulse_inputs(B, 0, device=dev)
    cur = torch.full((B,), -1e6, dtype=torch.float32, device=dev)
    points = sorted(args.spans_ps)
    ref = points[len(points) // 2]

    latency_ns = None
    if dev.type == "cuda":
        from spintorque_tpu_torch.ops.op_chain import measure_op_costs

        latency_ns = measure_op_costs(dev)["latency_ns"]

    def card(share):
        """A share of the card's peaks: None where the times are the CPU's."""
        return share if dev.type == "cuda" else None

    results = {}
    for label, thermal in (("deterministic", False), ("thermal_per_substep", True)):
        cfg = IntegratorConfig(method="rk4", max_substeps=5120, thermal=thermal,
                               noise_mode="reference", rk4_noise="per_substep")
        seed = THERMAL_SEED if thermal else None
        times, device, n_run, n_ref, profiled = {}, {}, {}, None, 0
        for n_sub in points:
            sp = torch.full((B,), n_sub * 1e-12, dtype=torch.float32, device=dev)

            def call(sp=sp):
                return integrate_pulse(m0, sp, cur, p, cfg, seed=seed)

            n = call().n_substeps
            n_run[n_sub] = int(n.max())
            if n_sub == ref:
                n_ref = n
            iters = args.iters if args.iters is not None else (20 if n_sub <= 1000 else 10)
            times[n_sub] = timed(call, iters=iters, warmup=args.warmup, device=dev)
            if dev.type == "cuda":
                device[n_sub], calls = kernel_ms(call, KERNEL_REPS)
                profiled += calls
        slope, intercept = fit([n_run[n] for n in points], [times[n] for n in points])
        t = times[ref]
        ops_per_substep = ci.pulse_ops_per_substep(cfg, True)
        ops, nbytes = ci.pulse_work(n_ref, cfg, True)
        achieved = ops / t
        marginal_achieved = ops_per_substep * B / slope
        fallback = thermal  # see the module docstring
        r = {f"ms_per_pulse_batch_{n}": times[n] * 1e3 for n in points}
        r.update(
            substeps_run={str(n): n_run[n] for n in points},
            us_per_substep_batch_total=t / n_run[ref] * 1e6,
            us_per_substep_batch_marginal=slope * 1e6,
            fixed_call_overhead_ms=intercept * 1e3,
            substep_flop_per_env_counted=ops_per_substep,
            ops_per_call=ops,
            achieved_tflop_per_s=achieved / 1e12,
            marginal_achieved_tflop_per_s=marginal_achieved / 1e12,
            fp32_utilization_vs_instr_ceiling=card(achieved / PEAK_FP32_INSTR),
            marginal_fp32_utilization=card(marginal_achieved / PEAK_FP32_INSTR),
            fp32_utilization_vs_fma_ceiling=card(achieved / PEAK_FLOPS),
            hbm_bytes_per_call=nbytes,
            hbm_utilization=card(nbytes / t / PEAK_BYTES),
            bound_ms=max(ops / PEAK_FP32_INSTR, nbytes / PEAK_BYTES) * 1e3,
            chain_path="fallback" if fallback else "finite",
            chain_depth=ci.pulse_chain_depth(cfg, True, fallback),
            chain_floor_us_per_substep=None,
            marginal_over_chain_floor=None,
            kernel_ms_per_pulse_batch=None,
            kernel_us_per_substep_batch_marginal=None,
            kernel_fixed_ms=None,
            kernel_marginal_over_chain_floor=None,
            kernel_profiled_calls=profiled,
        )
        if latency_ns is not None:
            floor_us = sum(d * latency_ns[c] for c, d in r["chain_depth"].items() if d) * 1e-3
            r.update(chain_floor_us_per_substep=floor_us,
                     marginal_over_chain_floor=r["us_per_substep_batch_marginal"] / floor_us,
                     kernel_ms_per_pulse_batch={str(n): device[n] for n in points})
            seen = [n for n in points if device[n] is not None]
            if len(seen) >= 2:
                k_slope, k_intercept = fit([n_run[n] for n in seen],
                                           [device[n] * 1e-3 for n in seen])
                r.update(kernel_us_per_substep_batch_marginal=k_slope * 1e6,
                         kernel_fixed_ms=k_intercept * 1e3,
                         kernel_marginal_over_chain_floor=k_slope * 1e6 / floor_us)
        results[label] = r
        shares = (f" = {100 * r['marginal_fp32_utilization']:.2f}% of the fp32 instruction "
                  f"rate; HBM {100 * r['hbm_utilization']:.4f}%; chain floor "
                  f"{r['chain_floor_us_per_substep']:.4f} us/substep "
                  f"({r['marginal_over_chain_floor']:.2f}x); the kernel alone "
                  f"{r['kernel_ms_per_pulse_batch']} ms, marginal "
                  f"{r['kernel_us_per_substep_batch_marginal']} us/substep-batch"
                  if dev.type == "cuda" else "")
        print(f"{label}: {t * 1e3:.4f} ms/{n_run[ref]}-substep batch, marginal "
              f"{r['us_per_substep_batch_marginal']:.4f} us/substep-batch + "
              f"{r['fixed_call_overhead_ms']:.4f} ms/call fixed; marginal "
              f"{r['marginal_achieved_tflop_per_s']:.6f} T ops/s{shares}", flush=True)

    record = dict(backend=dev.type, card=where(dev), batch=B, substeps=ref,
                  spans_ps=points, fp32_instr_ceiling=PEAK_FP32_INSTR,
                  fp32_fma_ceiling=PEAK_FLOPS, hbm_bytes_per_s=PEAK_BYTES,
                  op_latency_ns=latency_ns, results=results)
    print(json.dumps(record), flush=True)
    if args.out:
        write_json(args.out, record)
    record["ok"] = all(np.isfinite(v) and v > 0 for r in results.values()
                       for k, v in r.items() if k.startswith("ms_per_pulse_batch_"))
    return record


if __name__ == "__main__":
    _sys.exit(0 if main()["ok"] else 1)
