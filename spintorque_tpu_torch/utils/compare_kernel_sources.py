"""K1's and K6's times from two kernel sources, in turns in one process on one card.

    python -m spintorque_tpu_torch.utils.compare_kernel_sources --base DIR [--out FILE]

``DIR`` is the root of another checkout of the repo (a parent commit's,
unpacked with ``git archive``) whose ``spintorque_tpu_torch/csrc`` has the
same C interface as this checkout's. Both libraries are built (each
``nvcc`` run in parallel, as ``ops._build`` does) and loaded into this
process; ``ops._build.use_library`` switches the one the pulse wrapper
launches from, so both run the same Python wrapper on the same inputs.

At each batch (4096 and 65536) the pulse runs the env's default
integrator config (RK4, 5001 substeps at most), thermal and deterministic,
in float32 (K1) and with bf16 stage arithmetic (K6, ``bf16_rhs``), over
the main path's inputs: unit states, spans from 1 ps to 5 ns and currents
of |J| <= 2e6 A/m^2 from a seeded generator, +z easy axis. The two
libraries' results are compared bit for bit (m, substeps, failed), and
then each is timed by CUDA events (the mean of ``REPS`` calls) in the
order base, this, this, base, ``ROUNDS`` times over, so that a drift of
the card over the run falls on both alike. Each round gives two pairs
(base then this, this then base); the result counts the pairs this side
wins, the medians and the spread of the base's own times (the distance
between their quartiles). Prints the card's name and power limit, and one
JSON line with every time (and writes it to ``--out`` when given); its
keys name each call ``<kernel>_<thermal|deterministic>_B<batch>``. Exits 1
when a call's results differ between the two sources.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..envs import SpinTorqueEnvConfig
from ..ops import _build
from ..ops import cuda_integrator as ci
from ..physics import LLGSParams
from .host import card_line

ROUNDS = 10
REPS = 10
KERNELS = {"K1": False, "K6": True}  # kernel: bf16_rhs
MODES = ("thermal", "deterministic")
# The entry points a base checkout's library may lack: it gets only pulses to run.
BASE_MAY_LACK = frozenset({"spintorque_check_bf16_ops"})


def _inputs(B: int, seed: int, device):
    g = torch.Generator().manual_seed(seed)
    m = torch.randn(B, 3, generator=g, dtype=torch.float64)
    m = m / m.norm(dim=-1, keepdim=True)
    spans = 1e-12 + (5e-9 - 1e-12) * torch.rand(B, generator=g, dtype=torch.float64)
    current = 2e6 * (2.0 * torch.rand(B, generator=g, dtype=torch.float64) - 1.0)

    def f(t):
        return t.float().to(device).contiguous()

    return (f(m[:, 0]), f(m[:, 1]), f(m[:, 2])), f(spans), f(current)


def _params(device) -> LLGSParams:
    vals = dict(saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
                volume=1e-23, polarization=0.7)
    p = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in vals.items()}
    return LLGSParams(**p, easy_axis=torch.tensor([0.0, 0.0, 1.0], device=device), plus_z=True)


def _cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _same(a, b) -> bool:
    return (all(torch.equal(x, y) for x, y in zip(a.m, b.m))
            and torch.equal(a.n_substeps, b.n_substeps) and torch.equal(a.failed, b.failed))


def _quantiles(xs):
    q = torch.quantile(torch.tensor(xs, dtype=torch.float64),
                       torch.tensor([0.25, 0.5, 0.75], dtype=torch.float64))
    return [float(v) for v in q]


def pulse_ptxas(log: str) -> dict:
    """A build log's pulse kernel instances by kernel (K6: the Bf16 ones,
    K1 the float ones; K5 is K1's code), each with ptxas's registers,
    stack and spill bytes."""
    out = {"K1": {}, "K6": {}}
    for name, report in _build.ptxas_report(log).items():
        if "pulse_kernel" in name:
            out["K6" if "Bf16" in name else "K1"][name] = report
    return out


def summarize(times: dict, bitwise_equal: dict) -> dict:
    """Medians, the base's quartile spread, the pairs this side wins and
    this / base per call, from ``times[side][key]`` (ms of each turn, the
    sides ``base`` and ``this``, their i-th turns adjacent)."""
    keys = list(times["base"])
    median, base_iqr, wins = {"base": {}, "this": {}}, {}, {}
    for key in keys:
        for name in ("base", "this"):
            median[name][key] = _quantiles(times[name][key])[1]
        q1, _, q3 = _quantiles(times["base"][key])
        base_iqr[key] = q3 - q1
        # pair i: base's i-th time against this side's i-th (the same round
        # and half), so a win is the faster of two adjacent runs
        wins[key] = sum(t < b for t, b in zip(times["this"][key], times["base"][key]))
    return dict(
        bitwise_equal=bitwise_equal, median_ms=median, base_iqr_ms=base_iqr,
        pairs=len(times["base"][keys[0]]), pairs_this_faster=wins,
        this_over_base={key: median["this"][key] / median["base"][key] for key in keys},
        ms_in_turns=times,
    )


def compare(base: Path, batches=(4096, 65536), seed: int = 0) -> dict:
    if not ci.cuda_kernel_available():
        raise RuntimeError("torch sees no CUDA device")
    dev = torch.device("cuda")
    libs = {"this": _build.load_library(),
            "base": _build.build_library(Path(base) / "spintorque_tpu_torch" / "csrc",
                                         optional=BASE_MAY_LACK)}
    if libs["base"].path == libs["this"].path:
        raise ValueError(f"{base} has the same kernel sources as this checkout")
    main_cfg = SpinTorqueEnvConfig().integrator()
    configs = {"thermal": main_cfg, "deterministic": main_cfg._replace(thermal=False)}
    params = _params(dev)
    calls, equal = {}, {}
    for B in batches:
        m0, spans, cur = _inputs(B, seed + B, dev)
        for kernel in KERNELS:
            for label in MODES:
                cfg = configs[label]._replace(bf16_rhs=KERNELS[kernel])
                key = f"{kernel}_{label}_B{B}"
                calls[key] = (lambda cfg=cfg, m0=m0, spans=spans, cur=cur:
                              ci.integrate_pulse_cuda(m0, spans, cur, params, cfg, seed=5))
                results = {}
                for name, lib in libs.items():
                    _build.use_library(lib)
                    results[name] = calls[key]()
                equal[key] = _same(results["base"], results["this"])
    times = {name: {key: [] for key in calls} for name in libs}
    for _ in range(ROUNDS):
        for name in ("base", "this", "this", "base"):
            _build.use_library(libs[name])
            for key, fn in calls.items():
                times[name][key].append(_cuda_ms(fn, REPS))
    _build.use_library(libs["this"])
    return dict(
        card=card_line(), base=str(base), libraries={k: v.path.name for k, v in libs.items()},
        build_seconds={k: v.build_seconds for k, v in libs.items()},
        ptxas={k: pulse_ptxas(v.log) for k, v in libs.items()},
        config=main_cfg._asdict(), batches=list(batches), rounds=ROUNDS, reps=REPS,
        **summarize(times, equal),
    )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="root of the checkout to compare with")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = compare(Path(args.base))
    print(out["card"])
    for side, kernels in out["ptxas"].items():
        for kernel, instances in kernels.items():
            regs = sorted({r["registers"] for r in instances.values()})
            spills = sum(r.get("spill_stores", 0) + r.get("spill_loads", 0)
                         for r in instances.values())
            print(f"ptxas {side} {kernel}: {len(instances)} instances, registers {regs}, "
                  f"spill bytes {spills}")
    for key, ratio in out["this_over_base"].items():
        print(f"{key}: median base {out['median_ms']['base'][key]:.4f} ms (quartiles "
              f"{out['base_iqr_ms'][key]:.4f} apart), this {out['median_ms']['this'][key]:.4f} "
              f"ms, this / base {ratio:.4f}, this faster in {out['pairs_this_faster'][key]} of "
              f"{out['pairs']} pairs, bit for bit {out['bitwise_equal'][key]}")
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    if not all(out["bitwise_equal"].values()):
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
