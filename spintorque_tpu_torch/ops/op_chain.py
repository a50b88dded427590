"""Per-op prices on the card from serial dependent op chains (K7).

Counterpart of ``scripts/bench_vpu_op_costs.py``. Its Pallas kernel
``_chain_kernel`` runs a chain of ``trips x 100`` dependent steps of one op
over one (8, 128) float32 vreg; the slope of the time between two trip
counts is the op's price, free of the launch. Here the chain is the CUDA
kernel ``csrc/op_chain.cu`` (``op_chain``, which takes the step count
itself), one thread per lane, with ``op_chain_plain`` beside it (the same
chain in torch), and ``measure_op_costs`` times it by CUDA events in two
launch shapes:

  * latency: one block of 1024 threads, the vreg's 1024 lanes. Each SM
    holds at most one block, so the slope is one step's dependent latency.
  * throughput: 2048 threads on every SM (8 blocks of 256 each). The slope
    is then the SM's issue rate for the op; it is reported per 1024 lanes,
    the vreg's unit.

The companion simple ops of a step (the ``+ 1.0`` of ``log``, the scale of
``exp``, ...) are priced at base2/2, as the JAX script prices them, and
subtracted to isolate each op. ``base2_bf16``, which the JAX script lacks,
is base2's step in K6's native bf16 ops; half of it prices a ``bf16`` op
of K6's chain (``ops.cuda_integrator.pulse_chain_depth``).

From x = 1 every chain stays at its fixed point, so a timed chain runs on
ones, but there a copy, a skipped loop or the wrong op would agree with the
plain chain. The kernel is held to its plain version on ``check_input``:
per-op inputs on which each of ``CHECK_STEPS`` steps moves x, compared at
``CHECK_RTOL``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from . import _build
from ..utils.profiling import counter

Tensor = torch.Tensor


def _base2_bf16(x: Tensor) -> Tensor:
    """base2's Newton step in torch's bf16 ops, on x rounded to bf16 (exact
    after the first step), widened back to float32."""
    b = x.to(torch.bfloat16)
    return (b * (2.0 - b)).float()


# The chain steps, in the order of csrc/op_chain.cu's ChainOp. Every step
# holds x at a float32 fixed point near 1 and is nonlinear in x. The
# division is tensor by tensor: CUDA turns a Python scalar's division into
# a reciprocal multiply. base2_bf16 is base2 in K6's native bf16 ops (the
# kernel keeps the chain in bf16 between its float input and output).
OPS = {
    "base2": lambda x: x * (2.0 - x),  # Newton-reciprocal step; 2 simple ops
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "log": lambda x: torch.log(x) + 1.0,
    "exp": lambda x: torch.exp(x) * (1.0 / 2.718281828459045),
    "cos": lambda x: torch.cos(x) + 0.4596976941,
    "div": lambda x: torch.full_like(x, 2.0) / (x + 1.0),
    "select": lambda x: torch.where(x > 0.5, x, x + 1e-7),
    "base2_bf16": _base2_bf16,  # 2 native bf16 ops
}
# Simple ops beside the headline op in one step, priced at base2/2 each.
OP_COMPANIONS = {
    "base2": 0, "sqrt": 0, "rsqrt": 0, "log": 1, "exp": 1, "cos": 1, "div": 1, "select": 1,
    "base2_bf16": 0,
}
# The steps of two ops of one class (a subtract and a multiply): each prices
# its class at half the step, ``simple`` (float32) and ``bf16``.
PAIR_CLASSES = {"base2": "simple", "base2_bf16": "bf16"}
_OP_INDEX = {name: i for i, name in enumerate(OPS)}
# Where each chain moves for a few steps: log's and exp's fixed points are
# neutral, approached from above and from below (from the other side the
# chain runs off to NaN or inf), and select moves only below 0.5, by 1e-7 a
# step, so its inputs are small enough for that to show at CHECK_RTOL.
# base2_bf16 starts further below 1, where each of its steps still moves a
# bf16 value (from 0.55 it would reach 1 in bf16 within three steps).
CHECK_DOMAIN = {
    "base2": (0.55, 1.45), "sqrt": (0.55, 1.45), "rsqrt": (0.55, 1.45), "log": (1.0, 1.45),
    "exp": (0.55, 1.0), "cos": (0.55, 1.45), "div": (0.55, 1.45), "select": (1e-6, 1e-5),
    "base2_bf16": (0.1, 0.5),
}
CHECK_STEPS = 3
CHECK_RTOL = 1e-6
LATENCY_THREADS = 1024
THROUGHPUT_BLOCK = 256
THREADS_PER_SM = 2048
# The two step counts of each shape's slope (~10 ms and more of chain at
# the longer one), and the launches of which each time is the least.
LATENCY_STEPS = (200_000, 600_000)
THROUGHPUT_STEPS = (20_000, 60_000)
REPS = 3


OP_CHAIN_LAUNCHES = counter("op_chain.launches")  # K7


def check_input(op: str, n: int, device="cpu", seed: int = 0) -> Tensor:
    """``n`` float32 values, uniform in ``CHECK_DOMAIN[op]``, from ``seed``."""
    lo, hi = CHECK_DOMAIN[op]
    u = torch.rand(n, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    return (lo + (hi - lo) * u).float().to(device)


def op_chain_plain(x: Tensor, op: str, steps: int) -> Tensor:
    """The chain kernel's plain version: ``steps`` steps of ``OPS[op]`` on
    ``x``, one torch op at a time."""
    step = OPS[op]
    for _ in range(steps):
        x = step(x)
    return x


def op_chain(x: Tensor, op: str, steps: int, block: int = LATENCY_THREADS) -> Tensor:
    """``steps`` dependent steps of ``OPS[op]`` on each element of ``x``,
    a contiguous float32 CUDA tensor, by the chain kernel with ``block``
    threads per block. Launches on the current stream and does not
    synchronize; raises on a CPU tensor or an unknown op."""
    if not isinstance(x, Tensor) or x.device.type != "cuda":
        raise ValueError("op_chain takes a CUDA tensor")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("op_chain takes a nonempty contiguous float32 tensor")
    if op not in _OP_INDEX:
        raise ValueError(f"unknown op {op!r}; one of {list(OPS)}")
    y = torch.empty_like(x)
    rc = _build.launch(_build.kernel_fn("spintorque_op_chain"), x.device, x.data_ptr(),
                       y.data_ptr(), x.numel(), _OP_INDEX[op], steps, block)
    if rc != 0:
        raise RuntimeError(f"op chain kernel launch failed: cudaError {rc}")
    OP_CHAIN_LAUNCHES.add()
    return y


def slope_ns_per_step(t_lo_ms: float, t_hi_ms: float, lo: int, hi: int) -> float:
    """ns per chain step from the times (ms) of ``lo`` and ``hi`` steps:
    the intercept (launch, loop set-up) cancels."""
    return (t_hi_ms - t_lo_ms) * 1e6 / (hi - lo)


def isolate(step_ns: Dict[str, float]) -> Dict[str, float]:
    """Each op's own price: its step's price less its companion simple ops
    at base2/2 each; ``simple`` is base2/2 and ``bf16`` (when measured)
    base2_bf16/2."""
    simple = step_ns["base2"] / 2.0
    out = {op: step_ns[op] - OP_COMPANIONS[op] * simple for op in step_ns
           if op not in PAIR_CLASSES}
    out.update({cls: step_ns[op] / 2.0 for op, cls in PAIR_CLASSES.items() if op in step_ns})
    return out


def _launch_ms(x: Tensor, op: str, steps: int, block: int) -> float:
    """The least time (ms) of ``REPS`` launches, each timed by CUDA events."""
    best = math.inf
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        op_chain(x, op, steps, block)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def measure_op_costs(device="cuda") -> Dict[str, Any]:
    """ns per op on the card, in both launch shapes.

    Returns ``latency_step_ns`` and ``throughput_step_ns_per_1024`` (each
    op's whole step), their ``isolate``d forms ``latency_ns`` and
    ``throughput_ns_per_1024``, and the shapes. The chains run on ones, at
    their fixed points. Raises without a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("measure_op_costs needs a CUDA device")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = {
        "latency": (LATENCY_THREADS, LATENCY_THREADS, LATENCY_STEPS),
        "throughput": (sms * THREADS_PER_SM, THROUGHPUT_BLOCK, THROUGHPUT_STEPS),
    }
    out: Dict[str, Any] = {}
    for shape, (threads, block, (lo, hi)) in shapes.items():
        x = torch.ones(threads, dtype=torch.float32, device=device)
        per_1024 = LATENCY_THREADS / threads
        step_ns = {}
        for op in OPS:
            op_chain(x, op, lo, block)  # warm-up
            t_lo = _launch_ms(x, op, lo, block)
            t_hi = _launch_ms(x, op, hi, block)
            step_ns[op] = slope_ns_per_step(t_lo, t_hi, lo, hi) * per_1024
        suffix = "" if shape == "latency" else "_per_1024"
        out[f"{shape}_step_ns{suffix}"] = step_ns
        out[f"{shape}_ns{suffix}"] = isolate(step_ns)
    out["shapes"] = {k: dict(threads=v[0], block=v[1], steps=list(v[2])) for k, v in shapes.items()}
    return out
