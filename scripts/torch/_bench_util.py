"""Shared measurement discipline of the programs under scripts/torch/.

PyTorch counterpart of scripts/_bench_util.py: ONE copy of the
steady-state timer and of the canonical bench device parameters, so that
neither forks per program, plus the device option every program takes.

``timed`` runs ``warmup`` calls, then ``iters`` calls between two device
synchronizes (one per timed block, on the card); on the CPU the host clock
is the device's. ``setup_pulse_inputs`` draws from a seeded CPU
``torch.Generator`` and moves the draws to the device, so that the CPU and
the card integrate the same inputs.
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import torch  # noqa: E402

from spintorque_tpu_torch.physics import params_from_dict  # noqa: E402
from spintorque_tpu_torch.utils.host import card_line  # noqa: E402

BENCH_PARAMS = dict(  # float32, +z easy axis
    saturation_magnetization=800e3,
    damping=0.01,
    uniaxial_anisotropy=1.2e6,
    volume=1e-23,
    polarization=0.7,
    easy_axis=[0.0, 0.0, 1.0],
)


def bench_params(device, dtype=torch.float32, **over):
    """``BENCH_PARAMS`` (with ``over`` replacing fields) as LLGSParams on
    ``device``, +z resolved on the host."""
    return params_from_dict({**BENCH_PARAMS, **over}, dtype=dtype, device=device)


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def where(device) -> str:
    """What a record ran on: the card's name and power limit as nvidia-smi
    prints them (its name alone without nvidia-smi), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return card_line() or torch.cuda.get_device_name(device)


def sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, iters=20, warmup=12, device=None):
    """Steady-state wall time per call (s): ``warmup`` calls, then ``iters``
    calls timed by the host clock from one device synchronize to the next."""
    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / iters


def setup_pulse_inputs(B=4096, seed=0, span_lo=1e-12, span_hi=5e-9, cur_lo=-2e6, cur_hi=0.0,
                       device="cuda"):
    """Canonical random pulse-batch inputs shared by the kernel programs:
    unit m0 components, spans uniform in [span_lo, span_hi) and currents in
    [cur_lo, cur_hi), float32, contiguous on ``device``."""
    g = torch.Generator().manual_seed(seed)
    m = torch.randn((B, 3), generator=g, dtype=torch.float32)
    m = m / torch.linalg.vector_norm(m, dim=-1, keepdim=True)
    spans = span_lo + (span_hi - span_lo) * torch.rand(B, generator=g, dtype=torch.float32)
    cur = cur_lo + (cur_hi - cur_lo) * torch.rand(B, generator=g, dtype=torch.float32)

    def to(t):
        return t.to(device).contiguous()

    return (to(m[:, 0]), to(m[:, 1]), to(m[:, 2])), to(spans), to(cur)


def write_json(path, record) -> None:
    """Writes ``record`` to ``path`` (its directory made)."""
    import json

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(record, fh, indent=2)
    print(f"wrote {path}", flush=True)
