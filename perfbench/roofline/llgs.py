"""The frozen price of an LLGS pulse: the operations and bytes the
algorithm needs, whatever implements it.

A pulse integrates each env over the substeps its duration needs under the
dt law (dt0 = min(max_step, span / 100), n = max(10, floor(span / dt0)),
capped at the configuration's substep bound). A substep of RK4 costs the
operations counted below, each addition, subtraction, multiplication,
division, square root, logarithm and floor one operation (a multiply-add
two). The count is of the generic easy-axis form: an implementation that
drops the products by a zero axis component, fuses, skips or re-forms
operations changes its time, not this count. The Philox words that key the
thermal field are integer work and are not counted against a float32 peak.

Bytes are each input read once (m, span, current: 20 bytes an env) and
each output written once (m, the failed flag: 13 bytes an env).

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
float32 outside the tensor cores and HBM3 bandwidth.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

PEAK_FLOPS = 67e12  # float32 operations/s
PEAK_BYTES = 3.35e12  # bytes/s

# One evaluation of the right-hand side:
#   m . e (3 mul, 2 add), h_k (m . e), its product with e (3),
#   the demagnetizing term hz - Ms mz (2), four cross products
#   (m x e, m x (m x e), m x H, m x (m x H): 9 each), and per component
#   gamma' (p + alpha d) + stt v (5): 5 + 1 + 3 + 2 + 36 + 15.
RHS_OPS = 62
RHS_THERMAL_OPS = 3  # H + H_thermal
# RK4 around four evaluations: k = dt f (4 x 3), the stage states
# m + k1/2, m + k2/2, m + k3 (6 + 6 + 3), (k1 + 2 k2 + 2 k3 + k4) / 6
# (6 a component), the update m + dm (3), the normalization (5 for the
# squared norm, 1 square root, 3 divisions).
RK4_OPS = 12 + 15 + 18 + 3 + 9
# One normal of an exact Box-Muller pair, half of the pair's float work:
# two uniforms from their bits (2 each), 1 - u, log, -2 x, sqrt, the
# quadrant fold (6), the cosine and sine polynomials (9 + 7), r c and r s.
NORMAL_OPS = 16
FIELD_OPS = 3  # sigma x normal, three components
BYTES_PER_ENV = 20 + 13


def ops_per_substep(env: Dict) -> int:
    """Operations of one RK4 substep of the configuration's env."""
    if env["method"] != "rk4":
        raise ValueError("the frozen count prices RK4")
    ops = 4 * RHS_OPS + RK4_OPS
    if env["include_thermal"]:
        if env["rk4_noise"] != "per_substep":
            raise ValueError("the frozen count prices one field a substep")
        ops += 4 * RHS_THERMAL_OPS + FIELD_OPS + 3 * NORMAL_OPS
    return ops


def substeps(durations: np.ndarray, max_step: float, max_duration: float) -> np.ndarray:
    """Each env's substeps under the dt law, in float32 as the env runs it."""
    span = np.clip(np.asarray(durations, np.float32), np.float32(1e-12),
                   np.float32(max_duration))
    dt0 = np.minimum(np.float32(max_step), span / np.float32(100.0))
    n = np.maximum(np.floor(span / dt0).astype(np.int64), 10)
    bound = max(10, int(math.ceil(max_duration / min(max_step, max_duration / 100.0))) + 1)
    return np.minimum(n, bound)


def pulse_work(durations: np.ndarray, config: Dict) -> Tuple[float, float]:
    """(operations, bytes) of one pulse call over envs of these durations."""
    env = config["env"]
    n = substeps(durations, float(config["integrator"]["max_step"]), float(env["max_duration"]))
    return float(n.sum()) * ops_per_substep(env), float(n.size) * BYTES_PER_ENV


def roofline_share(ops: float, nbytes: float, seconds: float) -> Tuple[float, str]:
    """(percent of the roofline, the bound that applies: 'compute' or
    'bytes') of work that took ``seconds`` on the device."""
    compute, memory = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 100.0 * max(compute, memory) / seconds, "compute" if compute >= memory else "bytes"
