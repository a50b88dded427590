"""Switching-probability diagrams and parameter ladders, sharded over ranks.

PyTorch counterpart of ``spintorque_tpu/research/sweeps.py``. A whole
(current, duration) grid x thermal ensemble, or a ladder of device
parameters x ensemble, is one batch through the pulse integrator (the CUDA
kernel on a CUDA device, its plain version on the CPU; the JAX package's
``use_pallas`` has no counterpart). With a mesh each rank integrates its
rows of the batch (K5 on CUDA), with their global env indices in the
thermal stream, and the per-point counts meet in one ``all_reduce(SUM)``:
a sharded sweep equals the unsharded one bit for bit. A batch that does
not divide the data axis is replicated, as the JAX sweep leaves it
unsharded for ``integrate_pulse_pallas`` to run (its ``_maybe_shard``,
``spintorque_tpu/research/sweeps.py:51-63``): every rank integrates all of
it unsharded (K1 on CUDA) and reduces nothing, so the result is the
unsharded sweep's on every rank.

The JAX package's ``key`` becomes ``seed``, the 64-bit key of the Philox
thermal stream.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..parallel.mesh import all_reduce, gather_batch, local_rows, resolve_device, split_mesh
from ..physics.integrator import IntegratorConfig, integrate_pulse, max_substeps_for
from ..physics.llgs import LLGSParams

Tensor = torch.Tensor


def _flat_grid(currents, durations, n_ensemble, dtype, device):
    currents = torch.as_tensor(currents, dtype=dtype, device=device).reshape(-1)
    durations = torch.as_tensor(durations, dtype=dtype, device=device).reshape(-1)
    jj, tt = torch.meshgrid(currents, durations, indexing="ij")
    return (currents, durations, jj.reshape(-1).repeat_interleave(n_ensemble),
            tt.reshape(-1).repeat_interleave(n_ensemble))


def _tilted_m0(B, dtype, device, sign=-1.0):
    """Initial state in the ``sign`` well with a 0.5 degree polar tilt:
    exactly +-z is a torque fixed point, so a cold pole start would make
    the deterministic part of switching invisible."""
    tilt = torch.tensor(math.sin(math.radians(0.5)), dtype=dtype)  # host scalars
    mz0 = float(math.copysign(1.0, sign) * torch.sqrt(1.0 - tilt * tilt))
    return (
        torch.full((B,), float(tilt), dtype=dtype, device=device),
        torch.zeros((B,), dtype=dtype, device=device),
        torch.full((B,), mz0, dtype=dtype, device=device),
    ), mz0


def _param_rows(params: LLGSParams, rows: slice, B: int) -> LLGSParams:
    """``params`` with every per-env (B,) field ((B, 3) axis) cut to ``rows``."""
    def cut(name, x):
        per_env = x.ndim == (2 if name == "easy_axis" else 1) and x.shape[0] == B
        return x[rows] if per_env else x

    return dataclasses.replace(params, **{
        f.name: cut(f.name, getattr(params, f.name))
        for f in dataclasses.fields(params) if f.name != "plus_z"
    })


def _ensemble_stats(switched: Tensor, failed: Tensor, n_points: int, n_ensemble: int,
                    rows: slice, mesh) -> tuple:
    """(p_switch, failed_fraction) per grid point over every rank's rows;
    failed trajectories are EXCLUDED from the switching denominator
    (counting them as non-switching would report a confident p=0 for a
    fully-failed point). A point whose whole ensemble failed reports
    p_switch=nan."""
    device = switched.device
    point = (rows.start + torch.arange(switched.shape[0], device=device)) // n_ensemble
    counts = torch.zeros((3, n_points), dtype=torch.float64, device=device)
    for k, x in enumerate((switched, ~failed, failed)):
        counts[k].index_add_(0, point, x.to(torch.float64))
    n_switched, valid, n_failed = all_reduce(counts, mesh).unbind()
    p = torch.where(valid > 0, n_switched / torch.clamp_min(valid, 1.0), math.nan)
    return p.to(torch.float32), (n_failed / n_ensemble).to(torch.float32)


def switching_probability_diagram(
    params: LLGSParams,
    currents,
    durations,
    n_ensemble: int = 256,
    temperature: float = 300.0,
    seed: int = 0,
    method: str = "heun",
    noise_mode: str = "physical",
    max_substeps: Optional[int] = None,
    initial_mz: float = -1.0,
    mesh=None,
    device=None,
) -> Dict[str, Tensor]:
    """P(switch) over a (current, duration) grid with thermal ensembles.

    Starts every trajectory in the ``initial_mz`` well (default -z, with a
    0.5 degree tilt so deterministic torque is nonzero at the pole) and
    reports the fraction of the ensemble that ends with sign(m_z) flipped.
    One ``integrate_pulse`` call covers the whole grid x ensemble, or this
    rank's rows of it on a mesh (all of them where the batch does not divide
    the data axis). Runs on ``device``: "cuda" unless the caller asks for
    "cpu", or the mesh's.

    Returns {"currents", "durations", "p_switch" (nJ, nT),
    "failed_fraction" (nJ, nT), "final_mz" (B,)}, the same on every rank.
    """
    device = resolve_device(device, mesh)
    dtype = torch.float32
    currents, durations, j_flat, t_flat = _flat_grid(currents, durations, n_ensemble, dtype,
                                                     device)
    B = j_flat.shape[0]
    n_j, n_t = currents.shape[0], durations.shape[0]
    if max_substeps is None:
        max_substeps = max_substeps_for(float(durations.max()))
    config = IntegratorConfig(
        method=method,
        max_substeps=int(max_substeps),
        thermal=temperature > 0.0,
        noise_mode=noise_mode,
        rk4_noise="per_substep",
    )
    rows, split = local_rows(B, mesh), split_mesh(B, mesh)
    m0, mz0 = _tilted_m0(rows.stop - rows.start, dtype, device, sign=initial_mz)
    res = integrate_pulse(m0, span=t_flat[rows], current=j_flat[rows],
                          params=params.to(device, dtype), config=config, seed=seed,
                          temperature=temperature, mesh=split)
    mz = res.m[2]
    # Strict sign flip: mz ending exactly at 0.0 has not crossed into the
    # opposite well, so it must not count.
    switched = (mz * mz0 < 0.0) & ~res.failed
    p, failed_fraction = _ensemble_stats(switched, res.failed, n_j * n_t, n_ensemble, rows, split)
    return {
        "currents": currents,
        "durations": durations,
        "p_switch": p.reshape(n_j, n_t),
        "failed_fraction": failed_fraction.reshape(n_j, n_t),
        "final_mz": gather_batch(mz, split),
    }


def parameter_ladder_sweep(
    base_params: LLGSParams,
    vary: Dict[str, Tensor],
    current: float,
    duration: float,
    n_ensemble: int = 128,
    temperature: float = 300.0,
    seed: int = 0,
    method: str = "heun",
    noise_mode: str = "physical",
    mesh=None,
    device=None,
) -> Dict[str, Tensor]:
    """Switching probability along ladders of DEVICE parameters.

    ``vary`` maps LLGSParams field names (e.g. 'uniaxial_anisotropy',
    'damping', 'volume') to equal-length value arrays; entry i of each
    ladder is evaluated with an ``n_ensemble`` thermal ensemble. The
    integrator's per-env (B,) parameters make the whole ladder one batch,
    which shards like the grid sweep above.
    """
    device = resolve_device(device, mesh)
    dtype = torch.float32
    names = list(vary)
    if not names:
        raise ValueError("parameter_ladder_sweep: vary must name at least one LLGSParams field")
    ladders = [torch.as_tensor(vary[n], dtype=dtype, device=device).reshape(-1) for n in names]
    n_points = ladders[0].shape[0]
    for n, lad in zip(names, ladders):
        if lad.shape[0] != n_points:
            raise ValueError(f"ladder {n!r} length {lad.shape[0]} != {n_points}")
    B = n_points * n_ensemble

    fields = {n: lad.repeat_interleave(n_ensemble) for n, lad in zip(names, ladders)}
    params = dataclasses.replace(base_params.to(device, dtype), **fields)
    config = IntegratorConfig(
        method=method,
        max_substeps=max_substeps_for(float(duration)),
        thermal=temperature > 0.0,
        noise_mode=noise_mode,
        rk4_noise="per_substep",
    )
    rows, split = local_rows(B, mesh), split_mesh(B, mesh)
    n = rows.stop - rows.start
    m0, _ = _tilted_m0(n, dtype, device, sign=-1.0)
    res = integrate_pulse(m0, span=torch.full((n,), duration, dtype=dtype, device=device),
                          current=torch.full((n,), current, dtype=dtype, device=device),
                          params=_param_rows(params, rows, B), config=config, seed=seed,
                          temperature=temperature, mesh=split)
    switched = (res.m[2] > 0) & ~res.failed
    p, failed_fraction = _ensemble_stats(switched, res.failed, n_points, n_ensemble, rows, split)
    out = {"p_switch": p, "failed_fraction": failed_fraction}
    out.update({n: lad for n, lad in zip(names, ladders)})
    return out
