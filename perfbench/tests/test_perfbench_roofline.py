"""The frozen price of a pulse, worked by hand for one small batch."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.lib import manifest
from perfbench.reference import spintorque as ref
from perfbench.roofline import llgs

THERMAL = manifest.config("spintorque-v0-thermal")
DET = manifest.config("spintorque-v0-deterministic")
DURATIONS = np.array([1e-12, 5e-11, 2.5e-10, 1e-9, 5e-9], np.float32)


def test_dt_law_by_hand():
    # span < 100 ps: dt0 = span / 100, so 100 substeps; else span / 1 ps.
    assert llgs.substeps(DURATIONS, 1e-12, 5e-9).tolist() == [100, 100, 250, 1000, 5000]


def test_substep_prices_by_hand():
    # rhs: m.e 5, h_k (m.e) 1, x e 3, demag 2, four crosses 36, output 15.
    assert llgs.RHS_OPS == 62
    # RK4: k = dt f 12, stage states 15, the weighted sum 18, update 3, norm 9.
    assert llgs.RK4_OPS == 57
    assert llgs.ops_per_substep(DET["env"]) == 4 * 62 + 57 == 305
    # + H_thermal in each stage, sigma x n, three normals at 16.
    assert llgs.ops_per_substep(THERMAL["env"]) == 305 + 12 + 3 + 48 == 368


@pytest.mark.parametrize("config,per_substep", [(THERMAL, 368), (DET, 305)],
                         ids=["thermal", "deterministic"])
def test_pulse_work_and_share_by_hand(config, per_substep):
    ops, nbytes = llgs.pulse_work(DURATIONS, config)
    assert ops == 6450 * per_substep
    assert nbytes == 5 * 33
    share, bound = llgs.roofline_share(ops, nbytes, 1e-3)
    assert bound == "compute"
    assert share == pytest.approx(100 * ops / 67e12 / 1e-3, rel=1e-12)
    # Bytes bound only where the work is tiny against its size.
    assert llgs.roofline_share(1.0, 1e6, 1.0)[1] == "bytes"


def test_dt_law_matches_the_reference():
    g = torch.Generator().manual_seed(3)
    span = (1e-12 + (5e-9 - 1e-12) * torch.rand(4096, generator=g)).float()
    _, n = ref.dt_law(span, 1e-12, ref.max_substeps_for(5e-9, 1e-12))
    assert llgs.substeps(span.numpy(), 1e-12, 5e-9).tolist() == n.tolist()
