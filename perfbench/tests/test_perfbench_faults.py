"""The check's control and the faults a cell can have (``lib/faults.py``),
each seen as ``correct`` false: the harness without its look for a card,
driving the rest of a run on the CPU at a tiny size with the timed path
broken underneath. The four-card cell's faults, the exchange between
cards left out among them, are read on four gloo ranks
(``test_perfbench_ranks.py``)."""

from __future__ import annotations

import pytest
from conftest import TINY, TINY_CONFIG

from perfbench.lib import faults, manifest, runner

# The one-card cells; the four-card path has its own test on four gloo ranks.
CELLS = [w["name"] for w in manifest.manifest()["workloads"] if w["chips"] == 1]


def _run(cell, overrides=TINY, **kw):
    return runner.run_cell(cell, 20261017, 0.3, False, device="cpu", overrides=overrides,
                           config_overrides=TINY_CONFIG, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_tiny_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_bf16_stages_is_not_correct(cell):
    """Pulses of at most 20 ps part float32 from bf16 by little: a zero-
    current pulse from a fresh state shows it, a fifth of the draws, so the
    rollout gets 128 pulses."""
    assert not _run(cell, dict(TINY, batch=32, program_steps=4), control=True)["correct"]


@pytest.mark.parametrize("fault", faults.ONE_CARD)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault):
    out = _run(cell, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_float32_passes_at_the_cell_size_on_the_card(card, cell):
    """Three seeds at the cell's own size and window: a shorter window holds
    fewer of the zero-current pulses (a fifth of the draws) from a fresh
    state that tell bf16 from float32 in the Gymnasium cell."""
    seconds = manifest.manifest()["run_seconds"]
    for seed in (2**31 + 11, 2**32 + 13, 2**33 + 17):
        assert runner.run_cell(cell, seed, seconds, False, device="cuda")["correct"]
        assert not runner.run_cell(cell, seed, seconds, False, device="cuda",
                                   control=True)["correct"]
