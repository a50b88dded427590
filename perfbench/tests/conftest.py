"""Shared fixtures of the benchmark's own tests.

Run on the CPU with ``python -m pytest perfbench/tests -q`` from the root of
the checkout; the card's cases carry the ``cuda`` marker and skip without a
card (``python -m pytest perfbench/tests -m cuda -q`` on the card's machine).
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# A tiny size of every cell, for the CPU: a few envs, pulses of at most
# 20 ps (100 substeps), a narrow policy, short windows, every step compared.
TINY = {"batch": 8, "traffic": {"duration": [1e-12, 2e-11]}, "check": {"every": 1},
        "warmup_programs": 0, "block_programs": 1, "program_steps": 2, "trace_programs": 1,
        "warmup_steps": 1, "trace_steps": 2, "ppo": {"hidden_sizes": [16, 16]}}
# The policy's pulses reach max_duration: 20 ps keeps them at 100 substeps.
TINY_CONFIG = {"env": {"max_duration": 2e-11}}


@pytest.fixture
def card():
    """The CUDA device; skips where torch sees none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")
