"""The share of the port's racetrack steps that ran as a CUDA graph's
replay: ``racetrack.graph_replays`` over ``racetrack.steps``, the port's
host counters over the whole run (warm-up, window and traced windows; the
reference calls neither), read from its store through
``lib/racetrack_program.py``. None where the port has neither counter (one
older than the graphed racetrack step) or counted no step, and without a
CUDA device, where no step is replayed."""

import torch

from perfbench.lib import racetrack_program


def read(records):
    return racetrack_program.replay_share() if torch.cuda.is_available() else None
