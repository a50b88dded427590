"""The share of the port's array steps that ran as a CUDA graph's replay:
``array.graph_replays`` over ``array.steps``, the port's host counters
over the whole run (warm-up, window and traced windows; the reference
calls neither), read from its store through ``lib/array_program.py``.
None where the port has neither counter (one older than the graphed array
step) or counted no step, and without a CUDA device, where no step is
replayed."""

import torch

from perfbench.lib import array_program

REPLAYS, STEPS = "array.graph_replays", "array.steps"


def read(records):
    if not torch.cuda.is_available():
        return None
    counts = array_program._store().counters()
    if REPLAYS not in counts or STEPS not in counts:
        return None
    return counts[REPLAYS] / counts[STEPS] if counts[STEPS] else None
