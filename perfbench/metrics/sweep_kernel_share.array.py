"""The share of the port's sequential sweeps that ran as its one CUDA
kernel: ``array.sweep_kernels`` over ``array.sweep_kernels`` plus
``array.sweep_eager``, the port's host counters over the whole run
(warm-up, window and traced windows; the reference calls neither), read
from its store through ``lib/array_program.py``. None where the port has
neither counter (one older than the kernel) or counted no sweep, and
without a CUDA device, where no kernel route exists to take a share of."""

import torch

from perfbench.lib import array_program

KERNELS, EAGER = "array.sweep_kernels", "array.sweep_eager"


def read(records):
    if not torch.cuda.is_available():
        return None
    counts = array_program._store().counters()
    if KERNELS not in counts and EAGER not in counts:
        return None
    kernels = counts.get(KERNELS, 0)
    total = kernels + counts.get(EAGER, 0)
    return kernels / total if total else None
