"""One process a card for a cell on several cards.

The process that ``run.py`` starts is rank 0; it starts ranks 1 … W-1 as
copies of itself with ``--rank``, ``--world`` and ``--rendezvous`` (a
``file://`` path in the run's temporary directory), and each rank joins
the process group through the port's ``parallel.initialize``. Only rank 0
prints a result. Rank 0 waits for every rank it started and ends any that
outlive it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import uuid
from typing import List

JOIN_SECONDS = 120


def rendezvous() -> str:
    """A fresh ``file://`` rendezvous in the temporary directory."""
    return "file://" + os.path.join(tempfile.gettempdir(), f"perfbench-{uuid.uuid4().hex}")


def spawn(argv: List[str], world: int, url: str, logs: str) -> List[subprocess.Popen]:
    """Ranks 1 … world-1 of ``run.py`` with ``argv``; each writes its
    output to ``<logs>.<rank>``."""
    procs = []
    for rank in range(1, world):
        out = open(f"{logs}.{rank}", "w")
        procs.append(subprocess.Popen(
            [sys.executable, *argv, "--rank", str(rank), "--world", str(world),
             "--rendezvous", url], stdout=out, stderr=subprocess.STDOUT))
        out.close()
    return procs


def join(procs: List[subprocess.Popen], logs: str) -> List[str]:
    """Waits for each rank; ends one that does not finish in time. Returns
    the tails of the logs of the ranks that failed."""
    failed = []
    for rank, p in enumerate(procs, start=1):
        try:
            rc = p.wait(timeout=JOIN_SECONDS)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        if rc != 0:
            with open(f"{logs}.{rank}") as f:
                failed.append(f"rank {rank} exited {rc}: " + f.read()[-2000:])
    for rank in range(1, len(procs) + 1):
        try:
            os.unlink(f"{logs}.{rank}")
        except OSError:
            pass
    return failed
