"""Process-group initialization and multi-process utilities.

PyTorch counterpart of ``spintorque_tpu/parallel/distributed.py``. One
process per card: ``initialize()`` joins the process group (torchrun's
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` by default), and
``parallel.mesh.make_mesh`` then lays the ranks out as a ('data', 'model')
mesh. ``torch.distributed`` carries the few collectives (metric means,
gradient averages); the env step itself needs none.

    torchrun --nproc_per_node 4 train.py   # train.py calls initialize()

``spawn_ranks`` runs a function in several processes of one host without
torchrun (tests, and two ranks sharing one card).
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.profiling import always_span


def _local_rank(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the default process group, once per process.

    Does nothing in a single process (world size 1 and no ``init_method``),
    so the same script runs unchanged on one card or many, and nothing when
    the group already exists. Arguments default to torchrun's environment:
    ``WORLD_SIZE``, ``RANK`` and ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``). The backend defaults to ``nccl`` when the ranks hold
    CUDA devices, else ``gloo``; with CUDA each rank's current device is
    its local rank's card (``LOCAL_RANK``, else rank mod the device count).
    """
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(_local_rank(rank))
    with always_span("mesh.initialize"):  # once a process: recorded with tracing off too
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)


def is_multihost() -> bool:
    """True when more than one process takes part (the JAX package's
    process count > 1)."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> dict:
    initialized = dist.is_initialized()
    cuda = torch.cuda.is_available()
    return {
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": dist.get_world_size() if initialized else 1,
        "local_device_count": torch.cuda.device_count() if cuda else 1,
        "global_device_count": dist.get_world_size() if initialized else 1,  # one card per rank
        "backend": dist.get_backend() if initialized else None,
        "device": "cuda" if cuda else "cpu",
    }


def _rank_main(rank: int, fn, world_size: int, init_method: str, backend: str,
               out_dir: str, args: Sequence[Any]) -> None:
    out = Path(out_dir) / f"rank{rank}"
    try:
        initialize(init_method, world_size, rank, backend)
        result = fn(*args)
        torch.save(result, f"{out}.pt")
    except BaseException:
        Path(f"{out}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(
    fn: Callable[..., Any],
    world_size: int,
    args: Sequence[Any] = (),
    backend: str = "gloo",
    timeout: float = 120.0,
    workdir: Optional[str] = None,
) -> List[Any]:
    """Run ``fn(*args)`` in ``world_size`` spawned processes of this host,
    each after ``initialize`` with a ``file://`` rendezvous in ``workdir``
    (a new temporary directory by default), and return each rank's result
    (passed back with ``torch.save``, so results hold CPU tensors or plain
    values).

    ``fn`` must be importable (a module-level function). Raises
    ``TimeoutError`` and kills every rank when they have not all ended
    within ``timeout`` seconds, and ``RuntimeError`` with each failed rank's
    traceback when any rank fails.
    """
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        ctx = mp.get_context("spawn")
        procs = [
            ctx.Process(target=_rank_main,
                        args=(r, fn, world_size, init_method, backend, tmp, tuple(args)))
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        # Until every rank has ended, one has failed (the others would wait
        # for it in a collective), or the time is up.
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = [p.exitcode for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.05)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        for p in procs:
            p.join()
        errors = []
        for r, p in enumerate(procs):
            err = Path(tmp) / f"rank{r}.err"
            if err.is_file():
                errors.append(f"rank {r} exited with {p.exitcode}:\n{err.read_text()}")
            elif p.exitcode != 0 and p not in alive:
                errors.append(f"rank {r} exited with {p.exitcode}")
        if errors:
            raise RuntimeError("\n".join(errors))
        if alive:
            raise TimeoutError(f"{len(alive)} of {world_size} ranks still ran after {timeout} s")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world_size)]
