"""Rollout collection and the data-parallel path over torch.distributed.

``distributed.initialize`` joins the process group, ``make_mesh`` lays the
ranks out as a ('data', 'model') mesh, and each rank holds its rows of the
env batch (``SpinTorqueEnv(mesh=...)``, ``shard_env_state``), or all of
it where the batch does not divide the data axis (``local_rows``); metrics
are reduced with ``pmean_metrics``.
"""

from . import distributed
from .distributed import initialize, is_multihost, process_info, spawn_ranks
from .mesh import (
    MODEL_ALL_REDUCES,
    Mesh,
    all_reduce,
    gather_batch,
    local_batch_size,
    local_rows,
    make_mesh,
    model_all_reduce,
    pmean_metrics,
    replicates,
    resolve_device,
    shard_batch,
    shard_env_state,
    split_mesh,
)
from .rollout import Trajectory, random_policy, rollout, summarize

__all__ = [
    "distributed",
    "initialize",
    "is_multihost",
    "process_info",
    "spawn_ranks",
    "MODEL_ALL_REDUCES",
    "Mesh",
    "all_reduce",
    "gather_batch",
    "local_batch_size",
    "local_rows",
    "make_mesh",
    "model_all_reduce",
    "pmean_metrics",
    "replicates",
    "resolve_device",
    "shard_batch",
    "shard_env_state",
    "split_mesh",
    "Trajectory",
    "random_policy",
    "rollout",
    "summarize",
]
