"""Rollout collection and the data-parallel path over torch.distributed.

``distributed.initialize`` joins the process group, ``make_mesh`` lays the
ranks out as a ('data', 'model') mesh, and each rank holds its rows of the
env batch (``SpinTorqueEnv(mesh=...)``, ``shard_env_state``); metrics are
reduced with ``pmean_metrics``.
"""

from . import distributed
from .distributed import initialize, is_multihost, process_info, spawn_ranks
from .mesh import (
    MODEL_ALL_REDUCES,
    Mesh,
    all_reduce,
    gather_batch,
    local_batch_size,
    make_mesh,
    model_all_reduce,
    pmean_metrics,
    resolve_device,
    shard_batch,
    shard_env_state,
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
    "make_mesh",
    "model_all_reduce",
    "pmean_metrics",
    "resolve_device",
    "shard_batch",
    "shard_env_state",
    "Trajectory",
    "random_policy",
    "rollout",
    "summarize",
]
