"""The ('data', 'model') rank mesh and the helpers of the data-parallel path.

PyTorch counterpart of ``spintorque_tpu/parallel/mesh.py``. One process
drives one card, so a mesh is a layout of the ranks of the default process
group (``parallel.distributed.initialize``), built with
``torch.distributed.device_mesh.init_device_mesh``:

  * 'data'  - the env batch axis: rank r of W holds global rows
    [r B/W, (r+1) B/W) of every batch-major tensor (pure data parallel);
  * 'model' - the tensor-parallel axis of the policy network
    (``rl.ActorCritic(mesh=...)``): each rank holds a slice of every
    hidden layer, and the ranks of one data coordinate hold the same env
    rows, as the JAX package replicates the batch across 'model'.

Each env is independent, so the env step needs no collective; the ranks
meet only to reduce metrics and, in the trainer, gradients over 'data',
and to sum the policy's partial products over 'model'
(``model_all_reduce``, the one collective of that axis). The JAX
package's ``env_sharding`` and ``replicated`` have no counterpart: a JAX
array carries its sharding, a torch tensor is a rank's own rows, and what
would be replicated is simply the same on every rank.

A global batch whose size does not divide the data axis (a batch of one
included) is replicated, as the JAX package's ``shard_env_state``
replicates it (``spintorque_tpu/parallel/mesh.py:66``): every rank holds
all of its rows (``local_rows``) and runs them as one process does, with
no collective, and its pulse is the unsharded kernel
(``integrate_pulse(mesh=split_mesh(B, mesh))``). The helpers
whose JAX counterparts need a divisible batch, ``local_batch_size`` and
``shard_batch``, raise as those do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..utils.profiling import counter, span

Tensor = torch.Tensor

# All-reduces over the 'model' axis (``model_all_reduce``), every caller's.
MODEL_ALL_REDUCES = counter("mesh.model_all_reduces")
# Every all-reduce issued by ``all_reduce`` and ``model_all_reduce``, and
# the bytes of the tensors they reduced.
ALL_REDUCES = counter("mesh.all_reduces")
ALL_REDUCE_BYTES = counter("mesh.all_reduce_bytes")


def _all_reduce(x: Tensor, op, group) -> None:
    """``dist.all_reduce`` in place, counted and inside the span
    ``mesh.all_reduce``."""
    with span("mesh.all_reduce"):
        dist.all_reduce(x, op=op, group=group)
    ALL_REDUCES.add()
    ALL_REDUCE_BYTES.add(x.numel() * x.element_size())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The rank mesh as this rank sees it.

    ``shape`` is {"data": n_data, "model": n_model}; ``device`` is this
    rank's device; ``device_mesh`` is the torch ``DeviceMesh``, or None in a
    single process without a process group (a 1 x 1 mesh whose collectives
    are the identity)."""

    shape: Dict[str, int]
    device: torch.device
    device_mesh: Any = None

    @property
    def data_rank(self) -> int:
        """This rank's index along 'data'."""
        return 0 if self.device_mesh is None else int(self.device_mesh.get_coordinate()[0])

    @property
    def data_group(self):
        return None if self.device_mesh is None else self.device_mesh.get_group("data")

    @property
    def model_rank(self) -> int:
        """This rank's index along 'model'."""
        return 0 if self.device_mesh is None else int(self.device_mesh.get_coordinate()[1])

    @property
    def model_group(self):
        return None if self.device_mesh is None else self.device_mesh.get_group("model")

    @property
    def backend(self) -> Optional[str]:
        return None if self.device_mesh is None else dist.get_backend()


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device="cuda") -> Mesh:
    """A ('data', 'model') mesh over the ranks of the process group.

    Defaults to every rank on the data axis; raises when n_data x n_model
    is not the world size (1 without a process group). ``device`` is the
    rank's device type: "cuda" (the card ``initialize`` made current) or
    "cpu"."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world or n_data < 1:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} ranks")
    device = resolve_device(device, None)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    device_mesh = None
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(device.type, (n_data, n_model),
                                       mesh_dim_names=("data", "model"))
    return Mesh({"data": n_data, "model": n_model}, device, device_mesh)


def resolve_device(device, mesh: Optional[Mesh]) -> torch.device:
    """The device of an entry point: the mesh's when a mesh is given (an
    explicit ``device`` of another type raises), else ``device``, "cuda"
    when None. Raises on a device other than cuda or cpu, and on "cuda"
    where torch sees no card."""
    if mesh is not None:
        if device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"the mesh is on {mesh.device}, not {device}")
        return mesh.device
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"runs on cuda or cpu, not {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device; pass device='cpu'")
    return device


def replicates(batch: int, mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` replicates a global batch of ``batch`` rows: its size
    does not divide the data axis (a batch of one on two or more ranks
    included), so every rank holds all of them. False without a mesh."""
    return mesh is not None and batch % mesh.shape["data"] != 0


def local_rows(batch: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global batch of ``batch``: its shard
    [r B/W, (r+1) B/W) when the batch divides the data axis, every row when
    the mesh replicates it (``replicates``) or there is no mesh."""
    if mesh is None or replicates(batch, mesh):
        return slice(0, batch)
    n = batch // mesh.shape["data"]
    return slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)


def split_mesh(batch: int, mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh a global batch of ``batch`` rows is split over: ``mesh``, or
    None without one or where it replicates the batch (every rank then holds
    all of it, and its reductions are one process's)."""
    return None if replicates(batch, mesh) else mesh


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Rows of each shard of a global batch; raises when the batch does not
    divide the data axis, as the JAX package's does
    (``spintorque_tpu/parallel/mesh.py:97``). ``local_rows`` gives the rows
    of a replicated batch too."""
    n = mesh.shape["data"]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {n} "
                         "(spintorque_tpu/parallel/mesh.py:97 raises too)")
    return global_batch // n


def shard_batch(x: Tensor, mesh: Mesh) -> Tensor:
    """This rank's rows of a global (B, ...) tensor. Raises when B does not
    divide the data axis, as the JAX package's ``device_put`` onto the
    batch sharding does (``spintorque_tpu/parallel/mesh.py:75``);
    ``shard_env_state`` replicates such a tensor."""
    B = x.shape[0]
    n = mesh.shape["data"]
    if B % n:
        raise ValueError(f"global batch {B} not divisible by data axis {n} "
                         "(spintorque_tpu/parallel/mesh.py:75 raises too)")
    return x[local_rows(B, mesh)]


def shard_env_state(state, mesh: Mesh):
    """This rank's rows of a global (unsharded) EnvState, or of any nest of
    tensors in dataclasses and dicts: every tensor of one or more
    dimensions gives its ``local_rows``, so a leading dimension that
    does not divide the data axis (or is 1) is replicated, as the JAX
    package places it (``spintorque_tpu/parallel/mesh.py:58-70``); 0-dim
    tensors and host fields (seed, counter) are kept. Equals the state that
    ``SpinTorqueEnv(mesh=mesh)`` returns from ``reset`` with the same
    seed."""
    def place(x):
        if isinstance(x, Tensor):
            return x[local_rows(x.shape[0], mesh)] if x.ndim >= 1 else x
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: place(getattr(x, f.name))
                                             for f in dataclasses.fields(x) if f.init})
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        return x

    return place(state)


def all_reduce(x: Tensor, mesh: Optional[Mesh], op=None) -> Tensor:
    """``x`` reduced over the data axis (SUM by default), in place; the
    identity without a mesh or without a process group."""
    if mesh is not None and mesh.device_mesh is not None:
        _all_reduce(x, dist.ReduceOp.SUM if op is None else op, mesh.data_group)
    return x


def model_all_reduce(x: Tensor, mesh: Optional[Mesh]) -> Tensor:
    """The SUM of ``x`` over the 'model' axis, as a new tensor; a copy
    without a process group. Floating types narrower than float32 are
    summed in float32 and returned so (the caller rounds once); every
    other dtype keeps its own. The one collective of the 'model' axis: an
    all-reduce works on gloo with CUDA tensors (two ranks sharing one
    card), where gloo lacks all-gather and reduce-scatter. Counts in
    ``MODEL_ALL_REDUCES``."""
    wide = x.dtype in (torch.bfloat16, torch.float16)
    y = x.to(torch.float32) if wide else x.clone()
    if mesh is not None and mesh.device_mesh is not None:
        _all_reduce(y, dist.ReduceOp.SUM, mesh.model_group)
        MODEL_ALL_REDUCES.add()
    return y


def gather_batch(x: Tensor, mesh: Optional[Mesh]) -> Tensor:
    """The global (B, ...) tensor from every rank's rows (the inverse of
    ``shard_batch``), on every rank."""
    if mesh is None or mesh.device_mesh is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.shape["data"])]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def pmean_metrics(tree, mesh: Optional[Mesh]):
    """Global mean of each metric leaf, the same on every rank.

    Leaves are tensors (a rank's rows of per-env metrics, or scalars) or
    numbers, in nested dicts; each becomes a 0-dim tensor, the mean over
    every rank's elements. One ``all_reduce(SUM)`` carries each leaf's sum
    and element count, in float64, and the division follows it
    (``ReduceOp.AVG`` exists only on NCCL)."""
    leaves = []

    def collect(t):
        if isinstance(t, dict):
            return {k: collect(v) for k, v in t.items()}
        leaves.append(torch.as_tensor(t))
        return len(leaves) - 1

    index = collect(tree)
    if not leaves:
        return tree
    device = mesh.device if mesh is not None else leaves[0].device
    sums = [x.to(device, torch.float64).sum() for x in leaves]
    # Filled on the device: a tensor made from a host list would sync.
    counts = [torch.full((), float(x.numel()), dtype=torch.float64, device=device) for x in leaves]
    totals = all_reduce(torch.stack(sums + counts), mesh)
    means = totals[:len(leaves)] / totals[len(leaves):]

    def place(i):
        if isinstance(i, dict):
            return {k: place(v) for k, v in i.items()}
        x = leaves[i]
        dtype = x.dtype if x.is_floating_point() else torch.get_default_dtype()
        return means[i].to(dtype)

    return place(index)
