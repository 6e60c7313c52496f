"""Data-parallel meshes over a `torch.distributed` process group.

Counterpart of `deepcut_tpu.parallel.mesh` for its 'data' axis. The JAX
package shards one program over a ('data', 'spatial') device mesh in one
process; here each process drives one GPU (`parallel.distributed`):

- parameters and solver state are replicated: broadcast from rank 0 once
  (`replicated`), then every rank applies the same update;
- each rank computes its rows of the global batch (`shard_batch`);
- the gradients are all-reduced with SUM, coalesced into a few flat
  buckets (`all_reduce_sum`), before the Caffe update;
- inside `data_parallel(mesh)` the losses divide by GLOBAL normalisers
  (`ops.losses.sharded_losses`), BatchNorm in TRAIN normalises with the
  global batch's moments (`ops.norm.sharded_bn_stats`), and Dropout,
  STOCHASTIC pooling and random DummyData draw the global batch and keep
  the rank's rows (`ops.shard_rng`).

So a step equals one device's step on the global batch. Plain DDP
averaging would equal it only where every rank's normaliser is the same,
which VALID counts with ignore_label, smooth-L1 weight sums and BatchNorm
moments are not. Row-sharded ('spatial') training is the spatial slice
of the port (`parallel/spatial.py`), not ported yet: ``spatial > 1``
raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

import torch
import torch.distributed as dist

from deepcut_tpu_torch.ops.losses import sharded_losses
from deepcut_tpu_torch.ops.norm import sharded_bn_stats
from deepcut_tpu_torch.ops.shard_rng import sharded_rng_batch
from deepcut_tpu_torch.parallel import distributed

SPATIAL_MESSAGE = ("spatial > 1 (image rows sharded over a 'spatial' axis: halo exchange, "
                   "parallel/spatial.py and parallel/graph_spatial.py) belongs to the spatial "
                   "slice of the port, which is not ported yet (data-parallel meshes take "
                   "spatial=1)")
BUCKET_BYTES = 64 << 20   # the gradient all-reduce's flat buckets


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'spatial') mesh over a process group: this process is
    rank `rank` of `data` along the 'data' axis, on `device`."""

    group: Any            # torch.distributed ProcessGroup (None: the default group)
    rank: int
    data: int
    spatial: int
    device: torch.device

    def is_coordinator(self) -> bool:
        return self.rank == 0

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the mesh's ranks, in place; returns `t`."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def make_mesh(n_devices: Optional[int] = None, *, data: Optional[int] = None,
              spatial: int = 1, device: Union[str, torch.device, None] = None) -> Mesh:
    """The mesh over the job's process group (`distributed.initialize`
    first). n_devices must equal the world size; data defaults to it.
    device: the one `initialize` bound this process to, else
    ``cuda:<current>`` under NCCL, else ``"cuda"``."""
    if spatial != 1:
        raise NotImplementedError(SPATIAL_MESSAGE)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group. Start one process per GPU (torchrun "
            "--nproc_per_node N ...) and call deepcut_tpu_torch.parallel.distributed."
            "initialize() in each; on the CPU, a gloo group of N processes")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise RuntimeError(
            f"make_mesh: {n_devices} devices requested but the process group has {world} "
            f"ranks. Launch one process per device (torchrun --nproc_per_node {n_devices} "
            f"...), or on the CPU a gloo group of {n_devices} processes")
    data = world if data is None else int(data)
    if data * spatial != world:
        raise ValueError(f"make_mesh: data={data} x spatial={spatial} != {world} ranks")
    if device is None:
        device = distributed.device()
    if device is None:
        device = (f"cuda:{torch.cuda.current_device()}" if dist.get_backend() == "nccl"
                  else "cuda")
    return Mesh(group=None, rank=dist.get_rank(), data=data, spatial=spatial,
                device=torch.device(device))


def check_data_mesh(mesh: Optional[Mesh]) -> None:
    """A mesh a data-parallel path takes: None or spatial == 1 (a spatial
    axis raises: the spatial slice of the port)."""
    if mesh is not None and mesh.spatial != 1:
        raise NotImplementedError(SPATIAL_MESSAGE)


def shard_batch(mesh: Mesh, batch: Mapping[str, Any], axis: int = 0) -> Dict[str, Any]:
    """This rank's rows of every entry (numpy or tensor) along `axis` (1
    behind an iter_size axis). A batch that does not split evenly raises."""
    out = {}
    for k, v in batch.items():
        n = v.shape[axis]
        if n % mesh.data:
            raise ValueError(f"shard_batch: '{k}' has {n} rows along axis {axis}, "
                             f"not divisible by the {mesh.data} data-parallel ranks")
        rows = n // mesh.data
        index = [slice(None)] * v.ndim
        index[axis] = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
        out[k] = v[tuple(index)]
    return out


def _buckets(tensors: List[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    """Consecutive runs of one dtype and device of at most BUCKET_BYTES
    (a larger tensor alone)."""
    run: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + nbytes > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


@torch.no_grad()
def _coalesced(tensors: List[torch.Tensor], collective) -> None:
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        parts = flat.split([t.numel() for t in bucket])
        torch._foreach_copy_(bucket, [v.view_as(t) for t, v in zip(bucket, parts)])


def all_reduce_sum(mesh: Mesh, tensors: List[torch.Tensor]) -> None:
    """Sum every tensor over the mesh in place, a few flat buckets at a
    time (one all-reduce per bucket, not per tensor)."""
    _coalesced(tensors, mesh.all_reduce_)


def replicated(mesh: Mesh, tensors: List[torch.Tensor]) -> None:
    """Every rank's tensors set to rank 0's, in place (bucketed broadcasts)."""
    _coalesced(tensors, lambda t: dist.broadcast(t, src=0, group=mesh.group))


def tree_leaves(tree: Mapping[str, Mapping[str, torch.Tensor]]) -> List[torch.Tensor]:
    """The tensors of a {layer: {key: tensor}} tree in a fixed order."""
    return [tree[n][k] for n in sorted(tree) for k in sorted(tree[n])]


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Global-batch semantics for what runs inside: the losses' and
    Accuracy's normalisers, BatchNorm's moments and the stochastic draws
    (a no-op for ``mesh=None``)."""
    with sharded_losses(mesh), sharded_bn_stats(mesh), sharded_rng_batch(mesh):
        yield


def broadcast_int(mesh: Mesh, value: int) -> int:
    """Rank 0's integer (a seed), on every rank."""
    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    dist.broadcast(t, src=0, group=mesh.group)
    return int(t.item())


def gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows concatenated in rank order (the global batch)."""
    parts = [torch.empty_like(t) for _ in range(mesh.data)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)

