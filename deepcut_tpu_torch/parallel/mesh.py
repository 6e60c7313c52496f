"""Meshes over a `torch.distributed` process group: the ('data', 'spatial') axes.

Counterpart of `deepcut_tpu.parallel.mesh`. The JAX package shards one
program over a ('data', 'spatial') device mesh in one process; here each
process drives one GPU (`parallel.distributed`) and the mesh lays the
ranks out as the JAX package's ``reshape(data, spatial)`` does: rank
``d * spatial + s`` holds data row d and row shard s. Each axis is a
process sub-group (`Axis`): the ranks of one data row form its 'spatial'
axis and the ranks of one spatial index its 'data' axis.

- parameters and solver state are replicated: broadcast from rank 0 once
  (`replicated`), then every rank applies the same update;
- each rank computes its rows of the global batch, and with a spatial
  axis its block of the image rows (`shard_batch`);
- the gradients are all-reduced with SUM over the whole mesh, coalesced
  into a few flat buckets (`all_reduce_sum`), before the Caffe update;
- inside `data_parallel(mesh)` the losses divide by GLOBAL normalisers
  (`ops.losses.sharded_losses`), BatchNorm in TRAIN normalises with the
  global batch's moments (`ops.norm.sharded_bn_stats`), and Dropout,
  STOCHASTIC pooling and random DummyData draw the global batch and keep
  the rank's rows (`ops.shard_rng`), each over the 'data' axis.

So a step equals one device's step on the global batch. Plain DDP
averaging would equal it only where every rank's normaliser is the same,
which VALID counts with ignore_label, smooth-L1 weight sums and BatchNorm
moments are not. Row-sharded training and serving (halo exchange, the
gather before the heads) are `parallel.spatial` and
`parallel.graph_spatial`.
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

BUCKET_BYTES = 64 << 20   # the gradient all-reduce's flat buckets
SPATIAL_KEYS = ("image", "aug_canvas")   # the batch entries whose rows shard over 'spatial'


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh: the `size` ranks of a process group (None: the
    whole job), this one at `index` along it."""

    group: Any
    size: int
    index: int

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the axis, in place; returns `t`."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `t` (one shape on all), in axis order."""
        if self.size == 1:
            return [t]
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return parts


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'spatial') mesh over a process group: this process is
    rank `rank` = data_index * spatial + spatial_index, on `device`.
    data_group / spatial_group: the sub-groups of its 'data' and 'spatial'
    axes (`make_mesh` makes them; None where the axis is the whole job)."""

    group: Any            # torch.distributed ProcessGroup (None: the default group)
    rank: int
    data: int
    spatial: int
    device: torch.device
    data_group: Any = None
    spatial_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def data_axis(self) -> Axis:
        """The ranks of this rank's spatial index: one per data row."""
        return Axis(self.group if self.spatial == 1 else self.data_group, self.data,
                    self.data_index)

    @property
    def spatial_axis(self) -> Axis:
        """The ranks of this rank's data row: one per row shard."""
        return Axis(self.group if self.data == 1 else self.spatial_group, self.spatial,
                    self.spatial_index)

    @property
    def world_axis(self) -> Axis:
        """Both axes: every rank of the mesh."""
        return Axis(self.group, self.data * self.spatial, self.rank)

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
    first), laid out as the JAX package's ``reshape(data, spatial)``.
    n_devices must equal the world size; data defaults to it over
    `spatial`. Every rank makes the axes' sub-groups, in the same order.
    device: the one `initialize` bound this process to, else
    ``cuda:<current>`` under NCCL, else ``"cuda"``."""
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
    spatial = int(spatial)
    if spatial < 1 or world % spatial:
        raise ValueError(f"make_mesh: {world} ranks not divisible by spatial={spatial}")
    data = world // spatial if data is None else int(data)
    if data * spatial != world:
        raise ValueError(f"make_mesh: data={data} x spatial={spatial} != {world} ranks")
    if device is None:
        device = distributed.device()
    if device is None:
        device = (f"cuda:{torch.cuda.current_device()}" if dist.get_backend() == "nccl"
                  else "cuda")
    rank = dist.get_rank()
    # the sub-groups: every data row's 'spatial' axis, then every spatial
    # index's 'data' axis (new_group is collective: all ranks, one order)
    spatial_group = data_group = None
    if spatial > 1 and data > 1:
        rows = [dist.new_group(list(range(d * spatial, (d + 1) * spatial))) for d in range(data)]
        cols = [dist.new_group(list(range(s, world, spatial))) for s in range(spatial)]
        spatial_group, data_group = rows[rank // spatial], cols[rank % spatial]
    return Mesh(group=None, rank=rank, data=data, spatial=spatial,
                device=torch.device(device), data_group=data_group,
                spatial_group=spatial_group)


def _block(v, axis: int, parts: int, index: int, key: str, ranks: str):
    n = v.shape[axis]
    if n % parts:
        raise ValueError(f"shard_batch: '{key}' has {n} rows along axis {axis}, "
                         f"not divisible by the {parts} {ranks}")
    rows = n // parts
    sl = [slice(None)] * v.ndim
    sl[axis] = slice(index * rows, (index + 1) * rows)
    return v[tuple(sl)]


def shard_batch(mesh: Mesh, batch: Mapping[str, Any], axis: int = 0,
                rows: Optional[Mapping[str, int]] = None) -> Dict[str, Any]:
    """This rank's share of every entry (numpy or tensor): its data row's
    block along `axis` (1 behind an iter_size axis) and, for the entries of
    `rows` ({key: row axis}; by default `SPATIAL_KEYS` at axis + 1, the
    NHWC canvas), its block of rows over the 'spatial' axis. Everything
    else (targets, annotations, raw images, warp coefficients) is sharded
    over 'data' only. A batch that does not split evenly raises."""
    if rows is None:
        rows = {k: axis + 1 for k in SPATIAL_KEYS} if mesh.spatial > 1 else {}
    out = {}
    for k, v in batch.items():
        v = _block(v, axis, mesh.data, mesh.data_index, k, "data-parallel ranks")
        if k in rows and mesh.spatial > 1:
            v = _block(v, rows[k], mesh.spatial, mesh.spatial_index, k, "row shards")
        out[k] = v
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
    Accuracy's normalisers, BatchNorm's moments and the stochastic draws,
    each over the mesh's 'data' axis (a no-op for ``mesh=None``). Under a
    spatial axis this is the replicated part after the gather: within a
    data row every rank computes the same rows."""
    axis = None if mesh is None else mesh.data_axis
    with sharded_losses(axis), sharded_bn_stats(axis), sharded_rng_batch(axis):
        yield


def broadcast_int(mesh: Mesh, value: int) -> int:
    """Rank 0's integer (a seed), on every rank."""
    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    dist.broadcast(t, src=0, group=mesh.group)
    return int(t.item())


def gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every data row's batch rows concatenated in order (the global batch)."""
    return torch.cat(mesh.data_axis.all_gather(t))

