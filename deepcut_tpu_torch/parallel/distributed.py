"""The process group of a multi-GPU job: one process per GPU.

Counterpart of `deepcut_tpu.parallel.distributed`. The JAX package runs
one process per host over a device mesh (`jax.distributed`); the PyTorch
idiom is one process per GPU under ``torchrun``, joined by a
`torch.distributed` process group — NCCL between cards, gloo on the CPU.
Call `initialize()` in every process, then build the mesh
(`global_mesh()` or `parallel.mesh.make_mesh`)::

    torchrun --nproc_per_node 4 -m deepcut_tpu_torch.tools.cli train -solver S -mesh 4
    torchrun --nproc_per_node 4 -m deepcut_tpu_torch.tools.cli train -solver S -mesh 4 -spatial 2

A group that cannot form raises: nothing falls back to one process.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

_DEVICE: Optional[torch.device] = None   # the device `initialize` bound this process to


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise RuntimeError(
            f"distributed.initialize: {name} is not set; start one process per GPU under "
            "torchrun (torchrun --nproc_per_node N ...), or pass world_size, rank and "
            "init_method")
    return int(os.environ[name])


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, *, device: Union[str, torch.device] = "cuda",
               backend: Optional[str] = None) -> torch.device:
    """Join the job's process group and return this process's device.

    The arguments default to torchrun's environment: ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK`` and (``env://``) ``MASTER_ADDR`` /
    ``MASTER_PORT``. device: ``"cuda"`` (the default) binds this process to
    ``cuda:<LOCAL_RANK>`` (`torch.cuda.set_device`), ``"cuda:i"`` to card
    i, ``"cpu"`` to the CPU. backend: NCCL for a card and gloo for the CPU
    unless given (gloo also takes CUDA tensors, through the host)."""
    global _DEVICE
    if dist.is_initialized():
        raise RuntimeError("distributed.initialize: the process group exists already")
    world_size = _env_int("WORLD_SIZE", world_size)
    rank = _env_int("RANK", rank)
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _DEVICE = dev
    return dev


def device() -> Optional[torch.device]:
    """The device `initialize` bound this process to (None before it)."""
    return _DEVICE


def global_mesh(*, spatial: int = 1):
    """The ('data', 'spatial') mesh over every process of the job: world /
    spatial data rows of `spatial` row shards each."""
    from deepcut_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(spatial=spatial)


def is_coordinator() -> bool:
    """Rank 0 of the job, or a process outside any job."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group (every rank calls it at the end)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None
