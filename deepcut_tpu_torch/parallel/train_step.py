"""The train and eval steps, on one device or data-parallel, and the
batch's way onto the device.

Counterpart of `deepcut_tpu.parallel.train_step`: one call is the
reference hot loop (Net::ForwardBackward + P2PSync's reduce +
SGDSolver::ApplyUpdate, solver.cpp:193-275) — device warp, device
targets, forward, the fork's losses, backward, the Caffe update rule.
With a data-parallel `parallel.mesh.Mesh` each rank takes its rows of the
global batch, its losses divide by the global normalisers, and the
gradients are summed over the ranks in flat buckets before the update, so
the step equals one device's on the global batch. With a spatial axis
the same step runs over row blocks (`batch_preparer` checks the canvas
and warps the rank's rows, `GradStep` runs the row-sharded forward and
divides the summed gradients by the spatial size).

A host batch (`data.pipeline.PoseDataSource`, NHWC numpy)
crosses to the device once, from pinned memory without blocking the host,
and there the image and any dense target maps become NCHW (a permute: the
NHWC bytes are the channels_last layout the convolutions take).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from deepcut_tpu_torch.models.resnet import DeeperCutConfig, forward, is_trainable
from deepcut_tpu_torch.models.train import bn_frozen_mults, loss_fn
from deepcut_tpu_torch.parallel.mesh import (
    all_reduce_sum, data_parallel, gather_rows, shard_batch)
from deepcut_tpu_torch.parallel.spatial import check_batch, spatial_axis_size, spatial_pose_loss
from deepcut_tpu_torch.pose import targets as T
from deepcut_tpu_torch.pose.augment_device import warp_batch
from deepcut_tpu_torch.pose.targets_device import make_batch_rasterizer
from deepcut_tpu_torch.solver import update_rules


def _nhwc_map(key: str, value: torch.Tensor) -> bool:
    return value.ndim == 4 and (key == "image" or key.endswith(("_targets", "_weights")))


def to_device(batch: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy or tensors, NHWC maps) -> tensors on `device`, the
    image and dense target maps permuted to NCHW. ``image_raw`` and the
    ``anno_*`` / ``aug_*`` entries keep their layouts."""
    device = torch.device(device)
    out: Dict[str, torch.Tensor] = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if t.device != device:
            if device.type == "cuda" and t.device.type == "cpu" and t.numel():
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        out[k] = t.permute(0, 3, 1, 2) if _nhwc_map(k, t) else t
    return out


def batch_preparer(device, target_cfg=None, target_stats=None, *, mesh=None
                   ) -> Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]]:
    """Host batch -> the loss's device batch: with a mesh this rank's share
    of the GLOBAL batch (`parallel.mesh.shard_batch`; a spatial mesh first
    holds the canvas to `parallel.spatial.check_batch`), the transfer, the
    device warp of an ``image_raw`` batch (with a spatial axis only this
    rank's block of the canvas rows: `warp_batch_local`), then (with
    `target_cfg`) the rasterization of ``anno_*`` annotations into dense
    NCHW maps on the GLOBAL stride-8 grid."""
    nsp = spatial_axis_size(mesh)
    block = 0 if mesh is None else mesh.spatial_index

    def prepare(batch):
        if mesh is not None:
            if nsp > 1:
                check_batch(batch, mesh)
            batch = shard_batch(mesh, batch)
        batch = to_device(batch, device)
        if "aug_canvas" in batch:
            batch = warp_batch(batch, y0=block * int(batch["aug_canvas"].shape[1]))
        if target_cfg is None:
            return batch
        img = batch["image"]
        grid = (img.shape[2] * nsp // T.STRIDE, img.shape[3] // T.STRIDE)
        return make_batch_rasterizer(target_cfg, target_stats, grid=grid)(batch)

    return prepare


class GradStep:
    """The body of a training iteration, shared by `solver.PoseSolver.step`
    and `make_train_step`. `backward` runs the forward, the fork's losses
    and autograd into each trainable leaf's ``.grad`` (calls sum, as an
    iter_size accumulation needs); `update` hands those gradients to the
    Caffe update rule, with zeros for the leaves that got none (the frozen
    BN statistics, a head the config leaves out), and clears them. The zero
    gradients are made once and re-zeroed after each update, since the rule
    clips and decays its gradients in place.

    With a mesh, `backward` runs on the rank's rows under global-batch
    semantics (`parallel.mesh.data_parallel`: the losses and metrics are
    the global batch's) and `update` first sums the accumulated gradients
    over the ranks (`parallel.mesh.all_reduce_sum`). With a spatial axis
    the forward is the row-sharded one (`parallel.spatial.spatial_pose_loss`)
    and the summed gradients are divided by the spatial size, which the
    gather and the replicated heads count S times each."""

    def __init__(self, model_cfg: DeeperCutConfig, solver_cfg: update_rules.SolverConfig, *,
                 lr_mults=None, decay_mults=None, mesh=None):
        self.nsp = spatial_axis_size(mesh)
        self.loss = loss_fn
        if self.nsp > 1:
            self.loss = lambda p, b, c: spatial_pose_loss(p, b, c, mesh)
        self.model_cfg = model_cfg
        self.solver_cfg = solver_cfg
        self.lr_mults = lr_mults
        self.decay_mults = decay_mults
        self.mesh = mesh
        self._zeros: Dict[tuple, torch.Tensor] = {}

    def backward(self, params, batch):
        """-> (total loss, metrics), detached; the gradients land in ``.grad``."""
        with torch.enable_grad(), data_parallel(self.mesh):
            total, metrics = self.loss(params, batch, self.model_cfg)
            total.backward()
        return total.detach(), {k: v.detach() for k, v in metrics.items()}

    def reduced_grads(self, params):
        """The accumulated gradients summed over the mesh (divided by the
        spatial size), {layer: {key: tensor}}, zeros where none arrived."""
        if self.mesh is not None:
            got = [v.grad for e in params.values() for v in e.values() if v.grad is not None]
            all_reduce_sum(self.mesh, got)
            if self.nsp > 1:
                torch._foreach_div_(got, float(self.nsp))
        grads = {}
        for name, entry in params.items():
            grads[name] = {}
            for k, v in entry.items():
                if v.grad is None and (name, k) not in self._zeros:
                    self._zeros[name, k] = torch.zeros_like(v)
                grads[name][k] = self._zeros[name, k] if v.grad is None else v.grad
        return grads

    def update(self, params, state):
        grads = self.reduced_grads(params)
        params, state = update_rules.step(self.solver_cfg, params, grads, state,
                                          lr_mults=self.lr_mults, decay_mults=self.decay_mults)
        for entry in params.values():
            for v in entry.values():
                v.grad = None
        if self._zeros:
            torch._foreach_zero_(list(self._zeros.values()))
        return params, state


def make_train_step(model_cfg: DeeperCutConfig, solver_cfg: update_rules.SolverConfig,
                    mesh=None, *, target_cfg=None, target_stats=None):
    """Returns ``train_step(params, state, batch) -> (params, state,
    metrics)`` over the port's param dict and `update_rules` state on the
    params' device. The params and state are updated in place (the JAX step
    donates their buffers); the trainable leaves are made to require grad.
    The BatchNorm statistics are frozen (`models.train.bn_frozen_mults`).
    With a mesh every rank passes the GLOBAL host batch and the same params
    (`parallel.mesh.replicated`); each keeps its rows, with a spatial axis
    its block of the image rows too (the canvas held to `parallel.spatial.
    check_spatial_shapes`), and the metrics are the global batch's."""
    if solver_cfg.iter_size > 1:
        raise ValueError("make_train_step takes one batch per call and does not accumulate; "
                         "use PoseSolver for iter_size > 1")

    per_device: Dict[torch.device, tuple] = {}

    def train_step(params, state, batch):
        dev = next(iter(next(iter(params.values())).values())).device
        if dev not in per_device:
            mults = bn_frozen_mults(params)
            per_device[dev] = (batch_preparer(dev, target_cfg, target_stats, mesh=mesh),
                               GradStep(model_cfg, solver_cfg, lr_mults=mults, decay_mults=mults,
                                        mesh=mesh))
        prepare, body = per_device[dev]
        for name, entry in params.items():
            if is_trainable(name):
                for v in entry.values():
                    v.requires_grad_()
        _, metrics = body.backward(params, prepare(batch))
        metrics["lr"] = update_rules.learning_rate(solver_cfg, state["iter"])
        params, state = body.update(params, state)
        return params, state, metrics

    return train_step


def make_eval_step(model_cfg: DeeperCutConfig, mesh=None, *, folded: bool = True):
    """``eval_step(params, images) -> outputs``: the forward over an NCHW
    batch on the params' device, without autograd. With a mesh each data
    row runs its rows of the global batch (whole frames: the spatial axis
    replicates them, as the JAX package's eval step is data-parallel) and
    every rank gets the whole batch's outputs (gathered in order)."""

    def eval_step(params, images):
        with torch.inference_mode():
            if mesh is None:
                return forward(params, images, model_cfg, folded=folded)
            local = forward(params, shard_batch(mesh, {"x": images}, rows={})["x"], model_cfg,
                            folded=folded)
            return {k: gather_rows(mesh, v) for k, v in local.items()}

    return eval_step
