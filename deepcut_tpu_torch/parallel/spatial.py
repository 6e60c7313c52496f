"""Row-sharded ('spatial') DeeperCut: halo exchange, the training step and
the serving forward over a ('data', 'spatial') mesh.

Counterpart of `deepcut_tpu.parallel.spatial`. The JAX package runs one
program under ``shard_map`` and exchanges halos with ``lax.ppermute``;
here each rank of the mesh (`parallel.mesh`) is a process that holds a
block of the image rows of its data row's batch:

- the trunk (conv1 .. res5c) runs on the local rows. Before each conv or
  pool that reads rows beyond its block, `RowShards` fetches them from the
  neighbouring shards (`_RowWindow`, a `torch.autograd.Function`): the top
  and bottom halos for a padded or wide kernel, and on the first and last
  shard the padding itself (zeros; -inf, or int8's minimum, below the
  ceil-mode pool). The conv then runs locally with H padding 0 and its W
  padding. Its backward sends each halo's cotangent back to the shard that
  owns those rows and adds it there (what ``ppermute`` transposes to);
- at the taps (res5c and the stride-8 skip) the blocks are gathered over
  the 'spatial' axis (`_GatherRows`) and the heads and losses run on the
  full grid, replicated within the data row. The gather's backward sums
  the cotangents over the axis and keeps the local rows (the all-gather's
  transpose, a reduce-scatter);
- the losses reduce their sums and normalisers over the 'data' axis only
  (`parallel.mesh.data_parallel`), so the loss equals the single device's;
- the gradients are summed over the whole mesh and divided by the
  spatial size once: the gather's backward and the replicated heads each
  count every data row exactly S times, uniformly over the parameters
  (the JAX package's psum over both axes / nsp).

Transport: every exchange is a collective over the row group (an
``all_gather`` of each shard's edge rows: a few rows, not the activation),
in the forward and in the backward, so every rank posts the same
collectives in the same order, under ``remat`` too (a checkpointed block
repeats its forward exchanges inside the backward on every rank alike).
Collectives take CUDA tensors under NCCL and under gloo (through the
host); gloo's point-to-point send / recv take CPU tensors only, so no
exchange uses them.

Row blocks: training keeps the JAX package's contract (canvas H divisible
by 16 * S and H >= 32 * S, `check_spatial_shapes`), under which every
trunk height splits evenly. Serving takes any canvas of about 32 * S rows
or more: res4 / res5 of the 688 canvas have 43 rows. Each layer's output
rows are then split into blocks of floor and ceil(H / S) rows
(`split_rows`), and each shard reads the input rows its output block
needs (`RowShards.halo`, an output-driven plan), so the sharded forward
equals the unsharded forward of the same canvas; a `RowPlan` maps each
local row count to its global height. A canvas too small for its shards
(an empty block, or a halo deeper than a neighbour's block) raises.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from deepcut_tpu_torch.models.resnet import DeeperCutConfig, forward, is_trainable
from deepcut_tpu_torch.models.train import pose_loss
from deepcut_tpu_torch.ops.conv import conv2d, conv_output_size
from deepcut_tpu_torch.ops.losses import sharded_losses
from deepcut_tpu_torch.ops.pool import max_pool2d, pool_output_size

Ranges = List[Tuple[int, int]]


def split_rows(height: int, n: int) -> Ranges:
    """The global rows [lo, hi) of each of `n` shards: even blocks where n
    divides, else blocks of floor and ceil(height / n) rows, the longer
    ones first (no shard is more than one row short of another)."""
    q, r = divmod(height, n)
    return [(s * q + min(s, r), (s + 1) * q + min(s + 1, r)) for s in range(n)]


def trunk_heights(height: int, cfg: DeeperCutConfig) -> List[int]:
    """Every row count the DeeperCut trunk's tensors take from a canvas of
    `height` rows: the canvas, conv1, the stem pool, and after each stage
    whose first block strides."""
    hs = [height, conv_output_size(height, 7, 2, 3)]
    hs.append(pool_output_size(hs[-1], 3, 2, 0))
    for s in cfg.stage_strides:
        if s > 1:
            hs.append(conv_output_size(hs[-1], 1, s, 0))
    return hs


class RowPlan:
    """Which global height a row block of a given local size belongs to.

    `even(n)`: every height the stream takes splits evenly over n shards,
    so H = local * n (the training contract, and the graph engine's
    shardable prefix). `for_heights(n, heights)`: the heights of one
    forward (`trunk_heights`) split by `split_rows`; a local size that two
    heights share on some shard, or a shard left without rows, raises for
    every rank alike (the table is built from global values)."""

    def __init__(self, n: int, table: Optional[List[Dict[int, int]]] = None):
        self.n = n
        self._table = table

    @classmethod
    def even(cls, n: int) -> "RowPlan":
        return cls(n)

    @classmethod
    def for_heights(cls, n: int, heights: Sequence[int]) -> "RowPlan":
        table: List[Dict[int, int]] = [{} for _ in range(n)]
        for h in sorted(set(int(v) for v in heights)):
            for s, (lo, hi) in enumerate(split_rows(h, n)):
                if hi <= lo:
                    raise ValueError(f"row plan: {h} rows leave shard {s} of {n} empty "
                                     f"(heights {list(heights)}); a larger canvas is needed")
                if table[s].get(hi - lo, h) != h:
                    raise ValueError(f"row plan: shard {s} holds {hi - lo} rows of both "
                                     f"{table[s][hi - lo]} and {h}")
                table[s][hi - lo] = h
        return cls(n, table)

    def global_rows(self, local: int, index: int) -> int:
        if self._table is None:
            return local * self.n
        try:
            return self._table[index][local]
        except KeyError:
            raise ValueError(f"row plan: no height has {local} rows on shard {index}") from None


def _window_parts(have: Ranges, need: Ranges, height: int):
    """Per shard: (top fill, rows from the previous shard, own rows [a, b)
    local, rows from the next shard, bottom fill) for the global rows
    `need` of a tensor whose shards hold `have`. Rows outside [0, height)
    are fill; a halo deeper than the neighbour's block raises."""
    parts = []
    for r, ((lo, hi), (nlo, nhi)) in enumerate(zip(have, need)):
        a, z = max(nlo, 0), min(nhi, height)
        top, bottom = max(0, -nlo), max(0, nhi - max(height, nlo))
        t = max(0, min(lo, z) - a)
        b = max(0, z - max(hi, a))
        own_lo, own_hi = max(a, lo), min(z, hi)
        if own_hi <= own_lo or (t and lo - have[r - 1][0] < t) or (
                b and have[r + 1][1] - have[r + 1][0] < b):
            raise ValueError(f"halo exchange: shard {r} holds rows [{lo}, {hi}) of {height} and "
                             f"needs [{nlo}, {nhi}): deeper than a neighbouring shard")
        parts.append((top, t, own_lo - lo, own_hi - lo, b, bottom))
    return parts


def _like(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t in x's memory format (channels_last stays channels_last)."""
    if (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)):
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


def _pad_rows(t: torch.Tensor, rows: int, front: bool) -> torch.Tensor:
    """t with zero rows added (at the front or the end) up to `rows`."""
    if t.shape[2] >= rows:
        return t
    z = t.new_zeros(t.shape[:2] + (rows - t.shape[2],) + t.shape[3:])
    return torch.cat([z, t] if front else [t, z], dim=2)


def _rows_of(t: torch.Tensor, n: int, fill) -> torch.Tensor:
    return t.new_full(t.shape[:2] + (n,) + t.shape[3:], fill)


class _RowWindow(torch.autograd.Function):
    """The global rows each shard needs, from its block and its neighbours'.

    Every shard publishes its first B and last T rows (B, T: the deepest
    bottom and top halo any shard takes, so one shape for all) through one
    all-gather over the row group, and assembles [top fill, the previous
    shard's rows, its own rows, the next shard's rows, bottom fill]. The
    backward publishes the cotangents of the borrowed rows the same way and
    adds each neighbour's into the rows it lent."""

    @staticmethod
    def forward(ctx, x, axis, parts, fill):
        top, t, a, b, nb, bottom = parts[axis.index]
        big_t = max(p[1] for p in parts)
        big_b = max(p[4] for p in parts)
        pieces = [_rows_of(x, top, 0)] if top else []
        gathered = None
        if big_t or big_b:
            size = x.shape[2]
            pub = torch.cat([_pad_rows(x[:, :, :big_b], big_b, front=False),
                             _pad_rows(x[:, :, size - min(big_t, size):], big_t, front=True)],
                            dim=2)
            gathered = axis.all_gather(pub.contiguous())
        if t:
            pieces.append(gathered[axis.index - 1][:, :, big_b + big_t - t:])
        pieces.append(x[:, :, a:b])
        if nb:
            pieces.append(gathered[axis.index + 1][:, :, :nb])
        if bottom:
            pieces.append(_rows_of(x, bottom, fill))
        ctx.axis, ctx.parts, ctx.big = axis, parts, (big_t, big_b)
        ctx.shape = x.shape
        ctx.cl = x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
        return _like(x, torch.cat(pieces, dim=2))

    @staticmethod
    def backward(ctx, g):
        axis, parts, (big_t, big_b) = ctx.axis, ctx.parts, ctx.big
        top, t, a, b, nb, _ = parts[axis.index]
        grad = g.new_zeros(ctx.shape)
        own = top + t
        grad[:, :, a:b] += g[:, :, own:own + b - a]
        if big_t or big_b:
            g_prev = g[:, :, top:top + t]            # the previous shard's last t rows
            g_next = g[:, :, own + b - a:own + b - a + nb]   # the next shard's first rows
            pub = torch.cat([_pad_rows(g_next, big_b, front=False),
                             _pad_rows(g_prev, big_t, front=True)], dim=2)
            gathered = axis.all_gather(pub.contiguous())
            size = ctx.shape[2]
            if axis.index + 1 < axis.size:
                tn = parts[axis.index + 1][1]
                if tn:
                    grad[:, :, size - tn:] += gathered[axis.index + 1][:, :, big_b + big_t - tn:]
            if axis.index > 0:
                bp = parts[axis.index - 1][4]
                if bp:
                    grad[:, :, :bp] += gathered[axis.index - 1][:, :, :bp]
        if ctx.cl:
            grad = grad.contiguous(memory_format=torch.channels_last)
        return grad, None, None, None


def row_window(x: torch.Tensor, axis, have: Ranges, need: Ranges, height: int,
               fill: float = 0.0) -> torch.Tensor:
    """This shard's rows `need[index]` of a row-sharded (N, C, rows, W)
    tensor whose shards hold `have` (global rows of a `height`-row tensor):
    its own block cropped, the neighbours' halo rows, fill beyond the
    tensor. x itself where nothing moves on any shard."""
    parts = _window_parts(have, need, height)
    if all(p == (0, 0, 0, hi - lo, 0, 0) for p, (lo, hi) in zip(parts, have)):
        return x
    return _RowWindow.apply(x, axis, parts, fill)


class _GatherRows(torch.autograd.Function):
    """The full tensor from the row blocks of `have`, on every shard. The
    backward sums the cotangents over the row group and keeps the local
    rows: each shard's heads are the same computation, so every block's
    cotangent arrives S times (divided once with the gradients)."""

    @staticmethod
    def forward(ctx, x, axis, have):
        rows = max(hi - lo for lo, hi in have)
        gathered = axis.all_gather(_pad_rows(x, rows, front=False).contiguous())
        ctx.axis, ctx.span = axis, have[axis.index]
        ctx.cl = x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
        return _like(x, torch.cat([p[:, :, :hi - lo] for p, (lo, hi) in zip(gathered, have)],
                                  dim=2))

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.span
        full = ctx.axis.all_reduce_(g.contiguous().clone())
        grad = full[:, :, lo:hi]
        grad = (grad.contiguous(memory_format=torch.channels_last) if ctx.cl
                else grad.contiguous())
        return grad, None, None


def _pair(v) -> Tuple[int, int]:
    return (int(v[0]), int(v[-1])) if isinstance(v, (tuple, list)) else (int(v), int(v))


def _neg_fill(t: torch.Tensor):
    """The value padding takes below a max pool: -inf, or the integer minimum."""
    return float("-inf") if t.is_floating_point() else torch.iinfo(t.dtype).min


class RowShards:
    """The trunk's conv / pool hooks (`models.resnet.run_trunk`) and the
    gather before the heads, for a tensor stream whose rows are sharded
    over `axis` (a mesh's `spatial_axis`) by `plan`."""

    def __init__(self, axis, plan: Optional[RowPlan] = None):
        self.axis = axis
        self.plan = plan or RowPlan.even(axis.size)

    def _height(self, x: torch.Tensor) -> int:
        return self.plan.global_rows(int(x.shape[2]), self.axis.index)

    def halo(self, x: torch.Tensor, kernel: int, stride: int = 1, pad: int = 0,
             dilation: int = 1, fill: float = 0.0) -> torch.Tensor:
        """The input rows this shard's output block of a conv (or pool, with
        its fill) along H reads: its own, the neighbours' halos, the
        padding on the first and last shard. The op then pads W alone."""
        if kernel == 1 and stride == 1 and pad == 0:
            return x
        n = self.axis.size
        height = self._height(x)
        k_eff = dilation * (kernel - 1) + 1
        out = (height + 2 * pad - k_eff) // stride + 1
        need = [(lo * stride - pad, (hi - 1) * stride - pad + k_eff) for lo, hi in split_rows(out, n)]
        return row_window(x, self.axis, split_rows(height, n), need, height, fill)

    def conv(self, op, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
             stride=1, pad=0, dilation=1, **kw) -> torch.Tensor:
        """`op` (a conv with Caffe's geometry, weight OIHW) on this shard's
        output rows: halo rows along H, then the op with H padding 0."""
        (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(pad), _pair(dilation)
        x = self.halo(x, int(w.shape[2]), sh, ph, dh)
        return op(x, w, b, stride=(sh, sw), pad=(0, pw), dilation=(dh, dw), **kw)

    def pool(self, x: torch.Tensor, kernel=3, stride=2) -> torch.Tensor:
        """Caffe's unpadded ceil-mode MAX pool on this shard's output rows:
        the bottom halo, the clipped edge window as -inf (int8's minimum for
        an int8 stream) on the last shard; W by `ops.pool.max_pool2d`."""
        (kh, kw), (sh, sw) = _pair(kernel), _pair(stride)
        n = self.axis.size
        height = self._height(x)
        out = pool_output_size(height, kh, sh, 0)
        need = [(lo * sh, (hi - 1) * sh + kh) for lo, hi in split_rows(out, n)]
        x = row_window(x, self.axis, split_rows(height, n), need, height, _neg_fill(x))
        return max_pool2d(x, kernel=(kh, kw), stride=(sh, sw))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every row of a row-sharded tensor, on every shard of the group."""
        if self.axis.size == 1:
            return x
        return _GatherRows.apply(x, self.axis, split_rows(self._height(x), self.axis.size))


def _spatial(mesh):
    return mesh.spatial_axis if hasattr(mesh, "spatial_axis") else mesh


def halo_exchange(x: torch.Tensor, top: int, bottom: int, mesh,
                  bottom_fill: Optional[float] = None) -> torch.Tensor:
    """Concatenate neighbour rows onto an evenly row-sharded (N, C, Hl, W)
    block: `top` rows from the previous shard (zeros on the first, which IS
    the conv's zero padding), `bottom` rows from the next (zeros on the
    last, or `bottom_fill`: -inf for the ceil-mode pool). mesh: a mesh (its
    'spatial' axis) or an axis. Differentiable: the halo rows' cotangents
    go back to the shards that own them."""
    axis = _spatial(mesh)
    n, local = axis.size, int(x.shape[2])
    height = local * n
    have = split_rows(height, n)
    need = [(lo - top, hi + bottom) for lo, hi in have]
    return row_window(x, axis, have, need, height, 0.0 if bottom_fill is None else bottom_fill)


def spatial_conv2d(x, w, b=None, *, stride=1, pad=0, dilation=1, groups: int = 1, mesh,
                   compute_dtype: Optional[torch.dtype] = None, plan: Optional[RowPlan] = None):
    """`ops.conv.conv2d` with H sharded over the mesh's 'spatial' axis: the
    halo rows (top = pad_h, bottom = k_eff - pad_h - stride_h on even
    blocks) are fetched, then the conv runs locally with H padding 0 and
    its W padding. stride / pad / dilation take (h, w) pairs."""
    return RowShards(_spatial(mesh), plan).conv(
        conv2d, x, w, b, stride=stride, pad=pad, dilation=dilation, groups=groups,
        compute_dtype=compute_dtype)


def spatial_max_pool(x, *, kernel=3, stride=2, mesh, plan: Optional[RowPlan] = None):
    """Ceil-mode unpadded MAX pool with H sharded: the bottom halo is
    kernel_h - stride_h rows on even blocks, -inf on the last shard
    (Caffe's clipped edge window); W by `ops.pool.max_pool2d`."""
    return RowShards(_spatial(mesh), plan).pool(x, kernel, stride)


def spatial_forward(params: Mapping, x_local: torch.Tensor, cfg: DeeperCutConfig, mesh, *,
                    plan: Optional[RowPlan] = None, folded: bool = False,
                    heads: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """The row-sharded forward: `models.resnet.forward` on this rank's block
    of the image rows, through `RowShards` over the mesh's 'spatial' axis
    (halo hooks in the trunk, res5c and the skip tap gathered, the heads on
    the full grid). Equal to the forward of the whole canvas."""
    return forward(params, x_local, cfg, folded=folded, heads=heads,
                   rows=RowShards(mesh.spatial_axis, plan))


def sharded_pose_loss(outputs, batch, cfg: DeeperCutConfig, mesh):
    """`models.train.pose_loss` with its sums and normalisers reduced over
    the mesh's 'data' axis (the heads are replicated within a data row)."""
    with sharded_losses(mesh.data_axis):
        return pose_loss(outputs, batch, cfg)


def spatial_pose_loss(params, batch, cfg: DeeperCutConfig, mesh):
    """(total, losses) of the row-sharded forward over this rank's block of
    ``batch["image"]`` and its data row's full-grid targets."""
    return sharded_pose_loss(spatial_forward(params, batch["image"], cfg, mesh), batch, cfg,
                             mesh)


def check_spatial_shapes(h: int, n: int, mesh) -> None:
    """Host-side validation of the training shape contract (clear errors
    beat shape mismatches three collectives deep)."""
    nsp, nd = mesh.spatial, mesh.data
    if n % nd:
        raise ValueError(f"spatial train step: batch {n} not divisible by "
                         f"data axis {nd}")
    if h % (16 * nsp):
        raise ValueError(
            f"spatial train step: image H={h} must be divisible by "
            f"16*n_spatial={16 * nsp} so every trunk stage splits evenly "
            "(pad the canvas to the next multiple)")
    if h < 32 * nsp:
        raise ValueError(
            f"spatial train step: image H={h} too small for spatial={nsp} "
            f"(res5's dilated 3x3 needs a 2-row halo; H >= {32 * nsp})")


def spatial_axis_size(mesh) -> int:
    """Size of the mesh's 'spatial' axis (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.spatial)


def check_batch(batch: Mapping, mesh) -> None:
    """`check_spatial_shapes` for a GLOBAL host batch (NHWC canvas, or the
    augment path's ``aug_canvas`` shape token)."""
    key = "aug_canvas" if "aug_canvas" in batch else "image"
    n = batch["image_raw" if "image_raw" in batch else "image"].shape[0]
    check_spatial_shapes(int(batch[key].shape[1]), int(n), mesh)


def make_spatial_value_and_grad(model_cfg: DeeperCutConfig, mesh, target_cfg=None,
                                target_stats=None):
    """``vg(params, batch) -> ((loss, metrics), grads)`` over the 2-D mesh:
    every rank passes the GLOBAL host batch and the same params; the grads
    ({layer: {key: tensor}}, zeros for the frozen BN statistics) are the
    single device's on that batch, on every rank. The gradient half of the
    spatial step; `solver.PoseSolver` accumulates `parallel.train_step.
    GradStep`'s local gradients over iter_size micro-batches and reduces
    them once instead."""
    from deepcut_tpu_torch.parallel.train_step import GradStep, batch_preparer

    prepare = batch_preparer(mesh.device, target_cfg, target_stats, mesh=mesh)
    body = GradStep(model_cfg, None, mesh=mesh)

    def vg(params, batch):
        for name, entry in params.items():
            if is_trainable(name):
                for v in entry.values():
                    v.requires_grad_()
        total, metrics = body.backward(params, prepare(batch))
        grads = body.reduced_grads(params)
        for entry in params.values():
            for v in entry.values():
                v.grad = None
        return (total, metrics), grads

    return vg


def make_spatial_train_step(model_cfg: DeeperCutConfig, solver_cfg, mesh, *, target_cfg=None,
                            target_stats=None):
    """``(params, state, batch) -> (params, state, metrics)`` over a 2-D
    ('data', 'spatial') mesh: `parallel.train_step.make_train_step`, whose
    batch preparation and gradient step dispatch on the spatial size (batch
    rows over 'data', image rows over 'spatial', params and solver state
    replicated and updated in place on every rank, trajectory-equal to the
    single-device step). Every rank passes the GLOBAL host batch; the shape
    contract is checked first (`check_spatial_shapes`)."""
    from deepcut_tpu_torch.parallel.train_step import make_train_step

    return make_train_step(model_cfg, solver_cfg, mesh, target_cfg=target_cfg,
                           target_stats=target_stats)
