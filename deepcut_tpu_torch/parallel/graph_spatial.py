"""Row-sharded ('spatial') TRAINING for any prototxt graph.

Counterpart of `deepcut_tpu.parallel.graph_spatial`. The native-model
spatial step (`parallel.spatial`) hard-codes the DeeperCut trunk; this
module generalises the same design to the graph engine's layer plans, so
`core.graph.Net.make_train_step(mesh=2-D mesh)` trains the reference's own
prototxt files with image rows sharded:

1. **Plan split** (`split_plan`, a pure function of the plan and the blob
   shapes). A walker classifies each layer: spatially SHARDABLE
   (convolutions and unpadded MAX pools whose geometry tiles the row axis
   exactly, and the pointwise / per-channel layers of `_POINTWISE`, train
   BatchNorm included, whose moments then reduce over BOTH axes) run on
   local row blocks with halo exchange (`parallel.spatial.RowShards`); the
   first layer that cannot shard (InnerProduct, Deconvolution, Flatten,
   padded or AVE pooling, a stochastic layer, a geometry that does not
   tile) is the GATHER BOUNDARY: every live sharded blob is gathered over
   the 'spatial' axis and the suffix runs replicated within each data row.
   Where the boundary is layer 0 the step is data-parallel training, the
   JAX package's documented behaviour; it is logged.
2. **Losses.** The suffix runs under `parallel.mesh.data_parallel`: loss
   sums and normalisers reduce over the 'data' axis, train BatchNorm's
   moments over 'data', stochastic draws key by the data index with the
   layer's index in the whole plan. The per-sample-mean losses
   (`_MEAN_LOSSES`) take `_wrap_mean_loss`; a loss outside both sets raises.
3. **Gradients.** Summed over both axes and divided by the spatial size
   once: the gather's backward and the replicated suffix each count every
   data row S times (`parallel.spatial`'s module docstring).

Shardability conditions per layer (global row count H per blob, n = axis
size): H_in % n == 0, H_out % n == 0, the output rows tile the input
(H_out * stride_h == H_in) and the halo depth fits in one neighbour shard
(top = pad_h <= H_in/n, bottom = k_eff - pad_h - stride_h <= H_in/n).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from deepcut_tpu_torch.core.layers import conv_forward, conv_geometry
from deepcut_tpu_torch.ops.losses import sharded_losses
from deepcut_tpu_torch.ops.norm import sharded_bn_stats
from deepcut_tpu_torch.parallel.spatial import RowPlan, RowShards

LOG = logging.getLogger(__name__)

# layers that act per-element / per-channel: safe on row shards as-is
_POINTWISE = {
    "ReLU", "PReLU", "ELU", "Sigmoid", "TanH", "BNLL", "AbsVal", "Power",
    "Exp", "Log", "Threshold", "Scale", "Bias", "BatchNorm", "Eltwise",
}
# losses whose sums and normalisers reduce over the 'data' axis
# (`ops.losses.sharded_losses`)
_SHARDED_LOSSES = {
    "SoftmaxWithLoss", "SoftmaxWithLossVec", "SmoothL1Loss",
    "SigmoidCrossEntropyLoss", "EuclideanLoss",
}
# losses that are plain PER-SAMPLE MEANS (normaliser = batch size, no
# valid-count / ignore-label coupling): `_wrap_mean_loss` is exact for
# these. Losses outside both sets raise.
_MEAN_LOSSES = {
    "HingeLoss", "ContrastiveLoss", "MultinomialLogisticLoss", "InfogainLoss",
}


class _DataMean(torch.autograd.Function):
    """A rank's local mean -> the mean over the 'data' axis (equal counts per
    rank by sharding); the backward hands the local vjp g / ndata: the
    all-reduce stays out of the differentiated path."""

    @staticmethod
    def forward(ctx, v, axis):
        ctx.n = axis.size
        return axis.all_reduce_(v.clone()) / axis.size

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _wrap_mean_loss(fn, axis):
    """A per-sample-MEAN loss layer over the data axis: its local mean (the
    layer alone, no context), then `_DataMean`."""
    def wrapped(entry, bottoms):
        with sharded_losses(None):
            out = fn(entry, bottoms)
        out = out[0] if isinstance(out, (list, tuple)) else out
        return [_DataMean.apply(out, axis)]
    return wrapped


def _pair(node, base: str, default: int) -> Tuple[int, int]:
    """Caffe's kernel_size/_h/_w, stride/_h/_w, pad/_h/_w conventions."""
    if node.has(f"{base}_h") or node.has(f"{base}_w"):
        return (node.get_int(f"{base}_h", default),
                node.get_int(f"{base}_w", default))
    vals = [int(v) for v in node.get_list(base)] or [default]
    return (vals[0], vals[-1])


def _conv_spatial_info(spec, h_in: int, h_out: int, nsp: int):
    """(geometry kwargs) when this Convolution tiles the row axis, else None."""
    cp = spec.param("convolution_param")
    kh, kw = _pair(cp, "kernel_size", 1)
    sh, sw = _pair(cp, "stride", 1)
    ph, pw = _pair(cp, "pad", 0)
    dil = cp.get_int("dilation", 1)
    k_eff = dil * (kh - 1) + 1
    local = h_in // nsp
    if (h_in % nsp or h_out % nsp or h_out * sh != h_in
            or ph > local or max(k_eff - ph - sh, 0) > local):
        return None
    return dict(stride=(sh, sw), pad=(ph, pw), dilation=dil,
                groups=cp.get_int("group", 1))


def _pool_spatial_info(spec, h_in: int, h_out: int, nsp: int):
    pp = spec.param("pooling_param")
    if pp.get_str("pool", "MAX") != "MAX" or pp.get_bool("global_pooling", False):
        return None
    kh, kw = _pair(pp, "kernel_size", 0)
    sh, sw = _pair(pp, "stride", 1)
    ph, pw = _pair(pp, "pad", 0)
    local = h_in // nsp
    if (ph or pw or h_in % nsp or h_out % nsp or h_out * sh != h_in
            or kh < sh or max(kh - sh, 0) > local):
        return None
    return dict(kernel=(kh, kw), stride=(sh, sw))


def split_plan(net, blob_shapes: Dict[str, Tuple[int, ...]], nsp: int):
    """Walk the plan; return (boundary_index, per-layer spatial infos,
    sharded_inputs, gather_blobs).

    blob_shapes: global NCHW shapes for every blob (inputs + all tops).
    sharded_inputs: net inputs that enter row-sharded.
    gather_blobs: sharded blobs that must be gathered at the boundary
    (consumed at/after it, or a net output)."""
    plan = net._plan
    sharded: Set[str] = set()
    infos: List[Optional[dict]] = []
    boundary = 0

    def h_of(name):
        sh = blob_shapes.get(name)
        return sh[2] if sh is not None and len(sh) == 4 else None

    for idx, (fn, spec) in enumerate(plan):
        typ = spec.type
        info: Optional[dict] = None
        ok = False
        if not getattr(fn, "needs_rng", False):
            hs_in = [h_of(b) for b in spec.bottoms]
            hs_out = [h_of(t) for t in spec.tops]
            all_4d = all(h is not None for h in hs_in + hs_out) and hs_in
            if typ == "Convolution" and all_4d:
                info = _conv_spatial_info(spec, hs_in[0], hs_out[0], nsp)
                ok = info is not None
            elif typ == "Pooling" and all_4d:
                info = _pool_spatial_info(spec, hs_in[0], hs_out[0], nsp)
                ok = info is not None
            elif typ in _POINTWISE and all_4d:
                # same-H bottoms (Eltwise) and H-preserving outputs only;
                # Concat is excluded (axis bookkeeping): boundary instead
                ok = (len(set(hs_in + hs_out)) == 1
                      and all(h % nsp == 0 for h in hs_in))
        # every 4-D bottom the layer consumes must be sharded or shardable
        if ok:
            for b in spec.bottoms:
                if h_of(b) is None or (b not in sharded and b not in net.input_names):
                    ok = False
                    break
        if not ok:
            boundary = idx
            break
        infos.append(info)
        sharded.update(b for b in spec.bottoms if b in net.input_names)
        sharded.update(spec.tops)
    else:
        boundary = len(plan)

    sharded_inputs = {b for b in sharded if b in net.input_names}
    consumed_later: Set[str] = set()
    for _, spec in plan[boundary:]:
        consumed_later.update(spec.bottoms)
    consumed_later.update(net.output_names())
    gather_blobs = sorted(sharded & consumed_later)

    for fn, spec in plan[boundary:]:
        is_loss = spec.type.endswith("Loss") or spec.type == "SoftmaxWithLossVec"
        if is_loss and spec.type not in _SHARDED_LOSSES \
                and spec.type not in _MEAN_LOSSES:
            raise NotImplementedError(
                f"spatial graph training: loss layer '{spec.name}' of type "
                f"{spec.type} has no psum'ed sharded variant; supported: "
                f"{sorted(_SHARDED_LOSSES | _MEAN_LOSSES)}")
        # stochastic layers (needs_rng) are fine here: the walker keeps them
        # out of the sharded prefix, and the suffix draws their random
        # tensors at the GLOBAL batch size and keeps the data row's rows
        # (ops/shard_rng.py): masks equal the single-device sequence.
    return boundary, infos, sharded_inputs, gather_blobs


def _sharded_layer(fn, spec, info: Optional[dict], rows: RowShards, compute_dtype):
    """The layer function of a prefix layer on row blocks: a conv or pool
    with its halo rows; any other (pointwise) layer as built."""
    if spec.type == "Convolution":
        g = conv_geometry(spec.param("convolution_param"))
        (kh, _), (sh, _), (ph, pw), (dh, _) = g["kernel"], g["stride"], g["pad"], g["dilation"]
        local = dict(g, pad=(0, pw))
        return lambda p, b: conv_forward(rows.halo(b[0], kh, sh, ph, dh), p, local,
                                         compute_dtype)
    if spec.type == "Pooling":
        return lambda p, b: rows.pool(b[0], info["kernel"], info["stride"])
    return fn


def make_graph_spatial_train_step(net, solver_cfg, mesh, *, lr_mults=None, decay_mults=None,
                                  iter_size: int = 1, log=None):
    """``(params, state, inputs) -> (params, state, loss)`` over a 2-D
    ('data', 'spatial') mesh for a graph-engine `core.graph.Net`, in place,
    trajectory-equal to the single-device step. Every rank passes the
    GLOBAL inputs (NCHW; with iter_size > 1 a leading micro-batch axis, whose
    gradients are summed before the one reduction and update) and holds
    the same params. The split is planned per input-shape signature
    (``step.plans``: {signature: `split_plan`'s result}) and reported
    through `log` (default: this module's logger), a boundary at layer 0
    (data-parallel) included."""
    from deepcut_tpu_torch.core.graph import _tf32_off, _to_tensor
    from deepcut_tpu_torch.parallel.mesh import all_reduce_sum, data_parallel, shard_batch
    from deepcut_tpu_torch.solver import update_rules

    nsp = mesh.spatial
    say = log or LOG.info
    iter_size = max(int(iter_size), 1)
    rows = RowShards(mesh.spatial_axis, RowPlan.even(nsp))
    built: Dict[Any, tuple] = {}
    plans: Dict[Any, tuple] = {}

    def build(shapes):
        blob_shapes, _ = net._meta_pass(dict(shapes))
        blob_shapes = {nm: tuple(v.shape) for nm, v in blob_shapes.items()}
        split = split_plan(net, blob_shapes, nsp)
        boundary, infos, sharded_inputs, gather_blobs = split
        plan = net._plan
        at = plan[boundary][1].name if boundary < len(plan) else "the end"
        if boundary == 0:
            say(f"spatial graph training: the first layer ({at}) cannot shard its rows; the "
                f"step trains data-parallel over the mesh")
        else:
            say(f"spatial graph training: rows sharded over {nsp} ranks up to layer {boundary} "
                f"of {len(plan)} ({at}), gathering {gather_blobs}")
        prefix = [(_sharded_layer(fn, spec, info, rows, net.compute_dtype), spec)
                  for (fn, spec), info in zip(plan[:boundary], infos)]
        suffix = [((_wrap_mean_loss(fn, mesh.data_axis) if spec.type in _MEAN_LOSSES else fn),
                   spec) for fn, spec in plan[boundary:]]
        return split, prefix, suffix

    def one_grad(params, inputs, stream, parts):
        (boundary, _, _, gather_blobs), prefix, suffix = parts
        leaves, used = net._grad_params(params)
        updates: Dict[str, Dict[str, torch.Tensor]] = {}
        with _tf32_off(net.compute_dtype is None):
            # the prefix on row blocks: train BatchNorm's moments over both axes
            with sharded_bn_stats(mesh.world_axis):
                blobs = net._execute(used, inputs, plan=prefix, collect_updates=updates)
            for b in gather_blobs:
                blobs[b] = rows.gather(blobs[b])
            with data_parallel(mesh):
                blobs = net._execute(used, blobs, plan=suffix, collect_updates=updates,
                                     rng=stream, rng_offset=boundary)
                loss = net.total_loss(blobs)
                flat = [v for e in leaves.values() for v in e.values() if v.requires_grad]
                got = iter(torch.autograd.grad(loss, flat, allow_unused=True)
                           if flat and loss.requires_grad else [None] * len(flat))
        grads = {n: {k: (next(got) if v.requires_grad else None) for k, v in e.items()}
                 for n, e in leaves.items()}
        grads = {n: {k: torch.zeros_like(params[n][k]) if g is None else g
                     for k, g in e.items()} for n, e in grads.items()}
        return loss.detach(), grads, updates

    def step(params, state, inputs):
        it = int(state["iter"])
        shapes = tuple(sorted((nm, tuple(v.shape[1:] if iter_size > 1 else v.shape))
                              for nm, v in inputs.items()))
        if shapes not in built:
            built[shapes] = build(shapes)
            plans[shapes] = built[shapes][0]
        parts = built[shapes]
        sharded_inputs = parts[0][2]
        axis = 0 if iter_size == 1 else 1
        inputs = shard_batch(mesh, inputs, axis=axis, rows={k: axis + 2 for k in sharded_inputs})
        inputs = {k: _to_tensor(v, net.device) for k, v in inputs.items()}
        loss, grads, updates = None, None, {}
        for m in range(iter_size):
            micro = inputs if iter_size == 1 else {k: v[m] for k, v in inputs.items()}
            l_m, g_m, updates = one_grad(params, micro, (0, it, m), parts)
            loss = l_m if loss is None else loss + l_m
            if grads is None:
                grads = g_m
            else:
                for n, e in grads.items():
                    for k in e:
                        e[k] = e[k] + g_m[n][k]
        loss = loss / iter_size
        flat = [g for e in grads.values() for g in e.values()]
        all_reduce_sum(mesh, flat)
        torch._foreach_div_(flat, float(nsp))
        update_rules.step(solver_cfg, params, grads, state, lr_mults=lr_mults,
                          decay_mults=decay_mults)
        with torch.no_grad():
            for name, upd in updates.items():
                for k, v in upd.items():
                    params[name][k].copy_(v)
        return params, state, loss

    step.plans = plans
    return step
