"""On-device target rasterization: compact annotations -> dense NCHW maps.

Counterpart of the device half of `deepcut_tpu.pose.targets_device`
(`make_batch_rasterizer`). The host half — `compact_sample`,
`record_limits`, `ANNO_KEYS` — is the JAX package's own jax-free code,
which `PoseDataSource(device_targets=True)` already runs; this module turns
its ``anno_*`` arrays into the dense target maps on the batch's device, so
that only a few KB per sample cross from the host.

The JAX code rasterizes one sample and `vmap`s it; here the batch dimension
is written out, and every class is handled in one pass over a
(N, H, W, C', M) distance tensor instead of a loop over classes. The maps
come out NCHW, the layout of the model's outputs and of the port's losses.
Statement for statement it mirrors `pose.targets.rasterize`: the per-class
argmin over entries keeps "ties go to the first" (`torch.argmin`'s
documented rule), the ``FLT_MAX`` sentinels stay, and ``take_along_axis``
becomes `torch.gather`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from deepcut_tpu.data.window_file import JointStats, default_stats
from deepcut_tpu.pose import targets as T
from deepcut_tpu.pose.targets_device import FLT_MAX


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """take_along_axis: `idx` broadcasts against `x` except along `dim`."""
    shape = list(x.shape)
    shape[dim] = idx.shape[dim]
    return torch.gather(x, dim, idx.expand(shape))


def rasterize_batch(anno: Mapping[str, torch.Tensor], cfg: T.TargetConfig,
                    stats: JointStats, grid_h: int, grid_w: int) -> Dict[str, torch.Tensor]:
    """The ``anno_*`` tensors of a batch (leading dim N, one device) -> the
    dense target dict, each map (N, C, grid_h, grid_w) f32."""
    J, SKIP = cfg.num_classes, cfg.skip_class
    first = 1 if cfg.no_bg_class else 0
    f32 = torch.float32
    cls = anno["anno_cls"].long()                          # (N, M), 0 = padding
    xy = anno["anno_xy"].to(f32)                           # (N, M, 2)
    person = anno["anno_person"].long()                    # (N, M)
    jidx = anno["anno_joint_index"].long()                 # (N, P, J), -1 = absent
    scale = anno["anno_scale"].to(f32).reshape(-1, 1, 1, 1)
    dims = anno["anno_dims"].long()
    th, tw, sh, sw = (dims[:, i].reshape(-1, 1, 1) for i in range(4))
    dev = cls.device
    n = cls.shape[0]

    gy, gx = torch.meshgrid(torch.arange(grid_h, device=dev), torch.arange(grid_w, device=dev),
                            indexing="ij")
    in_grid = (gy < th) & (gx < tw)                        # (N, H, W)
    in_sample = (gy < sh) & (gx < sw)
    pt = torch.stack([gx * T.STRIDE + T.HALF_STRIDE, gy * T.STRIDE + T.HALF_STRIDE],
                     dim=-1).to(f32) / scale               # (N, H, W, 2)

    valid_e = (cls >= 1)[:, None, None, :]                 # (N, 1, 1, M)
    diff_all = xy[:, None, None, :, :] - pt[:, :, :, None, :]      # (N, H, W, M, 2)
    dist_all = torch.sqrt((diff_all * diff_all).sum(dim=-1))
    dist_m = torch.where(valid_e, dist_all, FLT_MAX)               # (N, H, W, M)
    flat_arg = torch.argmin(dist_m, dim=3, keepdim=True)          # ties -> first
    min_dist = torch.gather(dist_m, 3, flat_arg)[..., 0]
    closest_joint = torch.gather(cls[:, None, None, :].expand_as(dist_m), 3, flat_arg)[..., 0]

    # per class c: distance / index of the closest entry of that class.
    # Class 0 and absent classes see only FLT_MAX: dist FLT_MAX, arg 0.
    classes = torch.arange(SKIP + 1, device=dev)
    is_c = cls[:, None, None, None, :] == classes[:, None]         # (N, 1, 1, C', M)
    d_c = torch.where(is_c, dist_m[:, :, :, None, :], FLT_MAX)     # (N, H, W, C', M)
    class_arg = torch.argmin(d_c, dim=4, keepdim=True)
    class_dist = torch.gather(d_c, 4, class_arg)[..., 0]           # (N, H, W, C')
    class_arg = class_arg[..., 0]
    if cfg.soft_labels:
        scores = torch.exp(-class_dist * class_dist / (2 * cfg.gauss_blob_sigma ** 2))
    else:
        scores = (class_dist <= cfg.fg_threshold).to(f32)
    scores[..., 0] = 0.0

    skip_sample = scores[..., SKIP] > T.FG_SCORE_THRESH
    closest_score = _take(scores, closest_joint[..., None], 3)[..., 0]
    scores[..., 0] = 1.0 - closest_score

    if cfg.soft_labels:
        is_fg = scores[..., 0] <= 1 - T.FG_SCORE_THRESH
    else:
        is_fg = min_dist <= cfg.fg_threshold
    is_fg = is_fg & in_grid
    skip_sample = skip_sample & in_grid
    sample_mask = is_fg | skip_sample
    num_positives = is_fg.sum(dim=(1, 2)).to(f32).reshape(-1, 1, 1, 1)

    write = ~skip_sample & in_grid
    if cfg.fg_fraction is not None:
        write = write & is_fg
    if not cfg.soft_labels and not cfg.multi_label:
        curr = torch.where(is_fg, closest_joint, 0)
        scores_out = torch.nn.functional.one_hot(curr, SKIP + 1).to(f32)
    else:
        scores_out = scores

    labels = torch.where(write[..., None], scores_out[..., first:J + 1], T.IGNORE_VALUE)
    weights = torch.ones_like(labels)
    gate_scores = scores_out  # post-overwrite gating (pose_data_layer quirk)
    out: Dict[str, torch.Tensor] = {}

    def nchw(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 3, 1, 2).contiguous()

    if cfg.location_refinement:
        args_j = class_arg[..., 1:J + 1]                                 # (N, H, W, J)
        active = ((write & is_fg)[..., None]
                  & (gate_scores[..., 1:J + 1] >= T.FG_SCORE_THRESH)
                  & (class_dist[..., 1:J + 1] < FLT_MAX))
        d = _take(diff_all, args_j[..., None], 3) * scale[..., None]     # (N, H, W, J, 2)
        loc = torch.where(active[..., None], d / T.LOCREF_STD, 0.0)
        out["locref_targets"] = nchw(loc.reshape(n, grid_h, grid_w, 2 * J))
        out["locref_weights"] = nchw(active.to(f32).repeat_interleave(2, dim=-1))

    if cfg.regress_to_other:
        cls_e = torch.as_tensor(stats.edges[:, 0], dtype=torch.long, device=dev)   # (E,)
        nxt_e = torch.as_tensor(stats.edges[:, 1], dtype=torch.long, device=dev)
        means = torch.as_tensor(stats.means, dtype=f32, device=dev)                # (E, 2)
        stds = torch.as_tensor(stats.std_devs, dtype=f32, device=dev)
        E = cls_e.shape[0]
        gate_e = gate_scores[..., cls_e]                                            # (N, H, W, E)
        cdist_e = class_dist[..., cls_e]
        arg_e = class_arg[..., cls_e]
        pidx_e = torch.gather(person, 1, arg_e.reshape(n, -1)).reshape(arg_e.shape)
        P = jidx.shape[1]
        nj = torch.gather(jidx.reshape(n, P * J), 1,
                          (pidx_e * J + (nxt_e - 1)).reshape(n, -1)).reshape(arg_e.shape)
        active = ((write & is_fg)[..., None] & (gate_e >= T.FG_SCORE_THRESH)
                  & (cdist_e < FLT_MAX) & (nj >= 0))
        nxt_xy = torch.gather(xy, 1, nj.clamp(min=0).reshape(n, -1, 1).expand(-1, -1, 2))
        d = (nxt_xy.reshape(n, grid_h, grid_w, E, 2) - pt[:, :, :, None, :]) * scale[..., None]
        t = torch.where(active[..., None], (d - means) / stds, 0.0)
        out["pairwise_targets"] = nchw(t.reshape(n, grid_h, grid_w, 2 * E))
        out["pairwise_weights"] = nchw(active.to(f32).repeat_interleave(2, dim=-1))

    # negatives (targets._fill_negatives_vec)
    onehot0 = torch.zeros(SKIP + 1, dtype=f32, device=dev)
    onehot0[0] = 1.0
    onehot0 = onehot0[first:J + 1]
    if cfg.weight_targets:
        total = (sh * sw).to(f32)[..., None]                                        # (N, 1, 1, 1)
        neg = torch.clamp(total - num_positives, min=1.0)
        frac = cfg.fg_fraction or 0.25
        w = (1 - frac) / frac * num_positives / neg
        bg = (in_sample & ~sample_mask)[..., None]
        labels = torch.where(bg, onehot0, labels)
        weights = torch.where(bg, w, weights)
    elif cfg.fg_fraction is not None:
        neg = anno["anno_neg_mask"].bool()[..., None]
        labels = torch.where(neg, onehot0, labels)

    # padding beyond the sample's own (sh, sw): ignore-labels, zero weights
    labels = torch.where(in_sample[..., None], labels, T.IGNORE_VALUE)
    weights = torch.where(in_sample[..., None], weights, 0.0)
    out["part_score_targets"] = nchw(labels)
    out["part_score_weights"] = nchw(weights)
    return out


def make_batch_rasterizer(cfg: T.TargetConfig, stats: Optional[JointStats] = None):
    """Returns `apply(batch) -> batch` replacing the ``anno_*`` tensors with
    the dense NCHW target maps, rasterized on their device; a no-op for a
    batch that already carries dense targets. The stride-8 grid comes from
    the NCHW ``image`` canvas (bucketed)."""
    stats = stats or default_stats(cfg.num_classes)

    def apply(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if "anno_cls" not in batch:
            return dict(batch)
        img = batch["image"]
        gh, gw = img.shape[2] // T.STRIDE, img.shape[3] // T.STRIDE
        annos = {k: v for k, v in batch.items() if k.startswith("anno_")}
        rest = {k: v for k, v in batch.items() if not k.startswith("anno_")}
        return {**rest, **rasterize_batch(annos, cfg, stats, gh, gw)}

    return apply
