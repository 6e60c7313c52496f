"""On-device target rasterization: compact annotations -> dense NCHW maps.

Counterpart of `deepcut_tpu.pose.targets_device`, both halves. The host
half — `compact_sample`, `record_limits`, `ANNO_KEYS` — is the port's own
copy of the JAX package's jax-free code (held against it by
tests/test_torch_data.py); `PoseDataSource(device_targets=True)` runs it
and ships a few KB of ``anno_*`` arrays per sample. The device half turns
those arrays into the dense target maps on the batch's device.

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

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from deepcut_tpu_torch.data.window_file import ImageRecord, JointStats, default_stats
from deepcut_tpu_torch.pose import targets as T

# --------------------------------------------------------------------------
# Host half (numpy): the compact annotation of one sample
# --------------------------------------------------------------------------

FLT_MAX = float(np.finfo(np.float32).max)

#: batch keys produced by compact_sample (all small; shipped each step)
ANNO_KEYS = ("anno_cls", "anno_xy", "anno_person", "anno_joint_index",
             "anno_scale", "anno_dims", "anno_neg_mask")


@dataclasses.dataclass(frozen=True)
class CompactLimits:
    """Static padding sizes for the annotation arrays (per data source)."""

    max_entries: int  # M: total (person, joint) entries incl. skip markers
    max_people: int   # P


def record_limits(records: Sequence[ImageRecord]) -> CompactLimits:
    m = p = 1
    for rec in records:
        m = max(m, sum(len(pe.classes) for pe in rec.people))
        p = max(p, len(rec.people))
    return CompactLimits(max_entries=m, max_people=p)


def _entry_arrays(record: ImageRecord, cfg: T.TargetConfig):
    """Flatten (person, joint) entries in reference iteration order."""
    J = cfg.num_classes
    cls_l: List[int] = []
    xy_l: List[np.ndarray] = []
    person_l: List[int] = []
    joint_index = np.full((max(len(record.people), 1), J), -1, np.int32)
    for pidx, p in enumerate(record.people):
        for k in range(len(p.classes)):
            cls_l.append(int(p.classes[k]))
            xy_l.append(np.asarray(p.xy[k], np.float32))
            person_l.append(pidx)
            if 1 <= p.classes[k] <= J:
                joint_index[pidx, p.classes[k] - 1] = len(cls_l) - 1
    cls_arr = np.asarray(cls_l, np.int32)
    if cls_arr.size:
        bad = (cls_arr < 1) | ((cls_arr > J) & (cls_arr != cfg.skip_class))
        if bad.any():
            raise ValueError(
                f"joint classes {sorted(set(cls_arr[bad].tolist()))} out of "
                f"range for num_classes={J} (skip_class={cfg.skip_class})")
    xy_arr = (np.stack(xy_l).astype(np.float32) if cls_l
              else np.zeros((0, 2), np.float32))
    return cls_arr, xy_arr, np.asarray(person_l, np.int32), joint_index


def _host_sampling_state(cls_arr, xy_arr, cfg: T.TargetConfig, scale, th, tw):
    """(sample_mask, min_distance, num_positives) over the (th, tw) grid —
    the inputs the reference's negative-sampling loop reads. Mirrors the
    fg/skip math of targets.rasterize exactly (pose_data_layer.cpp:676-745)."""
    SKIP = cfg.skip_class
    gy, gx = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
    pt = np.stack([gx * T.STRIDE + T.HALF_STRIDE,
                   gy * T.STRIDE + T.HALF_STRIDE],
                  axis=-1).astype(np.float32) / scale
    if not len(cls_arr):
        empty = np.zeros((th, tw), bool)
        return empty, np.full((th, tw), FLT_MAX, np.float32), 0
    diff = xy_arr[None, None, :, :] - pt[:, :, None, :]
    dist = np.sqrt(np.sum(diff * diff, axis=-1)).astype(np.float32)
    min_dist = dist.min(axis=2)
    if cfg.soft_labels:
        flat_arg = np.argmin(dist, axis=2)
        closest_joint = cls_arr[flat_arg]
        scores = np.zeros((th, tw, SKIP + 1), np.float32)
        for c in range(1, SKIP + 1):
            m = cls_arr == c
            if m.any():
                d_c = dist[:, :, m].min(axis=2)
                scores[:, :, c] = np.exp(-d_c ** 2 / (2 * cfg.gauss_blob_sigma ** 2))
        closest_score = np.take_along_axis(
            scores, closest_joint[..., None], axis=2)[..., 0]
        is_fg = (1.0 - closest_score) <= 1 - T.FG_SCORE_THRESH
        if (cls_arr == SKIP).any():
            skip_sample = scores[:, :, SKIP] > T.FG_SCORE_THRESH
        else:
            skip_sample = np.zeros((th, tw), bool)
    else:
        is_fg = min_dist <= cfg.fg_threshold
        if (cls_arr == SKIP).any():
            m = cls_arr == SKIP
            skip_sample = (dist[:, :, m].min(axis=2) <= cfg.fg_threshold)
        else:
            skip_sample = np.zeros((th, tw), bool)
    return (is_fg | skip_sample), min_dist, int(np.sum(is_fg))


def _draw_negative_mask(cfg: T.TargetConfig, sample_mask, min_distance,
                        num_positives, th, tw, rng) -> np.ndarray:
    """Reference negative-sampling loop (pose_data_layer.cpp:828-855),
    emitting the sampled-cell mask instead of writing labels. Draw order is
    identical to targets._fill_negatives_vec so RNG trajectories match."""
    neg = np.zeros_like(sample_mask)
    mask = sample_mask.copy()
    max_neg = int(num_positives * (1.0 - cfg.fg_fraction) / cfg.fg_fraction)
    num_neg = 0
    for _ in range(max_neg * 10):
        j = int(rng.randint(0, th))
        i = int(rng.randint(0, tw))
        if mask[j, i]:
            continue
        if cfg.bg_threshold is not None and min_distance[j, i] <= cfg.bg_threshold:
            continue
        neg[j, i] = True
        mask[j, i] = True
        num_neg += 1
        if num_neg == max_neg:
            break
    return neg


def compact_sample(
    record: ImageRecord,
    cfg: T.TargetConfig,
    stats: Optional[JointStats] = None,
    rng: Optional[np.random.RandomState] = None,
    scale: Optional[float] = None,
    limits: Optional[CompactLimits] = None,
) -> Dict[str, np.ndarray]:
    """Host half of the device-rasterizer pipeline: the compact annotation
    arrays plus whatever targets stay host-built (RPN / segmentation — both
    small). Consumes `rng` in exactly the order targets.rasterize does, so a
    PoseDataSource in device-target mode replays the host mode's stream."""
    if stats is None:
        stats = default_stats(cfg.num_classes)
    if rng is None:
        rng = np.random.RandomState(0)
    if scale is None:
        scale = T.sample_scale(cfg, rng)
    sh, sw, ih, iw = T.grid_geometry(record.height, record.width, scale)
    th = math.ceil(round(record.height * scale) / T.STRIDE)
    tw = math.ceil(round(record.width * scale) / T.STRIDE)
    cls_arr, xy_arr, person_arr, joint_index = _entry_arrays(record, cfg)
    lim = limits or CompactLimits(max(len(cls_arr), 1),
                                  max(len(record.people), 1))
    if len(cls_arr) > lim.max_entries or joint_index.shape[0] > lim.max_people:
        raise ValueError(
            f"record exceeds CompactLimits: {len(cls_arr)} entries / "
            f"{joint_index.shape[0]} people vs {lim}")

    neg_mask = np.zeros((sh, sw), np.uint8)
    if cfg.fg_fraction is not None and not cfg.weight_targets:
        sample_mask, min_dist, npos = _host_sampling_state(
            cls_arr, xy_arr, cfg, scale, th, tw)
        neg_mask[:th, :tw] = _draw_negative_mask(
            cfg, sample_mask, min_dist, npos, th, tw, rng)

    M, P = lim.max_entries, lim.max_people
    cls_pad = np.zeros((M,), np.int32)
    cls_pad[: len(cls_arr)] = cls_arr
    xy_pad = np.zeros((M, 2), np.float32)
    xy_pad[: len(cls_arr)] = xy_arr
    person_pad = np.zeros((M,), np.int32)
    person_pad[: len(cls_arr)] = person_arr
    ji_pad = np.full((P, cfg.num_classes), -1, np.int32)
    ji_pad[: joint_index.shape[0]] = joint_index

    out: Dict[str, np.ndarray] = {
        "anno_cls": cls_pad,
        "anno_xy": xy_pad,
        "anno_person": person_pad,
        "anno_joint_index": ji_pad,
        "anno_scale": np.float32(scale),
        "anno_dims": np.array([th, tw, sh, sw], np.int32),
        "anno_neg_mask": neg_mask,
        "scale": np.float32(scale),
        "input_size": np.array([ih, iw], np.int32),
    }
    T._add_aux_targets(out, record, cfg, rng, scale, sh, sw, th, tw, ih, iw)
    return out


# --------------------------------------------------------------------------
# Device half (torch): the dense maps of a batch
# --------------------------------------------------------------------------


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


def make_batch_rasterizer(cfg: T.TargetConfig, stats: Optional[JointStats] = None,
                          grid: Optional[Tuple[int, int]] = None):
    """Returns `apply(batch) -> batch` replacing the ``anno_*`` tensors with
    the dense NCHW target maps, rasterized on their device; a no-op for a
    batch that already carries dense targets. The stride-8 grid comes from
    the NCHW ``image`` canvas (bucketed), or is `grid` = (gh, gw) where the
    image is a row block of the canvas (`parallel.spatial`): the targets
    are sharded over 'data' only, so every row shard rasterizes the whole
    grid."""
    stats = stats or default_stats(cfg.num_classes)

    def apply(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if "anno_cls" not in batch:
            return dict(batch)
        if grid is not None:
            gh, gw = grid
        else:
            img = batch["image"]
            gh, gw = img.shape[2] // T.STRIDE, img.shape[3] // T.STRIDE
        annos = {k: v for k, v in batch.items() if k.startswith("anno_")}
        rest = {k: v for k, v in batch.items() if not k.startswith("anno_")}
        return {**rest, **rasterize_batch(annos, cfg, stats, gh, gw)}

    return apply
