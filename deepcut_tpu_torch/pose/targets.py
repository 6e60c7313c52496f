"""Training-target rasterizer: keypoint annotations -> dense stride-8 maps.

The port's own copy of `deepcut_tpu.pose.targets` (jax-free; held against the original
by tests/test_torch_data.py and tests/test_torch_surface_parity.py).

Reimplements the PoseDataLayer target construction
(src/caffe/layers/pose_data_layer.cpp:676-855) semantics:

- grid cell centres at ``i*8+4`` mapped back to original coords by 1/scale;
- per class, the CLOSEST instance across all people defines score/offset;
- hard scores ``dist <= fg_threshold`` or soft Gaussian ``exp(-d^2/2s^2)``;
- skip regions (class 15) with score > 0.05 leave cells at ignore (1000);
- location refinement: scaled offsets / sqrt(53) for classes scoring >=0.05;
- pairwise ("regress_to_other"): per directed edge (cls -> next_cls), offset
  from the cell to the *closest cls-person's* next_cls joint, normalised by
  per-edge mean/std (182 edges for 14 joints);
- negatives: either class-weight maps down-weighting background by
  ``(1-fg)/fg * P/N`` or fg_fraction-limited random negative sampling.

Three implementations ship here: `rasterize_reference` (naive loops, the
oracle, mirrors the C++ control flow), `rasterize` (vectorized numpy) and
`rasterize_native` (the C++ rasterizer of `runtime`, which the input
pipeline calls; it takes the numpy path where no C++ compiler is at hand).

Output layout is NHWC-style (h, w, C), the JAX package's; channels are
identical in order to the reference's NCHW blobs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepcut_tpu_torch.data.window_file import ImageRecord, JointStats, default_stats

IGNORE_VALUE = 1000.0
STRIDE = 8
HALF_STRIDE = 4
LOCREF_STD = math.sqrt(53.0)
FG_SCORE_THRESH = 0.05


@dataclasses.dataclass(frozen=True)
class TargetConfig:
    """Mirrors PoseDataParameter (caffe.proto:1142-1187) defaults."""

    num_classes: int = 14
    scale: float = 1.0
    scale_jitter_lo: Optional[float] = None   # both set => jitter enabled
    scale_jitter_up: Optional[float] = None
    fg_threshold: float = 17.0
    bg_threshold: Optional[float] = None      # set => used in negative sampling
    fg_fraction: Optional[float] = None       # set => fg-fraction sampling
    soft_labels: bool = False
    gauss_blob_sigma: float = 10.0
    multi_label: bool = False
    no_bg_class: bool = False
    location_refinement: bool = True
    regress_to_other: bool = False
    weight_targets: bool = False
    rpn: bool = False
    rpn_distance_threshold: float = 17.0
    segmentation: bool = False
    segmentation_stride: int = 8
    max_input_size: int = 700
    min_image_size: int = 100

    @property
    def skip_class(self) -> int:
        return self.num_classes + 1

    @property
    def label_channels(self) -> int:
        return self.num_classes + (0 if self.no_bg_class else 1)


def grid_geometry(height: int, width: int, scale: float) -> Tuple[int, int, int, int]:
    """(sc_map_h, sc_map_w, input_h, input_w): stride-8 grid for scaled image."""
    sh = math.ceil(height * scale / STRIDE)
    sw = math.ceil(width * scale / STRIDE)
    return sh, sw, sh * STRIDE, sw * STRIDE


def accepts(cfg: TargetConfig, height: int, width: int, scale: float) -> bool:
    """Rejection rules (pose_data_layer.cpp:552-569)."""
    if height < cfg.min_image_size or width < cfg.min_image_size:
        return False
    _, _, ih, iw = grid_geometry(height, width, scale)
    return ih * iw <= cfg.max_input_size ** 2


# --------------------------------------------------------------------------
# Reference (naive) implementation — the test oracle
# --------------------------------------------------------------------------


def rasterize_reference(
    record: ImageRecord,
    cfg: TargetConfig,
    stats: Optional[JointStats] = None,
    rng: Optional[np.random.RandomState] = None,
    scale: Optional[float] = None,
) -> Dict[str, np.ndarray]:
    if stats is None:
        stats = default_stats(cfg.num_classes)
    if rng is None:
        rng = np.random.RandomState(0)
    if scale is None:
        scale = sample_scale(cfg, rng)
    J = cfg.num_classes
    sh, sw, ih, iw = grid_geometry(record.height, record.width, scale)
    th = math.ceil(round(record.height * scale) / STRIDE)
    tw = math.ceil(round(record.width * scale) / STRIDE)
    C = cfg.label_channels
    first = 1 if cfg.no_bg_class else 0

    labels = np.full((sh, sw, C), IGNORE_VALUE, np.float32)
    weights = np.ones((sh, sw, C), np.float32)
    loc_t = np.zeros((sh, sw, 2 * J), np.float32)
    loc_w = np.zeros((sh, sw, 2 * J), np.float32)
    E = len(stats.edges)
    next_t = np.zeros((sh, sw, 2 * E), np.float32)
    next_w = np.zeros((sh, sw, 2 * E), np.float32)
    sample_mask = np.zeros((sh, sw), bool)
    min_distance = np.full((sh, sw), np.finfo(np.float32).max, np.float32)

    people = record.people
    joint_index = []  # per person: class -> index in their list (-1 absent)
    for p in people:
        ji = np.full((J,), -1, np.int32)
        for k, cls in enumerate(p.classes):
            if 1 <= cls <= J:
                ji[cls - 1] = k
        joint_index.append(ji)

    num_positives = 0
    for j in range(th):
        for i in range(tw):
            pt = np.array([i * STRIDE + HALF_STRIDE, j * STRIDE + HALF_STRIDE],
                          np.float32) / scale
            scores = np.zeros((cfg.skip_class + 1,), np.float32)
            dists = np.full((J,), np.finfo(np.float32).max, np.float32)
            person_dists = np.full((J,), -1, np.int32)
            diffs = np.zeros((J, 2), np.float32)
            min_dist = np.finfo(np.float32).max
            closest_joint = -1
            skip_sample = False
            for pidx, p in enumerate(people):
                for k in range(len(p.classes)):
                    cls = int(p.classes[k])
                    diff = p.xy[k] - pt
                    dist = float(np.sqrt(np.dot(diff, diff)))
                    jid = cls - 1
                    if cls != cfg.skip_class and dist < dists[jid]:
                        if cfg.soft_labels:
                            scores[cls] = math.exp(-dist * dist / (2 * cfg.gauss_blob_sigma ** 2))
                        else:
                            scores[cls] = 1.0 if dist <= cfg.fg_threshold else 0.0
                        dists[jid] = dist
                        person_dists[jid] = pidx
                        diffs[jid] = diff * scale
                    elif cls == cfg.skip_class:
                        # reference updates scores/dists for skip class too,
                        # but never diffs (pose_data_layer.cpp:697-706)
                        if cfg.soft_labels:
                            sc = math.exp(-dist * dist / (2 * cfg.gauss_blob_sigma ** 2))
                        else:
                            sc = 1.0 if dist <= cfg.fg_threshold else 0.0
                        scores[cls] = max(scores[cls], sc)
                    if dist < min_dist:
                        min_dist = dist
                        closest_joint = cls
                    if cls == cfg.skip_class and scores[cls] > FG_SCORE_THRESH:
                        skip_sample = True
            min_distance[j, i] = min_dist
            scores[0] = 1 - scores[closest_joint] if closest_joint >= 0 else 1.0

            is_fg = (scores[0] <= 1 - FG_SCORE_THRESH) if cfg.soft_labels \
                else (min_dist <= cfg.fg_threshold)
            if is_fg:
                num_positives += 1
            if is_fg or skip_sample:
                sample_mask[j, i] = True
            if skip_sample:
                continue
            if cfg.fg_fraction is not None and not is_fg:
                continue
            if not cfg.soft_labels and not cfg.multi_label:
                curr = closest_joint if is_fg else 0
                for cls in range(J + 1):
                    scores[cls] = 1.0 if cls == curr else 0.0
            for cls in range(first, J + 1):
                labels[j, i, cls - first] = scores[cls]
            if is_fg and cfg.location_refinement:
                for cls in range(1, J + 1):
                    if scores[cls] < FG_SCORE_THRESH:
                        continue
                    jid = cls - 1
                    loc_t[j, i, 2 * jid:2 * jid + 2] = diffs[jid] / LOCREF_STD
                    loc_w[j, i, 2 * jid:2 * jid + 2] = 1.0
            if is_fg and cfg.regress_to_other:
                for l in range(E):
                    cls, next_cls = int(stats.edges[l, 0]), int(stats.edges[l, 1])
                    if scores[cls] < FG_SCORE_THRESH:
                        continue
                    pidx = int(person_dists[cls - 1])
                    if pidx < 0:
                        continue
                    nj = int(joint_index[pidx][next_cls - 1])
                    if nj < 0:
                        continue
                    nxt = people[pidx].xy[nj]
                    d = (nxt - pt) * scale
                    next_t[j, i, 2 * l] = (d[0] - stats.means[l, 0]) / stats.std_devs[l, 0]
                    next_t[j, i, 2 * l + 1] = (d[1] - stats.means[l, 1]) / stats.std_devs[l, 1]
                    next_w[j, i, 2 * l:2 * l + 2] = 1.0

    _fill_negatives(cfg, labels, weights, sample_mask, min_distance,
                    num_positives, th, tw, rng, first)
    out = {
        "part_score_targets": labels,
        "part_score_weights": weights,
        "scale": np.float32(scale),
        "input_size": np.array([ih, iw], np.int32),
    }
    if cfg.location_refinement:
        out["locref_targets"] = loc_t
        out["locref_weights"] = loc_w
    if cfg.regress_to_other:
        out["pairwise_targets"] = next_t
        out["pairwise_weights"] = next_w
    return out


def _fill_negatives(cfg, labels, weights, sample_mask, min_distance,
                    num_positives, th, tw, rng, first):
    """weight_targets / fg_fraction negative handling
    (pose_data_layer.cpp:806-855)."""
    J = cfg.num_classes
    sh, sw = labels.shape[:2]
    if cfg.weight_targets:
        total = sh * sw
        neg = max(total - num_positives, 1)
        w = ((1 - (cfg.fg_fraction or 0.25)) / (cfg.fg_fraction or 0.25)
             * num_positives / neg)
        for j in range(sh):
            for i in range(sw):
                if sample_mask[j, i]:
                    continue
                for c in range(first, J + 1):
                    labels[j, i, c - first] = 1.0 if c == 0 else 0.0
                    weights[j, i, c - first] = w
    elif cfg.fg_fraction is not None:
        max_neg = int(num_positives * (1.0 - cfg.fg_fraction) / cfg.fg_fraction)
        num_neg = 0
        for _ in range(max_neg * 10):
            j = int(rng.randint(0, th))
            i = int(rng.randint(0, tw))
            if sample_mask[j, i]:
                continue
            if cfg.bg_threshold is not None and min_distance[j, i] <= cfg.bg_threshold:
                continue
            for c in range(first, J + 1):
                labels[j, i, c - first] = 1.0 if c == 0 else 0.0
            sample_mask[j, i] = True
            num_neg += 1
            if num_neg == max_neg:
                break




def sample_scale(cfg: TargetConfig, rng: np.random.RandomState) -> float:
    scale = cfg.scale
    if cfg.scale_jitter_lo is not None and cfg.scale_jitter_up is not None:
        r = rng.random_sample()
        scale *= cfg.scale_jitter_lo + (cfg.scale_jitter_up - cfg.scale_jitter_lo) * r
    return scale


# --------------------------------------------------------------------------
# Vectorized implementation — used by the input pipeline
# --------------------------------------------------------------------------


def rasterize(
    record: ImageRecord,
    cfg: TargetConfig,
    stats: Optional[JointStats] = None,
    rng: Optional[np.random.RandomState] = None,
    scale: Optional[float] = None,
) -> Dict[str, np.ndarray]:
    if stats is None:
        stats = default_stats(cfg.num_classes)
    if rng is None:
        rng = np.random.RandomState(0)
    if scale is None:
        scale = sample_scale(cfg, rng)
    J = cfg.num_classes
    SKIP = cfg.skip_class
    sh, sw, ih, iw = grid_geometry(record.height, record.width, scale)
    th = math.ceil(round(record.height * scale) / STRIDE)
    tw = math.ceil(round(record.width * scale) / STRIDE)
    C = cfg.label_channels
    first = 1 if cfg.no_bg_class else 0

    # Flatten all (person, joint) entries preserving reference iteration order.
    entries_cls, entries_xy, entries_person = [], [], []
    # joint_index[p, j] = GLOBAL entry index of person p's joint class j+1.
    joint_index = np.full((max(len(record.people), 1), J), -1, np.int64)
    for pidx, p in enumerate(record.people):
        for k in range(len(p.classes)):
            entries_cls.append(int(p.classes[k]))
            entries_xy.append(p.xy[k])
            entries_person.append(pidx)
            if 1 <= p.classes[k] <= J:
                joint_index[pidx, p.classes[k] - 1] = len(entries_cls) - 1
    n_entries = len(entries_cls)

    gy, gx = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
    pt = np.stack([gx * STRIDE + HALF_STRIDE, gy * STRIDE + HALF_STRIDE],
                  axis=-1).astype(np.float32) / scale      # (th, tw, 2)

    labels = np.full((sh, sw, C), IGNORE_VALUE, np.float32)
    weights = np.ones((sh, sw, C), np.float32)
    loc_t = np.zeros((sh, sw, 2 * J), np.float32)
    loc_w = np.zeros((sh, sw, 2 * J), np.float32)
    E = len(stats.edges)
    next_t = np.zeros((sh, sw, 2 * E), np.float32)
    next_w = np.zeros((sh, sw, 2 * E), np.float32)
    sample_mask = np.zeros((sh, sw), bool)
    min_distance = np.full((sh, sw), np.finfo(np.float32).max, np.float32)
    num_positives = 0

    if n_entries:
        cls_arr = np.asarray(entries_cls, np.int64)              # (M,)
        xy_arr = np.stack(entries_xy).astype(np.float32)         # (M, 2)
        person_arr = np.asarray(entries_person, np.int64)
        diff_all = xy_arr[None, None, :, :] - pt[:, :, None, :]  # (th, tw, M, 2)
        dist_all = np.sqrt(np.sum(diff_all * diff_all, axis=-1)).astype(np.float32)

        # closest entry overall (ties -> first entry, like the C++ strict <)
        flat_arg = np.argmin(dist_all, axis=2)
        min_dist = np.take_along_axis(dist_all, flat_arg[..., None], axis=2)[..., 0]
        closest_joint = cls_arr[flat_arg]                        # (th, tw)

        # per class: distance/index of closest instance of that class
        scores = np.zeros((th, tw, SKIP + 1), np.float32)
        class_dist = np.full((th, tw, SKIP + 1), np.finfo(np.float32).max, np.float32)
        class_arg = np.zeros((th, tw, SKIP + 1), np.int64)
        for c in range(1, SKIP + 1):
            m = cls_arr == c
            if not m.any():
                continue
            d_c = dist_all[:, :, m]
            a_c = np.argmin(d_c, axis=2)
            class_dist[:, :, c] = np.take_along_axis(d_c, a_c[..., None], axis=2)[..., 0]
            class_arg[:, :, c] = np.flatnonzero(m)[a_c]
            if cfg.soft_labels:
                scores[:, :, c] = np.exp(-class_dist[:, :, c] ** 2 /
                                         (2 * cfg.gauss_blob_sigma ** 2))
            else:
                scores[:, :, c] = (class_dist[:, :, c] <= cfg.fg_threshold).astype(np.float32)

        if (cls_arr == SKIP).any():
            skip_sample = scores[:, :, SKIP] > FG_SCORE_THRESH
        else:
            skip_sample = np.zeros((th, tw), bool)
        closest_score = np.take_along_axis(scores, closest_joint[..., None], axis=2)[..., 0]
        scores[:, :, 0] = 1.0 - closest_score

        is_fg = (scores[:, :, 0] <= 1 - FG_SCORE_THRESH) if cfg.soft_labels \
            else (min_dist <= cfg.fg_threshold)
        num_positives = int(np.sum(is_fg))
        sample_mask[:th, :tw] = is_fg | skip_sample
        min_distance[:th, :tw] = min_dist

        write = ~skip_sample
        if cfg.fg_fraction is not None:
            write = write & is_fg
        if not cfg.soft_labels and not cfg.multi_label:
            curr = np.where(is_fg, closest_joint, 0)
            onehot = np.zeros((th, tw, SKIP + 1), np.float32)
            np.put_along_axis(onehot, curr[..., None], 1.0, axis=2)
            scores_out = onehot
        else:
            scores_out = scores
        lab_block = labels[:th, :tw]
        lab_block[write] = scores_out[..., first:J + 1][write]
        labels[:th, :tw] = lab_block

        # The reference overwrites `scores` in place with the one-hot BEFORE
        # the locref/pairwise gating (pose_data_layer.cpp:738-745 then :746+),
        # so in hard non-multi mode only the closest class gets regression
        # targets. Gate on the post-overwrite scores.
        gate_scores = scores_out
        if cfg.location_refinement:
            person_of = np.zeros((th, tw, J), np.int64)
            for c in range(1, J + 1):
                jid = c - 1
                active = write & is_fg & (gate_scores[:, :, c] >= FG_SCORE_THRESH) \
                    & (class_dist[:, :, c] < np.finfo(np.float32).max)
                arg = class_arg[:, :, c]
                d = np.take_along_axis(
                    diff_all, arg[..., None, None], axis=2)[..., 0, :] * scale
                loc_t[:th, :tw, 2 * jid] = np.where(active, d[..., 0] / LOCREF_STD,
                                                    loc_t[:th, :tw, 2 * jid])
                loc_t[:th, :tw, 2 * jid + 1] = np.where(active, d[..., 1] / LOCREF_STD,
                                                        loc_t[:th, :tw, 2 * jid + 1])
                loc_w[:th, :tw, 2 * jid] = np.where(active, 1.0, loc_w[:th, :tw, 2 * jid])
                loc_w[:th, :tw, 2 * jid + 1] = loc_w[:th, :tw, 2 * jid]
                person_of[:, :, jid] = person_arr[arg]
        else:
            person_of = None

        if cfg.regress_to_other:
            if person_of is None:
                person_of = np.zeros((th, tw, J), np.int64)
                for c in range(1, J + 1):
                    person_of[:, :, c - 1] = person_arr[class_arg[:, :, c]]
            all_xy = np.stack(entries_xy).astype(np.float32)
            for l in range(E):
                cls, next_cls = int(stats.edges[l, 0]), int(stats.edges[l, 1])
                active = write & is_fg & (gate_scores[:, :, cls] >= FG_SCORE_THRESH) \
                    & (class_dist[:, :, cls] < np.finfo(np.float32).max)
                pidx = person_of[:, :, cls - 1]
                nj = joint_index[pidx, next_cls - 1]          # (th, tw)
                active = active & (nj >= 0)
                nxt = all_xy[np.clip(nj, 0, None)]            # (th, tw, 2)
                d = (nxt - pt) * scale
                tx = (d[..., 0] - stats.means[l, 0]) / stats.std_devs[l, 0]
                ty = (d[..., 1] - stats.means[l, 1]) / stats.std_devs[l, 1]
                next_t[:th, :tw, 2 * l] = np.where(active, tx, next_t[:th, :tw, 2 * l])
                next_t[:th, :tw, 2 * l + 1] = np.where(active, ty, next_t[:th, :tw, 2 * l + 1])
                next_w[:th, :tw, 2 * l] = np.where(active, 1.0, next_w[:th, :tw, 2 * l])
                next_w[:th, :tw, 2 * l + 1] = next_w[:th, :tw, 2 * l]

    if not n_entries:
        _fill_background_empty(cfg, labels, th, tw, first)
    _fill_negatives_vec(cfg, labels, weights, sample_mask, min_distance,
                        num_positives, th, tw, rng, first)
    out = {
        "part_score_targets": labels,
        "part_score_weights": weights,
        "scale": np.float32(scale),
        "input_size": np.array([ih, iw], np.int32),
    }
    if cfg.location_refinement:
        out["locref_targets"] = loc_t
        out["locref_weights"] = loc_w
    if cfg.regress_to_other:
        out["pairwise_targets"] = next_t
        out["pairwise_weights"] = next_w
    _add_aux_targets(out, record, cfg, rng, scale, sh, sw, th, tw, ih, iw)
    return out


def _fill_background_empty(cfg, labels, th, tw, first):
    """Zero-joint records: the reference's main cell loop still writes the
    background one-hot to every cell when fg_fraction is unset (its min
    distance is just FLT_MAX everywhere) — matching the JAX package's
    rasterize_reference.
    With fg_fraction set, 0 positives -> 0 sampled negatives -> all IGNORE,
    and weight_targets fills backgrounds itself in _fill_negatives_vec."""
    if cfg.fg_fraction is None and not cfg.weight_targets:
        onehot = np.zeros((cfg.num_classes + 1,), np.float32)
        onehot[0] = 1.0
        labels[:th, :tw] = onehot[first:][None, None, :]


def _add_aux_targets(out, record, cfg, rng, scale, sh, sw, th, tw, ih, iw):
    """RPN + sticks-segmentation tops (pose_data_layer.cpp:857-906).

    Emitted whenever the config enables them — the layer's top count is
    fixed per prototxt, so a zero-person record must still produce the
    blobs (all-IGNORE cls / zero reg, exactly what the reference's
    prepareLabel pre-fill leaves when the rasterizers have nothing to do);
    otherwise batches mixing empty and annotated records would misbind."""
    from deepcut_tpu_torch.pose.aux_targets import (
        NUM_ANCHORS, NUM_REG_TARGS, NUM_SEGM_CLASSES, rpn_targets,
        sticks_segmentation)

    if cfg.rpn:
        if record.people:
            cls, reg, reg_w = rpn_targets(
                record.people[0], sh, sw, th, tw, scale=scale,
                distance_threshold=cfg.rpn_distance_threshold, rng=rng)
        else:
            cls = np.full((sh, sw, NUM_ANCHORS), IGNORE_VALUE, np.float32)
            reg = np.zeros((sh, sw, NUM_ANCHORS * NUM_REG_TARGS), np.float32)
            reg_w = np.zeros_like(reg)
        out["rpn_cls_targets"] = cls
        out["rpn_reg_targets"] = reg
        out["rpn_reg_weights"] = reg_w
    if cfg.segmentation:
        seg_h = math.ceil(ih / cfg.segmentation_stride)
        seg_w = math.ceil(iw / cfg.segmentation_stride)
        if record.people:
            out["segm_cls_targets"] = sticks_segmentation(
                record.people[0], seg_h, seg_w, scale=scale,
                segm_stride=cfg.segmentation_stride, rng=rng)
        else:
            out["segm_cls_targets"] = np.full(
                (seg_h, seg_w, NUM_SEGM_CLASSES), IGNORE_VALUE, np.float32)


def rasterize_native(
    record: ImageRecord,
    cfg: TargetConfig,
    stats: Optional[JointStats] = None,
    rng: Optional[np.random.RandomState] = None,
    scale: Optional[float] = None,
) -> Dict[str, np.ndarray]:
    """C++ fast path (`runtime`, built with g++ at first use); the
    vectorized numpy implementation where it cannot be built.
    Negative sampling stays in Python either way (RNG-stream parity)."""
    from deepcut_tpu_torch import runtime

    lib = runtime.load_library()
    if lib is None:
        return rasterize(record, cfg, stats, rng, scale)
    if stats is None:
        stats = default_stats(cfg.num_classes)
    if rng is None:
        rng = np.random.RandomState(0)
    if scale is None:
        scale = sample_scale(cfg, rng)
    J = cfg.num_classes
    sh, sw, ih, iw = grid_geometry(record.height, record.width, scale)
    th = math.ceil(round(record.height * scale) / STRIDE)
    tw = math.ceil(round(record.width * scale) / STRIDE)
    C = cfg.label_channels

    cls_l, xy_l, person_l = [], [], []
    joint_index = np.full((max(len(record.people), 1), J), -1, np.int64)
    for pidx, p in enumerate(record.people):
        for k in range(len(p.classes)):
            cls_l.append(int(p.classes[k]))
            xy_l.append(p.xy[k])
            person_l.append(pidx)
            if 1 <= p.classes[k] <= J:
                joint_index[pidx, p.classes[k] - 1] = len(cls_l) - 1
    n = len(cls_l)
    entry_cls = np.asarray(cls_l, np.int32)
    entry_xy = (np.stack(xy_l).astype(np.float32) if n else np.zeros((0, 2), np.float32))
    entry_person = np.asarray(person_l, np.int32)
    # the C kernel indexes per-class arrays of size J (+skip) by cls-1 with
    # no bounds checks; a window file labeled for more joints than
    # num_classes would corrupt memory — fail loudly like the numpy path
    if n:
        bad = (entry_cls < 1) | ((entry_cls > J) & (entry_cls != cfg.skip_class))
        if bad.any():
            raise ValueError(
                f"joint classes {sorted(set(entry_cls[bad].tolist()))} out of "
                f"range for num_classes={J} (skip_class={cfg.skip_class})")

    labels = np.full((sh, sw, C), IGNORE_VALUE, np.float32)
    weights = np.ones((sh, sw, C), np.float32)
    loc_t = np.zeros((sh, sw, 2 * J), np.float32)
    loc_w = np.zeros((sh, sw, 2 * J), np.float32)
    E = len(stats.edges)
    next_t = np.zeros((sh, sw, 2 * E), np.float32)
    next_w = np.zeros((sh, sw, 2 * E), np.float32)
    sample_mask_u8 = np.zeros((sh, sw), np.uint8)
    min_distance = np.full((sh, sw), np.finfo(np.float32).max, np.float32)

    num_positives = 0
    if n:
        num_positives = lib.dc_rasterize(
            entry_cls, np.ascontiguousarray(entry_xy.reshape(-1)), entry_person, n,
            np.ascontiguousarray(joint_index.reshape(-1)),
            len(record.people), J, cfg.skip_class,
            th, tw, sh, sw,
            np.float32(scale), np.float32(cfg.fg_threshold),
            int(cfg.soft_labels), np.float32(cfg.gauss_blob_sigma),
            int(cfg.multi_label), int(cfg.no_bg_class),
            int(cfg.fg_fraction is not None),
            int(cfg.location_refinement), int(cfg.regress_to_other),
            np.ascontiguousarray(stats.edges.reshape(-1).astype(np.int32)),
            np.ascontiguousarray(stats.means.reshape(-1).astype(np.float32)),
            np.ascontiguousarray(stats.std_devs.reshape(-1).astype(np.float32)), E,
            labels.reshape(-1), loc_t.reshape(-1), loc_w.reshape(-1),
            next_t.reshape(-1), next_w.reshape(-1),
            sample_mask_u8.reshape(-1), min_distance.reshape(-1),
        )
    sample_mask = sample_mask_u8.astype(bool)
    if not n:
        _fill_background_empty(cfg, labels, th, tw, 1 if cfg.no_bg_class else 0)
    _fill_negatives_vec(cfg, labels, weights, sample_mask, min_distance,
                        num_positives, th, tw, rng, 1 if cfg.no_bg_class else 0)
    out = {
        "part_score_targets": labels,
        "part_score_weights": weights,
        "scale": np.float32(scale),
        "input_size": np.array([ih, iw], np.int32),
    }
    if cfg.location_refinement:
        out["locref_targets"] = loc_t
        out["locref_weights"] = loc_w
    if cfg.regress_to_other:
        out["pairwise_targets"] = next_t
        out["pairwise_weights"] = next_w
    _add_aux_targets(out, record, cfg, rng, scale, sh, sw, th, tw, ih, iw)
    return out


def _fill_negatives_vec(cfg, labels, weights, sample_mask, min_distance,
                        num_positives, th, tw, rng, first):
    J = cfg.num_classes
    sh, sw = labels.shape[:2]
    if cfg.weight_targets:
        total = sh * sw
        neg = max(total - num_positives, 1)
        w = ((1 - (cfg.fg_fraction or 0.25)) / (cfg.fg_fraction or 0.25)
             * num_positives / neg)
        bg = ~sample_mask
        onehot = np.zeros((J + 1,), np.float32)
        onehot[0] = 1.0
        labels[bg] = onehot[first:][None, :]
        weights[bg] = w
    elif cfg.fg_fraction is not None:
        # Random sampling loop kept scalar to match the reference's RNG-driven
        # semantics exactly (pose_data_layer.cpp:828-855).
        max_neg = int(num_positives * (1.0 - cfg.fg_fraction) / cfg.fg_fraction)
        num_neg = 0
        onehot = np.zeros((J + 1,), np.float32)
        onehot[0] = 1.0
        for _ in range(max_neg * 10):
            j = int(rng.randint(0, th))
            i = int(rng.randint(0, tw))
            if sample_mask[j, i]:
                continue
            if cfg.bg_threshold is not None and min_distance[j, i] <= cfg.bg_threshold:
                continue
            labels[j, i] = onehot[first:]
            sample_mask[j, i] = True
            num_neg += 1
            if num_neg == max_neg:
                break
