"""On-device augmentation: the affine warp + scale + canvas prep of a batch.

Counterpart of `deepcut_tpu.pose.augment_device.warp_batch`. The host ships
the decoded uint8 image (mean-padded to a raw bucket) and six affine
coefficients (`pose.augment.device_warp_coef`, the JAX package's jax-free
code); the canvas is resampled on the device in two one-axis bilinear
passes:

    img1(y, x') = raw(a*y + b*x' + c, x')     # rows
    out(y, x)   = img1(y, d*x + e*y + f)      # columns

The JAX package writes each pass as an einsum against tent weights
``max(0, 1 - |p - r|)`` over every raw row (column), because the TPU
serializes gathers. On the card a two-tap gather is the idiom, and it is
the same sum: of the tent weights only those of ``floor(p)`` and
``floor(p) + 1`` can be non-zero, and the zero products add nothing. The
taps keep the reference's weights and order (lower tap first); a tap
outside the raw image contributes nothing, as it has no row there.

Kept from the reference: the truncation of the warped image to uint8 before
the paste (``floor`` before the clip, so a one-ULP difference of a sum
landing on an integer moves a pixel by one grey level), the 64-px
edge-replication band (a clamped canvas coordinate), the mean fill beyond
it, and the error on a canvas height that is not a multiple of 16.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from deepcut_tpu_torch.constants import MEAN_BGR

PAD_BORDER = 64   # data/pipeline.PAD_BORDER (pose_data_layer.cpp:637)
ROW_BLOCK = 16    # the reference warps canvas rows in blocks of 16


def _two_tap(p: torch.Tensor, size: int):
    """Lower tap index, both tent weights and in-range masks for sample
    positions `p` on an axis of `size` samples."""
    r0 = torch.floor(p)
    r1 = r0 + 1.0
    w0 = torch.clamp(1.0 - torch.abs(p - r0), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(p - r1), min=0.0)
    ok0 = (r0 >= 0) & (r0 <= size - 1)
    ok1 = (r1 >= 0) & (r1 <= size - 1)
    return r0.long().clamp(0, size - 1), r1.long().clamp(0, size - 1), \
        torch.where(ok0, w0, 0.0), torch.where(ok1, w1, 0.0)


def warp_images(raw: torch.Tensor, coef: torch.Tensor, nhw: torch.Tensor,
                ih: int, iw: int, y0: int = 0) -> torch.Tensor:
    """(B, RH, RW, 3) uint8 mean-padded raws -> (B, ih, iw, 3) f32
    mean-subtracted canvases. coef (B, 6) = [a b c d e f]; nhw (B, 4) =
    [nh nw input_h input_w]: the warped size before the edge band, and the
    canvas size the host path would have produced (zero beyond it).

    y0: the first GLOBAL canvas row produced; the row-sharded path passes
    its block's start, and each row is computed from its own coordinate
    alone, so the rows equal those of the full canvas bit for bit."""
    if ih % ROW_BLOCK:
        raise ValueError(f"canvas height {ih} not a multiple of {ROW_BLOCK} "
                         f"(bucket_step must be)")
    f32 = torch.float32
    dev = raw.device
    B, rh, rw = raw.shape[0], raw.shape[1], raw.shape[2]
    coef, nhw = coef.to(f32), nhw.to(f32)
    a, b, c, d, e, f = (coef[:, i].reshape(B, 1, 1) for i in range(6))
    nh, nw, sh, sw = (nhw[:, i].reshape(B, 1, 1) for i in range(4))
    mean = torch.tensor(MEAN_BGR, dtype=f32, device=dev)
    # mean-padded raw -> 0 outside the real image after the subtract, so a
    # border tap blends toward the mean like cv2's BORDER_CONSTANT
    rawf = raw.to(f32) - mean                                    # (B, RH, RW, 3)
    x = torch.arange(iw, dtype=f32, device=dev)
    y = float(y0) + torch.arange(ih, dtype=f32, device=dev)
    # the 64-px edge-replication band == clamping the canvas coordinate
    x_eff = torch.minimum(x.reshape(1, 1, iw), nw - 1.0)          # (B, 1, iw)
    y_eff = torch.minimum(y.reshape(1, ih, 1), nh - 1.0)          # (B, ih, 1)
    bi = torch.arange(B, device=dev).reshape(B, 1, 1)

    # pass 1 (vertical): img1[y, x'] = raw(a*y_eff + b*x' + c, x')
    xs = torch.arange(rw, dtype=f32, device=dev).reshape(1, 1, rw)
    p1 = a * y_eff + b * xs + c                                  # (B, ih, RW)
    r0, r1, w0, w1 = _two_tap(p1, rh)
    xi = torch.arange(rw, device=dev).reshape(1, 1, rw)
    img1 = w0[..., None] * rawf[bi, r0, xi] + w1[..., None] * rawf[bi, r1, xi]  # (B, ih, RW, 3)

    # pass 2 (horizontal): out[y, x] = img1(y, d*x_eff + e*y_eff + f)
    p2 = d * x_eff + e * y_eff + f                               # (B, ih, iw)
    q0, q1, u0, u1 = _two_tap(p2, rw)
    yi = torch.arange(ih, device=dev).reshape(1, ih, 1)   # local rows of img1
    out = u0[..., None] * img1[bi, yi, q0] + u1[..., None] * img1[bi, yi, q1]   # (B, ih, iw, 3)

    # the host path truncates the warped image to uint8 before the paste
    out = torch.clamp(torch.floor(out + mean), 0.0, 255.0) - mean
    # the host canvas is (input_h, input_w): the edge band is cropped there
    # and the bucket beyond it is zero; beyond the band it is the mean (0)
    band = ((y.reshape(1, ih, 1) < torch.minimum(nh + PAD_BORDER, sh))
            & (x.reshape(1, 1, iw) < torch.minimum(nw + PAD_BORDER, sw)))
    return torch.where(band[..., None], out, 0.0)


def warp_batch(batch: Mapping[str, torch.Tensor], y0: int = 0) -> Dict[str, torch.Tensor]:
    """Replace a raw-image batch's ``image_raw`` / ``aug_*`` entries with the
    warped f32 canvas under ``image``, NCHW (channels_last memory). No-op
    for a batch without ``image_raw``. y0: the first global canvas row of
    the ``aug_canvas`` token's rows (`warp_images`)."""
    batch = dict(batch)
    if "image_raw" not in batch:
        return batch
    raw = batch.pop("image_raw")
    coef = batch.pop("aug_coef")
    nhw = batch.pop("aug_nhw")
    token = batch.pop("aug_canvas")   # (B, ih, iw, 0): its shape is the payload
    ih, iw = int(token.shape[1]), int(token.shape[2])
    batch["image"] = warp_images(raw, coef, nhw, ih, iw, y0=y0).permute(0, 3, 1, 2)
    return batch


def warp_batch_local(batch: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """`warp_batch` for a rank of a spatial mesh (`parallel.spatial`): the
    raw images and coefficients are its data row's (replicated over the
    'spatial' axis), the ``aug_canvas`` token its block of the canvas rows,
    and it warps only those rows (global rows [s*ih, (s+1)*ih)). No halos:
    the source is the whole raw image, so the rows equal the same rows of
    `warp_batch`'s canvas bit for bit and the warp's cost divides by the
    axis size. No-op without ``image_raw``."""
    return warp_batch(batch, y0=mesh.spatial_index * int(batch["aug_canvas"].shape[1])
                      if "aug_canvas" in batch else 0)
