"""Port device warp (`deepcut_tpu_torch.pose.augment_device`) against
`deepcut_tpu.pose.augment_device.warp_batch`.

The same mean-padded uint8 raws and affine coefficients
(`pose.augment.device_warp_coef`) go through the JAX warp (two einsums
against tent weights) and the port's (two two-tap gathers), on the CPU.

Tolerance: the identity warp samples at integer positions, where one tap
has weight 1 and the other 0, so the canvases are bit-equal. Under
rotation and scale both sums are the same two products, but XLA's dot may
fuse the second product into its add (one rounding, not two): the f32 sums
then differ by an ULP, and where one lands on an integer the ``floor`` of
the uint8 truncation moves that pixel by one grey level. Held: at most 1
grey level anywhere, on at most 0.1% of the pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcut_tpu.constants import MEAN_BGR
from deepcut_tpu.pose.augment import affine_about, device_warp_coef
from deepcut_tpu.pose import augment_device as JA
from deepcut_tpu_torch.pose import augment_device as TA


def _image(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(yy / 17) * np.cos(xx / 23),
                    128 + 90 * np.cos(yy / 11 + 1) * np.sin(xx / 31),
                    128 + 80 * np.sin((yy + xx) / 29)], -1)
    img = img + rng.randint(-20, 21, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _batch(rng, warps, h=200, w=260, ih=256, iw=320):
    """A raw batch as PoseDataSource(augment_device=True) collates it."""
    rbh, rbw = (h + 63) // 64 * 64, (w + 63) // 64 * 64
    raws, coefs, nhws = [], [], []
    for angle, ascale, scale in warps:
        M = affine_about((w / 2, h / 2), angle, ascale)
        coef, nhw = device_warp_coef(M, scale, h, w)
        rb = np.empty((rbh, rbw, 3), np.uint8)
        rb[:] = np.asarray(MEAN_BGR, np.uint8)
        rb[:h, :w] = _image(rng, h, w)
        raws.append(rb)
        coefs.append(coef)
        sh = min(ih, int(np.ceil(h * scale / 8)) * 8)
        sw = min(iw, int(np.ceil(w * scale / 8)) * 8)
        nhws.append(np.concatenate([nhw, [sh, sw]]).astype(np.float32))
    return {"image_raw": np.stack(raws), "aug_coef": np.stack(coefs),
            "aug_nhw": np.stack(nhws), "aug_canvas": np.zeros((len(warps), ih, iw, 0), np.uint8),
            "anno_scale": np.ones(len(warps), np.float32)}


def _both(batch):
    ref = jax.jit(JA.warp_batch)({k: jnp.asarray(v) for k, v in batch.items()})
    got = TA.warp_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(ref) == {"image", "anno_scale"}
    assert got["image"].is_contiguous(memory_format=torch.channels_last)
    return got["image"].permute(0, 2, 3, 1).numpy(), np.asarray(ref["image"])


def test_identity_warp_bit_equal():
    batch = _batch(np.random.RandomState(0), [(0.0, 1.0, 1.0), (0.0, 1.0, 1.0)])
    got, ref = _both(batch)
    assert got.shape == ref.shape == (2, 256, 320, 3)
    assert np.array_equal(got, ref)
    assert (got[:, 200 + 64:] == 0).all()       # beyond the 64-px band: mean (0)


@pytest.mark.parametrize("warps", [
    [(12.0, 1.07, 0.9), (-15.0, 0.9, 1.13)],
    [(7.5, 1.0, 1.0), (0.0, 1.0, 0.8), (3.0, 1.2, 1.0)],
], ids=["rotate_scale", "mixed"])
def test_rotation_scale_within_one_grey_level(warps):
    got, ref = _both(_batch(np.random.RandomState(1), warps))
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


def test_canvas_height_not_multiple_of_16_raises():
    batch = _batch(np.random.RandomState(2), [(0.0, 1.0, 1.0)], ih=248)
    with pytest.raises(ValueError, match="multiple of 16"):
        TA.warp_batch({k: torch.from_numpy(v) for k, v in batch.items()})


def test_batch_without_raw_passes_through():
    batch = {"image": torch.zeros(1, 3, 16, 16)}
    assert TA.warp_batch(batch)["image"] is batch["image"]
