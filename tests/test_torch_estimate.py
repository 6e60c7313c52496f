"""Port `PoseEstimator(device="cpu")` against the JAX `PoseEstimator`, both
with the same numpy params (carried across by `params_from_numpy`), the same
uint8 frames, and the unfolded f32 forward.

Tolerances, with their reasons:
- preprocess: exact at scale 1 (pad, mean and paste only). At scale != 1
  the two interpolation products sum in another order, so a value within
  an f32 rounding of a .5 boundary can round to the other grey level: at
  most 1 grey level, on under 1% of the pixels (0.4% seen at scale 1.3).
- poses: the maps agree to f32 rounding of the convs' sums (rtol 1e-4 in
  test_torch_resnet.py) and the argmax cells agree exactly, so x, y and the
  offsets agree to 1e-3 px and the confidence to 1e-5. Across a resize a
  flipped grey level moves the maps by more (about 1e-3 relative), which
  moves the pose by under 0.05 px but not its argmax cell.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepcut_tpu.models import resnet as jr
from deepcut_tpu.pose import estimate as je
from deepcut_tpu_torch.models import resnet as tr
from deepcut_tpu_torch.models.convert import params_from_numpy
from deepcut_tpu_torch.pose import estimate as te
from test_torch_resnet import tame_params

KW = dict(depths=(1, 1, 1, 1), stage_widths=(4, 4, 8, 8), num_joints=3)
JCFG = jr.DeeperCutConfig(compute_dtype=jnp.float32, **KW)
TCFG = tr.DeeperCutConfig(compute_dtype=torch.float32, **KW)
POSE_TOL = dict(rtol=1e-5, atol=1e-3)
RESIZE_POSE_TOL = dict(rtol=1e-4, atol=5e-2)


def _params():
    """JAX-layout numpy params, tamed so that the scoremaps are not saturated."""
    return tame_params(JCFG)


def _pair(max_size=te.MAX_SIZE, params=None):
    params = _params() if params is None else params
    jax_est = je.PoseEstimator(jax.tree_util.tree_map(jnp.asarray, params), JCFG,
                               folded=False, max_size=max_size)
    port = te.PoseEstimator(params_from_numpy(params), TCFG, folded=False,
                            max_size=max_size, device="cpu")
    return jax_est, port


def _frame(seed, h, w):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


def test_numpy_helpers_match_jax():
    for dim in (1, 7, 8, 100, 479, 480, 688, 1280):
        for scale in (0.75, 1.0, 1.3):
            assert te.canvas_size(dim, scale) == je.canvas_size(dim, scale)
        assert te._bucket(dim) == je._bucket(dim)
    for n_in, n_out in ((164, 123), (164, 164), (100, 213), (752, 564)):
        np.testing.assert_array_equal(te._bilinear_matrix(n_in, n_out),
                                      je._bilinear_matrix(n_in, n_out))


@pytest.mark.parametrize("max_size", [700, 512, 500])
def test_tile_plan_matches_jax_over_sizes(max_size):
    for length in list(range(1, 3001, 37)) + [700, 701, 720, 1064, 1280, 2048]:
        assert te._tile_plan(length, max_size) == je._tile_plan(length, max_size), length
        assert te._num_tiles(length, max_size, te.RF) == je._num_tiles(length, max_size, je.RF)


@pytest.mark.parametrize("scale", [1.0, 0.8, 1.3])
def test_preprocess_on_device_matches_jax(scale):
    img = _frame(3, 96, 72)
    oh, ow = int((96 + te.PAD_SIZE) * scale), int((72 + te.PAD_SIZE) * scale)
    ch, cw = te.canvas_size(96, scale), te.canvas_size(72, scale)
    ref = np.asarray(je.preprocess_on_device(jnp.asarray(img), oh, ow, ch + 16, cw))
    got = te.preprocess_on_device(torch.from_numpy(img), oh, ow, ch + 16, cw).numpy()
    assert got.shape == ref.shape
    if scale == 1.0:
        np.testing.assert_array_equal(got, ref)
    else:
        diff = np.abs(got - ref)
        assert diff.max() <= 1.0
        assert np.mean(diff > 0) < 0.01, np.mean(diff > 0)


@pytest.mark.parametrize("scales", [[1.0], [0.75], [0.75, 1.0]])
def test_estimate_pose_matches_jax(scales):
    jax_est, port = _pair()
    img = _frame(0, 100, 140)
    ref = jax_est.estimate_pose(img, scales)
    got = port.estimate_pose(img, scales)
    assert got.shape == ref.shape == (5, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **(POSE_TOL if scales == [1.0] else RESIZE_POSE_TOL))


def test_estimate_pose_none_when_no_scale_is_confident():
    params = _params()
    params["res5c_up_pose"]["b"][:] = -1e4  # sigmoid -> exactly 0
    jax_est, port = _pair(params=params)
    img = _frame(1, 60, 44)
    assert jax_est.estimate_pose(img) is None
    assert port.estimate_pose(img) is None


def test_batch_and_many_match_jax():
    jax_est, port = _pair(max_size=512)
    frames = [_frame(10 + i, 60, 44) for i in range(3)]
    np.testing.assert_allclose(port.estimate_pose_batch(frames),
                               jax_est.estimate_pose_batch(frames), **POSE_TOL)
    # mixed buckets, two frames sharing one, and an HD frame on the tiled path
    mixed = [_frame(20, 100, 140), _frame(21, 60, 44), _frame(22, 90, 120),
             _frame(23, 330, 620), _frame(24, 96, 130)]
    ref = jax_est.estimate_pose_many(mixed)
    got = port.estimate_pose_many(mixed)
    assert got.shape == (5, 5, 3)
    np.testing.assert_allclose(got, ref, **POSE_TOL)
    for i, im in enumerate(mixed):
        np.testing.assert_allclose(got[i], port.estimate_pose(im), **POSE_TOL)


def test_tiled_scoremaps_match_jax_and_full_frame():
    jax_est, port = _pair(max_size=512)
    img = _frame(4, 330, 620)  # canvas 336 x 624: three 512-wide tiles
    sm_ref, loc_ref = jax_est.scoremaps(img)
    sm, loc = port.scoremaps(img)
    assert sm.shape == sm_ref.shape == (42, 78, 3) and loc.shape == loc_ref.shape
    np.testing.assert_allclose(sm, sm_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loc, loc_ref, rtol=1e-4, atol=1e-4)
    # the tiny model's receptive field is far inside the 224 px trim, so the
    # tiles reproduce the full-frame maps
    full = te.PoseEstimator(params_from_numpy(_params()), TCFG, folded=False,
                            max_size=4000, device="cpu")
    sm_full, loc_full = full.scoremaps(img)
    np.testing.assert_allclose(sm, sm_full, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(loc, loc_full, rtol=5e-4, atol=5e-4)


def test_estimate_pose_avg_matches_jax():
    jax_est, port = _pair()
    img = _frame(3, 96, 128)
    np.testing.assert_allclose(port.estimate_pose_avg(img, [0.75, 1.0]),
                               jax_est.estimate_pose_avg(img, [0.75, 1.0]), **RESIZE_POSE_TOL)


# -- int8 serving (tests/test_estimate.py:209-233) ----------------------------
KW8 = dict(depths=(1, 1, 1, 1), stage_widths=(8, 8, 16, 16), num_joints=3)


def _int8_pair():
    """Both packages' folded bf16 estimators on the same tamed params."""
    jcfg, tcfg = jr.DeeperCutConfig(**KW8), tr.DeeperCutConfig(**KW8)
    params = tame_params(jcfg, seed=5)
    for name in ("res5c_up_pose", "res3d_pose"):  # structured, unsaturated maps
        params[name]["w"] *= np.float32(10.0)
    jax_est = je.PoseEstimator(jax.tree_util.tree_map(jnp.asarray, params), jcfg)
    port = te.PoseEstimator(params_from_numpy(params), tcfg, device="cpu")
    return jax_est, port


def test_quantize_int8_matches_jax_estimator():
    """Calibration on the same frame gives the JAX estimator's scales (f32
    convs summed in another order: rtol 1e-5); on a shared quantization
    (the JAX package's, carried across) the int8 maps are bit-equal and the
    poses of every path agree as the float paths do."""
    from deepcut_tpu_torch.models.convert import qparams_from_numpy

    jax_est, port = _int8_pair()
    img = _frame(11, 100, 120)
    pose_fp = port.estimate_pose(img)
    sm_fp, _ = port.scoremaps(img)
    jax_est.quantize_int8(img)
    port.quantize_int8(img)
    assert port.is_int8 and jax_est.is_int8
    ref_scales = {k: float(v) for k, v in jax_est.params["s"].items()}
    assert set(port.model.act_scales) == set(ref_scales)
    for k, v in ref_scales.items():
        assert port.model.act_scales[k] == pytest.approx(v, rel=1e-5), k
    model = port.model
    port.quantize_int8(_frame(12, 60, 44))  # a second call does nothing
    assert port.model is model

    port.serve_int8(*qparams_from_numpy(jax.tree_util.tree_map(np.asarray, jax_est.params["q"]),
                                        jax.tree_util.tree_map(np.asarray, jax_est.params["s"])))
    sm_ref, loc_ref = jax_est.scoremaps(img)
    sm, loc = port.scoremaps(img)
    np.testing.assert_array_equal(loc, loc_ref)
    np.testing.assert_array_max_ulp(sm, sm_ref, maxulp=4)
    np.testing.assert_allclose(port.estimate_pose(img), jax_est.estimate_pose(img), **POSE_TOL)
    frames = [img, _frame(13, 100, 120)]
    np.testing.assert_allclose(port.estimate_pose_batch(frames),
                               jax_est.estimate_pose_batch(frames), **POSE_TOL)
    # close to the float path, as tests/test_estimate.py holds the JAX one
    pose_q = port.estimate_pose(img)
    assert (np.abs(pose_q[:2] - pose_fp[:2]) / (np.abs(pose_fp[:2]) + 1.0) < 0.10).all()
    assert np.mean(np.abs(sm - sm_fp) > 0.25) < 0.05
    batch = port.estimate_pose_batch([img, img])
    np.testing.assert_allclose(batch[0], batch[1], rtol=1e-5)
