"""Port ops (`deepcut_tpu_torch.ops`, NCHW) against `deepcut_tpu.ops` (NHWC)
on the same numpy inputs, both in f32 on the CPU.

Tolerances: convolutions sum the same products in another order (oneDNN
against XLA's CPU conv), so they agree to f32 rounding of sums of O(100)
terms: rtol 1e-5 / atol 1e-5 on O(1) values. Pooling, cropping and the
per-channel affine compute the same operations element by element and are
compared exactly or to one f32 rounding.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepcut_tpu.ops import conv as jconv, eltwise as jelt, norm as jnorm, pool as jpool
from deepcut_tpu_torch.models.convert import params_from_numpy
from deepcut_tpu_torch.ops import conv as tconv, eltwise as telt, norm as tnorm, pool as tpool
from deepcut_tpu_torch.ops.activations import relu, sigmoid

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("k,stride,pad,dilation,groups,hw", [
    (7, 2, 3, 1, 1, (23, 30)),    # the stem
    (1, 2, 0, 1, 1, (15, 15)),    # strided 1x1 branch2a / branch1
    (3, 1, 2, 2, 1, (11, 9)),     # res5's dilated 3x3
    (3, 1, 1, 1, 2, (10, 12)),    # groups
    (5, 3, 1, 2, 4, (17, 13)),    # everything at once
])
def test_conv2d_matches_jax(k, stride, pad, dilation, groups, hw):
    rng = np.random.RandomState(k * 7 + groups)
    cin, cout = 8, 12
    x = rng.randn(2, *hw, cin).astype(np.float32)
    w = rng.randn(k, k, cin // groups, cout).astype(np.float32) * 0.2
    b = rng.randn(cout).astype(np.float32)
    ref = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  stride=stride, pad=pad, dilation=dilation,
                                  groups=groups, compute_dtype=None))
    wt = params_from_numpy({"c": {"w": w}})["c"]["w"]  # HWIO -> OIHW
    got = tconv.conv2d(_nchw(x), wt, torch.from_numpy(b), stride=stride, pad=pad,
                       dilation=dilation, groups=groups, compute_dtype=None)
    assert got.shape[2:] == (tconv.conv_output_size(hw[0], k, stride, pad, dilation),
                             tconv.conv_output_size(hw[1], k, stride, pad, dilation))
    np.testing.assert_allclose(_nhwc(got), ref, **TOL)


@pytest.mark.parametrize("k,stride,pad,dilation,groups", [
    (3, 2, 0, 1, 1),    # the DeeperCut head (res5c_up_*)
    (4, 2, 1, 1, 1),
    (3, 2, 1, 2, 1),
    (3, 2, 0, 1, 2),
])
def test_deconv2d_matches_jax_through_converter(k, stride, pad, dilation, groups):
    """The native (kh, kw, Cin, Cout/g) deconv weight goes through
    params_from_numpy under a deconv layer name: transposed, not flipped."""
    rng = np.random.RandomState(k + stride + pad + dilation + groups)
    cin, cout = 6, 4
    x = rng.randn(2, 5, 7, cin).astype(np.float32)
    w = rng.randn(k, k, cin, cout // groups).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    ref = np.asarray(jconv.deconv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    stride=stride, pad=pad, dilation=dilation,
                                    groups=groups, compute_dtype=None))
    wt = params_from_numpy({"res5c_up_pose": {"w": w}})["res5c_up_pose"]["w"]
    assert tuple(wt.shape) == (cin, cout // groups, k, k)
    got = tconv.deconv2d(_nchw(x), wt, torch.from_numpy(b), stride=stride, pad=pad,
                         dilation=dilation, groups=groups, compute_dtype=None)
    assert got.shape[2] == tconv.deconv_output_size(5, k, stride, pad, dilation)
    np.testing.assert_allclose(_nhwc(got), ref, **TOL)


@pytest.mark.parametrize("k,stride,pad", [(3, 2, 0), (3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_ceil_max_pool_matches_jax_over_sizes(k, stride, pad):
    rng = np.random.RandomState(k + stride + pad)
    for size in range(max(k, 3), 40, 3):
        x = rng.randn(1, size, size + 3, 2).astype(np.float32)
        ref = np.asarray(jpool.max_pool2d(jnp.asarray(x), kernel=k, stride=stride, pad=pad))
        got = _nhwc(tpool.max_pool2d(_nchw(x), kernel=k, stride=stride, pad=pad))
        assert got.shape[1] == tpool.pool_output_size(size, k, stride, pad)
        np.testing.assert_array_equal(got, ref)


def test_pool_output_size_matches_jax_and_stem():
    assert tpool.pool_output_size(344, 3, 2, 0) == 172  # the DeeperCut stem
    for size in range(3, 800):
        assert tpool.pool_output_size(size, 3, 2, 0) == jpool.pool_output_size(size, 3, 2, 0)


def test_pool_rejects_geometry_torch_would_shrink():
    """stride > kernel with pad 0: Caffe keeps the last window, ceil-mode
    torch drops it — raise rather than return the wrong size."""
    with pytest.raises(ValueError, match="Caffe geometry"):
        tpool.max_pool2d(torch.zeros(1, 1, 4, 4), kernel=1, stride=2)


@pytest.mark.parametrize("sf", [None, 0.999, 0.0])
def test_bn_ops_match_jax(sf):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    mean = rng.randn(8).astype(np.float32)
    var = (1 + rng.rand(8)).astype(np.float32)
    gamma = rng.randn(8).astype(np.float32)
    beta = rng.randn(8).astype(np.float32)
    sfj = None if sf is None else jnp.full((1,), sf, jnp.float32)
    sft = None if sf is None else torch.full((1,), sf)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    ref = np.asarray(jnorm.bn_scale_affine(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(var),
                                           sfj, jnp.asarray(gamma), jnp.asarray(beta)))
    got = _nhwc(tnorm.bn_scale_affine(_nchw(x), t(mean), t(var), sft, t(gamma), t(beta)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    ref = np.asarray(jnorm.batch_norm_inference(jnp.asarray(x), jnp.asarray(mean),
                                                jnp.asarray(var), sfj))
    got = _nhwc(tnorm.batch_norm_inference(_nchw(x), t(mean), t(var), sft))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_crop_like_top_left_and_activations():
    rng = np.random.RandomState(8)
    x = rng.randn(2, 9, 11, 3).astype(np.float32)
    ref = np.asarray(jelt.crop_like(jnp.asarray(x), (2, 8, 8, 3), axis=1))
    got = _nhwc(telt.crop_like(_nchw(x), (2, 3, 8, 8), axis=2))
    np.testing.assert_array_equal(got, ref)
    from deepcut_tpu.ops.activations import relu as jrelu, sigmoid as jsigmoid
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(relu(t).numpy(), np.asarray(jrelu(jnp.asarray(x))))
    np.testing.assert_allclose(sigmoid(t).numpy(), np.asarray(jsigmoid(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
