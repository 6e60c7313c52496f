"""The serving conv's epilogue (`deepcut_tpu_torch.ops.conv_epilogue`, the
plain version of `csrc/conv_epilogue.cu`) and the rounded convs around it
(`ops.conv.conv2d_rounded` / `deconv2d_rounded`) against the JAX package.

Tolerance: none. The epilogue repeats the JAX op sequence, ``(y +
b).astype(bf16)``, the residual add in bf16 and ReLU, on the same f32
inputs, so it is compared bit for bit, planted round-half-to-even ties
included. The rounded convs take bf16-valued operands: every product is
exact and the f32 sums of these small convs agree with XLA's, so the bf16
results are compared bit for bit too.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepcut_tpu.ops import conv as jconv
from deepcut_tpu.ops.activations import relu as jrelu
from deepcut_tpu.ops.eltwise import crop_like as jcrop
from deepcut_tpu_torch.ops import conv_epilogue as ce
from deepcut_tpu_torch.ops.conv import conv2d_rounded, deconv2d_rounded, exact_conv
from deepcut_tpu_torch.ops.eltwise import crop_like


def _bf16(a: np.ndarray) -> np.ndarray:
    """numpy f32 -> the nearest bf16 values, as f32."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _t(a_nhwc: np.ndarray) -> torch.Tensor:
    """(N, H, W, C) numpy -> (N, C, H, W) tensor in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a_nhwc)).permute(0, 3, 1, 2)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _epilogue_inputs(rng, n=2, h=5, w=7, c=12):
    y = (rng.randn(n, h, w, c) * 4).astype(np.float32)
    # exact ties between two bf16 neighbours (round half to even), zeros and
    # a NaN, so the rounding and ReLU edge cases are exercised
    y.reshape(-1)[:6] = [1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8), 0.0, -0.0, np.nan]
    b = (rng.randn(c) * 0.5).astype(np.float32)
    b[:6] = 0.0
    return y, b


@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
@pytest.mark.parametrize("residual", [None, "dense", "strided"])
@pytest.mark.parametrize("c", [12, 42])
def test_epilogue_plain_matches_jax_sequence(residual, relu, c):
    rng = np.random.RandomState(c + 3 * relu)
    y, b = _epilogue_inputs(rng, c=c)
    n, h, w, _ = y.shape
    ref = (jnp.asarray(y) + jnp.asarray(b)).astype(jnp.bfloat16)
    res_t = None
    if residual is not None:
        big = _bf16(rng.randn(n, h + 3, w + 2, c).astype(np.float32) * 3)
        r = big[:, :h, :w] if residual == "strided" else np.ascontiguousarray(big[:, :h, :w])
        ref = jcrop(jnp.asarray(big).astype(jnp.bfloat16), ref.shape, axis=1) + ref \
            if residual == "strided" else jnp.asarray(r).astype(jnp.bfloat16) + ref
        res_t = crop_like(_t(big), (n, c, h, w)) if residual == "strided" else _t(r)
        assert res_t.stride(1) == 1
    if relu:
        ref = jrelu(ref)
    ref = np.asarray(ref.astype(jnp.float32))
    before = ce.launches
    got = ce.conv_epilogue(_t(y), torch.from_numpy(b), res_t, relu)
    assert ce.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), ref)


def test_epilogue_without_bias_only_rounds():
    y, _ = _epilogue_inputs(np.random.RandomState(1))
    got = ce.conv_epilogue_plain(_t(y), None)
    np.testing.assert_array_equal(_np(got), _bf16(y))


CONV_CASES = {  # (kh, stride, pad, dilation, cin, cout): the trunk's conv kinds
    "1x1": (1, 1, 0, 1, 16, 24),
    "1x1_s2": (1, 2, 0, 1, 16, 32),
    "3x3": (3, 1, 1, 1, 8, 8),
    "3x3_dil2": (3, 1, 2, 2, 8, 12),
    "7x7_s2_stem": (7, 2, 3, 1, 3, 16),
}


@pytest.mark.parametrize("name", list(CONV_CASES))
@pytest.mark.parametrize("block_end", [False, True], ids=["cbr", "residual_relu"])
def test_rounded_conv_matches_jax_bf16_conv(name, block_end):
    k, s, p, d, cin, cout = CONV_CASES[name]
    rng = np.random.RandomState(len(name) + 7 * block_end)
    x = _bf16(rng.randn(2, 13, 11, cin).astype(np.float32) * 3)
    w = _bf16(rng.randn(k, k, cin, cout).astype(np.float32) * (2.0 / (k * k * cin)) ** 0.5)
    b = (rng.randn(cout) * 0.3).astype(np.float32)
    y = jconv.conv2d(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
                     stride=s, pad=p, dilation=d, compute_dtype=jnp.bfloat16)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    if block_end:
        short = _bf16(rng.randn(*y.shape).astype(np.float32) * 2)
        ref = jrelu(jnp.asarray(short).astype(jnp.bfloat16) + y)
        got = conv2d_rounded(_t(x), wt, torch.from_numpy(b), stride=s, pad=p, dilation=d,
                             residual=_t(short), relu=True)
    else:
        ref = jrelu(y)
        got = conv2d_rounded(_t(x), wt, torch.from_numpy(b), stride=s, pad=p, dilation=d,
                             relu=True)
    np.testing.assert_array_equal(_np(got), np.asarray(ref.astype(jnp.float32)))


def test_rounded_heads_match_jax_deconv_crop_add():
    """The heads: the k3 s2 deconv over res5c rounded after its bias, then
    the 1x1 skip conv whose epilogue adds the cropped deconv output (JAX:
    crop_like(up) + sk, both bf16)."""
    rng = np.random.RandomState(11)
    cin, cskip, ch = 16, 8, 9
    res5c = _bf16(rng.randn(1, 5, 6, cin).astype(np.float32))
    skip = _bf16(rng.randn(1, 10, 12, cskip).astype(np.float32))
    wup = _bf16(rng.randn(3, 3, cin, ch).astype(np.float32) * 0.2)
    wsk = _bf16(rng.randn(1, 1, cskip, ch).astype(np.float32) * 0.3)
    bup, bsk = (rng.randn(ch).astype(np.float32) for _ in range(2))
    up = jconv.deconv2d(jnp.asarray(res5c).astype(jnp.bfloat16), jnp.asarray(wup),
                        jnp.asarray(bup), stride=2, compute_dtype=jnp.bfloat16)
    sk = jconv.conv2d(jnp.asarray(skip).astype(jnp.bfloat16), jnp.asarray(wsk),
                      jnp.asarray(bsk), compute_dtype=jnp.bfloat16)
    ref = np.asarray((jcrop(up, sk.shape, axis=1) + sk).astype(jnp.float32))
    t_up = deconv2d_rounded(_t(res5c), torch.from_numpy(np.ascontiguousarray(wup.transpose(2, 3, 0, 1))),
                            torch.from_numpy(bup), stride=2)
    np.testing.assert_array_equal(_np(t_up), np.asarray(up.astype(jnp.float32)))
    fused = conv2d_rounded(_t(skip), torch.from_numpy(np.ascontiguousarray(wsk.transpose(3, 2, 0, 1))),
                           torch.from_numpy(bsk), residual=crop_like(t_up, (1, ch, 10, 12)))
    np.testing.assert_array_equal(_np(fused), ref)


def test_exact_conv_widens_bf16_weights_and_rejects_bf16_input():
    rng = np.random.RandomState(2)
    x = _t(_bf16(rng.randn(1, 6, 6, 4).astype(np.float32)))
    w = torch.from_numpy(rng.randn(5, 4, 3, 3).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(exact_conv(x, w, pad=1), exact_conv(x, w.float(), pad=1))
    with pytest.raises(TypeError, match="bf16 values"):
        exact_conv(x.to(torch.bfloat16), w, pad=1)


def test_epilogue_wrapper_rejects_devices_without_kernel():
    y = torch.empty((1, 8, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ce.conv_epilogue(y, torch.empty((8,), device="meta"))
