"""Port decode (`deepcut_tpu_torch.pose.decode`, the plain version of the CUDA
kernel) against the JAX package's XLA decode and its Pallas kernel (run in
interpret mode, as tests/test_pallas_decode.py runs it on the CPU).

Tolerance: none. Both sides compute the argmax over the same f32 values and
the pose with the same f32 operations in the same order, so indices,
confidences and poses are compared bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepcut_tpu.ops.pallas_decode import decode_pose_pallas
from deepcut_tpu.pose.decode import decode_pose as jax_decode
from deepcut_tpu_torch.ops import cuda_decode
from deepcut_tpu_torch.pose.decode import decode_pose, decode_pose_batch


def _nchw(a: np.ndarray) -> torch.Tensor:
    """(N, h, w, C) numpy -> contiguous (N, C, h, w) tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _maps(rng, n, h, w, J, ties=False):
    sm = rng.rand(n, h, w, J).astype(np.float32)
    if ties:  # few distinct values -> many equal maxima per joint
        sm = np.round(sm * 4).astype(np.float32) / 4
    loc = rng.randn(n, h, w, 2 * J).astype(np.float32)
    return sm, loc


@pytest.mark.parametrize("n,h,w,ties", [(1, 12, 9, False), (3, 87, 87, False),
                                        (2, 86, 86, True), (1, 250, 188, True)])
@pytest.mark.parametrize("scale", [1.0, 0.75, 1.3])
def test_decode_batch_matches_jax_with_masks(n, h, w, ties, scale):
    rng = np.random.RandomState(h * w + n)
    J = 14
    sm, loc = _maps(rng, n, h, w, J, ties)
    vh = rng.randint(1, h + 1, n).astype(np.int32)
    vw = rng.randint(1, w + 1, n).astype(np.int32)
    vh[0], vw[0] = h, w  # one unmasked image
    got = decode_pose_batch(_nchw(sm), _nchw(loc), scale=scale,
                            valid_hw=(torch.from_numpy(vh), torch.from_numpy(vw))).numpy()
    assert got.shape == (n, 5, J) and got.dtype == np.float32
    for i in range(n):
        ref = np.asarray(jax_decode(jnp.asarray(sm[i]), jnp.asarray(loc[i]), scale=scale,
                                    valid_hw=(jnp.int32(vh[i]), jnp.int32(vw[i]))))
        np.testing.assert_array_equal(got[i], ref)


@pytest.mark.parametrize("h,w", [(12, 9), (87, 87), (250, 188)])
def test_decode_matches_pallas_kernel(h, w):
    """The TPU kernel itself (interpret mode) against the port's plain decode."""
    rng = np.random.RandomState(h + w)
    sm, loc = _maps(rng, 1, h, w, 14, ties=True)
    ref = np.asarray(decode_pose_pallas(jnp.asarray(sm[0]), jnp.asarray(loc[0]),
                                        scale=1.3, interpret=True))
    got = decode_pose(_nchw(sm)[0], _nchw(loc)[0], scale=1.3).numpy()
    np.testing.assert_array_equal(got, ref)


def test_decode_ties_nan_and_fully_masked():
    J, h, w = 4, 16, 16
    sm = np.zeros((1, h, w, J), np.float32)
    sm[0, 3, 3, 0] = sm[0, 10, 10, 0] = 5.0           # tie: earlier position wins
    sm[0, 6, 1, 1] = np.nan
    sm[0, 5, 2, 1] = np.nan                           # first NaN wins, over +inf too
    sm[0, 0, 0, 1] = np.inf
    sm[0, 15, 15, 2] = 9.0                            # masked out below
    sm[0, 1, 1, 2] = 1.0
    loc = np.random.RandomState(0).randn(1, h, w, 2 * J).astype(np.float32)
    vh, vw = np.int32(8), np.int32(12)
    got = decode_pose_batch(_nchw(sm), _nchw(loc),
                            valid_hw=(torch.tensor([vh]), torch.tensor([vw]))).numpy()[0]
    ref = np.asarray(jax_decode(jnp.asarray(sm[0]), jnp.asarray(loc[0]),
                                valid_hw=(jnp.int32(vh), jnp.int32(vw))))
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] == 3 * 8 + 4 + np.float32(loc[0, 3, 3, 0]) * np.float32(7.2801098892805181)
    assert np.isnan(got[2, 1]) and got[0, 1] == 2 * 8 + 4 + np.float32(loc[0, 5, 2, 2]) * np.float32(7.2801098892805181)
    assert got[2, 2] == 1.0
    # every cell masked: all -inf, the argmax is the first cell as in jnp.argmax
    zero = torch.zeros(1, dtype=torch.int32)
    got0 = decode_pose_batch(_nchw(sm), _nchw(loc), valid_hw=(zero, zero)).numpy()[0]
    ref0 = np.asarray(jax_decode(jnp.asarray(sm[0]), jnp.asarray(loc[0]),
                                 valid_hw=(jnp.int32(0), jnp.int32(0))))
    np.testing.assert_array_equal(got0, ref0)


def test_wrapper_takes_plain_path_on_cpu_tensors():
    rng = np.random.RandomState(5)
    sm, loc = _maps(rng, 3, 20, 24, 14, ties=True)
    vh = torch.tensor([20, 11, 7], dtype=torch.int32)
    vw = torch.tensor([24, 24, 5], dtype=torch.int32)
    before = cuda_decode.prob_launches
    got = cuda_decode.decode_pose(_nchw(sm), _nchw(loc), vh, vw, 0.75)
    ref = decode_pose_batch(_nchw(sm), _nchw(loc), scale=0.75, valid_hw=(vh, vw))
    assert torch.equal(got, ref)
    assert cuda_decode.prob_launches == before == 0


def test_wrapper_rejects_devices_without_kernel():
    prob = torch.empty((1, 14, 8, 8), device="meta")
    loc = torch.empty((1, 28, 8, 8), device="meta")
    v = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_decode.decode_pose(prob, loc, v, v, 1.0)


def test_build_needs_nvcc_and_is_keyed_by_source(monkeypatch, tmp_path):
    import dataclasses

    import torch.utils.cpp_extension as cpp
    from deepcut_tpu_torch import native
    from deepcut_tpu_torch.ops import conv_epilogue

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.nvcc_path()
    lib = cuda_decode.LIB.path()
    assert lib.parent == native.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "deepcut_tpu_torch")
    assert lib.name.startswith("libdecode_pose-") and conv_epilogue.LIB.path() != lib
    flagged = dataclasses.replace(cuda_decode.LIB, flags=native.NVCC_FLAGS + ("-lineinfo",))
    assert flagged.path() != lib
    src = tmp_path / "k.cu"
    src.write_text("// a kernel source never built\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.build(native.NativeLib(src))
    assert not native.NativeLib(src).path().exists()


def test_fused_plain_matches_jax_forward_and_decode():
    """The serving decode end to end on the CPU: the port's folded bf16
    heads map through `decode_fused` (its plain version) against the JAX
    package's folded bf16 forward and `decode_pose`, per image with its own
    valid cell grid. Argmax cells, x, y and offsets equal; the confidence is
    each framework's own f32 sigmoid of equal logits, within 4 ulp (see
    test_torch_resnet.py's bf16 forward test)."""
    import jax

    from deepcut_tpu.models import resnet as jr
    from deepcut_tpu_torch.models import resnet as tr
    from deepcut_tpu_torch.models.convert import params_from_numpy
    from test_torch_resnet import TINY_KW, tame_params

    kw = dict(TINY_KW, num_joints=5)
    jcfg, tcfg = jr.DeeperCutConfig(**kw), tr.DeeperCutConfig(**kw)
    params = tame_params(jcfg, seed=6)
    x = (np.random.RandomState(8).rand(3, 48, 64, 3) * 255 - 128).astype(np.float32)
    heads = ("pose", "locref")
    ref = jax.jit(jr.forward, static_argnums=(2,), static_argnames=("folded", "heads"))(
        jr.cast_params(jr.fold_bn(params, jcfg)), jnp.asarray(x), jcfg, folded=True, heads=heads)
    model = tr.DeeperCut(tr.cast_params(tr.fold_bn(params_from_numpy(params), tcfg)), tcfg)
    with torch.inference_mode():
        fused = model.fused_heads(torch.from_numpy(x).permute(0, 3, 1, 2), heads=heads)
    assert fused.shape == (3, 15, 6, 8)
    valid = [(6, 8), (4, 8), (6, 3)]
    got = cuda_decode.decode_fused(fused, 5, [v[0] for v in valid], [v[1] for v in valid], 0.75)
    for i, (vh, vw) in enumerate(valid):
        want = np.asarray(jax_decode(ref["prob"][i], ref["loc_pred"][i], scale=0.75,
                                     valid_hw=(jnp.int32(vh), jnp.int32(vw))))
        g = got[i].numpy()
        np.testing.assert_array_equal(g[[0, 1, 3, 4]], want[[0, 1, 3, 4]])
        np.testing.assert_array_max_ulp(g[2], want[2], maxulp=4)


@pytest.mark.parametrize("extra", [0, 7])
def test_fused_plain_is_the_decode_of_the_sliced_maps(extra):
    """`decode_fused` reads logits then locref from the unsliced map (any
    channels after 3J are ignored): its value is `decode_pose_batch` over
    their sigmoid and locref, ties and NaN included."""
    rng = np.random.RandomState(9 + extra)
    J, n, h, w = 14, 2, 11, 13
    logits = np.round(rng.randn(n, h, w, J) * 2).astype(np.float32)   # many ties
    logits[0, 3, 4, 2] = np.nan
    fused = _nchw(np.concatenate([logits, rng.randn(n, h, w, 2 * J + extra).astype(np.float32)], -1))
    fused = fused.contiguous(memory_format=torch.channels_last)
    got = cuda_decode.decode_fused(fused, J, [11, 6], [13, 4], 1.3)
    want = decode_pose_batch(torch.sigmoid(fused[:, :J]), fused[:, J:3 * J], scale=1.3,
                             valid_hw=(torch.tensor([11, 6]), torch.tensor([13, 4])))
    assert torch.equal(got[:, [0, 1, 3, 4]], want[:, [0, 1, 3, 4]])
    assert torch.equal(torch.isnan(got[:, 2]), torch.isnan(want[:, 2]))
    assert cuda_decode.launches == 0


def test_fused_wrapper_rejects_devices_without_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        cuda_decode.decode_fused(torch.empty((1, 42, 8, 8), device="meta"), 14, [8], [8])
