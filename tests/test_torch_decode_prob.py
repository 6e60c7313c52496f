"""The decode's probability-map entry (`ops.cuda_decode.decode_pose`), as
the estimator's `_decode_whole` calls it: strided views read in place, the
valid sizes as Python ints (or CPU tensors). On the CPU the wrapper runs its
plain version; here it is held against the same plain version on contiguous
copies, the JAX package's `decode_pose` and its Pallas kernel in interpret
mode (unmasked images), on the views the card's kernel takes.

Tolerance: none. Every side computes the argmax over the same f32 values
and the pose with the same f32 operations in the same order, so poses are
compared bit for bit (NaN where NaN).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepcut_tpu.ops.pallas_decode import decode_pose_pallas
from deepcut_tpu.pose.decode import decode_pose as jax_decode
from deepcut_tpu_torch import native
from deepcut_tpu_torch.ops import cuda_decode
from deepcut_tpu_torch.pose.decode import decode_pose_batch

J, H, W = 6, 13, 18
SCALES = (1.0, 0.75, 1.3)


def _maps(kind: str, rng, n: int):
    """(n, H, W, J) probabilities of a kind and (n, H, W, 2J) locref."""
    sm = rng.rand(n, H, W, J).astype(np.float32)
    if kind == "ties":      # few distinct values: many equal maxima per joint
        sm = np.round(sm * 4).astype(np.float32) / 4
    elif kind == "all-equal":
        sm = np.full_like(sm, 0.5)
    elif kind == "nan":     # the first NaN wins, over +inf and over later NaN
        sm[:, 7, 3, 1] = np.nan
        sm[:, 2, 15, 1] = np.nan
        sm[:, 0, 0, 1] = np.inf
        sm[:, 0, 0, 2] = np.nan
        sm[:, 12, 17, 3] = np.nan   # outside image 1's valid grid below
    loc = rng.randn(n, H, W, 2 * J).astype(np.float32)
    return sm, loc


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _granule(prob: torch.Tensor) -> int:
    """Floats per load that the view's width and strides allow (the launch
    then halves it until the base address is aligned)."""
    n, j, h, w = prob.shape
    return cuda_decode._plan(prob, torch.empty((n, 2 * j, h, w)))[0].granule


def _views(view: str, sm: np.ndarray, loc: np.ndarray, rng):
    """prob (n, J, H, W) and loc (n, 2J, H, W) as views of the given layout
    whose values are sm's and loc's."""
    prob, off = _nchw(sm), _nchw(loc)
    n = prob.shape[0]
    if view == "contiguous":
        return prob, off
    if view == "row-crop":          # the mesh's and scoremaps' prob[0, :, :gh]
        out = []
        for t in (prob, off):
            big = torch.from_numpy(rng.rand(n, t.shape[1], H + 5, W).astype(np.float32))
            big[:, :, :H] = t
            out.append(big[:, :, :H])
        return tuple(out)
    if view == "channel-slice":     # both maps sliced out of one larger map
        big = torch.from_numpy(rng.rand(n, 3 + 3 * J + 2, H, W).astype(np.float32))
        big[:, 3:3 + J] = prob
        big[:, 3 + J:3 + 3 * J] = off
        return big[:, 3:3 + J], big[:, 3 + J:3 + 3 * J]
    if view == "permuted":          # the pyramid's average: (rows, joints) swapped in memory
        return (prob.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3),
                off.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3))
    if view == "loc-noncontig":     # loc cut out of wider rows, prob contiguous
        big = torch.from_numpy(rng.rand(n, 2 * J, H, W + 3).astype(np.float32))
        big[..., 1:W + 1] = off
        return prob, big[..., 1:W + 1]
    raise ValueError(view)


VIEWS = ("contiguous", "row-crop", "channel-slice", "permuted", "loc-noncontig")


@pytest.mark.parametrize("sizes", ["ints", "tensors"])
@pytest.mark.parametrize("kind", ["random", "ties", "all-equal", "nan"])
@pytest.mark.parametrize("view", VIEWS)
def test_prob_entry_views_match_jax(view, kind, sizes):
    rng = np.random.RandomState(VIEWS.index(view) * 10 + len(kind))
    sm, loc = _maps(kind, rng, 2)
    prob, off = _views(view, sm, loc, rng)
    if view != "contiguous":
        assert not (prob.is_contiguous() and off.is_contiguous())
    cuda_decode._check(prob, off)             # a view the card's kernel reads in place
    assert _granule(prob) in (1, 2, 4)
    vh, vw = [H, 9], [W, 11]                  # image 0 whole, image 1 masked
    valid = (vh, vw) if sizes == "ints" else tuple(torch.tensor(v, dtype=torch.int32)
                                                   for v in (vh, vw))
    for scale in SCALES:
        got = cuda_decode.decode_pose(prob, off, *valid, scale).numpy()
        assert got.shape == (2, 5, J) and got.dtype == np.float32
        plain = decode_pose_batch(_nchw(sm), _nchw(loc), scale=scale,
                                  valid_hw=tuple(torch.tensor(v) for v in (vh, vw))).numpy()
        np.testing.assert_array_equal(got, plain)
        for i in range(2):
            ref = np.asarray(jax_decode(jnp.asarray(sm[i]), jnp.asarray(loc[i]), scale=scale,
                                        valid_hw=(jnp.int32(vh[i]), jnp.int32(vw[i]))))
            np.testing.assert_array_equal(got[i], ref)
        if kind != "nan":   # the TPU kernel's own max / argmax, on the unmasked image
            ref = np.asarray(decode_pose_pallas(jnp.asarray(sm[0]), jnp.asarray(loc[0]),
                                                scale=scale, interpret=True))
            np.testing.assert_array_equal(got[0], ref)
    assert cuda_decode.prob_launches == 0


@pytest.mark.parametrize("masked", [(0, W), (H, 0), (0, 0), (-3, 5)])
def test_prob_entry_fully_masked_plane(masked):
    """No valid cell: the argmax of all -inf is the first cell, conf -inf,
    the offsets gathered there (as jnp.argmax and the plain version)."""
    rng = np.random.RandomState(3)
    sm, loc = _maps("random", rng, 2)
    prob, off = _views("row-crop", sm, loc, rng)
    vh, vw = [masked[0], H], [masked[1], W]
    for scale in SCALES:
        got = cuda_decode.decode_pose(prob, off, vh, vw, scale).numpy()
        ref = np.asarray(jax_decode(jnp.asarray(sm[0]), jnp.asarray(loc[0]), scale=scale,
                                    valid_hw=(jnp.int32(vh[0]), jnp.int32(vw[0]))))
        np.testing.assert_array_equal(got[0], ref)
        assert np.all(got[0, 2] == -np.inf) and np.all(got[0, 0] == np.float32(
            (np.float32(4) + loc[0, 0, 0, 0::2] * np.float32(7.2801098892805181)) / np.float32(scale)))
        whole = np.asarray(jax_decode(jnp.asarray(sm[1]), jnp.asarray(loc[1]), scale=scale))
        np.testing.assert_array_equal(got[1], whole)


def test_prob_entry_sizes_and_geometries_on_the_cpu():
    """Sizes: one per image, ints or CPU tensors; a CPU call launches
    nothing and records no geometry."""
    rng = np.random.RandomState(4)
    sm, loc = _maps("ties", rng, 3)
    prob, off = _nchw(sm), _nchw(loc)
    native.record_geometries(True)
    try:
        a = cuda_decode.decode_pose(prob, off, [H, 5, 1], [W, 7, 2], 0.75)
        b = cuda_decode.decode_pose(prob, off, torch.tensor([H, 5, 1], dtype=torch.int32),
                                    torch.tensor([W, 7, 2], dtype=torch.int32), 0.75)
        assert torch.equal(a, b)
        assert native.geometries == {} and cuda_decode.prob_launches == 0
    finally:
        native.record_geometries(False)
    assert native.geometries is None
    assert cuda_decode._sizes("valid_h", torch.tensor([3, 4], dtype=torch.int32), 2) == [3, 4]
    with pytest.raises(ValueError, match="3 valid_h sizes for 2 images"):
        cuda_decode._sizes("valid_h", [1, 2, 3], 2)
    with pytest.raises(ValueError, match="ints or a CPU tensor"):
        cuda_decode._sizes("valid_w", torch.empty((2,), dtype=torch.int32, device="meta"), 2)


def test_prob_entry_load_width_follows_the_view():
    """16-byte loads where the width and strides allow, 8 or 4 else."""
    base = torch.zeros(2, J, 90, 160)
    assert _granule(base) == 4                                   # the tiled HD maps
    assert _granule(torch.zeros(1, J, 86, 86)[:, :, :43]) == 2   # 688 row crop
    assert _granule(torch.zeros(1, J, 9, 15)) == 1               # odd width
    assert _granule(base[:, :, :, 1:157]) == 4                   # a column crop: width 156
    assert _granule(base[:, :, :, 2:160]) == 2                   # width 158
    assert _granule(torch.zeros(2, J, 90, 162)[:, :, :, :160]) == 2   # row stride 162
    assert _granule(base[:1, :1, :1]) == 4                       # size-1 dims: strides ignored
    big = torch.zeros(2, 14, 90, 160)
    geometry = cuda_decode._plan(big[:, 2:9, 5:], torch.zeros(2, 14, 85, 160))[0]
    assert (geometry.pn, geometry.pj, geometry.ph, geometry.ln, geometry.lj, geometry.lh) == (
        14 * 90 * 160, 90 * 160, 160, 14 * 85 * 160, 85 * 160, 160)
    assert (geometry.n, geometry.J, geometry.h, geometry.w) == (2, 7, 85, 160)


@pytest.mark.parametrize("what,prob,loc,match", [
    ("column stride", (1, 14, 8, 8), "transposed", "column stride of 1"),
    ("prob column stride", "transposed", (1, 28, 8, 8), "column stride of 1"),
    ("loc shape", (1, 14, 8, 8), (1, 14, 8, 8), "does not match"),
    ("3-D", (14, 8, 8), (28, 8, 8), "must be 4-D"),
    ("too many joints", (1, 70000, 1, 1), (1, 140000, 1, 1), "unsupported shape"),
])
def test_prob_wrapper_rejects_views_it_cannot_take(what, prob, loc, match):
    """A card call with a view the kernel cannot read raises ValueError with
    the reason, before any launch (shown with meta tensors, which take the
    same checks as CUDA tensors and have no kernel)."""
    def make(spec, channels):
        if spec == "transposed":
            return torch.empty((1, channels, 8, 8), device="meta").transpose(2, 3)
        return torch.empty(spec, device="meta")
    with pytest.raises(ValueError, match=match):
        cuda_decode.decode_pose(make(prob, 14), make(loc, 28), [8], [8], 1.0)


def test_prob_wrapper_takes_strided_views_up_to_the_launch():
    """The views of the estimator's paths pass every check; on a device
    without the kernel the call then stops at 'no kernel'."""
    big = torch.empty((1, 14, 100, 86), device="meta")
    loc = torch.empty((1, 40, 100, 86), device="meta")
    for prob, off in ((big[:, :, :86], loc[:, 3:31, :86]),
                      (big.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3),
                       loc[:, :28].permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3))):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            cuda_decode.decode_pose(prob, off, [86], [86], 1.0)


def test_decode_whole_hands_the_maps_over_in_place(monkeypatch):
    """`PoseEstimator._decode_whole` gives the probability-map entry the
    paths' maps as they lie (the scoremaps' row crop, the tiled maps, the
    pyramid's average) with int sizes, and its pose is the JAX package's
    decode of the same maps."""
    from deepcut_tpu_torch.models.convert import params_from_numpy
    from deepcut_tpu_torch.pose import estimate as te
    from test_torch_estimate import TCFG, _frame, _params

    est = te.PoseEstimator(params_from_numpy(_params()), TCFG, folded=False, max_size=512,
                           device="cpu")
    calls = []
    inner = cuda_decode.decode_pose

    def spy(prob, loc, valid_h, valid_w, scale=1.0):
        calls.append((prob, loc, valid_h, valid_w))
        return inner(prob, loc, valid_h, valid_w, scale)

    monkeypatch.setattr(cuda_decode, "decode_pose", spy)
    prob, loc = est._scoremaps_dev(_frame(1, 100, 90))
    pose = est._decode_whole(prob, loc, 0.75)
    est.estimate_pose(_frame(2, 600, 150))                         # the tiled path
    est.estimate_pose_avg(_frame(3, 90, 80), (0.8, 1.0, 1.2))      # the pyramid
    assert len(calls) == 3
    (p0, l0, vh, vw), _, (p2, l2, _, _) = calls
    assert p0.data_ptr() == prob.data_ptr() and l0.data_ptr() == loc.data_ptr()
    assert vh == [prob.shape[1]] and vw == [prob.shape[2]] and all(
        type(v) is int for v in vh + vw)
    assert not p2.is_contiguous()                                  # the average, read in place
    for p, l, _, _ in calls:
        cuda_decode._check(p, l)                                   # views the card's kernel takes
    ref = np.asarray(jax_decode(jnp.asarray(prob.permute(1, 2, 0).numpy()),
                                jnp.asarray(loc.permute(1, 2, 0).numpy()), scale=0.75))
    np.testing.assert_array_equal(pose, ref)
