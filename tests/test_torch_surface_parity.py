"""The public functions that closed the port's surface (tests/test_torch_surface.py)
against their JAX counterparts, on the CPU, on the same seeded numpy inputs.

Tolerances: float results within 16 f32 ulps at the output's largest
magnitude (tests/test_torch_engine_losses.py's rule; the sums of the means
and of the unfolded and f32 convolutions run in another order, oneDNN
against XLA); the data movers, `bilinear_filler` and the folded bf16
forward's head maps exactly (the bf16 forward's 'prob' within 4 ulps: each
framework's own f32 sigmoid of equal logits, as
tests/test_torch_resnet.py holds it). The jax-free copies
(`write_window_file`, `rasterize_reference`, `augment_record`) are byte- or
value-equal, and leave the same `RandomState` draws behind.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcut_tpu.core import layers as j_layers
from deepcut_tpu.core.graph import Net as JNet
from deepcut_tpu.data import window_file as j_wf
from deepcut_tpu.models import resnet as jr
from deepcut_tpu.ops import activations as j_act
from deepcut_tpu.ops import conv as j_conv
from deepcut_tpu.ops import eltwise as j_elt
from deepcut_tpu.ops import pool as j_pool
from deepcut_tpu.pose import augment as j_aug
from deepcut_tpu.pose import targets as j_targets
from deepcut_tpu.proto import text_format as j_tf
from deepcut_tpu_torch.core import layers as t_layers
from deepcut_tpu_torch.core.graph import Net as TNet
from deepcut_tpu_torch.data import window_file as t_wf
from deepcut_tpu_torch.models import resnet as tr
from deepcut_tpu_torch.models.convert import params_from_numpy
from deepcut_tpu_torch.ops import activations as t_act
from deepcut_tpu_torch.ops import conv as t_conv
from deepcut_tpu_torch.ops import eltwise as t_elt
from deepcut_tpu_torch.ops import pool as t_pool
from deepcut_tpu_torch.pose import augment as t_aug
from deepcut_tpu_torch.pose import estimate as te
from deepcut_tpu_torch.pose import targets as t_targets
from deepcut_tpu_torch.proto import text_format as t_tf
from deepcut_tpu_torch.runtime import build as t_build
from test_targets import CONFIGS, _record
from test_torch_engine_losses import assert_close
from test_torch_resnet import DEEP3_KW, TINY_KW, tame_params

X = (2, 3, 7, 9)   # N, C, H, W


def _x(seed=0, shape=X, positive=False):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 1.5
    return np.abs(a) + 0.05 if positive else a


def _nhwc(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), 1, -1))


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1))


# -- ops --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["global_avg_pool2d", "global_max_pool2d"])
def test_global_pooling_matches_jax(name):
    x = _x(1)
    got = getattr(t_pool, name)(torch.from_numpy(x))
    want = _nchw(getattr(j_pool, name)(jnp.asarray(_nhwc(x))))
    assert got.shape == (2, 3, 1, 1)
    assert_close(got.numpy(), want, name)


@pytest.mark.parametrize("kernel, stride", [(3, 2), (2, 2), ((3, 2), (2, 3))])
def test_stochastic_pool2d_matches_jax_and_dispatches(kernel, stride):
    """TEST form against the JAX package's (train=False, or train without a
    key / generator); the TRAIN form is `stochastic_pool2d_train` on the
    generator given (torch cannot draw JAX's samples: each picks one
    element of its window in both packages)."""
    x = _x(2, positive=True)
    want = _nchw(j_pool.stochastic_pool2d(jnp.asarray(_nhwc(x)), kernel=kernel, stride=stride))
    xt = torch.from_numpy(x)
    for got in (t_pool.stochastic_pool2d(xt, kernel=kernel, stride=stride),
                t_pool.stochastic_pool2d(xt, None, kernel=kernel, stride=stride, train=True)):
        assert_close(got.numpy(), want, "stochastic TEST")
    drawn = t_pool.stochastic_pool2d(xt, torch.Generator().manual_seed(5), kernel=kernel,
                                     stride=stride, train=True)
    again = t_pool.stochastic_pool2d_train(xt, torch.Generator().manual_seed(5), kernel=kernel,
                                           stride=stride)
    assert torch.equal(drawn, again)
    jdrawn = _nchw(j_pool.stochastic_pool2d(jnp.asarray(_nhwc(x)), jax.random.PRNGKey(5),
                                            kernel=kernel, stride=stride, train=True))
    assert jdrawn.shape == tuple(drawn.shape) == want.shape
    for sample in (drawn.numpy(), jdrawn):   # an element of its window, or a zero past the edge
        assert np.isin(sample, np.append(x, 0.0)).all()


@pytest.mark.parametrize("name", ["tanh", "absval"])
def test_activations_match_jax(name):
    x = _x(3)
    got = getattr(t_act, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(j_act, name)(jnp.asarray(x)))
    assert_close(got, want, name)
    if name == "absval":
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kh, kw, cin, cout", [(4, 4, 3, 3), (3, 3, 2, 5), (4, 3, 3, 2),
                                               (1, 1, 2, 2), (16, 16, 14, 14)])
def test_bilinear_filler_matches_jax(kh, kw, cin, cout):
    """The JAX package's (kh, kw, cin, cout) weight is the transpose of the
    port's deconv layout (cin, cout, kh, kw); the values are exact."""
    got = t_conv.bilinear_filler(kh, kw, cin, cout)
    want = np.asarray(j_conv.bilinear_filler(kh, kw, cin, cout)).transpose(2, 3, 0, 1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    half = t_conv.bilinear_filler(kh, kw, cin, cout, dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16 and torch.equal(half, got.to(torch.bfloat16))


@pytest.mark.parametrize("axis", [0, 1, 2, 3])
def test_concat_and_split_op_match_jax(axis):
    parts = [_x(4, X), _x(5, X)]
    got = t_elt.concat([torch.from_numpy(p) for p in parts], axis=axis).numpy()
    # the JAX package's axes are NHWC: NCHW axis a is NHWC axis (0, 3, 1, 2)[a]
    want = _nchw(j_elt.concat([jnp.asarray(_nhwc(p)) for p in parts], axis=(0, 3, 1, 2)[axis]))
    np.testing.assert_array_equal(got, want)
    x = torch.from_numpy(parts[0])
    tops, jtops = t_elt.split_op(x, 3), j_elt.split_op(jnp.asarray(parts[0]), 3)
    assert len(tops) == len(jtops) == 3 and all(t is x for t in tops)


def test_output_channels_matches_jax():
    proto = """name: "c"
input: "data" input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 6 kernel_size: 3 } }
layer { name: "up" type: "Deconvolution" bottom: "conv" top: "up"
  convolution_param { num_output: 2 kernel_size: 2 stride: 2 } }
layer { name: "relu" type: "ReLU" bottom: "up" top: "up" }
layer { name: "pool" type: "Pooling" bottom: "up" top: "pool"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
"""
    jplan = JNet(j_tf.parse(proto), compute_dtype=None)._plan
    tplan = TNet(t_tf.parse(proto), compute_dtype=None, device="cpu")._plan
    assert [s.name for _, s in tplan] == [s.name for _, s in jplan]
    for (_, ts), (_, js) in zip(tplan, jplan):
        for cin in (None, 5):
            assert t_layers.output_channels(ts, cin) == j_layers.output_channels(js, cin), ts.name
    assert [t_layers.output_channels(s, 5) for _, s in tplan] == [6, 2, 5, 5]


# -- make_forward -----------------------------------------------------------

MAKE_FORWARD_CASES = [("unfolded-f32", TINY_KW, False, "f32"),
                      ("folded-f32", TINY_KW, True, "f32"),
                      ("folded-bf16", TINY_KW, True, "bf16"),
                      ("folded-bf16-res3b", DEEP3_KW, True, "bf16")]


@pytest.mark.parametrize("heads", [("pose", "locref"), None], ids=["pose-locref", "all-heads"])
@pytest.mark.parametrize("case", MAKE_FORWARD_CASES, ids=[c[0] for c in MAKE_FORWARD_CASES])
def test_make_forward_matches_jax_and_the_estimator(case, heads):
    """`make_forward(cfg, folded=, heads=)(params, x)` against the JAX
    package's jitted `make_forward` on the same params and frames, and bit
    for bit against the port's `PoseEstimator` forward (its model, built
    from the raw params, folds and casts them itself)."""
    _, kw, folded, dtype = case
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jcfg = jr.DeeperCutConfig(compute_dtype=jdt, **kw)
    tcfg = tr.DeeperCutConfig(compute_dtype=tdt, **kw)
    params = tame_params(jcfg)
    x = (np.random.RandomState(1).rand(2, 40, 48, 3) * 255 - 128).astype(np.float32)
    jp = jr.cast_params(jr.fold_bn(params, jcfg), jdt) if folded else params
    want = jax.jit(jr.make_forward(jcfg, folded=folded, heads=heads))(jp, jnp.asarray(x))
    tp = params_from_numpy(params)
    if folded:
        tp = tr.cast_params(tr.fold_bn(tp, tcfg), tdt)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = tr.make_forward(tcfg, folded=folded, heads=heads)(tp, xt)
        est = te.PoseEstimator(params_from_numpy(params), tcfg, folded=folded, device="cpu")
        served = est.model(xt, heads=heads)
    assert set(got) == set(want) == set(served)
    assert set(got) >= {"fc_pose", "prob", "loc_pred"} and ("next_pred" in got) == (heads is None)
    for k in want:
        assert torch.equal(got[k], served[k]), f"{k}: make_forward against the estimator"
        g, w = got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k])
        if dtype == "f32":
            assert_close(g, w, k)
        elif k == "prob":
            np.testing.assert_array_max_ulp(g, w, maxulp=4)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


# -- the jax-free copies ----------------------------------------------------


def test_write_window_file_writes_the_jax_packages_bytes(tmp_path):
    rng = np.random.RandomState(6)
    jrecs = [dataclasses.replace(_record(rng, num_people=n, height=120 + 8 * n), path=f"im{n}.png",
                                 multi=n > 1) for n in (1, 3, 2)]
    jrecs.append(j_wf.ImageRecord("empty.png", 3, 64, 48, [], multi=True))
    trecs = [t_wf.ImageRecord(r.path, r.channels, r.height, r.width,
                              [t_wf.Person(p.classes, p.xy) for p in r.people], r.multi)
             for r in jrecs]
    j_wf.write_window_file(str(tmp_path / "jax.txt"), jrecs)
    t_wf.write_window_file(str(tmp_path / "port.txt"), trecs)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    back = t_wf.parse_window_file(str(tmp_path / "port.txt"))
    assert [(r.path, r.height, r.width, r.multi, len(r.people)) for r in back] == \
           [(r.path, r.height, r.width, r.multi, len(r.people)) for r in trecs]
    for r, b in zip(trecs, back):
        for p, q in zip(r.people, b.people):
            np.testing.assert_array_equal(q.classes, p.classes)
            np.testing.assert_array_equal(q.xy, p.xy)


def _port_record(rec):
    return t_wf.ImageRecord(rec.path, rec.channels, rec.height, rec.width,
                            [t_wf.Person(p.classes, p.xy) for p in rec.people], rec.multi)


@pytest.mark.parametrize("num_people, with_skip", [(1, False), (3, False), (2, True)])
@pytest.mark.parametrize("cfg_idx", range(len(CONFIGS)))
def test_rasterize_reference_equals_jax(cfg_idx, num_people, with_skip):
    """The loop oracle on the JAX package's target configurations
    (tests/test_targets.py): every map exactly equal, the same draws taken
    (scale sampled where the config jitters it), and the port's vectorized
    `rasterize` within that test's tolerance of it."""
    jcfg = CONFIGS[cfg_idx]
    tcfg = t_targets.TargetConfig(**dataclasses.asdict(jcfg))
    jrec = _record(np.random.RandomState(42 + cfg_idx), num_people=num_people,
                   with_skip=with_skip)
    jrng, trng = np.random.RandomState(7), np.random.RandomState(7)
    want = j_targets.rasterize_reference(jrec, jcfg, rng=jrng)
    got = t_targets.rasterize_reference(_port_record(jrec), tcfg, rng=trng)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert trng.randint(1 << 30) == jrng.randint(1 << 30)
    vec = t_targets.rasterize(_port_record(jrec), tcfg, rng=np.random.RandomState(7))
    for k in want:
        np.testing.assert_allclose(vec[k], got[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("seed", range(4))
def test_augment_record_equals_jax(seed):
    """The same warped image (byte-equal), the same transformed joints and
    the same draws; a record without people comes back unchanged."""
    rng = np.random.RandomState(seed)
    jrec = _record(rng, num_people=1 + seed % 2, height=96, width=128)
    if seed == 3:
        jrec = dataclasses.replace(jrec, people=[])
    image = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    jrng, trng = np.random.RandomState(100 + seed), np.random.RandomState(100 + seed)
    jimg, jout = j_aug.augment_record(jrec, image.copy(), jrng, max_rotation_deg=20.0)
    timg, tout = t_aug.augment_record(_port_record(jrec), image.copy(), trng, max_rotation_deg=20.0)
    assert timg.dtype == jimg.dtype and timg.tobytes() == jimg.tobytes()
    assert (tout.height, tout.width, len(tout.people)) == (jout.height, jout.width, len(jout.people))
    for p, q in zip(tout.people, jout.people):
        np.testing.assert_array_equal(p.classes, q.classes)
        np.testing.assert_array_equal(p.xy, q.xy)
    assert trng.randint(1 << 30) == jrng.randint(1 << 30)
    if seed == 3:
        assert timg is not None and np.array_equal(timg, image)


# -- runtime/build.py ---------------------------------------------------------


def test_runtime_build_builds_and_loads_the_host_library():
    """`build(cuda=False)` builds (or finds built) the C++ rasterizer alone,
    loads it, and the rasterizer then computes the numpy oracle's targets."""
    from deepcut_tpu_torch import runtime

    if shutil.which("g++") is None:
        pytest.skip("no g++ here: the host library cannot be built")
    paths = t_build.build(cuda=False)
    assert paths == [runtime.LIB.path()] and paths[0].is_file()
    assert [lib.source.name for lib in t_build.libraries()] == [
        "rasterizer.cpp", "decode_pose.cu", "conv_epilogue.cu", "int8_conv.cu", "conv3x3.cu"]
    assert runtime.available()
    cfg = t_targets.TargetConfig(location_refinement=True)
    rec = _port_record(_record(np.random.RandomState(3)))
    want = t_targets.rasterize(rec, cfg, rng=np.random.RandomState(4), scale=1.0)
    got = t_targets.rasterize_native(rec, cfg, rng=np.random.RandomState(4), scale=1.0)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_runtime_build_command_fails_naming_nvcc_without_it(tmp_path):
    """`python -m deepcut_tpu_torch.runtime.build` builds every library, so
    where no nvcc is found it exits 1 and names nvcc; it never skips one."""
    from deepcut_tpu_torch import native

    try:
        native.nvcc_path()
        pytest.skip("nvcc is installed here: the command would build the CUDA libraries")
    except RuntimeError:
        pass
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    run = subprocess.run([sys.executable, "-m", "deepcut_tpu_torch.runtime.build"],
                         cwd=Path(__file__).resolve().parents[1], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 1, (run.stdout, run.stderr)
    assert "nvcc not found" in run.stderr and "Traceback" not in run.stderr
