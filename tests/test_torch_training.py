"""Port training forward/backward (`deepcut_tpu_torch.models.train`, the
trainable unfolded `models.resnet` forward, device warp and targets) against
`deepcut_tpu.models.train.loss_fn` under `jax.value_and_grad`.

Same tamed numpy params (tests/test_torch_resnet.py) and the same
`PoseDataSource` batches through both packages, on a tiny model
(depths (1,1,1,1), widths (4,4,8,8), 5 joints, pairwise head), f32 at
highest precision:
- the loss, each of its terms, and the gradient of every parameter, on a
  dense-target batch, an ``anno_*`` batch (targets rasterized on the
  device) and an ``image_raw`` batch (warped on the device);
- the BatchNorm statistics get no gradient (JAX: zero);
- the stem pool's tie rule, with planted ties, NCHW and channels_last;
- mixed_train (bf16 convs) against the JAX package's mixed training;
- remat against no remat (bit-equal on the CPU).

Tolerances: loss terms rtol 2e-5 (measured 2.5e-7). A gradient leaf is
held to atol 5e-5 x its largest entry + rtol 1e-4 (measured worst 9e-6 of
the largest entry): both sides sum thousands of f32 products per entry in
another order (oneDNN against XLA), through the backward of ~20
convolutions. Mixed training rounds every conv output to bf16 (8 bits) at
other places in the two frameworks (oneDNN may add the bias before
rounding): loss rtol 2e-3 (measured 4e-6); each gradient leaf within 15% of
its largest entry and the median leaf within 2% (measured 8% and 0.8%; the
port's f32 gradients against the JAX mixed ones miss both, at 47% and
2.3%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcut_tpu.data.pipeline import PoseDataSource
from deepcut_tpu.data.window_file import ImageRecord, Person
from deepcut_tpu.models import resnet as jr
from deepcut_tpu.models import train as jt
from deepcut_tpu.ops.pool import max_pool2d as jax_max_pool2d
from deepcut_tpu.pose.augment_device import warp_batch as jax_warp
from deepcut_tpu.pose.targets import TargetConfig
from deepcut_tpu.pose.targets_device import make_batch_rasterizer as jax_rasterizer
from deepcut_tpu_torch.models import resnet as tr
from deepcut_tpu_torch.models import train as tt
from deepcut_tpu_torch.models.convert import params_from_numpy
from deepcut_tpu_torch.ops.pool import max_pool2d
from deepcut_tpu_torch.parallel.train_step import batch_preparer

from test_torch_resnet import tame_params

J = 5
TINY = dict(depths=(1, 1, 1, 1), stage_widths=(4, 4, 8, 8), num_joints=J, pairwise=True)
TCFG = TargetConfig(num_classes=J, no_bg_class=True, location_refinement=True,
                    regress_to_other=True, weight_targets=True, fg_fraction=0.25)


def jax_cfg(**kw):
    return jr.DeeperCutConfig(**{"compute_dtype": jnp.float32, **TINY, **kw})


def port_cfg(**kw):
    return tr.DeeperCutConfig(**{"compute_dtype": torch.float32, **TINY, **kw})


def records(n=4, h=120, w=160):
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        k = rng.randint(3, J + 1)
        classes = (rng.permutation(J)[:k] + 1).astype(np.int32)
        xy = np.stack([rng.uniform(8, w - 8, k), rng.uniform(8, h - 8, k)], 1).astype(np.float32)
        out.append(ImageRecord(f"img{i}", 3, h, w, [Person(classes, xy)]))
    return out


def image_loader(path):
    i = int(path[3:])
    return np.random.RandomState(50 + i).randint(0, 256, (120, 160, 3), np.uint8)


def source(**kw):
    return PoseDataSource(records(), TCFG, seed=5, image_loader=image_loader, bucket_step=32,
                          uint8_images=True, **kw)


BATCH_KINDS = {
    "dense": dict(),
    "anno": dict(device_targets=True),
    "image_raw": dict(device_targets=True, augment=True, augment_device=True),
}


def jax_value_and_grad(params, batch, cfg):
    rast = jax_rasterizer(TCFG)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jt.loss_fn(p, rast(jax_warp(b)), cfg),
                                    has_aux=True))
    (total, terms), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(total), {k: float(v) for k, v in terms.items()}, grads


def port_value_and_grad(params, batch, cfg):
    b = batch_preparer("cpu", TCFG)(batch)
    leaves = {n: {k: (v.requires_grad_() if tr.is_trainable(n) else v) for k, v in e.items()}
              for n, e in params_from_numpy(params).items()}
    total, terms = tt.loss_fn(leaves, b, cfg)
    total.backward()
    grads = {n: {k: v.grad for k, v in e.items()} for n, e in leaves.items()}
    return float(total.detach()), {k: float(v.detach()) for k, v in terms.items()}, grads


def assert_grads_close(got, ref_jax, atol_frac, rtol, what=""):
    ref = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_jax))
    assert set(got) == set(ref)
    for n in ref:
        for k in ref[n]:
            if not tr.is_trainable(n):
                assert got[n][k] is None and not ref[n][k].any(), (n, k)
                continue
            scale = float(ref[n][k].abs().max())
            np.testing.assert_allclose(got[n][k].numpy(), ref[n][k].numpy(), rtol=rtol,
                                       atol=atol_frac * scale, err_msg=f"{what} {n}/{k}")


@pytest.mark.parametrize("kind", sorted(BATCH_KINDS))
def test_loss_and_gradients_match_jax(kind):
    jcfg = jax_cfg()
    params = tame_params(jcfg)
    batch = source(**BATCH_KINDS[kind]).next_batch(2)
    assert ("anno_cls" in batch) == (kind != "dense") and ("image_raw" in batch) == (kind == "image_raw")
    ref_total, ref_terms, ref_grads = jax_value_and_grad(params, batch, jcfg)
    total, terms, grads = port_value_and_grad(params, batch, port_cfg())
    assert set(terms) == set(ref_terms) == {"part_loss", "locref_loss", "pairwise_loss", "total_loss"}
    for k in ref_terms:
        assert terms[k] == pytest.approx(ref_terms[k], rel=2e-5), k
    assert total == pytest.approx(ref_total, rel=2e-5)
    assert_grads_close(grads, ref_grads, atol_frac=5e-5, rtol=1e-4, what=kind)


@pytest.mark.parametrize("hw", [(35, 35), (36, 41)])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_pool_backward_first_max_wins(hw, layout):
    """Ceil-mode 3x3/2 pool, inputs quantised to a few levels (post-ReLU
    zeros, plateaus of equal maxima): the whole cotangent of each window
    goes to its first maximum in scan order, as in the JAX package (and
    Caffe); an equality-mask backward would differ on every tie."""
    rng = np.random.RandomState(hw[1])
    x = np.maximum(np.round(rng.randn(2, *hw, 3) * 1.5) / 2, 0.0).astype(np.float32)
    x[:, :9, :9] = 0.5                                         # a plateau: every window tied
    g_shape = jax.eval_shape(lambda a: jax_max_pool2d(a, kernel=3, stride=2), x).shape
    g = rng.randn(*g_shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_max_pool2d(a, kernel=3, stride=2), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    xt = (xt.contiguous() if layout == "nchw" else xt.contiguous(memory_format=torch.channels_last))
    xt.requires_grad_()
    y = max_pool2d(xt, kernel=3, stride=2)
    assert y.permute(0, 2, 3, 1).shape == g.shape
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.array_equal(got != 0, ref != 0)                  # the same winners
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    ties = (x[:, :9, :9] == 0.5).sum()
    assert (ref[:, :9, :9] != 0).sum() < ties / 2              # ties did not all receive


def test_mixed_train_matches_jax_mixed():
    jcfg = jax_cfg(mixed_train=True, compute_dtype=jnp.bfloat16)
    params = tame_params(jax_cfg())
    batch = source().next_batch(2)
    ref_total, _, ref_grads = jax_value_and_grad(params, batch, jcfg)
    total, _, grads = port_value_and_grad(params, batch,
                                          port_cfg(mixed_train=True, compute_dtype=torch.bfloat16))
    f32_total, _, _ = port_value_and_grad(params, batch, port_cfg())
    assert total == pytest.approx(ref_total, rel=2e-3)
    assert total != f32_total                                   # it did run in bf16
    ref = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_grads))
    errs = [float((grads[n][k] - ref[n][k]).abs().max() / ref[n][k].abs().max())
            for n in ref if tr.is_trainable(n) for k in ref[n]]
    assert max(errs) <= 0.15 and float(np.median(errs)) <= 0.02, (max(errs), np.median(errs))


@pytest.mark.parametrize("remat", [True, (True, False, True, False)], ids=["all", "stages_1_3"])
def test_remat_equals_no_remat(remat):
    params = tame_params(jax_cfg())
    batch = source(device_targets=True).next_batch(2)
    total, terms, grads = port_value_and_grad(params, batch, port_cfg())
    total_r, terms_r, grads_r = port_value_and_grad(params, batch, port_cfg(remat=remat))
    assert total_r == total and terms_r == terms
    for n in grads:
        for k in grads[n]:
            if grads[n][k] is not None:
                assert torch.equal(grads_r[n][k], grads[n][k]), (n, k)


def test_trainable_module_freezes_bn_statistics():
    model = tr.DeeperCut(params_from_numpy(tame_params(jax_cfg())), port_cfg(),
                         folded=False, trainable=True)
    flags = {(n, k): v.requires_grad for n, e in model.param_dict().items() for k, v in e.items()}
    assert not any(f for (n, _), f in flags.items() if n.startswith("bn"))
    assert all(f for (n, _), f in flags.items() if not n.startswith("bn"))
    with pytest.raises(ValueError, match="unfolded"):
        tr.DeeperCut(params_from_numpy(tame_params(jax_cfg())), port_cfg(), trainable=True)
    mults = tt.bn_frozen_mults(model.param_dict())
    assert mults["bn_conv1"] == {"mean": 0.0, "var": 0.0, "scale_factor": 0.0}
    assert mults["scale_conv1"] == {"gamma": 1.0, "beta": 1.0}
