"""Port model (`deepcut_tpu_torch.models`) against `deepcut_tpu.models.resnet`.

Both packages get the same numpy params (JAX layout, carried across by
`params_from_numpy`) and the same numpy input, and run in f32 on the CPU.
The weights are tamed (conv1 scaled down, BN/Scale perturbed away from
identity so that folding is exercised) so the sigmoid is not saturated and
the outputs are O(1)-O(10).

Tolerance: rtol 1e-4 / atol 1e-4 relative to the output scale. The convs
sum in another order (oneDNN against XLA), and the difference compounds
through the ~16 convs of the tiny trunks; f32 leaves ~1e-7 per rounding.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepcut_tpu.models import resnet as jr
from deepcut_tpu.proto.caffemodel import load_deepercut_params, save_caffemodel
from deepcut_tpu_torch.models import resnet as tr
from deepcut_tpu_torch.models.convert import params_from_numpy

TINY_KW = dict(depths=(1, 1, 1, 1), stage_widths=(4, 4, 8, 8), num_joints=3)
# numbered res3b1..res3b3 blocks and the res3b3 skip tap
DEEP3_KW = dict(depths=(1, 4, 1, 1), stage_widths=(4, 4, 8, 8), num_joints=3)


def _cfgs(kw):
    return (jr.DeeperCutConfig(compute_dtype=jnp.float32, **kw),
            tr.DeeperCutConfig(compute_dtype=torch.float32, **kw))


def tame_params(cfg, seed=0):
    """JAX-layout numpy params (names and shapes from the JAX init_params,
    numbers from numpy) with non-identity BN and O(1) outputs."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda k: jr.init_params(k, cfg), jax.random.PRNGKey(0))
    params = {}
    for name, entry in shapes.items():
        p = {}
        for k, s in entry.items():
            if k == "w":
                head = name.startswith(("res5c_up_", "res3d_"))
                std = 0.01 if head else (2.0 / np.prod(s.shape[:3])) ** 0.5
                p[k] = std * rng.randn(*s.shape)
            elif k in ("mean", "beta", "b"):
                p[k] = 0.1 * rng.randn(*s.shape)
            elif k in ("var", "gamma"):
                p[k] = 1 + 0.3 * rng.rand(*s.shape)
            else:  # scale_factor
                p[k] = np.full(s.shape, 0.999)
            p[k] = p[k].astype(np.float32)
        params[name] = p
    params["conv1"]["w"] *= np.float32(0.01)
    return params


# one compiled program per shape instead of op-by-op dispatch
jax_forward = jax.jit(jr.forward, static_argnums=(2,), static_argnames=("folded", "heads"))


def _close(got: torch.Tensor, ref, name):
    ref = np.asarray(ref)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("kw", [TINY_KW, DEEP3_KW], ids=["tiny", "res3b_numbered"])
@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("hw", [(40, 40), (44, 58)])
def test_forward_matches_jax(kw, folded, hw):
    jcfg, tcfg = _cfgs(kw)
    params = tame_params(jcfg)
    x = (np.random.RandomState(1).rand(2, *hw, 3) * 255 - 128).astype(np.float32)
    pj = jr.fold_bn(params, jcfg) if folded else params
    ref = jax_forward(pj, jnp.asarray(x), jcfg, folded=folded)
    pt = params_from_numpy(params)
    if folded:
        pt = tr.fold_bn(pt, tcfg)
    model = tr.DeeperCut(pt, tcfg, folded=folded)
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == {"fc_pose", "prob", "loc_pred", "next_pred"} == set(ref)
    for k in ref:
        _close(got[k], ref[k], k)
    assert 0.01 < float(got["prob"].min()) and float(got["prob"].max()) < 0.99  # not saturated
    # the serving subset and the uint8 input path
    with torch.inference_mode():
        sub = model(torch.from_numpy(x).permute(0, 3, 1, 2), heads=("pose", "locref"))
    assert set(sub) == {"fc_pose", "prob", "loc_pred"}
    torch.testing.assert_close(sub["loc_pred"], got["loc_pred"], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="mandatory"):
        model(torch.from_numpy(x).permute(0, 3, 1, 2), heads=("locref",))


def test_uint8_input_is_mean_subtracted_on_device():
    jcfg, tcfg = _cfgs(TINY_KW)
    params = tame_params(jcfg)
    u8 = np.random.RandomState(2).randint(0, 256, (1, 32, 40, 3), np.uint8)
    ref = jax_forward(params, jnp.asarray(u8), jcfg)
    model = tr.DeeperCut(params_from_numpy(params), tcfg, folded=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(u8).permute(0, 3, 1, 2))
    _close(got["prob"], ref["prob"], "prob")


def test_fold_bn_matches_jax_including_zero_scale_factor():
    jcfg, tcfg = _cfgs(TINY_KW)
    params = tame_params(jcfg)
    params["bn2a_branch2b"]["scale_factor"] = np.zeros((1,), np.float32)
    ref = jax.tree_util.tree_map(np.asarray, jr.fold_bn(params, jcfg))
    got = tr.fold_bn(params_from_numpy(params), tcfg)
    back = params_from_numpy(ref)
    assert set(got) == set(back)
    for name in got:
        assert set(got[name]) == set(back[name]), name
        for k in got[name]:
            torch.testing.assert_close(got[name][k], back[name][k], rtol=1e-6, atol=1e-6)
    cast = tr.cast_params(got, torch.bfloat16)
    assert cast["conv1"]["w"].dtype == torch.bfloat16 and cast["conv1"]["b"].dtype == torch.float32


def test_resnet152_param_names_and_shapes_match_jax():
    jcfg = jr.deepercut_config(152)
    shapes = jax.eval_shape(lambda k: jr.init_params(k, jcfg), jax.random.PRNGKey(0))
    ref = params_from_numpy({n: {k: np.zeros(s.shape, np.float32) for k, s in p.items()}
                             for n, p in shapes.items()})
    tcfg = tr.deepercut_config(152)
    got = tr.init_params(torch.Generator().manual_seed(0), tcfg)
    assert sorted(got) == sorted(ref)
    for name in got:
        assert {k: tuple(v.shape) for k, v in got[name].items()} == \
               {k: tuple(v.shape) for k, v in ref[name].items()}, name
    assert "res3b7_branch2c" in got and tr._skip_block(tcfg) == jr._skip_block(jcfg) == "3b7"
    assert tr._block_names(tcfg, 2) == jr._block_names(jcfg, 2)
    # MSRA std on a 3x3/256 conv, identity BN, std-0.01 heads
    w = got["res4b5_branch2b"]["w"]
    assert abs(float(w.std()) - (2.0 / (9 * 256)) ** 0.5) < 2e-3
    assert float(got["res5c_up_pose"]["w"].std()) == pytest.approx(0.01, rel=0.05)
    assert torch.equal(got["bn2a_branch1"]["var"], torch.ones(256))


def test_caffemodel_written_by_jax_package_loads_into_port(tmp_path):
    """save_caffemodel (JAX package) -> load_deepercut_params + params_from_numpy
    (the port's loader, as get_estimator(model_bin=...) runs it)."""
    jcfg, tcfg = _cfgs(DEEP3_KW)
    params = tame_params(jcfg, seed=3)
    path = str(tmp_path / "tiny.caffemodel")
    save_caffemodel(path, params, deconv_names=[n for n in params if n.startswith("res5c_up_")])
    loaded = params_from_numpy(load_deepercut_params(path))
    direct = params_from_numpy(params)
    assert set(loaded) == set(direct)
    for name in direct:
        for k in direct[name]:
            assert torch.equal(loaded[name][k].reshape(direct[name][k].shape), direct[name][k]), (name, k)
    x = (np.random.RandomState(4).rand(1, 40, 48, 3) * 255 - 128).astype(np.float32)
    ref = jax_forward(params, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        got = tr.DeeperCut(loaded, tcfg, folded=False)(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got["prob"], ref["prob"], "prob")
    _close(got["loc_pred"], ref["loc_pred"], "loc_pred")


@pytest.mark.parametrize("kw", [TINY_KW, DEEP3_KW], ids=["tiny", "res3b_numbered"])
@pytest.mark.parametrize("hw", [(40, 40), (44, 58)])
def test_folded_bf16_forward_matches_jax_bf16(kw, hw):
    """The serving forward (BN folded, bf16 weights and activations) against
    the JAX package's folded bf16 forward on the same tamed params, bit for
    bit on the CPU.

    Both round each conv's f32 sum plus its f32 bias to bf16 once, then the
    residual add in bf16 and ReLU (the port's `ops.conv_epilogue`, whose
    plain version the CPU runs); the port's conv is an f32 `F.conv2d` of
    bf16-valued operands, exact products summed in f32. Held: the head maps
    (logits, locref) equal (atol 0); 'prob' within 4 ulp: it is each
    framework's own f32 sigmoid of equal logits, and each of the two lies
    within 2 ulp of the exact value (read over 4M normal logits of std 6
    on the CPU; they differ on 0.4% of them, by at most 3 ulp)."""
    jcfg, tcfg = jr.DeeperCutConfig(**kw), tr.DeeperCutConfig(**kw)
    params = tame_params(jcfg)
    x = (np.random.RandomState(1).rand(2, *hw, 3) * 255 - 128).astype(np.float32)
    ref = jax_forward(jr.cast_params(jr.fold_bn(params, jcfg)), jnp.asarray(x), jcfg, folded=True)
    model = tr.DeeperCut(tr.cast_params(tr.fold_bn(params_from_numpy(params), tcfg)), tcfg)
    w = model.layers["conv1"]["w"]  # bf16 values, held in f32 for the serving convs
    assert w.dtype == torch.float32 and torch.equal(w, w.to(torch.bfloat16).float())
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in ref:
        r = np.asarray(ref[k])
        g = got[k].permute(0, 2, 3, 1).numpy()
        assert g.dtype == np.float32 and g.shape == r.shape, k
        if k == "prob":
            np.testing.assert_array_max_ulp(g, r, maxulp=4)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)
