"""int8 serving in the port (`deepcut_tpu_torch.models.quantize`, the plain
versions in `ops.int8_conv`) against `deepcut_tpu.models.quantize`.

Both packages get the same numpy params (JAX layout, carried across by
`params_from_numpy` / `qparams_from_numpy`) and the same numpy input, on the
CPU. The JAX forward is jitted, as the JAX estimator runs it: XLA:CPU then
contracts each dequantization ``acc * scale + b`` (and the int8 stream's
``y_q * s_y + z``) into one FMA, which the port's epilogue reproduces.

Tolerances, with their reasons:
- quantized weights, int32 accumulators, epilogue and quantization: none
  (integer arithmetic, and the same f32 operations in the same order);
- the bf16 forward on a shared quantization: the heads' maps (``fc_pose``,
  ``loc_pred``) bit-equal; ``prob`` within 4 ulp, each framework's own f32
  sigmoid of equal logits (tests/test_torch_resnet.py);
- the f32 forward: bit-equal with the int8 deconv; with the float deconv
  the maps agree to 5e-6 of their scale, its f32 sums running in another
  order (oneDNN against XLA), ~1e-7 per rounding over 4608 terms;
- activation scales: rtol 1e-5. Calibration runs f32 convs on both sides,
  summed in another order; absmax and percentiles pick the same element,
  so the scales differ by the f32 rounding of its sums only;
- the percentile helper: bit-equal to ``jnp.percentile``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepcut_tpu.models import quantize as jq
from deepcut_tpu.models import resnet as jr
from deepcut_tpu_torch.models import quantize as tq
from deepcut_tpu_torch.models import resnet as tr
from deepcut_tpu_torch.models.convert import params_from_numpy, qparams_from_numpy
from deepcut_tpu_torch.ops import int8_conv as ic
from test_torch_resnet import tame_params

# tests/test_quantize.py's TINY configs: pose+locref, and all three heads
TINY_KW = dict(depths=(1, 1, 1, 1), stage_widths=(8, 8, 16, 16), num_joints=4, pairwise=False)
PAIR_KW = dict(depths=(1, 1, 1, 1), stage_widths=(8, 8, 16, 16), num_joints=3)

jax_forward_int8 = jax.jit(jq.forward_int8, static_argnums=(3,),
                           static_argnames=("int8_residual", "int8_deconv", "heads"))


def _cfgs(kw, dtype="bf16"):
    return (jr.DeeperCutConfig(compute_dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32, **kw),
            tr.DeeperCutConfig(compute_dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
                               **kw))


def _x(seed=1, n=2, h=40, w=48):
    return (np.random.RandomState(seed).rand(n, h, w, 3) * 255 - 128).astype(np.float32)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).permute(0, 3, 1, 2)  # a writable copy


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shared(kw, dtype="bf16", quantize_deconv=True):
    """The JAX package's quantization of tamed params, in both layouts."""
    jcfg, tcfg = _cfgs(kw, dtype)
    params = jax.tree_util.tree_map(jnp.asarray, tame_params(jcfg))
    x = _x()
    qp, sc = jq.prepare_int8(params, jcfg, jnp.asarray(x), quantize_deconv=quantize_deconv)
    return jcfg, tcfg, x, (qp, sc), qparams_from_numpy(_np(qp), _np(sc))


# -- quantization and calibration ---------------------------------------------
@pytest.mark.parametrize("quantize_deconv", [False, True])
def test_quantize_weights_matches_jax(quantize_deconv):
    jcfg, tcfg = _cfgs(PAIR_KW)
    params = tame_params(jcfg)
    params["res2a_branch2b"]["w"][..., 3] = 0.0  # a zero channel gets scale 1
    folded = _np(jr.fold_bn(jax.tree_util.tree_map(jnp.asarray, params), jcfg))
    ref = _np(jq.quantize_weights(jax.tree_util.tree_map(jnp.asarray, folded),
                                  quantize_deconv=quantize_deconv))
    want, _ = qparams_from_numpy(ref, {})
    got = tq.quantize_weights(params_from_numpy(folded), quantize_deconv=quantize_deconv)
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for k in want[name]:
            assert got[name][k].dtype == want[name][k].dtype, (name, k)
            assert torch.equal(got[name][k], want[name][k]), (name, k)
    assert got["res2a_branch2b"]["w_scale"][3] == 1.0
    assert ("w_q" in got["res5c_up_pose"]) == quantize_deconv and "w" in got["res5c_up_pose"]
    assert "w_q" not in got["conv1"]


@pytest.mark.parametrize("q", [99.9, 99.0, 50.0, 37.3])
def test_percentile_matches_jnp_bit_for_bit(q):
    rng = np.random.RandomState(int(q * 10))
    for n in (2, 7, 1000, 65537, 131072):
        a = (np.abs(rng.randn(n)) * rng.choice([0.1, 10.0])).astype(np.float32)
        want = np.float32(jnp.percentile(jnp.asarray(a), q))
        got = tq.percentile_f32(torch.from_numpy(a), q)
        assert got.dtype == torch.float32 and got.item() == want, (n, got.item(), want)


@pytest.mark.parametrize("percentile", [100.0, 99.9])
@pytest.mark.parametrize("kw", [TINY_KW, PAIR_KW], ids=["tiny", "pairwise"])
def test_calibrate_act_scales_matches_jax(kw, percentile):
    jcfg, tcfg = _cfgs(kw, "f32")
    params = tame_params(jcfg)
    folded = _np(jr.fold_bn(jax.tree_util.tree_map(jnp.asarray, params), jcfg))
    x = _x(2, n=1, h=72, w=64) * 0.3
    ref = _np(jq.calibrate_act_scales(jax.tree_util.tree_map(jnp.asarray, folded), jcfg,
                                      jnp.asarray(x), percentile=percentile))
    got = tq.calibrate_act_scales(params_from_numpy(folded), tcfg, _nchw(x),
                                  percentile=percentile)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].item(), ref[k], rtol=1e-5, err_msg=k)
    # one tensor, one value: the int8 stream's last boundary, the deconv
    # input and every head's skip input
    last = tr._block_names(tcfg, 3)[-1]
    assert got["res5c_up"].item() == got[f"res{last}#out"].item()
    heads = [k for k in got if k.startswith("res3d_")]
    assert len(heads) == (3 if kw is PAIR_KW else 2)
    assert len({got[k].item() for k in heads}) == 1


# -- the forward on a shared quantization -------------------------------------
@pytest.mark.parametrize("int8_deconv", [False, True], ids=["deconv_bf16", "deconv_int8"])
@pytest.mark.parametrize("int8_residual", [False, True], ids=["stream_float", "stream_int8"])
def test_forward_int8_bf16_bit_equal_to_jax(int8_residual, int8_deconv):
    jcfg, tcfg, x, (qp, sc), (tqp, tsc) = _shared(TINY_KW)
    ref = jax_forward_int8(qp, sc, jnp.asarray(x), jcfg, int8_residual=int8_residual,
                           int8_deconv=int8_deconv)
    got = tq.forward_int8(tqp, tsc, _nchw(x), tcfg, int8_residual=int8_residual,
                          int8_deconv=int8_deconv)
    assert set(got) == set(ref) == {"fc_pose", "prob", "loc_pred"}
    for k in ref:
        r, g = np.asarray(ref[k]), got[k].permute(0, 2, 3, 1).numpy()
        assert g.dtype == np.float32 and g.shape == r.shape, k
        if k == "prob":
            np.testing.assert_array_max_ulp(g, r, maxulp=4)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)
    assert 1e-3 < float(got["prob"].min()) and float(got["prob"].max()) < 0.999  # not saturated


@pytest.mark.parametrize("heads", [None, ("pose", "locref"), ("pose", "next")],
                         ids=["all", "serving", "pose_next"])
def test_forward_int8_heads_subset_bit_equal_to_jax(heads):
    jcfg, tcfg, x, (qp, sc), (tqp, tsc) = _shared(PAIR_KW)
    ref = jax_forward_int8(qp, sc, jnp.asarray(x), jcfg, heads=heads)
    model = tq.DeeperCutInt8(tqp, tsc, tcfg)
    with torch.inference_mode():
        got = model(_nchw(x), heads)
        fused = model.fused_heads(_nchw(x), heads)
    assert set(got) == set(ref)
    for k in ref:
        if k != "prob":
            np.testing.assert_array_equal(got[k].permute(0, 2, 3, 1).numpy(), np.asarray(ref[k]))
    assert fused.shape[1] == sum(got[k].shape[1] for k in got if k != "prob")
    with pytest.raises(ValueError, match="mandatory"):
        model(_nchw(x), ("locref",))


@pytest.mark.parametrize("int8_deconv", [False, True], ids=["deconv_f32", "deconv_int8"])
def test_forward_int8_f32_matches_jax(int8_deconv):
    jcfg, tcfg, x, (qp, sc), (tqp, tsc) = _shared(TINY_KW, "f32")
    for int8_residual in (False, True):
        ref = jax_forward_int8(qp, sc, jnp.asarray(x), jcfg, int8_residual=int8_residual,
                               int8_deconv=int8_deconv)
        got = tq.forward_int8(tqp, tsc, _nchw(x), tcfg, int8_residual=int8_residual,
                              int8_deconv=int8_deconv)
        for k in ("fc_pose", "loc_pred"):
            r, g = np.asarray(ref[k]), got[k].permute(0, 2, 3, 1).numpy()
            if int8_deconv:
                np.testing.assert_array_equal(g, r, err_msg=k)
            else:
                np.testing.assert_allclose(g, r, rtol=0, atol=5e-6 * np.abs(r).max(), err_msg=k)


# -- the plain ops against the JAX expressions --------------------------------
def _i8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("k,stride,pad,dilation,cin", [
    (1, 1, 0, 1, 128), (1, 2, 0, 1, 128), (3, 1, 1, 1, 128), (3, 1, 2, 2, 128), (3, 2, 1, 1, 128),
    (3, 1, 1, 1, 12), (1, 1, 0, 1, 12)])
def test_conv_i8_plain_and_route_match_jax(k, stride, pad, dilation, cin):
    """The exact accumulator, and the card's route (im2col rows, packed
    weight, torch._int_mm; its plain im2col here), at full-scale values:
    products of 127 * 127, sums past int16 and (3x3) past f32's 2**24.
    With 12 channels the GEMM's inner width is padded with zeros to a
    multiple of 8 (108 -> 112, 12 -> 16), as the card's int8 GEMM needs."""
    rng = np.random.RandomState(k * 100 + stride * 10 + dilation + cin)
    x = _i8(rng, 2, 11, 9, cin)
    w = _i8(rng, k, k, cin, 16)
    x[0, :, :, :] = 127
    w[..., 0] = 127
    ref = np.asarray(jq._conv_i8(jnp.asarray(x), jnp.asarray(w), stride=stride, pad=pad,
                                 dilation=dilation))
    assert np.abs(ref).max() > (2**24 if (k, cin) == (3, 128) else 2**16)
    xt, wt = _nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    plain = ic.conv_i8_plain(xt, wt, stride=stride, pad=pad, dilation=dilation)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.permute(0, 2, 3, 1).numpy(), ref)
    route = ic.conv_i8(xt, ic.pack_conv_weight(wt), 16, k, stride=stride, pad=pad,
                       dilation=dilation)
    np.testing.assert_array_equal(route.permute(0, 2, 3, 1).numpy(), ref)


def test_deconv_i8_plain_and_route_match_jax():
    """``_deconv_i8``: the plain transposed conv, and the route's conv over
    the input dilated by 2 with the flipped kernel, the output width padded
    from 6 to 8 for the GEMM."""
    rng = np.random.RandomState(7)
    x = _i8(rng, 2, 5, 6, 32)
    w = _i8(rng, 3, 3, 32, 6)  # the JAX package's (kh, kw, Cin, Cout)
    ref = np.asarray(jq._deconv_i8(jnp.asarray(x), jnp.asarray(w), stride=2))
    wt = torch.from_numpy(w.transpose(2, 3, 0, 1).copy())  # (Cin, Cout, kh, kw), no flip
    plain = ic.deconv_i8_plain(_nchw(x), wt)
    np.testing.assert_array_equal(plain.permute(0, 2, 3, 1).numpy(), ref)
    packed = ic.pack_deconv_weight(wt)
    assert packed.shape == (8, 9 * 32) and not packed[6:].any()
    route = ic.conv_i8(_nchw(x), packed, 6, 3, pad=2, lhs_dilation=2)
    np.testing.assert_array_equal(route.permute(0, 2, 3, 1).numpy(), ref)


def _jax_epilogue(mode):
    """The JAX package's expressions (quantize.py), jitted as the estimator
    runs them."""
    def quant(v, s):
        return jnp.clip(jnp.round(v.astype(jnp.float32) * (1.0 / s)), -127, 127).astype(jnp.int8)

    def fn(acc, s_x, ws, b, r, s_r, s_n):
        y = acc.astype(jnp.float32) * (s_x * ws) + b
        if mode == "act":          # qconv: relu, bf16, then the next conv's quant
            return quant(jnp.where(y > 0, y, 0).astype(jnp.bfloat16), s_n)
        if mode == "block":        # relu(shortcut + z), both bf16
            z = y.astype(jnp.bfloat16)
            out = z + r.astype(jnp.bfloat16)
            return jnp.where(out > 0, out, jnp.zeros((), out.dtype)).astype(jnp.float32)
        if mode == "stream":       # relu(y_q * s_y + z), f32, then quant
            z = y.astype(jnp.bfloat16)
            out = r.astype(jnp.int8).astype(jnp.float32) * s_r + z
            return quant(jnp.where(out > 0, out, 0), s_n)
        return r + y               # heads: crop(up) + sk, f32
    return jax.jit(fn)


@pytest.mark.parametrize("mode", ["act", "block", "stream", "heads"])
def test_epilogue_plain_matches_jax(mode):
    """65536 accumulators at the trunk's range: the dequantization rounds
    once as XLA's FMA (a multiply-then-add differs on ~7% of them), then
    each mode's bf16 rounding, residual, ReLU and quantization."""
    rng = np.random.RandomState(3)
    c = 64
    acc = rng.randint(-2**24, 2**24, (16, 64, c)).astype(np.int32)
    s_x, s_r, s_n = np.float32(0.0123), np.float32(0.0371), np.float32(0.0517)
    ws = (rng.rand(c) * 1e-3 + 1e-5).astype(np.float32)
    b = (rng.randn(c) * 3).astype(np.float32)
    if mode == "stream":
        r = _i8(rng, 16, 64, c)
    else:
        r = (rng.randn(16, 64, c) * 30).astype(np.float32)
        r = np.asarray(jnp.asarray(r).astype(jnp.bfloat16).astype(jnp.float32))
    ref = np.asarray(_jax_epilogue(mode)(acc, s_x, ws, b, r, s_r, s_n))
    at = _nchw(acc[None])
    scale = torch.tensor(s_x) * torch.from_numpy(ws)
    kw = dict(act=dict(relu=True, f32_out=False, requant_s=float(s_n)),
              block=dict(residual=_nchw(r[None]), relu=True),
              stream=dict(residual=_nchw(r[None]), residual_scale=float(s_r), relu=True,
                          f32_out=False, requant_s=float(s_n)),
              heads=dict(residual=_nchw(r[None]), bf16=False))[mode]
    y, q = ic.int8_epilogue(at, scale, torch.from_numpy(b), **kw)
    got = (q if q is not None else y).permute(0, 2, 3, 1)[0].numpy()
    np.testing.assert_array_equal(got, ref)
    naive = (acc.astype(np.float32) * np.asarray(scale) + b).astype(np.float32)
    fma = ic.fma_f32(at.float(), scale.reshape(1, -1, 1, 1), torch.from_numpy(b).reshape(1, -1, 1, 1))
    assert (fma.permute(0, 2, 3, 1)[0].numpy() != naive).mean() > 0.01  # the FMA shows


def test_fma_f32_rounds_once_on_planted_ties():
    """a * b + c exactly halfway between two f32 values in f64, with a
    nonzero remainder below f64's precision: one rounding goes to the
    nearer side, a second rounding of the f64 sum would tie to even."""
    from fractions import Fraction

    a = torch.tensor([1 + 2.0**-23, 3.0, 1 + 2.0**-23, -(1 + 2.0**-23), 7.25], dtype=torch.float32)
    b = torch.tensor([1 + 2.0**-23, 5.0, 1 - 2.0**-24, 1 + 2.0**-23, -0.5], dtype=torch.float32)
    c = torch.tensor([2.0**-25, 2.0**-70, -2.0**-24, -2.0**-25, 1e-30], dtype=torch.float32)
    got = ic.fma_f32(a, b, c)
    for i in range(a.numel()):
        exact = Fraction(a[i].item()) * Fraction(b[i].item()) + Fraction(c[i].item())
        lo = torch.tensor(float(exact), dtype=torch.float32)
        cands = [torch.nextafter(lo, torch.tensor(-1e38)), lo, torch.nextafter(lo, torch.tensor(1e38))]
        best = min(cands, key=lambda v: (abs(Fraction(v.item()) - exact),
                                         int(v.view(torch.int32)) & 1))
        assert got[i].item() == best.item(), (i, got[i].item(), best.item())


def test_quantize_i8_plain_matches_jax_on_ties_and_saturation():
    s = np.float32(0.25)
    x = np.array([0.125, 0.375, -0.125, -0.375, 0.625, 31.75, 31.875, 40.0, -40.0, -31.875,
                  0.0, -0.0, 1e-9], np.float32)  # x / s: ties at .5, +-127, beyond
    ref = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / jnp.float32(s))), -127, 127)
                     .astype(jnp.int8))
    got = ic.quantize_i8(torch.from_numpy(x), float(s))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.tolist()[:10] == [0, 2, 0, -2, 2, 127, 127, 127, -127, -127]
    # the reciprocal is one f32 value: x * (1/s) differs from x / s here
    s3 = np.float32(0.3)
    assert ic.recip_f32(s3) == float(np.float32(1) / s3)


# -- the port's own envelopes (tests/test_quantize.py:15-111) ----------------
def _port_fp(cfg, x):
    params = tr.fold_bn(tr.init_params(torch.Generator().manual_seed(0), cfg), cfg)
    with torch.inference_mode():
        fp = tr.forward(params, x, cfg, folded=True)
    return params, fp


def test_port_int8_forward_close_to_fp():
    cfg = tr.DeeperCutConfig(compute_dtype=torch.float32, **TINY_KW)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 64, 64).astype(np.float32) * 40)
    params, ref = _port_fp(cfg, x)
    qp, sc = tq.prepare_int8(params, cfg, x)
    got = tq.forward_int8(qp, sc, x, cfg)
    assert got["prob"].shape == ref["prob"].shape
    a, b = ref["fc_pose"].reshape(-1).numpy(), got["fc_pose"].reshape(-1).numpy()
    assert np.corrcoef(a, b)[0, 1] > 0.99
    assert np.abs(a - b).mean() / (np.abs(a).mean() + 1e-6) < 0.1


@pytest.mark.parametrize("option", ["int8_residual", "int8_deconv"])
def test_port_int8_options_stay_in_the_envelope(option):
    cfg = tr.DeeperCutConfig(compute_dtype=torch.float32, **dict(PAIR_KW))
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 3, 64, 64).astype(np.float32) * 20)
    params, fp = _port_fp(cfg, x)
    qp, sc = tq.prepare_int8(params, cfg, x, quantize_deconv=True)
    assert qp["res5c_up_pose"]["w_q"].dtype == torch.int8 and "w" in qp["res5c_up_pose"]
    e_plain = (tq.forward_int8(qp, sc, x, cfg)["prob"] - fp["prob"]).abs().max()
    e_opt = (tq.forward_int8(qp, sc, x, cfg, **{option: True})["prob"] - fp["prob"]).abs().max()
    assert e_opt < max(2.5 * float(e_plain), 0.15), (e_opt, e_plain)


def test_port_percentile_calibration_rescues_a_poisoned_batch():
    cfg = tr.DeeperCutConfig(compute_dtype=torch.float32, **TINY_KW)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 64, 64).astype(np.float32) * 40)
    params, fp = _port_fp(cfg, x)
    _, sc_abs = tq.prepare_int8(params, cfg, x)
    qp, sc_pct = tq.prepare_int8(params, cfg, x, percentile=99.9)
    for k in sc_abs:
        assert sc_pct[k] <= sc_abs[k] * (1 + 1e-6), k

    def err(sc):
        return float((tq.forward_int8(qp, sc, x, cfg)["prob"] - fp["prob"]).abs().max())
    assert err(sc_pct) < max(2.5 * err(sc_abs), 0.15)
    x_cal = x.clone()
    x_cal[0, :, 0, 0] = 4000.0  # one insane pixel inflates every absmax downstream
    _, sc_out_abs = tq.prepare_int8(params, cfg, x_cal)
    _, sc_out_pct = tq.prepare_int8(params, cfg, x_cal, percentile=99.9)
    assert sc_out_pct["conv1"] < sc_out_abs["conv1"] / 10
    assert err(sc_out_pct) < err(sc_out_abs)
