"""int8 serving: post-training quantization of the folded model, in PyTorch.

Counterpart of `deepcut_tpu.models.quantize`, with its names, signatures
and numerics:

- weights: per-output-channel absmax symmetric int8, ``round(w / s)`` (a
  division), a zero channel getting scale 1 (`quantize_weights`); conv1
  stays float (a 3-channel int8 conv gains nothing), and so do the
  transposed-conv heads unless ``quantize_deconv``;
- activations: a static scale per conv input from one f32 calibration
  forward (`calibrate_act_scales`): the absmax, or a percentile of a
  subsample, over 127, floored at 1e-8; quantized by the f32 reciprocal;
- each int8 conv accumulates in int32, is dequantized in its epilogue
  (``acc * (s_x * w_scale) + b``), rounded to ``cfg.compute_dtype``, takes
  its residual and ReLU and is requantized for the next conv
  (`ops.int8_conv`).

``int8_residual`` keeps the residual stream int8 (each block boundary
quantized once at its own calibrated scale, ``res{block}#out``) and
``int8_deconv`` quantizes the transposed-conv heads too, as in the JAX
package. Tensors are NCHW (channels_last on the card) and weights in the
port's layouts: int8 conv weights OIHW, the int8 deconv ``(Cin, Cout, kh,
kw)``; `models.convert.qparams_from_numpy` carries the JAX package's
``(qparams, act_scales)`` across.

`DeeperCutInt8` holds a quantization as an ``nn.Module``: the int8 weights
as buffers packed once for the GEMM, the per-channel dequantization scales
``s_x * w_scale`` and the activation scales. It exposes `fused_heads` and
`forward` as `models.resnet.DeeperCut` does, so `pose.estimate` serves
either model the same way, row-sharded too (``rows``,
`parallel.spatial.RowShards`): each trunk conv reads its halo rows (int8
rows for the int8 convs, whose im2col then pads W alone), the stem pool
its -inf halo, and the heads, the int8 deconv included, run on the
gathered taps.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from deepcut_tpu_torch.models.resnet import (
    DeeperCutConfig, Params, _block_names, _head_list, _skip_block, fold_bn, local_conv,
    local_pool, prepare_input)
from deepcut_tpu_torch.ops.activations import relu, sigmoid
from deepcut_tpu_torch.ops.conv import (
    conv2d, conv2d_f32, conv2d_rounded, deconv2d, deconv2d_rounded)
from deepcut_tpu_torch.ops.eltwise import crop_like
from deepcut_tpu_torch.ops.int8_conv import (
    conv_i8, fma_f32, int8_epilogue, pack_conv_weight, pack_deconv_weight, quantize_i8)
from deepcut_tpu_torch.ops.pool import max_pool2d

DECONV_PREFIX = "res5c_up_"
# calibration subsamples activations above this many elements (the JAX
# package's `a[::max(n // 65536, 1)]`)
SUBSAMPLE = 65536


def quantize_weights(folded_params: Mapping, *, quantize_deconv: bool = False) -> Params:
    """Folded (w, b) params -> {w_q int8, w_scale (Cout,) f32, b} per conv.
    conv1, entries without a 4-D ``w`` and, unless ``quantize_deconv``,
    the deconv heads are copied as they are; a quantized deconv keeps its
    float ``w`` beside ``w_q`` so that the same dict serves both head
    variants."""
    out: Params = {}
    for name, entry in folded_params.items():
        deconv = name.startswith(DECONV_PREFIX)
        if ((deconv and not quantize_deconv) or name == "conv1"
                or "w" not in entry or entry["w"].dim() != 4):
            out[name] = dict(entry)
            continue
        # deconv (Cin, Cout, kh, kw), conv OIHW
        w_q, s = quantize_conv_weight(entry["w"], cout_dim=1 if deconv else 0)
        out[name] = {"w_q": w_q, "w_scale": s,
                     "b": entry["b"].float() if "b" in entry else torch.zeros_like(s)}
        if deconv:
            out[name]["w"] = entry["w"]
    return out


def quantize_conv_weight(w: torch.Tensor, cout_dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """A 4-D weight -> (int8 ``round(w / s)`` clipped to +-127, the f32
    scales s (Cout,)): per output channel (dim `cout_dim`) absmax / 127, a
    zero channel getting scale 1."""
    w = w.float()
    s = w.abs().amax(dim=tuple(d for d in range(4) if d != cout_dim)) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    shape = [1, 1, 1, 1]
    shape[cout_dim] = -1
    return torch.clamp(torch.round(w / s.reshape(shape)), -127, 127).to(torch.int8), s


def act_scale(x: torch.Tensor, percentile: float = 100.0) -> torch.Tensor:
    """A conv input's static activation scale, an f32 0-d tensor on the CPU:
    its absmax (or, below 100, the `percentile` of a subsample of |x|) over
    127, floored at 1e-8. A 4-D NCHW input is read in NHWC order, as the
    JAX package's subsample reads it."""
    a = x.float().abs()
    a = (a.permute(0, 2, 3, 1) if a.dim() == 4 else a).reshape(-1)
    if percentile >= 100.0:
        v = a.max().cpu()
    else:
        v = percentile_f32(a[::max(a.numel() // SUBSAMPLE, 1)], percentile)
    return torch.clamp_min(v / 127.0, 1e-8)


def percentile_f32(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(a, q)`` (linear interpolation) of a 1-D f32 tensor,
    bit for bit, as XLA compiles it with q a runtime value: it folds
    ``(q / 100) * (n - 1)`` into ``q * f32((n - 1) * f32(1/100))`` and
    contracts the interpolation ``lo * (1 - w) + hi * w`` into
    ``fma(hi, w, lo * (1 - w))`` (read on the CPU over 500 random arrays
    and quantiles: this order matched every one, the plain order 419).
    ``torch.quantile`` differs by up to ~20 ulp. NaN-free input. An f32
    0-d tensor on the CPU."""
    f = np.float32
    n = a.numel()
    qq = f(f(q) * f(f(n - 1) * f(f(1) / f(100))))
    low, high = np.floor(qq), np.ceil(qq)
    hw = f(qq - low)
    lw = f(f(1) - hw)
    lo, hi = (int(np.clip(v, 0, n - 1)) for v in (low, high))
    vals = torch.sort(a.float()).values[[lo, hi]].cpu()
    return fma_f32(vals[1:], float(hw), vals[:1] * float(lw))[0]


def calibrate_act_scales(folded_params: Mapping, cfg: DeeperCutConfig, sample: torch.Tensor,
                         *, percentile: float = 100.0) -> Dict[str, torch.Tensor]:
    """One f32 forward over a calibration batch (N, 3, H, W), TF32 off,
    recording each conv input's absmax (or a subsampled percentile) ->
    {key: f32 0-d scale} under the JAX package's keys: every conv's name,
    ``res{block}#out`` per block end, ``res5c_up`` (the deconv input) and
    ``res3d_{head}`` per enabled head (one tensor, one value)."""
    scales: Dict[str, torch.Tensor] = {}

    def cbr(xf, name, *, stride=1, pad=0, dilation=1, act=True):
        scales[name] = act_scale(xf, percentile)
        p = folded_params[name]
        y = conv2d_f32(xf, p["w"], p.get("b"), stride=stride, pad=pad, dilation=dilation)
        return relu(y) if act else y

    y = cbr(sample.float(), "conv1", stride=2, pad=3)
    y = max_pool2d(y, kernel=3, stride=2)
    skip_name = _skip_block(cfg)
    for stage in range(4):
        s, d = cfg.stage_strides[stage], cfg.stage_dilations[stage]
        for bi, block in enumerate(_block_names(cfg, stage)):
            bs = s if bi == 0 else 1
            shortcut = cbr(y, f"res{block}_branch1", stride=bs, act=False) if bi == 0 else y
            z = cbr(y, f"res{block}_branch2a", stride=bs)
            z = cbr(z, f"res{block}_branch2b", pad=d, dilation=d)
            z = cbr(z, f"res{block}_branch2c", act=False)
            y = relu(shortcut + z)
            scales[f"res{block}#out"] = act_scale(y, percentile)  # the int8-resident stream boundary
    scales["res5c_up"] = scales[f"res{block}#out"]  # the deconv reads res5c
    for head, _ in _head_list(cfg, None):               # the skip convs read the tap
        scales[f"res3d_{head}"] = scales[f"res{skip_name}#out"]
    return scales


def prepare_int8(params: Mapping, cfg: DeeperCutConfig, sample: torch.Tensor, *,
                 quantize_deconv: bool = False, percentile: float = 100.0
                 ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """(folded or raw f32 params) -> (qparams, act_scales) for
    `forward_int8` / `DeeperCutInt8`. percentile < 100 (e.g. 99.9) clips
    calibration outliers: the few clipped values saturate at +-127 while
    the rest gain resolution."""
    folded = fold_bn(params, cfg) if any(k.startswith("bn") for k in params) else params
    scales = calibrate_act_scales(folded, cfg, sample, percentile=percentile)
    return quantize_weights(folded, quantize_deconv=quantize_deconv), scales


class _QConv(nn.Module):
    """One int8 conv: the packed weight, the dequantization scale
    ``s_x * w_scale`` (one f32 product, as the JAX package) and the bias,
    as buffers; the input scale s_x as a Python float."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, b: torch.Tensor, s_x: float,
                 *, deconv: bool = False):
        super().__init__()
        self.k = int(w_q.shape[2])
        self.cout = int(w_q.shape[1] if deconv else w_q.shape[0])
        self.s_x = s_x
        self.register_buffer("packed", pack_deconv_weight(w_q) if deconv else pack_conv_weight(w_q))
        self.register_buffer("scale", torch.tensor(s_x, dtype=torch.float32) * w_scale.float())
        self.register_buffer("bias", b.float().contiguous())

    def forward(self, x_q: torch.Tensor, *, stride=1, pad=0, dilation=1, lhs_dilation=1,
                rows=None, **epi):
        """rows (`parallel.spatial.RowShards`): x_q is a row block; its halo
        rows are fetched and the conv pads W alone."""
        if rows is not None:
            x_q = rows.halo(x_q, self.k, stride, pad, dilation)
            pad = (0, pad)
        acc = conv_i8(x_q, self.packed, self.cout, self.k, stride=stride, pad=pad,
                      dilation=dilation, lhs_dilation=lhs_dilation)
        return int8_epilogue(acc, self.scale, self.bias, **epi)


def _cat_qconv(convs: Sequence[_QConv], *, deconv: bool, weights: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The heads' per-head int8 convs concatenated along Cout: (packed,
    scale, bias), packed anew from the per-head int8 weights."""
    w = torch.cat(list(weights), dim=1 if deconv else 0)
    packed = pack_deconv_weight(w) if deconv else pack_conv_weight(w)
    return (packed, torch.cat([c.scale for c in convs]).contiguous(),
            torch.cat([c.bias for c in convs]).contiguous())


class DeeperCutInt8(nn.Module):
    """The quantized part detector (see the module docstring). qparams:
    `quantize_weights`'s dict in the port's layouts; act_scales: the
    calibration's {key: scale}. ``int8_residual`` and ``int8_deconv`` as in
    `forward_int8`, fixed at construction (they choose which scales
    dequantize which conv)."""

    def __init__(self, qparams: Mapping, act_scales: Mapping, cfg: DeeperCutConfig, *,
                 int8_residual: bool = False, int8_deconv: bool = False):
        super().__init__()
        self.cfg = cfg
        self.int8_residual = int8_residual
        self.int8_deconv = int8_deconv
        self.bf16 = cfg.compute_dtype == torch.bfloat16
        self.act_scales = {k: float(v) for k, v in act_scales.items()}
        s = self.act_scales
        p1 = qparams["conv1"]
        self.register_buffer("conv1_w", self._cdt(p1["w"]))
        self.register_buffer("conv1_b", p1["b"].float() if "b" in p1 else None)
        convs = {}
        s_in = s[f"res{_block_names(cfg, 0)[0]}_branch2a"]  # the int8 stream's first scale
        for stage in range(4):
            for bi, block in enumerate(_block_names(cfg, stage)):
                for br in (("branch1",) if bi == 0 else ()) + ("branch2a", "branch2b", "branch2c"):
                    name = f"res{block}_{br}"
                    p = qparams[name]
                    # the int8 stream dequantizes branch1 / branch2a at its own scale
                    s_x = s_in if int8_residual and br in ("branch1", "branch2a") else s[name]
                    convs[name] = _QConv(p["w_q"], p["w_scale"], p["b"], s_x)
                s_in = s[f"res{block}#out"]
        self.convs = nn.ModuleDict(convs)
        heads = {}
        for head, _ in _head_list(cfg, None):
            p = qparams[f"res3d_{head}"]
            heads[f"res3d_{head}"] = _QConv(p["w_q"], p["w_scale"], p["b"], s[f"res3d_{head}"])
            p = qparams[f"{DECONV_PREFIX}{head}"]
            if int8_deconv:
                heads[f"{DECONV_PREFIX}{head}"] = _QConv(p["w_q"], p["w_scale"], p["b"],
                                                         s["res5c_up"], deconv=True)
        self.heads = nn.ModuleDict(heads)
        # the per-head int8 weights, kept to pack a subset's concatenation;
        # the float deconv weights (rounded to the compute dtype) otherwise
        frozen = lambda t: nn.Parameter(t, requires_grad=False)  # noqa: E731
        self.head_w = nn.ParameterDict({
            n: frozen(qparams[n]["w_q"] if (n.startswith("res3d_") or int8_deconv)
                      else self._cdt(qparams[n]["w"]))
            for head, _ in _head_list(cfg, None)
            for n in (f"res3d_{head}", f"{DECONV_PREFIX}{head}")})
        self.head_b = nn.ParameterDict({
            n: frozen(qparams[n]["b"].float()) for n in self.head_w if n.startswith(DECONV_PREFIX)})
        self._packs: Dict[Tuple[str, ...], tuple] = {}

    def _cdt(self, w: torch.Tensor) -> torch.Tensor:
        """A float weight as the convs take it: bf16 values in f32 for bf16."""
        w = w.float()
        return w.to(torch.bfloat16).float() if self.bf16 else w

    def _apply(self, fn, recurse=True):
        self._packs = {}
        return super()._apply(fn, recurse)

    def _head_pack(self, names: Tuple[str, ...]):
        """(skip conv pack, deconv pack or float (w, b)) for a head subset."""
        if names not in self._packs:
            sk = _cat_qconv([self.heads[f"res3d_{n}"] for n in names], deconv=False,
                            weights=[self.head_w[f"res3d_{n}"] for n in names])
            ups = [f"{DECONV_PREFIX}{n}" for n in names]
            if self.int8_deconv:
                up = _cat_qconv([self.heads[u] for u in ups], deconv=True,
                                weights=[self.head_w[u] for u in ups])
            else:
                up = (torch.cat([self.head_w[u] for u in ups], dim=1),
                      torch.cat([self.head_b[u] for u in ups]))
            self._packs[names] = (sk, up)
        return self._packs[names]

    # -- the forward ----------------------------------------------------------
    def _stem(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """bf16 conv1 (+ ReLU) and the pool, as the float serving forward."""
        x = prepare_input(x).to(self.cfg.compute_dtype).float()
        conv = local_conv if rows is None else rows.conv
        if self.bf16:
            y = conv(conv2d_rounded, x, self.conv1_w, self.conv1_b, stride=2, pad=3, relu=True)
        else:
            y = relu(conv(conv2d, x, self.conv1_w, self.conv1_b, stride=2, pad=3,
                          compute_dtype=torch.float32))
        return local_pool(y) if rows is None else rows.pool(y)

    def run_trunk(self, x: torch.Tensor, rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(res5c, skip tap), f32 (bf16 values in the bf16 config). rows: x
        is a row block (`parallel.spatial.RowShards`); both taps come back
        gathered."""
        y = self._stem(x, rows)
        trunk = self._trunk_int8_stream if self.int8_residual else self._trunk
        res5c, skip = trunk(y, rows)
        if rows is not None:
            res5c, skip = rows.gather(res5c), rows.gather(skip)
        return res5c, skip

    def _trunk(self, y: torch.Tensor, rows=None):
        """The block ends stay float; each is quantized once per distinct
        scale of the convs that read it, in the epilogue that writes it
        where it can."""
        cfg, cv, bf = self.cfg, self.convs, self.bf16
        blocks = [(stage, bi, block) for stage in range(4)
                  for bi, block in enumerate(_block_names(cfg, stage))]
        quantized = {}  # input scale -> y quantized at it

        def q(scale):
            if scale not in quantized:
                quantized[scale] = quantize_i8(y, scale)
            return quantized[scale]

        skip, skip_name = None, _skip_block(cfg)
        for idx, (stage, bi, block) in enumerate(blocks):
            bs = cfg.stage_strides[stage] if bi == 0 else 1
            d = cfg.stage_dilations[stage]
            c2a, c2b, c2c = (cv[f"res{block}_branch2{x}"] for x in "abc")
            if bi == 0:
                c1 = cv[f"res{block}_branch1"]
                shortcut, _ = c1(q(c1.s_x), stride=bs, bf16=bf, rows=rows)
            else:
                shortcut = y
            _, z = c2a(q(c2a.s_x), stride=bs, relu=True, bf16=bf, f32_out=False,
                       requant_s=c2b.s_x, rows=rows)
            _, z = c2b(z, pad=d, dilation=d, relu=True, bf16=bf, f32_out=False,
                       requant_s=c2c.s_x, rows=rows)
            nxt = (cv[f"res{blocks[idx + 1][2]}_branch2a"].s_x if idx + 1 < len(blocks)
                   else None)
            y, y_q = c2c(z, residual=shortcut, relu=True, bf16=bf, requant_s=nxt)
            quantized = {nxt: y_q} if nxt is not None else {}
            if block == skip_name:
                skip = y
        return y, skip

    def _trunk_int8_stream(self, y: torch.Tensor, rows=None):
        """``int8_residual``: each block boundary is quantized once, at its
        calibrated ``res{block}#out`` scale, and read as int8 by the next
        block's convs and its identity shortcut."""
        cfg, cv, bf, s = self.cfg, self.convs, self.bf16, self.act_scales
        s_y = s[f"res{_block_names(cfg, 0)[0]}_branch2a"]
        y_q = quantize_i8(y, s_y)  # the stem's output, quantized once
        skip, skip_name = None, _skip_block(cfg)
        for stage in range(4):
            d = cfg.stage_dilations[stage]
            for bi, block in enumerate(_block_names(cfg, stage)):
                bs = cfg.stage_strides[stage] if bi == 0 else 1
                c2a, c2b, c2c = (cv[f"res{block}_branch2{x}"] for x in "abc")
                if bi == 0:
                    res, res_scale = cv[f"res{block}_branch1"](y_q, stride=bs, bf16=bf,
                                                               rows=rows)[0], None
                else:
                    res, res_scale = y_q, s_y  # y_q * s_y + z, one rounding
                _, z = c2a(y_q, stride=bs, relu=True, bf16=bf, f32_out=False,
                           requant_s=c2b.s_x, rows=rows)
                _, z = c2b(z, pad=d, dilation=d, relu=True, bf16=bf, f32_out=False,
                           requant_s=c2c.s_x, rows=rows)
                s_y = s[f"res{block}#out"]
                _, y_q = c2c(z, residual=res, residual_scale=res_scale, relu=True, bf16=bf,
                             f32_out=False, requant_s=s_y)
                if block == skip_name:
                    skip = y_q.float() * s_y
        return y_q.float() * s_y, skip

    def fused_heads(self, x: torch.Tensor, heads: Optional[Sequence[str]] = None, rows=None
                    ) -> torch.Tensor:
        """The trunk and the enabled heads (one deconv over res5c, one int8
        1x1 skip conv, summed in f32 after the top-left crop): the unsliced
        f32 (N, C, h, w) map, as `DeeperCut.fused_heads`; rows as
        `run_trunk` (the heads run on the gathered grid)."""
        res5c, skip = self.run_trunk(x, rows)
        names = tuple(n for n, _ in _head_list(self.cfg, heads))
        (sk_packed, sk_scale, sk_bias), up_pack = self._head_pack(names)
        cout = sk_scale.shape[0]
        if self.int8_deconv:
            packed, scale, bias = up_pack
            s_up = self.act_scales["res5c_up"]
            acc = conv_i8(quantize_i8(res5c, s_up), packed, cout, 3, pad=2, lhs_dilation=2)
            up, _ = int8_epilogue(acc, scale, bias, bf16=self.bf16)
        elif self.bf16:
            up = deconv2d_rounded(res5c.to(torch.bfloat16).float(), *up_pack, stride=2)
        else:
            up = deconv2d(res5c, *up_pack, stride=2, compute_dtype=torch.float32)
        s_sk = self.act_scales[f"res3d_{names[0]}"]  # the heads share one input scale
        acc = conv_i8(quantize_i8(skip, s_sk), sk_packed, cout, 1)
        fused, _ = int8_epilogue(acc, sk_scale, sk_bias, crop_like(up, acc.shape, axis=2),
                                 bf16=False)
        return fused

    def forward(self, x: torch.Tensor, heads: Optional[Sequence[str]] = None, rows=None
                ) -> Dict[str, torch.Tensor]:
        """{'fc_pose', 'prob' (f32 sigmoid), 'loc_pred', 'next_pred' as
        computed}: f32 contiguous NCHW maps, as `DeeperCut.forward`."""
        fused = self.fused_heads(x, heads, rows)
        names = {"pose": "fc_pose", "locref": "loc_pred", "next": "next_pred"}
        outs: Dict[str, torch.Tensor] = {}
        off = 0
        for n, ch in _head_list(self.cfg, heads):
            outs[names[n]] = fused[:, off:off + ch].contiguous()
            off += ch
        outs["prob"] = sigmoid(outs["fc_pose"])
        return outs


def forward_int8(qparams: Mapping, act_scales: Mapping, x: torch.Tensor,
                 cfg: DeeperCutConfig = DeeperCutConfig(), *, int8_residual: bool = False,
                 int8_deconv: bool = False, heads: Optional[Sequence[str]] = None
                 ) -> Dict[str, torch.Tensor]:
    """The quantized forward over a mean-subtracted (N, 3, H, W) batch (or a
    uint8 one): `DeeperCutInt8` built for this call on x's device."""
    model = DeeperCutInt8(qparams, act_scales, cfg, int8_residual=int8_residual,
                          int8_deconv=int8_deconv).to(x.device)
    with torch.inference_mode():
        return model(x, heads)
