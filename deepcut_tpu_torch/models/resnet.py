"""DeeperCut part detector: the dilated fully-convolutional ResNet, in PyTorch.

Counterpart of `deepcut_tpu.models.resnet`: conv1 7x7/2 -> BN/Scale/ReLU ->
maxpool 3x3/2 (ceil) -> res2 .. res4 bottlenecks -> res5 (stride removed,
3x3 convs dilated by 2) -> the deconv heads off res5c fused with 1x1 skip
convs off res3b7 by a top-left crop and a sum. Output stride 8.

Parameters are a dict keyed by the prototxt's Caffe layer names, each entry
a dict of tensors in PyTorch layout (conv OIHW, deconv
``(Cin, Cout, kh, kw)``); `models.convert.params_from_numpy` maps the JAX
package's layouts onto it. `DeeperCut` holds such a dict as an
``nn.Module``; tensors are NCHW (``channels_last`` memory on the card).

As in the JAX package's serving path, the folded forward runs the trunk in
``cfg.compute_dtype`` (bf16) with weights pre-cast and f32 biases, and the
heads come out in f32 with the sigmoid in f32. With bf16 it rounds where
the JAX package rounds: activations and weights hold bf16 values in f32
tensors, each conv sums exact products in f32 and its epilogue
(`ops.conv_epilogue`) adds the f32 bias and rounds once, then adds the
residual (rounded again) and applies ReLU (`ops.conv.conv2d_rounded`). The unfolded forward is the
training one: f32 (or bf16 convs under ``mixed_train``), BN statistics
held constant, optional per-stage recompute (``remat``). Note the geometry traps:
the stride sits on the 1x1 ``branch2a`` / ``branch1`` convs (not the 3x3 as
in torchvision), and res5's 3x3 convs use dilation 2 with pad 2.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepcut_tpu_torch.constants import MEAN_BGR
from deepcut_tpu_torch.ops.activations import relu, sigmoid
from deepcut_tpu_torch.ops import conv3x3
from deepcut_tpu_torch.ops.conv import conv2d, conv2d_rounded, deconv2d, deconv2d_rounded
from deepcut_tpu_torch.ops.eltwise import crop_like
from deepcut_tpu_torch.ops.norm import bn_scale_affine, scaled_stats
from deepcut_tpu_torch.ops.pool import max_pool2d

Params = Dict[str, Dict[str, torch.Tensor]]


def prepare_input(x: torch.Tensor) -> torch.Tensor:
    """A uint8 BGR batch (N, 3, H, W) is converted and mean-subtracted on
    its device; a float batch is taken as already mean-subtracted."""
    if x.dtype == torch.uint8:
        mean = torch.tensor(MEAN_BGR, dtype=torch.float32, device=x.device)
        return x.float() - mean.reshape(1, 3, 1, 1)
    return x


@dataclasses.dataclass(frozen=True)
class DeeperCutConfig:
    """Model family config. Defaults = the reference ResNet-152 part detector."""

    depths: Tuple[int, ...] = (3, 8, 36, 3)
    stage_widths: Tuple[int, ...] = (64, 128, 256, 512)
    # Per-stage (stride, dilation): res5's stride is removed and its 3x3
    # convs dilated by 2.
    stage_strides: Tuple[int, ...] = (1, 2, 2, 1)
    stage_dilations: Tuple[int, ...] = (1, 1, 1, 2)
    num_joints: int = 14
    location_refinement: bool = True
    pairwise: bool = True
    # "letters" (res3b, res3c...) for ResNet-50, "numbered" (res3b1...) for 101/152.
    naming: str = "numbered"
    bn_eps: float = 1e-5
    compute_dtype: torch.dtype = torch.bfloat16
    # Recompute residual blocks in the backward pass instead of keeping
    # their activations: True/False for every/no stage, or a 4-tuple of
    # bools for res2..res5.
    remat: Any = False
    # Mixed-precision training: the unfolded forward runs its convs in
    # compute_dtype (bf16) while params, BN statistics, losses and updates
    # stay f32. The reference trains pure f32; leave False for its
    # trajectories.
    mixed_train: bool = False

    @property
    def stride(self) -> int:
        return 8

    @property
    def locref_channels(self) -> int:
        return 2 * self.num_joints

    @property
    def pairwise_channels(self) -> int:
        return self.num_joints * (self.num_joints - 1) * 2


RESNET_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def deepercut_config(resnet_depth: int = 152, **kw) -> DeeperCutConfig:
    naming = "letters" if resnet_depth == 50 else "numbered"
    return DeeperCutConfig(depths=RESNET_DEPTHS[resnet_depth], naming=naming, **kw)


def _block_names(cfg: DeeperCutConfig, stage: int) -> List[str]:
    """Caffe/MSRA block names for stage index (0-based; stage label = idx+2)."""
    n = cfg.depths[stage]
    label = stage + 2
    if cfg.naming == "letters" or n <= 3:
        return [f"{label}{chr(ord('a') + i)}" for i in range(n)]
    return [f"{label}a"] + [f"{label}b{i}" for i in range(1, n)]


def _skip_block(cfg: DeeperCutConfig) -> Optional[str]:
    """The stride-8 skip tap: last block of stage 3 (res3b7 in ResNet-152)."""
    names = _block_names(cfg, 1)
    return names[-1] if names else None


def _head_channels(cfg: DeeperCutConfig) -> List[Tuple[str, int]]:
    heads = [("pose", cfg.num_joints)]
    if cfg.location_refinement:
        heads.append(("locref", cfg.locref_channels))
    if cfg.pairwise:
        heads.append(("next", cfg.pairwise_channels))
    return heads


# --------------------------------------------------------------------------
# Parameter initialisation (Caffe filler semantics)
# --------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: DeeperCutConfig = DeeperCutConfig()) -> Params:
    """Random init mirroring the reference's filler choices: MSRA convs,
    gaussian std-0.01 heads with zero bias, identity BN statistics. f32 on
    the CPU. The numbers differ from the JAX package's `jax.random` init;
    parity tests feed both packages the same numpy params instead."""
    params: Params = {}

    def normal(shape, std):
        return std * torch.randn(shape, generator=generator, dtype=torch.float32)

    def add_conv(name, kh, kw, cin, cout):
        params[name] = {"w": normal((cout, cin, kh, kw), math.sqrt(2.0 / (kh * kw * cin)))}

    def add_bn_scale(suffix, c):
        params[f"bn{suffix}"] = {"mean": torch.zeros(c), "var": torch.ones(c),
                                 "scale_factor": torch.ones(1)}
        params[f"scale{suffix}"] = {"gamma": torch.ones(c), "beta": torch.zeros(c)}

    add_conv("conv1", 7, 7, 3, 64)
    add_bn_scale("_conv1", 64)
    cin = 64
    for stage in range(4):
        width = cfg.stage_widths[stage]
        cout = 4 * width
        for bi, block in enumerate(_block_names(cfg, stage)):
            if bi == 0:
                add_conv(f"res{block}_branch1", 1, 1, cin, cout)
                add_bn_scale(f"{block}_branch1", cout)
            add_conv(f"res{block}_branch2a", 1, 1, cin if bi == 0 else cout, width)
            add_bn_scale(f"{block}_branch2a", width)
            add_conv(f"res{block}_branch2b", 3, 3, width, width)
            add_bn_scale(f"{block}_branch2b", width)
            add_conv(f"res{block}_branch2c", 1, 1, width, cout)
            add_bn_scale(f"{block}_branch2c", cout)
        cin = cout

    skip_c = 4 * cfg.stage_widths[1]  # stride-8 tap channels (512)
    top_c = 4 * cfg.stage_widths[3]   # res5 output channels (2048)
    for head, ch in _head_channels(cfg):
        params[f"res5c_up_{head}"] = {"w": normal((top_c, ch, 3, 3), 0.01),
                                      "b": torch.zeros(ch)}
        params[f"res3d_{head}"] = {"w": normal((ch, skip_c, 1, 1), 0.01),
                                   "b": torch.zeros(ch)}
    return params


# --------------------------------------------------------------------------
# BN/Scale folding — the inference path
# --------------------------------------------------------------------------


def cast_params(params: Params, dtype: torch.dtype = torch.bfloat16) -> Params:
    """Pre-cast conv weights to the compute dtype once at load; biases and
    every other entry stay as they are (f32)."""
    return {name: {k: (v.to(dtype) if k == "w" else v) for k, v in p.items()}
            for name, p in params.items()}


def _bn_key(name: str, params: Params) -> Optional[str]:
    """The BN/Scale suffix that follows conv `name`, or None (the heads)."""
    if name == "conv1":
        return "_conv1"
    if name.startswith("res") and f"bn{name[len('res'):]}" in params:
        return name[len("res"):]
    return None


def fold_bn(params: Params, cfg: DeeperCutConfig = DeeperCutConfig()) -> Params:
    """Fold each conv's trailing BatchNorm+Scale into (w, b).

    y = gamma * (conv(x, w) - mean/s) * rsqrt(var/s + eps) + beta
      = conv(x, w * g) + (beta - mean/s * g),   g = gamma * rsqrt(var/s + eps)

    A scale factor s of 0 gives zero statistics, as in Caffe."""
    folded: Params = {}
    for name, p in params.items():
        if name.startswith("bn") or name.startswith("scale"):
            continue
        key = _bn_key(name, params)
        if key is None or f"bn{key}" not in params:
            folded[name] = dict(p)
            continue
        bn, sc = params[f"bn{key}"], params[f"scale{key}"]
        mean, var = scaled_stats(bn["mean"], bn["var"], bn.get("scale_factor"))
        g = sc["gamma"] * torch.rsqrt(var + cfg.bn_eps)
        b = p["b"] if "b" in p else torch.zeros_like(g)
        folded[name] = {"w": p["w"] * g.reshape(-1, 1, 1, 1),
                        "b": b + sc["beta"] - mean * g}
    return folded


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def _stop_gradient(t: torch.Tensor) -> torch.Tensor:
    return t.detach() if t.requires_grad else t


def _rounds_once(cfg: DeeperCutConfig, folded: bool) -> bool:
    """The folded bf16 serving forward: `conv2d_rounded` convs, one rounding
    after each f32 bias add as in the JAX package."""
    return folded and cfg.compute_dtype == torch.bfloat16


def local_conv(op, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, **kw
               ) -> torch.Tensor:
    """The trunk's default conv hook: the conv `op` over the whole input."""
    return op(x, w, b, **kw)


def local_pool(y: torch.Tensor) -> torch.Tensor:
    """The trunk's default pool hook: the stem's 3x3/2 ceil-mode max pool."""
    return max_pool2d(y, kernel=3, stride=2)


def _cbr(params: Mapping, x: torch.Tensor, name: str, cfg: DeeperCutConfig, cdt,
         folded: bool, *, stride=1, pad=0, dilation=1, act=True,
         residual: Optional[torch.Tensor] = None, conv_fn=local_conv) -> torch.Tensor:
    """conv [+ BN/Scale] [+ residual] [+ ReLU]; a residual only on the
    `_rounds_once` path, where the epilogue adds it. conv_fn(op, x, w, b,
    **geometry) runs the conv op (see `run_trunk`)."""
    p = params[name]
    if _rounds_once(cfg, folded):
        return conv_fn(conv2d_rounded, x, p["w"], p.get("b"), stride=stride, pad=pad,
                       dilation=dilation, residual=residual, relu=act)
    y = conv_fn(conv2d, x, p["w"], p["b"] if "b" in p else None, stride=stride,
                pad=pad, dilation=dilation, compute_dtype=cdt)
    if not folded:
        key = _bn_key(name, params)
        bn, sc = params[f"bn{key}"], params[f"scale{key}"]
        # BN statistics are constants under autodiff (the prototxt pins all
        # three BatchNorm blobs at lr_mult 0); Scale's gamma/beta train.
        y = bn_scale_affine(y, _stop_gradient(bn["mean"]), _stop_gradient(bn["var"]),
                            _stop_gradient(bn["scale_factor"]) if "scale_factor" in bn else None,
                            sc["gamma"], sc["beta"] if "beta" in sc else None,
                            eps=cfg.bn_eps)
    return relu(y) if act else y


def _compute_dtype(cfg: DeeperCutConfig, folded: bool) -> Optional[torch.dtype]:
    """The conv dtype: ``cfg.compute_dtype`` when folded (serving) or under
    ``mixed_train``; None (the input's own f32) for the reference training."""
    return cfg.compute_dtype if (folded or cfg.mixed_train) else None


def _stage_remat(cfg: DeeperCutConfig, stage: int) -> bool:
    return bool(cfg.remat[stage]) if isinstance(cfg.remat, (tuple, list)) else bool(cfg.remat)


def run_trunk(params: Mapping, x: torch.Tensor, cfg: DeeperCutConfig, *,
              folded: bool = False, conv_fn=local_conv, pool_fn=local_pool
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """conv1 .. res5c over a mean-subtracted (N, 3, H, W) batch (or a uint8
    one, see `prepare_input`). Returns (res5c, skip tap). Under autodiff a
    block of a ``cfg.remat`` stage is recomputed in the backward pass
    (`torch.utils.checkpoint`) instead of keeping its activations.

    Generic over where the convs and the stem pool run, as the JAX
    package's: ``conv_fn(op, x, w, b, *, stride, pad, dilation, **kw)``
    applies the conv `op` (`ops.conv.conv2d`, or `conv2d_rounded` on the
    serving path) with Caffe's geometry, and ``pool_fn(y)`` is the stem's
    3x3/2 ceil-mode max pool. The defaults run them on the whole input;
    the row-sharded paths (`parallel.spatial.RowShards`) fetch halo rows
    first, so the same block code runs on a block of the image rows."""
    cdt = _compute_dtype(cfg, folded)
    x = prepare_input(x).to(cdt or torch.float32)
    rounded = _rounds_once(cfg, folded)
    if rounded:
        x = x.float()  # bf16 values in f32, the operand the serving convs take
    cbr = functools.partial(_cbr, conv_fn=conv_fn)
    y = cbr(params, x, "conv1", cfg, cdt, folded, stride=2, pad=3)
    y = pool_fn(y)
    skip, skip_name = None, _skip_block(cfg)
    for stage in range(4):
        s, d = cfg.stage_strides[stage], cfg.stage_dilations[stage]
        remat = _stage_remat(cfg, stage) and torch.is_grad_enabled()
        for bi, block in enumerate(_block_names(cfg, stage)):

            def one_block(y, block=block, bs=s if bi == 0 else 1, first=bi == 0, d=d):
                if first:
                    shortcut = cbr(params, y, f"res{block}_branch1", cfg, cdt, folded,
                                   stride=bs, act=False)
                else:
                    shortcut = y
                z = cbr(params, y, f"res{block}_branch2a", cfg, cdt, folded, stride=bs)
                z = cbr(params, z, f"res{block}_branch2b", cfg, cdt, folded, pad=d, dilation=d)
                if rounded:  # relu(shortcut + z) in branch2c's epilogue
                    return cbr(params, z, f"res{block}_branch2c", cfg, cdt, folded,
                               residual=shortcut)
                z = cbr(params, z, f"res{block}_branch2c", cfg, cdt, folded, act=False)
                return relu(shortcut + z)

            y = checkpoint(one_block, y, use_reentrant=False) if remat else one_block(y)
            if block == skip_name:
                skip = y
    return y, skip


def fused_heads(params: Mapping, res5c: torch.Tensor, skip: Optional[torch.Tensor],
                cfg: DeeperCutConfig, *, compute_dtype: Optional[torch.dtype] = None,
                heads: Optional[Sequence[str]] = None, folded: bool = False) -> torch.Tensor:
    """The enabled heads as ONE deconv (k3 s2 p0) over res5c plus ONE 1x1
    skip conv, over concatenated output channels, summed after a top-left
    crop of the upsampled map: the (N, C, h, w) map before it is sliced, in
    the channel order of `_head_channels` ("pose", "locref", "next").

    heads: optional subset of ("pose", "locref", "next"); "pose" is
    mandatory. On the `_rounds_once` path the sum is the skip conv's
    epilogue, with the cropped deconv output as its residual, and the map
    holds bf16 values in f32 (channels_last on the card); otherwise it is
    in the convs' dtype."""
    if skip is None:
        raise ValueError("compute_heads: the config has no stride-8 skip tap")
    head_list = _head_list(cfg, heads)
    up_p = [params[f"res5c_up_{n}"] for n, _ in head_list]
    sk_p = [params[f"res3d_{n}"] for n, _ in head_list]
    wup = torch.cat([p["w"] for p in up_p], dim=1)
    bup = torch.cat([p["b"] for p in up_p])
    wsk = torch.cat([p["w"] for p in sk_p], dim=0)
    bsk = torch.cat([p["b"] for p in sk_p])
    if _rounds_once(cfg, folded):
        up = deconv2d_rounded(res5c, wup, bup, stride=2)
        return conv2d_rounded(skip, wsk, bsk, residual=crop_like(up, skip.shape, axis=2))
    up = deconv2d(res5c, wup, bup, stride=2, compute_dtype=compute_dtype)
    sk = conv2d(skip, wsk, bsk, compute_dtype=compute_dtype)
    return crop_like(up, sk.shape, axis=2) + sk


def _head_list(cfg: DeeperCutConfig, heads: Optional[Sequence[str]]) -> List[Tuple[str, int]]:
    head_list = _head_channels(cfg)
    if heads is not None:
        head_list = [(n, ch) for n, ch in head_list if n in heads]
        if not any(n == "pose" for n, _ in head_list):
            raise ValueError("compute_heads: the 'pose' head is mandatory")
    return head_list


def compute_heads(params: Mapping, res5c: torch.Tensor, skip: Optional[torch.Tensor],
                  cfg: DeeperCutConfig, *, compute_dtype: Optional[torch.dtype] = None,
                  heads: Optional[Sequence[str]] = None,
                  folded: bool = False) -> Dict[str, torch.Tensor]:
    """`fused_heads`, sliced per head. Returns f32 contiguous NCHW maps:
    'fc_pose', 'prob' (sigmoid, in f32) and, when computed, 'loc_pred' and
    'next_pred'."""
    fused = fused_heads(params, res5c, skip, cfg, compute_dtype=compute_dtype, heads=heads,
                        folded=folded)
    names = {"pose": "fc_pose", "locref": "loc_pred", "next": "next_pred"}
    outs: Dict[str, torch.Tensor] = {}
    off = 0
    for n, ch in _head_list(cfg, heads):
        outs[names[n]] = fused[:, off:off + ch].to(
            torch.float32, memory_format=torch.contiguous_format)
        off += ch
    outs["prob"] = sigmoid(outs["fc_pose"])
    return outs


def forward(params: Mapping, x: torch.Tensor, cfg: DeeperCutConfig = DeeperCutConfig(), *,
            folded: bool = False, heads: Optional[Sequence[str]] = None,
            rows=None) -> Dict[str, torch.Tensor]:
    """The part detector over a Caffe-named param mapping. x: (N, 3, H, W)
    mean-subtracted BGR (or uint8). Returns the `compute_heads` dict; the
    h = ceil(H/8) grid of the reference.

    folded=True takes BN-folded params and computes in ``cfg.compute_dtype``
    (with bf16, rounding once per conv: module docstring). folded=False takes the raw params with BN/Scale entries: f32, or with
    ``cfg.mixed_train`` bf16 convs whose outputs round to bf16 before the
    bf16 bias add (the JAX package's mixed training).

    rows (`parallel.spatial.RowShards`): x is this rank's block of the image
    rows; the trunk runs on it with halo hooks and the heads on the
    gathered taps, every rank of the row group getting the whole maps."""
    if rows is None:
        res5c, skip = run_trunk(params, x, cfg, folded=folded)
    else:
        res5c, skip = run_trunk(params, x, cfg, folded=folded, conv_fn=rows.conv,
                                pool_fn=rows.pool)
        res5c, skip = rows.gather(res5c), rows.gather(skip)
    return compute_heads(params, res5c, skip, cfg, compute_dtype=_compute_dtype(cfg, folded),
                         heads=heads, folded=folded)


def make_forward(cfg: DeeperCutConfig = DeeperCutConfig(), *, folded: bool = True,
                 heads: Optional[Sequence[str]] = None):
    """The forward as a function ``(params, x) -> outputs`` (`forward` with
    `folded` and `heads` bound), the JAX package's entry. params and x are
    in this module's layouts (OIHW, NCHW).

    heads: optional head subset (see `compute_heads`): serving entry points
    that decode pose and locref only pass ("pose", "locref")."""

    def fn(params: Mapping, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return forward(params, x, cfg, folded=folded, heads=heads)

    return fn


# --------------------------------------------------------------------------
# The module
# --------------------------------------------------------------------------


def is_trainable(name: str) -> bool:
    """Every entry but the BatchNorm statistics (``bn*`` layers) trains."""
    return not name.startswith("bn")


class DeeperCut(nn.Module):
    """The part detector holding a Caffe-named param dict as ``nn.Parameter``s.

    folded=True takes BN-folded params (`fold_bn`, usually `cast_params`'d)
    and computes in ``cfg.compute_dtype``; folded=False takes the raw
    params with BN/Scale entries (see `forward`). Parameters are frozen
    unless trainable=True (unfolded only): then conv weights and biases and
    Scale's gamma/beta require grad, and the BN statistics never do."""

    def __init__(self, params: Params, cfg: DeeperCutConfig = DeeperCutConfig(),
                 *, folded: bool = True, trainable: bool = False):
        super().__init__()
        if trainable and folded:
            raise ValueError("DeeperCut: only the unfolded forward trains")
        self.cfg = cfg
        self.folded = folded
        if _rounds_once(cfg, folded):
            # the serving convs take bf16 values in f32: widened once here,
            # not per call
            params = {name: {k: (v.to(torch.bfloat16).float() if k == "w" else v)
                             for k, v in p.items()} for name, p in params.items()}
        self.layers = nn.ModuleDict({
            name: nn.ParameterDict({
                k: nn.Parameter(torch.as_tensor(v), requires_grad=trainable and is_trainable(name))
                for k, v in p.items()})
            for name, p in params.items()})
        self._view: Optional[Params] = None
        self._pack()

    def _apply(self, fn, recurse=True):
        self._view = None
        out = super()._apply(fn, recurse)
        self._pack()
        return out

    def _pack(self) -> None:
        """On the card, the serving forward's 3x3 weights packed for
        `ops.conv3x3` once, here, not per call (nor in a graph's capture)."""
        if _rounds_once(self.cfg, self.folded):
            conv3x3.warm(p["w"] for p in self.layers.values() if "w" in p)

    def param_dict(self) -> Params:
        """The parameters as a plain ``{layer: {key: Parameter}}`` dict (the
        live tensors, not copies)."""
        if self._view is None:
            self._view = {name: dict(p.items()) for name, p in self.layers.items()}
        return self._view

    def run_trunk(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return run_trunk(self.param_dict(), x, self.cfg, folded=self.folded)

    def compute_heads(self, res5c: torch.Tensor, skip: torch.Tensor,
                      heads: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
        return compute_heads(self.param_dict(), res5c, skip, self.cfg,
                             compute_dtype=_compute_dtype(self.cfg, self.folded), heads=heads,
                             folded=self.folded)

    def fused_heads(self, x: torch.Tensor, heads: Optional[Sequence[str]] = None
                    ) -> torch.Tensor:
        """The trunk and `fused_heads` over an input batch: the unsliced
        (N, C, h, w) head map, which the serving decode reads directly."""
        res5c, skip = self.run_trunk(x)
        return fused_heads(self.param_dict(), res5c, skip, self.cfg,
                           compute_dtype=_compute_dtype(self.cfg, self.folded), heads=heads,
                           folded=self.folded)

    def forward(self, x: torch.Tensor, heads: Optional[Sequence[str]] = None, rows=None
                ) -> Dict[str, torch.Tensor]:
        return forward(self.param_dict(), x, self.cfg, folded=self.folded, heads=heads,
                       rows=rows)
