"""The DeeperCut part detector as a deploy prototxt, written with `net_spec`.

`deepercut_deploy` lays out the dilated ResNet of `models.resnet` layer by
layer under the reference's Caffe names (conv1 / bn_conv1 / scale_conv1,
res2a_branch1 / bn2a_branch1 / scale2a_branch1, ..., res5c_up_pose,
res3d_pose), so that the graph engine (`core.graph.Net`) runs the same
network as the native `models.resnet.DeeperCut` and loads the same
``.caffemodel``:

- conv1 7x7/2 -> BatchNorm (global statistics) -> Scale -> ReLU -> max pool
  3x3/2;
- bottleneck blocks: a 1x1 ``branch1`` shortcut on each stage's first block,
  ``branch2a`` 1x1 (carrying the stage's stride) -> ``branch2b`` 3x3 (pad
  and dilation d: 2 in res5) -> ``branch2c`` 1x1, each with BatchNorm and
  Scale, an Eltwise sum and a ReLU; trunk convs have no bias;
- per head, a 3x3/2 Deconvolution over res5c and a 1x1 skip Convolution
  over the last res3 block, the deconv cropped to the skip's size at the
  top-left (Crop) and the two summed (Eltwise) into ``fc_pose`` /
  ``loc_pred`` / ``next_pred``; ``prob`` is the Sigmoid of ``fc_pose``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from deepcut_tpu_torch.models.resnet import (
    DeeperCutConfig, _block_names, _head_channels, _skip_block)
from deepcut_tpu_torch.net_spec import NetSpec, layers as L

HEAD_BLOBS = {"pose": "fc_pose", "locref": "loc_pred", "next": "next_pred"}


def _conv(bottom, cout: int, k: int, *, stride: int = 1, pad: int = 0, dilation: int = 1,
          bias: bool = False):
    cp = dict(num_output=cout, kernel_size=k, bias_term=bias)
    if stride != 1:
        cp["stride"] = stride
    if pad:
        cp["pad"] = pad
    if dilation != 1:
        cp["dilation"] = dilation
    return L.Convolution(bottom, convolution_param=cp)


def deepercut_deploy(cfg: DeeperCutConfig = DeeperCutConfig(),
                     input_shape: Tuple[int, int, int, int] = (1, 3, 688, 688),
                     heads: Optional[Sequence[str]] = None) -> NetSpec:
    """The deploy net of `cfg` over a mean-subtracted BGR ``data`` input of
    `input_shape`; `heads` a subset of ("pose", "locref", "next") (default:
    the config's)."""
    n = NetSpec()

    def cbs(name: str, suffix: str, bottom, cout, k, *, relu=True, **kw):
        """conv `name` -> bn`suffix` -> scale`suffix` [-> ReLU], in place."""
        setattr(n, name, _conv(bottom, cout, k, **kw))
        top = getattr(n, name)
        setattr(n, f"bn{suffix}", L.BatchNorm(
            top, batch_norm_param=dict(use_global_stats=True), in_place=True))
        setattr(n, f"scale{suffix}", L.Scale(top, scale_param=dict(bias_term=True),
                                             in_place=True))
        if relu:
            setattr(n, f"{name}_relu", L.ReLU(top, in_place=True))
        return top

    n.data = L.Input(input_param=dict(shape=dict(dim=list(input_shape))))
    x = cbs("conv1", "_conv1", n.data, 64, 7, stride=2, pad=3)
    n.pool1 = L.Pooling(x, pooling_param=dict(pool="MAX", kernel_size=3, stride=2))
    x, skip = n.pool1, None
    for stage in range(4):
        width, s, d = cfg.stage_widths[stage], cfg.stage_strides[stage], cfg.stage_dilations[stage]
        for bi, block in enumerate(_block_names(cfg, stage)):
            first = bi == 0
            shortcut = (cbs(f"res{block}_branch1", f"{block}_branch1", x, 4 * width, 1,
                            relu=False, stride=s) if first else x)
            z = cbs(f"res{block}_branch2a", f"{block}_branch2a", x, width, 1,
                    stride=s if first else 1)
            z = cbs(f"res{block}_branch2b", f"{block}_branch2b", z, width, 3, pad=d, dilation=d)
            z = cbs(f"res{block}_branch2c", f"{block}_branch2c", z, 4 * width, 1, relu=False)
            setattr(n, f"res{block}", L.Eltwise(shortcut, z))
            x = getattr(n, f"res{block}")
            setattr(n, f"res{block}_relu", L.ReLU(x, in_place=True))
            if block == _skip_block(cfg):
                skip = x
    for head, ch in _head_channels(cfg):
        if heads is not None and head not in heads:
            continue
        setattr(n, f"res5c_up_{head}", L.Deconvolution(
            x, convolution_param=dict(num_output=ch, kernel_size=3, stride=2)))
        setattr(n, f"res3d_{head}", _conv(skip, ch, 1, bias=True))
        setattr(n, f"res5c_up_{head}_crop", L.Crop(getattr(n, f"res5c_up_{head}"),
                                                   getattr(n, f"res3d_{head}")))
        setattr(n, HEAD_BLOBS[head], L.Eltwise(getattr(n, f"res3d_{head}"),
                                               getattr(n, f"res5c_up_{head}_crop")))
        if head == "pose":
            n.prob = L.Sigmoid(n.fc_pose)
    return n
