"""Plain reference of the DeeperCut ResNet-152 part detector, in f32.

What `PoseEstimator.estimate_pose_batch` computes, written out again from
the published description with plain PyTorch operations and no kernel,
cache or batching of the program: the preprocess at scale 1 (pad 64 px
bottom / right by edge replication, subtract the BGR mean, paste top-left
into a zero canvas), the trunk (conv1 7x7/2, BN and Scale applied as they
stand, a 3x3/2 ceil-mode max pool, bottleneck blocks whose stride sits on
the 1x1 convs, res5 undilated to stride 1 with its 3x3 convs dilated by 2),
each head as a 3x3/2 deconv off res5c cropped top-left and summed with a
1x1 conv off the stride-8 tap (the last res3 block), the sigmoid, and the
decode: the first row-major argmax of each joint over the image's valid
cells, offsets from the locref map times its stdev.

Departure, stated: the canvas is rounded up to the estimator's bucket grid
(``bucket_step``), as the program and the JAX package it was ported from
serve it, and the argmax is masked to the valid ceil(size / 8) cells.

The weights are made here from the seed (`make_weights`) and handed to both
sides; the reference applies BatchNorm itself where the program folds it.
Runs on the card with TF32 off. Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, Dict[str, torch.Tensor]]


def block_names(cfg: dict, stage: int) -> List[str]:
    """Caffe's block names of stage index `stage` (label stage + 2):
    res3b1, res3b2, ... where a stage has more than three blocks and the
    net is numbered, else letters."""
    n, label = cfg["depths"][stage], stage + 2
    if cfg["block_naming"] == "letters" or n <= 3:
        return [f"{label}{chr(ord('a') + i)}" for i in range(n)]
    return [f"{label}a"] + [f"{label}b{i}" for i in range(1, n)]


def heads(cfg: dict) -> List[Tuple[str, int]]:
    """Every head the model has, with its channels."""
    j = cfg["num_joints"]
    out = [("pose", j)]
    if cfg["location_refinement"]:
        out.append(("locref", 2 * j))
    if cfg["pairwise"]:
        out.append(("next", j * (j - 1) * 2))
    return out


def conv_leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """Every random weight in Caffe's layer order: (layer, shape, std)."""
    out = []

    def conv(name, k, cin, cout):
        out.append((name, (cout, cin, k, k), math.sqrt(2.0 / (k * k * cin))))

    conv("conv1", 7, 3, cfg["stem_channels"])
    cin = cfg["stem_channels"]
    for stage, width in enumerate(cfg["stage_widths"]):
        cout = cfg["expansion"] * width
        for bi, block in enumerate(block_names(cfg, stage)):
            if bi == 0:
                conv(f"res{block}_branch1", 1, cin, cout)
            conv(f"res{block}_branch2a", 1, cin if bi == 0 else cout, width)
            conv(f"res{block}_branch2b", 3, width, width)
            conv(f"res{block}_branch2c", 1, width, cout)
        cin = cout
    skip_c = cfg["expansion"] * cfg["stage_widths"][1]
    for head, ch in heads(cfg):
        out.append((f"res5c_up_{head}", (cin, ch, 3, 3), 0.01))
        out.append((f"res3d_{head}", (ch, skip_c, 1, 1), 0.01))
    return out


def make_weights(cfg: dict, seed: int, device) -> Weights:
    """The raw weights from the seed, on `device`, in f32, in two draws.

    The first draws every conv and head weight, scaled per layer (MSRA for
    the trunk, 0.01 for the heads) and tamed as the config states (the pose
    and locref heads x30, conv1 x3e-4). The second draws, per BatchNorm
    channel, the statistics and the Scale's beta, and the head biases:

    - the statistics as Caffe stores them, times a scale factor s per
      layer: var = v * s with v log-uniform over [1/2, 2], mean = m * s
      with m standard normal, s uniform over [1, 1000];
    - gamma as tamed: 0.1 on every branch2c, 1 elsewhere;
    - beta = m * g + gamma * bias_scale * z, g = gamma / sqrt(v + eps), z
      standard normal: each of m, v, s and beta is of order one against
      activations of a few hundredths, and yet the folded bias, beta -
      m * g, is a fraction of them, so that the maps keep their structure;
    - each head conv's bias normal at ``head_bias_std``.

    A fold that drops or misuses any of them moves the maps."""
    tame = cfg["weights"]["tamed"]
    leaves = conv_leaves(cfg)
    counts = [math.prod(shape) for _, shape, _ in leaves]
    stds = []
    for name, _, std in leaves:
        if name in ("res5c_up_pose", "res3d_pose", "res5c_up_locref", "res3d_locref"):
            std *= tame["heads_scale"]
        elif name == "conv1":
            std *= tame["conv1_scale"]
        stds.append(std)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(counts), generator=gen, device=device)
    flat.mul_(torch.repeat_interleave(torch.tensor(stds, device=device),
                                      torch.tensor(counts, device=device)))
    weights: Weights = {name: {"w": w.view(shape)}
                        for (name, shape, _), w in zip(leaves, flat.split(counts))}

    head = {name for name, _ in heads(cfg)}
    heads_c = [(name, shape[1] if "_up_" in name else shape[0]) for name, shape, _ in leaves
               if name.split("_", 2)[-1] in head]
    bn_c = [(name, shape[0]) for name, shape, _ in leaves if name.split("_", 2)[-1] not in head]
    per_bn, per_head = [c for _, c in bn_c], [c for _, c in heads_c]
    nb, nh = sum(per_bn), sum(per_head)
    normal = torch.randn(2 * nb + nh, generator=gen, device=device)
    uniform = torch.rand(nb + len(bn_c), generator=gen, device=device)
    m_all, z_all, hb_all = normal.split([nb, nb, nh])
    v_all = torch.exp2(2.0 * uniform[:nb] - 1.0)
    s_all = 1.0 + 999.0 * uniform[nb:]
    for (name, _), b in zip(heads_c, hb_all.mul(tame["head_bias_std"]).split(per_head)):
        weights[name]["b"] = b
    for (name, _), m, z, v, s in zip(bn_c, m_all.split(per_bn), z_all.split(per_bn),
                                     v_all.split(per_bn), s_all.split(1)):
        suffix = "_conv1" if name == "conv1" else name[len("res"):]
        gamma = torch.full_like(m, tame["branch2c_gamma"] if name.endswith("_branch2c") else 1.0)
        g = gamma / torch.sqrt(v + cfg["bn_eps"])
        weights[f"bn{suffix}"] = {"mean": m * s, "var": v * s, "scale_factor": s}
        weights[f"scale{suffix}"] = {"gamma": gamma,
                                     "beta": m * g + gamma * tame["bias_scale"] * z}
    return weights


def canvas_geometry(cfg: dict, hw, scale: float, bucket_step: int):
    """(canvas rows, canvas columns, valid cell rows, valid cell columns)."""
    stride = cfg["stride"]
    ch = [int(math.ceil(d * scale / stride) * stride) for d in hw]
    bucket = [int(math.ceil(c / bucket_step) * bucket_step) for c in ch]
    return bucket[0], bucket[1], ch[0] // stride, ch[1] // stride


def canvas(cfg: dict, frames: torch.Tensor, scale: float, bucket_step: int) -> torch.Tensor:
    """(N, h, w, 3) uint8 BGR frames -> the (N, 3, H, W) f32 canvases."""
    if scale != 1.0:
        raise NotImplementedError("the reference preprocess is written for scale 1")
    n, h, w, _ = frames.shape
    ch, cw, _, _ = canvas_geometry(cfg, (h, w), scale, bucket_step)
    pad = cfg["input_pad"]
    x = frames.permute(0, 3, 1, 2).float()
    x = F.pad(x, (0, pad, 0, pad), mode="replicate")
    x = x - torch.tensor(cfg["mean_bgr"], device=x.device).view(1, 3, 1, 1)
    out = torch.zeros((n, 3, ch, cw), device=x.device)
    rows, cols = min(ch, h + pad), min(cw, w + pad)
    out[:, :, :rows, :cols] = x[:, :, :rows, :cols]
    return out


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with a per-tensor scale (its absmax at 448)."""
    s = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def maps(cfg: dict, weights: Weights, x: torch.Tensor, low: bool = False
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 forward of (N, 3, H, W) canvases -> the pose logits (N, J,
    h, w), before the sigmoid, and locref (N, 2J, h, w). low=True rounds every conv's operands to float8
    (the precision control)."""
    q = fp8 if low else (lambda t: t)
    eps = cfg["bn_eps"]

    def conv(name, t, stride=1, pad=0, dilation=1):
        p = weights[name]
        return F.conv2d(q(t), q(p["w"]), p.get("b"), stride=stride, padding=pad,
                        dilation=dilation)

    def bn(suffix, t):
        b, s = weights[f"bn{suffix}"], weights[f"scale{suffix}"]
        sf = float(b["scale_factor"][0])
        k = 0.0 if sf == 0 else 1.0 / sf
        mean, var = b["mean"] * k, b["var"] * k
        inv = s["gamma"] / torch.sqrt(var + eps)
        return (t - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1) + s["beta"].view(1, -1, 1, 1)

    y = F.relu(bn("_conv1", conv("conv1", x, stride=2, pad=3)))
    y = F.max_pool2d(y, 3, 2, ceil_mode=True)
    skip = None
    for stage in range(len(cfg["depths"])):
        s, d = cfg["stage_strides"][stage], cfg["stage_dilations"][stage]
        names = block_names(cfg, stage)
        for bi, block in enumerate(names):
            bs = s if bi == 0 else 1
            short = bn(f"{block}_branch1", conv(f"res{block}_branch1", y, stride=bs)) if bi == 0 else y
            z = F.relu(bn(f"{block}_branch2a", conv(f"res{block}_branch2a", y, stride=bs)))
            z = F.relu(bn(f"{block}_branch2b", conv(f"res{block}_branch2b", z, pad=d, dilation=d)))
            z = bn(f"{block}_branch2c", conv(f"res{block}_branch2c", z))
            y = F.relu(short + z)
            if stage == 1 and bi == len(names) - 1:
                skip = y
    out = {}
    for head in cfg["serving_heads"]:
        up, sk = weights[f"res5c_up_{head}"], weights[f"res3d_{head}"]
        u = F.conv_transpose2d(q(y), q(up["w"]), up["b"], stride=2)
        v = F.conv2d(q(skip), q(sk["w"]), sk["b"])
        out[head] = u[:, :, :v.shape[2], :v.shape[3]] + v
    return out["pose"], out["locref"]


def decode(cfg: dict, prob: torch.Tensor, loc: torch.Tensor, scale: float) -> torch.Tensor:
    """(N, J, h, w) probabilities (already cropped to the valid cells) and
    locref -> (N, 5, J) poses [x, y, conf, off_y, off_x]."""
    n, j, h, w = prob.shape
    flat = prob.reshape(n, j, h * w)
    idx = torch.argmax(flat, dim=2)
    conf = torch.gather(flat, 2, idx[..., None])[..., 0]
    row, col = (idx // w).float(), (idx % w).float()
    off = loc.reshape(n, j, 2, h * w)
    mul = cfg["locref_stdev"]
    off_x = torch.gather(off[:, :, 0], 2, idx[..., None])[..., 0] * mul
    off_y = torch.gather(off[:, :, 1], 2, idx[..., None])[..., 0] * mul
    half = cfg["stride"] / 2
    x = (col * cfg["stride"] + half + off_x) / scale
    y = (row * cfg["stride"] + half + off_y) / scale
    return torch.stack([x, y, conf, off_y / scale, off_x / scale], dim=1)


class _TF32Off:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def serve(cfg: dict, mix: dict, weights: Weights, pool: np.ndarray, device, block: int = 8,
          low: bool = False) -> Dict[str, np.ndarray]:
    """Every pool frame through the reference, `block` frames at a time:
    the valid cells' pose logits and locref maps and the decoded poses,
    as host arrays indexed by pool item."""
    scale, step = float(mix["scale"]), int(mix["bucket_step"])
    _, _, gh, gw = canvas_geometry(cfg, pool.shape[1:3], scale, step)
    logits, locs, poses = [], [], []
    with _TF32Off(), torch.inference_mode():
        for i in range(0, len(pool), block):
            frames = torch.from_numpy(pool[i:i + block]).to(device)
            logit, loc = maps(cfg, weights, canvas(cfg, frames, scale, step), low=low)
            logit, loc = logit[:, :, :gh, :gw], loc[:, :, :gh, :gw]
            poses.append(decode(cfg, torch.sigmoid(logit), loc, scale).cpu().numpy())
            logits.append(logit.cpu().numpy())
            locs.append(loc.cpu().numpy())
    return {"logit": np.concatenate(logits), "loc": np.concatenate(locs),
            "pose": np.concatenate(poses)}
