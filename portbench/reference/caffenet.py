"""Plain reference of BVLC's CaffeNet (deploy form), in f32.

The layers as Caffe defines them, in plain PyTorch over NCHW: conv1 to
conv5 (conv2, conv4 and conv5 in two groups), ReLU, MAX pooling 3x3/2 in
ceil mode, LRN across five channels (x / (k + alpha / n * sum x^2)^beta),
InnerProduct over the C, H, W flattened blob, Dropout as the identity (TEST
phase), Softmax. The input is the uint8 BGR batch less the per-channel mean.
It returns fc8's logits; the probabilities are their softmax.

The weights are made here from the seed (`make_weights`) and handed to both
sides. Runs on the card with TF32 off. Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, Dict[str, torch.Tensor]]


def _pool_size(size: int, k: int, s: int) -> int:
    return -(-(size - k) // s) + 1


def layer_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """Every conv and InnerProduct weight: (layer, shape, fan_in), in order."""
    c, h, w = cfg["input"]
    out = []
    for spec in cfg["conv"]:
        k, g = spec["kernel"], spec["group"]
        out.append((spec["name"], (spec["num_output"], c // g, k, k), c // g * k * k))
        h = (h + 2 * spec["pad"] - k) // spec["stride"] + 1
        w = (w + 2 * spec["pad"] - k) // spec["stride"] + 1
        c = spec["num_output"]
        if spec["name"] in cfg["pool_after"]:
            h = _pool_size(h, cfg["pool"]["kernel"], cfg["pool"]["stride"])
            w = _pool_size(w, cfg["pool"]["kernel"], cfg["pool"]["stride"])
    k_in = c * h * w
    for spec in cfg["fc"]:
        out.append((spec["name"], (spec["num_output"], k_in), k_in))
        k_in = spec["num_output"]
    return out


def make_weights(cfg: dict, seed: int, device) -> Weights:
    """The weights from the seed, on `device`, in f32: one draw for every
    weight, scaled per layer by sqrt(2 / fan_in) (fc8 at a tenth), and one
    for every bias, at std 0.1."""
    shapes = layer_shapes(cfg)
    counts = [math.prod(s) for _, s, _ in shapes]
    stds = [math.sqrt(2.0 / fan) * (0.1 if name == cfg["fc"][-1]["name"] else 1.0)
            for name, _, fan in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(counts), generator=gen, device=device)
    flat.mul_(torch.repeat_interleave(torch.tensor(stds, device=device),
                                      torch.tensor(counts, device=device)))
    biases = torch.randn(sum(s[0] for _, s, _ in shapes), generator=gen, device=device) * 0.1
    out: Weights = {}
    for (name, shape, _), wv, bv in zip(shapes, flat.split(counts),
                                        biases.split([s[0] for _, s, _ in shapes])):
        out[name] = {"w": wv.view(shape), "b": bv}
    return out


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with a per-tensor scale (its absmax at 448)."""
    s = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def lrn(x: torch.Tensor, n: int, alpha: float, beta: float, k: float) -> torch.Tensor:
    half = n // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, half))
    window = sum(sq[:, i:i + x.shape[1]] for i in range(n))
    return x / (k + alpha / n * window) ** beta


def logits(cfg: dict, weights: Weights, images: torch.Tensor, low: bool = False) -> torch.Tensor:
    """(N, H, W, 3) uint8 BGR images -> (N, classes) f32 logits of fc8.
    low=True rounds every conv's and InnerProduct's operands to float8 (the
    precision control)."""
    q = fp8 if low else (lambda t: t)
    x = images.permute(0, 3, 1, 2).float()
    x = x - torch.tensor(cfg["mean_bgr"], device=x.device).view(1, 3, 1, 1)
    lp = cfg["lrn"]
    for spec in cfg["conv"]:
        p = weights[spec["name"]]
        x = F.relu(F.conv2d(q(x), q(p["w"]), p["b"], stride=spec["stride"], padding=spec["pad"],
                            groups=spec["group"]))
        if spec["name"] in cfg["pool_after"]:
            x = F.max_pool2d(x, cfg["pool"]["kernel"], cfg["pool"]["stride"], ceil_mode=True)
        if spec["name"] in cfg["lrn_after"]:
            x = lrn(x, lp["local_size"], lp["alpha"], lp["beta"], lp["k"])
    x = x.reshape(x.shape[0], -1)
    for i, spec in enumerate(cfg["fc"]):
        p = weights[spec["name"]]
        x = F.linear(q(x), q(p["w"]), p["b"])
        if i + 1 < len(cfg["fc"]):
            x = F.relu(x)
    return x


class _TF32Off:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def serve(cfg: dict, mix: dict, weights: Weights, pool: np.ndarray, device, block: int = 256,
          low: bool = False) -> Dict[str, np.ndarray]:
    """Every pool image through the reference, `block` at a time: fc8's
    logits as a host array indexed by pool item."""
    out = []
    with _TF32Off(), torch.inference_mode():
        for i in range(0, len(pool), block):
            out.append(logits(cfg, weights, torch.from_numpy(pool[i:i + block]).to(device),
                              low=low).cpu().numpy())
    return {"logits": np.concatenate(out)}
