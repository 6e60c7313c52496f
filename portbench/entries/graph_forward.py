"""Drives the graph engine's serving forward of deepcut_tpu_torch.

The configuration's prototxt goes through the serving chain (`Net` ->
`fold_bn` -> `prune(outputs)` -> `fuse_siblings` -> `cast_weights` ->
`make_forward(outputs)`). One call uploads a whole batch of uint8 BGR
images from pinned memory, subtracts the per-channel mean on the device,
runs the forward and brings back each image's top classes and their
probabilities. `compare` judges every image served against the reference's
logits of the same image:

- ``top1_gap``: how far the reference's logit of the program's class lies
  below the reference's best (a near-tie may pick either class; a wrong
  pick cannot hide);
- ``prob_err``: the program's probability of its class against the
  reference's, relatively;
- ``logit_err``: the gaps between the program's log-probabilities of its
  top classes against the gaps between the reference's logits of the
  same classes (the network's own output, whatever the softmax's
  saturation).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np
import torch


TOP = 5  # classes brought back per image, best first


class System:
    """The served net, its pinned batches and the traffic."""

    def __init__(self, cfg: dict, mix: dict, weights, traffic, device, control: str = "",
                 config_dir: Path = Path(".")):
        from deepcut_tpu_torch.core.graph import Net

        if traffic.mode != "fixed":
            raise ValueError("graph_forward: the mix must send fixed batches")
        self.traffic, self.device = traffic, torch.device(device)
        self.outputs = list(mix["outputs"])
        net = Net(str(config_dir / cfg["prototxt"]), weights=weights, device=device)
        net.fold_bn()
        net.prune(self.outputs)
        net.fuse_siblings()
        b = traffic.batch
        pool = torch.from_numpy(traffic.pool)
        self.mean = torch.tensor(cfg["mean_bgr"], device=device).view(1, 3, 1, 1)
        if control == "int8":
            net.quantize_int8(data=self._prepare(pool[:b].to(device)).cpu().numpy())
        elif control:
            raise ValueError(f"graph_forward: no program control {control!r}")
        net.cast_weights()
        self.net, self.fwd = net, net.make_forward(self.outputs)
        batches = pool.view(-1, b, *pool.shape[1:])
        self.batches = batches.pin_memory() if self.device.type == "cuda" else batches

    def _prepare(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 3, 1, 2).float() - self.mean

    def call(self, i: int):
        """Call i: (items served, its record)."""
        idx = self.traffic.items(i)
        k = int(idx[0]) // self.traffic.batch
        x = self._prepare(self.batches[k].to(self.device, non_blocking=True))
        prob = self.fwd(self.net.params, {"data": x})[self.outputs[-1]]
        p, c = prob.reshape(prob.shape[0], -1).topk(TOP, dim=1)
        top = torch.cat([p, c.float()], dim=1).cpu().numpy()
        return len(idx), (idx, top[:, :TOP], top[:, TOP:].astype(np.int64))

    def counters(self) -> Dict[str, int]:
        """The program's launch counts: its conv epilogue's and its int8
        kernels'."""
        from deepcut_tpu_torch.ops import conv_epilogue, int8_conv

        return {"conv_epilogue": conv_epilogue.launches,
                "int8_im2col": int8_conv.im2col_launches,
                "int8_epilogue": int8_conv.epilogue_launches,
                "int8_quantize": int8_conv.quantize_launches}

    def quantized(self) -> bool:
        """Whether the program serves its int8 model."""
        return bool(any("w_q" in p for p in self.net.params.values()))

    def close(self) -> None:
        self.net.close()
        del self.net, self.fwd, self.batches


def served(records: List) -> Dict[str, np.ndarray]:
    """The records as arrays of items, top-1 probabilities and classes."""
    return {"items": np.concatenate([r[0] for r in records]),
            "prob": np.concatenate([r[1] for r in records]).astype(np.float64),
            "cls": np.concatenate([r[2] for r in records])}


def _log_softmax(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.float64)
    m = z.max(axis=1, keepdims=True)
    return z - m - np.log(np.exp(z - m).sum(axis=1, keepdims=True))


def from_reference(ref: Dict[str, np.ndarray], items: np.ndarray) -> Dict[str, np.ndarray]:
    """The reference's own top classes of `items`, in `served`'s form."""
    z = ref["logits"][items]
    cls = np.argsort(-z, axis=1, kind="stable")[:, :TOP]
    return {"items": items, "prob": np.exp(np.take_along_axis(_log_softmax(z), cls, axis=1)),
            "cls": cls}


def compare(cfg: dict, mix: dict, out: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]
            ) -> Dict[str, float]:
    """The three numbers over every image served (module docstring). Each
    answer reads the reference's logits of its own classes only."""
    items, cls, prob = out["items"], out["cls"], out["prob"]
    if len(items) == 0 or cls.min() < 0 or cls.max() >= cfg["num_classes"]:
        return {"top1_gap": float("inf"), "prob_err": float("inf"), "logit_err": float("inf")}
    z = ref["logits"]
    zmax = z.max(axis=1).astype(np.float64)
    lse = (_log_softmax(z) - z.astype(np.float64))[:, 0]    # -logsumexp per pool item
    zc = z[items[:, None], cls].astype(np.float64)           # the served classes' logits
    gap = zmax[items] - zc[:, 0]
    rel = np.abs(prob[:, 0] / np.exp(zc[:, 0] + lse[items]) - 1)
    with np.errstate(divide="ignore"):
        dlog = np.log(prob[:, 1:]) - np.log(prob[:, :1])
    dlogit = np.abs(dlog - (zc[:, 1:] - zc[:, :1]))
    return {"top1_gap": float(np.max(gap)), "prob_err": float(np.max(rel)),
            "logit_err": float(np.max(dlogit))}
