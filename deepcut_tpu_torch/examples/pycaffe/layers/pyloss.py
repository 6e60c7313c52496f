"""Python loss layer on the port: the counterpart of
`examples/pycaffe/layers/pyloss.py` (the reference's EuclideanLossLayer
written in Python).

The port's Python layer contract (`core.layers`, type "Python"): a class
with `forward(*bottoms)` over torch tensors, an optional
`setup(param_str)` and an optional `backward`; without one, autograd
differentiates the forward, so unlike the reference no hand-written
backward is needed.

Register it, then use `type: "Python"` in the prototxt:

    from deepcut_tpu_torch.core import layers as L
    from deepcut_tpu_torch.examples.pycaffe.layers.pyloss import EuclideanLossLayer
    L.register_python_layer("EuclideanLossLayer", EuclideanLossLayer)

    layer {
      name: "loss" type: "Python" bottom: "pred" bottom: "label" top: "loss"
      python_param { module: "pyloss" layer: "EuclideanLossLayer" }
      loss_weight: 1
    }

Or leave it unregistered and let `python_param.module` import it: put this
file's directory on the path first, as Caffe's Python layers are found
(from the repository's root:
``PYTHONPATH=deepcut_tpu_torch/examples/pycaffe/layers:. python ...``).
"""

from __future__ import annotations

import torch


class EuclideanLossLayer:
    """loss = sum((pred - label)^2) / (2 N), the reference pyloss.py's math;
    the backward comes from autograd instead of the hand-written
    `self.diff / bottom[0].num` the reference needs."""

    def forward(self, pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        diff = pred - label
        return torch.sum(diff * diff) / (2.0 * pred.shape[0])
