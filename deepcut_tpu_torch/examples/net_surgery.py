"""Net surgery on the port (reference: examples/net_surgery.ipynb): the
counterpart of `examples/net_surgery.py`, on the port's pycaffe facade.

1. edit a conv filter in place through `net.params` and see the output change;
2. cast a classifier into a fully-convolutional net by transplanting its
   InnerProduct weights into a convolution, so it slides over larger
   inputs and emits a score map instead of a single vector.

The port's `net.params` show Caffe's layouts (conv OIHW, InnerProduct
(N_out, K)) and write through to the net, so both edits go through the
public params, as the reference notebook does.

Run (from the repository's root):
  python -m deepcut_tpu_torch.examples.net_surgery [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

import deepcut_tpu_torch.compat as caffe
from deepcut_tpu_torch.net_spec import NetSpec, layers as L


def classifier_prototxt(h: int, w: int, fully_conv: bool) -> str:
    """A tiny classifier; `fully_conv` swaps the IP head for a 1x1 conv."""
    n = NetSpec()
    n.data = L.Input(shape=dict(dim=[1, 3, h, w]))
    n.conv = L.Convolution(n.data, num_output=8, kernel_size=5, stride=2,
                           weight_filler=dict(type="gaussian", std=0.1))
    n.relu = L.ReLU(n.conv, in_place=True)
    n.pool = L.Pooling(n.conv, pool=0, kernel_size=3, stride=3)
    if fully_conv:
        # the surgered head: a conv with the SAME weights as the IP
        n.score = L.Convolution(n.pool, num_output=4, kernel_size=1,
                                weight_filler=dict(type="constant"))
    else:
        n.ip = L.InnerProduct(n.pool, num_output=4,
                              weight_filler=dict(type="gaussian", std=0.1))
    return n.to_proto_text()


def _net(text: str, tmp: str, name: str, device: str) -> "caffe.Net":
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(text)
    return caffe.Net(path, caffe.TEST, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="deepcut_tpu_torch.examples.net_surgery")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    device = ap.parse_args(argv).device
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory(prefix="net_surgery_") as tmp:
        # --- 1. filter surgery -----------------------------------------------
        net = _net(classifier_prototxt(33, 33, fully_conv=False), tmp, "small.prototxt", device)
        x = rng.randn(1, 3, 33, 33).astype(np.float32)
        net.forward(blobs=["conv"], data=x)
        # zero one filter through the params view: the write pushes through
        # to the live net, the pycaffe net-surgery idiom
        net.params["conv"][0].data[0] = 0.0  # Caffe's OIHW: output channel 0
        after = net.forward(blobs=["conv"], data=x)["conv"]
        if not np.allclose(after[:, 0], 0.0) or np.allclose(after[:, 1], 0.0):
            raise AssertionError("the zeroed filter must output zeros, the others not")
        print("filter surgery: channel 0 silenced, others untouched")

        # --- 2. fully-convolutional cast -------------------------------------
        # sizes chosen so pooling divides exactly (33 -> conv 15 -> pool 5);
        # with ceil-mode partial windows the sliding equivalence only holds in
        # the interior, as the reference notebook also notes.
        _, c, ph, pw = net.blobs["pool"].shape
        ip_w = net.params["ip"][0].data      # (4, C*ph*pw), Caffe's layout
        ip_b = net.params["ip"][1].data
        # the score conv takes the pooled map's whole (ph, pw) window
        big = classifier_prototxt(63, 63, fully_conv=True).replace(
            "kernel_size: 1", f"kernel_h: {ph} kernel_w: {pw}")
        fcn = _net(big, tmp, "big.prototxt", device)
        for i, blob in enumerate(net.params["conv"]):
            fcn.params["conv"][i].data[...] = blob.data
        fcn.params["score"][0].data[...] = ip_w.reshape(4, c, ph, pw)  # OIHW
        fcn.params["score"][1].data[...] = ip_b

        xb = rng.randn(1, 3, 63, 63).astype(np.float32)
        score_map = fcn.forward(blobs=["score"], data=xb)["score"]
        print(f"fully-convolutional score map: {score_map.shape} "
              f"(a classifier slid over the 2x input)")
        # the top-left window must equal the small classifier
        small_out = net.forward(data=xb[:, :, :33, :33])["ip"]
        np.testing.assert_allclose(score_map[:, :, 0, 0], small_out.reshape(1, 4),
                                   rtol=1e-4, atol=1e-4)
    print("top-left window matches the dense classifier: surgery exact")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
