"""Programmatic CaffeNet authoring with the port's net_spec: the
counterpart of `examples/pycaffe/caffenet.py` (the reference's
examples/pycaffe/caffenet.py): build the AlexNet-style architecture in
Python and emit a prototxt.

Usage (from the repository's root):
  python -m deepcut_tpu_torch.examples.pycaffe.caffenet [lmdb_path] [out.prototxt]
"""

from __future__ import annotations

import sys

from deepcut_tpu_torch.net_spec import NetSpec, layers as L


def conv_relu(bottom, ks, nout, stride=1, pad=0, group=1):
    conv = L.Convolution(bottom, kernel_size=ks, stride=stride,
                         num_output=nout, pad=pad, group=group,
                         weight_filler=dict(type="gaussian", std=0.01))
    return conv, L.ReLU(conv, in_place=True)


def fc_relu(bottom, nout):
    fc = L.InnerProduct(bottom, num_output=nout,
                        weight_filler=dict(type="gaussian", std=0.005))
    return fc, L.ReLU(fc, in_place=True)


def max_pool(bottom, ks, stride=1):
    return L.Pooling(bottom, pool="MAX", kernel_size=ks, stride=stride)


def caffenet(lmdb_path: str, batch_size: int = 16, num_classes: int = 1000,
             include_acc: bool = False) -> NetSpec:
    n = NetSpec()
    n.data, n.label = L.Data(source=lmdb_path, backend="LMDB",
                             batch_size=batch_size, ntop=2,
                             transform_param=dict(crop_size=227, mirror=True))
    n.conv1, n.relu1 = conv_relu(n.data, 11, 96, stride=4)
    n.pool1 = max_pool(n.relu1, 3, stride=2)
    n.norm1 = L.LRN(n.pool1, local_size=5, alpha=1e-4, beta=0.75)
    n.conv2, n.relu2 = conv_relu(n.norm1, 5, 256, pad=2, group=2)
    n.pool2 = max_pool(n.relu2, 3, stride=2)
    n.norm2 = L.LRN(n.pool2, local_size=5, alpha=1e-4, beta=0.75)
    n.conv3, n.relu3 = conv_relu(n.norm2, 3, 384, pad=1)
    n.conv4, n.relu4 = conv_relu(n.relu3, 3, 384, pad=1, group=2)
    n.conv5, n.relu5 = conv_relu(n.relu4, 3, 256, pad=1, group=2)
    n.pool5 = max_pool(n.relu5, 3, stride=2)
    n.fc6, n.relu6 = fc_relu(n.pool5, 4096)
    n.drop6 = L.Dropout(n.relu6, in_place=True)
    n.fc7, n.relu7 = fc_relu(n.drop6, 4096)
    n.drop7 = L.Dropout(n.relu7, in_place=True)
    n.fc8 = L.InnerProduct(n.drop7, num_output=num_classes,
                           weight_filler=dict(type="gaussian", std=0.01))
    n.loss = L.SoftmaxWithLoss(n.fc8, n.label)
    if include_acc:
        n.acc = L.Accuracy(n.fc8, n.label)
    return n


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    lmdb = argv[0] if len(argv) > 0 else "examples/imagenet/data/train_lmdb"
    out = argv[1] if len(argv) > 1 else "examples/pycaffe/caffenet_train.prototxt"
    with open(out, "w") as f:
        f.write(caffenet(lmdb).to_proto_text())
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
