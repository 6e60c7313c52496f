"""Each reference against the program at a tiny depth on the CPU: the same
seeded weights and frames through both, f32 on both sides."""

import json
from pathlib import Path

import numpy as np
import torch

from portbench.generator import Traffic
from portbench.harness import load_module

PB = Path(__file__).resolve().parents[1]


def test_pose_reference_against_the_port():
    from deepcut_tpu_torch.models.resnet import fold_bn, forward
    from deepcut_tpu_torch.pose.decode import decode_pose_batch
    from deepcut_tpu_torch.pose.estimate import PoseEstimator

    ref = load_module(PB / "reference" / "deepercut-r152.py")
    entry = load_module(PB / "entries" / "pose_batch.py")
    cfg = json.loads((PB / "configs" / "deepercut-r152.json").read_text())
    cfg.update(depths=[1, 2, 2, 1], stage_widths=[8, 16, 32, 64], stem_channels=8,
               block_naming="numbered")
    mix = {"item_hw": [72, 88], "pool": 2, "batch": 2, "scale": 1.0, "bucket_step": 64}
    cpu = torch.device("cpu")
    weights = ref.make_weights(cfg, 1234, cpu)
    traffic = Traffic(mix, 5, 6, cpu)

    # the preprocess: the estimator's bucketed canvas, exactly
    est = PoseEstimator(weights, entry._port_config(cfg), bucket_step=64, device="cpu")
    ours = ref.canvas(cfg, torch.from_numpy(traffic.pool), 1.0, 64)
    theirs = torch.cat([est._canvas(f, 1.0, 128, 128) for f in traffic.pool]).permute(0, 3, 1, 2)
    assert torch.equal(ours, theirs)

    # the f32 forward: BN applied here; there applied as it stands, and
    # folded into the convs as the estimator serves it
    import dataclasses

    f32 = dataclasses.replace(entry._port_config(cfg), compute_dtype=torch.float32)
    with torch.no_grad():
        logit, loc = ref.maps(cfg, weights, ours)
        prob = torch.sigmoid(logit)
        for folded in (False, True):
            params = fold_bn(weights, f32) if folded else weights
            theirs = forward(params, ours, f32, folded=folded, heads=("pose", "locref"))
            assert float((prob - theirs["prob"]).abs().max()) <= 1e-5, folded
            assert float((loc - theirs["loc_pred"]).abs().max()) <= 1e-5 * max(
                float(loc.abs().max()), 1.0), folded

    # the decode, on the valid cells
    _, _, gh, gw = ref.canvas_geometry(cfg, (72, 88), 1.0, 64)
    got = ref.decode(cfg, prob[:, :, :gh, :gw], loc[:, :, :gh, :gw], 1.0)
    want = decode_pose_batch(prob, loc, valid_hw=(torch.tensor([gh] * 2), torch.tensor([gw] * 2)))
    assert torch.allclose(got, want, rtol=0, atol=1e-4)


def test_caffenet_reference_against_the_port():
    from deepcut_tpu_torch.core.graph import Net

    ref = load_module(PB / "reference" / "caffenet.py")
    cfg = json.loads((PB / "configs" / "caffenet.json").read_text())
    cpu = torch.device("cpu")
    weights = ref.make_weights(cfg, 99, cpu)
    images = Traffic({"item_hw": [227, 227], "pool": 2, "batch": 2}, 3, 4, cpu).pool
    with torch.no_grad():
        got = ref.logits(cfg, weights, torch.from_numpy(images))
    net = Net(str(PB / "configs" / cfg["prototxt"]), weights=weights, compute_dtype=None,
              device="cpu")
    x = torch.from_numpy(images).permute(0, 3, 1, 2).float() - torch.tensor(
        cfg["mean_bgr"]).view(1, 3, 1, 1)
    want = torch.from_numpy(np.asarray(net.forward(data=x.numpy())["fc8"]))
    assert got.shape == (2, cfg["num_classes"])
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
