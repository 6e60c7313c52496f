"""A run with the timed path broken underneath comes out not correct: an
answer altered where the program produces it (the one fault a serving
cell can have), a BatchNorm fold that drops or misuses one of the
statistics the weights carry, and int8 serving put in the bf16 cell's
place."""

import json

import numpy as np
import pytest
import torch

from portbench.harness import main


def run(root, workload, capsys, control=""):
    rc = main(["--workload", workload, "--seed", "11", "--seconds", "0.3", "--trace", "0"],
              device="cpu", root=root, control=control)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_pose_sound_then_one_joint_moved(tiny_root, capsys, monkeypatch):
    from deepcut_tpu_torch.pose.estimate import PoseEstimator

    assert run(tiny_root, "r152-pose-b8", capsys)[1]["correct"]
    served = PoseEstimator.estimate_pose_batch

    def moved(self, images, scale=1.0):
        poses = served(self, images, scale).copy()
        poses[0, 0, 3] += 8.0          # one joint's x, a cell (8 px) off
        return poses

    monkeypatch.setattr(PoseEstimator, "estimate_pose_batch", moved)
    rc, out = run(tiny_root, "r152-pose-b8", capsys)
    assert rc == 0 and out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["check"].values())


def test_caffenet_sound_then_one_class_moved(tiny_root, capsys, monkeypatch):
    from deepcut_tpu_torch.core import graph

    assert run(tiny_root, "caffenet-b256", capsys)[1]["correct"]
    make = graph.Net.make_forward

    def make_moved(self, outputs=None):
        fwd = make(self, outputs)

        def moved(params, inputs):
            out = fwd(params, inputs)
            prob = out["prob"].clone()
            prob[0] = prob[0].roll(1)     # image 0's probabilities shifted by one class
            return dict(out, prob=prob)
        return moved

    monkeypatch.setattr(graph.Net, "make_forward", make_moved)
    rc, out = run(tiny_root, "caffenet-b256", capsys)
    assert rc == 0 and out["correct"] is False
    assert np.isfinite(out["check"]["top1_gap"]["value"])
    assert out["check"]["top1_gap"]["value"] > out["check"]["top1_gap"]["limit"]


def _beta_dropped(bn, sc):
    return bn, dict(sc, beta=torch.zeros_like(sc["beta"]))


def _mean_dropped(bn, sc):
    return dict(bn, mean=torch.zeros_like(bn["mean"])), sc


def _var_as_one(bn, sc):
    return dict(bn, var=bn["scale_factor"] * torch.ones_like(bn["var"])), sc


def _scale_factor_ignored(bn, sc):
    return dict(bn, scale_factor=torch.ones_like(bn["scale_factor"])), sc


@pytest.mark.parametrize("fault", [_beta_dropped, _mean_dropped, _var_as_one,
                                   _scale_factor_ignored])
def test_pose_fold_fault(tiny_root, capsys, monkeypatch, fault):
    from deepcut_tpu_torch.pose import estimate

    fold = estimate.fold_bn

    def broken(params, cfg):
        params = dict(params)
        for name in [k for k in params if k.startswith("bn")]:
            sc = "scale" + name[2:]
            params[name], params[sc] = fault(params[name], params[sc])
        return fold(params, cfg)

    monkeypatch.setattr(estimate, "fold_bn", broken)
    rc, out = run(tiny_root, "r152-pose-b8", capsys)
    assert rc == 0 and out["correct"] is False


def test_pose_folded_bias_skipped(tiny_root, capsys, monkeypatch):
    from deepcut_tpu_torch.pose import estimate

    fold = estimate.fold_bn

    def no_bias(params, cfg):
        return {k: {n: (torch.zeros_like(t) if n == "b" else t) for n, t in p.items()}
                for k, p in fold(params, cfg).items()}

    monkeypatch.setattr(estimate, "fold_bn", no_bias)
    rc, out = run(tiny_root, "r152-pose-b8", capsys)
    assert rc == 0 and out["correct"] is False


@pytest.mark.parametrize("workload", ["r152-pose-b8", "caffenet-b256"])
def test_int8_serving_in_a_bf16_cell(tiny_root, capsys, workload):
    rc, out = run(tiny_root, workload, capsys, control="int8")
    assert rc == 0 and out["correct"] is False
    assert out["check"]["int8_serving"]["value"] > out["check"]["int8_serving"]["limit"]
