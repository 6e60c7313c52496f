"""The port's profiler spans (`deepcut_tpu_torch.spans`) on the CPU.

Under `torch.profiler` the estimator's batched call and the graph engine's
`make_forward` call record their spans, nested in time on the calling
thread, in the same event stream as the aten ops inside them, and none as
a user annotation (which a CUDA build's profiler would project onto the
device timeline). With no profiler running the outputs are bit-equal to a
run whose spans are no-ops.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepcut_tpu_torch import spans
from deepcut_tpu_torch.core import graph
from deepcut_tpu_torch.models.resnet import DeeperCutConfig, init_params
from deepcut_tpu_torch.pose import estimate
from deepcut_tpu_torch.proto import text_format

CFG = DeeperCutConfig(depths=(1, 1, 1, 1), stage_widths=(4, 4, 8, 8), num_joints=3)

NET = """
name: "SpanNet"
input: "data"
input_shape { dim: 2 dim: 3 dim: 16 dim: 16 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 8 kernel_size: 3 pad: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "left" type: "Convolution" bottom: "conv1" top: "left"
        convolution_param { num_output: 4 kernel_size: 1 } }
layer { name: "right" type: "Convolution" bottom: "conv1" top: "right"
        convolution_param { num_output: 4 kernel_size: 1 } }
layer { name: "cat" type: "Concat" bottom: "left" bottom: "right" top: "cat" }
layer { name: "pool" type: "Pooling" bottom: "cat" top: "pool"
        pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip" type: "InnerProduct" bottom: "pool" top: "ip"
        inner_product_param { num_output: 5 } }
layer { name: "prob" type: "Softmax" bottom: "ip" top: "prob" }
"""


def _estimator():
    return estimate.PoseEstimator(init_params(torch.Generator().manual_seed(0), CFG), CFG,
                                  device="cpu")


def _frames(n):
    rng = np.random.RandomState(1)
    return [rng.randint(0, 256, (40, 48, 3), np.uint8) for _ in range(n)]


def _net():
    net = graph.Net(text_format.parse(NET), device="cpu", seed=3)
    assert net.fuse_siblings() == 1   # left + right: one plan step
    return net


def _input():
    return {"data": torch.from_numpy(np.random.RandomState(2).randn(2, 3, 16, 16)
                                     .astype(np.float32))}


def _profiled(fn):
    """fn() under a CPU profiler -> (its result, the raw events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.profiler.kineto_results.events())


def _named(events, prefix):
    return sorted((e for e in events if e.name().startswith(prefix)), key=lambda e: e.start_ns())


def _inside(inner, outer):
    return outer.start_ns() <= inner.start_ns() and inner.end_ns() <= outer.end_ns()


def test_batch_call_records_nested_pose_spans():
    """5 frames, chunks of 4: one call holding, per chunk, its canvases, a
    net and a decode, then one wait, all on one thread, each holding the
    aten ops it ran."""
    est = _estimator()
    est.estimate_pose_batch(_frames(5))                  # warm the matrices' cache
    poses, events = _profiled(lambda: est.estimate_pose_batch(_frames(5)))
    assert poses.shape == (5, 5, 3)
    ours = _named(events, "pose.")
    names = [e.name() for e in ours]
    assert names == ([spans.POSE_CALL] + [spans.POSE_CANVAS, spans.POSE_NET, spans.POSE_DECODE] * 2
                     + [spans.POSE_WAIT])
    call, inner = ours[0], ours[1:]
    assert all(_inside(e, call) for e in inner)
    assert all(a.end_ns() <= b.start_ns() for a, b in zip(inner, inner[1:]))  # siblings in turn
    assert len({e.start_thread_id() for e in ours}) == 1
    aten = [e for e in events if e.name().startswith("aten::")]
    for e in inner:
        if e.name() != spans.POSE_DECODE:   # the CPU decode may run no aten op of its own
            assert any(_inside(a, e) and a.start_thread_id() == e.start_thread_id()
                       for a in aten), e.name()


def test_make_forward_records_a_span_per_plan_step():
    """One graph.forward holding graph.<layer> for every plan step (the
    fused siblings as one), in plan order."""
    net = _net()
    fwd = net.make_forward(["prob"])
    x = _input()
    fwd(net.params, x)
    _, events = _profiled(lambda: fwd(net.params, x))
    ours = _named(events, spans.GRAPH_PREFIX)
    assert ours[0].name() == spans.GRAPH_FORWARD
    steps = [spec.name for _, spec in net._plan]
    assert "right" not in steps and len(steps) == 7
    assert [e.name() for e in ours[1:]] == ["graph." + s for s in steps]
    assert all(_inside(e, ours[0]) for e in ours[1:])


@pytest.mark.parametrize("which", ["pose", "graph"])
def test_no_span_is_a_user_annotation(which):
    if which == "pose":
        est = _estimator()
        _, events = _profiled(lambda: est.estimate_pose_batch(_frames(2)))
    else:
        net = _net()
        fwd = net.make_forward(["prob"])
        _, events = _profiled(lambda: fwd(net.params, _input()))
    ours = _named(events, which + ".")
    assert ours and not any(e.is_user_annotation() for e in ours)


def _no_spans(monkeypatch):
    for mod in (estimate, graph):
        monkeypatch.setattr(mod, "span", lambda name: contextlib.nullcontext())


@pytest.mark.parametrize("which", ["pose", "graph"])
def test_outputs_bit_equal_without_spans(monkeypatch, which):
    """No profiler running: the outputs equal, bit for bit, those of the
    same calls with every span a no-op."""
    def run():
        if which == "pose":
            est = _estimator()
            return [est.estimate_pose_batch(_frames(5)), est.estimate_pose(_frames(1)[0]),
                    *est.scoremaps(_frames(1)[0])]
        net = _net()
        return [net.make_forward(["prob"])(net.params, _input())["prob"].numpy()]

    with_spans = run()
    _no_spans(monkeypatch)
    without = run()
    for a, b in zip(with_spans, without):
        np.testing.assert_array_equal(a, b)


def test_fast_record_function_is_there():
    """The spans rest on torch's private `_RecordFunctionFast`: a torch
    without it fails here rather than losing the spans unseen."""
    from torch._C._profiler import _RecordFunctionFast

    assert isinstance(spans.span("pose.check"), _RecordFunctionFast)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("pose.check"):
            torch.ones(2).add_(1)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "pose.check" in names
