"""The program's spans as the benchmark reads them (`portbench.spans`): the
interval arithmetic on hand-made intervals, `trace.summarize` on a stub
event stream with and without span events, and `collect` over a real CPU
profile of the port's estimator and graph engine."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from portbench import spans as ps
from portbench.trace import _union, summarize


def rec(program, items=1):
    return {"trace": {"items": items, "program": program}}


def test_union_and_overlap():
    assert _union([[5, 9], [0, 2], [1, 3], [9, 10]]) == [[0, 3], [5, 10]]
    a, b = [[0, 10], [20, 30]], [[5, 25], [28, 40]]
    assert ps.overlap_ns(a, b) == 5 + 5 + 2
    assert ps.overlap_ns(a, []) == 0 and ps.total_ns(a) == 20


def test_span_time_per_item_less_its_waits():
    """Nested calls count once; the waits inside them come off."""
    p = {"spans": {"pose.call": [[0, 4_000_000], [1_000_000, 2_000_000], [6_000_000, 8_000_000]],
                   "pose.wait": [[3_000_000, 4_000_000], [7_500_000, 8_000_000]]},
         "busy": None, "window": None}
    assert ps.span_ms_per_item(rec(p, 2), "pose.call") == pytest.approx(3.0)
    assert ps.span_ms_per_item(rec(p, 2), "pose.call", minus="pose.wait") == pytest.approx(2.25)
    assert ps.span_ms_per_item(rec(p), "pose.net") is None
    assert ps.span_ms_per_item({"trace": {"items": 1}}, "pose.call") is None
    assert ps.span_ms_per_item({"trace": None}, "pose.call") is None


def test_idle_inside_and_outside_a_span_by_overlap():
    """Window [0, 100), device busy [10, 30) and [60, 70): idle 70. The span
    [25, 65) straddles both edges of the idle gap [30, 60): 30 inside it,
    40 outside; off the card (busy None) both are None."""
    p = {"spans": {"pose.net": [[25, 65]]}, "busy": [[10, 30], [60, 70]], "window": [0, 100]}
    assert ps.idle_pct(rec(p), "pose.net", inside=True) == pytest.approx(30.0)
    assert ps.idle_pct(rec(p), "pose.net", inside=False) == pytest.approx(40.0)
    clipped = dict(p, busy=[[-20, 5], [10, 30], [60, 70], [95, 130]])
    assert ps.idle_pct(rec(clipped), "pose.net", inside=False) == pytest.approx(30.0)
    assert ps.idle_pct(rec(dict(p, busy=None)), "pose.net", inside=True) is None
    assert ps.idle_pct(rec(p), "pose.call", inside=False) is None


class Ev:
    """A stub of the profiler's raw event."""

    def __init__(self, name, start, end, device=False):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU

    def is_hidden_event(self):
        return False


STREAM = [Ev("ProfilerStep#1", 0, 1000), Ev("ProfilerStep#1", 0, 1000, device=True),
          Ev("aten::conv", 100, 300), Ev("cudaLaunchKernel", 120, 130),
          Ev("kernel_a", 150, 250, device=True), Ev("kernel_b", 400, 500, device=True),
          Ev("aten::copy_", 600, 700), Ev("kernel_a", 800, 900, device=True)]
SPANS = [Ev("pose.call", 50, 950), Ev("pose.net", 90, 450), Ev("pose.wait", 550, 750)]


def test_summarize_unchanged_by_span_events():
    """busy_s, kernels and the gaps' total are those of the stream without
    spans; a gap where no host op ran is labelled by the span around it."""
    plain, spanned = summarize(STREAM), summarize(STREAM + SPANS)
    assert spanned["busy_s"] == plain["busy_s"] == pytest.approx(300e-9)
    assert spanned["kernels"] == plain["kernels"]
    assert sum(spanned["gaps"].values()) == pytest.approx(sum(plain["gaps"].values()))
    assert plain["gaps"] == pytest.approx({"no host op recorded": 150e-9, "aten::copy_": 300e-9})
    assert spanned["gaps"] == pytest.approx({"pose.net": 150e-9, "aten::copy_": 300e-9})
    got = ps.collect(STREAM + SPANS)
    assert got["busy"] == [[150, 250], [400, 500], [800, 900]] and got["window"] == [0, 1000]
    assert set(got["spans"]) == {"pose.call", "pose.net", "pose.wait"}
    # idle: [0, 150), [250, 400), [500, 800), [900, 1000)
    assert ps.idle_pct(rec(got), "pose.net", inside=True) == pytest.approx(21.0)
    assert ps.idle_pct(rec(got), "pose.call", inside=False) == pytest.approx(10.0)


def _traced(fn, calls=2):
    """fn() as profile_calls runs calls: a warm-up step, then a traced one."""
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        prof.step()
        for _ in range(calls):
            fn()
        prof.step()
    return ps.collect(prof.profiler.kineto_results.events())


def test_collect_on_the_estimator_and_graph_engine():
    """A CPU profile of the port: the span times of the five host metrics
    read numbers, the pose spans nest within the call less its wait, and the
    idle shares read None without a device."""
    from deepcut_tpu_torch.core.graph import Net
    from deepcut_tpu_torch.models.resnet import DeeperCutConfig, init_params
    from deepcut_tpu_torch.pose.estimate import PoseEstimator
    from deepcut_tpu_torch.proto import text_format

    cfg = DeeperCutConfig(depths=(1, 1, 1, 1), stage_widths=(4, 4, 8, 8), num_joints=3)
    est = PoseEstimator(init_params(torch.Generator().manual_seed(0), cfg), cfg, device="cpu")
    frames = [np.random.RandomState(k).randint(0, 256, (40, 48, 3), np.uint8) for k in range(5)]
    p = _traced(lambda: est.estimate_pose_batch(frames))
    assert p["busy"] is None and p["window"] is not None
    assert {len(v) for v in p["spans"].values()} == {2, 10, 4} and len(p["spans"]) == 5
    r = rec(p, items=10)
    call = ps.span_ms_per_item(r, "pose.call", minus="pose.wait")
    parts = [ps.span_ms_per_item(r, n) for n in ("pose.canvas", "pose.net", "pose.decode")]
    assert call > 0 and all(v > 0 for v in parts) and sum(parts) <= call
    lo, hi = p["window"]
    assert all(lo <= a <= b <= hi for v in p["spans"].values() for a, b in v)
    assert ps.idle_pct(r, "pose.net", inside=True) is None
    assert ps.idle_pct(r, "pose.call", inside=False) is None

    net = Net(text_format.parse("""
        input: "data" input_shape { dim: 2 dim: 3 dim: 8 dim: 8 }
        layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
                inner_product_param { num_output: 4 } }
        layer { name: "prob" type: "Softmax" bottom: "ip" top: "prob" }"""), device="cpu")
    fwd, x = net.make_forward(["prob"]), {"data": torch.ones(2, 3, 8, 8)}
    g = _traced(lambda: fwd(net.params, x))
    assert sorted(g["spans"]) == ["graph.forward", "graph.ip", "graph.prob"]
    assert ps.span_ms_per_item(rec(g, items=4), "graph.forward") > 0
    assert ps.idle_pct(rec(g, items=4), "graph.forward", inside=False) is None
