"""The estimator's CUDA-graph path (`deepcut_tpu_torch.pose.graphs`) on the CPU.

A graph is captured and replayed only on the card, so here the rule that
chooses the path is checked as a predicate, the paths it refuses are run
and held bit-equal to the eager loop the estimator ran before graphs, and
the cache's bookkeeping is driven with the capture stubbed: a stub graph
whose replay runs the same forward over its static input. A shape is
captured at its second use, and a full cache gives a place only to a shape
used twice more than its least recent graph. The card check
(chip_smoke.py --pose-graphs) holds real replays bit-equal to the eager
path.
"""

import contextlib
import sys
import threading

import numpy as np
import pytest
import torch

from deepcut_tpu_torch.models.resnet import DeeperCutConfig, init_params
from deepcut_tpu_torch.ops import conv_epilogue, cuda_decode
from deepcut_tpu_torch.pose import estimate, graphs

CFG = DeeperCutConfig(depths=(1, 1, 1, 1), stage_widths=(4, 4, 8, 8), num_joints=3)
STUB_LAUNCHES = 7   # the stub graph's conv epilogue launches per replay


def _estimator(folded=True):
    return estimate.PoseEstimator(init_params(torch.Generator().manual_seed(0), CFG), CFG,
                                  folded=folded, device="cpu")


def _frames(n, h=40, w=48, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3), np.uint8) for _ in range(n)]


def _before_graphs(est, frames, scale=1.0):
    """estimate_pose_batch as the estimator computed it before graphs:
    chunk by chunk, the network eagerly, the fused decode."""
    h, w = frames[0].shape[:2]
    ch, cw = estimate.canvas_size(h, scale), estimate.canvas_size(w, scale)
    bh, bw = estimate._bucket(ch, est.bucket_step), estimate._bucket(cw, est.bucket_step)
    canvases = torch.cat([est._canvas(im, scale, bh, bw) for im in frames])
    c, stride = est.BATCH_CHUNK, 8
    poses = []
    for i in range(0, canvases.shape[0], c):
        with torch.inference_mode():
            fused = est.model.fused_heads(canvases[i:i + c].permute(0, 3, 1, 2),
                                          heads=estimate.HEADS)
        fused = fused.to(torch.float32, memory_format=torch.channels_last)
        n = fused.shape[0]
        poses.append(cuda_decode.decode_fused(fused, CFG.num_joints, [-(-ch // stride)] * n,
                                              [-(-cw // stride)] * n, scale))
    return torch.cat(poses).numpy()


class _StubGraph:
    """Stands for a captured graph: a replay runs the forward again over
    the static input, into the static output."""

    def __init__(self, forward, static_in, static_out):
        self.forward, self.static_in, self.static_out = forward, static_in, static_out

    def replay(self):
        with torch.inference_mode():
            self.static_out.copy_(self.forward(self.static_in))


@pytest.fixture
def stubbed(monkeypatch):
    """Captures stubbed (each logged by its chunk shape) and every CPU
    estimator taking the graph path."""
    captured = []

    def capture(forward, chunk, pool):
        assert pool == "pool"
        captured.append(tuple(chunk.shape[:3]))
        static_in = chunk.clone()
        with torch.inference_mode():
            static_out = forward(static_in)
        return graphs.NetGraph(static_in, _StubGraph(forward, static_in, static_out),
                               static_out, STUB_LAUNCHES)

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(estimate.PoseEstimator, "_graphable", lambda self: True)
    return captured


@pytest.mark.parametrize("device,folded,int8,mesh,graphed", [
    ("cuda", True, False, False, True),
    ("cpu", True, False, False, False),
    ("cuda", False, False, False, False),
    ("cuda", True, True, False, False),
    ("cuda", True, False, True, False),
])
def test_graph_rule(device, folded, int8, mesh, graphed):
    est = _estimator()
    est.device, est.folded, est._int8 = torch.device(device), folded, int8
    est.mesh = object() if mesh else None
    assert est._graphable() is graphed


@pytest.mark.parametrize("kind", ["folded", "unfolded", "int8"])
def test_eager_paths_unchanged(kind, monkeypatch):
    """The CPU (folded or not) and the int8 model never capture, and give
    what the eager loop gave before graphs, bit for bit."""
    monkeypatch.setattr(graphs, "capture", lambda *a: pytest.fail("captured"))
    est = _estimator(folded=kind != "unfolded")
    frames = _frames(5)
    if kind == "int8":
        est.quantize_int8(frames[0])
    assert not est._graphable()
    got = est.estimate_pose_batch(frames)
    np.testing.assert_array_equal(got, _before_graphs(est, frames))
    np.testing.assert_array_equal(est.estimate_pose(frames[0]), _before_graphs(est, frames[:1])[0])
    assert est.graph_stats == {"captures": 0, "replays": 0, "eager": 3}   # 4 + 1, then 1


def test_graph_cache_keys_and_counts(stubbed):
    est = _estimator()
    frames = _frames(5)
    want = _before_graphs(est, frames)
    before = conv_epilogue.launches
    np.testing.assert_array_equal(est.estimate_pose_batch(frames), want)
    assert stubbed == [] and est.graph_stats == {"captures": 0, "replays": 0, "eager": 2}
    np.testing.assert_array_equal(est.estimate_pose_batch(frames), want)
    # the full chunk and the remainder each have their own key (40x48 -> the 64x64 bucket)
    assert stubbed == [(4, 64, 64), (1, 64, 64)]
    assert list(est._graphs.entries) == [(4, 64, 64), (1, 64, 64)]
    assert est.graph_stats == {"captures": 2, "replays": 2, "eager": 4}   # with the warm-ups
    np.testing.assert_array_equal(est.estimate_pose_batch(frames), want)
    np.testing.assert_array_equal(est.estimate_pose(frames[3]), want[3])
    assert stubbed == [(4, 64, 64), (1, 64, 64)]   # no capture after a shape's second chunk
    assert est.graph_stats == {"captures": 2, "replays": 5, "eager": 4}
    assert conv_epilogue.launches - before == 5 * STUB_LAUNCHES   # each replay's launches


def test_graph_cache_least_recently_used(stubbed, monkeypatch):
    monkeypatch.setattr(estimate.PoseEstimator, "GRAPH_SHAPES", 2)
    est = _estimator()
    a, b, c, d = (_frames(1, h, 48, seed=h)[0] for h in (40, 100, 160, 220))
    for im in (a, a, b, b, a):   # a used again after b: b is the least recent
        est.estimate_pose(im)
    assert list(est._graphs.entries) == [(1, 128, 64), (1, 64, 64)]
    for _ in range(3):           # c used 3 times, b twice: no place yet
        np.testing.assert_array_equal(est.estimate_pose(c), _before_graphs(est, [c])[0])
    assert stubbed == [(1, 64, 64), (1, 128, 64)]
    est.estimate_pose(c)         # 4 uses, 2 more than b's: b gives way
    assert list(est._graphs.entries) == [(1, 64, 64), (1, 192, 64)]
    np.testing.assert_array_equal(est.estimate_pose(b), _before_graphs(est, [b])[0])
    est.estimate_pose(d)         # b (3 uses) and d (1) stay eager
    assert list(est._graphs.entries) == [(1, 64, 64), (1, 192, 64)]
    assert stubbed == [(1, 64, 64), (1, 128, 64), (1, 192, 64)]
    assert est.graph_stats == {"captures": 3, "replays": 4, "eager": 10}


def _counting_graphs(capacity):
    """A NetGraphs over a doubling forward, its captures stubbed and logged."""
    captured = []

    def forward(x):
        return x * 2

    def capture(fwd, chunk, pool):
        captured.append(tuple(chunk.shape[:3]))
        static_in = chunk.clone()
        static_out = fwd(static_in)
        return graphs.NetGraph(static_in, _StubGraph(fwd, static_in, static_out), static_out, 0)

    return graphs.NetGraphs(forward, forward, capacity), captured, capture


@pytest.mark.parametrize("shapes,rounds", [(3, 12), (10, 40)])
def test_graph_rotation_does_not_thrash(shapes, rounds, monkeypatch):
    """A rotation over more shapes than the cache holds: the first round
    eager, the second captures the cache's fill, then no capture at all,
    across the use counts' halvings too; every answer the forward's."""
    cap = 2 if shapes == 3 else 8
    g, captured, capture = _counting_graphs(cap)
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    assert shapes * rounds > graphs.AGE * cap   # at least one halving
    for r in range(rounds):
        for k in range(shapes):
            x = torch.full((1, k + 1, 1, 3), float(r))
            torch.testing.assert_close(g.run(x, lambda m: m.clone()), x * 2, rtol=0, atol=0)
        assert len(captured) == (0 if r == 0 else cap)
    assert g.stats["captures"] == cap
    assert g.stats["replays"] == (rounds - 1) * cap
    assert g.stats["eager"] == shapes + (rounds - 1) * (shapes - cap) + cap


def test_graph_cache_ages_out_stale_shapes(monkeypatch):
    """A shape that stops coming gives way to a new one within a few dozen
    uses, however often it was used before: the halvings forget it."""
    g, captured, capture = _counting_graphs(1)
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    old, new = torch.ones(1, 2, 1, 3), torch.ones(1, 3, 1, 3)
    for _ in range(60):
        g.run(old, lambda m: None)
    assert captured == [(1, 2, 1)]
    for n in range(1, 21):
        g.run(new, lambda m: None)
        if len(captured) == 2:
            break
    assert captured == [(1, 2, 1), (1, 3, 1)] and list(g.entries) == [(1, 3, 1)]
    assert n < 60 // 2


def test_graph_one_off_shapes_stay_eager(stubbed):
    """Frames of sizes seen once each never capture."""
    est = _estimator()
    frames = [_frames(1, h, w, seed=h)[0] for h, w in ((40, 48), (100, 48), (40, 130), (160, 160))]
    for im in frames:
        np.testing.assert_array_equal(est.estimate_pose(im), _before_graphs(est, [im])[0])
    assert stubbed == [] and est.graph_stats == {"captures": 0, "replays": 0, "eager": 4}


def test_graph_many_buckets(stubbed):
    """estimate_pose_many over two buckets: a key per bucket, poses as
    each bucket's eager batch."""
    est = _estimator()
    small, large = _frames(3, 40, 48), _frames(2, 100, 48, seed=2)
    for _ in range(2):   # first sight eager, then captured
        got = est.estimate_pose_many([small[0], large[0], small[1], large[1], small[2]])
        np.testing.assert_array_equal(got[[0, 2, 4]], _before_graphs(est, small))
        np.testing.assert_array_equal(got[[1, 3]], _before_graphs(est, large))
    assert sorted(stubbed) == [(2, 128, 64), (3, 64, 64)]


def test_graph_threads_get_the_serial_answers(stubbed):
    est = _estimator()
    batches = [_frames(5, seed=s) for s in range(4)]
    serial = [est.estimate_pose_batch(b) for b in batches]
    out = [None] * 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: out.__setitem__(
            k, est.estimate_pose_batch(batches[k % 4]))) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for k in range(8):
        np.testing.assert_array_equal(out[k], serial[k % 4])
    # serial: 2 eager calls, then 2 captures with their replays, then 4 replays
    assert est.graph_stats["replays"] == 2 + 4 + 2 * 8 and est.graph_stats["captures"] == 2


def test_capture_counts_only_its_own_thread(monkeypatch):
    """A capture keeps, and takes back off the counter, the launches its
    own thread recorded; another thread's launches meanwhile stay counted
    and stay out of the graph's count."""
    class _Stream:
        def wait_stream(self, other):
            pass

    capturing = []

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode="global"):
        capturing.append(g)
        yield
        capturing.pop()

    monkeypatch.setattr(torch.cuda, "Stream", lambda dev=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: "graph")
    monkeypatch.setattr(torch.cuda, "graph", graph)

    def forward(x):
        conv_epilogue.add_launches(STUB_LAUNCHES)   # as the forward's epilogues count
        if capturing:                               # an eager forward elsewhere
            t = threading.Thread(target=conv_epilogue.add_launches, args=(100,))
            t.start()
            t.join()
        return x * 2

    before = conv_epilogue.launches
    entry = graphs.capture(forward, torch.ones(1, 2, 2, 3), "pool")
    assert entry.launches == STUB_LAUNCHES and entry.graph == "graph"
    # the warm-up's launches ran, the other thread's ran, the capture's did not
    assert conv_epilogue.launches - before == STUB_LAUNCHES + 100
    conv_epilogue.add_launches(-(STUB_LAUNCHES + 100))


def test_add_launches_counts_from_threads():
    before, mine = conv_epilogue.launches, {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def add(n):
        start = conv_epilogue.thread_launches()
        for _ in range(2000):
            conv_epilogue.add_launches(n)
        mine[n] = conv_epilogue.thread_launches() - start

    try:
        threads = [threading.Thread(target=add, args=(n,)) for n in (3, -1, 5, -2, 7, 4, 2, -9)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert conv_epilogue.launches - before == 2000 * 9
    assert mine == {n: 2000 * n for n in (3, -1, 5, -2, 7, 4, 2, -9)}   # each thread its own
    conv_epilogue.add_launches(-2000 * 9)
    assert conv_epilogue.launches == before
