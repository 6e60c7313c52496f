"""The estimator's CUDA-graph path (`deepcut_tpu_torch.pose.graphs`) and its
chunk staging on the CPU.

A graph is captured and replayed only on the card, so here the rule that
chooses the path is checked as a predicate, the paths it refuses are run
and held bit-equal to the eager loop the estimator ran before graphs, and
the cache's bookkeeping is driven with the capture stubbed: a stub graph
whose replay runs the same forward over its static input. A shape is
captured at its second use, and a full cache gives a place only to a shape
used twice more than its least recent graph. The card check
(chip_smoke.py --pose-graphs) holds real replays bit-equal to the eager
path.

The batched paths stage a chunk's frames as one (one upload and one
preprocess per frame size) and enqueue each chunk's network before the next
chunk's canvases: canvases and poses are held bit-equal to each frame's
canvas made alone, as the estimator made it before (`_frame_canvas`), and a
recording stub holds the order.
"""

import contextlib
import copy
import sys
import threading

import numpy as np
import pytest
import torch

from deepcut_tpu_torch import native
from deepcut_tpu_torch.constants import MEAN_BGR
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


def _frame_canvas(image, scale, canvas_h, canvas_w):
    """One frame's (1, canvas_h, canvas_w, 3) canvas as the estimator made
    it before chunks were staged: the frame alone, padded by edge
    replication, resized by the two rounded matrix products, the mean
    taken off, pasted into a zero canvas."""
    h, w = image.shape[:2]
    ph, pw = h + estimate.PAD_SIZE, w + estimate.PAD_SIZE
    out_h, out_w = estimate._resized_size(h, scale), estimate._resized_size(w, scale)
    u8 = torch.from_numpy(np.ascontiguousarray(image))
    rows = torch.clamp(torch.arange(ph), max=h - 1)
    cols = torch.clamp(torch.arange(pw), max=w - 1)
    img = u8[rows][:, cols].to(torch.float32)
    if (out_h, out_w) != (ph, pw):
        Ah = torch.from_numpy(estimate._bilinear_matrix(ph, out_h))
        Aw = torch.from_numpy(estimate._bilinear_matrix(pw, out_w))
        img = estimate._round_half_up(torch.einsum("ow,hwc->hoc", Aw, img))
        img = estimate._round_half_up(torch.einsum("oh,hwc->owc", Ah, img))
    img = img - torch.tensor(MEAN_BGR, dtype=torch.float32)
    ch, cw = min(canvas_h, out_h), min(canvas_w, out_w)
    canvas = torch.zeros((1, canvas_h, canvas_w, 3), dtype=torch.float32)
    canvas[0, :ch, :cw] = img[:ch, :cw]
    return canvas


def _before_graphs(est, frames, scale=1.0):
    """estimate_pose_batch (or one canvas bucket of estimate_pose_many) as
    the estimator computed it before graphs and staged chunks: every
    frame's canvas alone (`_frame_canvas`), then chunk by chunk the network
    eagerly and the fused decode, each frame masked to its own grid."""
    ch = [estimate.canvas_size(im.shape[0], scale) for im in frames]
    cw = [estimate.canvas_size(im.shape[1], scale) for im in frames]
    bh, bw = estimate._bucket(ch[0], est.bucket_step), estimate._bucket(cw[0], est.bucket_step)
    canvases = torch.cat([_frame_canvas(im, scale, bh, bw) for im in frames])
    c, stride = est.BATCH_CHUNK, 8
    poses = []
    for i in range(0, canvases.shape[0], c):
        with torch.inference_mode():
            fused = est.model.fused_heads(canvases[i:i + c].permute(0, 3, 1, 2),
                                          heads=estimate.HEADS)
        fused = fused.to(torch.float32, memory_format=torch.channels_last)
        poses.append(cuda_decode.decode_fused(fused, CFG.num_joints,
                                              [-(-v // stride) for v in ch[i:i + c]],
                                              [-(-v // stride) for v in cw[i:i + c]], scale))
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
                               static_out, {"conv_epilogue": STUB_LAUNCHES})

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
        return graphs.NetGraph(static_in, _StubGraph(fwd, static_in, static_out), static_out, {})

    return graphs.NetGraphs(forward, forward, capacity, lambda: True), captured, capture


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


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_int8_copy_runs_its_own_model(graphed, request):
    """A ``copy.copy`` quantized to int8 (the demo's and the HTTP service's
    private estimator) runs its own int8 network, never its original's
    forward or graphs, and counts its own calls; the original keeps its
    graphs and its answers."""
    if graphed:
        request.getfixturevalue("stubbed")
    est = _estimator()
    frames = _frames(5)
    want = _before_graphs(est, frames)
    for _ in range(2):   # graphed: first sight, then captured
        np.testing.assert_array_equal(est.estimate_pose_batch(frames), want)
    held, stats = list(est._graphs.entries), dict(est.graph_stats)
    q = copy.copy(est)
    q.quantize_int8(frames[0])
    want_q = _before_graphs(q, frames)
    assert not np.array_equal(want_q, want)
    for _ in range(3):
        np.testing.assert_array_equal(q.estimate_pose_batch(frames), want_q)
        np.testing.assert_array_equal(est.estimate_pose_batch(frames), want)
    assert list(est._graphs.entries) == held
    assert est.graph_stats == {**stats, ("replays" if graphed else "eager"): stats[
        "replays" if graphed else "eager"] + 6}
    assert q.graph_stats == ({"captures": 2, "replays": 4, "eager": 4} if graphed
                             else {"captures": 0, "replays": 0, "eager": 6})


def test_capture_counts_only_its_own_thread(monkeypatch):
    """A capture keeps in its graph's tally, and out of the live counts,
    the launches its own thread recorded (`native.tally`); another
    thread's launches meanwhile stay counted and stay out of the tally."""
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
        native.add_counts({"conv_epilogue": STUB_LAUNCHES})   # as the forward's epilogues count
        if capturing:                                         # an eager forward elsewhere
            t = threading.Thread(target=native.add_counts, args=({"conv_epilogue": 100},))
            t.start()
            t.join()
        return x * 2

    before = conv_epilogue.launches
    entry = graphs.capture(forward, torch.ones(1, 2, 2, 3), "pool")
    assert entry.launches == {"conv_epilogue": STUB_LAUNCHES} and entry.graph == "graph"
    # the warm-up's launches ran, the other thread's ran, the capture's did not
    assert conv_epilogue.launches - before == STUB_LAUNCHES + 100
    native.add_counts({"conv_epilogue": -(STUB_LAUNCHES + 100)})


def test_add_launches_counts_from_threads():
    """Eight threads count at once: the live count takes every launch
    exactly, and each thread's tally holds its own launches alone."""
    before, mine = conv_epilogue.launches, {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def add(n):
        for _ in range(2000):
            native.add_counts({"conv_epilogue": n})
        with native.tally() as own:
            for _ in range(2000):
                native.add_counts({"conv_epilogue": n})
        mine[n] = own["conv_epilogue"]

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
    native.add_counts({"conv_epilogue": -2000 * 9})
    assert conv_epilogue.launches == before


# -- chunk staging ---------------------------------------------------------------
MIXED = [(40, 48), (36, 44), (40, 48), (33, 48), (40, 48)]   # one 64x64 bucket at 1.0 and 0.8


@pytest.mark.parametrize("scale", [1.0, 0.8])
@pytest.mark.parametrize("sizes", [[(40, 48)], [(40, 48)] * 5, MIXED],
                         ids=["one", "same-size", "mixed"])
def test_chunk_canvases_bit_equal_to_each_frame_alone(scale, sizes):
    """A chunk's canvases, staged as one per frame size, against each
    frame's made alone; a BGR view with negative strides among them."""
    est = _estimator()
    frames = [_frames(1, h, w, seed=k)[0] for k, (h, w) in enumerate(sizes)]
    frames[0] = frames[0][:, :, ::-1]
    got = est._canvases(frames, scale, 64, 64)
    want = torch.cat([_frame_canvas(im, scale, 64, 64) for im in frames])
    assert got.shape == (len(frames), 64, 64, 3) and torch.equal(got, want)
    assert torch.equal(est._canvas(frames[-1], scale, 64, 64), want[-1:])


def test_upload_keeps_plain_tensors_on_the_cpu():
    est = _estimator()
    frames = _frames(3)
    frames[1] = frames[1][:, ::-1]
    up = est._upload(frames)
    assert up.device.type == "cpu" and up.dtype == torch.uint8 and not up.is_pinned()
    np.testing.assert_array_equal(up.numpy(), np.stack(frames))


@contextlib.contextmanager
def _frame_canvases(est):
    """`est`'s single-frame canvases made as before chunks were staged."""
    est._canvas = lambda im, scale, h, w: _frame_canvas(im, scale, h, w)
    try:
        yield
    finally:
        del est._canvas


@pytest.mark.parametrize("scale", [1.0, 0.8])
@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_staged_poses_bit_equal_to_each_frame_alone(scale, graphed, request):
    """estimate_pose, estimate_pose_batch at 8 and 5 frames, and
    estimate_pose_many over mixed sizes in two buckets with a frame on the
    tiled path, each pose bit-equal to the path that made every canvas
    alone; on the graph path (stubbed) on first sight, capture and replay."""
    if graphed:
        request.getfixturevalue("stubbed")
    est = _estimator()
    est.max_size = 512
    frames = _frames(8)
    mixed = [_frames(1, h, w, seed=10 + k)[0] for k, (h, w) in enumerate(MIXED)]
    tall = _frames(2, 100, 48, seed=20)
    hd = _frames(1, 330, 700, seed=30)[0]   # canvas wider than max_size at 1.0 and 0.8
    many = [mixed[0], tall[0], mixed[1], hd, mixed[2], tall[1], mixed[3], mixed[4]]
    want_many = np.zeros((len(many), 5, 3), np.float32)
    want_many[[0, 2, 4, 6, 7]] = _before_graphs(est, mixed, scale)
    want_many[[1, 5]] = _before_graphs(est, tall, scale)
    with _frame_canvases(est):
        want_many[3] = est._decode_whole(*est._scoremaps_tiled(hd, scale), scale)
    for _ in range(3 if graphed else 1):   # first sight, capture, replay
        np.testing.assert_array_equal(est.estimate_pose(frames[0], [scale]),
                                      _before_graphs(est, frames[:1], scale)[0])
        for n in (8, 5):
            np.testing.assert_array_equal(est.estimate_pose_batch(frames[:n], scale),
                                          _before_graphs(est, frames[:n], scale))
        np.testing.assert_array_equal(est.estimate_pose_many(many, scale), want_many)
    if graphed:
        assert est.graph_stats["replays"] > 0


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_chunk_network_enqueued_before_next_canvases(graphed, request, monkeypatch):
    """A recording stub: each chunk's network comes right after its
    canvases and before the next chunk's preprocess, and the call waits
    once, at its end (estimate_pose_many: once for all its buckets)."""
    if graphed:
        request.getfixturevalue("stubbed")
    est = _estimator()
    log = []
    preprocess, run, eager, wait = (estimate.preprocess_on_device, est._graphs.run,
                                    est._net_eager, est._wait)

    def logged(kind, fn):
        def call(x, *a, **k):
            log.append((kind, len(x)))
            return fn(x, *a, **k)
        return call

    monkeypatch.setattr(estimate, "preprocess_on_device", logged("canvas", preprocess))
    monkeypatch.setattr(est._graphs, "run", logged("net", run))
    monkeypatch.setattr(est, "_net_eager", logged("net", eager))
    monkeypatch.setattr(est, "_wait", logged("wait", wait))
    small, tall = _frames(5), _frames(2, 100, 48, seed=2)
    for _ in range(3 if graphed else 1):   # first sight, capture, replay
        log.clear()
        est.estimate_pose_batch(_frames(8))
        assert log == [("canvas", 4), ("net", 4), ("canvas", 4), ("net", 4), ("wait", 8)]
        log.clear()
        est.estimate_pose_many([small[0], tall[0], small[1], small[2], tall[1], small[3], small[4]])
        assert log == [("canvas", 4), ("net", 4), ("canvas", 1), ("net", 1),
                       ("canvas", 2), ("net", 2), ("wait", 7)]
