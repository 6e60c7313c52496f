"""The port's own copies of the JAX package's jax-free modules against the
originals, on the same inputs: `proto.text_format`, `proto.caffemodel`,
`data.window_file`, the host half of `pose.targets_device`, `pose.targets`
(its numpy and C++ rasterizers), `pose.augment`, `data.pipeline`
(`PoseDataSource`, `Prefetcher`, the process pool's bounded close).

Tolerance: none. The copies run the same numpy code on the same inputs and
the same seeded random streams, so every parse, file, array and batch is
compared for equality, byte for byte where it is a file.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from deepcut_tpu import runtime as j_runtime
from deepcut_tpu.data import pipeline as j_pipeline
from deepcut_tpu.data import window_file as j_wf
from deepcut_tpu.pose import targets as j_targets
from deepcut_tpu.pose import targets_device as j_td
from deepcut_tpu.proto import caffemodel as j_cm
from deepcut_tpu.proto import text_format as j_tf
from deepcut_tpu_torch import runtime as t_runtime
from deepcut_tpu_torch.data import pipeline as t_pipeline
from deepcut_tpu_torch.data import window_file as t_wf
from deepcut_tpu_torch.pose import targets as t_targets
from deepcut_tpu_torch.pose import targets_device as t_td
from deepcut_tpu_torch.proto import caffemodel as t_cm
from deepcut_tpu_torch.proto import text_format as t_tf

REPO = Path(__file__).resolve().parents[1]
PROTOTXTS = sorted(str(p.relative_to(REPO)) for p in (REPO / "examples").rglob("*.prototxt"))


def _equal_trees(a, b, where=""):
    """Dicts / lists / arrays / scalars equal, array for array."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, list(a), list(b))
        for k in a:
            _equal_trees(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{where}[{i}]")
    elif dataclasses.is_dataclass(a):
        _equal_trees(dataclasses.asdict(a), dataclasses.asdict(b), where)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (where, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=where)


@pytest.mark.parametrize("rel", PROTOTXTS)
def test_text_format_parse_and_dump_match(rel):
    text = (REPO / rel).read_text()
    got, want = t_tf.parse(text), j_tf.parse(text)
    assert t_tf.dump(got) == j_tf.dump(want)
    assert t_tf.dump(t_tf.parse(t_tf.dump(got))) == t_tf.dump(got)


def _params(rng):
    """A DeeperCut-shaped param tree in the JAX layout: convs, a deconv
    head, BN and Scale entries."""
    return {
        "conv1": {"w": rng.randn(7, 7, 3, 8).astype(np.float32),
                  "b": rng.randn(8).astype(np.float32)},
        "bn_conv1": {"mean": rng.randn(8).astype(np.float32), "var": rng.rand(8).astype(np.float32),
                     "scale_factor": np.ones(1, np.float32)},
        "scale_conv1": {"gamma": rng.randn(8).astype(np.float32),
                        "beta": rng.randn(8).astype(np.float32)},
        "res5c_up_pose": {"w": rng.randn(3, 3, 8, 14).astype(np.float32),
                          "b": rng.randn(14).astype(np.float32)},
        "res3d_pose": {"w": rng.randn(1, 1, 8, 14).astype(np.float32),
                       "b": rng.randn(14).astype(np.float32)},
    }


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_caffemodel_written_by_one_package_reads_in_the_other(tmp_path, writer):
    params = _params(np.random.RandomState(0))
    save = t_cm.save_caffemodel if writer == "port" else j_cm.save_caffemodel
    load = j_cm.load_deepercut_params if writer == "port" else t_cm.load_deepercut_params
    path = tmp_path / "w.caffemodel"
    save(str(path), params)
    _equal_trees(load(str(path)), params)
    other = tmp_path / "other.caffemodel"
    (j_cm.save_caffemodel if writer == "port" else t_cm.save_caffemodel)(str(other), params)
    assert path.read_bytes() == other.read_bytes()


def _records(rng, n=4, h=140, w=180, root=""):
    recs = []
    for i in range(n):
        people = []
        for _ in range(1 + i % 2):
            k = rng.randint(6, 15)
            classes = (rng.permutation(14)[:k] + 1).astype(np.int32)
            if i == 3:
                classes[-1] = 15  # a skip marker
            xy = np.stack([rng.uniform(5, w - 5, k), rng.uniform(5, h - 5, k)], 1)
            people.append(j_wf.Person(classes, xy.astype(np.float32)))
        recs.append(j_wf.ImageRecord(str(Path(root) / f"im{i}.png"), 3, h, w, people,
                                    multi=len(people) > 1))
    return recs


def _write_frames(root: Path, recs, seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    for r in recs:
        Image.fromarray(rng.randint(0, 256, (r.height, r.width, 3), np.uint8)).save(r.path)


def test_window_file_and_stats_parsing_match(tmp_path):
    recs = _records(np.random.RandomState(1))
    index = tmp_path / "index.txt"
    j_wf.write_window_file(str(index), recs)
    _equal_trees(t_wf.parse_window_file(str(index), "root/"),
                 j_wf.parse_window_file(str(index), "root/"))
    stats = tmp_path / "stats.txt"
    stats.write_text("# edges\n2 2\n1 2\n2 1\n# means\n2 2\n0.5 -1.25\n3 4\n"
                     "# std_devs\n2 2\n1 2\n3 0.5\n")
    _equal_trees(t_wf.parse_stats_file(str(stats)), j_wf.parse_stats_file(str(stats)))
    _equal_trees(t_wf.default_stats(14), j_wf.default_stats(14))


CFGS = {
    "default": {},
    "fg_fraction": dict(fg_fraction=0.25, bg_threshold=30.0),
    "soft_pairwise_jitter": dict(soft_labels=True, regress_to_other=True,
                                 scale_jitter_lo=0.8, scale_jitter_up=1.2, no_bg_class=True),
    "weight_targets": dict(weight_targets=True),
}


@pytest.mark.parametrize("name", list(CFGS))
def test_record_limits_and_compact_sample_match(name):
    recs = _records(np.random.RandomState(2))
    _equal_trees(t_td.record_limits(recs), j_td.record_limits(recs))
    tcfg, jcfg = t_targets.TargetConfig(**CFGS[name]), j_targets.TargetConfig(**CFGS[name])
    t_rng, j_rng = np.random.RandomState(3), np.random.RandomState(3)
    for rec in recs:
        got = t_td.compact_sample(rec, tcfg, None, t_rng, limits=t_td.record_limits(recs))
        want = j_td.compact_sample(rec, jcfg, None, j_rng, limits=j_td.record_limits(recs))
        _equal_trees(got, want, rec.path)
    assert t_rng.randint(1 << 30) == j_rng.randint(1 << 30)  # the streams stayed in step


@pytest.fixture
def numpy_rasterizers(monkeypatch):
    """Both packages on their numpy rasterizer."""
    monkeypatch.setattr(t_runtime, "load_library", lambda: None)
    monkeypatch.setattr(j_runtime, "_TRIED", True)
    monkeypatch.setattr(j_runtime, "_LIB", None)


@pytest.mark.parametrize("name", list(CFGS))
def test_rasterize_matches(name, numpy_rasterizers):
    recs = _records(np.random.RandomState(4))
    tcfg, jcfg = t_targets.TargetConfig(**CFGS[name]), j_targets.TargetConfig(**CFGS[name])
    t_rng, j_rng = np.random.RandomState(5), np.random.RandomState(5)
    for rec in recs:
        _equal_trees(t_targets.rasterize_native(rec, tcfg, None, t_rng),
                     j_targets.rasterize_native(rec, jcfg, None, j_rng), rec.path)


SOURCE_MODES = {
    "host_targets": dict(uint8_images=True),
    "device_targets": dict(uint8_images=True, device_targets=True),
    "augment_f32": dict(augment=True),
    "augment_device": dict(uint8_images=True, device_targets=True, augment_device=True),
    "cycle_threads": dict(uint8_images=True, cycle=True, workers=2),
}


def _batches(module, index, cfg, mode, n=3, batch=2):
    src = module.PoseDataSource(str(index), cfg, None, seed=7, **SOURCE_MODES[mode])
    try:
        return [src.next_batch(batch) for _ in range(n)]
    finally:
        src.close()


@pytest.mark.parametrize("mode", list(SOURCE_MODES))
def test_pose_data_source_batches_match_numpy_rasterizer(tmp_path, mode, numpy_rasterizers):
    recs = _records(np.random.RandomState(6), root=str(tmp_path))
    _write_frames(tmp_path, recs)
    index = tmp_path / "index.txt"
    j_wf.write_window_file(str(index), recs)
    kw = dict(fg_fraction=0.25, scale_jitter_lo=0.9, scale_jitter_up=1.1)
    _equal_trees(_batches(t_pipeline, index, t_targets.TargetConfig(**kw), mode),
                 _batches(j_pipeline, index, j_targets.TargetConfig(**kw), mode))


def test_pose_data_source_batches_match_through_the_native_rasterizer(tmp_path, monkeypatch):
    """The port's C++ rasterizer, built with g++ at first use, against the
    JAX package on its numpy path (which the JAX package's own tests hold
    equal to its C++ one): same batches."""
    monkeypatch.setattr(j_runtime, "_TRIED", True)
    monkeypatch.setattr(j_runtime, "_LIB", None)
    if not t_runtime.available():
        pytest.skip("no g++ to build the port's rasterizer")
    assert t_runtime.LIB.path().parent.parts[-2:] == ("build", "deepcut_tpu_torch")
    recs = _records(np.random.RandomState(8), root=str(tmp_path))
    _write_frames(tmp_path, recs, seed=1)
    index = tmp_path / "index.txt"
    j_wf.write_window_file(str(index), recs)
    kw = dict(regress_to_other=True, fg_fraction=0.25, bg_threshold=30.0)
    _equal_trees(_batches(t_pipeline, index, t_targets.TargetConfig(**kw), "host_targets"),
                 _batches(j_pipeline, index, j_targets.TargetConfig(**kw), "host_targets"))


def test_process_pool_closes_mid_pipeline_within_a_bounded_wait(tmp_path):
    """The port's process pool (2 workers) closed while the pipelined
    `batches()` stream still has a batch in flight: `close` lets that work
    finish and shuts the workers down, where terminating the pool could
    leave its task handler waiting forever. `close` runs in a daemon
    thread joined with a 60 s timeout, so a regression fails here instead
    of hanging the run. The batches equal the serial source's."""
    import threading

    recs = _records(np.random.RandomState(9), n=3, root=str(tmp_path))
    _write_frames(tmp_path, recs, seed=2)
    cfg = t_targets.TargetConfig(location_refinement=True)
    serial = t_pipeline.PoseDataSource(recs, cfg, seed=5, bucket_step=32, uint8_images=True)
    piped = t_pipeline.PoseDataSource(recs, cfg, seed=5, bucket_step=32, uint8_images=True,
                                      workers=2, worker_mode="process")
    closer = threading.Thread(target=piped.close, daemon=True)
    try:
        stream = piped.batches(2)
        for _ in range(2):
            _equal_trees(next(stream), serial.next_batch(2))
        assert piped._proc_pool._in_flight   # the next batch is in flight
    finally:
        closer.start()
        closer.join(timeout=60)
    assert not closer.is_alive(), "CanvasPool.close hung with work in flight"
    assert piped._proc_pool is None


def test_prefetcher_delivers_the_sources_batches_and_raises_its_errors():
    made = iter(range(5))
    pre = t_pipeline.Prefetcher(lambda: {"i": np.asarray(next(made))}, depth=2)
    try:
        assert [int(pre.get()["i"]) for _ in range(5)] == list(range(5))
        with pytest.raises(StopIteration):
            pre.get()
    finally:
        pre.stop()


def test_pckh_evaluate_matches():
    """pose/evaluate.py: PCKh, the head size, the report and the estimator
    loop (a missing pose scores every joint missed) equal to the original."""
    from deepcut_tpu.pose import evaluate as j_ev
    from deepcut_tpu_torch.pose import evaluate as t_ev

    rng = np.random.RandomState(9)
    gt = rng.uniform(0, 100, (6, 14, 2)).astype(np.float32)
    gt[1, 3] = np.nan
    pred = gt + rng.randn(6, 14, 2).astype(np.float32) * 8
    heads = rng.uniform(10, 30, 6).astype(np.float32)
    for t in (0.2, 0.5):
        _equal_trees(t_ev.pckh(pred, gt, heads, t), j_ev.pckh(pred, gt, heads, t))
    assert t_ev.head_size_from_box(1, 2, 30, 40) == j_ev.head_size_from_box(1, 2, 30, 40)
    assert t_ev.MPII_JOINT_NAMES == j_ev.MPII_JOINT_NAMES

    class Fixed:
        def __init__(self):
            self.poses = iter([np.vstack([pred[0].T, np.ones((1, 14))]), None])

        def estimate_pose(self, image, scales=None):
            return next(self.poses)

    samples = [{"image": None, "gt_xy": gt[i], "head_size": float(heads[i])} for i in range(2)]
    got, want = t_ev.evaluate_estimator(Fixed(), samples), j_ev.evaluate_estimator(Fixed(), samples)
    _equal_trees(got, want)
    assert t_ev.format_report(got) == j_ev.format_report(want)
