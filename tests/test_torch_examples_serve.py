"""The port's HTTP front ends (`deepcut_tpu_torch.examples.pose.serve`,
`deepcut_tpu_torch.examples.web_demo.app`) against the JAX package's
(`examples/pose/serve.py`, `examples/web_demo/app.py`), on the CPU.

The pose service: both packages' estimators carry the same tamed numpy
params (the tiny DeeperCut of tests/test_torch_estimate.py, f32 unfolded)
and both services take the same PNG uploads. The served poses are rounded
by the service (`pose` to 4 decimals, `x` / `y` to 2), so they are
compared after that rounding: within `POSE_TOL` of the JAX service's, and
within one rounding step (2e-4) of the port's own `estimate_pose`. int8
answers of the port's service equal, after the rounding, its estimator's
own int8 poses on the same calibration frame. Dynamic batching groups
concurrent requests (batches_run < images_run). Four threads making their
first request together answer what serial requests answer; the service
runs its estimator on one long-lived thread, and the estimator itself,
called from four new threads at once, gives the serial poses too.

The web demo: the same CaffeNet-like deploy net and `.caffemodel` (written
by the JAX package) behind both services; the top-5 labels are equal and
their probabilities (rounded to 5 decimals by the service) within 1e-5.
"""

import importlib.util
import io as pyio
import json
import sys
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import deepcut_tpu.compat as j_caffe
from deepcut_tpu.pose import estimate as je
from deepcut_tpu.proto.caffemodel import save_caffemodel as j_save_caffemodel
from deepcut_tpu_torch.examples.pose import serve as t_serve
from deepcut_tpu_torch.examples.web_demo import app as t_app
from deepcut_tpu_torch.models.convert import params_from_numpy
from deepcut_tpu_torch.pose import estimate as te
from test_torch_estimate import JCFG, POSE_TOL, TCFG, _frame, _params
from test_torch_frontends import CLASSIFIER
from test_torch_graph import tame_params as graph_tame_params

REPO = Path(__file__).resolve().parents[1]
ROUND_TOL = 2e-4   # one 4-decimal rounding step, with room for the f32 -> f64 cast


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


j_serve = _load("j_pose_serve", "examples/pose/serve.py")
j_app = _load("j_web_demo_app", "examples/web_demo/app.py")


def _estimators():
    params = _params()
    jest = je.PoseEstimator(jax.tree_util.tree_map(jnp.asarray, params), JCFG, folded=False,
                            bucket_step=64, max_size=256)
    test = te.PoseEstimator(params_from_numpy(params), TCFG, folded=False, bucket_step=64,
                            max_size=256, device="cpu")
    return jest, test


def _png(img_bgr):
    buf = pyio.BytesIO()
    Image.fromarray(img_bgr[:, :, ::-1]).save(buf, format="PNG")
    return buf.getvalue()


def _multipart(payload: bytes, boundary="portboundary", name="f.png"):
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
            f"filename=\"{name}\"\r\nContent-Type: image/png\r\n\r\n").encode() \
        + payload + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _post(httpd, path, payload):
    body, headers = _multipart(payload)
    req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}{path}",
                                 data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(httpd):
    with urllib.request.urlopen(f"http://127.0.0.1:{httpd.server_address[1]}/",
                                timeout=60) as r:
        return r.read()


def _served(resp):
    assert resp["ok"], resp
    return np.asarray(resp["pose"], np.float64)


def _rounded(pose):
    """A pose as the service rounds it into its JSON answer."""
    return [[round(float(v), 4) for v in row] for row in np.asarray(pose, np.float64)]


@pytest.fixture
def servers():
    started = []

    def start(mod, app):
        httpd = mod.serve(app, port=0, background=True)
        started.append(httpd)
        return httpd
    yield start
    for httpd in started:
        httpd.shutdown()
        httpd.server_close()


# -- the pose service ---------------------------------------------------------------
def test_pose_serve_roundtrip_matches_jax(servers):
    jest, test = _estimators()
    jh = servers(j_serve, j_serve.PoseApp(estimator=jest))
    th = servers(t_serve, t_serve.PoseApp(estimator=test))
    assert _get(th) == _get(jh).replace(b"deepcut_tpu ", b"deepcut_tpu_torch ")
    for seed, (h, w) in ((1, (48, 64)), (2, (100, 140))):
        img = _frame(seed, h, w)
        got, want = _post(th, "/estimate", _png(img)), _post(jh, "/estimate", _png(img))
        assert got.keys() == want.keys() == {"ok", "pose", "joints"}
        assert [j["name"] for j in got["joints"]] == [j["name"] for j in want["joints"]]
        assert _served(got).shape == (5, 3)
        np.testing.assert_allclose(_served(got), _served(want), **POSE_TOL)
        np.testing.assert_allclose(_served(got), _rounded(test.estimate_pose(img)),
                                   rtol=0, atol=ROUND_TOL)
        xy = [[j["x"] for j in got["joints"]], [j["y"] for j in got["joints"]]]
        np.testing.assert_allclose(xy, np.round(_served(got)[:2], 2), atol=0.011)


def test_pose_serve_reports_errors_like_jax(servers):
    jest, test = _estimators()
    jh = servers(j_serve, j_serve.PoseApp(estimator=jest))
    th = servers(t_serve, t_serve.PoseApp(estimator=test))
    for httpd in (jh, th):
        body, headers = _multipart(b"not an image")
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/estimate",
                                     data=body, headers=headers)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400 and json.loads(err.value.read())["ok"] is False


def test_pose_serve_int8_calibrates_on_the_first_request():
    jest, test = _estimators()
    ref = te.PoseEstimator(params_from_numpy(_params()), TCFG, folded=False, bucket_step=64,
                           max_size=256, device="cpu")
    japp, tapp = (j_serve.PoseApp(estimator=jest, int8=True),
                  t_serve.PoseApp(estimator=test, int8=True))
    img, later = _frame(3, 48, 64), _frame(4, 60, 44)
    assert not test.is_int8 and not jest._int8
    got, want = tapp.estimate_bytes(_png(img)), japp.estimate_bytes(_png(img))
    assert test.is_int8 and jest._int8, "the first request must calibrate"
    ref.quantize_int8(img)
    np.testing.assert_array_equal(got["pose"], _rounded(ref.estimate_pose(img)))
    np.testing.assert_allclose(got["pose"], want["pose"], **POSE_TOL)
    # steady state: the calibrated int8 model serves every later request
    np.testing.assert_array_equal(tapp.estimate_bytes(_png(img))["pose"], got["pose"])
    np.testing.assert_array_equal(tapp.estimate_bytes(_png(later))["pose"],
                                  _rounded(ref.estimate_pose(later)))


def test_pose_serve_dynamic_batching_matches_jax(servers):
    jest, test = _estimators()
    app = t_serve.PoseApp(estimator=test, batch_window_ms=300.0, max_batch=8)
    httpd = servers(t_serve, app)
    rng = np.random.RandomState(3)
    frames = [rng.randint(0, 255, (h, w, 3), np.uint8)
              for h, w in [(48, 64), (40, 56), (48, 64), (100, 90), (44, 60)]]
    with ThreadPoolExecutor(len(frames)) as pool:
        resps = list(pool.map(lambda f: _post(httpd, "/estimate", _png(f)), frames))
    assert app.batcher.images_run == len(frames)
    assert app.batcher.batches_run < len(frames)   # batched
    for img, resp in zip(frames, resps):
        np.testing.assert_allclose(_served(resp), _rounded(jest.estimate_pose(img, [1.0])),
                                   **POSE_TOL)
        np.testing.assert_allclose(_served(resp), _rounded(test.estimate_pose(img, [1.0])),
                                   rtol=0, atol=ROUND_TOL)
    with pytest.raises(ValueError, match="single --scales"):
        t_serve.PoseApp(estimator=test, scales=(0.8, 1.0), batch_window_ms=4.0)


def _together(fn, items):
    """fn(item) for each item, each on a new thread, all released at once
    (a short switch interval); -> the results in order."""
    start = threading.Barrier(len(items))
    results = [None] * len(items)

    def call(i):
        start.wait(timeout=60)
        results[i] = fn(items[i])

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call, args=(i,), daemon=True)
                   for i in range(len(items))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None for r in results)
    return results


@pytest.mark.parametrize("int8", [False, True])
def test_pose_serve_threads_first_call_together(int8):
    """Four handler threads make their first request on one fresh service
    at once (no batch window); with int8 each may queue a calibration, and
    only the first calibrates. Each answer equals the serial one: the same
    estimator's poses one at a time, with int8 after calibrating on the
    frame whose calibration ran."""
    frames = [_frame(20 + i, 48 + 8 * i, 64) for i in range(4)]
    _, est = _estimators()
    calibrated = []
    if int8:
        inner = est.quantize_int8

        def spy(image, **kw):
            if not est.is_int8:
                calibrated.append(image.copy())
            return inner(image, **kw)
        est.quantize_int8 = spy
    app = t_serve.PoseApp(estimator=est, int8=int8)
    results = _together(lambda f: app.estimate_bytes(_png(f)), frames)
    assert est.is_int8 == int8 and len(calibrated) == int(int8)
    _, ref = _estimators()
    if int8:
        ref.quantize_int8(calibrated[0])
    for got, img in zip(results, frames):
        np.testing.assert_array_equal(got["pose"], _rounded(ref.estimate_pose(img)))


@pytest.mark.parametrize("int8", [False, True])
def test_estimator_threads_first_call_together(int8):
    """`PoseEstimator.estimate_pose` from four new threads at once, each a
    first call (the bilinear matrices of new frame sizes; int8's head
    packs): the poses equal the serial calls' on another estimator."""
    frames = [_frame(30 + i, 40 + 8 * i, 56) for i in range(4)]
    _, est = _estimators()
    _, ref = _estimators()
    if int8:
        est.quantize_int8(frames[0])
        ref.quantize_int8(frames[0])
    for got, img in zip(_together(est.estimate_pose, frames), frames):
        np.testing.assert_array_equal(got, ref.estimate_pose(img))


def test_pose_serve_default_path_uses_the_cached_estimator(monkeypatch):
    """PoseApp() with no estimator serves `get_estimator(model_def,
    model_bin, device)`'s; with int8 a private copy of it, so the cached
    one stays float."""
    _, est = _estimators()
    monkeypatch.setitem(te._MODEL_CACHE, ("", "", "cpu"), est)
    app = t_serve.PoseApp(device="cpu")
    assert app.est is est
    img = _frame(5, 48, 64)
    np.testing.assert_array_equal(app.estimate_bytes(_png(img))["pose"],
                                  _rounded(est.estimate_pose(img)))
    app8 = t_serve.PoseApp(device="cpu", int8=True)
    assert app8.est is not est and app8.est.model is est.model
    app8.estimate_bytes(_png(img))
    assert app8.est.is_int8 and not est.is_int8


# -- the web demo -------------------------------------------------------------------
@pytest.fixture(scope="module")
def classifier_model(tmp_path_factory):
    root = tmp_path_factory.mktemp("web_demo")
    proto = root / "deploy.prototxt"
    proto.write_text(CLASSIFIER)
    jnet = j_caffe.Net(str(proto), j_caffe.TEST)._net
    weights = root / "w.caffemodel"
    j_save_caffemodel(str(weights), graph_tame_params(jnet), deconv_names=jnet.deconv_names())
    return str(proto), str(weights)


def test_web_demo_matches_jax(classifier_model, servers):
    proto, weights = classifier_model
    labels = [f"thing_{i}" for i in range(5)]
    mean = np.array([104.0, 117.0, 123.0], np.float32)
    jh = servers(j_app, j_app.ClassifierApp(proto, weights, mean=mean, labels=labels))
    th = servers(t_app, t_app.ClassifierApp(proto, weights, mean=mean, labels=labels,
                                            device="cpu"))
    assert _get(th) == _get(jh).replace(b"deepcut_tpu ", b"deepcut_tpu_torch ")
    for seed, (h, w) in ((0, (20, 20)), (1, (40, 31))):
        png = _png(np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8))
        got, want = _post(th, "/classify_upload", png), _post(jh, "/classify_upload", png)
        assert got["ok"] and want["ok"] and len(got["top5"]) == 5
        assert [t["label"] for t in got["top5"]] == [t["label"] for t in want["top5"]]
        np.testing.assert_allclose([t["prob"] for t in got["top5"]],
                                   [t["prob"] for t in want["top5"]], rtol=0, atol=1e-5)


def test_web_demo_serves_concurrent_requests_like_serial(classifier_model):
    """The port's demo holds one Classifier, whose input blobs are host
    state: concurrent requests take turns and each gets its own answer."""
    proto, weights = classifier_model
    app = t_app.ClassifierApp(proto, weights, device="cpu")
    pngs = [_png(np.random.RandomState(10 + i).randint(0, 255, (24, 24, 3), np.uint8))
            for i in range(6)]
    want = [app.classify_bytes(p) for p in pngs]
    with ThreadPoolExecutor(len(pngs)) as pool:
        got = list(pool.map(app.classify_bytes, pngs))
    assert got == want


@pytest.mark.parametrize("payload", [b"\x89PNG plain", b"ends with a dash -", b"crlf\r\n",
                                     b"\r\n\r\nblank lines first"])
def test_multipart_parser_matches_jax(payload):
    body, headers = _multipart(payload)
    assert t_app._parse_multipart_image(headers, body) == \
        j_app._parse_multipart_image(headers, body) == payload
    for bad_headers, bad_body in (({"Content-Type": "text/plain"}, body),
                                  (headers, b"--portboundary\r\nno file\r\n\r\nx")):
        with pytest.raises(ValueError):
            t_app._parse_multipart_image(bad_headers, bad_body)
        with pytest.raises(ValueError):
            j_app._parse_multipart_image(bad_headers, bad_body)
