"""Pose-estimation HTTP service on the PyTorch port: the counterpart of
`examples/pose/serve.py`, DeeperCut's serving deployment.

Standard library only (http.server). The PoseEstimator is created once,
on the card unless ``--device cpu``, and every request reuses it: the
bilinear matrices it caches per frame size and the CUDA kernels it built
at its first call. The server's handler threads (one per request) decode
the uploads; the estimator runs on one long-lived thread of the app's,
or, with ``--batch-window``, on the batcher's, which collects concurrent
requests into one batch. PyTorch caches cuDNN's execution plans per
thread, so a thread per request would plan every convolution anew.

Usage (from the repository's root):
  python -m deepcut_tpu_torch.examples.pose.serve --model-bin ResNet-152.caffemodel \
      [--scales 0.8,1.0,1.2] [--port 5001] [--int8] [--batch-window 4] [--device cuda]
  curl -s -F image=@person.jpg http://localhost:5001/estimate

Response: {"ok": true, "pose": [[x..],[y..],[conf..],[off_y..],[off_x..]],
           "joints": [{"name": ..., "x": ..., "y": ..., "confidence": ...}]}
(the 5x14 layout is the reference's, estimate_pose.py:60-67).
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from deepcut_tpu_torch.examples.web_demo.app import _parse_multipart_image

JOINT_NAMES = [
    "r_ankle", "r_knee", "r_hip", "l_hip", "l_knee", "l_ankle",
    "r_wrist", "r_elbow", "r_shoulder", "l_shoulder", "l_elbow", "l_wrist",
    "chin", "top_head",
]

INDEX_HTML = """<!doctype html>
<title>deepcut_tpu_torch pose service</title>
<h1>Pose estimation</h1>
<form action="/estimate" method="post" enctype="multipart/form-data">
  <input type="file" name="image">
  <input type="submit" value="Estimate">
</form>
"""


class _Batcher:
    """Dynamic micro-batching: concurrent /estimate requests are collected
    within a latency window (the first request opens it) and run as one
    `PoseEstimator.estimate_pose_many` call, which groups mixed sizes by
    canvas bucket. Per-image results equal the unbatched path's up to the
    batch's rounding."""

    def __init__(self, est, scale: float, window_ms: float = 4.0, max_batch: int = 8):
        self.est = est
        self.scale = float(scale)
        self.window_s = window_ms / 1e3
        self.max_batch = int(max_batch)
        self.q: "queue.Queue" = queue.Queue()
        self.batches_run = 0
        self.images_run = 0
        threading.Thread(target=self._run, daemon=True).start()

    def submit(self, img: np.ndarray) -> np.ndarray:
        done = threading.Event()
        slot: dict = {}
        self.q.put((img, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["pose"]

    def _run(self):
        while True:
            batch = [self.q.get()]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=left))
                except queue.Empty:
                    break
            try:
                poses = self.est.estimate_pose_many([b[0] for b in batch], self.scale)
                self.batches_run += 1
                self.images_run += len(batch)
                for (_, done, slot), pose in zip(batch, poses):
                    slot["pose"] = pose
                    done.set()
            except Exception as e:  # surfaced per request
                for _, done, slot in batch:
                    slot["error"] = e
                    done.set()


class PoseApp:
    """estimator: a `PoseEstimator` to serve; by default the cached one of
    `get_estimator(model_def, model_bin, device)`, and with int8 a private
    copy of it (quantizing the cached one would switch every later
    `get_estimator` caller in the process to int8)."""

    def __init__(self, model_def: str = "", model_bin: str = "", scales=(1.0,),
                 estimator=None, int8: bool = False, batch_window_ms: float = 0.0,
                 max_batch: int = 8, device: str = "cuda"):
        if estimator is None:
            from deepcut_tpu_torch.pose.estimate import get_estimator

            estimator = get_estimator(model_def, model_bin, device)
            if int8:
                estimator = copy.copy(estimator)
        self.est = estimator
        self.scales = tuple(scales)
        self.int8 = int8  # calibrated lazily on the first request's image
        self._runner = ThreadPoolExecutor(max_workers=1, thread_name_prefix="pose-estimator")
        self.batcher = None
        if batch_window_ms > 0:
            if len(self.scales) != 1:
                raise ValueError("--batch-window needs a single --scales value (requests "
                                 "in one batch share the scale)")
            self.batcher = _Batcher(estimator, self.scales[0], window_ms=batch_window_ms,
                                    max_batch=max_batch)

    def estimate_bytes(self, raw: bytes):
        from PIL import Image

        img = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"),
                         np.uint8)[:, :, ::-1]  # BGR like the reference CLI
        if self.int8 and not self.est.is_int8:
            # on the runner, before any request is served: a request that
            # queues a second calibration finds it done (quantize_int8 is
            # idempotent)
            self._runner.submit(self.est.quantize_int8, img, scale=self.scales[0]).result()
        if self.batcher is not None:
            pose = self.batcher.submit(img)
            raw_pose = None if float(np.min(pose[2])) == 0.0 else pose
        else:
            raw_pose = self._runner.submit(self.est.estimate_pose, img,
                                           scales=self.scales).result()
        if raw_pose is None:  # no scale cleared the min-confidence bar
            raise ValueError("no pose found at the requested scales")
        pose = np.asarray(raw_pose, np.float64)
        joints = [{"name": JOINT_NAMES[j] if j < len(JOINT_NAMES) else str(j),
                   "x": round(float(pose[0, j]), 2),
                   "y": round(float(pose[1, j]), 2),
                   "confidence": round(float(pose[2, j]), 4)}
                  for j in range(pose.shape[1])]
        return {"pose": [[round(float(v), 4) for v in row] for row in pose],
                "joints": joints}


def make_handler(app: PoseApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, body: bytes, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._send(200, INDEX_HTML.encode())

        def do_POST(self):
            if self.path != "/estimate":
                self._send(404, b"not found")
                return
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                raw = _parse_multipart_image(self.headers, body)
                result = app.estimate_bytes(raw)
                result["ok"] = True
                self._send(200, json.dumps(result).encode(), "application/json")
            except Exception as e:  # report, don't crash the server
                self._send(400, json.dumps({"ok": False, "error": str(e)}).encode(),
                           "application/json")
    return Handler


def serve(app: PoseApp, port: int = 5001, background: bool = False):
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(app))
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd
    print(f"pose service on http://127.0.0.1:{httpd.server_address[1]}/")
    httpd.serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="deepcut_tpu_torch.examples.pose.serve")
    ap.add_argument("--model-def", default="")
    ap.add_argument("--model-bin", default="",
                    help=".caffemodel weights (a seeded random init if omitted)")
    ap.add_argument("--scales", default="1.0")
    ap.add_argument("--port", type=int, default=5001)
    ap.add_argument("--int8", action="store_true",
                    help="int8 serving (calibrates on the first request)")
    ap.add_argument("--batch-window", type=float, default=0.0,
                    help="dynamic batching: collect concurrent requests for this many ms "
                         "and run them as one batch (single --scales value only; 0 = off)")
    ap.add_argument("--max-batch", type=int, default=8, help="max requests per dynamic batch")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    scales = tuple(float(s) for s in args.scales.split(","))
    serve(PoseApp(args.model_def, args.model_bin, scales, int8=args.int8,
                  batch_window_ms=args.batch_window, max_batch=args.max_batch,
                  device=args.device),
          args.port)


if __name__ == "__main__":
    main()
