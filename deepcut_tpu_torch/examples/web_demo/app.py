"""Web classification demo on the PyTorch port: the counterpart of
`examples/web_demo/app.py` (the reference's flask app serving CaffeNet
classifications), standard library only (http.server). Upload an image,
get the top-5 classes back as JSON.

The model is loaded once, on the card unless ``--device cpu``; every
request runs the port's `Classifier` (center crop, f32) on it, on one
long-lived thread: the Classifier stages its input in host blobs, and
PyTorch caches cuDNN's execution plans per thread, while the server starts
a thread per request.

Usage (from the repository's root):
  python -m deepcut_tpu_torch.examples.web_demo.app deploy.prototxt \
      weights.caffemodel [--labels labels.txt] [--mean mean.binaryproto] \
      [--port 5000] [--device cuda]

Then POST an image:
  curl -s -F image=@cat.jpg http://localhost:5000/classify_upload
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from deepcut_tpu_torch.examples import read_labels, read_mean

INDEX_HTML = """<!doctype html>
<title>deepcut_tpu_torch web demo</title>
<h1>Classification demo</h1>
<form action="/classify_upload" method="post" enctype="multipart/form-data">
  <input type="file" name="image">
  <input type="submit" value="Classify">
</form>
"""


def _parse_multipart_image(headers, body: bytes) -> bytes:
    """Minimal multipart/form-data parser: returns the first file part."""
    ctype = headers.get("Content-Type", "")
    if "boundary=" not in ctype:
        raise ValueError("expected multipart/form-data")
    boundary = ctype.split("boundary=")[1].strip().encode()
    for part in body.split(b"--" + boundary):
        if b"\r\n\r\n" not in part:
            continue
        head, _, data = part.partition(b"\r\n\r\n")
        if b"filename=" in head:
            # exactly one CRLF precedes the next boundary marker; rstrip
            # would eat legitimate trailing '-'/CR/LF bytes of the payload
            if data.endswith(b"\r\n"):
                data = data[:-2]
            return data
    raise ValueError("no file part in form")


class ClassifierApp:
    def __init__(self, model_def, weights, mean=None, labels=None, device="cuda"):
        from deepcut_tpu_torch.classifier import Classifier

        self.clf = Classifier(model_def, weights, mean=mean, raw_scale=255.0,
                              channel_swap=(2, 1, 0), device=device)
        self.labels = labels
        self._runner = ThreadPoolExecutor(max_workers=1, thread_name_prefix="classifier")

    def classify_bytes(self, raw: bytes):
        from PIL import Image

        img = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"), np.float32) / 255.0
        probs = self._runner.submit(self.clf.predict, [img], oversample=False).result()[0]
        top5 = np.argsort(probs)[::-1][:5]
        return [{"label": (self.labels[i] if self.labels and i < len(self.labels)
                           else f"class {i}"),
                 "prob": round(float(probs[i]), 5)} for i in top5]


def make_handler(app: ClassifierApp):
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
            if self.path != "/classify_upload":
                self._send(404, b"not found")
                return
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                raw = _parse_multipart_image(self.headers, body)
                result = app.classify_bytes(raw)
                self._send(200, json.dumps({"ok": True, "top5": result}).encode(),
                           "application/json")
            except Exception as e:  # report, don't crash the server
                self._send(400, json.dumps({"ok": False, "error": str(e)}).encode(),
                           "application/json")
    return Handler


def serve(app: ClassifierApp, port: int = 5000, background: bool = False):
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(app))
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd
    print(f"serving on http://127.0.0.1:{httpd.server_address[1]}/")
    httpd.serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="deepcut_tpu_torch.examples.web_demo.app")
    ap.add_argument("model_def")
    ap.add_argument("weights")
    ap.add_argument("--labels", default=None)
    ap.add_argument("--mean", default=None)
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    mean = read_mean(args.mean) if args.mean else None
    labels = read_labels(args.labels) if args.labels else None
    serve(ClassifierApp(args.model_def, args.weights, mean, labels, args.device), args.port)


if __name__ == "__main__":
    main()
