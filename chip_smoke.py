#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`deepcut_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's single-image pose-serving path at the full ResNet-152
width through its entry points, in phases; any failure raises and the exit
code is non-zero:

1. the card: nvidia-smi's name and power limit, torch / CUDA versions;
2. build the CUDA decode kernel from csrc/ with nvcc;
3. the kernel against its plain PyTorch version on the card, bit for bit;
4. the full-width slice (random weights from a seeded generator, tamed):
   estimate_pose, estimate_pose_batch, bf16 against f32 scoremaps, an HD
   frame on the tiled path;
5. examples/pose/serve.py, unchanged, serving the port's estimator: three
   concurrent HTTP requests of mixed sizes, one of them HD;
6. times on the card (CUDA events), each beside the card's name and limit.

The kernel's launch counter is zeroed before phase 4 and read after phase 5.
It never imports jax (the card's machine has none). The line before the last
is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import http.client
import importlib.util
import io
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from deepcut_tpu_torch.models.resnet import deepercut_config, init_params
from deepcut_tpu_torch.ops import cuda_decode
from deepcut_tpu_torch.pose.decode import decode_pose_batch
from deepcut_tpu_torch.pose.estimate import PoseEstimator, canvas_size

ROOT = Path(__file__).resolve().parent
SEED = 0
J = 14
KERNEL_SHAPES = [(1, J, 87, 87), (4, J, 86, 86), (3, J, 250, 188)]
# Pose agreement between two bf16 runs of the same frame that differ only in
# batch composition or path (batch of 4 against one, HTTP against direct).
# cuDNN may pick other algorithms per batch size, so the bf16 maps can differ
# by a rounding step, and on the flat maps of random weights that can move
# the argmax to another cell of nearly the same score. Held: the confidence
# of every joint within 2**-8 (one bf16 step at 1.0), so a moved argmax lands
# on a near-tie; x / y within 2 px where the cell agrees (the offsets leave
# the bf16 head: one bf16 step at |offset| in [16, 32) is 0.125, times
# sqrt(53) = 0.91 px); and the cell agreeing on at least half the joints.
BATCH_CONF_TOL = 2.0 ** -8
BATCH_PX_TOL = 2.0
BATCH_MIN_AGREE = 0.5
# bf16 forward against the f32 forward of the same weights (TF32 off): each
# bf16 rounding keeps 8 bits, over 155 layers; held: prob within 0.1.
BF16_PROB_TOL = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


# -- 1. the card -------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device_count {torch.cuda.device_count()} device {torch.cuda.get_device_name(0)}")
    # every f32 comparison below runs in full f32: cuDNN defaults to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return smi


# -- 2. build ----------------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    lib = cuda_decode.build()
    log(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    log(lib.with_suffix(".log").read_text().strip())


# -- 3. kernel against plain -------------------------------------------------
def _kernel_cases(rng):
    for shape in KERNEL_SHAPES:
        n, _, h, w = shape
        rand = rng.rand(*shape).astype(np.float32)
        ties = np.round(rand * 8) / 8                               # many equal maxima
        bf16 = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3).to(torch.bfloat16).float()
        loc = torch.from_numpy(rng.randn(n, 2 * J, h, w).astype(np.float32))
        full = (torch.full((n,), h, dtype=torch.int32), torch.full((n,), w, dtype=torch.int32))
        masked = (torch.from_numpy(rng.randint(1, h + 1, n).astype(np.int32)),
                  torch.from_numpy(rng.randint(1, w + 1, n).astype(np.int32)))
        yield f"{shape} random", torch.from_numpy(rand), loc, full
        yield f"{shape} ties masked", torch.from_numpy(ties.astype(np.float32)), loc, masked
        yield f"{shape} all-equal", torch.full(shape, 0.5), loc, masked
        yield f"{shape} bf16-upcast masked", bf16, loc, masked


def phase_kernel_vs_plain() -> float:
    rng = np.random.RandomState(SEED)
    max_err = 0.0
    for name, prob, loc, (vh, vw) in _kernel_cases(rng):
        prob, loc, vh, vw = (t.cuda().contiguous() for t in (prob, loc, vh, vw))
        for scale in (1.0, 0.75):
            got = cuda_decode.decode_pose(prob, loc, vh, vw, scale)
            ref = decode_pose_batch(prob, loc, scale=scale, valid_hw=(vh, vw))
            torch.cuda.synchronize()
            if not torch.equal(got[:, 2], ref[:, 2]):
                raise AssertionError(f"kernel conf differs from plain on {name}")
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
            max_err = max(max_err, float((got - ref).abs().max()))
        # argmax indices: with zero offsets at scale 1, x and y are cell*8+4
        zero = torch.zeros_like(loc)
        cells = cuda_decode.decode_pose(prob, zero, vh, vw, 1.0)
        idx = ((cells[:, 1] - 4) / 8).long() * prob.shape[3] + ((cells[:, 0] - 4) / 8).long()
        rows = torch.arange(prob.shape[2], device="cuda").reshape(1, 1, -1, 1)
        cols = torch.arange(prob.shape[3], device="cuda").reshape(1, 1, 1, -1)
        keep = (rows < vh.reshape(-1, 1, 1, 1)) & (cols < vw.reshape(-1, 1, 1, 1))
        masked = torch.where(keep, prob, torch.tensor(float("-inf"), device="cuda"))
        want = torch.argmax(masked.flatten(2), dim=2)
        if not torch.equal(idx, want):
            raise AssertionError(f"kernel argmax differs from plain on {name}")
        log(f"kernel == plain: {name}")
    log(f"kernel vs plain: argmax and conf bit-equal on all cases, "
        f"pose max |err| {max_err:.3g} (held to 1e-6 relative)")
    return max_err


# -- 4. the full-width slice -------------------------------------------------
def tame_params(cfg):
    """ResNet-152 at random init, tamed in this script only: the residual
    branches' last BN scale at 0.1 keeps 50 blocks from growing the trunk's
    activations without bound, and the heads x30 give the maps structure
    (as tests/test_estimate.py does). With every bias 0 the network is
    linear in conv1's scale, and conv1 x3e-4 brings the logits from
    thousands down to a few units, so the sigmoid does not saturate."""
    params = init_params(torch.Generator().manual_seed(SEED), cfg)
    for name, p in params.items():
        if name.startswith("scale") and name.endswith("_branch2c"):
            p["gamma"] = torch.full_like(p["gamma"], 0.1)
    for name in ("res5c_up_pose", "res3d_pose", "res5c_up_locref", "res3d_locref"):
        params[name]["w"] = params[name]["w"] * 30.0
    params["conv1"]["w"] = params["conv1"]["w"] * 3e-4
    return params


def frame(rng, h, w):
    return rng.randint(0, 256, (h, w, 3), np.uint8)


def cell_of(pose):
    """(row, col) argmax cell of each joint of a scale-1 pose."""
    col = np.rint((pose[0] - pose[4] - 4) / 8)
    row = np.rint((pose[1] - pose[3] - 4) / 8)
    return np.stack([row, col])


def agreement(a, b, what):
    same = np.all(cell_of(a) == cell_of(b), axis=0)
    dconf = float(np.abs(a[2] - b[2]).max())
    dpx = float(np.abs(a[:2, same] - b[:2, same]).max()) if same.any() else 0.0
    log(f"{what}: argmax cell agrees on {int(same.sum())}/{same.size} joints, "
        f"max |dconf| {dconf:.3g}, max |dxy| on agreeing joints {dpx:.3g} px")
    if same.mean() < BATCH_MIN_AGREE or dconf > BATCH_CONF_TOL or dpx > BATCH_PX_TOL:
        raise AssertionError(f"{what}: outside the batch tolerance")


def phase_slice(rng):
    cfg = deepercut_config(152)
    params = tame_params(cfg)
    est = PoseEstimator(params, cfg, device="cuda")          # BN-folded, bf16, channels_last
    est32 = PoseEstimator(params, dataclasses.replace(cfg, compute_dtype=torch.float32),
                          device="cuda")
    f480 = frame(rng, 480, 640)
    canvas = est._canvas(f480, 1.0, 480, 640)
    with torch.inference_mode():
        res5c, _ = est.model.run_trunk(canvas.permute(0, 3, 1, 2))
    log(f"max |res5c| (bf16, 480x640 frame): {float(res5c.abs().max()):.4g}")

    pose = est.estimate_pose(f480)
    if pose is None or pose.shape != (5, J) or not np.isfinite(pose).all():
        raise AssertionError(f"estimate_pose: bad pose {pose}")
    if cuda_decode.launches == 0:
        raise AssertionError("estimate_pose did not launch the decode kernel")
    log(f"estimate_pose 480x640: finite (5, 14), conf min {pose[2].min():.4f} "
        f"max {pose[2].max():.4f}, kernel launches so far {cuda_decode.launches}")

    batch = est.estimate_pose_batch([f480] * 4)
    for i in range(4):
        agreement(batch[i], pose, f"estimate_pose_batch[{i}] vs estimate_pose")

    sm16, _ = est.scoremaps(f480)
    sm32, _ = est32.scoremaps(f480)
    d = float(np.abs(sm16 - sm32).max())
    same = (sm16.reshape(-1, J).argmax(0) == sm32.reshape(-1, J).argmax(0)).mean()
    log(f"bf16 vs f32 scoremaps (TF32 off): max |dprob| {d:.4g}, "
        f"argmax agrees on {same:.3f} of joints")
    if not np.isfinite(sm16).all() or d > BF16_PROB_TOL:
        raise AssertionError(f"bf16 scoremaps off the f32 ones by {d}")
    del est32

    tiled = []
    inner = est._scoremaps_tiled
    est._scoremaps_tiled = lambda *a: tiled.append(a) or inner(*a)
    hd = frame(rng, 720, 1280)
    pose_hd = est.estimate_pose(hd)
    del est._scoremaps_tiled
    if not tiled or pose_hd is None or not np.isfinite(pose_hd).all():
        raise AssertionError("HD frame did not take the tiled path or gave no pose")
    log(f"HD 720x1280: tiled path ({canvas_size(720, 1)}x{canvas_size(1280, 1)} canvas), "
        f"finite (5, 14)")
    return est


# -- 5. the server -----------------------------------------------------------
def _post_png(port: int, img_bgr: np.ndarray) -> dict:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img_bgr[:, :, ::-1]).save(buf, format="PNG")
    boundary = "chipsmokeboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
            f"filename=\"f.png\"\r\nContent-Type: image/png\r\n\r\n").encode() \
        + buf.getvalue() + f"\r\n--{boundary}--\r\n".encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/estimate", body,
                     {"Content-Type": f"multipart/form-data; boundary={boundary}"})
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def phase_server(est, rng):
    spec = importlib.util.spec_from_file_location("pose_serve", ROOT / "examples/pose/serve.py")
    serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve)
    app = serve.PoseApp(estimator=est, batch_window_ms=4)
    httpd = serve.serve(app, port=0, background=True)
    try:
        frames = [frame(rng, 480, 640), frame(rng, 300, 400), frame(rng, 720, 1280)]
        with ThreadPoolExecutor(len(frames)) as pool:
            answers = list(pool.map(lambda f: _post_png(httpd.server_address[1], f), frames))
    finally:
        httpd.shutdown()
        httpd.server_close()
    for f, ans in zip(frames, answers):
        if not ans.get("ok") or len(ans["joints"]) != J:
            raise AssertionError(f"server answer for {f.shape}: {ans}")
        direct = est.estimate_pose(f)
        served = np.asarray(ans["pose"], np.float32)
        served[:2] = [[j["x"] for j in ans["joints"]], [j["y"] for j in ans["joints"]]]
        want = direct.copy()
        want[:2] = np.round(direct[:2].astype(np.float64), 2)
        agreement(served, want, f"HTTP {f.shape[0]}x{f.shape[1]} vs estimate_pose")
    log(f"server: {len(frames)} concurrent requests answered ok, "
        f"{app.batcher.batches_run} batches for {app.batcher.images_run} images")


# -- 6. times ----------------------------------------------------------------
def _events_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_times(est, rng, card: str):
    for bs in (1, 4):
        frames = [frame(rng, 688, 688) for _ in range(bs)]
        ms = _events_ms(lambda: est.estimate_pose_batch(frames), iters=20)
        log(f"time [{card}]: estimate_pose_batch 688x688 frames (canvas bucket 704), "
            f"bf16, pose+locref, batch {bs}: {ms:.3f} ms/call, {bs * 1000 / ms:.2f} img/s")
        x = torch.zeros((bs, 3, 688, 688), device="cuda", dtype=torch.bfloat16).to(
            memory_format=torch.channels_last)
        with torch.inference_mode():
            ms = _events_ms(lambda: est.model(x, heads=("pose", "locref")), iters=20)
        log(f"time [{card}]: forward only, 688x688 canvas, bf16, pose+locref, "
            f"batch {bs}: {ms:.3f} ms, {bs * 1000 / ms:.2f} img/s")
    n, _, h, w = KERNEL_SHAPES[1]
    prob = torch.rand((n, J, h, w), device="cuda")
    loc = torch.randn((n, 2 * J, h, w), device="cuda")
    vh = torch.full((n,), h, dtype=torch.int32, device="cuda")
    vw = torch.full((n,), w, dtype=torch.int32, device="cuda")
    ms = _events_ms(lambda: cuda_decode.decode_pose(prob, loc, vh, vw, 1.0), iters=200)
    plain_ms = _events_ms(lambda: decode_pose_batch(prob, loc, valid_hw=(vh, vw)), iters=200)
    log(f"time [{card}]: decode {(n, J, h, w)}: kernel {ms * 1000:.2f} us, "
        f"plain PyTorch {plain_ms * 1000:.2f} us")
    return ms, plain_ms


def main() -> int:
    card = phase_device()
    phase_build()
    max_err = phase_kernel_vs_plain()
    rng = np.random.RandomState(SEED)
    cuda_decode.launches = 0                     # the main path's run starts here
    est = phase_slice(rng)
    phase_server(est, rng)
    launches = cuda_decode.launches              # and ends here
    if launches == 0:
        raise AssertionError("the main path never launched the decode kernel")
    ms, plain_ms = phase_times(est, rng, card)
    log(json.dumps({"kernels": [{
        "name": "decode_pose", "route": "cuda",
        "source": "deepcut_tpu_torch/csrc/decode_pose.cu",
        "replaces": "deepcut_tpu/ops/pallas_decode.py:63",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
