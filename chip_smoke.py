#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`deepcut_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --serving-times  # phase 1 and the serving times only

Drives the port's four paths (bf16 serving, int8 serving, training, and the
Caffe graph engine's serving) at full width through their entry points, in
phases; any failure raises and the exit code is non-zero:

1. the card: nvidia-smi's name and power limit, torch / CUDA versions;
2. build the CUDA kernels from csrc/ with nvcc, one process per source, all
   started together: the decode (csrc/decode_pose.cu), the serving conv's
   epilogue (csrc/conv_epilogue.cu) and the int8 conv's pieces
   (csrc/int8_conv.cu: im2col, epilogue, quantize);
3. each kernel against its plain PyTorch version on the card: the decode's
   fused entry and its probability-map entry (argmax and pose bit for bit,
   on ties, all-equal, bf16-valued and NaN maps), the epilogue bit for bit
   (random, residual, strided residual), the int8 im2col, epilogue (each
   mode of the int8 forward) and quantization (+-127, .5 ties) bit for bit,
   and the route im2col + torch._int_mm equal to an exact f64 convolution's
   int32 accumulator; and cuDNN's TF32 convolution exact on bf16-valued
   operands (allowed against not allowed, 1e-5 relative);
4. the serving slice (random weights from a seeded generator, tamed):
   estimate_pose, estimate_pose_batch, bf16 against f32 scoremaps, an HD
   frame on the tiled path;
5. examples/pose/serve.py, unchanged, serving the port's estimator: three
   concurrent HTTP requests of mixed sizes, one of them HD;
Q. int8 serving: quantize_int8 on a 480x640 frame, estimate_pose and
   estimate_pose_batch, int8 against bf16 scoremaps, an HD frame on the
   tiled path, an int8_deconv=True estimator, forward_int8's int8_residual
   within the int8 envelope; then serve.py's --int8 on a fresh estimator
   (it calibrates on the first request) with the requests of phase 5;
T1. training through `python -m deepcut_tpu_torch.tools.cli train`'s entry
   point: copies of examples/pose/pose_{train,solver}.prototxt over a
   synthetic window file of 480x640 frames, finetuning ResNet-152 from the
   tamed weights written as a .caffemodel: f32 with snapshots, a restore
   that trains on, -mixed_precision -remat, -augment_device;
T2. gradients at full width on one batch from the CLI's data source: remat
   against no remat (deterministic cuDNN, bit-equal), the mixed loss against
   the f32 loss (and a planted dropped bias outside that tolerance), the
   stem pool's first-max backward against a plain scatter;
T3. the tiny model learns the coloured-disc task of
   tests/test_pose_training_e2e.py on the card (1800 steps, data through
   the CLI's source), scored through the port's PoseEstimator (the decode
   kernel) by the eval hook; an estimator built from T1's .caffemodel
   snapshot gives a finite pose;
G. the graph engine (`deepcut_tpu_torch.core.graph.Net` and its front ends):
   G1 CaffeNet (examples/imagenet/caffenet_deploy.prototxt, unchanged: batch
   10 of 227x227, 96/256/384/384/256 channels, two grouped convs, two LRNs,
   fc6/fc7 of 4096, 8 classes) from a seeded .caffemodel written by
   `compat.Net.save`: `Classifier.predict` over two frames with 10-crop
   oversampling (f32, TF32 off), the same crops through the bf16
   `make_forward` and through `compat.Net.forward_all`, then the CLI's `time`
   and `test`; G2 the DeeperCut ResNet-152 written as a deploy prototxt with
   the port's `net_spec` (1x3x688x688), phase 4's tamed weights from a
   .caffemodel, the serving chain (fold_bn, prune, [fuse_siblings],
   cast_weights, make_forward) against the native `DeeperCut` bf16 forward
   and `forward()` in f32 against the native f32 forward; G3
   `Net.quantize_int8` on G2's graph in the int8 envelope;
6. times on the card, each beside the card's name and limit: the bf16 and
   int8 serving forwards and estimate_pose_batch at batch 1 and 4
   (CUDA-event wall time, torch.profiler device busy time, idle share,
   kernels per call), each kernel at the main path's shapes beside its
   plain version, its bound and a library call where one computes the
   same function (quantize_i8 with the L2 flushed before each call),
   torch._int_mm per GEMM shape of the int8 forward against its int8 bound,
   the graph engine's CaffeNet `Classifier.predict` (20 crops) and
   `make_forward` at batch 10, the ResNet-152 graph's `make_forward` at
   batch 1 and 4 beside the native bf16 forward, and the full-width
   PoseSolver.step.

The kernels' launch counters are zeroed before phase 4 and read after
phase 5 (the serving path), zeroed again before Q and read after its
server (the int8 serving path), again before T1 and after T3 (the
training path), and again before G and after it (the graph engine's path). --serving-times imports only what the package had before the conv
epilogue kernel, so the same timing runs over an older checkout of the
package (run from that checkout) for a comparison inside one call.
It never imports jax (the card's machine has none). The line before the last
is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import importlib.util
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from deepcut_tpu_torch.constants import MEAN_BGR as MEAN_BGR_T
from deepcut_tpu_torch.models.resnet import DeeperCut, deepercut_config, init_params
from deepcut_tpu_torch.ops import cuda_decode
from deepcut_tpu_torch.pose.decode import decode_pose_batch
from deepcut_tpu_torch.pose.estimate import HEADS, PoseEstimator, canvas_size

ROOT = Path(__file__).resolve().parent
SEED = 0
J = 14
KERNEL_SHAPES = [(1, J, 87, 87), (4, J, 86, 86), (3, J, 250, 188)]
# The fused decode's (n, h, w, channels beyond 3J): the serving path's 88 x 88
# grid (704 canvas) at batch 1 and 4 (8-byte copies), a large grid with an
# odd channel count (4-byte copies), and rows so wide that its shared memory
# holds one at a time (3600 * 14 logits; a band then takes several stages).
FUSED_SHAPES = [(1, 88, 88, 0), (4, 88, 88, 0), (3, 125, 94, 7), (1, 40, 3600, 0)]
# The epilogue at the serving forward's shapes (704 canvas): (shape,
# residual, relu, residual crop). C = 64 and 256 at res2, 512 at res3, 2048
# at res5, and the heads' 42 channels (deconv out; skip conv + cropped deconv).
EPILOGUE_CASES = [((1, 64, 176, 176), False, True, (0, 0)),
                  ((1, 256, 176, 176), True, True, (0, 0)),
                  ((4, 512, 88, 88), True, True, (0, 0)),
                  ((4, 2048, 44, 44), True, True, (0, 0)),
                  ((1, 2048, 44, 44), False, False, (0, 0)),
                  ((4, 42, 89, 89), False, False, (0, 0)),
                  ((4, 42, 88, 88), True, False, (1, 1)),
                  ((3, 64, 17, 23), True, True, (3, 2))]
# int8_im2col and the int8 conv route at the int8 forward's shapes (704
# canvas) and at rectangular kernels (the graph engine's int8 convs):
# (name, x, k or (kh, kw), stride, pad, dilation, input dilation, Cout).
IM2COL_CASES = [("res2 3x3", (4, 64, 176, 176), 3, 1, 1, 1, 1, 64),
                ("res2 3x3 batch 1", (1, 64, 176, 176), 3, 1, 1, 1, 1, 64),
                ("res3a 1x1 stride 2", (4, 256, 176, 176), 1, 2, 0, 1, 1, 128),
                ("res5 3x3 dilated", (4, 512, 44, 44), 3, 1, 2, 2, 1, 512),
                ("heads int8 deconv", (4, 2048, 44, 44), 3, 1, 2, 1, 2, 42),
                ("res4 1x1 (the input as A)", (4, 1024, 44, 44), 1, 1, 0, 1, 1, 256),
                ("9 rows, padded to 17", (1, 64, 3, 3), 1, 1, 0, 1, 1, 64),
                ("4-byte path", (2, 12, 13, 11), 3, 2, 1, 1, 1, 8),
                ("byte path", (2, 42, 13, 11), 3, 1, 1, 1, 1, 8),
                ("1x3", (2, 64, 43, 43), (1, 3), 1, 1, 1, 1, 64),
                ("3x1 strided and dilated", (2, 16, 30, 22), (3, 1), 2, 2, 2, 1, 24)]
# int8_epilogue in each mode of the int8 forward: (name, acc shape, acc row
# stride, residual (None, "f32" holding bf16 values, "i8"), its crop,
# keyword arguments).
I8_EPILOGUE_CASES = [
    ("branch2a: ReLU, requantized", (4, 64, 176, 176), 64, None, (0, 0),
     dict(relu=True, f32_out=False, requant_s=0.0517)),
    ("block end: bf16 residual, ReLU, f32 + requantized", (4, 256, 176, 176), 256, "f32", (0, 0),
     dict(relu=True, requant_s=0.0517)),
    ("int8 stream: int8 residual", (4, 512, 88, 88), 512, "i8", (0, 0),
     dict(residual_scale=0.0371, relu=True, f32_out=False, requant_s=0.0517)),
    ("branch1 at res5, batch 1", (1, 2048, 44, 44), 2048, None, (0, 0), dict()),
    ("heads: skip conv + cropped deconv, f32", (4, 42, 88, 88), 48, "f32", (1, 1),
     dict(bf16=False)),
    ("int8 deconv out", (4, 42, 89, 89), 48, None, (0, 0), dict()),
    ("f32 config block end", (2, 64, 17, 23), 64, "f32", (3, 2), dict(bf16=False, relu=True)),
    ("int8 residual, scalar path", (3, 42, 5, 7), 48, "i8", (0, 0),
     dict(residual_scale=0.0371, relu=True, requant_s=0.0517)),
]
# quantize_i8: (shape, scale) at the stem's output (batch 4 and 1), the skip
# tap, and an odd element count (the scalar path).
QUANTIZE_CASES = [((4, 64, 176, 176), 0.25), ((1, 64, 176, 176), 0.0371),
                  ((4, 512, 88, 88), 0.125), ((3, 5, 7, 11), 0.25)]
# TF32 allowed against not allowed on bf16-valued operands: (name, x, w,
# pad, dilation, transposed) at res4, res5 (dilated) and the heads' deconv.
TF32_CASES = [("res4 1x1", (1, 1024, 44, 44), (256, 1024, 1, 1), 0, 1, False),
              ("res4 3x3", (1, 256, 44, 44), (256, 256, 3, 3), 1, 1, False),
              ("res5 3x3 dilated", (1, 512, 44, 44), (512, 512, 3, 3), 2, 2, False),
              ("heads deconv", (1, 2048, 44, 44), (2048, 42, 3, 3), 0, 1, True)]
# Exact products, f32 sums in another order. Read on the card (NVIDIA H100
# 80GB HBM3, 700 W): 2.6e-6 to 1.1e-5 of max |ref|, the most at res5's
# 4608-term sums. A TF32 rounding of any value that is not bf16 (a Winograd
# or FFT transform) errs by ~2**-11 = 4.9e-4 of that value, 10x above this.
TF32_RTOL = 5e-5
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
# The same gap, and the serving forward's device kernels per call at batch 1
# and 4, as the card read them while cuDNN added a bf16 bias after rounding
# each conv (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
BIAS_TWICE_BF16_GAP = 0.02369
BIAS_TWICE_KERNELS_PER_CALL = {1: 688, 4: 734}
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's device memory rate (NVIDIA's data sheet)
INT8_OPS_PER_S = 1979e12   # its dense int8 tensor-core rate (the same sheet)
# int8 against bf16 scoremaps of the same tamed weights: the heads x30 put
# many cells near the sigmoid's steep middle or in saturation, where int8
# noise can move a probability far; held as tests/test_estimate.py:228-230
# holds the JAX package's: under 5% of cells moved by more than 0.25.
INT8_FLIP, INT8_MAX_FLIPS = 0.25, 0.05
# torch._int_mm at the int8 forward's GEMM shapes (704 canvas, batch 4):
# (name, M = N*oh*ow, K = kh*kw*Cin, N = Cout rounded up to 8).
INT_MM_SHAPES = [("res2 branch2b 3x3", 123904, 576, 64), ("res2 branch2c 1x1", 123904, 64, 256),
                 ("res3 branch2b 3x3", 30976, 1152, 128), ("res4 branch2b 3x3", 7744, 2304, 256),
                 ("res4 branch2c 1x1", 7744, 256, 1024),
                 ("res5 branch2b 3x3 dilated", 7744, 4608, 512),
                 ("res5 branch2c 1x1", 7744, 512, 2048), ("heads skip 1x1", 30976, 512, 48),
                 ("heads int8 deconv", 31684, 18432, 48)]
# The full-width training loss with bf16 convolutions against f32 (TF32
# off), same params and batch: the loss averages ~10^4 cross-entropy terms
# over the bf16 logits, whose errors largely cancel in the mean. Read on the
# card: 1.24e-4 relative with zero head biases. Held: within 2e-3, which the
# same mixed forward with one head's bias dropped must exceed (T2 checks it).
MIXED_LOSS_RTOL = 2e-3
HEAD_BIAS_STD = 0.5
# The learning proof (tests/test_pose_training_e2e.py's bounds, reached there
# after 450 steps from the JAX package's init). From the port's seeded init
# the JAX package on the CPU reads PCKh 0.848 after 450 steps of that recipe
# (rate drop at 600), below the bound: the init sets the pace. So the run
# trains 1800 steps and drops the rate at 1200.
PCKH_MIN, PCKH_GAIN = 0.9, 0.5


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
    from deepcut_tpu_torch import native
    from deepcut_tpu_torch.ops import conv_epilogue, int8_conv

    t0 = time.perf_counter()
    libs = native.build(cuda_decode.LIB, conv_epilogue.LIB, int8_conv.LIB)
    log(f"build: {', '.join(str(lib.relative_to(ROOT)) for lib in libs)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, one process per source, in parallel)")
    for lib in libs:
        log(lib.with_suffix(".log").read_text().strip())


# -- 3. kernels against plain -----------------------------------------------
def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN where NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in f32 units in the last place between finite a and b."""
    fin = a.isfinite() & b.isfinite()
    d = (a[fin].view(torch.int32).long() - b[fin].view(torch.int32).long()).abs()
    return int(d.max()) if d.numel() else 0


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


def check_decode_prob() -> float:
    """The probability-map entry against its plain version."""
    rng = np.random.RandomState(SEED)
    max_err = 0.0
    for name, prob, loc, (vh, vw) in _kernel_cases(rng):
        prob, loc, vh, vw = (t.cuda().contiguous() for t in (prob, loc, vh, vw))
        for scale in (1.0, 0.75):
            got = cuda_decode.decode_pose(prob, loc, vh, vw, scale)
            ref = decode_pose_batch(prob, loc, scale=scale, valid_hw=(vh, vw))
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"decode (prob entry) differs from plain on {name}")
            max_err = max(max_err, float((got - ref).abs().max()))
        # argmax indices: with zero offsets at scale 1, x and y are cell*8+4
        cells = cuda_decode.decode_pose(prob, torch.zeros_like(loc), vh, vw, 1.0)
        idx = ((cells[:, 1] - 4) / 8).long() * prob.shape[3] + ((cells[:, 0] - 4) / 8).long()
        rows = torch.arange(prob.shape[2], device="cuda").reshape(1, 1, -1, 1)
        cols = torch.arange(prob.shape[3], device="cuda").reshape(1, 1, 1, -1)
        keep = (rows < vh.reshape(-1, 1, 1, 1)) & (cols < vw.reshape(-1, 1, 1, 1))
        masked = torch.where(keep, prob, torch.tensor(float("-inf"), device="cuda"))
        if not torch.equal(idx, torch.argmax(masked.flatten(2), dim=2)):
            raise AssertionError(f"decode (prob entry) argmax differs from plain on {name}")
    log(f"decode prob entry == plain: argmax and pose bit-equal on {len(KERNEL_SHAPES) * 4} "
        f"cases x 2 scales (max |err| {max_err:.3g})")
    return max_err


def _fused_map(logits: np.ndarray, loc: np.ndarray, extra: int, rng) -> torch.Tensor:
    """(N, h, w, J) logits + (N, h, w, 2J) loc [+ extra channels] -> the
    heads' (N, C, h, w) f32 channels_last map on the card."""
    parts = [logits, loc] + ([rng.randn(*logits.shape[:3], extra).astype(np.float32)] if extra else [])
    nhwc = torch.from_numpy(np.ascontiguousarray(np.concatenate(parts, -1))).cuda()
    return nhwc.permute(0, 3, 1, 2)


def check_decode_fused() -> float:
    """The fused entry (the serving path's) against `decode_fused_plain` on
    the card: argmax, x, y and offsets bit for bit; the confidence is the
    kernel's sigmoid against torch.sigmoid's, held within 1 ulp and
    reported when not bit-equal."""
    rng = np.random.RandomState(SEED + 1)
    max_err, conf_ulps, cases = 0.0, 0, 0
    limits = cuda_decode.fused_limits()
    for n, h, w, extra in FUSED_SHAPES:
        loc = rng.randn(n, h, w, 2 * J).astype(np.float32)
        raw = (rng.randn(n, h, w, J) * 3).astype(np.float32)
        nan = raw.copy()
        nan[0, h // 2, w // 3, :3] = np.nan
        nan[-1, 0, 0, 5] = np.nan
        variants = {
            "random": raw,
            "ties": np.round(raw),                                   # many equal maxima
            "all-equal": np.full_like(raw, 0.25),
            "bf16": torch.from_numpy(raw).to(torch.bfloat16).float().numpy(),
            "nan": nan,
        }
        for name, logits in variants.items():
            fused = _fused_map(logits.astype(np.float32), loc, extra, rng)
            for masked in (False, True):
                vh = rng.randint(1, h + 1, n).tolist() if masked else [h] * n
                vw = rng.randint(1, w + 1, n).tolist() if masked else [w] * n
                for scale in (1.0, 0.75):
                    got = cuda_decode.decode_fused(fused, J, vh, vw, scale)
                    ref = cuda_decode.decode_fused_plain(fused, J, vh, vw, scale)
                    torch.cuda.synchronize()
                    what = f"{(n, fused.shape[1], h, w)} {name}{' masked' if masked else ''}"
                    if not _same(got[:, [0, 1, 3, 4]], ref[:, [0, 1, 3, 4]]):
                        raise AssertionError(f"decode (fused entry) pose differs from plain on {what}")
                    if not torch.equal(got[:, 2].isnan(), ref[:, 2].isnan()):
                        raise AssertionError(f"decode (fused entry) NaN conf differs on {what}")
                    conf_ulps = max(conf_ulps, _ulps(got[:, 2], ref[:, 2]))
                    if conf_ulps > 1:
                        raise AssertionError(f"decode (fused entry) conf {conf_ulps} ulp off on {what}")
                    d = (got - ref).abs()
                    max_err = max(max_err, float(d[d.isfinite()].max()))
                    cases += 1
    log(f"decode fused entry == plain ({limits['cluster']}-block clusters): argmax, x, y and "
        f"offsets bit-equal on {cases} cases (random, ties, all-equal, bf16-valued, NaN; "
        f"masked and not; 2 scales); conf "
        + ("bit-equal to torch.sigmoid's" if conf_ulps == 0 else f"within {conf_ulps} ulp of "
           "torch.sigmoid's (not bit-equal)") + f"; max |err| {max_err:.3g}")
    return max_err


def _epilogue_case(rng, shape, residual, crop=(0, 0)):
    n, c, h, w = shape
    y = torch.from_numpy((rng.randn(n, h, w, c) * 4).astype(np.float32))
    y.view(-1)[:4] = torch.tensor([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8), -0.0])
    y = y.cuda().permute(0, 3, 1, 2)
    bias = torch.from_numpy(rng.randn(c).astype(np.float32)).cuda()
    res = None
    if residual:
        big = torch.from_numpy(rng.randn(n, h + crop[0], w + crop[1], c).astype(np.float32) * 3)
        big = big.to(torch.bfloat16).float().cuda().permute(0, 3, 1, 2)
        res = big[:, :, :h, :w]
    return y, bias, res


def check_conv_epilogue() -> float:
    """The epilogue against `conv_epilogue_plain` on the card, bit for bit,
    at the serving forward's shapes (704 canvas)."""
    from deepcut_tpu_torch.ops import conv_epilogue

    rng = np.random.RandomState(SEED + 2)
    cases = 0
    for shape, residual, relu, crop in EPILOGUE_CASES:
        y, bias, res = _epilogue_case(rng, shape, residual, crop)
        got = conv_epilogue.conv_epilogue(y.clone(), bias, res, relu)
        ref = conv_epilogue.conv_epilogue_plain(y, bias, res, relu)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"conv_epilogue differs from plain on {shape} residual={residual} "
                                 f"crop={crop} relu={relu}")
        cases += 1
    log(f"conv_epilogue == plain: bit-equal on {cases} cases (vec4 and scalar, residual dense "
        f"and strided, ReLU and not)")
    return 0.0


def check_tf32_exact() -> None:
    """cuDNN with TF32 allowed (the serving `exact_conv`) against TF32 not
    allowed, on bf16-valued operands: every product is exact in TF32, so the
    two differ only by the order of f32 sums. A lossy algorithm pick
    (Winograd, FFT) would show here."""
    from deepcut_tpu_torch.ops.conv import exact_conv

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cl = torch.channels_last
    worst = 0.0
    for name, xs, ws, pad, dil, transposed in TF32_CASES:
        x = torch.randn(xs, generator=gen, device="cuda").to(torch.bfloat16).float().contiguous(memory_format=cl)
        w = (torch.randn(ws, generator=gen, device="cuda") * (2.0 / (ws[1] * ws[2] * ws[3])) ** 0.5
             ).to(torch.bfloat16).float().contiguous(memory_format=cl)
        stride = 2 if transposed else 1
        got = exact_conv(x, w, stride=stride, pad=pad, dilation=dil, transposed=transposed)
        if transposed:
            ref = torch.ops.aten.cudnn_convolution_transpose(
                x, w, (pad, pad), (0, 0), (stride, stride), (dil, dil), 1, False, False, False)
        else:
            ref = torch.ops.aten.cudnn_convolution(
                x, w, (pad, pad), (stride, stride), (dil, dil), 1, False, False, False)
        rel = float((got - ref).abs().max() / ref.abs().max())
        worst = max(worst, rel)
        log(f"TF32 conv on bf16 values, {name} {tuple(xs)} * {tuple(ws)}: max |diff| / max |ref| "
            f"{rel:.3g} against TF32 off")
        if rel > TF32_RTOL:
            raise AssertionError(f"TF32 conv not exact on bf16 values at {name}: {rel}")


def _i8(gen, shape, memory_format=torch.channels_last) -> torch.Tensor:
    """Random int8 values in [-127, 127] on the card."""
    return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8
                         ).contiguous(memory_format=memory_format)


def check_int8_im2col() -> float:
    """int8_im2col against its plain version bit for bit, and the route
    (im2col rows or the input itself, packed weight, torch._int_mm) equal
    to the plain f64 convolution's int32 accumulator, exactly."""
    from deepcut_tpu_torch.ops import int8_conv as ic

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for name, xs, k, stride, pad, dil, lhs, cout in IM2COL_CASES:
        x = _i8(gen, xs)
        kw = dict(stride=stride, pad=pad, dilation=dil, lhs_dilation=lhs)
        got = ic.int8_im2col(x, k, **kw)
        ref = ic.int8_im2col_plain(x, k, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"int8_im2col differs from plain at {name} {xs}")
        if lhs > 1:  # the int8 deconv: (Cin, Cout, kh, kw), packed flipped
            w = _i8(gen, (xs[1], cout, *ic.kernel_hw(k)), torch.contiguous_format)
            packed, want = ic.pack_deconv_weight(w), ic.deconv_i8_plain(x, w, stride=lhs)
        else:
            w = _i8(gen, (cout, xs[1], *ic.kernel_hw(k)), torch.contiguous_format)
            packed, want = ic.pack_conv_weight(w), ic.conv_i8_plain(x, w, **kw)
        acc = ic.conv_i8(x, packed, cout, k, **kw)
        torch.cuda.synchronize()
        if not torch.equal(acc, want):
            raise AssertionError(f"im2col + torch._int_mm differs from the exact accumulator at "
                                 f"{name} {xs} (max |diff| {int((acc - want).abs().max())})")
        log(f"int8_im2col == plain and the route == the exact int32 accumulator: {name} "
            f"{tuple(xs)} k={k} stride={stride} pad={pad} dilation={dil} lhs={lhs} -> "
            f"A {tuple(got.shape)}, acc {tuple(acc.shape)} max |acc| {int(acc.abs().max())}")
    return 0.0


def _i8_epilogue_case(gen, shape, ldc, residual, crop=(0, 0)):
    """(acc view with row stride ldc, scale, bias, residual) on the card."""
    n, c, h, w = shape
    rows = torch.randint(-2**24, 2**24, (n * h * w, ldc), generator=gen, device="cuda",
                         dtype=torch.int32)
    acc = rows.view(n, h, w, ldc).permute(0, 3, 1, 2)[:, :c]
    scale = (torch.rand(c, generator=gen, device="cuda") * 1e-3 + 1e-5) * 0.0123
    bias = torch.randn(c, generator=gen, device="cuda") * 3
    res = None
    if residual == "i8":
        res = _i8(gen, (n, c, h, w))
    elif residual == "f32":
        big = torch.randn((n, c, h + crop[0], w + crop[1]), generator=gen, device="cuda") * 30
        res = big.to(torch.bfloat16).float().contiguous(memory_format=torch.channels_last)
        res = res[:, :, :h, :w]
    return acc, scale, bias, res


def check_int8_epilogue() -> float:
    """int8_epilogue against its plain version bit for bit in each mode of
    the int8 forward, at its shapes (704 canvas)."""
    from deepcut_tpu_torch.ops import int8_conv as ic

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for name, shape, ldc, residual, crop, kw in I8_EPILOGUE_CASES:
        acc, scale, bias, res = _i8_epilogue_case(gen, shape, ldc, residual, crop)
        got = ic.int8_epilogue(acc, scale, bias, res, **kw)
        ref = ic.int8_epilogue_plain(acc, scale, bias, res, **kw)
        torch.cuda.synchronize()
        for g, r, what in zip(got, ref, ("f32", "int8")):
            if (g is None) != (r is None) or (g is not None and not _same(g, r)):
                raise AssertionError(f"int8_epilogue {what} output differs from plain at {name}")
        log(f"int8_epilogue == plain: {name} {shape} (acc row stride {ldc}): "
            + ", ".join(f"{what} bit-equal" for g, what in zip(got, ("f32", "int8")) if g is not None))
    return 0.0


def check_quantize_i8() -> float:
    """quantize_i8 against its plain version bit for bit, with +-127
    saturation and exact .5 ties planted (a power-of-two scale makes
    x * (1/s) exact)."""
    from deepcut_tpu_torch.ops import int8_conv as ic

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for shape, s in QUANTIZE_CASES:
        x = (torch.randn(shape, generator=gen, device="cuda") * 40 * s
             ).contiguous(memory_format=torch.channels_last)
        flat = x.permute(0, 2, 3, 1).reshape(-1)
        k = min(flat.numel() // 4, 4096)
        flat[:k] = (torch.randint(-200, 200, (k,), generator=gen, device="cuda") + 0.5) * s
        flat[k:2 * k] = torch.randn(k, generator=gen, device="cuda") * 1000 * s
        got = ic.quantize_i8(x, s)
        ref = ic.quantize_i8_plain(x, s)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"quantize_i8 differs from plain at {shape} s={s}")
        sat = float((got.abs() == 127).float().mean())
        log(f"quantize_i8 == plain: {shape} s={s}, bit-equal ({sat:.3f} saturated, "
            f"{k} planted .5 ties)")
    return 0.0


def _view(geometry, fill):
    """A tensor view of a recorded (dtype, shape, strides, storage offset),
    its storage filled by ``fill(numel, dtype)``."""
    dtype, shape, strides, offset = geometry
    numel = offset + 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    return fill(numel, getattr(torch, dtype.split(".")[-1])).as_strided(shape, strides, offset)


def replay_path_geometries(epilogue: dict, recorded: dict, device: str = "cuda") -> dict:
    """Every distinct launch geometry (shape, strides, storage offset and
    mode) that the main paths gave conv_epilogue, int8_im2col,
    int8_epilogue and quantize_i8 (recorded by their wrappers: `epilogue`
    is conv_epilogue's record, `recorded` int8_conv's), replayed on
    fresh random inputs against the plain version on the card, bit for bit.
    -> {kernel: number of geometries}. On the CPU (a rehearsal) both sides
    take the plain version."""
    from deepcut_tpu_torch.ops import conv_epilogue, int8_conv as ic

    gen = torch.Generator(device=device).manual_seed(SEED + 8)

    def randn(scale, dtype=torch.float32):
        return lambda n, _: (torch.randn(n, generator=gen, device=device) * scale).to(dtype).float()

    def rand_i8(n, _):
        return torch.randint(-127, 128, (n,), generator=gen, device=device, dtype=torch.int8)

    def rand_i32(n, _):
        return torch.randint(-2**24, 2**24, (n,), generator=gen, device=device, dtype=torch.int32)

    def residual(g):
        if g is None:
            return None
        return _view(g, rand_i8 if g[0] == "torch.int8" else randn(30, torch.bfloat16))

    done = {}
    for (yg, has_bias, rg, relu) in epilogue:
        y = _view(yg, randn(4))
        bias = torch.randn(yg[1][1], generator=gen, device=device) if has_bias else None
        res = residual(rg)
        got = conv_epilogue.conv_epilogue(y.clone(), bias, res, relu)
        if not torch.equal(got, conv_epilogue.conv_epilogue_plain(y, bias, res, relu)):
            raise AssertionError(f"conv_epilogue differs from plain at the path's {yg} "
                                 f"bias={has_bias} residual={rg} relu={relu}")
    done["conv_epilogue"] = len(epilogue)
    for (xg, k, stride, pad, dil, lhs, min_rows, width) in recorded.get("im2col_launches", {}):
        x = _view(xg, rand_i8)
        kw = dict(stride=stride, pad=pad, dilation=dil, lhs_dilation=lhs, min_rows=min_rows,
                  width=width)
        if not torch.equal(ic.int8_im2col(x, k, **kw), ic.int8_im2col_plain(x, k, **kw)):
            raise AssertionError(f"int8_im2col differs from plain at the path's {xg} k={k} {kw}")
    for (ag, rg, relu, bf16, f32_out, _), (res_scale, requant_s) in recorded.get(
            "epilogue_launches", {}).items():
        acc = _view(ag, rand_i32)
        c = ag[1][1]
        scale = (torch.rand(c, generator=gen, device=device) * 1e-3 + 1e-5) * 0.0123
        bias = torch.randn(c, generator=gen, device=device) * 3
        res = residual(rg)
        kw = dict(residual_scale=res_scale, relu=relu, bf16=bf16, f32_out=f32_out,
                  requant_s=requant_s)
        got = ic.int8_epilogue(acc, scale, bias, res, **kw)
        ref = ic.int8_epilogue_plain(acc, scale, bias, res, **kw)
        if not all((g is None and r is None) or (g is not None and r is not None and _same(g, r))
                   for g, r in zip(got, ref)):
            raise AssertionError(f"int8_epilogue differs from plain at the path's {ag} "
                                 f"residual={rg} {kw}")
    def planted(s):  # near-.5 ties and saturation, as check_quantize_i8 plants them
        def fill(n, _):
            v = torch.randn(n, generator=gen, device=device) * 40 * s
            k = min(n // 4, 4096)
            v[:k] = (torch.randint(-200, 200, (k,), generator=gen, device=device) + 0.5) * s
            v[k:2 * k] = torch.randn(k, generator=gen, device=device) * 1000 * s
            return v
        return fill

    for xg, (s,) in recorded.get("quantize_launches", {}).items():
        x = _view(xg, planted(s))
        if not torch.equal(ic.quantize_i8(x, s), ic.quantize_i8_plain(x, s)):
            raise AssertionError(f"quantize_i8 differs from plain at the path's {xg} s={s}")
    for name, key in (("int8_im2col", "im2col_launches"), ("int8_epilogue", "epilogue_launches"),
                      ("quantize_i8", "quantize_launches")):
        done[name] = len(recorded.get(key, {}))
    log(f"the main paths' launch geometries replayed against the plain versions on fresh "
        f"random inputs, bit-equal: {done}")
    return done


def phase_kernels_vs_plain() -> dict:
    errs = {"decode_pose_prob": check_decode_prob(), "decode_pose": check_decode_fused(),
            "conv_epilogue": check_conv_epilogue(), "int8_im2col": check_int8_im2col(),
            "int8_epilogue": check_int8_epilogue(), "quantize_i8": check_quantize_i8()}
    check_tf32_exact()
    return errs


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
    from deepcut_tpu_torch.ops import conv_epilogue

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
    if cuda_decode.launches == 0 or conv_epilogue.launches == 0:
        raise AssertionError("estimate_pose did not launch the decode and epilogue kernels")
    log(f"estimate_pose 480x640: finite (5, 14), conf min {pose[2].min():.4f} "
        f"max {pose[2].max():.4f}, launches so far: decode {cuda_decode.launches}, "
        f"conv_epilogue {conv_epilogue.launches}")

    batch = est.estimate_pose_batch([f480] * 4)
    for i in range(4):
        agreement(batch[i], pose, f"estimate_pose_batch[{i}] vs estimate_pose")

    sm16, _ = est.scoremaps(f480)
    sm32, _ = est32.scoremaps(f480)
    d = float(np.abs(sm16 - sm32).max())
    same = (sm16.reshape(-1, J).argmax(0) == sm32.reshape(-1, J).argmax(0)).mean()
    log(f"bf16 vs f32 scoremaps (TF32 off): max |dprob| {d:.4g} (with the bias rounded twice: "
        f"{BIAS_TWICE_BF16_GAP}), argmax agrees on {same:.3f} of joints")
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


# -- Q. the int8 slice ---------------------------------------------------------
def _flips(a: np.ndarray, b: np.ndarray) -> float:
    """The fraction of scoremap cells whose probability moved by > 0.25."""
    return float(np.mean(np.abs(a - b) > INT8_FLIP))


def phase_int8(est16, rng):
    """int8 serving at full width from the tamed weights: quantize_int8 on
    a 480x640 frame, then every estimator path against the bf16 one."""
    from deepcut_tpu_torch.models.quantize import forward_int8, prepare_int8
    from deepcut_tpu_torch.ops import int8_conv

    cfg = deepercut_config(152)
    params = tame_params(cfg)
    est = PoseEstimator(params, cfg, device="cuda")
    f480 = frame(rng, 480, 640)
    t0 = time.perf_counter()
    est.quantize_int8(f480)
    torch.cuda.synchronize()
    log(f"quantize_int8 on a 480x640 frame (512x640 bucket, f32 calibration, TF32 off): "
        f"{time.perf_counter() - t0:.2f} s, {len(est.model.act_scales)} activation scales, "
        f"{len(est.model.convs)} int8 trunk convs")
    if not est.is_int8:
        raise AssertionError("quantize_int8 did not switch the estimator")

    pose = est.estimate_pose(f480)
    if pose is None or pose.shape != (5, J) or not np.isfinite(pose).all():
        raise AssertionError(f"int8 estimate_pose: bad pose {pose}")
    if int8_conv.epilogue_launches == 0 or int8_conv.im2col_launches == 0:
        raise AssertionError("int8 estimate_pose did not launch the int8 kernels")
    log(f"int8 estimate_pose 480x640: finite (5, 14), conf min {pose[2].min():.4f} max "
        f"{pose[2].max():.4f}; launches so far: im2col {int8_conv.im2col_launches}, epilogue "
        f"{int8_conv.epilogue_launches}, quantize {int8_conv.quantize_launches}")
    batch = est.estimate_pose_batch([f480] * 4)
    for i in range(4):
        agreement(batch[i], pose, f"int8 estimate_pose_batch[{i}] vs estimate_pose")

    sm8, _ = est.scoremaps(f480)
    sm16, _ = est16.scoremaps(f480)
    flips = _flips(sm8, sm16)
    same = (sm8.reshape(-1, J).argmax(0) == sm16.reshape(-1, J).argmax(0)).mean()
    log(f"int8 vs bf16 scoremaps: |dprob| > {INT8_FLIP} on {flips:.4f} of cells (held below "
        f"{INT8_MAX_FLIPS}), max |dprob| {np.abs(sm8 - sm16).max():.4g}, argmax agrees on "
        f"{same:.3f} of joints, pose conf int8 {pose[2].mean():.4f} vs bf16 "
        f"{est16.estimate_pose(f480)[2].mean():.4f} (mean)")
    if not np.isfinite(sm8).all() or flips >= INT8_MAX_FLIPS:
        raise AssertionError(f"int8 scoremaps off the bf16 ones: {flips}")

    tiled = []
    inner = est._scoremaps_tiled
    est._scoremaps_tiled = lambda *a: tiled.append(a) or inner(*a)
    pose_hd = est.estimate_pose(frame(rng, 720, 1280))
    del est._scoremaps_tiled
    if not tiled or pose_hd is None or not np.isfinite(pose_hd).all():
        raise AssertionError("int8: the HD frame did not take the tiled path or gave no pose")
    log("int8 HD 720x1280: tiled path, finite (5, 14)")

    est_dq = PoseEstimator(params, cfg, device="cuda")
    est_dq.quantize_int8(f480, int8_deconv=True)
    pose_dq = est_dq.estimate_pose(f480)
    sm_dq, _ = est_dq.scoremaps(f480)
    flips_dq = _flips(sm_dq, sm16)
    log(f"int8_deconv=True: finite pose {pose_dq is not None and np.isfinite(pose_dq).all()}, "
        f"|dprob| > {INT8_FLIP} against bf16 on {flips_dq:.4f} of cells")
    if pose_dq is None or not np.isfinite(pose_dq).all() or flips_dq >= INT8_MAX_FLIPS:
        raise AssertionError("int8_deconv=True estimator off the bf16 one")
    del est_dq

    # the int8-resident stream against the plain int8 forward, both against
    # bf16, as tests/test_quantize.py:59-61 holds it
    canvas = est16._canvas(f480, 1.0, 512, 640).permute(0, 3, 1, 2)
    fp = {n: {k: v.detach().float() for k, v in e.items()}
          for n, e in est16.model.param_dict().items()}
    with torch.inference_mode():
        qp, sc = prepare_int8(fp, cfg, canvas)
        ref = est16.model(canvas, heads=HEADS)["prob"]
        e = {res: float((forward_int8(qp, sc, canvas, cfg, int8_residual=res,
                                      heads=HEADS)["prob"] - ref).abs().max())
             for res in (False, True)}
    log(f"forward_int8 max |dprob| against bf16: plain {e[False]:.4g}, int8_residual=True "
        f"{e[True]:.4g} (held below max(2.5 x plain, 0.15))")
    if not e[True] < max(2.5 * e[False], 0.15):
        raise AssertionError("int8_residual=True outside the int8 envelope")
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


def phase_server(est, rng, int8: bool = False):
    """int8: the service's --int8, which calibrates `est` on the first
    request's frame."""
    spec = importlib.util.spec_from_file_location("pose_serve", ROOT / "examples/pose/serve.py")
    serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve)
    app = serve.PoseApp(estimator=est, int8=int8, batch_window_ms=4)
    httpd = serve.serve(app, port=0, background=True)
    try:
        frames = [frame(rng, 480, 640), frame(rng, 300, 400), frame(rng, 720, 1280)]
        with ThreadPoolExecutor(len(frames)) as pool:
            answers = list(pool.map(lambda f: _post_png(httpd.server_address[1], f), frames))
    finally:
        httpd.shutdown()
        httpd.server_close()
    if int8 and not est.is_int8:
        raise AssertionError("serve.py --int8 did not quantize the estimator")
    what = "int8 " if int8 else ""
    for f, ans in zip(frames, answers):
        if not ans.get("ok") or len(ans["joints"]) != J:
            raise AssertionError(f"{what}server answer for {f.shape}: {ans}")
        direct = est.estimate_pose(f)
        served = np.asarray(ans["pose"], np.float32)
        served[:2] = [[j["x"] for j in ans["joints"]], [j["y"] for j in ans["joints"]]]
        want = direct.copy()
        want[:2] = np.round(direct[:2].astype(np.float64), 2)
        agreement(served, want, f"{what}HTTP {f.shape[0]}x{f.shape[1]} vs estimate_pose")
    log(f"{what}server: {len(frames)} concurrent requests answered ok, "
        f"{app.batcher.batches_run} batches for {app.batcher.images_run} images")


# -- T1. training through the CLI entry point --------------------------------
class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def write_index(path: Path, records) -> Path:
    """A window file in the reference's format (pose_data_layer.cpp:146-207):
    per image ``# i``, its path, ``3 height width``, the joint count, then
    ``class x y`` per joint. records: (png path, h, w, (14, 2) xy)."""
    lines = []
    for i, (png, h, w, xy) in enumerate(records):
        lines += [f"# {i}", str(png), f"3 {h} {w}", str(J)]
        lines += [f"{j + 1} {float(x)} {float(y)}" for j, (x, y) in enumerate(xy)]
    path.write_text("\n".join(lines) + "\n")
    return path


def write_frames(root: Path, rng, n: int, h: int, w: int) -> Path:
    """n random h x w frames on disk, one person with all 14 joints each;
    -> their window file."""
    from PIL import Image

    root.mkdir(exist_ok=True)
    recs = []
    for i in range(n):
        png = root / f"frame{i}.png"
        Image.fromarray(frame(rng, h, w)).save(png)
        xy = np.stack([rng.uniform(20, w - 20, J), rng.uniform(20, h - 20, J)], 1)
        recs.append((png, h, w, xy.astype(np.float32)))
    return write_index(root / "train_index.txt", recs)


def write_solver(root: Path, index: Path, name: str, max_iter: int, snapshot: int,
                 display: int = 1, no_jitter: bool = False) -> Path:
    """Copies of examples/pose/pose_{train,solver}.prototxt over `index`: the
    published recipe with a short run and the rate cut to 1e-5 for random
    weights. no_jitter: scale 1 and no scale jitter, so that every frame of
    one size fills the same canvas."""
    net = (ROOT / "examples/pose/pose_train.prototxt").read_text().replace(
        "examples/pose/train_index.txt", str(index))
    if no_jitter:
        net = "\n".join(ln.replace("scale: 0.8452830189", "scale: 1.0")
                        for ln in net.splitlines() if "scale_jitter" not in ln)
    (root / f"{name}_train.prototxt").write_text(net)
    solver = (ROOT / "examples/pose/pose_solver.prototxt").read_text()
    solver = solver.replace("examples/pose/pose_train.prototxt", str(root / f"{name}_train.prototxt"))
    solver = solver.replace("examples/pose/snapshots/pose", str(root / "snap" / name))
    sets = {"max_iter": max_iter, "display": display, "snapshot": snapshot, "base_lr": 1e-5}
    lines = [f"{ln.split(':')[0]}: {sets[ln.split(':')[0]]}" if ln.split(":")[0] in sets
             else ln.replace("multistep_lr: 0.005", "multistep_lr: 0.00001")
             for ln in solver.splitlines()]
    path = root / f"{name}_solver.prototxt"
    path.write_text("\n".join(lines + [f"random_seed: {SEED}"]) + "\n")
    return path


def run_cli(argv):
    """`cli.main(argv)`, its output shown and returned; every logged loss
    must be finite."""
    from deepcut_tpu_torch.tools import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        if cli.main(argv) != 0:
            raise AssertionError(f"cli train {argv} returned non-zero")
    out = buf.getvalue()
    losses = [float(ln.split("loss = ")[1].split()[0]) for ln in out.splitlines()
              if ln.startswith("Iteration ") and "loss = " in ln]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"cli train {argv}: losses {losses}")
    return out, losses


def phase_train_cli(root: Path, rng):
    from deepcut_tpu_torch.models.convert import save_caffemodel

    index = write_frames(root / "frames", rng, 4, 480, 640)
    weights = root / "tamed_resnet152.caffemodel"
    save_caffemodel(str(weights), tame_params(deepercut_config(152)))
    base = ["train", "-resnet", "152", "-device", "cuda"]

    f32_solver = write_solver(root, index, "f32", 3, 3)
    out, losses = run_cli(base + ["-solver", str(f32_solver), "-weights", str(weights)])
    if not out.startswith("f32 training: TF32 off"):
        raise AssertionError("f32 training did not state that TF32 is off")
    snap = root / "snap" / "f32_iter_3"
    for suffix in (".npz", ".caffemodel"):
        if not snap.with_suffix(suffix).is_file():
            raise AssertionError(f"no snapshot {snap.with_suffix(suffix)}")
    log(f"T1 cli train f32 (ResNet-152 from a .caffemodel, 480x640 frames): losses {losses}")

    out, resumed = run_cli(base + ["-solver", str(write_solver(root, index, "f32", 5, 3)),
                                   "-snapshot", str(snap.with_suffix(".npz"))])
    if "at iter 3" not in out or len(resumed) != 2:
        raise AssertionError("the .npz snapshot did not restore at iter 3 and train on")
    log(f"T1 cli train -snapshot {snap.name}.npz: restored at iter 3, losses {resumed}")

    _, mixed = run_cli(base + ["-solver", str(write_solver(root, index, "mixed", 2, 0)),
                               "-weights", str(weights), "-mixed_precision", "-remat"])
    log(f"T1 cli train -mixed_precision -remat: losses {mixed}")
    _, warped = run_cli(base + ["-solver", str(write_solver(root, index, "warp", 2, 0)),
                                "-weights", str(weights), "-augment_device"])
    log(f"T1 cli train -augment_device: losses {warped}")
    return f32_solver, snap.with_suffix(".caffemodel")


# -- T2. gradients at full width ---------------------------------------------
def first_max_pool_grad(x, g, kernel=3, stride=2):
    """Plain Caffe pool backward: each window's cotangent to its FIRST max
    in row-major scan order (torch.argmax's documented tie rule)."""
    n, c, h, w = x.shape
    oh, ow = g.shape[2:]
    ph, pw = max((oh - 1) * stride + kernel - h, 0), max((ow - 1) * stride + kernel - w, 0)
    xp = F.pad(x.float(), (0, pw, 0, ph), value=float("-inf"))
    win = xp.unfold(2, kernel, stride).unfold(3, kernel, stride).reshape(n, c, oh, ow, -1)
    idx = win.argmax(-1)
    rows = torch.arange(oh, device=x.device).reshape(oh, 1) * stride + idx // kernel
    cols = torch.arange(ow, device=x.device).reshape(1, ow) * stride + idx % kernel
    flat = (rows * (w + pw) + cols).reshape(n, c, -1)
    gx = torch.zeros(n, c, (h + ph) * (w + pw), device=x.device)
    gx.scatter_add_(2, flat, g.float().reshape(n, c, -1))
    return gx.reshape(n, c, h + ph, w + pw)[:, :, :h, :w]


def phase_train_grads(solver: Path):
    from deepcut_tpu_torch.models.train import loss_fn
    from deepcut_tpu_torch.models.resnet import is_trainable
    from deepcut_tpu_torch.parallel.train_step import batch_preparer
    from deepcut_tpu_torch.solver.solver import SolverParams
    from deepcut_tpu_torch.tools.cli import pose_data

    tcfg, stats, src, _ = pose_data(SolverParams.from_prototxt(str(solver)))
    try:
        batch = batch_preparer("cuda", tcfg, stats)(src.next_batch(2))
    finally:
        src.close()
    cfg = deepercut_config(152, pairwise=False)
    params = tame_params(cfg)
    # head biases as a trained head has them, so that the mixed check below
    # also holds the heads' bias path, and a dropped bias shows
    bias = np.random.RandomState(SEED)
    for name in ("res5c_up_pose", "res3d_pose", "res5c_up_locref", "res3d_locref"):
        params[name]["b"] = torch.from_numpy(
            (bias.randn(*params[name]["b"].shape) * HEAD_BIAS_STD).astype(np.float32))
    model = DeeperCut(params, cfg, folded=False, trainable=True).to(
        "cuda", memory_format=torch.channels_last)
    params = model.param_dict()
    leaves = [v for n, e in params.items() if is_trainable(n) for v in e.values()]

    def loss_and_grads(**kw):
        total, _ = loss_fn(params, batch, dataclasses.replace(cfg, **kw))
        return float(total.detach()), torch.autograd.grad(total, leaves)

    torch.backends.cudnn.deterministic = True
    try:
        loss32, g32 = loss_and_grads()
        loss_r, g_r = loss_and_grads(remat=True)
    finally:
        torch.backends.cudnn.deterministic = False
    if loss_r != loss32 or not all(torch.equal(a, b) for a, b in zip(g_r, g32)):
        raise AssertionError("remat changed the loss or a gradient (deterministic cuDNN)")
    del g_r
    if not all(bool(torch.isfinite(g).all()) for g in g32):
        raise AssertionError("non-finite f32 gradient")
    log(f"T2 remat == no remat at full width (batch 2, {tuple(batch['image'].shape)}): "
        f"loss {loss32:.6f} and {len(g32)} gradients bit-equal")
    del g32
    loss16, _ = loss_and_grads(mixed_train=True)
    rel = abs(loss16 - loss32) / abs(loss32)
    # the check's reach: the same mixed forward with one head's bias dropped
    dropped = {**params, "res3d_pose": {**params["res3d_pose"],
                                        "b": torch.zeros_like(params["res3d_pose"]["b"])}}
    with torch.no_grad():
        fault, _ = loss_fn(dropped, batch, dataclasses.replace(cfg, mixed_train=True))
    rel_fault = abs(float(fault) - loss32) / abs(loss32)
    log(f"T2 mixed loss {loss16:.6f} vs f32 loss {loss32:.6f}: relative {rel:.3g} "
        f"(held to {MIXED_LOSS_RTOL}); with res3d_pose's bias dropped {float(fault):.6f}, "
        f"relative {rel_fault:.3g}")
    if not math.isfinite(loss16) or rel > MIXED_LOSS_RTOL:
        raise AssertionError("mixed-precision loss off the f32 loss")
    if not rel_fault > MIXED_LOSS_RTOL:
        raise AssertionError("the mixed-loss check cannot see a dropped head bias")
    del model, params, leaves, batch, dropped

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        for fmt in (torch.contiguous_format, torch.channels_last):
            x = torch.relu(torch.round(torch.randn((1, 64, 344, 344), generator=gen, device="cuda")
                                       * 2) / 2)
            x[:, :, :40, :40] = 0.5                                 # plateaus of equal maxima
            x = x.to(dtype).contiguous(memory_format=fmt).requires_grad_()
            y = F.max_pool2d(x, 3, 2, 0, ceil_mode=True)
            g = (torch.randint(-8, 9, y.shape, generator=gen, device="cuda") / 8).to(dtype)
            (got,) = torch.autograd.grad(y, x, g)              # sums of k/8: exact in f32 and bf16
            want = first_max_pool_grad(x.detach(), g)
            if not torch.equal(got.float(), want):
                raise AssertionError(f"pool backward is not first-max-wins ({dtype}, {fmt})")
    log("T2 stem pool backward (1,64,344,344) f32/bf16, NCHW/channels_last: "
        "equal to the plain first-max scatter")


# -- T3. it learns, through the port's estimator -------------------------------
def disc_frames(n: int, seed: int, h: int = 128, w: int = 128):
    """The coloured-disc task of tests/test_pose_training_e2e.py: each of the
    14 joints a disc of its own colour on a noisy grey frame (BGR)."""
    import colorsys

    colors = [tuple(int(255 * c) for c in colorsys.hsv_to_rgb(j / J, 1, 1))[::-1] for j in range(J)]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xy = np.stack([rng.uniform(10, w - 10, J), rng.uniform(10, h - 10, J)], 1).astype(np.float32)
        img = np.clip(np.full((h, w, 3), 127, np.int16) + rng.randint(-20, 20, (h, w, 3)),
                      0, 255).astype(np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        for j in range(J):
            img[(xx - xy[j, 0]) ** 2 + (yy - xy[j, 1]) ** 2 <= 25] = colors[j]
        out.append((img, xy))
    return out


def pckh(est, samples, threshold: float = 0.5):
    """-> (mean, per joint) PCKh of `est` on samples of {image, gt_xy,
    head_size}: a joint is found within threshold * head size; a frame
    without a pose misses all (MPII's rule, as deepcut_tpu/pose/evaluate.py)."""
    hits = []
    for s in samples:
        pose = est.estimate_pose(s["image"])
        pred = np.full((J, 2), np.inf, np.float32) if pose is None else pose[:2].T
        hits.append(np.linalg.norm(pred - s["gt_xy"], axis=1) <= threshold * s["head_size"])
    hits = np.asarray(hits)
    return float(hits.mean()), hits.mean(axis=0)


def phase_train_learns(root: Path, snapshot_model: Path, device: str = "cuda"):
    """The disc task through the CLI's data source and `PoseSolver`, scored
    by the eval hook through the port's estimator. `device` other than cuda
    is for rehearsing the recipe off the card (no kernel there)."""
    from PIL import Image
    from deepcut_tpu_torch.models.resnet import DeeperCutConfig
    from deepcut_tpu_torch.pose.estimate import get_estimator
    from deepcut_tpu_torch.solver.solver import PoseSolver, SolverParams
    from deepcut_tpu_torch.tools.cli import pose_data

    disc = root / "discs"
    disc.mkdir()
    recs = []
    for i, (img, xy) in enumerate(disc_frames(160, 0)):
        png = disc / f"t{i}.png"
        Image.fromarray(img[:, :, ::-1]).save(png)
        recs.append((png, 128, 128, xy))
    index = write_index(disc / "index.txt", recs)
    (disc / "net.prototxt").write_text(
        f'layer {{ name: "data" type: "PoseData" pose_data_param {{ source: "{index}" '
        f'num_classes: {J} scale: 1.0 no_bg_class: true location_refinement: true '
        f'cycle_training_data: true }} }}\n')
    # random_seed seeds the data (1, as the JAX test); the init is SEED's
    sp = SolverParams.from_prototxt(f"""
        net: "{disc / 'net.prototxt'}"
        base_lr: 0.002  momentum: 0.9  lr_policy: "multistep"  gamma: 0.2  stepvalue: 1200
        clip_gradients: 10.0  display: 0  max_iter: 2000  snapshot: 0  test_interval: 450
        random_seed: 1  snapshot_prefix: "{disc}/p"
    """)
    tcfg, stats, source, _ = pose_data(sp)
    cfg = DeeperCutConfig(depths=(1, 1, 1, 1), stage_widths=(8, 8, 16, 16), num_joints=J,
                          pairwise=False, compute_dtype=torch.float32)
    held_out = [{"image": img, "gt_xy": xy, "head_size": 25.0} for img, xy in disc_frames(8, 99)]
    scores = []

    def eval_fn(params, it):
        est = PoseEstimator(params, cfg, folded=False, bucket_step=32, device=device)
        scores.append(pckh(est, held_out))
        return f"PCKh@0.5 = {scores[-1][0]:.4f}"

    solver = PoseSolver(sp, cfg, lambda: source.next_batch(4),
                        net_params=init_params(torch.Generator().manual_seed(SEED), cfg),
                        eval_fn=eval_fn, target_cfg=tcfg, target_stats=stats, device=device)
    before = cuda_decode.launches
    t0 = time.perf_counter()
    try:
        solver.step(1801)                    # evals before iterations 0, 450, ..., 1800
    finally:
        source.close()
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    (m0, _), (m1, per_joint) = scores[0], scores[-1]
    log(f"T3 disc task, tiny model, 1800 steps of batch 4 on {device} in {secs:.1f} s: held-out "
        f"PCKh@0.5 {' -> '.join(f'{m:.4f}' for m, _ in scores)} every 450 iterations; "
        f"joints at >= 0.5: {int((per_joint >= 0.5).sum())}/{J}; decode kernel launches "
        f"{cuda_decode.launches - before}")
    if m1 < PCKH_MIN or m1 <= m0 + PCKH_GAIN or (per_joint >= 0.5).sum() < J - 2:
        raise AssertionError(f"PCKh {m0} -> {m1}: the model did not learn")
    if device != "cuda":
        return
    if cuda_decode.launches <= before:
        raise AssertionError("the eval hook's estimator did not launch the decode kernel")

    est = get_estimator(model_bin=str(snapshot_model), device="cuda")
    pose = est.estimate_pose(frame(np.random.RandomState(SEED), 480, 640))
    if pose is None or pose.shape != (5, J) or not np.isfinite(pose).all():
        raise AssertionError(f"estimator from {snapshot_model.name}: bad pose {pose}")
    log(f"T3 estimator from {snapshot_model.name}: finite (5, 14) pose")


def phase_train(rng):
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = Path(tmp)
        solver, snapshot_model = phase_train_cli(root, rng)
        phase_train_grads(solver)
        phase_train_learns(root, snapshot_model)


# -- G. the graph engine -------------------------------------------------------
CAFFENET = ROOT / "examples/imagenet/caffenet_deploy.prototxt"
IMAGENET_MEAN_BGR = np.array([104.0, 117.0, 123.0], np.float32)
# Classifier.predict in f32 (TF32 off) against the bf16 serving forward of the
# same crops and weights (prob averaged over the 10 crops): 8 bf16 layers
# over 227x227 crops, softmax over 8 classes; held within 0.02.
CAFFENET_BF16_PROB_TOL = 0.02
# The graph's bf16 heads' maps against the native DeeperCut bf16 forward of the
# same weights (both folded on the device: the card's rsqrt differs from the
# host's in the last bit, and a folded weight's bf16 rounding with it).
# Without fuse_siblings the graph runs the native trunk's convolutions on the
# same values (the fold formula gives the same f32 values for its bias-free
# convs), so its trunk is bit-equal; its heads run one deconv and one skip
# conv per head where the native forward runs one of each for all heads
# (42 channels), which cuDNN may sum in another order: a term moves by one
# bf16 step of its own magnitude and the rounded sum by one more, so each
# element is held within 2 steps at the larger magnitude of itself and its
# two terms (an element whose terms cancel would read many steps of its own
# magnitude), and within one step at the map's largest magnitude. Read on
# the card (NVIDIA H100 80GB HBM3, 700.00 W): fc_pose bit-equal, loc_pred
# 0.0019% of elements apart, by 2 such steps, 0.125 at the map's scale.
# fuse_siblings merges each stage's first branch1 and branch2a into one conv
# of another width, whose f32 sums run in another order too; a bf16 rounding
# that moves there propagates through up to 36 later blocks, so the fused
# graph is held in steps at each map's largest magnitude: read on the card,
# 1 (fc_pose) and 2 (loc_pred), 5% of elements apart. Held to 4.
FUSED_MAX_STEPS = 4
# The graph's f32 forward() against the native f32 forward (TF32 off) of the
# same weights: the same f32 convolutions, but the graph applies BatchNorm
# and Scale as two layers where the native forward folds them into one
# affine, a few f32 roundings per conv over 155 convs. Read on the card
# (NVIDIA H100 80GB HBM3, 700.00 W): 2.1e-6 of the maps' largest magnitude;
# held within 1e-4.
GRAPH_F32_RTOL = 1e-4


def tame_caffenet(net, gen) -> None:
    """Seeded fan-in-scaled Gaussians over a graph net's conv and
    InnerProduct weights (He's scale for the ReLU layers, fc8 at a tenth so
    the softmax does not saturate) and small biases, in place."""
    for name, entry in net.params.items():
        for k, v in entry.items():
            if k == "w":
                fan_in = v[0].numel()
                std = (2.0 / fan_in) ** 0.5 * (0.1 if name == "fc8" else 1.0)
                entry[k] = (torch.randn(v.shape, generator=gen) * std).to(v.device)
            else:
                entry[k] = (torch.randn(v.shape, generator=gen) * 0.1).to(v.device)


def _bf16_step(v: float) -> float:
    """One bf16 step (unit in the last place) at magnitude v."""
    return 2.0 ** (math.floor(math.log2(max(v, 2.0 ** -126))) - 7)


def _steps_bf16(got: torch.Tensor, want: torch.Tensor, *terms: torch.Tensor) -> float:
    """Largest |got - want| in bf16 steps at each element's magnitude, or at
    the larger magnitude of the `terms` the element is the rounded sum of
    (a sum that cancels carries its terms' roundings at their scale)."""
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs())
    for t in terms:
        mag = torch.maximum(mag, t.double().abs())
    mag = mag.clamp_min(2.0 ** -126)
    return float(((got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def phase_graph_caffenet(root: Path, rng, device: str = "cuda") -> dict:
    """G1: CaffeNet at full width (examples/imagenet/caffenet_deploy.prototxt,
    batch 10 of 227x227, 8 classes) from a seeded .caffemodel: the
    Classifier's 10-crop predictions, against the bf16 serving forward and
    through compat.Net.forward_all, then `cli time` and `cli test`."""
    from deepcut_tpu_torch import compat
    from deepcut_tpu_torch.classifier import Classifier
    from deepcut_tpu_torch.core.graph import Net

    weights = root / "caffenet_tamed.caffemodel"
    writer = compat.Net(str(CAFFENET), compat.TEST, device=device)
    tame_caffenet(writer._net, torch.Generator().manual_seed(SEED))
    writer.save(str(weights))
    del writer
    kw = dict(image_dims=(256, 256), raw_scale=255, channel_swap=(2, 1, 0),
              mean=IMAGENET_MEAN_BGR)
    cls = Classifier(str(CAFFENET), str(weights), device=device, **kw)
    frames = [rng.rand(480, 640, 3).astype(np.float32), rng.rand(300, 400, 3).astype(np.float32)]
    pred = cls.predict(frames)
    if pred.shape != (2, 8) or not np.isfinite(pred).all() or np.abs(pred.sum(1) - 1).max() > 1e-4:
        raise AssertionError(f"Classifier.predict: {pred}")
    in_ = cls.inputs[0]
    crops = dio_oversample(cls, frames)
    data = np.stack([cls.transformer.preprocess(in_, c) for c in crops])
    again = compat.Net(str(CAFFENET), str(weights), compat.TEST, device=device)
    fa = again.forward_all(data=data)["prob"].reshape(2, 10, -1).mean(1)
    d_fa = float(np.abs(fa - pred).max())
    serve = Net(str(CAFFENET), weights=str(weights), device=device)
    serve.fold_bn()
    serve.prune(["prob"])
    serve.fuse_siblings()
    serve.cast_weights()
    fwd = serve.make_forward(["prob"])
    x = torch.from_numpy(data).to(device)
    p16 = torch.cat([fwd(serve.params, {"data": x[i:i + 10]})["prob"] for i in (0, 10)])
    p16 = p16.cpu().numpy().reshape(2, 10, -1).mean(1)
    d16 = float(np.abs(p16 - pred).max())
    log(f"G1 CaffeNet Classifier.predict, 2 frames x 10 crops (f32, TF32 off): (2, 8), rows sum "
        f"to 1, top classes {pred.argmax(1).tolist()} (max p {pred.max():.4f}); compat.Net."
        f"forward_all max |dp| {d_fa:.3g}; bf16 make_forward max |dp| {d16:.4g} (held to "
        f"{CAFFENET_BF16_PROB_TOL}), top classes {p16.argmax(1).tolist()}")
    if d_fa > 1e-6 or d16 > CAFFENET_BF16_PROB_TOL:
        raise AssertionError("CaffeNet: forward_all or the bf16 forward off the Classifier's")
    out, _ = run_verb(["time", "-model", str(CAFFENET), "-iterations", "20", "-device", device])
    if "Average forward (make_forward)" not in out:
        raise AssertionError(f"cli time: {out}")
    out, _ = run_verb(["test", "-model", str(CAFFENET), "-weights", str(weights),
                       "-iterations", "2", "-device", device])
    if "prob = 0.125000" not in out:   # the mean of an 8-way softmax
        raise AssertionError(f"cli test: {out}")
    return {"classifier": cls, "frames": frames, "serve": serve, "fwd": fwd, "x10": x[:10]}


def dio_oversample(cls, frames):
    """The Classifier's own crops: resized to image_dims, 10 per frame."""
    from deepcut_tpu_torch import io as dio

    return dio.oversample([dio.resize_image(im, cls.image_dims) for im in frames],
                          tuple(cls.crop_dims))


def run_verb(argv):
    """`cli.main(argv)` with its output shown and returned."""
    from deepcut_tpu_torch.tools import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv} returned {rc}")
    return buf.getvalue(), rc


def _serving_graph(proto: Path, weights: Path, device: str, heads, *, fuse: bool):
    """The serving chain over the prototxt and .caffemodel: fold_bn ->
    prune(heads) -> [fuse_siblings] -> cast_weights; -> (net, counts)."""
    from deepcut_tpu_torch.core.graph import Net

    net = Net(str(proto), weights=str(weights), device=device)
    counts = (len(net._plan), net.fold_bn(), net.prune(heads), net.fuse_siblings() if fuse else 0)
    net.cast_weights()
    return net, counts


HEAD_TERMS = {"fc_pose": ("res3d_pose", "res5c_up_pose_crop"),
              "loc_pred": ("res3d_locref", "res5c_up_locref_crop")}


def _against_native(what: str, got: dict, want: dict, *, element_steps=None, map_steps=None) -> None:
    """The graph's heads' maps against the native forward's: in bf16 steps
    per element (at the larger magnitude of the element and of its two
    terms, the skip conv's and the cropped deconv's outputs), or at each
    map's largest magnitude."""
    for k in ("fc_pose", "loc_pred"):
        d = float((got[k] - want[k]).abs().max())
        top = float(want[k].abs().max())
        per_element = _steps_bf16(got[k], want[k], *(got[t] for t in HEAD_TERMS[k]))
        per_map = d / _bf16_step(top)
        held = ", ".join(f"{what_} held to {n}" for what_, n in (
            ("per element", element_steps), ("at the map's largest magnitude", map_steps))
            if n is not None)
        log(f"G2 {what} {k} against native DeeperCut bf16: "
            f"{float((got[k] != want[k]).float().mean()):.6f} of elements differ; max |d| {d:.4g}, "
            f"{per_element:.3g} bf16 steps per element, {per_map:.3g} at the map's largest "
            f"magnitude {top:.4g} ({held})")
        if (element_steps is not None and not per_element <= element_steps) or (
                map_steps is not None and not per_map <= map_steps):
            raise AssertionError(f"G2: {what} {k} outside the tolerance")


def phase_graph_serving(g: dict, device: str = "cuda") -> dict:
    """G2: the serving chain without and with fuse_siblings against the
    native DeeperCut bf16 forward of the same weights on one frame."""
    from deepcut_tpu_torch.models.resnet import fold_bn

    cfg, x, heads = g["cfg"], g["x"], g["heads"]
    # folded on the device, as the graph folds: the card's rsqrt may differ
    # from the host's in the last bit, and a folded weight's bf16 rounding
    # with it
    on_device = {n: {k: v.to(device) for k, v in e.items()} for n, e in g["params"].items()}
    native = DeeperCut(fold_bn(on_device, cfg), cfg).to(device, memory_format=g["cl"])
    with torch.inference_mode():
        want = native(x.contiguous(memory_format=g["cl"]), heads=("pose", "locref"))
    del native
    plain, counts = _serving_graph(g["proto"], g["weights"], device, heads, fuse=False)
    got = plain.make_forward(heads + [t for pair in HEAD_TERMS.values() for t in pair])(
        plain.params, {"data": x})
    log(f"G2 ResNet-{g['depth']} prototxt ({g['proto'].name}, {counts[0]} layers, "
        f"{g['canvas']}x{g['canvas']}): fold_bn folded {counts[1]}, prune removed {counts[2]}")
    _against_native("graph bf16 (no fuse_siblings)", got, want, element_steps=2, map_steps=1)
    del plain, got
    net, counts = _serving_graph(g["proto"], g["weights"], device, heads, fuse=True)
    fwd = net.make_forward(heads)
    got = net.make_forward(heads + [t for pair in HEAD_TERMS.values() for t in pair])(
        net.params, {"data": x})
    log(f"G2 fuse_siblings fused {counts[3]} groups; {len(net._plan)} layers serve")
    _against_native("graph bf16", got, want, map_steps=FUSED_MAX_STEPS)
    return {"net": net, "fwd152": fwd, "prob16": got["prob"]}


def phase_graph_f32(g: dict, device: str = "cuda") -> None:
    """G2, f32: the pycaffe forward() of every blob against the native f32
    forward (TF32 off) of the same weights."""
    from deepcut_tpu_torch.core.graph import Net

    cfg, x = g["cfg"], g["x"]
    net32 = Net(str(g["proto"]), weights=str(g["weights"]), compute_dtype=None, device=device)
    blobs = net32.forward(data=x.cpu().numpy())
    native32 = DeeperCut(g["params"], dataclasses.replace(cfg, compute_dtype=torch.float32),
                         folded=False).to(device, memory_format=g["cl"])
    with torch.inference_mode():
        want32 = native32(x.contiguous(memory_format=g["cl"]), heads=("pose", "locref"))
    for k in ("fc_pose", "loc_pred", "prob"):
        ref = want32[k].cpu().numpy()
        rel = float(np.abs(blobs[k] - ref).max() / np.abs(ref).max())
        log(f"G2 graph f32 forward() {k} against native f32 (TF32 off): max |d| / max |ref| "
            f"{rel:.3g} (held to {GRAPH_F32_RTOL}); forward() returned {len(blobs)} blobs")
        if not rel <= GRAPH_F32_RTOL:
            raise AssertionError(f"G2: f32 {k} off the native f32 forward")


def phase_graph_int8(g: dict, prob16: torch.Tensor, device: str = "cuda") -> None:
    """G3: Net.quantize_int8 on G2's graph, calibrated on G2's frame,
    against the bf16 graph's prob, in the int8 envelope."""
    from deepcut_tpu_torch.core.graph import Net
    from deepcut_tpu_torch.ops import int8_conv

    heads, x = g["heads"], g["x"]
    q = Net(str(g["proto"]), weights=str(g["weights"]), device=device)
    q.fold_bn()
    q.prune(heads)
    q.fuse_siblings()
    before = (int8_conv.quantize_launches, int8_conv.im2col_launches, int8_conv.epilogue_launches)
    t0 = time.perf_counter()
    n_q = q.quantize_int8(data=x.cpu().numpy())
    q.cast_weights()
    prob8 = q.make_forward(heads)(q.params, {"data": x})["prob"]
    secs = time.perf_counter() - t0
    flips = float(((prob8 - prob16).abs() > INT8_FLIP).float().mean())
    after = (int8_conv.quantize_launches, int8_conv.im2col_launches, int8_conv.epilogue_launches)
    log(f"G3 Net.quantize_int8 on one {g['canvas']}x{g['canvas']} frame: {n_q} int8 convs, "
        f"calibration and first forward {secs:.2f} s; prob |d| > {INT8_FLIP} against bf16 on "
        f"{flips:.4f} of cells (held below {INT8_MAX_FLIPS}), max |dprob| "
        f"{float((prob8 - prob16).abs().max()):.4g}; int8 launches (quantize, im2col, epilogue): "
        f"{tuple(b - a for a, b in zip(before, after))}")
    if not math.isfinite(flips) or flips >= INT8_MAX_FLIPS:
        raise AssertionError("G3: the int8 graph outside the int8 envelope")
    if device == "cuda" and not all(b > a for a, b in zip(before, after)):
        raise AssertionError("G3: the int8 graph did not launch every int8 kernel")


def graph_resnet_inputs(root: Path, rng, device: str = "cuda", depth: int = 152,
                        canvas: int = 688) -> dict:
    """The DeeperCut ResNet as a deploy prototxt written with the port's
    net_spec, phase 4's tamed weights as a .caffemodel, and one frame."""
    from deepcut_tpu_torch.models.convert import save_caffemodel
    from deepcut_tpu_torch.models.prototxt import deepercut_deploy

    cfg = deepercut_config(depth)
    params = tame_params(cfg)
    proto = root / f"resnet{depth}_deploy.prototxt"
    proto.write_text(deepercut_deploy(cfg, (1, 3, canvas, canvas)).to_proto_text() + "\n")
    weights = root / f"resnet{depth}_tamed.caffemodel"
    save_caffemodel(str(weights), params)
    f = frame(rng, canvas, canvas)
    x = (torch.from_numpy(f).float().permute(2, 0, 1)[None]
         - torch.tensor(MEAN_BGR_T).reshape(1, 3, 1, 1)).contiguous().to(device)
    # the card's serving layout (the graph's stream is channels_last there)
    cl = torch.channels_last if device == "cuda" else torch.contiguous_format
    return {"cfg": cfg, "params": params, "proto": proto, "weights": weights, "x": x, "cl": cl,
            "depth": depth, "canvas": canvas, "heads": ["fc_pose", "loc_pred", "prob"]}


def phase_graph(rng, device: str = "cuda", depth: int = 152, canvas: int = 688) -> dict:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
        root = Path(tmp)
        state = phase_graph_caffenet(root, rng, device)
        g = graph_resnet_inputs(root, rng, device, depth, canvas)
        served = phase_graph_serving(g, device)
        phase_graph_f32(g, device)
        phase_graph_int8(g, served.pop("prob16"), device)
        state.update(served, params=g["params"], cfg=g["cfg"], canvas=canvas)
    return state


# -- 6. times ----------------------------------------------------------------
def _events_ms(fn, iters: int, warmup: int = 3, before=None) -> float:
    """CUDA-event ms per call of `fn`: the calls back to back, or, with
    `before` (an L2 flush), each call alone between its own two events,
    `before` running ahead of it outside them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if before is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


# Readings of torch.profiler that fail a check (a kernel under its byte
# bound or not recorded; a forward's busy time off its graph device time),
# listed again before the result lines; none enters PERF.md's tables.
PROFILER_FLAGS = []
# Graph device time minus the profiler's busy time, per kernel: the idle
# gap between two kernels of a replayed CUDA graph (read on the card: 0.3-0.4
# us for the native forward). More than this means the profiler missed
# device time.
GRAPH_GAP_US = 4.0
# The other way: kernels of an eager run that leaves the card idle most of
# the time read slower than in a graph's replay, which keeps it busy (read
# on the card: the graph engine's forwards, idle share 0.6-0.9, 1.7-7%
# under the profiler's busy). A busy time more than this share above the
# graph's is flagged.
GRAPH_BUSY_OVER = 0.10


def _graph_device_ms(fn, replays: int = 5):
    """The device time of one call of `fn` with no host gaps, measured
    without the profiler: `fn` captured once into a CUDA graph, whose
    replays run its kernels back to back between two CUDA events (the gaps
    between kernels included). None when `fn` cannot be captured (it
    synchronizes with the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # capture wants a warm-up on a side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as e:
        log(f"CUDA graph capture failed: {str(e).splitlines()[0][:200]}")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    torch.cuda.empty_cache()        # the graph's private memory pool
    return start.elapsed_time(end) / replays


def _device_profile(fn, steps: int, top: int = 0):
    """(device ms, device ops, the `top` kernels by device ms) per call of
    `fn`, from torch.profiler's per-kernel self device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()  # no earlier work inside the window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1000.0
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    return (busy / steps, sum(e.count for e in events) / steps,
            [(e.key, e.self_device_time_total / 1000.0 / steps, e.count / steps) for e in ranked])


def serving_times(est, rng, card: str, label: str = "bf16") -> None:
    """The serving forward and estimate_pose_batch on 688x688 frames at
    batch 1 and 4: CUDA-event wall time, device busy time and kernels per
    call from torch.profiler, the idle share, and where the device time
    goes. Uses only what the package had before the epilogue kernel (see
    --serving-times)."""
    for bs in (1, 4):
        frames = [frame(rng, 688, 688) for _ in range(bs)]
        x = torch.zeros((bs, 3, 688, 688), device="cuda").to(memory_format=torch.channels_last)

        def forward():
            with torch.inference_mode():
                est.model(x, heads=("pose", "locref"))

        for what, fn in (("forward only, 688x688 canvas", forward),
                         ("estimate_pose_batch 688x688 frames (canvas bucket 704)",
                          lambda: est.estimate_pose_batch(frames))):
            ms = _events_ms(fn, iters=20)
            busy, ops, ranked = _device_profile(fn, steps=10, top=6)
            log(f"time [{card}]: {what}, {label}, pose+locref, batch {bs}: {ms:.3f} ms/call, "
                f"{bs * 1000 / ms:.2f} img/s; device busy {busy:.3f} ms (profiler; idle share "
                f"{1 - busy / ms:.3f}), {ops:.0f} device kernels per call (with the bias rounded twice, the "
                f"bf16 forward: {BIAS_TWICE_KERNELS_PER_CALL[bs]})"
                + (_graph_check(f"{label} {what}, batch {bs}", busy, ops, fn)
                   if fn is forward else ""))
            log(f"profile [{card}]: {what}, {label}, batch {bs}, top kernels (ms per call, launches): "
                + "; ".join(f"{name[:70]} {t:.3f} ms x{n:.0f}" for name, t, n in ranked))


def _bound_ms(nbytes: float) -> float:
    """The least time to move `nbytes` at the H100's 3.35 TB/s."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_times(card: str) -> dict:
    """Each kernel at the main path's shapes (704 canvas, batch 4) beside its
    plain version, its bound and, where one exists, a single PyTorch call
    computing the same function; the decode's probability-map entry in the
    same call."""
    from deepcut_tpu_torch.ops import conv_epilogue

    rng = np.random.RandomState(SEED + 3)
    n, h, w = 4, 88, 88
    logits = torch.from_numpy((rng.randn(n, h, w, J) * 3).astype(np.float32)).to(torch.bfloat16).float()
    loc = torch.from_numpy(rng.randn(n, h, w, 2 * J).astype(np.float32))
    fused = torch.cat([logits, loc], -1).cuda().permute(0, 3, 1, 2)
    vh = vw = [h] * n
    prob = torch.sigmoid(fused[:, :J]).contiguous()
    locc = fused[:, J:].contiguous()
    vht = torch.full((n,), h, dtype=torch.int32, device="cuda")
    rows = torch.arange(h, device="cuda").reshape(1, 1, -1, 1)
    masked = torch.where(rows < vht.reshape(-1, 1, 1, 1), prob, float("-inf"))
    out = {}
    it = 500
    t = {"fused": _events_ms(lambda: cuda_decode.decode_fused(fused, J, vh, vw), it),
         "fused_plain": _events_ms(lambda: cuda_decode.decode_fused_plain(fused, J, vh, vw), it),
         "prob": _events_ms(lambda: cuda_decode.decode_pose(prob, locc, vht, vht), it),
         "prob_plain": _events_ms(lambda: decode_pose_batch(prob, locc, valid_hw=(vht, vht)), it),
         "library": _events_ms(lambda: torch.max(masked.flatten(2), 2), it)}
    cells = n * J * h * w
    out["decode_pose"] = dict(ms=t["fused"], plain_ms=t["fused_plain"], library_ms=t["library"],
                              bound_ms=_bound_ms(cells * 4 + n * J * 2 * 4 + n * 5 * J * 4))
    out["decode_pose_prob"] = dict(ms=t["prob"], plain_ms=t["prob_plain"], library_ms=t["library"],
                                   bound_ms=_bound_ms(cells * 4 + n * J * 2 * 4 + 2 * n * 4
                                                      + n * 5 * J * 4))
    dev = {k: _kernel_device_us(name, fn, 50, out[name]["bound_ms"]) for k, name, fn in (
        ("fused", "decode_pose", lambda: cuda_decode.decode_fused(fused, J, vh, vw)),
        ("prob", "decode_pose_prob", lambda: cuda_decode.decode_pose(prob, locc, vht, vht)))}
    for key, name in (("fused", "decode fused entry (redesigned)"), ("prob", "decode prob entry")):
        log(f"time [{card}]: {name} at {(n, 3 * J if key == 'fused' else J, h, w)}: "
            f"{t[key] * 1000:.2f} us per call (CUDA events over {it} calls), device time "
            f"{dev[key]}, plain PyTorch {t[key + '_plain'] * 1000:.2f} us, "
            f"torch.max over masked prob {t['library'] * 1000:.2f} us, bound "
            f"{out['decode_pose' if key == 'fused' else 'decode_pose_prob']['bound_ms'] * 1000:.3f} us")

    shape = (4, 512, 88, 88)                  # a res3 block end: residual and ReLU
    y, bias, res = _epilogue_case(rng, shape, True)
    ms = _events_ms(lambda: conv_epilogue.conv_epilogue(y, bias, res, True), 200)
    plain_ms = _events_ms(lambda: conv_epilogue.conv_epilogue_plain(y, bias, res, True), 50)
    numel = y.numel()
    out["conv_epilogue"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                bound_ms=_bound_ms(numel * 4 * 3 + shape[1] * 4))
    dev = _kernel_device_us("conv_epilogue", lambda: conv_epilogue.conv_epilogue(y, bias, res, True),
                            50, out["conv_epilogue"]["bound_ms"])
    log(f"time [{card}]: conv_epilogue at {shape} with residual and ReLU: {ms * 1000:.2f} us per "
        f"call, device time {dev}, plain PyTorch "
        f"{plain_ms * 1000:.2f} us, bound {out['conv_epilogue']['bound_ms'] * 1000:.2f} us "
        f"(reads y and the residual, writes y)")
    return out


def _kernel_device_us(name: str, fn, steps: int, bound_ms: float, match: str = "") -> str:
    """The device time per call of `fn`'s longest kernel (or its kernel
    whose name holds `match`) from the profiler, as text, held against the
    kernel's byte bound: a reading under the bound, or a kernel the
    profiler did not record, is flagged (PROFILER_FLAGS) and rejected."""
    _, _, ranked = _device_profile(fn, steps=steps, top=64)
    hits = [(k, t) for k, t, _ in ranked if match in k]
    if not hits:
        PROFILER_FLAGS.append(f"{name}: kernel not recorded by the profiler")
        return "not recorded by the profiler (flagged)"
    kname, dev_ms = hits[0]
    text = f"{dev_ms * 1000:.2f} us ({kname[:40]})"
    if dev_ms < bound_ms:
        PROFILER_FLAGS.append(f"{name}: profiler device time {dev_ms * 1000:.2f} us under its "
                              f"byte bound {bound_ms * 1000:.2f} us")
        return text + " UNDER ITS BYTE BOUND (flagged, rejected)"
    return text


def _timed(card: str, name: str, fn, plain, bound_ms: float, iters: int = 200,
           before=None, match: str = "") -> dict:
    """A kernel's wrapper per call (CUDA events), its device time
    (profiler; its kernel's name holds `match`) and its plain version's
    time, logged beside its bound; `before` (an L2 flush) runs ahead of
    each call, outside its events."""
    ms = _events_ms(fn, iters, before=before)
    plain_ms = _events_ms(plain, max(iters // 10, 5), before=before)
    dev = _kernel_device_us(name, fn if before is None else (lambda: (before(), fn())), 50,
                            bound_ms, match)
    log(f"time [{card}]: {name}: {ms * 1000:.2f} us per call, device time {dev}, plain PyTorch "
        f"{plain_ms * 1000:.2f} us, bound {bound_ms * 1000:.2f} us")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=None)


L2_FLUSH_BYTES = 256 * 2**20  # five times the H100's 50 MB L2


def int8_kernel_times(card: str) -> dict:
    """The three int8 kernels at the int8 forward's shapes (704 canvas,
    batch 4), and torch._int_mm per GEMM shape against its int8 bound.
    No single PyTorch call computes what a kernel does: F.unfold refuses
    int8 on the card, and the epilogue and quantization (a reciprocal in
    f32, +-127) have no library form."""
    from deepcut_tpu_torch.ops import int8_conv as ic

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    out = {}
    x = _i8(gen, (4, 64, 176, 176))           # res2's 3x3 input
    rows, k = 4 * 176 * 176, 9 * 64
    out["int8_im2col"] = _timed(
        card, "int8_im2col at res2 3x3 (4,64,176,176) -> (123904, 576)",
        lambda: ic.int8_im2col(x, 3, pad=1), lambda: ic.int8_im2col_plain(x, 3, pad=1),
        _bound_ms(x.numel() + rows * k))
    shape = (4, 512, 88, 88)                  # a res3 block end
    acc, scale, bias, res = _i8_epilogue_case(gen, shape, 512, "f32")
    kw = dict(relu=True, requant_s=0.0517)
    n = acc.numel()
    out["int8_epilogue"] = _timed(
        card, f"int8_epilogue at {shape}: bf16 residual, ReLU, f32 out + requantized",
        lambda: ic.int8_epilogue(acc, scale, bias, res, **kw),
        lambda: ic.int8_epilogue_plain(acc, scale, bias, res, **kw),
        _bound_ms(n * 4 + n * 4 + n * 4 + n + shape[1] * 8))
    y = torch.randn((4, 64, 176, 176), generator=gen, device="cuda").contiguous(
        memory_format=torch.channels_last)
    # its 32 MB input would stay in the 50 MB L2 between back-to-back calls
    # and read under the HBM bound: the L2 is flushed before each call
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    out["quantize_i8"] = _timed(
        card, f"quantize_i8 at the stem's output {tuple(y.shape)}, L2 flushed before each call",
        lambda: ic.quantize_i8(y, 0.0371), lambda: ic.quantize_i8_plain(y, 0.0371),
        _bound_ms(y.numel() * 5), iters=50, before=flush.zero_, match="quantize")
    del flush
    for name, m, kk, nn in INT_MM_SHAPES:
        a = torch.randint(-127, 128, (m, kk), generator=gen, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (nn, kk), generator=gen, device="cuda", dtype=torch.int8)
        ms = _events_ms(lambda: torch._int_mm(a, w.t()), 50)
        ops_ms = 2.0 * m * kk * nn / INT8_OPS_PER_S * 1e3
        bytes_ms = _bound_ms(m * kk + kk * nn + m * nn * 4)
        log(f"time [{card}]: torch._int_mm {name} ({m} x {kk}) x ({kk} x {nn}): {ms * 1000:.2f} us, "
            f"bound {max(ops_ms, bytes_ms) * 1000:.2f} us by {'operations' if ops_ms > bytes_ms else 'bytes'}"
            f" ({2.0 * m * kk * nn / ms / 1e9:.1f} TOPS)")
        del a, w
    return out


def phase_times(est, est8, rng, card: str) -> dict:
    serving_times(est, rng, card)
    serving_times(est8, rng, card, label="int8")
    return {**kernel_times(card), **int8_kernel_times(card)}


def _graph_check(what: str, busy: float, ops: float, fn) -> str:
    """The profiler's busy time per call of `fn` held against its CUDA-graph
    device time (`_graph_device_ms`), as text; a disagreement is flagged."""
    dev = _graph_device_ms(fn)
    if dev is None:
        PROFILER_FLAGS.append(f"{what}: no graph device time, the profiler's busy unverified")
        return "; graph device time not measured (flagged: busy unverified)"
    gap_us = (dev - busy) / ops * 1000
    ok = busy <= dev * (1 + GRAPH_BUSY_OVER) and gap_us <= GRAPH_GAP_US
    if not ok:
        PROFILER_FLAGS.append(f"{what}: profiler busy {busy:.3f} ms against graph device time "
                              f"{dev:.3f} ms ({gap_us:.2f} us per kernel)")
    return (f"; device time as a CUDA graph (no profiler, no host gaps) {dev:.3f} ms, "
            f"{gap_us:.2f} us per kernel beyond the profiler's busy"
            + ("" if ok else " (flagged: the profiler's busy disagrees)"))


def _profiled(card: str, what: str, fn, bs: int, iters: int = 20, steps: int = 10,
              top: int = 0, graph: bool = False) -> float:
    """CUDA-event wall time, device busy time, idle share and kernels per
    call of `fn` (and its `top` kernels by device time), and with `graph`
    the busy time held against the CUDA-graph device time, logged; returns
    the wall ms."""
    ms = _events_ms(fn, iters=iters)
    busy, ops, ranked = _device_profile(fn, steps=steps, top=top)
    log(f"time [{card}]: {what}: {ms:.3f} ms/call, {bs * 1000 / ms:.2f} img/s; device busy "
        f"{busy:.3f} ms (profiler; idle share {1 - busy / ms:.3f}), {ops:.0f} device kernels per "
        f"call" + (_graph_check(what, busy, ops, fn) if graph else ""))
    if ranked:
        log(f"profile [{card}]: {what}, top kernels (ms per call, launches): "
            + "; ".join(f"{name[:70]} {t:.3f} ms x{n:.0f}" for name, t, n in ranked))
    return ms


def graph_times(state: dict, rng, card: str) -> None:
    """The graph engine's serving times: CaffeNet's Classifier.predict over 2
    frames (20 crops, f32) and its bf16 make_forward at batch 10; the
    ResNet-152 graph's make_forward at batch 1 and 4 on a 688 canvas beside
    the native DeeperCut bf16 forward of the same weights."""
    from deepcut_tpu_torch.models.resnet import fold_bn

    cls, frames = state["classifier"], state["frames"]
    _profiled(card, "CaffeNet Classifier.predict, 2 frames (20 crops of 227x227), f32 (TF32 off)",
              lambda: cls.predict(frames), 2, iters=5, steps=3)
    serve, fwd, x10 = state["serve"], state["fwd"], state["x10"]
    _profiled(card, "CaffeNet make_forward, bf16, batch 10 of 227x227",
              lambda: fwd(serve.params, {"data": x10}), 10, graph=True)
    net, gfwd, cfg = state["net"], state["fwd152"], state["cfg"]
    native = DeeperCut(fold_bn(state["params"], cfg), cfg).to("cuda", memory_format=torch.channels_last)
    c = state["canvas"]
    for bs in (1, 4):
        x = torch.from_numpy((rng.rand(bs, 3, c, c) * 255 - 117).astype(np.float32)).to("cuda")
        xcl = x.contiguous(memory_format=torch.channels_last)

        def native_fwd():
            with torch.inference_mode():
                native(xcl, heads=("pose", "locref"))

        _profiled(card, f"ResNet-152 graph make_forward (fc_pose, loc_pred, prob), bf16, "
                  f"{c}x{c}, batch {bs}", lambda: gfwd(net.params, {"data": x}), bs, top=8,
                  graph=True)
        _profiled(card, f"ResNet-152 native DeeperCut forward (pose, locref), bf16, {c}x{c}, "
                  f"batch {bs}", native_fwd, bs, top=8, graph=True)
    del native


def phase_train_times(card: str):
    """The full-width train step as the CLI runs it, `PoseSolver.step` (the
    batch to the card, device targets, forward, losses, backward, update),
    over a copy of the published recipe at scale 1 without jitter, so that
    the 688x688 frames fill a 704 canvas. The host batches come from the
    CLI's data source before the clock starts; display is off, as between
    the recipe's display lines."""
    from deepcut_tpu_torch.solver.solver import PoseSolver, SolverParams
    from deepcut_tpu_torch.tools.cli import pose_data

    with tempfile.TemporaryDirectory(prefix="chip_smoke_times_") as tmp:
        root = Path(tmp)
        index = write_frames(root / "frames", np.random.RandomState(SEED), 4, 688, 688)
        sp = SolverParams.from_prototxt(str(write_solver(root, index, "times", 10 ** 6, 0,
                                                         display=0, no_jitter=True)))
        tcfg, stats, src, _ = pose_data(sp)
        try:
            batches = {bs: src.next_batch(bs) for bs in (1, 4)}
        finally:
            src.close()
    feed = {}
    for mixed in (False, True):
        cfg = deepercut_config(152, pairwise=False, mixed_train=mixed)
        solver = PoseSolver(sp, cfg, lambda: feed["batch"], net_params=tame_params(cfg),
                            handle_signals=False, log=lambda *_: None, target_cfg=tcfg,
                            target_stats=stats, device="cuda")
        for bs in (1, 4):
            feed["batch"] = batches[bs]
            torch.cuda.reset_peak_memory_stats()
            ms = _events_ms(lambda: solver.step(1), iters=5, warmup=2)
            log(f"time [{card}]: train step (PoseSolver.step), ResNet-152, 688x688 frames "
                f"(canvas {batches[bs]['image'].shape[1]}), "
                f"{'mixed bf16' if mixed else 'f32 (TF32 off)'}, batch {bs}: {ms:.3f} ms, "
                f"{bs * 1000 / ms:.2f} img/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            busy, ops, _ = _device_profile(lambda: solver.step(1), steps=2)
            log(f"profile [{card}]: that step issues {ops:.0f} device ops; device busy "
                + (f"{busy:.3f} ms of {ms:.3f} ms (idle share {1 - busy / ms:.2f})" if busy
                   else "not measured (the profiler saw no device time)"))
        del solver
        torch.cuda.empty_cache()


KERNELS = {  # name -> (source, what it replaces)
    "conv_epilogue": ("deepcut_tpu_torch/csrc/conv_epilogue.cu",
                      "deepcut_tpu/ops/conv.py:93 (no TPU kernel: XLA fuses this epilogue)"),
    "int8_im2col": ("deepcut_tpu_torch/csrc/int8_conv.cu",
                    "deepcut_tpu/models/quantize.py:67 (no TPU kernel: XLA's int8 conv)"),
    "int8_epilogue": ("deepcut_tpu_torch/csrc/int8_conv.cu",
                      "deepcut_tpu/models/quantize.py:127 (no TPU kernel: XLA fuses it)"),
    "quantize_i8": ("deepcut_tpu_torch/csrc/int8_conv.cu",
                    "deepcut_tpu/models/quantize.py:119 (no TPU kernel: XLA fuses it)"),
    "decode_pose": ("deepcut_tpu_torch/csrc/decode_pose.cu", "deepcut_tpu/ops/pallas_decode.py:63"),
    "decode_pose_prob": ("deepcut_tpu_torch/csrc/decode_pose.cu",
                         "deepcut_tpu/ops/pallas_decode.py:63"),
}


def _counts() -> dict:
    from deepcut_tpu_torch.ops import conv_epilogue, int8_conv

    return {"conv_epilogue": conv_epilogue.launches, "decode_pose": cuda_decode.launches,
            "decode_pose_prob": cuda_decode.prob_launches,
            "int8_im2col": int8_conv.im2col_launches,
            "int8_epilogue": int8_conv.epilogue_launches,
            "quantize_i8": int8_conv.quantize_launches}


def _record_geometries(on: bool):
    """Start recording the kernels' launch geometries, or stop; returns
    what was recorded until then."""
    from deepcut_tpu_torch.ops import conv_epilogue, int8_conv

    recorded = (conv_epilogue.geometries, int8_conv.geometries)
    conv_epilogue.record_geometries(on)
    int8_conv.record_geometries(on)
    return recorded


def _zero_counts() -> None:
    from deepcut_tpu_torch.ops import conv_epilogue, int8_conv

    conv_epilogue.launches = cuda_decode.launches = cuda_decode.prob_launches = 0
    int8_conv.reset_counts()


def main() -> int:
    card = phase_device()
    if sys.argv[1:] == ["--serving-times"]:
        serving_times(PoseEstimator(tame_params(deepercut_config(152)), device="cuda"),
                      np.random.RandomState(SEED), card)
        return 0
    phase_build()
    errs = phase_kernels_vs_plain()
    rng = np.random.RandomState(SEED)
    _record_geometries(True)                     # every main path's launch geometries
    _zero_counts()                               # the serving path starts here
    est = phase_slice(rng)
    phase_server(est, rng)
    serving = _counts()                          # and ends here
    _zero_counts()                               # the int8 serving path starts here
    est8 = phase_int8(est, rng)
    phase_server(PoseEstimator(tame_params(deepercut_config(152)), device="cuda"), rng, int8=True)
    int8 = _counts()                             # and ends here
    _zero_counts()                               # the training path starts here
    phase_train(rng)
    training = _counts()                         # and ends here
    _zero_counts()                               # the graph engine's path starts here
    graph_state = phase_graph(rng)
    graph = _counts()                            # and ends here
    replay_path_geometries(*_record_geometries(False))
    log(f"kernel launches: serving path {serving}, int8 serving path {int8}, "
        f"training path {training}, graph engine path {graph}")
    for path, counts, need in (("serving", serving, ("conv_epilogue", "decode_pose",
                                                     "decode_pose_prob")),
                               ("int8 serving", int8, KERNELS),
                               ("training", training, ("conv_epilogue", "decode_pose")),
                               ("graph engine", graph, ("conv_epilogue", "quantize_i8",
                                                        "int8_im2col", "int8_epilogue"))):
        idle = [k for k in need if counts[k] == 0]
        if idle:
            raise AssertionError(f"the {path} path never launched {idle}")
    times = phase_times(est, est8, rng, card)
    del est, est8
    graph_times(graph_state, rng, card)
    del graph_state
    phase_train_times(card)
    log(f"profiler checks: {len(PROFILER_FLAGS)} readings flagged"
        + "".join(f"\n  flagged: {f}" for f in PROFILER_FLAGS))
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": serving[name] + int8[name] + training[name] + graph[name],
         "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"], "bound_by": "bytes",
         "library_ms": times[name]["library_ms"]}
        for name, (src, rep) in KERNELS.items()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
