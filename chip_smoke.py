#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`deepcut_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --serving-times  # phase 1 and the serving times only
    python3 chip_smoke.py --pose-graphs    # phases 1, 2 and P only

Drives the port's ten paths (bf16 serving, int8 serving, training, the
Caffe graph engine's serving, its data slice, the examples' front ends,
MatCaffe with data-parallel training, the spatial axis, the engine's
training, and the functional forward `models.resnet.make_forward` into the
fused decode) at full width through their entry points, in phases; any
failure raises and the exit code is non-zero. Each phase's seconds are
logged, and summed per phase before the result lines:

1. the card: nvidia-smi's name and power limit, torch / CUDA versions;
2. build the native libraries through the command users run to build
   ahead, `python -m deepcut_tpu_torch.runtime.build` (one compiler process
   per source, all started together): the rasterizer (g++), the decode
   (csrc/decode_pose.cu), the serving conv's epilogue
   (csrc/conv_epilogue.cu) and the int8 conv's pieces (csrc/int8_conv.cu:
   im2col, epilogue, quantize), with nvcc;
3. each kernel against its plain PyTorch version on the card: the decode's
   fused entry and its probability-map entry (argmax and pose bit for bit,
   on ties, all-equal, bf16-valued and NaN maps; the prob entry also at the
   shapes its paths launch and on their strided views: row-cropped,
   channel-sliced, rows outermost, loc in wider rows), the epilogue bit for bit
   (random, residual, strided residual), the int8 im2col, epilogue (each
   mode of the int8 forward) and quantization (+-127, .5 ties) bit for bit,
   and the route im2col + torch._int_mm equal to an exact f64 convolution's
   int32 accumulator; and cuDNN's TF32 convolution exact on bf16-valued
   operands (allowed against not allowed, 1e-5 relative);
4. the serving slice (random weights from a seeded generator, tamed):
   estimate_pose, estimate_pose_batch, bf16 against f32 scoremaps, an HD
   frame on the tiled path and estimate_pose_avg over a 688 frame at
   PYRAMID_SCALES, each decoded by one launch of the probability-map entry
   bit-equal to the plain version on the path's own maps;
5. the port's pose service (`deepcut_tpu_torch.examples.pose.serve`)
   serving the port's estimator: three concurrent HTTP requests of mixed
   sizes, one of them HD;
Q. int8 serving: quantize_int8 on a 480x640 frame, estimate_pose and
   estimate_pose_batch, int8 against bf16 scoremaps, an HD frame on the
   tiled path, an int8_deconv=True estimator, forward_int8's int8_residual
   within the int8 envelope; then the service's --int8 on a fresh estimator
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
   tests/test_pose_training_e2e.py on the card (T3_STEPS steps, data through
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
   `Net.quantize_int8` on G2's graph in the int8 envelope; G1 also runs
   `Detector.detect_windows` over 10 windows against `compat.Net.forward`
   of its crops;
D. the data slice, CaffeNet at BVLC's widths through its data layers
   (examples/imagenet/caffenet_train_val.prototxt, batch 256 TRAIN and 50
   TEST, crop 227, TRAIN mirrored, fc8 at 1000): D1 seeded 256x256 PNG
   frames (256 train, 100 val, 8 colour classes) through the port's
   `tools.datasets`: convert_imageset to an LMDB (train) and a LevelDB
   (val), compute_image_mean; D2 `cli train` 20 iterations from the LMDB,
   a test pass from the LevelDB every 10, snapshots at 10 and 20 (.npz,
   .caffemodel, .solverstate), its log read back by `tools.parse_log`; D3
   the iteration-10 .solverstate's history bit-equal to the momentum the
   solver held, then `cli train -snapshot` on it resumes at 10 with the
   .caffemodel's weights and finishes; D4 `cli test` from the LevelDB in
   bf16 (conv_epilogue) and -fp32, the losses within DATA_TEST_LOSS_STEPS
   bf16 steps; D5 ImageData (the train list, shuffled, resized to 256) and
   WindowData (R-CNN's batch 128, fc8_pascal at 21) each feed two
   `GraphSolver` steps, their tops checked on the card, and a PoseData
   layer's tops bit-equal to `PoseDataSource` called with the same seed;
   D6 `extract_features` to .h5, an HDF5Output net and `snapshot_format:
   HDF5` where h5py imports, or each raising ImportError naming h5py;
E. the graph engine's training, f32 with TF32 off: E(a) CaffeNet at BVLC's
   widths (examples/imagenet/caffenet_train_val.prototxt with MemoryData in
   place of its Data layers, batch 256, fc8 of 1000) trained 50 steps on
   colour-class frames through `compat.get_solver` and `set_input_arrays`
   with caffenet_solver.prototxt's SGD recipe at a tenth of its rate, its
   loss falling and a test pass classifying 90% of 500 frames, Dropout's
   keep rate on the card; E(b) the ResNet-152 prototxt with the heads'
   losses through `GraphSolver`
   against one `PoseSolver.step` on the same weights and host batch (the
   loss, conv1's and the heads' updates and weights); both timed;
X. the examples' front ends (`deepcut_tpu_torch.examples`), each started as
   a user starts it: X1 the pose service through its default path
   (`PoseApp(model_bin=...)`: `get_estimator` loads phase 4's tamed
   ResNet-152 from a .caffemodel), in bf16 and with --int8 (a private copy
   calibrated on the first request): four concurrent first requests,
   EXAMPLE_REQUESTS sequential 688x688 requests (request latency, median and
   90th percentile, beside `estimate_pose`'s wall time on the same frames)
   and a 720x1280 one (the tiled path), each pose equal to `estimate_pose`'s
   after the JSON rounding; then --batch-window 4 and two bursts of
   EXAMPLE_BURST concurrent requests (img/s, `batches_run` / `images_run`);
   X2 the web demo on G1's CaffeNet weights, its top-5 against
   `Classifier.predict`; X3 `python -m ...classification` and
   `...detection` as two processes, their classes against the Classifier's
   and Detector's in this process; X4 `net_surgery`; X5 the mnist maker to
   the LMDB examples/mnist/lenet_train.prototxt names, then `cli train` on
   lenet_solver.prototxt cut to LENET_ITERATIONS iterations, its loss
   falling;
M. MatCaffe and data-parallel training: M1 the reference's matcaffe
   scenarios (test_net, test_solver, test_io) through
   `matlab_gateway.dispatch` on the card (set_mode_gpu) and on the CPU, the
   weights carried by .caffemodel, compared within f32 tolerances, then the
   port's MEX (deepcut_tpu_torch/matlab/caffe_.cpp, g++ against the
   repository's mex stub) through ctypes in a subprocess where Python.h and
   a shared libpython exist (else the phase says why it did not run); M2
   `parallel.distributed.initialize` on localhost (NCCL, a world of one) and
   PoseSolver with mesh=make_mesh(1) at ResNet-50's (M2_DEPTH) full width on the 704
   canvas, f32, bit-equal to mesh=None over 3 steps, its eval hook decoding
   through the port's estimator; M3 two spawned ranks on the one card over
   gloo (CUDA tensors) against one process on the global batch: GraphSolver
   on BVLC's CaffeNet (E(a)'s MemoryData net, Dropout on) at batch 256 for 5
   steps, PoseSolver at full width on 2 frames for 3 steps, the losses and
   conv1's and the heads' weights within the stated tolerances; each step
   timed (one card: not a scaling measurement);
S. the spatial axis: two spawned ranks on the one card over gloo (CUDA
   tensors through the host), a (data=1, spatial=2) mesh, against one
   process: S1 PoseSolver at ResNet-152's full width on the 704 canvas, f32
   (TF32 off), 3 steps with the eval hook at iteration 0 (the losses and
   conv1's, res5c's and the heads' weights), and one -mixed_precision step;
   S2 E(b)'s ResNet-152 prototxt with the heads' losses through
   GraphSolver, the split logged (the trunk sharded up to the heads), its
   first step compared; S3 PoseEstimator(mesh=) in bf16 on a 1088x1920
   multi-person frame and a 688x688 one (43 rows at res4 / res5 over two
   ranks) against one process, the strict local maxima against one process
   and the tiled path, the pose through the decode's probability-map entry,
   and int8 (calibrated on a 480x640 frame) on the HD frame; each rank
   replays its new launch geometries (conv_epilogue at row-sharded shapes,
   int8_im2col with pad_h != pad_w) against the plain kernels; every step
   and scoremaps call timed beside one process's (not a scaling figure);
6a. `models.resnet.make_forward(cfg, folded=True, heads=("pose", "locref"))`
   on phase 4's tamed ResNet-152, folded and cast as a user does, on a
   688x688 frame's 704 canvas in bf16: its maps bit-equal to
   `PoseEstimator`'s forward of the canvas, and through the decode's fused
   entry the pose bit-equal to `estimate_pose`'s;
P. the estimator's CUDA graphs (`pose.graphs`, `phase_pose_graphs`) on
   the tamed ResNet-152: graphed poses bit-equal to the eager network's
   and the conv_epilogue count per call equal, for estimate_pose,
   estimate_pose_batch at 8 and 5 frames and estimate_pose_many over two
   buckets, every chunk after a shape's capture a replay (the hit share
   logged); four threads' answers equal to the serial ones; the profiler's
   busy time of the replayed network within 3% of its CUDA-event graph
   time and of the eager network's, and its conv_epilogue kernels equal to
   the counter; wall time per call graphed and eager in turns; 240
   estimate_pose_batch calls on distinct frames back to back, bit-equal to
   the per-frame pageable canvases' path, and both paths' wall time per
   call in turns (`_staging_check`); the cost of
   a capture; estimate_pose over 12 frame sizes (more shapes than the
   cache holds) and estimate_pose_many over batches of mixed sizes, in
   rounds, graphed against eager, with no capture once the cache settles;
   the tiled path, folded=False and int8 keeping the eager network;
6. times on the card, each beside the card's name and limit: the bf16 and
   int8 serving forwards and estimate_pose_batch at batch 1 and 4
   (CUDA-event wall time, torch.profiler device busy time, idle share,
   kernels per call), the same for estimate_pose on a 720x1280 frame (the
   tiled path) and estimate_pose_avg, with the profiler's kernels per
   `_decode_whole` call (the prob entry alone), each kernel at the main
   path's shapes (the prob entry at its paths' PROB_SHAPES) beside its
   plain version, its bound and a library call where one computes the
   same function (quantize_i8 with the L2 flushed before each call, in turns
   with torch.quantize_per_tensor to qint8, a yardstick of time only),
   torch._int_mm per GEMM shape of the int8 forward against its int8 bound,
   the graph engine's CaffeNet `Classifier.predict` (20 crops) and
   `make_forward` at batch 10, the ResNet-152 graph's `make_forward` at
   batch 1 and 4 beside the native bf16 forward, `Detector.detect_windows`,
   and the full-width PoseSolver.step; D7: the Data-layer train step from
   the LMDB beside E(a)'s MemoryData step, the host milliseconds of one
   LMDBDataSource batch of 256 and one WindowDataSource batch of 128, and
   `cli test`'s bf16 forward per batch of 50 from the LevelDB.

The kernels' launch counters are zeroed before phase 4 and read after
phase 5 (the serving path), zeroed again before Q and read after its
server (the int8 serving path), again before T1 and after T3 (the
training path), again before G and after it (the graph engine's path),
again before D and after it (the data slice's path: `cli test` in bf16
launches conv_epilogue), again before X and after it (the examples' path:
the launches of the requests its services answered, X1's and X2's; its
in-process references are logged apart), again before M and after it (MatCaffe and the
data-parallel path: the eval hook's decode), again before S and after it
(the spatial path, with the counts of its two ranks: every kernel), again before E and after it (the engine's
training path, which launches no kernel: its f32 stream rounds nowhere),
and again before 6a's `make_forward` and after its decode (the epilogue
and the fused decode; its references run before the counts are zeroed).
The launch geometries of every path but E (the decode's probability-map
entry's too: its views and valid sizes) are replayed against the plain
kernels after S (S's ranks replay their own). --serving-times imports only what the package had before the conv
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
import io
import itertools
import json
import math
import shutil
import subprocess
import sys
import tempfile
import threading
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
# The probability-map entry at the shapes its paths launch, batch 1, and at
# batch 4 on the 704 bucket's grid (the shape of the earlier readings).
PROB_SHAPES = [((1, J, 86, 86), "a 688 frame's scoremaps, or a 688 frame under a mesh"),
               ((1, J, 90, 160), "the tiled HD path's 720x1280 frame (phase 4)"),
               ((1, J, 136, 240), "a 1088x1920 frame under a mesh (S3)"),
               ((4, J, 88, 88), "batch 4 on the 704 bucket's grid")]
# The JSON record's: the shape of the earlier readings, so that its series
# compares (each record states its shape; the paths' shapes are logged).
PROB_RECORD_SHAPE = (4, J, 88, 88)
PYRAMID_SCALES = (0.8, 1.0, 1.2)      # estimate_pose_avg's scales in phases 4 and 6
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
# conv3x3 (the trunk's 3x3 convs) against cuDNN's TF32 route (`exact_conv`)
# at the geometries the kernel takes on the main path: (name, x (N, C, H, W),
# Cout, dilation). Widths 64 to 512, dilation 1 and 2, batch 4 and 1 on the
# 704 canvas, the tiled HD path's 720x1280 frame, and maps that are no
# multiple of the kernel's 128-pixel tile or narrower than a tap's reach.
CONV3X3_CASES = [("res2", (4, 64, 176, 176), 64, 1), ("res2 batch 1", (1, 64, 176, 176), 64, 1),
                 ("res3", (4, 128, 88, 88), 128, 1), ("res3 batch 1", (1, 128, 88, 88), 128, 1),
                 ("res4", (4, 256, 44, 44), 256, 1), ("res4 batch 1", (1, 256, 44, 44), 256, 1),
                 ("res5 dilated", (4, 512, 44, 44), 512, 2),
                 ("res5 dilated batch 1", (1, 512, 44, 44), 512, 2),
                 ("res3 HD tile", (1, 128, 180, 320), 128, 1),
                 ("res5 HD tile", (1, 512, 90, 160), 512, 2),
                 ("odd map", (2, 128, 20, 13), 128, 1), ("9x11 map", (1, 64, 9, 11), 64, 1),
                 ("dilated 9x7 map, Cout 512", (1, 256, 9, 7), 512, 2),
                 ("dilated 7x5 map, Cout 128", (1, 64, 7, 5), 128, 2)]
# The trunk's 3x3 convs at batch 4 and 1 on the 704 canvas: stage -> (C,
# map, dilation, convs per forward).
CONV3X3_STAGES = {"res2": (64, 176, 1, 3), "res3": (128, 88, 1, 8), "res4": (256, 44, 1, 36),
                  "res5": (512, 44, 2, 3)}
BF16_FLOPS = 989e12   # the H100 SXM's dense bf16 tensor-core rate (NVIDIA's data sheet)
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
# drops the rate at 1200. Eight runs on an H100 read 0.9375-0.9643 at
# step 1350 (0.8304-0.9375 at 900), so it stops at 1350.
PCKH_MIN, PCKH_GAIN = 0.9, 0.5
T3_STEPS = 1350
# M2's ResNet depth, at full width: its check, mesh=make_mesh(1) bit-equal
# to mesh=None, holds at any depth, and ResNet-50 takes a third of the
# convolutions. The ranks of M3 and S and E(b) stay at ResNet-152: they
# hold the tamed conv1 within 1e-3 of its scale, which ResNet-50's
# conditioning does not meet (M3 read 1.21e-3 at ResNet-50 on an H100,
# 1.2e-4 at ResNet-152).
M2_DEPTH = 50


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
    """The command users run to build ahead, `python -m
    deepcut_tpu_torch.runtime.build`, as a process: it builds the
    rasterizer (g++) and the four CUDA sources (nvcc), one compiler per
    source, all started together, loads each, and prints each library and
    its compiler log; it must exit 0."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "deepcut_tpu_torch.runtime.build"], cwd=ROOT,
                         capture_output=True, text=True)
    log(run.stdout.strip())
    if run.returncode != 0:
        raise AssertionError(f"python -m deepcut_tpu_torch.runtime.build exited {run.returncode}:"
                             f"\n{run.stderr}")
    log(f"build: python -m deepcut_tpu_torch.runtime.build exited 0 in "
        f"{time.perf_counter() - t0:.2f} s")


# -- 3. kernels against plain -----------------------------------------------
def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN where NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in f32 units in the last place between finite a and b."""
    fin = a.isfinite() & b.isfinite()
    d = (a[fin].view(torch.int32).long() - b[fin].view(torch.int32).long()).abs()
    return int(d.max()) if d.numel() else 0


def _strided(kind: str, prob: torch.Tensor, loc: torch.Tensor, rng):
    """prob (n, J, h, w) and loc (n, 2J, h, w) as views of another layout
    holding the same values: the paths' row crop of a taller map, both maps
    sliced out of one larger map, the pyramid's average ((rows, joints)
    swapped in memory), and a loc cut out of wider rows."""
    n, _, h, w = prob.shape
    if kind == "row-cropped":
        out = []
        for t in (prob, loc):
            big = torch.from_numpy(rng.rand(n, t.shape[1], h + 7, w).astype(np.float32))
            big[:, :, :h] = t
            out.append(big[:, :, :h])
        return tuple(out)
    if kind == "channel-sliced":
        big = torch.from_numpy(rng.rand(n, 3 * J + 5, h, w).astype(np.float32))
        big[:, 2:2 + J], big[:, 2 + J:2 + 3 * J] = prob, loc
        return big[:, 2:2 + J], big[:, 2 + J:2 + 3 * J]
    if kind == "rows-outer":
        return tuple(t.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3) for t in (prob, loc))
    if kind == "loc in wider rows":
        big = torch.from_numpy(rng.randn(n, 2 * J, h, w + 5).astype(np.float32))
        big[..., 3:3 + w] = loc
        return prob, big[..., 3:3 + w]
    raise ValueError(kind)


# The probability-map entry's views, each at a path's shape (batch 1).
STRIDED_CASES = [("row-cropped", (1, J, 86, 86)), ("row-cropped", (1, J, 136, 240)),
                 ("channel-sliced", (1, J, 90, 160)), ("rows-outer", (1, J, 86, 86)),
                 ("loc in wider rows", (2, J, 45, 61))]


def _kernel_cases(rng):
    """(name, prob, loc, valid rows, valid columns) for the probability-map
    entry, on the CPU: every shape of KERNEL_SHAPES and PROB_SHAPES with
    random, tied, all-equal, bf16-valued and NaN maps, then the paths'
    strided views."""
    for shape in KERNEL_SHAPES + [s for s, _ in PROB_SHAPES]:
        n, _, h, w = shape
        rand = rng.rand(*shape).astype(np.float32)
        ties = np.round(rand * 8) / 8                               # many equal maxima
        bf16 = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3).to(torch.bfloat16).float()
        nan = rand.copy()
        nan[0, :3, h // 2, w // 3] = np.nan
        nan[-1, 5, 0, 0] = np.nan
        nan[0, 1, h - 1, w - 1] = np.inf
        loc = torch.from_numpy(rng.randn(n, 2 * J, h, w).astype(np.float32))
        full = ([h] * n, [w] * n)
        masked = (rng.randint(1, h + 1, n).tolist(), rng.randint(1, w + 1, n).tolist())
        yield f"{shape} random", torch.from_numpy(rand), loc, *full
        yield f"{shape} ties masked", torch.from_numpy(ties.astype(np.float32)), loc, *masked
        yield f"{shape} all-equal", torch.full(shape, 0.5), loc, *masked
        yield f"{shape} bf16-upcast masked", bf16, loc, *masked
        yield f"{shape} NaN", torch.from_numpy(nan), loc, *full
    for kind, shape in STRIDED_CASES:
        n, _, h, w = shape
        ties = torch.from_numpy((np.round(rng.rand(*shape) * 8) / 8).astype(np.float32))
        loc = torch.from_numpy(rng.randn(n, 2 * J, h, w).astype(np.float32))
        prob, loc = _strided(kind, ties, loc, rng)
        yield f"{shape} {kind} ties", prob, loc, [h] * n, [w] * n
        yield (f"{shape} {kind} ties masked", prob, loc, rng.randint(0, h + 1, n).tolist(),
               rng.randint(1, w + 1, n).tolist())


def _on_card(t: torch.Tensor) -> torch.Tensor:
    """The same view (shape, strides, storage offset) of a copy of t's
    storage on the card: a strided case stays a view there."""
    storage = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    return storage.cuda().as_strided(t.shape, t.stride(), t.storage_offset())


def check_decode_prob() -> float:
    """The probability-map entry against its plain version on the card:
    argmax and pose bit for bit (NaN where NaN), sizes as ints."""
    rng = np.random.RandomState(SEED)
    max_err, cases = 0.0, 0
    for name, prob, loc, vh, vw in _kernel_cases(rng):
        prob, loc = _on_card(prob), _on_card(loc)
        valid = tuple(torch.tensor(v, dtype=torch.int32, device="cuda") for v in (vh, vw))
        for scale in (1.0, 0.75, 1.3):
            got = cuda_decode.decode_pose(prob, loc, vh, vw, scale)
            ref = decode_pose_batch(prob, loc, scale=scale, valid_hw=valid)
            torch.cuda.synchronize()
            if not _same(got, ref):
                raise AssertionError(f"decode (prob entry) differs from plain on {name} at "
                                     f"scale {scale}")
            d = (got - ref).abs()
            max_err = max(max_err, float(d[d.isfinite()].max()) if d.isfinite().any() else 0.0)
        # argmax indices: with zero offsets at scale 1, x and y are cell*8+4
        cells = cuda_decode.decode_pose(prob, torch.zeros_like(loc), vh, vw, 1.0)
        idx = ((cells[:, 1] - 4) / 8).long() * prob.shape[3] + ((cells[:, 0] - 4) / 8).long()
        rows = torch.arange(prob.shape[2], device="cuda").reshape(1, 1, -1, 1)
        cols = torch.arange(prob.shape[3], device="cuda").reshape(1, 1, 1, -1)
        keep = (rows < valid[0].reshape(-1, 1, 1, 1)) & (cols < valid[1].reshape(-1, 1, 1, 1))
        masked = torch.where(keep, prob, torch.tensor(float("-inf"), device="cuda"))
        if not torch.equal(idx, torch.argmax(masked.flatten(2), dim=2)):
            raise AssertionError(f"decode (prob entry) argmax differs from plain on {name}")
        cases += 1
    limits = cuda_decode.fused_limits()
    log(f"decode prob entry == plain ({limits['prob_cluster']}-block clusters): argmax and pose "
        f"bit-equal on {cases} cases x 3 scales (shapes {KERNEL_SHAPES} and the paths' "
        f"{[s for s, _ in PROB_SHAPES]}: random, ties, all-equal, bf16-valued, NaN, masked and "
        f"not; views {sorted({k for k, _ in STRIDED_CASES})}; max |err| {max_err:.3g})")
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


def _conv3x3_case(gen, xs, cout, device="cuda"):
    """bf16-valued x (channels_last) and a He-scaled bf16-valued
    (Cout, C, 3, 3) weight."""
    cl = torch.channels_last
    x = torch.randn(xs, generator=gen, device=device).to(torch.bfloat16).float()
    w = torch.randn((cout, xs[1], 3, 3), generator=gen, device=device) * (2.0 / (9 * xs[1])) ** 0.5
    return x.contiguous(memory_format=cl), w.to(torch.bfloat16).float().contiguous(memory_format=cl)


def _conv3x3_held(got, ref, x, w, dil, what: str) -> float:
    """got against ref, two f32 sums of the same 9*C exact products in other
    orders: each is within (K - 1) * 2**-24 * sum |x * w| of the exact sum,
    so they differ by at most K * 2**-23 * (|x| conv |w|) per element.
    Returns the largest difference as a share of that bound."""
    from deepcut_tpu_torch.ops.conv import full_f32_conv

    bound = 9 * x.shape[1] * 2.0 ** -23 * full_f32_conv(x.abs(), w.abs(), pad=dil, dilation=dil)
    share = float(((got - ref).abs() / bound.clamp_min(2.0 ** -126)).max())
    if not (share <= 1.0 and torch.isfinite(got).all()):
        raise AssertionError(f"conv3x3 at {what}: max |diff| {float((got - ref).abs().max()):.3g}, "
                             f"{share:.3g} of the reordered-sum bound")
    return share


def check_conv3x3() -> float:
    """conv3x3 against `exact_conv`'s cuDNN route (TF32 on bf16 values) at
    CONV3X3_CASES: within the reordered-sum bound (`_conv3x3_held`), two
    launches bit-equal, the output channels_last; the packed weights unpack
    to the originals. Returns the largest |diff| over max |ref|."""
    from deepcut_tpu_torch.ops import conv3x3
    from deepcut_tpu_torch.ops.conv import exact_conv

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    worst, worst_share = 0.0, 0.0
    for name, xs, cout, dil in CONV3X3_CASES:
        x, w = _conv3x3_case(gen, xs, cout)
        wk = conv3x3.pack(w)
        if not torch.equal(conv3x3.unpack(wk), w):
            raise AssertionError(f"conv3x3 at {name}: the packed weights do not unpack to w")
        got = conv3x3.conv3x3(x, wk, dil)
        again = conv3x3.conv3x3(x, wk, dil)
        ref = exact_conv(x, w, pad=dil, dilation=dil)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"conv3x3 at {name}: two launches differ")
        if not got.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError(f"conv3x3 at {name}: the output is not channels_last")
        worst_share = max(worst_share, _conv3x3_held(got, ref, x, w, dil, name))
        worst = max(worst, float((got - ref).abs().max() / ref.abs().max()))
    log(f"conv3x3 against cuDNN's TF32 route on {len(CONV3X3_CASES)} geometries: max |diff| / "
        f"max |ref| {worst:.3g}, at most {worst_share:.3g} of the reordered-sum bound; two "
        f"launches bit-equal")
    return worst


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


def replay_path_geometries(recorded: dict, device: str = "cuda") -> dict:
    """Every distinct launch geometry (shape, strides, storage offset and
    mode) that the main paths gave conv_epilogue, int8_im2col,
    int8_epilogue, quantize_i8 and the decode's probability-map entry
    (`recorded`: the seam's record per kernel name, `native.geometries`;
    the decode's holds its views and valid sizes), replayed on fresh
    random inputs against the plain version on the card, bit for bit; and
    conv3x3's, whose sums run in another order than the plain f32 conv's:
    two launches bit-equal, within `_conv3x3_held`'s bound of the plain.
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
    epilogue = recorded.get("conv_epilogue", {})
    for (yg, has_bias, rg, relu) in epilogue:
        y = _view(yg, randn(4))
        bias = torch.randn(yg[1][1], generator=gen, device=device) if has_bias else None
        res = residual(rg)
        got = conv_epilogue.conv_epilogue(y.clone(), bias, res, relu)
        if not torch.equal(got, conv_epilogue.conv_epilogue_plain(y, bias, res, relu)):
            raise AssertionError(f"conv_epilogue differs from plain at the path's {yg} "
                                 f"bias={has_bias} residual={rg} relu={relu}")
    done["conv_epilogue"] = len(epilogue)
    for (xg, k, stride, pad, dil, lhs, min_rows, width) in recorded.get("int8_im2col", {}):
        x = _view(xg, rand_i8)
        kw = dict(stride=stride, pad=pad, dilation=dil, lhs_dilation=lhs, min_rows=min_rows,
                  width=width)
        if not torch.equal(ic.int8_im2col(x, k, **kw), ic.int8_im2col_plain(x, k, **kw)):
            raise AssertionError(f"int8_im2col differs from plain at the path's {xg} k={k} {kw}")
    for (ag, rg, relu, bf16, f32_out, _), (res_scale, requant_s) in recorded.get(
            "int8_epilogue", {}).items():
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

    for xg, (s,) in recorded.get("quantize_i8", {}).items():
        x = _view(xg, planted(s))
        if not torch.equal(ic.quantize_i8(x, s), ic.quantize_i8_plain(x, s)):
            raise AssertionError(f"quantize_i8 differs from plain at the path's {xg} s={s}")
    for name in ("int8_im2col", "int8_epilogue", "quantize_i8"):
        done[name] = len(recorded.get(name, {}))

    def probs(n, _):   # probabilities in steps of 1/64: ties across the map
        return torch.round(torch.rand(n, generator=gen, device=device) * 64) / 64

    decode = recorded.get("decode_pose", {})
    for (pg, lg, vh, vw), (scale,) in decode.items():
        prob, loc = _view(pg, probs), _view(lg, randn(2))
        got = cuda_decode.decode_pose(prob, loc, list(vh), list(vw), scale)
        ref = decode_pose_batch(prob, loc, scale=scale,
                                valid_hw=(torch.tensor(vh), torch.tensor(vw)))
        if not _same(got, ref):
            raise AssertionError(f"decode (prob entry) differs from plain at the path's {pg} "
                                 f"loc {lg} valid {vh} x {vw} scale {scale}")
    done["decode_pose_prob"] = len(decode)
    from deepcut_tpu_torch.ops import conv3x3
    from deepcut_tpu_torch.ops.conv import full_f32_conv

    convs = recorded.get("conv3x3", {})
    for (xg, wshape, dil) in convs:
        x = _view(xg, randn(1, torch.bfloat16))
        cout, cin = wshape[0], wshape[3]
        w = (torch.randn((cout, cin, 3, 3), generator=gen, device=device) * (2.0 / (9 * cin)) ** 0.5
             ).to(torch.bfloat16).float()
        wk = conv3x3.pack(w)
        got, again = conv3x3.conv3x3(x, wk, dil), conv3x3.conv3x3(x, wk, dil)
        if not torch.equal(got, again):
            raise AssertionError(f"conv3x3 differs from itself at the path's {xg} {wshape} d={dil}")
        _conv3x3_held(got, full_f32_conv(x, w, pad=dil, dilation=dil), x, w, dil,
                      f"the path's {xg} {wshape} d={dil}")
    done["conv3x3"] = len(convs)
    log(f"the main paths' launch geometries replayed against the plain versions on fresh "
        f"random inputs, bit-equal (conv3x3: two launches bit-equal, within the reordered-sum "
        f"bound of the plain): {done}")
    return done


def phase_kernels_vs_plain() -> dict:
    errs = {"decode_pose_prob": check_decode_prob(), "decode_pose": check_decode_fused(),
            "conv_epilogue": check_conv_epilogue(), "int8_im2col": check_int8_im2col(),
            "int8_epilogue": check_int8_epilogue(), "quantize_i8": check_quantize_i8(),
            "conv3x3": check_conv3x3()}
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
    with decoded_wholes(est) as decoded:
        hd = frame(rng, 720, 1280)
        pose_hd = est.estimate_pose(hd)
        del est._scoremaps_tiled
        if not tiled or pose_hd is None or not np.isfinite(pose_hd).all():
            raise AssertionError("HD frame did not take the tiled path or gave no pose")
        log(f"HD 720x1280: tiled path ({canvas_size(720, 1)}x{canvas_size(1280, 1)} canvas), "
            f"finite (5, 14)")
        pose_avg = est.estimate_pose_avg(frame(np.random.RandomState(SEED + 11), 688, 688),
                                         PYRAMID_SCALES)
        if pose_avg.shape != (5, J) or not np.isfinite(pose_avg).all():
            raise AssertionError(f"estimate_pose_avg: bad pose {pose_avg}")
    check_decoded_wholes(decoded, ("the tiled HD frame", f"the pyramid {PYRAMID_SCALES}"))
    return est


@contextlib.contextmanager
def decoded_wholes(est):
    """Records each `_decode_whole` call of `est` inside the block: its maps
    (the views the decode read), scale, pose and the probability-map
    entry's launches during it."""
    calls = []
    inner = est._decode_whole

    def capture(prob, loc, scale):
        before = cuda_decode.prob_launches
        pose = inner(prob, loc, scale)
        calls.append((prob, loc, scale, pose, cuda_decode.prob_launches - before))
        return pose

    est._decode_whole = capture
    try:
        yield calls
    finally:
        del est._decode_whole


def check_decoded_wholes(calls, names) -> None:
    """Each recorded `_decode_whole` launched the probability-map entry once
    and gave the plain version's pose on the path's own maps, bit for bit."""
    if len(calls) != len(names):
        raise AssertionError(f"{len(calls)} decodes of whole maps for {names}")
    for (prob, loc, scale, pose, launches), name in zip(calls, names):
        h, w = prob.shape[1:]
        ref = decode_pose_batch(prob[None], loc[None], scale=scale,
                                valid_hw=(torch.tensor([h]), torch.tensor([w])))[0]
        same = _same(torch.from_numpy(pose), ref.cpu())
        if launches != 1 or not same:
            raise AssertionError(f"the decode of {name}: {launches} launches of the prob entry "
                                 f"(want 1), pose {'equal to' if same else 'differs from'} plain's")
        log(f"decode of {name}: maps {tuple(prob.shape)} strides {prob.stride()} / loc "
            f"{loc.stride()}, one launch of the prob entry, pose bit-equal to plain")


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
def _png(img_bgr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img_bgr[:, :, ::-1]).save(buf, format="PNG")
    return buf.getvalue()


def _png_body(img_bgr: np.ndarray) -> tuple:
    """A frame as the multipart upload a client sends: (body, headers)."""
    boundary = "chipsmokeboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
            f"filename=\"f.png\"\r\nContent-Type: image/png\r\n\r\n").encode() \
        + _png(img_bgr) + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _post(port: int, path: str, upload: tuple) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, *upload)
        answer = json.loads(conn.getresponse().read())
    finally:
        conn.close()
    if not answer.get("ok"):
        raise AssertionError(f"POST {path}: {answer}")
    return answer


def phase_server(est, rng, int8: bool = False):
    """int8: the service's --int8, which calibrates `est` on the first
    request's frame."""
    from deepcut_tpu_torch.examples.pose import serve

    app = serve.PoseApp(estimator=est, int8=int8, batch_window_ms=4)
    httpd = serve.serve(app, port=0, background=True)
    try:
        frames = [frame(rng, 480, 640), frame(rng, 300, 400), frame(rng, 720, 1280)]
        with ThreadPoolExecutor(len(frames)) as pool:
            answers = list(pool.map(
                lambda f: _post(httpd.server_address[1], "/estimate", _png_body(f)), frames))
    finally:
        httpd.shutdown()
        httpd.server_close()
    if int8 and not est.is_int8:
        raise AssertionError("the service's --int8 did not quantize the estimator")
    what = "int8 " if int8 else ""
    for f, ans in zip(frames, answers):
        if len(ans["joints"]) != J:
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
    """A window file in the reference's format (pose_data_layer.cpp:146-207),
    written by the port's `write_window_file`: one person with all 14
    joints per image. records: (png path, h, w, (14, 2) xy)."""
    from deepcut_tpu_torch.data.window_file import ImageRecord, Person, write_window_file

    classes = np.arange(1, J + 1, dtype=np.int32)
    write_window_file(str(path), [ImageRecord(str(png), 3, h, w, [Person(classes, np.asarray(xy))])
                                  for png, h, w, xy in records])
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


def phase_train_learns(root: Path, snapshot_model: Path, device: str = "cuda"):
    """The disc task through the CLI's data source and `PoseSolver`, scored
    by the eval hook through the port's estimator. `device` other than cuda
    is for rehearsing the recipe off the card (no kernel there)."""
    from PIL import Image
    from deepcut_tpu_torch.models.resnet import DeeperCutConfig
    from deepcut_tpu_torch.pose.estimate import get_estimator
    from deepcut_tpu_torch.pose.evaluate import evaluate_estimator
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
        result = evaluate_estimator(est, held_out)       # PCKh@0.5, MPII's rule
        scores.append((result.mean, result.per_joint))
        return f"PCKh@0.5 = {scores[-1][0]:.4f}"

    solver = PoseSolver(sp, cfg, lambda: source.next_batch(4),
                        net_params=init_params(torch.Generator().manual_seed(SEED), cfg),
                        eval_fn=eval_fn, target_cfg=tcfg, target_stats=stats, device=device)
    before = cuda_decode.launches
    t0 = time.perf_counter()
    try:
        solver.step(T3_STEPS + 1)            # evals before iterations 0, 450, ..., T3_STEPS
    finally:
        source.close()
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    (m0, _), (m1, per_joint) = scores[0], scores[-1]
    log(f"T3 disc task, tiny model, {T3_STEPS} steps of batch 4 on {device} in {secs:.1f} s: held-out "
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
# The native forward against itself on the graph engine's routes (every
# conv on cuDNN, `_cudnn_routes`): the trunk's 50 3x3 convs on conv3x3 sum
# their exact products in another order, so, as with fuse_siblings, a
# bf16 rounding that moves propagates through the later blocks. Held in
# steps at each map's largest magnitude, as the fused graph is. Read on the
# card (NVIDIA H100 80GB HBM3, 700.00 W): fc_pose 2.5, loc_pred 3, 79-81%
# of elements apart, where fuse_siblings' 6 reordered convs read 1 and 2;
# held to 8.
CONV3X3_MAP_STEPS = 8
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


def caffenet_weights(path: Path, device: str = "cuda") -> Path:
    """G1's CaffeNet weights (`tame_caffenet` from the seed) as a .caffemodel."""
    from deepcut_tpu_torch import compat

    writer = compat.Net(str(CAFFENET), compat.TEST, device=device)
    tame_caffenet(writer._net, torch.Generator().manual_seed(SEED))
    writer.save(str(path))
    return path


def phase_graph_caffenet(root: Path, rng, device: str = "cuda") -> dict:
    """G1: CaffeNet at full width (examples/imagenet/caffenet_deploy.prototxt,
    batch 10 of 227x227, 8 classes) from a seeded .caffemodel: the
    Classifier's 10-crop predictions, against the bf16 serving forward and
    through compat.Net.forward_all, then `cli time` and `cli test`."""
    from deepcut_tpu_torch import compat
    from deepcut_tpu_torch.classifier import Classifier
    from deepcut_tpu_torch.core.graph import Net

    weights = caffenet_weights(root / "caffenet_tamed.caffemodel", device)
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
    # the mean of an 8-way softmax, 1/8, from the bf16 stream: each
    # probability rounded to bf16 (relative 2^-9), so a row's sum is 1
    # within 2^-9 and the mean 1/8 within 2^-9 / 8
    prob = _printed(out).get("prob", math.nan)
    if not abs(prob - 0.125) <= 2.0 ** -9 / 8:
        raise AssertionError(f"cli test: {out}")
    det, windows = phase_graph_detector(root, rng, weights, device)
    return {"classifier": cls, "frames": frames, "serve": serve, "fwd": fwd, "x10": x[:10],
            "detector": det, "windows": windows}


DETECTOR_CONTEXT_PAD = 16


def phase_graph_detector(root: Path, rng, weights: Path, device: str = "cuda"):
    """G1, Detector: `Detector.detect_windows` on the CaffeNet deploy net over
    10 seeded windows of two frames (context padding 16), against
    `compat.Net.forward` of the same crops (one batch of 10, f32). The
    frames are written to a directory of their own, which `graph_times`
    reads again and removes."""
    from PIL import Image
    from deepcut_tpu_torch import compat
    from deepcut_tpu_torch import io as dio
    from deepcut_tpu_torch.detector import Detector

    frames = Path(tempfile.mkdtemp(prefix="chip_smoke_detector_"))
    windows = []
    for i, (h, w) in enumerate(((480, 640), (360, 500))):
        path = frames / f"detector{i}.png"
        Image.fromarray(frame(rng, h, w)[:, :, ::-1]).save(path)
        y0, x0 = rng.randint(0, h // 2, 5), rng.randint(0, w // 2, 5)
        boxes = np.stack([y0, x0, y0 + rng.randint(40, h // 2, 5),
                          x0 + rng.randint(40, w // 2, 5)], 1)
        windows.append((str(path), boxes))
    det = Detector(str(CAFFENET), str(weights), raw_scale=255, channel_swap=(2, 1, 0),
                   mean=IMAGENET_MEAN_BGR, context_pad=DETECTOR_CONTEXT_PAD, device=device)
    got = np.stack([d["prediction"] for d in det.detect_windows(windows)])
    in_ = det.inputs[0]
    crops = [det.crop(dio.load_image(path), box) for path, boxes in windows for box in boxes]
    data = np.stack([det.transformer.preprocess(in_, dio.resize_image(c, det.blobs[in_].shape[2:]))
                     for c in crops])
    net = compat.Net(str(CAFFENET), str(weights), compat.TEST, device=device)
    want = net.forward(data=data)["prob"].reshape(len(crops), -1)
    d = float(np.abs(got - want).max())
    log(f"G1 Detector.detect_windows, {len(crops)} windows of 2 frames (context pad "
        f"{DETECTOR_CONTEXT_PAD}), f32: {got.shape}, top classes {got.argmax(1).tolist()}; "
        f"against compat.Net.forward of the same crops max |dp| {d:.3g} (held to 1e-6)")
    if got.shape != (10, 8) or not np.isfinite(got).all() or d > 1e-6:
        raise AssertionError("Detector.detect_windows off Net.forward of its crops")
    return det, windows


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


def _printed(out: str) -> dict:
    """`cli test`'s `name = mean` lines."""
    return {ln.split(" = ")[0]: float(ln.split(" = ")[1]) for ln in out.splitlines()
            if " = " in ln and " " not in ln.split(" = ")[0]}


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


@contextlib.contextmanager
def _cudnn_routes():
    """The native forward on the graph engine's conv routes: conv3x3's rule
    off for the block, so every conv runs `exact_conv` (cuDNN)."""
    from deepcut_tpu_torch.ops import conv3x3

    rule = conv3x3.engages
    conv3x3.engages = lambda *args, **kwargs: False
    try:
        yield
    finally:
        conv3x3.engages = rule


def phase_graph_serving(g: dict, device: str = "cuda") -> dict:
    """G2: the serving chain without and with fuse_siblings against the
    native DeeperCut bf16 forward of the same weights on one frame, on the
    graph's conv routes (cuDNN, `_cudnn_routes`); and the native forward
    on its own routes (the 3x3 convs on conv3x3) against that."""
    from deepcut_tpu_torch.models.resnet import fold_bn

    cfg, x, heads = g["cfg"], g["x"], g["heads"]
    # folded on the device, as the graph folds: the card's rsqrt may differ
    # from the host's in the last bit, and a folded weight's bf16 rounding
    # with it
    on_device = {n: {k: v.to(device) for k, v in e.items()} for n, e in g["params"].items()}
    native = DeeperCut(fold_bn(on_device, cfg), cfg).to(device, memory_format=g["cl"])
    with torch.inference_mode():
        own = native(x.contiguous(memory_format=g["cl"]), heads=("pose", "locref"))
        with _cudnn_routes():
            want = native(x.contiguous(memory_format=g["cl"]), heads=("pose", "locref"))
    del native
    for k in ("fc_pose", "loc_pred"):
        top = float(want[k].abs().max())
        steps = float((own[k] - want[k]).abs().max()) / _bf16_step(top)
        log(f"G2 native bf16 {k}, its 3x3 convs on conv3x3 against cuDNN: "
            f"{float((own[k] != want[k]).float().mean()):.6f} of elements differ; {steps:.3g} "
            f"bf16 steps at the map's largest magnitude {top:.4g} (held to {CONV3X3_MAP_STEPS})")
        if not steps <= CONV3X3_MAP_STEPS:
            raise AssertionError(f"G2: the native {k} on conv3x3 outside the tolerance")
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


# -- E. the graph engine's training ---------------------------------------------
CAFFENET_TRAIN_VAL = ROOT / "examples/imagenet/caffenet_train_val.prototxt"
CAFFENET_SOLVER = ROOT / "examples/imagenet/caffenet_solver.prototxt"
CAFFENET_BATCH = {"TRAIN": 256, "TEST": 50}
CAFFENET_STEPS, CAFFENET_TEST_EVERY, CAFFENET_TEST_ITER = 50, 10, 10
COLOR_CLASSES = 8
# The recipe's rate (base_lr 0.01) is unstable on 8 classes: its fc8 sees 1/8
# of a batch per class where ImageNet's sees 1/1000, and a step moves the
# logits by tens. On the card (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md) the
# loss overshoots from 7.5 to 18-25 at step 1 and the test accuracy stays at
# one to three classes: in 13 runs the best of five passes read 63 of 500
# frames twice, 125-126 eight times, 187-188 three times. At a tenth of it
# the same 50 steps learn the task in every run (4 of 4: 435 of 500 frames
# at step 20, all 500 from step 30), as D2 learns from its LMDB; so E(a)
# and D run the recipe at CAFFENET_BASE_LR, and E(a) holds: the loss falls
# (the lowest 5-step mean after step 10 below half the first step's) and a
# test pass over 500 TEST frames classifies CAFFENET_MIN_ACCURACY of them
# (chance is 1/8). Colour means +-60 under noise of std 40.
CAFFENET_BASE_LR = 0.001
CAFFENET_LOSS_FALL = 0.5
CAFFENET_MIN_ACCURACY = 0.9
COLOR_MEAN, COLOR_NOISE = 60.0, 40.0
DROPOUT_KEEP_TOL = 0.01
# ResNet-152 graph (prototxt + the heads' losses) against PoseSolver, one
# step from the same weights on the same host batch, f32 with TF32 off.
# Written before the first run: the graph applies BatchNorm and Scale as two
# layers where the native forward applies one affine, and sums in another
# order, a few f32 roundings per layer over 155 convolutions: the loss within
# 1e-4 relative; each compared blob's update (old - new) within 1e-3 of its
# largest |update| (conv1's gradient crosses every layer), and its weights
# after the step within 1e-3 of their largest magnitude. The first run read
# loss 1.1e-7 and conv1's update 1.1e-4 apart; conv1's weights 1.1e-4 too,
# outside the 1e-5 first written here: tamed x3e-4, they are no larger than
# one update (PERF.md).
ENGINE_POSE_LOSS_RTOL = 1e-4
ENGINE_POSE_UPDATE_RTOL = 1e-3
ENGINE_POSE_WEIGHT_RTOL = 1e-3
ENGINE_POSE_BLOBS = ("conv1", "res3d_pose", "res5c_up_pose", "res3d_locref", "res5c_up_locref")


def caffenet_memory_net(root: Path) -> Path:
    """examples/imagenet/caffenet_train_val.prototxt at BVLC's published
    widths: its two Data layers replaced by MemoryData (TRAIN batch 256, TEST
    batch 50, 3x227x227), fc8 at 1000 outputs; the rest as it is (grouped
    convs, LRNs, Dropout 0.5, SoftmaxWithLoss, Accuracy in TEST)."""
    from deepcut_tpu_torch.proto import text_format
    from deepcut_tpu_torch.proto.text_format import PbNode

    net = text_format.parse_file(str(CAFFENET_TRAIN_VAL))
    for layer in net.get_list("layer"):
        if layer.get_str("type") == "Data":
            mp = PbNode()
            phase = layer.get("include").get_str("phase")
            for k, v in (("batch_size", CAFFENET_BATCH[phase]), ("channels", 3),
                         ("height", 227), ("width", 227)):
                mp.add(k, v)
            layer.fields["type"] = ["MemoryData"]
            layer.fields.pop("transform_param", None)
            layer.fields.pop("data_param", None)
            layer.add("memory_data_param", mp)
        if layer.get_str("name") == "fc8":
            layer.get("inner_product_param").fields["num_output"] = [1000]
    path = root / "caffenet_memory_train_val.prototxt"
    path.write_text(text_format.dump(net) + "\n")
    return path


def color_frames(gen: np.random.Generator, n: int):
    """n mean-subtracted 3x227x227 frames, labels 0..7: class k's colour mean
    is a corner of a cube (each BGR channel +-COLOR_MEAN), under noise of
    std COLOR_NOISE."""
    labels = np.arange(n) % COLOR_CLASSES
    corners = (np.array([[(k >> c) & 1 for c in range(3)] for k in range(COLOR_CLASSES)],
                        np.float32) * 2.0 - 1.0) * COLOR_MEAN
    data = gen.standard_normal((n, 3, 227, 227), dtype=np.float32) * COLOR_NOISE
    data += corners[labels][:, :, None, None]
    return data, labels.astype(np.float32)


def dropout_keep_rates(net, rows: int) -> list:
    """Each TRAIN Dropout layer of a graph net called on the card over ones
    of (rows, 4096), from the generator a step would give it: (name, share
    kept, the kept values)."""
    out = []
    for idx, (fn, spec) in enumerate(net._plan):
        if spec.type == "Dropout":
            y = fn({}, [torch.ones((rows, 4096), device=net.device)], gen=net._draws(0, 0, 0, idx))
            kept = y != 0
            out.append((spec.name, float(kept.float().mean()), torch.unique(y[kept]).tolist()))
    return out


def phase_engine_caffenet(root: Path, card: str, device: str = "cuda") -> None:
    """E(a): CaffeNet at BVLC's widths trained through the pycaffe route:
    `compat.get_solver` over caffenet_solver.prototxt's SGD recipe at
    CAFFENET_BASE_LR (its lr and decay mults), colour-class frames through
    `set_input_arrays` (512
    for TRAIN, 500 for TEST), 50 steps with `GraphSolver.test` on the TEST
    net every 10; Dropout's keep rate on the card; the step timed as
    PoseSolver's (10 steps after 3 warm-up steps with CUDA events, then
    torch.profiler, and the peak memory). `device` other than cuda, with
    CAFFENET_BATCH and CAFFENET_STEPS cut, is for rehearsing the phase off
    the card (no times there)."""
    from deepcut_tpu_torch import compat

    net = caffenet_memory_net(root)
    recipe = "\n".join(ln for ln in CAFFENET_SOLVER.read_text().splitlines()
                       if ln.split(":")[0] not in ("net", "test_iter", "display", "max_iter",
                                                   "snapshot", "snapshot_prefix", "base_lr"))
    solver_path = root / "caffenet_memory_solver.prototxt"
    solver_path.write_text(f'net: "{net}"\ntest_iter: {CAFFENET_TEST_ITER}\ndisplay: 0\n'
                           f'max_iter: 1000\nsnapshot: 0\nrandom_seed: {SEED}\n'
                           f'base_lr: {CAFFENET_BASE_LR}\n{recipe}\n')
    gen = np.random.default_rng(SEED)
    train = color_frames(gen, 2 * CAFFENET_BATCH["TRAIN"])
    test = color_frames(gen, CAFFENET_TEST_ITER * CAFFENET_BATCH["TEST"])
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = compat.get_solver(str(solver_path), device=device)
    solver.net.set_input_arrays(*train)
    solver.test_nets[0].set_input_arrays(*test)
    graph = solver.net._net
    n_params = sum(v.numel() for e in graph.params.values() for v in e.values())
    losses, tests = [], []
    for it in range(1, CAFFENET_STEPS + 1):
        solver.step(1)
        losses.append(solver.smoothed_loss)
        if it % CAFFENET_TEST_EVERY == 0:
            tests.append((it, solver._solver.test()))
    secs = time.perf_counter() - t0
    first = losses[0]
    lowest = float(np.nanmin([np.mean(losses[i:i + 5]) for i in range(10, CAFFENET_STEPS - 4)]))
    best = max(r.get("accuracy", 0.0) for _, r in tests)
    # a pass's accuracy is k / frames, averaged from f32 batch means that sit
    # a rounding off k / 50: held on the count k, which is exact
    frames = CAFFENET_TEST_ITER * CAFFENET_BATCH["TEST"]
    best_frames = round(best * frames)
    log(f"E(a) CaffeNet (BVLC widths, fc8 1000, {n_params} params), compat.get_solver SGD "
        f"recipe, batch {CAFFENET_BATCH['TRAIN']} of 3x227x227 from set_input_arrays, "
        f"{CAFFENET_STEPS} steps in {secs:.1f} s: loss {first:.4f}, lowest 5-step mean after "
        f"step 10 {lowest:.4f} (held below {CAFFENET_LOSS_FALL} x the first); losses every 5 "
        + " ".join(f"{v:.3f}" for v in losses[::5])
        + f"; GraphSolver.test over {CAFFENET_TEST_ITER * CAFFENET_BATCH['TEST']} frames (step: "
        "accuracy, loss) " + ", ".join(f"{it}: {r.get('accuracy', float('nan')):.3f}, "
                                       f"{r.get('loss', float('nan')):.4g}" for it, r in tests)
        + f"; best accuracy {best:.3f}, {best_frames} of {frames} frames (held >= "
        f"{CAFFENET_MIN_ACCURACY}; chance "
        f"{1 / COLOR_CLASSES})")
    if not (math.isfinite(first) and lowest < CAFFENET_LOSS_FALL * first):
        raise AssertionError("E(a): CaffeNet's loss did not fall")
    if not best_frames >= CAFFENET_MIN_ACCURACY * frames:
        raise AssertionError("E(a): CaffeNet's test accuracy does not beat chance")
    rates = dropout_keep_rates(graph, CAFFENET_BATCH["TRAIN"])
    log("E(a) Dropout on the card, keep rate (held 0.5 +- 0.01) and kept values: "
        + "; ".join(f"{n} {r:.4f} {vals}" for n, r, vals in rates))
    if len(rates) != 2 or any(abs(r - 0.5) > DROPOUT_KEEP_TOL or vals != [2.0]
                              for _, r, vals in rates):
        raise AssertionError("E(a): Dropout's keep rate or scale is off")
    if not cuda:
        return
    ms = _events_ms(lambda: solver.step(1), iters=10, warmup=3)
    busy, ops, ranked = _device_profile(lambda: solver.step(1), steps=2, top=6)
    ENGINE_CAFFENET_TIMES.update(ms=ms, busy=busy)
    log(f"time [{card}]: train step (compat Solver.step -> GraphSolver), CaffeNet, batch "
        f"{CAFFENET_BATCH['TRAIN']} of 3x227x227, f32 (TF32 off), SGD: {ms:.3f} ms, "
        f"{CAFFENET_BATCH['TRAIN'] * 1000 / ms:.2f} img/s; device busy {busy:.3f} ms (profiler; "
        f"idle share {1 - busy / ms:.3f}), {ops:.0f} device ops per step; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"profile [{card}]: CaffeNet train step, top kernels (ms per step, launches): "
        + "; ".join(f"{name[:70]} {t:.3f} ms x{n:.0f}" for name, t, n in ranked))
    del solver, graph
    torch.cuda.empty_cache()


def engine_pose_prototxt(root: Path, cfg, batch) -> Path:
    """The DeeperCut deploy prototxt of `cfg` (`models.prototxt`) at the
    batch's canvas, with the heads' losses of examples/pose/pose_train.prototxt
    (SoftmaxWithLossVec with cross_entropy, SmoothL1Loss) over Input tops
    for the dense targets."""
    from deepcut_tpu_torch.models.prototxt import deepercut_deploy

    n, h, w = batch["image"].shape[:3]
    tops = ("part_score_targets", "part_score_weights", "locref_targets", "locref_weights")
    shapes = " ".join("shape { " + " ".join(f"dim: {d}" for d in (
        n, batch[t].shape[3], batch[t].shape[1], batch[t].shape[2])) + " }" for t in tops)
    losses = (
        'layer { name: "targets" type: "Input" ' + " ".join(f'top: "{t}"' for t in tops)
        + f" input_param {{ {shapes} }} }}\n"
        'layer { name: "part_loss" type: "SoftmaxWithLossVec" bottom: "fc_pose" '
        'bottom: "part_score_targets" bottom: "part_score_weights" top: "part_loss" '
        'softmax_with_loss_vec_param { cross_entropy: true } }\n'
        'layer { name: "locref_loss" type: "SmoothL1Loss" bottom: "loc_pred" '
        'bottom: "locref_targets" bottom: "locref_weights" top: "locref_loss" loss_weight: 1 }\n')
    path = root / f"resnet{sum(cfg.depths) * 3 + 2}_train.prototxt"
    path.write_text(deepercut_deploy(cfg, (n, 3, h, w)).to_proto_text() + "\n" + losses)
    return path


def phase_engine_pose(root: Path, card: str, device: str = "cuda", depth: int = 152,
                      size: int = 688) -> None:
    """E(b): the DeeperCut ResNet-`depth` graph (prototxt + the heads' losses)
    against PoseSolver: one step each from the same tamed weights on the same
    host batch (one 688x688 frame on the 704 canvas, dense host targets, the
    published recipe's SGD), f32 with TF32 off; the loss and the updated
    conv1 and heads' weights compared; both steps timed. `device`, `depth`
    and `size` other than the card's are for rehearsing off the card."""
    from deepcut_tpu_torch.core.graph import Net
    from deepcut_tpu_torch.models.convert import save_caffemodel
    from deepcut_tpu_torch.parallel.train_step import to_device
    from deepcut_tpu_torch.solver.solver import GraphSolver, PoseSolver, SolverParams
    from deepcut_tpu_torch.tools.cli import pose_data

    index = write_frames(root / "engine_frames", np.random.RandomState(SEED), 1, size, size)
    sp = SolverParams.from_prototxt(str(write_solver(root, index, "engine", 10 ** 6, 0,
                                                     display=0, no_jitter=True)))
    _, _, src, _ = pose_data(sp, host_targets=True, workers=0)
    try:
        batch = src.next_batch(1)
    finally:
        src.close()
    cfg = deepercut_config(depth, pairwise=False)
    weights = root / "engine_tamed.caffemodel"
    save_caffemodel(str(weights), tame_params(cfg))
    proto = engine_pose_prototxt(root, cfg, batch)
    dev = to_device(batch, device)
    mean = torch.tensor(MEAN_BGR_T, device=device).reshape(1, 3, 1, 1)
    staged = {k: v for k, v in dev.items() if k != "image"}
    staged["data"] = dev["image"].float() - mean
    quiet = dict(handle_signals=False, log=lambda *_: None)
    graph = GraphSolver(sp, Net(str(proto), weights=str(weights), phase="TRAIN",
                                compute_dtype=None, device=device), device=device, **quiet)
    graph.extra_inputs = staged
    pose = PoseSolver(sp, cfg, lambda: batch, net_params=tame_params(cfg), target_cfg=None,
                      device=device, **quiet)
    before = {n: pose.net_params[n]["w"].detach().clone() for n in ENGINE_POSE_BLOBS}
    graph.step(1)
    pose.step(1)
    lg, lp = graph._loss_window[-1], float(pose._loss_window[-1])
    rel = abs(lg - lp) / abs(lp)
    lines, bad = [], rel > ENGINE_POSE_LOSS_RTOL
    for n in ENGINE_POSE_BLOBS:
        wg, wp = graph.net.params[n]["w"].detach(), pose.net_params[n]["w"].detach()
        ug, up = before[n] - wg, before[n] - wp
        du = float((ug - up).abs().max() / up.abs().max())
        dw = float((wg - wp).abs().max() / wp.abs().max())
        lines.append(f"{n} update {du:.3g}, weights {dw:.3g}")
        bad |= not (du <= ENGINE_POSE_UPDATE_RTOL and dw <= ENGINE_POSE_WEIGHT_RTOL)
    log(f"E(b) ResNet-{depth} graph ({len(graph.net._plan)} layers, {proto.name}) against "
        f"PoseSolver, one SGD step on one {size}x{size} frame (canvas {batch['image'].shape[1]}), f32 "
        f"(TF32 off): loss {lg:.6f} against {lp:.6f}, relative {rel:.3g} (held to "
        f"{ENGINE_POSE_LOSS_RTOL}); max |d| over the blob's largest magnitude (held to "
        f"{ENGINE_POSE_UPDATE_RTOL} for the update, {ENGINE_POSE_WEIGHT_RTOL} for the weights): "
        + "; ".join(lines))
    if bad:
        raise AssertionError("E(b): the graph's step is off PoseSolver's")
    if device != "cuda":
        return
    for what, solver in ((f"GraphSolver.step (ResNet-{depth} prototxt + losses)", graph),
                         (f"PoseSolver.step (native ResNet-{depth})", pose)):
        torch.cuda.reset_peak_memory_stats()
        ms = _events_ms(lambda: solver.step(1), iters=10, warmup=3)
        busy, ops, _ = _device_profile(lambda: solver.step(1), steps=2)
        log(f"time [{card}]: train step {what}, one 688x688 frame (canvas "
            f"{batch['image'].shape[1]}), f32 (TF32 off), batch 1: {ms:.3f} ms, "
            f"{1000 / ms:.2f} img/s; device busy {busy:.3f} ms (profiler; idle share "
            f"{1 - busy / ms:.3f}), {ops:.0f} device ops per step; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del graph, pose
    torch.cuda.empty_cache()


def phase_engine(card: str) -> None:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_engine_") as tmp:
        phase_engine_caffenet(Path(tmp), card)
        phase_engine_pose(Path(tmp), card)


# -- D. the data slice ---------------------------------------------------------
PASCAL_TRAIN_VAL = ROOT / "examples/finetune_pascal_detection/pascal_finetune_trainval_test.prototxt"
POSE_TRAIN = ROOT / "examples/pose/pose_train.prototxt"
DATA_FRAMES = {"TRAIN": 256, "TEST": 100}   # D1's 256x256 PNG frames, COLOR_CLASSES classes
DATA_SIDE, DATA_NOISE = 256, 20.0
DATA_ITERS, DATA_SNAPSHOT, DATA_TEST_INTERVAL, DATA_TEST_ITER = 20, 10, 10, 2
DATA_TEST_ITERATIONS = 4          # D4's `cli test` batches of CAFFENET_BATCH["TEST"]
WINDOW_BATCH, WINDOW_FRAMES = 128, 64   # R-CNN's WindowData batch; frames in its window file
# D4: `cli test`'s loss in bf16 (every op of the stream rounded to bf16)
# against -fp32 on the same LevelDB batches, from the snapshot at iteration
# 20. Written before the first run: the loss is a mean over 200 frames of
# -log p, each logit carrying the roundings of 8 layers (~2^-9 relative
# each), and phase G holds CaffeNet's bf16 outputs within a few bf16 steps of
# f32 at their scale: the loss within 8 bf16 steps at its magnitude.
DATA_TEST_LOSS_STEPS = 8
ENGINE_CAFFENET_TIMES: dict = {}   # phase E(a)'s MemoryData step, beside D7's


def _du(path: Path) -> float:
    """MB on disk under path."""
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 1e6


def data_frames(root: Path, gen: np.random.Generator, split: str) -> Path:
    """DATA_FRAMES[split] seeded DATA_SIDE x DATA_SIDE colour-class PNG
    frames (class k's BGR mean a corner of a cube around grey, +-COLOR_MEAN,
    under noise of std DATA_NOISE) -> their `path label` list file."""
    from PIL import Image

    n = DATA_FRAMES[split]
    labels = np.arange(n) % COLOR_CLASSES
    corners = (np.array([[(k >> c) & 1 for c in range(3)] for k in range(COLOR_CLASSES)],
                        np.float32) * 2.0 - 1.0) * COLOR_MEAN + 128.0
    frames = np.clip(gen.normal(0.0, DATA_NOISE, (n, DATA_SIDE, DATA_SIDE, 3))
                     + corners[labels][:, None, None, :], 0, 255).astype(np.uint8)
    (root / split).mkdir(exist_ok=True)
    paths = [root / split / f"{i:04d}.png" for i in range(n)]

    def save(i):   # BGR frames, stored as RGB PNGs
        Image.fromarray(np.ascontiguousarray(frames[i][:, :, ::-1])).save(paths[i], compress_level=1)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(save, range(n)))
    listing = root / f"{split.lower()}.txt"
    listing.write_text("".join(f"{p} {k}\n" for p, k in zip(paths, labels)))
    return listing


def caffenet_data_net(root: Path, name: str = "data", mutate=None) -> Path:
    """examples/imagenet/caffenet_train_val.prototxt at BVLC's widths through
    its Data layers: TRAIN from D1's LMDB (batch 256), TEST from its LevelDB
    (batch 50), crop 227, TRAIN mirrored, D1's mean file, fc8 at 1000;
    ``mutate(layer, phase)`` may rewrite a data layer further."""
    from deepcut_tpu_torch.proto import text_format

    net = text_format.parse_file(str(CAFFENET_TRAIN_VAL))
    for layer in net.get_list("layer"):
        if layer.get_str("type") == "Data":
            phase = layer.get("include").get_str("phase")
            dp = layer.get("data_param")
            dp.fields["source"] = [str(root / ("train_lmdb" if phase == "TRAIN" else "val_leveldb"))]
            dp.fields["batch_size"] = [CAFFENET_BATCH[phase]]
            dp.fields["backend"] = ["LMDB" if phase == "TRAIN" else "LEVELDB"]
            layer.get("transform_param").fields["mean_file"] = [str(root / "mean.binaryproto")]
            if mutate is not None:
                mutate(layer, phase)
        if layer.get_str("name") == "fc8":
            layer.get("inner_product_param").fields["num_output"] = [1000]
    path = root / f"caffenet_{name}_train_val.prototxt"
    path.write_text(text_format.dump(net) + "\n")
    return path


def data_solver(root: Path, net: Path, name: str, **sets) -> Path:
    """caffenet_solver.prototxt's SGD recipe over `net` at CAFFENET_BASE_LR: D2's
    20 iterations, a test pass of 2 batches every 10 (none at iteration 0),
    a snapshot every 10 under root/name/, a loss line each iteration; `sets`
    override."""
    recipe = [ln for ln in CAFFENET_SOLVER.read_text().splitlines()
              if ln.split(":")[0] not in ("net", "test_iter", "test_interval", "display",
                                          "max_iter", "snapshot", "snapshot_prefix", "base_lr")]
    fields = dict(net=f'"{net}"', base_lr=CAFFENET_BASE_LR, test_iter=DATA_TEST_ITER,
                  test_interval=DATA_TEST_INTERVAL,
                  test_initialization="false", display=1, max_iter=DATA_ITERS,
                  snapshot=DATA_SNAPSHOT, snapshot_prefix=f'"{root / name / "caffenet"}"',
                  random_seed=SEED)
    fields.update(sets)
    path = root / f"{name}_solver.prototxt"
    path.write_text("\n".join([f"{k}: {v}" for k, v in fields.items()] + recipe) + "\n")
    return path


@contextlib.contextmanager
def _solver_records():
    """GraphSolver.snapshot and .restore wrapped to keep host copies of the
    momentum each snapshot writes and of the params a restore leaves:
    {"history": {iter: tree}, "types": layer types, "restored": [(iter,
    params)]}."""
    from deepcut_tpu_torch.solver.solver import GraphSolver

    rec = {"history": {}, "restored": [], "types": None}
    snapshot, restore = GraphSolver.snapshot, GraphSolver.restore

    def host(tree):
        return {n: {k: v.detach().cpu().clone() for k, v in e.items()} for n, e in tree.items()}

    def snapshot_kept(self, *args, **kw):
        rec["history"][self.iter] = host(self.state["history"])
        rec["types"] = self.net.layer_types()
        return snapshot(self, *args, **kw)

    def restore_kept(self, path):
        restore(self, path)
        rec["restored"].append((self.iter, host(self.net.params)))
    GraphSolver.snapshot, GraphSolver.restore = snapshot_kept, restore_kept
    try:
        yield rec
    finally:
        GraphSolver.snapshot, GraphSolver.restore = snapshot, restore


def _pulled(net) -> dict:
    """One batch of a net's data layers, on the net's device as a step takes it."""
    host: dict = {}
    net._pull_data_layers(host)
    return {k: torch.as_tensor(np.asarray(v)).to(net.device) for k, v in host.items()}


def _check_tops(what: str, tops: dict, shapes: dict, span: float, labels) -> None:
    """A data layer's tops on the card: shape, f32, finite; the data within
    +-span and not constant; integral labels in `labels`, two at least."""
    for name, shape in shapes.items():
        t = tops[name]
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{what}: top {name} {tuple(t.shape)} {t.dtype}, want {shape} f32")
    data, label = tops["data"], tops["label"]
    lo, hi = float(data.min()), float(data.max())
    if not (-span <= lo < hi <= span and float(data.std()) > 1.0):
        raise AssertionError(f"{what}: data in [{lo}, {hi}]")
    got = set(torch.unique(label).tolist())
    if not got <= set(float(v) for v in labels) or len(got) < 2:
        raise AssertionError(f"{what}: labels {sorted(got)} outside {sorted(labels)}")
    log(f"D5 {what}: tops " + ", ".join(f"{k} {tuple(tops[k].shape)}" for k in shapes)
        + f" f32 on {data.device}, data in [{lo:.1f}, {hi:.1f}], labels {sorted(got)}")


def window_file(root: Path, listing: Path) -> Path:
    """An R-CNN window file over the first WINDOW_FRAMES frames of `listing`:
    per frame two windows of its class (overlap 0.8 and 0.6) and one of
    background (0.1), some reaching past the frame's edge; the classes are
    1..COLOR_CLASSES of fc8_pascal's 21."""
    rng = np.random.RandomState(SEED)
    lines = []
    for i, ln in enumerate(listing.read_text().splitlines()[:WINDOW_FRAMES]):
        path, label = ln.rsplit(None, 1)
        boxes = []
        for cls, overlap in ((int(label) + 1, 0.8), (int(label) + 1, 0.6), (0, 0.1)):
            x1, y1 = (int(v) for v in rng.randint(-20, DATA_SIDE // 2, 2))
            w, h = (int(v) for v in rng.randint(40, DATA_SIDE // 2 + 40, 2))
            boxes.append(f"{cls} {overlap} {x1} {y1} {x1 + w} {y1 + h}")
        lines += [f"# {i}", path, f"3 {DATA_SIDE} {DATA_SIDE}", str(len(boxes))] + boxes
    path = root / "windows.txt"
    path.write_text("\n".join(lines) + "\n")
    return path


def _expect_h5py_import_error(what: str, fn) -> None:
    """`fn` must raise ImportError naming h5py (the HDF5 paths where h5py is
    missing); `what` names the phase and the path."""
    try:
        fn()
    except ImportError as e:
        if "h5py" not in str(e):
            raise AssertionError(f"{what}: ImportError without h5py's name: {e}") from e
        log(f"{what}: ImportError naming h5py ({e})")
        return
    raise AssertionError(f"{what}: no ImportError without h5py")


def phase_data(root: Path, rng, device: str = "cuda") -> dict:
    """D: the data slice. D1 builds the datasets with the port's own tools;
    D2 trains CaffeNet through `cli train` from the LMDB, tests from the
    LevelDB, snapshots, and `parse_log` reads the log back; D3 checks the
    .solverstate against the momentum it was written from and resumes from
    it; D4 runs `cli test` in bf16 (conv_epilogue) and f32; D5 runs
    ImageData, WindowData and PoseData; D6 the HDF5 paths, or their
    ImportError where h5py is missing. Returns what D7's times need.
    `device` other than cuda, with DATA_FRAMES, CAFFENET_BATCH,
    WINDOW_BATCH and WINDOW_FRAMES cut, is for rehearsing it off the card."""
    from deepcut_tpu_torch.core.graph import Net
    from deepcut_tpu_torch.data.pipeline import PoseDataSource
    from deepcut_tpu_torch.models.convert import graph_params_to_numpy
    from deepcut_tpu_torch.proto import text_format
    from deepcut_tpu_torch.proto.caffemodel import decode_solverstate, load_caffemodel
    from deepcut_tpu_torch.solver.solver import GraphSolver, SolverParams
    from deepcut_tpu_torch.tools import cli, datasets
    from deepcut_tpu_torch.tools.parse_log import parse_log, parse_test_log

    t0 = time.perf_counter()
    gen = np.random.default_rng(SEED)
    train_list, val_list = data_frames(root, gen, "TRAIN"), data_frames(root, gen, "TEST")
    for argv in (["convert_imageset", str(train_list), str(root / "train_lmdb")],
                 ["convert_imageset", str(val_list), str(root / "val_leveldb"),
                  "--backend", "leveldb"],
                 ["compute_image_mean", str(root / "train_lmdb"), str(root / "mean.binaryproto")]):
        if datasets.main(argv) != 0:
            raise AssertionError(f"D1: datasets {argv[0]} failed")
    t1 = time.perf_counter()
    log(f"D1 {DATA_FRAMES['TRAIN']} + {DATA_FRAMES['TEST']} seeded {DATA_SIDE}x{DATA_SIDE} PNG "
        f"frames ({COLOR_CLASSES} classes) -> train LMDB {_du(root / 'train_lmdb'):.1f} MB, val "
        f"LevelDB {_du(root / 'val_leveldb'):.1f} MB, mean.binaryproto: {t1 - t0:.1f} s")

    # D2: cli train from the LMDB, tested on the LevelDB, snapshots; the log read back
    net = caffenet_data_net(root)
    train_log = root / "train.log"
    with _solver_records() as rec:
        with open(train_log, "w") as logf, contextlib.redirect_stdout(_Tee(sys.stdout, logf)):
            if cli.main(["train", "-solver", str(data_solver(root, net, "snap")),
                         "-device", device]) != 0:
                raise AssertionError("D2: cli train failed")
        t2 = time.perf_counter()
        rows, tests = parse_log(str(train_log)), parse_test_log(str(train_log))
        stepped = [r for r in rows if "LearningRate" in r]
        log(f"D2 cli train, CaffeNet (BVLC widths, fc8 1000), batch {CAFFENET_BATCH['TRAIN']} from "
            f"the LMDB, f32 (TF32 off): {DATA_ITERS} iterations in {t2 - t1:.1f} s; parse_log: "
            f"{len(stepped)} train losses " + " ".join(f"{r.get('loss', float('nan')):.3f}"
                                                       for r in stepped)
            + "; test rows (iteration: accuracy, loss) " + ", ".join(
                f"{r['NumIters']:.0f}: {r.get('accuracy', float('nan')):.3f}, "
                f"{r.get('loss', float('nan')):.4g}" for r in tests))
        if len(stepped) != DATA_ITERS or not all(math.isfinite(r.get("loss", math.nan))
                                                 for r in stepped):
            raise AssertionError(f"D2: {len(stepped)} train losses, want {DATA_ITERS} finite")
        if ([r["NumIters"] for r in tests] != [DATA_TEST_INTERVAL, DATA_ITERS] or not all(
                {"accuracy", "loss"} <= set(r) and math.isfinite(r["loss"]) for r in tests)):
            raise AssertionError(f"D2: test rows {tests}")

        # D3: the .solverstate at 10 holds the momentum of iteration 10; resume from it
        snap10 = root / "snap" / f"caffenet_iter_{DATA_SNAPSHOT}"
        it, learned, blobs, _ = decode_solverstate(snap10.with_suffix(".solverstate").read_bytes())
        held = graph_params_to_numpy(rec["history"][DATA_SNAPSHOT], rec["types"])
        want = [held[n][k] for n in sorted(held) for k in sorted(held[n])]
        if ((it, learned) != (DATA_SNAPSHOT, f"{snap10}.caffemodel") or len(blobs) != len(want)
                or not all(np.array_equal(b.data.reshape(w.shape), w) for b, w in zip(blobs, want))):
            raise AssertionError(f"D3: solverstate iter {it}, learned_net {learned}, {len(blobs)} "
                                 f"blobs for {len(want)}: not the momentum of iteration 10")
        out, _ = run_verb(["train", "-solver", str(data_solver(root, net, "resume")),
                           "-snapshot", f"{snap10}.solverstate", "-device", device])
        resumed = [float(ln.split("loss = ")[1].split()[0].rstrip(",")) for ln in out.splitlines()
                   if ln.startswith("Iteration ") and "loss = " in ln]
    (r_iter, r_params), = rec["restored"]
    model = load_caffemodel(f"{snap10}.caffemodel")
    same = all(np.array_equal(r_params[n][k].numpy(), b.data.reshape(tuple(r_params[n][k].shape)))
               for n, bs in model.items() for k, b in zip(r_params[n], bs))
    done = (root / "resume" / f"caffenet_iter_{DATA_ITERS}.caffemodel").is_file()
    log(f"D3 .solverstate at {it}: {len(blobs)} history blobs bit-equal to the solver's momentum "
        f"at iteration {DATA_SNAPSHOT}, learned_net {Path(learned).name}; cli train -snapshot "
        f"resumed at iteration {r_iter}, weights equal to the .caffemodel's: {same}, finished: {done}")
    if (r_iter != DATA_SNAPSHOT or not same or not done or "Optimization Done." not in out
            or len(resumed) != DATA_ITERS - DATA_SNAPSHOT + 1
            or not all(math.isfinite(v) for v in resumed)):
        raise AssertionError("D3: the resume from the .solverstate failed")

    # D4: cli test from the LevelDB, bf16 (conv_epilogue) and -fp32
    weights = root / "snap" / f"caffenet_iter_{DATA_ITERS}.caffemodel"
    got = {}
    for label, flags in (("bf16", []), ("f32", ["-fp32"])):
        out, _ = run_verb(["test", "-model", str(net), "-weights", str(weights), "-iterations",
                           str(DATA_TEST_ITERATIONS), "-device", device] + flags)
        got[label] = _printed(out)
    gap = abs(got["bf16"]["loss"] - got["f32"]["loss"]) / _bf16_step(abs(got["f32"]["loss"]))
    log(f"D4 cli test, {DATA_TEST_ITERATIONS} batches of {CAFFENET_BATCH['TEST']} from the "
        f"LevelDB: bf16 {got['bf16']}, f32 {got['f32']}; loss {gap:.2f} bf16 steps apart (held "
        f"<= {DATA_TEST_LOSS_STEPS})")
    if sorted(got["bf16"]) != ["accuracy", "loss"] or not gap <= DATA_TEST_LOSS_STEPS:
        raise AssertionError("D4: bf16 and f32 cli test disagree")

    # D5: ImageData and WindowData feed two GraphSolver steps each; a PoseData batch
    def image_data(layer, phase):
        if phase == "TRAIN":
            layer.fields["type"] = ["ImageData"]
            layer.fields.pop("data_param")
            ip = text_format.parse(
                f'source: "{train_list}" batch_size: {CAFFENET_BATCH["TRAIN"]} shuffle: true '
                f'new_height: {DATA_SIDE} new_width: {DATA_SIDE}')
            layer.add("image_data_param", ip)
    pascal = text_format.parse_file(str(PASCAL_TRAIN_VAL))
    windows = window_file(root, train_list)
    for layer in pascal.get_list("layer"):
        if layer.get_str("type") == "WindowData":
            layer.get("window_data_param").fields["source"] = [str(windows)]
            layer.get("window_data_param").fields["batch_size"] = [WINDOW_BATCH]
            layer.get("transform_param").fields["mean_file"] = [str(root / "mean.binaryproto")]
    (root / "pascal_train_val.prototxt").write_text(text_format.dump(pascal) + "\n")
    solvers = {}
    for what, proto, batch, labels in (
            ("ImageData", caffenet_data_net(root, "image", image_data), CAFFENET_BATCH["TRAIN"],
             range(COLOR_CLASSES)),
            ("WindowData", root / "pascal_train_val.prototxt", WINDOW_BATCH,
             range(COLOR_CLASSES + 1))):
        sp = SolverParams.from_prototxt(str(data_solver(
            root, proto, what.lower(), test_iter=0, test_interval=0, snapshot=0, display=0)))
        s = GraphSolver(sp, device=device, log=lambda *_: None, handle_signals=False)
        _check_tops(what, _pulled(s.net), {"data": (batch, 3, 227, 227), "label": (batch,)},
                    255.0, labels)
        losses = []
        for _ in range(2):
            s.step(1)
            losses.append(s.smoothed_loss)
        log(f"D5 {what}: 2 GraphSolver steps, losses {losses[0]:.4f} {losses[1]:.4f}")
        if s.iter != 2 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"D5 {what}: the steps failed")
        s.close()
        solvers[what] = s
    index = write_frames(root / "pose", rng, 2, 240, 320)
    node = next(ly for ly in text_format.parse_file(str(POSE_TRAIN)).get_list("layer")
                if ly.get_str("type") == "PoseData")
    node.get("pose_data_param").fields["source"] = [str(index)]
    node.get("pose_data_param").fields["batch_size"] = [2]
    pose_net = Net(text_format.parse(f"name: \"pose_data\"\nlayer {{\n{text_format.dump(node)}\n}}\n"),
                   phase="TRAIN", compute_dtype=None, device=device)
    tops = _pulled(pose_net)
    pose_net.close()
    tcfg, pp = cli._target_config_from_layer(node)
    direct = PoseDataSource(str(index), tcfg, None, root_folder=pp.get_str("root_folder", ""),
                            cycle=pp.get_bool("cycle_training_data", False)).next_batch(2)
    keys = ["image", "part_score_targets", "part_score_weights", "locref_targets", "locref_weights"]
    names = [str(t) for t in node.get_list("top")]
    equal = all(torch.equal(tops[nm], torch.as_tensor(direct[k].transpose(0, 3, 1, 2)).to(device))
                for nm, k in zip(names, keys))
    log(f"D5 PoseData: tops " + ", ".join(f"{nm} {tuple(tops[nm].shape)}" for nm in names)
        + f" on {tops[names[0]].device}, bit-equal to PoseDataSource(seed 0): {equal}")
    if not equal or set(tops) != set(names):
        raise AssertionError("D5: the PoseData layer's tops differ from PoseDataSource's")

    # D6: the HDF5 paths, or their ImportError where h5py is missing
    blobs_out = root / "features.h5"
    sink_net = text_format.parse_file(str(net))
    sink_net.add("layer", text_format.parse(
        'name: "sink" type: "HDF5Output" bottom: "fc8" bottom: "label" '
        f'include {{ phase: TEST }} hdf5_output_param {{ file_name: "{root / "sink.h5"}" }}'))
    s = solvers["ImageData"]
    s.params_cfg.snapshot_format = "HDF5"
    s.params_cfg.snapshot_prefix = str(root / "h5" / "caffenet")
    (root / "h5").mkdir(exist_ok=True)
    feature_argv = ["extract_features", "-model", str(net), "-weights", str(weights), "-blobs",
                    "fc8,pool5", "-iterations", "2", "-out", str(blobs_out), "-device", device]

    def sink_save():
        snet = Net(sink_net, weights=str(weights), phase="TEST", device=device)
        snet.forward()
        snet.close()
        snet.hdf5_sinks[0].save()
    try:
        import h5py
    except ImportError:
        h5py = None
    if h5py is None:
        _expect_h5py_import_error("D6 extract_features", lambda: run_verb(feature_argv))
        _expect_h5py_import_error("D6 HDF5Output sink save", sink_save)
        _expect_h5py_import_error("D6 snapshot_format: HDF5", s.snapshot)
    else:
        run_verb(feature_argv)
        sink_save()
        s.snapshot()
        with h5py.File(blobs_out, "r") as f, h5py.File(root / "sink.h5", "r") as g:
            shapes = {k: f[k].shape for k in f} | {f"sink {k}": g[k].shape for k in g}
        log(f"D6 h5py {h5py.__version__}: extract_features, HDF5Output and the HDF5 snapshot "
            f"wrote {shapes}, {sorted(p.name for p in (root / 'h5').iterdir())}")
    del solvers, s
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"D phase: {time.perf_counter() - t0:.1f} s")
    return {"net": net, "weights": weights, "windows": windows, "root": root}


def data_times(d: dict, card: str) -> None:
    """D7: the Data-layer train step of D2's net (CUDA events over 10 steps
    after 3, device busy from the profiler over 2 more) beside E(a)'s
    MemoryData step on the same net; the host milliseconds of one
    LMDBDataSource batch of 256 and one WindowDataSource batch of 128; and
    `cli test`'s bf16 forward per batch of 50 from the LevelDB (its
    `_forwards`: the data pulled, the bf16 stream, the outputs back)."""
    from deepcut_tpu_torch.core.graph import LayerSpec, Net
    from deepcut_tpu_torch.data.layers import LMDBDataSource, WindowDataSource
    from deepcut_tpu_torch.proto import text_format
    from deepcut_tpu_torch.solver.solver import GraphSolver, SolverParams
    from deepcut_tpu_torch.tools.cli import _forwards

    sp = SolverParams.from_prototxt(str(data_solver(d["root"], d["net"], "timed", test_iter=0,
                                                    test_interval=0, snapshot=0, display=0)))
    solver = GraphSolver(sp, device="cuda", log=lambda *_: None, handle_signals=False)
    ms = _events_ms(lambda: solver.step(1), iters=10, warmup=3)
    busy, ops, ranked = _device_profile(lambda: solver.step(1), steps=2, top=4)
    solver.close()
    mem = ENGINE_CAFFENET_TIMES
    log(f"time [{card}]: D7 train step, CaffeNet from the LMDB (Data layer, prefetch thread), "
        f"batch {CAFFENET_BATCH['TRAIN']}, f32 (TF32 off): {ms:.3f} ms, "
        f"{CAFFENET_BATCH['TRAIN'] * 1000 / ms:.2f} img/s; device busy {busy:.3f} ms (idle share "
        f"{1 - busy / ms:.3f}), {ops:.0f} device ops; E(a)'s MemoryData step on the same net: "
        f"{mem.get('ms', float('nan')):.3f} ms, busy {mem.get('busy', float('nan')):.3f} ms")
    log(f"profile [{card}]: D7 Data-layer train step, top kernels (ms per step, launches): "
        + "; ".join(f"{name[:70]} {t:.3f} ms x{n:.0f}" for name, t, n in ranked))
    del solver
    torch.cuda.empty_cache()
    train_data = next(ly for ly in text_format.parse_file(str(d["net"])).get_list("layer")
                      if ly.get_str("type") == "Data" and ly.get("include").get_str("phase") == "TRAIN")
    lmdb = LMDBDataSource(LayerSpec(train_data), "TRAIN")
    window = WindowDataSource(LayerSpec(text_format.parse(
        'layer { name: "w" type: "WindowData" top: "data" top: "label" '
        f'window_data_param {{ source: "{d["windows"]}" batch_size: {WINDOW_BATCH} '
        'fg_threshold: 0.5 bg_threshold: 0.5 fg_fraction: 0.25 context_pad: 16 } '
        f'transform_param {{ mirror: true crop_size: 227 mean_file: "{d["root"] / "mean.binaryproto"}" }} }}'
    ).get_list("layer")[0]), "TRAIN")
    host = {}
    for what, src in (("LMDBDataSource", lmdb), ("WindowDataSource", window)):
        src.next_batch()
        t0 = time.perf_counter()
        for _ in range(3):
            src.next_batch()
        host[what] = (time.perf_counter() - t0) * 1000 / 3
    batches = _forwards(Net(str(d["net"]), weights=str(d["weights"]), phase="TEST", device="cuda"),
                        1 + DATA_TEST_ITERATIONS + 4)   # the profile's 2 + 2
    next(batches)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DATA_TEST_ITERATIONS):
        next(batches)
    test_ms = (time.perf_counter() - t0) * 1000 / DATA_TEST_ITERATIONS
    busy_t, ops_t, _ = _device_profile(lambda: next(batches), steps=2)
    batches.close()
    log(f"time [{card}]: D7 host ms per batch (read, Datum.decode, transform, stack): "
        f"LMDBDataSource batch {CAFFENET_BATCH['TRAIN']} {host['LMDBDataSource']:.3f} ms; "
        f"WindowDataSource batch {WINDOW_BATCH} {host['WindowDataSource']:.3f} ms; cli test's "
        f"bf16 forward from the LevelDB (make_forward, the outputs to the host), batch "
        f"{CAFFENET_BATCH['TEST']}: {test_ms:.3f} ms, device busy {busy_t:.3f} ms (idle share "
        f"{1 - busy_t / test_ms:.3f}), {ops_t:.0f} device ops")


# -- X. the examples' front ends --------------------------------------------------
EXAMPLE_REQUESTS = 20        # X1's sequential 688x688 requests per mode
EXAMPLE_BURST = 8            # X1's concurrent requests under --batch-window
EXAMPLE_WINDOW_MS = 4.0      # the service's --batch-window
EXAMPLE_FIRST_CALLS = 4      # X1's concurrent first requests on a fresh service
LENET_ITERATIONS = 50        # X5's `cli train` iterations
LENET_LOSS_FALL = 0.5        # X5: the last logged loss under half the first


def _on_threads(fn, items, together: bool) -> list:
    """fn(item) for each item on a new thread each: all started together
    behind a barrier, or one after another; -> [(result, ms)]."""
    out = [None] * len(items)
    start = threading.Barrier(len(items) if together else 1)

    def run(i):
        start.wait(timeout=600)
        t0 = time.perf_counter()
        result = fn(items[i])
        out[i] = (result, (time.perf_counter() - t0) * 1e3)

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(len(items))]
    for t in threads:
        t.start()
        if not together:
            t.join(timeout=600)
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads) or None in out:
        raise AssertionError("a thread did not finish")
    return out


def _json_pose(pose: np.ndarray) -> list:
    """A pose as the pose service rounds it into its JSON answer."""
    return [[round(float(v), 4) for v in row] for row in np.asarray(pose, np.float64)]


def _launches_since(before: dict) -> dict:
    now = _counts()
    return {k: now[k] - before[k] for k in now}


def _add(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def _pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def phase_examples_pose(root: Path, rng, card: str, int8: bool, served: dict,
                        device: str = "cuda", size: int = 688, hd=(720, 1280)) -> None:
    """X1, one mode: the port's pose service started through its default
    path (`PoseApp(model_bin=...)`, no estimator given: `get_estimator`'s,
    a private copy of it with --int8), four concurrent first requests, the
    timed sequential ones, an HD frame (the tiled path), then a second
    service with --batch-window and its concurrent bursts. The launches of
    the served requests are added to `served`; the in-process
    `estimate_pose` references run after them, outside the count."""
    from deepcut_tpu_torch.examples.pose import serve
    from deepcut_tpu_torch.pose.estimate import get_estimator

    what = "int8" if int8 else "bf16"
    weights = root / "resnet152_tamed.caffemodel"
    frames = [frame(rng, size, size) for _ in range(EXAMPLE_REQUESTS)]
    uploads = [_png_body(f) for f in frames]
    hd_frame = frame(rng, *hd)
    before = _counts()
    t0 = time.perf_counter()
    app = serve.PoseApp(model_bin=str(weights), int8=int8, device=device)
    load_s = time.perf_counter() - t0
    httpd = serve.serve(app, port=0, background=True)
    port = httpd.server_address[1]
    try:
        with ThreadPoolExecutor(EXAMPLE_FIRST_CALLS) as pool:
            first = list(pool.map(lambda u: _post(port, "/estimate", u),
                                  uploads[:EXAMPLE_FIRST_CALLS]))
        answers, latency = [], []
        for upload in uploads:
            t0 = time.perf_counter()
            answers.append(_post(port, "/estimate", upload))
            latency.append((time.perf_counter() - t0) * 1e3)
        hd_answer = _post(port, "/estimate", _png_body(hd_frame))
    finally:
        httpd.shutdown()
        httpd.server_close()
    _add(served, _launches_since(before))
    if app.est.is_int8 != int8 or get_estimator("", str(weights), device).is_int8:
        raise AssertionError(f"X1 {what}: --int8 must quantize the service's own copy of the "
                             "cached estimator, and only it")
    direct_ms, exact = [], 0
    for f, ans in zip(frames, answers):
        t0 = time.perf_counter()
        pose = app.est.estimate_pose(f)
        direct_ms.append((time.perf_counter() - t0) * 1e3)
        exact += ans["pose"] == _json_pose(pose)
    for f, ans in zip(frames, first):
        exact += ans["pose"] == _json_pose(app.est.estimate_pose(f))
    if exact != len(answers) + len(first):
        raise AssertionError(f"X1 {what}: {exact} of {len(answers) + len(first)} served poses "
                             "equal estimate_pose's after the JSON rounding")
    if hd_answer["pose"] != _json_pose(app.est.estimate_pose(hd_frame)):
        raise AssertionError(f"X1 {what}: the HD frame's served pose differs from estimate_pose's")
    # where a request's time goes: the app without HTTP (PNG decode, the
    # runner thread, JSON), and estimate_pose on a new thread per call, as a
    # service calling it from its handler threads would (PyTorch caches
    # cuDNN's execution plans per thread); four new threads at once must
    # give the serial poses (the estimator's state is shared)
    app_ms = []
    for f in frames:
        png = _png(f)
        t0 = time.perf_counter()
        app.estimate_bytes(png)
        app_ms.append((time.perf_counter() - t0) * 1e3)
    fresh = _on_threads(app.est.estimate_pose, frames[:EXAMPLE_FIRST_CALLS], together=False)
    together = _on_threads(app.est.estimate_pose, frames[:EXAMPLE_FIRST_CALLS], together=True)
    serial = [app.est.estimate_pose(f) for f in frames[:EXAMPLE_FIRST_CALLS]]
    for (alone, _), (at_once, _), ref in zip(fresh, together, serial):
        if not (np.array_equal(alone, ref) and np.array_equal(at_once, ref)):
            raise AssertionError(f"X1 {what}: estimate_pose on new threads differs from the "
                                 "serial poses")
    log(f"X1 [{card}] pose service, {what}, default path (model load {load_s:.2f} s"
        f"{', int8 calibrated on the first request' if int8 else ''}): "
        f"{EXAMPLE_FIRST_CALLS} concurrent first requests, {len(answers)} sequential {size}x{size} "
        f"requests and one {hd[0]}x{hd[1]} (tiled) request, every pose equal to estimate_pose's after "
        f"the JSON rounding; request latency median {_pct(latency, 50):.3f} ms, p90 "
        f"{_pct(latency, 90):.3f} ms (min {min(latency):.3f}, max {max(latency):.3f}); "
        f"estimate_pose on the same frames in process: median {_pct(direct_ms, 50):.3f} ms, p90 "
        f"{_pct(direct_ms, 90):.3f} ms; HTTP, PNG decode and JSON take "
        f"{_pct(latency, 50) - _pct(direct_ms, 50):.3f} ms of the median; the app's "
        f"estimate_bytes without HTTP (PNG decode, the runner thread, JSON): median "
        f"{_pct(app_ms, 50):.3f} ms; estimate_pose on a new thread per call: "
        f"{', '.join(f'{ms:.3f}' for _, ms in fresh)} ms (cold per-thread cuDNN plans), "
        f"four new threads at once: {', '.join(f'{ms:.3f}' for _, ms in together)} ms, "
        f"poses equal to the serial ones")

    before = _counts()
    appb = serve.PoseApp(model_bin=str(weights), int8=int8, batch_window_ms=EXAMPLE_WINDOW_MS,
                         device=device)
    httpd = serve.serve(appb, port=0, background=True)
    port = httpd.server_address[1]
    # the batcher's batches, recorded: their composition depends on arrival
    # order, and cuDNN's sums (so bf16's roundings) on the batch size
    batches = []
    many = appb.est.estimate_pose_many

    def recorded(images, scale=1.0):
        poses = many(images, scale)
        batches.append((list(images), scale, poses))
        return poses

    appb.est.estimate_pose_many = recorded
    bursts = []
    try:
        for _ in range(2):   # the first burst meets the batch shapes (and int8's calibration)
            batches.clear()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(EXAMPLE_BURST) as pool:
                burst = list(pool.map(lambda u: _post(port, "/estimate", u),
                                      uploads[:EXAMPLE_BURST]))
            bursts.append((time.perf_counter() - t0, burst))
    finally:
        httpd.shutdown()
        httpd.server_close()
        del appb.est.estimate_pose_many
    _add(served, _launches_since(before))
    # each served pose is its batch's, after the JSON rounding, and each
    # batch run again gives the same poses; beside them, how far batching
    # moved each pose from estimate_pose's on the frame alone
    served_by = [(img, pose) for images, _, poses in batches for img, pose in zip(images, poses)]
    for images, scale, poses in batches:
        if not np.array_equal(many(images, scale), poses):
            raise AssertionError(f"X1 {what}: a batch of {len(images)} run again differs")
    same, dconf, cells = 0, 0.0, 0
    for f, ans in zip(frames, bursts[-1][1]):
        pose = next(p for img, p in served_by if np.array_equal(img, f))
        if ans["pose"] != _json_pose(pose):
            raise AssertionError(f"X1 {what}: a burst's served pose differs from its batch's")
        alone = appb.est.estimate_pose(f)
        same += ans["pose"] == _json_pose(alone)
        dconf = max(dconf, float(np.abs(pose[2] - alone[2]).max()))
        cells += int(np.all(cell_of(pose) == cell_of(alone), axis=0).sum())
    log(f"X1 [{card}] pose service, {what}, --batch-window {EXAMPLE_WINDOW_MS:g}: bursts of "
        f"{EXAMPLE_BURST} concurrent {size}x{size} requests, {EXAMPLE_BURST / bursts[0][0]:.2f} then "
        f"{EXAMPLE_BURST / bursts[1][0]:.2f} img/s ({bursts[1][0] * 1e3:.3f} ms for the "
        f"second); {appb.batcher.batches_run} batches for {appb.batcher.images_run} images, the "
        f"second burst's {[len(images) for images, _, _ in batches]}; every served pose equal to "
        f"its batch's after the JSON rounding, every batch run again equal; against "
        f"estimate_pose on each frame alone: {same} of {len(bursts[-1][1])} equal after the "
        f"rounding, argmax cell on {cells} of {len(bursts[-1][1]) * J} joints, max |dconf| "
        f"{dconf:.4g}")


def phase_examples_web(root: Path, rng, card: str, weights: Path, device: str = "cuda") -> dict:
    """X2: the web demo on G1's CaffeNet: its top-5 against the port's
    Classifier (center crop, f32) on the same upload."""
    from PIL import Image
    from deepcut_tpu_torch.classifier import Classifier
    from deepcut_tpu_torch.examples.web_demo import app as web

    before = _counts()
    labels = [f"synset_{i}" for i in range(COLOR_CLASSES)]
    demo = web.ClassifierApp(str(CAFFENET), str(weights), mean=IMAGENET_MEAN_BGR,
                             labels=labels, device=device)
    httpd = web.serve(demo, port=0, background=True)
    imgs = [frame(rng, 300, 400), frame(rng, 480, 640)]
    try:
        answers = [_post(httpd.server_address[1], "/classify_upload", _png_body(im))
                   for im in imgs]
    finally:
        httpd.shutdown()
        httpd.server_close()
    launched = _launches_since(before)
    ref = Classifier(str(CAFFENET), str(weights), mean=IMAGENET_MEAN_BGR, raw_scale=255.0,
                     channel_swap=(2, 1, 0), device=device)
    for im, ans in zip(imgs, answers):
        rgb = np.asarray(Image.fromarray(im[:, :, ::-1]), np.float32) / 255.0
        probs = ref.predict([rgb], oversample=False)[0]
        top5 = np.argsort(probs)[::-1][:5]
        got = [t["label"] for t in ans["top5"]]
        dp = max(abs(t["prob"] - float(probs[i])) for t, i in zip(ans["top5"], top5))
        if got != [labels[i] for i in top5] or dp > 1e-5:
            raise AssertionError(f"X2 web demo: {ans['top5']} against Classifier {probs}")
    log(f"X2 [{card}] web demo on G1's CaffeNet (f32): {len(imgs)} uploads, top-5 labels equal "
        f"to Classifier.predict's, probabilities within 1e-5; top classes "
        f"{[a['top5'][0]['label'] for a in answers]}")
    return launched


def phase_examples_scripts(root: Path, rng, card: str, weights: Path,
                           device: str = "cuda") -> None:
    """X3: `classification` and `detection` as a user starts them, two
    processes on the card at once, against the port's Classifier and
    Detector in this process on G1's weights and configuration."""
    from PIL import Image
    from deepcut_tpu_torch import io as dio
    from deepcut_tpu_torch.classifier import Classifier
    from deepcut_tpu_torch.detector import Detector

    images = []
    for i, (h, w) in enumerate(((480, 640), (360, 500))):
        images.append(root / f"x3_{i}.png")
        Image.fromarray(frame(rng, h, w)[:, :, ::-1]).save(images[-1])
    mean = root / "x3_mean.binaryproto"
    mean.write_bytes(dio.array_to_blobproto_bytes(IMAGENET_MEAN_BGR.reshape(1, 3, 1, 1)))
    labels = [f"synset_{i}" for i in range(COLOR_CLASSES)]
    (root / "x3_labels.txt").write_text("".join(f"{n}\n" for n in labels))
    windows = []
    for path in images:
        h, w = Image.open(path).size[::-1]
        y0, x0 = rng.randint(0, h // 2, 5), rng.randint(0, w // 2, 5)
        windows.append((str(path), np.stack([y0, x0, y0 + rng.randint(40, h // 2, 5),
                                             x0 + rng.randint(40, w // 2, 5)], 1)))
    wfile = root / "x3_windows.txt"
    wfile.write_text("".join(f"{p}\n" + "".join(" ".join(map(str, b)) + "\n" for b in boxes)
                             for p, boxes in windows))
    out_npz = root / "x3_det.npz"
    cmds = {"classification": [str(CAFFENET), str(weights), *map(str, images), "--mean", str(mean),
                               "--labels", str(root / "x3_labels.txt")],
            "detection": [str(CAFFENET), str(weights), str(wfile), "--mean", str(mean),
                          "--context-pad", str(DETECTOR_CONTEXT_PAD), "--out", str(out_npz)]}
    for argv in cmds.values():
        argv += ["--device", device]
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-m", f"deepcut_tpu_torch.examples.{name}",
                                     *argv], cwd=str(ROOT), stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, argv in cmds.items()}
    outs = {}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        if proc.returncode != 0:
            raise AssertionError(f"X3 {name} exited {proc.returncode}:\n{out}\n{err[-4000:]}")
        outs[name] = out
    wall = time.perf_counter() - t0

    probs = Classifier(str(CAFFENET), str(weights), mean=IMAGENET_MEAN_BGR, raw_scale=255.0,
                       channel_swap=(2, 1, 0), device=device).predict(
                           [dio.load_image(str(p)) for p in images])
    printed = outs["classification"].splitlines()
    want = []
    for path, p in zip(images, probs):
        want.append(str(path))
        want += [f"  {p[i]:.4f}  {labels[i]}" for i in np.argsort(p)[::-1][:5]]
    got_classes = [ln.split()[-1] for ln in printed if ln.startswith("  ")]
    want_classes = [ln.split()[-1] for ln in want if ln.startswith("  ")]
    dp = max(abs(float(g.split()[0]) - float(w.split()[0]))
             for g, w in zip([ln for ln in printed if ln.startswith("  ")],
                             [ln for ln in want if ln.startswith("  ")]))
    if got_classes != want_classes or dp > 1e-4 or len(printed) != len(want):
        raise AssertionError(f"X3 classification printed:\n{outs['classification']}\nwant:\n"
                             + "\n".join(want))
    det = Detector(str(CAFFENET), str(weights), mean=IMAGENET_MEAN_BGR, raw_scale=255.0,
                   channel_swap=(2, 1, 0), context_pad=DETECTOR_CONTEXT_PAD, device=device)
    ref = np.stack([d["prediction"] for d in det.detect_windows(windows)])
    saved = np.load(out_npz)["predictions"]
    printed_top = [int(ln.split("-> class ")[1].split()[0])
                   for ln in outs["detection"].splitlines() if "-> class " in ln]
    d = float(np.abs(saved - ref).max())
    if printed_top != ref.argmax(1).tolist() or d > 1e-5:
        raise AssertionError(f"X3 detection: classes {printed_top} against "
                             f"{ref.argmax(1).tolist()}, max |dp| {d}")
    log(f"X3 [{card}] python -m deepcut_tpu_torch.examples.classification and .detection, two "
        f"processes at once on {device} ({wall:.1f} s wall): exit 0; classification's top-5 "
        f"classes equal Classifier.predict's (10-crop, f32), printed probabilities within "
        f"{dp:.2g}; detection's classes {printed_top} equal Detector.detect_windows's, its .npz "
        f"within {d:.3g}")


def phase_examples_lenet(root: Path, card: str, device: str = "cuda") -> None:
    """X5: the mnist maker to its default path (the LMDB that
    examples/mnist/lenet_train.prototxt names), then `cli train` on a copy
    of examples/mnist/lenet_solver.prototxt cut to LENET_ITERATIONS
    iterations, from the repository's root as the recipe runs."""
    from deepcut_tpu_torch.examples.mnist import make_dataset as mnist

    solver = (ROOT / "examples/mnist/lenet_solver.prototxt").read_text()
    for key, value in (("max_iter: 1000", f"max_iter: {LENET_ITERATIONS}"),
                       ("display: 100", "display: 10"), ("snapshot: 1000", "snapshot: 0"),
                       ('snapshot_prefix: "examples/mnist/lenet"',
                        f'snapshot_prefix: "{root / "lenet"}"')):
        if key not in solver:
            raise AssertionError(f"lenet_solver.prototxt has no {key!r}")
        solver = solver.replace(key, value)
    (root / "lenet_solver.prototxt").write_text(solver)
    with contextlib.chdir(ROOT):
        t0 = time.perf_counter()
        mnist.make_lmdb("examples/mnist/train_lmdb", 2000)
        made = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, _ = run_verb(["train", "-solver", str(root / "lenet_solver.prototxt"),
                           "-device", device])
        trained = time.perf_counter() - t0
    losses = [float(ln.split("loss = ")[1].split(",")[0]) for ln in out.splitlines()
              if ln.startswith("Iteration ") and "loss = " in ln]
    if len(losses) < 3 or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < LENET_LOSS_FALL * losses[0]:
        raise AssertionError(f"X5 LeNet losses {losses}")
    log(f"X5 [{card}] the mnist maker wrote 2000 glyphs to examples/mnist/train_lmdb in "
        f"{made:.2f} s; cli train on lenet_solver.prototxt ({LENET_ITERATIONS} iterations, "
        f"{trained:.2f} s) logged losses {[round(v, 4) for v in losses]}")
    from deepcut_tpu_torch.examples.hdf5_classification import make_dataset as hdf5

    out = root / "hdf5_classification"
    try:
        import h5py  # noqa: F401
    except ImportError:
        _expect_h5py_import_error("X5 the HDF5 classification maker", lambda: hdf5.main(40, out))
        if out.exists():
            raise AssertionError("X5 the HDF5 maker wrote files before its ImportError")
        return
    hdf5.main(40, str(out))
    log(f"X5 [{card}] the HDF5 classification maker wrote "
        f"{sorted(p.name for p in out.iterdir())}")


def phase_examples(card: str, rng, device: str = "cuda", size: int = 688,
                   hd=(720, 1280)) -> dict:
    """X: the examples' front ends on the card; returns the launches of the
    served requests (X1, X2), the path's count. Rehearse it on the CPU with
    device="cpu" and small frames (`size`, and an `hd` frame whose canvas
    still exceeds 700 px on one side)."""
    from deepcut_tpu_torch.examples import net_surgery
    from deepcut_tpu_torch.models.convert import save_caffemodel

    served: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_x_") as tmp:
        root = Path(tmp)
        save_caffemodel(str(root / "resnet152_tamed.caffemodel"),
                        tame_params(deepercut_config(152)))
        for int8 in (False, True):
            phase_examples_pose(root, rng, card, int8, served, device, size, hd)
        weights = caffenet_weights(root / "caffenet_tamed.caffemodel", device)
        _add(served, phase_examples_web(root, rng, card, weights, device))
        phase_examples_scripts(root, rng, card, weights, device)
        buf = io.StringIO()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            net_surgery.main(["--device", device])
        if "surgery exact" not in buf.getvalue():
            raise AssertionError("X4 net_surgery did not report an exact surgery")
        log(f"X4 [{card}] net_surgery on {device}: filter surgery and the fully-convolutional "
            "cast exact")
        phase_examples_lenet(root, card, device)
    from deepcut_tpu_torch.pose.estimate import _MODEL_CACHE

    _MODEL_CACHE.clear()   # the services' cached ResNet-152
    if device == "cuda":
        torch.cuda.empty_cache()
    return served


# -- M. MatCaffe and data-parallel training ----------------------------------------
# The reference's matcaffe fixture (matlab/+caffe/+test/test_net.m's
# simple_net_file, legacy DummyData dims) with both DummyData tops constant,
# so that the scenarios stage their data and labels and the card and the
# CPU see the same inputs.
MATCAFFE_NET = """
name: "testnet" force_backward: true
layer { type: "DummyData" name: "data" top: "data" top: "label"
  dummy_data_param { num: 5 channels: 2 height: 3 width: 4
    num: 5 channels: 1 height: 1 width: 1
    data_filler { type: "constant" } data_filler { type: "constant" } } }
layer { type: "Convolution" name: "conv" bottom: "data" top: "conv"
  convolution_param { num_output: 11 kernel_size: 2 pad: 3
    weight_filler { type: "gaussian" std: 1 } bias_filler { type: "constant" value: 2 } }
  param { decay_mult: 1 } param { decay_mult: 0 } }
layer { type: "InnerProduct" name: "ip" bottom: "conv" top: "ip"
  inner_product_param { num_output: 13
    weight_filler { type: "gaussian" std: 2.5 } bias_filler { type: "constant" value: -3 } } }
layer { type: "SoftmaxWithLoss" name: "loss" bottom: "ip" bottom: "label" top: "loss" }
"""
# M1: the card against the CPU through the gateway, f32 with TF32 off (cuDNN
# and cuBLAS sum in other orders than the CPU). Written before the first
# run: a forward and a backward within 1e-5 of each blob's largest
# magnitude; test_solver.m's 100 SGD steps (momentum 0.9, the inv policy) on
# the tamed weights within 1e-4 of each param's scale.
MATCAFFE_FWD_RTOL, MATCAFFE_SOLVER_RTOL = 1e-5, 1e-4
# M2: PoseSolver with mesh=make_mesh(1) over NCCL against mesh=None, the same
# batches, deterministic cuDNN, f32 with TF32 off: bit-equal (an all-reduce
# over one rank returns its input).
M2_STEPS = 3
# M3: two ranks on the one card over gloo against one process on the global
# batch (each rank's convolutions run at half the batch, where cuDNN may
# pick other algorithms, and gloo sums the two halves' gradients in f32).
# Written before the first run: the losses within 1e-5 relative at every
# step, the weights within 1e-4 of their scale. Read on the card (NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md): the losses 2.2e-7 apart at most,
# CaffeNet's conv1 and fc8 1.5e-6 and 1.1e-7, the pose heads 1.2e-12;
# tightened to 1e-6 and 1e-5.
M3_LOSS_RTOL, M3_WEIGHT_RTOL = 1e-6, 1e-5
# PoseSolver's rate in M3: write_solver's cut recipe (1e-5) moves the tamed
# ResNet's loss 27.8 -> 145.4 -> 142.2 in its first steps (the CPU
# rehearsal at ResNet-50, 128 px), a regime where a one-ulp difference of a
# gradient grows to 3e-4 of the loss by step 3 whatever splits the batch;
# at 1e-7 the loss moves smoothly and the comparison reads the data-parallel
# path, not the chaos.
M3_POSE_LR = 1e-7
# conv1 in M3's PoseSolver: tamed to 3e-4 of its init, it moves by more than
# half its scale in 3 steps under a gradient that sums x * g over every
# position of the canvas and cancels to about 1e-2 of its own size. On one
# process (the CPU rehearsal at ResNet-50, 128 px) the same global batch
# taken as two micro-batches (iter_size 2) left conv1 1.3e-2 of its scale
# from one batch of two; two gloo ranks read 4.4e-3. Written before the
# first card run: 5e-2; read on the card at ResNet-152, 688 px: 1.2e-4;
# tightened to 1e-3. The heads are held at M3_WEIGHT_RTOL.
M3_CONV1_RTOL = 1e-3
M3_CAFFENET_STEPS, M3_POSE_STEPS, M3_POSE_BATCH = 5, 3, 2
M3_CAFFENET_BLOBS = ("conv1", "fc8")
M3_JOIN_S = 300


def _gw_single(arr) -> dict:
    """Caffe-order numpy -> the gateway's single encoding (MATLAB dims)."""
    a = np.ascontiguousarray(arr, np.float32)
    return {"dims": list(reversed(a.shape)) or [1], "data": a.tobytes()}


def _gw_arr(item) -> np.ndarray:
    dims = tuple(int(d) for d in item["dims"])
    return np.frombuffer(bytes(item["data"]), "<f4").reshape(dims[::-1]).copy()


def _gw_handles(gw, h):
    attr = dict(gw.dispatch("net_get_attr", [h])[0]["fields"])

    def blob(name):
        return attr["hBlob_blobs"]["v"][attr["blob_names"]["v"].index(name)]

    def params(layer):
        lh = attr["hLayer_layers"]["v"][attr["layer_names"]["v"].index(layer)]
        return dict(gw.dispatch("layer_get_attr", [lh])[0]["fields"])["hBlob_blobs"]["v"]
    return attr, blob, params


def matcaffe_weights(gw, net_file: Path, out: Path) -> Path:
    """Tamed seeded weights (logits of a few units: the fixture's own give
    ~300) written through a CPU net's param handles and saved by net_save."""
    gw.dispatch("set_mode_cpu", [])
    h = gw.dispatch("get_net", [str(net_file), "train"])[0]
    _, _, params = _gw_handles(gw, h)
    rng = np.random.RandomState(SEED)
    for layer, std in (("conv", 0.5), ("ip", 0.02)):
        for i, hb in enumerate(params(layer)):
            shape = _gw_arr(gw.dispatch("blob_get_data", [hb])[0]).shape
            gw.dispatch("blob_set_data", [hb, _gw_single(
                (std if i == 0 else 0.1) * rng.randn(*shape))])
    gw.dispatch("net_save", [h, str(out)])
    return out


def matcaffe_scenarios(gw, root: Path, mode: str, weights: Path) -> dict:
    """matlab/+caffe/+test's test_net, test_solver and test_io through the
    gateway after `mode` (set_mode_gpu / set_mode_cpu): -> every value read."""
    gw.dispatch(mode, [])
    net_file = root / "matcaffe_net.prototxt"
    rng = np.random.RandomState(SEED + 1)
    data = rng.randn(5, 2, 3, 4).astype(np.float32)
    labels = rng.randint(0, 13, (5, 1, 1, 1)).astype(np.float32)
    got = {}
    # test_net: test_blob, test_layer, test_forward_backward, test_save_and_read
    h = gw.dispatch("get_net", [str(net_file), "train"])[0]
    gw.dispatch("net_copy_from", [h, str(weights)])
    attr, blob, params = _gw_handles(gw, h)
    got["names"] = (attr["layer_names"]["v"], attr["blob_names"]["v"],
                    attr["output_blob_indices"]["v"])
    got["data_shape"] = gw.dispatch("blob_get_shape", [blob("data")])[0]["v"]
    gw.dispatch("blob_set_data", [blob("data"), _gw_single(data)])
    gw.dispatch("blob_set_data", [blob("label"), _gw_single(labels)])
    got["conv_shapes"] = [gw.dispatch("blob_get_shape", [p])[0]["v"] for p in params("conv")]
    got["conv_type"] = gw.dispatch("layer_get_type", [attr["hLayer_layers"]["v"][1]])[0]["v"]
    gw.dispatch("net_forward", [h])
    for nm in ("conv", "ip", "loss"):
        got[nm] = _gw_arr(gw.dispatch("blob_get_data", [blob(nm)])[0])
    gw.dispatch("net_backward", [h])
    got["data_diff"] = _gw_arr(gw.dispatch("blob_get_diff", [blob("data")])[0])
    saved = root / f"matcaffe_saved_{mode}.caffemodel"
    gw.dispatch("net_save", [h, str(saved)])
    h2 = gw.dispatch("get_net", [str(net_file), "test"])[0]
    gw.dispatch("net_copy_from", [h2, str(saved)])
    _, _, params2 = _gw_handles(gw, h2)
    got["save_and_read"] = all(
        gw.dispatch("blob_get_data", [a])[0] == gw.dispatch("blob_get_data", [b])[0]
        for layer in ("conv", "ip") for a, b in zip(params(layer), params2(layer)))
    # test_solver: iter 0 -> step(30) -> 30 -> solve -> 100, staged inputs
    hs = gw.dispatch("get_solver", [str(root / "matcaffe_solver.prototxt")])[0]
    f = dict(gw.dispatch("solver_get_attr", [hs])[0]["fields"])
    hnet, htest = f["hNet_net"]["v"][0], f["hNet_test_nets"]["v"]
    gw.dispatch("net_copy_from", [hnet, str(weights)])
    for hn in [hnet] + htest:
        _, b, _ = _gw_handles(gw, hn)
        gw.dispatch("blob_set_data", [b("data"), _gw_single(data)])
        gw.dispatch("blob_set_data", [b("label"), _gw_single(labels)])
    iters = [gw.dispatch("solver_get_iter", [hs])[0]["v"]]
    gw.dispatch("solver_step", [hs, 30.0])
    iters.append(gw.dispatch("solver_get_iter", [hs])[0]["v"])
    _, _, sparams = _gw_handles(gw, hnet)
    got["solver_30"] = [_gw_arr(gw.dispatch("blob_get_data", [p])[0])
                        for layer in ("conv", "ip") for p in sparams(layer)]
    gw.dispatch("solver_solve", [hs])
    iters.append(gw.dispatch("solver_get_iter", [hs])[0]["v"])
    got["iters"] = iters
    got["solver_100"] = [_gw_arr(gw.dispatch("blob_get_data", [p])[0])
                         for layer in ("conv", "ip") for p in sparams(layer)]
    # test_io: test_read_write_mean
    mean = (255 * np.random.RandomState(3).rand(3, 30, 20)).astype(np.float32)
    gw.dispatch("write_mean", [_gw_single(mean), str(root / f"mean_{mode}.binaryproto")])
    back = gw.dispatch("read_mean", [str(root / f"mean_{mode}.binaryproto")])[0]
    got["mean_ok"] = back["dims"] == [20, 30, 3] and np.array_equal(
        _gw_arr(back).reshape(mean.shape), mean)
    gw.dispatch("reset", [])
    return got


def _scale_close(got, want, rtol: float) -> float:
    """max |got - want| over want's largest magnitude; raises past rtol."""
    d = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    rel = d / max(float(np.abs(want).max()), 1e-30)
    if not rel <= rtol:
        raise AssertionError(f"{rel:.3g} of the scale apart (held to {rtol})")
    return rel


def mex_check(so: str, net_file: str, weights: str, mode: str) -> None:
    """The port's MEX through ctypes, with the mex stub's C API as
    tests/test_torch_matlab_mex.py drives it: `mode` (the device), get_net,
    net_copy_from, the data and labels staged as MATLAB singles through blob
    handles, net_forward; prints the version and the loss's bits."""
    import ctypes

    L = ctypes.CDLL(so)
    vp, sz, cp, ci = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int
    for name, res, args in (
            ("mxCreateString", vp, [cp]), ("mxCreateDoubleScalar", vp, [ctypes.c_double]),
            ("mxCreateNumericArray", vp, [sz, ctypes.POINTER(sz), ci, ci]),
            ("mxCreateStructMatrix", vp, [sz, sz, ci, ctypes.POINTER(cp)]),
            ("mxSetField", None, [vp, sz, cp, vp]), ("mxGetField", vp, [vp, sz, cp]),
            ("mxGetData", vp, [vp]), ("mxGetScalar", ctypes.c_double, [vp]),
            ("mxGetNumberOfElements", sz, [vp]), ("mxGetCell", vp, [vp, sz]),
            ("mxArrayToString", cp, [vp]),
            ("mex_test_call", ci, [ci, ctypes.POINTER(vp), ci, ctypes.POINTER(vp), cp, ci])):
        fn = getattr(L, name)
        fn.restype, fn.argtypes = res, args

    def call(cmd, *args, nlhs=1):
        prhs = (vp * (1 + len(args)))(L.mxCreateString(cmd.encode()), *args)
        plhs = (vp * max(nlhs, 1))()
        err = ctypes.create_string_buffer(2048)
        if L.mex_test_call(nlhs, plhs, 1 + len(args), prhs, err, 2048):
            raise RuntimeError(err.value.decode())
        return [plhs[i] for i in range(nlhs)]

    def text(s):
        return L.mxCreateString(s.encode())

    def single(a):
        a = np.ascontiguousarray(a, np.float32)
        ml = list(reversed(a.shape))
        pa = L.mxCreateNumericArray(len(ml), (sz * len(ml))(*ml), 5, 0)   # mxSINGLE_CLASS
        ctypes.memmove(L.mxGetData(pa), a.tobytes(), a.nbytes)
        return pa

    def handle(vec, i):   # element i of a handle vector as a 1x1 struct (MATLAB's copy)
        st = L.mxCreateStructMatrix(1, 1, 2, (cp * 2)(b"ptr", b"init_key"))
        ptr = L.mxCreateNumericArray(2, (sz * 2)(1, 1), 6, 0)             # mxUINT64_CLASS
        ctypes.cast(L.mxGetData(ptr), ctypes.POINTER(ctypes.c_uint64))[0] = int(
            L.mxGetScalar(L.mxGetField(vec, i, b"ptr")))
        L.mxSetField(st, 0, b"ptr", ptr)
        L.mxSetField(st, 0, b"init_key", L.mxCreateDoubleScalar(
            L.mxGetScalar(L.mxGetField(vec, i, b"init_key"))))
        return st

    (v,) = call("version")
    call(mode, nlhs=0)
    (h,) = call("get_net", text(net_file), text("train"))
    call("net_copy_from", h, text(weights), nlhs=0)
    (attr,) = call("net_get_attr", h)
    cell = L.mxGetField(attr, 0, b"blob_names")
    names = [L.mxArrayToString(L.mxGetCell(cell, i)).decode()
             for i in range(L.mxGetNumberOfElements(cell))]
    blobs = L.mxGetField(attr, 0, b"hBlob_blobs")
    rng = np.random.RandomState(SEED + 1)
    call("blob_set_data", handle(blobs, names.index("data")),
         single(rng.randn(5, 2, 3, 4)), nlhs=0)
    call("blob_set_data", handle(blobs, names.index("label")),
         single(rng.randint(0, 13, (5, 1, 1, 1))), nlhs=0)
    call("net_forward", h, nlhs=0)
    (loss,) = call("blob_get_data", handle(blobs, names.index("loss")))
    value = float(np.frombuffer(ctypes.string_at(L.mxGetData(loss), 4), "<f4")[0])
    print(f"MEX version {L.mxArrayToString(v).decode()!r}, {mode}, loss {value!r} "
          f"bits {value.hex()}", flush=True)


def phase_matcaffe(root: Path, card: str, device: str = "cuda") -> dict:
    """M1: the reference's matcaffe scenarios through `matlab_gateway.dispatch`
    on the card (set_mode_gpu) and on the CPU (set_mode_cpu), the weights
    carried by .caffemodel, compared within MATCAFFE_FWD_RTOL /
    MATCAFFE_SOLVER_RTOL; then the port's MEX through ctypes in a
    subprocess where Python.h and a shared libpython exist. `device`
    other than cuda is for rehearsing off the card (both runs on the CPU)."""
    import sysconfig

    from deepcut_tpu_torch import matlab_gateway as gw

    (root / "matcaffe_net.prototxt").write_text(MATCAFFE_NET)
    (root / "matcaffe_solver.prototxt").write_text(
        f'net: "{root / "matcaffe_net.prototxt"}"\ntest_iter: 10 test_interval: 10 '
        'base_lr: 0.01 momentum: 0.9\nweight_decay: 0.0005 lr_policy: "inv" gamma: 0.0001 '
        'power: 0.75\ndisplay: 0 max_iter: 100 snapshot_after_train: false\n')
    weights = matcaffe_weights(gw, root / "matcaffe_net.prototxt", root / "matcaffe.caffemodel")
    t0 = time.perf_counter()
    with _deterministic():
        card_run = matcaffe_scenarios(gw, root, "set_mode_gpu" if device == "cuda"
                                      else "set_mode_cpu", weights)
    t_card = time.perf_counter() - t0
    cpu_run = matcaffe_scenarios(gw, root, "set_mode_cpu", weights)
    for key in ("names", "data_shape", "conv_shapes", "conv_type", "iters"):
        if card_run[key] != cpu_run[key]:
            raise AssertionError(f"M1 {key}: {card_run[key]} on {device}, {cpu_run[key]} on the CPU")
    if card_run["iters"] != [0.0, 30.0, 100.0] or not (
            card_run["save_and_read"] and card_run["mean_ok"] and cpu_run["mean_ok"]):
        raise AssertionError(f"M1: iterations {card_run['iters']}, save_and_read "
                             f"{card_run['save_and_read']}, read/write mean {card_run['mean_ok']}")
    rel = {nm: _scale_close(card_run[nm], cpu_run[nm], MATCAFFE_FWD_RTOL)
           for nm in ("conv", "ip", "loss", "data_diff")}
    for when in ("solver_30", "solver_100"):
        rel[when] = max(_scale_close(a, b, MATCAFFE_SOLVER_RTOL)
                        for a, b in zip(card_run[when], cpu_run[when]))
    log(f"M1 matcaffe through matlab_gateway.dispatch on {device} against the CPU "
        f"(test_net, test_solver, test_io; {t_card:.1f} s on {device}): names, shapes, types and "
        f"iterations {card_run['iters']} equal; max |d| over each blob's scale: "
        + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + f" (held to {MATCAFFE_FWD_RTOL} / {MATCAFFE_SOLVER_RTOL}); loss "
        f"{float(card_run['loss'].ravel()[0]):.6f}")
    include = Path(sysconfig.get_path("include")) / "Python.h"
    lib = Path(sysconfig.get_config_var("LIBDIR") or "") / str(sysconfig.get_config_var("LDLIBRARY"))
    shared = bool(sysconfig.get_config_var("Py_ENABLE_SHARED"))
    if not (include.is_file() and lib.is_file() and shared):
        log(f"M1: the MEX part did not run: Python.h {'found' if include.is_file() else 'missing'} "
            f"({include}), libpython {'found' if lib.is_file() else 'missing'} ({lib}), "
            f"shared libpython {shared}")
        return {"mex": "not run"}
    from deepcut_tpu_torch.matlab.build import build_test_so

    so = build_test_so()
    mode = "set_mode_gpu" if device == "cuda" else "set_mode_cpu"
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.mex_check(*sys.argv[1:])",
         str(so), str(root / "matcaffe_net.prototxt"), str(weights), mode],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 or "MEX version" not in proc.stdout:
        raise AssertionError(f"M1 MEX through ctypes failed:\n{proc.stdout}\n{proc.stderr[-3000:]}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("MEX version"))
    loss = float.fromhex(line.rsplit("bits ", 1)[1])
    if loss != float(card_run["loss"].ravel()[0]):
        raise AssertionError(f"M1 MEX: loss {loss!r} against the gateway's "
                             f"{float(card_run['loss'].ravel()[0])!r}")
    log(f"M1 the port's MEX ({so.name}, g++ against matlab/mex_stub) through ctypes in a "
        f"subprocess: {line}; bit-equal to the gateway's loss")
    return {"mex": "ran"}


@contextlib.contextmanager
def _deterministic():
    """Deterministic cuDNN and no TF32 inside; the caller's flags back after."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, mm.allow_tf32
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, mm.allow_tf32 = True, False, False, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, mm.allow_tf32 = saved


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pose_batches(root: Path, name: str, n: int, batch: int, size: int):
    """n host batches of `batch` size x size frames from the CLI's data
    source over the published recipe at scale 1 (the 704 canvas at 688):
    -> (SolverParams, target config, joint stats, batches)."""
    from deepcut_tpu_torch.solver.solver import SolverParams
    from deepcut_tpu_torch.tools.cli import pose_data

    index = write_frames(root / f"{name}_frames", np.random.RandomState(SEED), n * batch, size,
                         size)
    sp = SolverParams.from_prototxt(str(write_solver(root, index, name, 10 ** 6, 0, display=0,
                                                     no_jitter=True)))
    tcfg, stats, src, _ = pose_data(sp, workers=0)
    try:
        batches = [src.next_batch(batch) for _ in range(n)]
    finally:
        src.close()
    return sp, tcfg, stats, batches


def _timed_steps(solver, steps: int, sync: bool):
    """`steps` single steps: -> (wall ms of each, the loss of each)."""
    ms, losses = [], []
    for _ in range(steps):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.step(1)
        if sync:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1000)
        losses.append(float(solver._loss_window[-1]))
    return ms, losses


def phase_dp_world1(root: Path, card: str, device: str = "cuda", depth: int = 152,
                    size: int = 688) -> dict:
    """M2: PoseSolver with mesh=make_mesh(1) on a process group of one (NCCL
    on the card, through `parallel.distributed.initialize` on localhost)
    against mesh=None: ResNet-`depth` at full width, the 704 canvas, f32
    with TF32 off, deterministic cuDNN, M2_STEPS steps on the same batches:
    the losses and every param bit-equal; the eval hook (iteration 0)
    decodes a frame through the port's estimator on the coordinator. Each
    step timed, one more profiled."""
    from deepcut_tpu_torch.parallel import distributed
    from deepcut_tpu_torch.parallel.mesh import make_mesh
    from deepcut_tpu_torch.solver.solver import PoseSolver

    sp, tcfg, stats, batches = pose_batches(root, "m2", M2_STEPS, 1, size)
    sp.test_interval = 10 ** 6       # the eval hook at iteration 0 only
    cfg = deepercut_config(depth, pairwise=False)
    eval_frame = frame(np.random.RandomState(SEED), 480, 640)
    poses = []

    def eval_fn(params, it):
        est = PoseEstimator(params, cfg, folded=False, device=device)
        poses.append(est.estimate_pose(eval_frame))
        return None

    dev = distributed.initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0, device=device)
    backend = torch.distributed.get_backend()
    runs = {}
    try:
        mesh = make_mesh(1)
        for name, m in (("mesh=None", None), ("mesh=make_mesh(1)", mesh)):
            feed = iter(batches)
            with _deterministic():
                solver = PoseSolver(sp, cfg, lambda: next(feed), net_params=tame_params(cfg),
                                    mesh=m, target_cfg=tcfg, target_stats=stats, eval_fn=eval_fn,
                                    handle_signals=False, log=lambda *_: None,
                                    device=None if m is not None else dev)
                ms, losses = _timed_steps(solver, M2_STEPS, device == "cuda")
            runs[name] = {"ms": ms, "losses": losses,
                          "params": {f"{n}/{k}": v.detach().cpu().clone()
                                     for n, e in solver.net_params.items() for k, v in e.items()}}
            if device == "cuda":
                again = batches[-1]
                solver.batch_source = lambda: again
                runs[name]["profile"] = _device_profile(lambda: solver.step(1), steps=2)[:2]
            del solver
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
    a, b = runs["mesh=None"], runs["mesh=make_mesh(1)"]
    differ = [k for k in a["params"] if not torch.equal(a["params"][k], b["params"][k])]
    if a["losses"] != b["losses"] or differ:
        raise AssertionError(f"M2: mesh=make_mesh(1) is not bit-equal to mesh=None: losses "
                             f"{a['losses']} against {b['losses']}, params apart {differ[:5]}")
    if len(poses) != 2 or not all(p is not None and np.isfinite(p).all() for p in poses):
        raise AssertionError(f"M2: the eval hook's poses {poses}")
    nan = (float("nan"), float("nan"))
    (busy_a, ops_a), (busy, ops) = a.get("profile", nan), b.get("profile", nan)
    log(f"M2 PoseSolver ResNet-{depth}, {size}x{size} frames (canvas "
        f"{batches[0]['image'].shape[1]}), batch 1, f32 (TF32 off), deterministic cuDNN, "
        f"{backend} process group of 1 on {dev}: mesh=make_mesh(1) bit-equal to mesh=None over "
        f"{M2_STEPS} steps (losses {', '.join(f'{v:.6f}' for v in b['losses'])}; "
        f"{len(a['params'])} param blobs); the eval hook's estimator decoded 2 frames")
    log(f"time [{card}]: M2 PoseSolver.step, batch 1, f32: mesh=None "
        + ", ".join(f"{v:.3f}" for v in a["ms"]) + " ms; mesh=make_mesh(1) over "
        f"{backend} " + ", ".join(f"{v:.3f}" for v in b["ms"]) + f" ms (wall per step, the "
        f"first with the eval hook); two more steps under the profiler: mesh=None device busy "
        f"{busy_a:.3f} ms, {ops_a:.0f} device ops; mesh=make_mesh(1) {busy:.3f} ms, "
        f"{ops:.0f} device ops per step")
    return runs


def _m3_caffenet(spec: dict, mesh) -> dict:
    """CaffeNet (E(a)'s MemoryData net, Dropout on) through GraphSolver,
    M3_CAFFENET_STEPS steps on the global batch of colour-class frames."""
    from deepcut_tpu_torch.solver.solver import GraphSolver, SolverParams

    with _deterministic():
        solver = GraphSolver(SolverParams.from_prototxt(spec["caffenet_solver"]), mesh=mesh,
                             handle_signals=False, log=lambda *_: None,
                             device=None if mesh is not None else spec["device"])
        solver.net.set_input_arrays(*color_frames(np.random.default_rng(SEED),
                                                  spec["caffenet_batch"]))
        ms, losses = _timed_steps(solver, M3_CAFFENET_STEPS, spec["device"] != "cpu")
        out = {"ms": ms, "losses": losses,
               "weights": {n: solver.net.params[n]["w"].detach().cpu().numpy()
                           for n in M3_CAFFENET_BLOBS}}
        if spec["device"] != "cpu":
            out["profile"] = _device_profile(lambda: solver.step(1), steps=2)[:2]
    solver.close()
    return out


def _m3_pose(spec: dict, mesh) -> dict:
    """PoseSolver at full width on the global batch of M3_POSE_BATCH frames."""
    from deepcut_tpu_torch.solver.solver import PoseSolver

    cfg = deepercut_config(spec["depth"], pairwise=False)
    feed = itertools.cycle(spec["pose_batches"])
    with _deterministic():
        solver = PoseSolver(spec["pose_sp"], cfg, lambda: next(feed),
                            net_params=tame_params(cfg), mesh=mesh, target_cfg=spec["tcfg"],
                            target_stats=spec["stats"], handle_signals=False,
                            log=lambda *_: None,
                            device=None if mesh is not None else spec["device"])
        ms, losses = _timed_steps(solver, M3_POSE_STEPS, spec["device"] != "cpu")
        out = {"ms": ms, "losses": losses,
               "weights": {n: solver.net_params[n]["w"].detach().cpu().numpy()
                           for n in ENGINE_POSE_BLOBS}}
        if spec["device"] != "cpu":
            out["profile"] = _device_profile(lambda: solver.step(1), steps=2)[:2]
    return out


def _m3_rank(rank: int, port: int, spec_path: str, out_dir: str, spawned: float) -> None:
    """One of M3's two ranks: a gloo group on localhost over CUDA tensors.
    `spawned`: as `_s_rank`'s."""
    import pickle

    log(f"M3 rank {rank}: started {time.time() - spawned:.1f} s after its spawn")
    time_phases(globals())

    from deepcut_tpu_torch.parallel import distributed
    from deepcut_tpu_torch.parallel.mesh import make_mesh

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    dev = distributed.initialize(f"tcp://127.0.0.1:{port}", 2, rank, device=spec["device"],
                                 backend="gloo")
    try:
        mesh = make_mesh(2, device=dev)
        out = {"caffenet": _m3_caffenet(spec, mesh), "pose": _m3_pose(spec, mesh)}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        distributed.shutdown()


def phase_dp_two_ranks(root: Path, card: str, device: str = "cuda", depth: int = 152,
                       size: int = 688) -> dict:
    """M3: two spawned ranks on the one card over gloo (CUDA tensors through
    the host) against one process on the global batch: GraphSolver on BVLC's
    CaffeNet at CAFFENET_BATCH["TRAIN"] (Dropout on: the global draw, each
    rank's rows) and PoseSolver at full width on M3_POSE_BATCH frames; the
    losses within M3_LOSS_RTOL at every step, the weights of
    M3_CAFFENET_BLOBS / ENGINE_POSE_BLOBS within M3_WEIGHT_RTOL of their
    scale; each step timed on every rank. Not a scaling measurement: one
    card, gloo through the host."""
    import multiprocessing as mp
    import pickle

    net = caffenet_memory_net(root)
    solver = root / "m3_caffenet_solver.prototxt"
    solver.write_text(f'net: "{net}"\nbase_lr: {CAFFENET_BASE_LR}\nmomentum: 0.9\n'
                      f'weight_decay: 0.0005\nlr_policy: "fixed"\ndisplay: 0\nmax_iter: 1000\n'
                      f'snapshot: 0\nrandom_seed: {SEED}\n')
    pose_sp, tcfg, stats, batches = pose_batches(root, "m3", M3_POSE_STEPS, M3_POSE_BATCH, size)
    pose_sp.config = dataclasses.replace(pose_sp.config, base_lr=M3_POSE_LR,
                                         stagelr=tuple(M3_POSE_LR for _ in pose_sp.config.stagelr))
    # both ranks on the one card (initialize would bind rank 1 to cuda:1)
    spec = {"device": "cuda:0" if device == "cuda" else device, "depth": depth,
            "caffenet_solver": str(solver),
            "caffenet_batch": CAFFENET_BATCH["TRAIN"], "pose_sp": pose_sp, "tcfg": tcfg,
            "stats": stats, "pose_batches": batches}
    spec_path = root / "m3_spec.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    single = {"caffenet": _m3_caffenet(spec, None), "pose": _m3_pose(spec, None)}
    if device == "cuda":
        torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_m3_rank,
                         args=(r, port, str(spec_path), str(root), time.time()))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(M3_JOIN_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if [p.exitcode for p in procs] != [0, 0]:
        raise AssertionError(f"M3: the ranks exited {[p.exitcode for p in procs]} (gloo over "
                             "CUDA tensors, two ranks on one card; their errors are above)")
    secs = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(root / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    lines = []
    for what in ("caffenet", "pose"):
        want = single[what]
        for r, res in enumerate(ranks):
            got = res[what]
            loss_rel = max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))
            if len(got["losses"]) != len(want["losses"]) or not loss_rel <= M3_LOSS_RTOL:
                raise AssertionError(f"M3 {what} rank {r}: losses {got['losses']} against "
                                     f"{want['losses']}")
            try:
                w_rel = {n: _scale_close(got["weights"][n], want["weights"][n],
                                         M3_CONV1_RTOL if (what, n) == ("pose", "conv1")
                                         else M3_WEIGHT_RTOL)
                         for n in want["weights"]}
            except AssertionError as e:
                raise AssertionError(f"M3 {what} rank {r}, the weights: {e}") from None
            if r == 0:
                lines.append(f"{what}: losses {', '.join(f'{v:.6f}' for v in want['losses'])}, "
                             f"max relative {loss_rel:.3g} (held to {M3_LOSS_RTOL}); weights "
                             + ", ".join(f"{n} {v:.3g}" for n, v in w_rel.items())
                             + f" of their scale (held to {M3_WEIGHT_RTOL}"
                             + (f", conv1 {M3_CONV1_RTOL})" if what == "pose" else ")"))
    log(f"M3 two ranks on {device} over gloo ({secs:.1f} s with the ranks' start) against one "
        f"process on the global batch: " + "; ".join(lines))
    log(f"time [{card}]: M3 (one card, not a scaling measurement) GraphSolver.step CaffeNet "
        f"batch {CAFFENET_BATCH['TRAIN']}, f32: one process "
        + ", ".join(f"{v:.3f}" for v in single["caffenet"]["ms"]) + " ms; two gloo ranks "
        + " | ".join(", ".join(f"{v:.3f}" for v in res["caffenet"]["ms"]) for res in ranks)
        + f" ms. PoseSolver.step ResNet-{depth} batch {M3_POSE_BATCH}, f32: one process "
        + ", ".join(f"{v:.3f}" for v in single["pose"]["ms"]) + " ms; two gloo ranks "
        + " | ".join(", ".join(f"{v:.3f}" for v in res["pose"]["ms"]) for res in ranks)
        + " ms (wall per step)")
    if device == "cuda":
        log(f"profile [{card}]: M3, two more steps under the profiler (device busy ms, device "
            "ops per step): " + "; ".join(
                f"{what} {who} {res[what]['profile'][0]:.3f}, {res[what]['profile'][1]:.0f}"
                for what in ("caffenet", "pose")
                for who, res in (("one process", single), ("rank 0", ranks[0]),
                                 ("rank 1", ranks[1]))))
    return {"single": single, "ranks": ranks}


def phase_matcaffe_dp(card: str) -> None:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_m_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        phase_matcaffe(root, card)
        phase_dp_world1(root, card, depth=M2_DEPTH)
        phase_dp_two_ranks(root, card)
        log(f"phase M took {time.perf_counter() - t0:.1f} s")


# -- S. the spatial axis: row-sharded training and serving --------------------
# Two ranks on the one card over gloo (CUDA tensors through the host), a
# (data=1, spatial=2) mesh, against one process. Not a scaling measurement:
# one card, and every halo exchange crosses the host.
#
# S1 / S2: each rank's convolutions run on its half of the canvas rows plus
# halos, where cuDNN may pick other algorithms and sum in another order;
# gloo sums the two halves' weight gradients in f32. Written before the
# first card run: M3's bounds, which the data axis met with the batch split
# in two (losses 1e-6 relative, weights 1e-5 of their scale, the tamed
# conv1 1e-3), at M3's rate (M3_POSE_LR, the same reason). Read on the card
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): the first step as predicted
# (S1's loss 1.2e-7 apart; S2's loss equal and conv1's update 1.9e-4 of its
# scale), but not S1's third step: its loss 7.2e-6 apart and the tamed
# conv1 1.66e-3 of its scale. conv1 moves by a quarter of its scale per
# step under a gradient that cancels to ~1e-2 of its terms. So every step
# is held to M3's bounds against one process's step from the same state
# (step 1 from the init, step k + 1 from the ranks' snapshot after step k:
# `_s1_replay`), where a wrong halo, gather or gradient scale in any step
# shows at once; the free three-step trajectory is held to bounds set
# after that first reading, ~7x above it, and its witness is logged beside
# it: one process's own trajectory from the ranks' first step. Read on the
# card: every step from the same state within M3's bounds (conv1's update
# 2.3e-4 at most); one process from the ranks' step-1 snapshot drifts
# 6.7e-6 / 1.58e-3 from its own trajectory (the ranks 7.2e-6 / 1.66e-3),
# and the ranks' step 2 in another summation order lands as far from
# their own (worst leaf 7.9e-4) as from one process's: rounding, amplified.
S_STEPS = 3
S_LOSS_RTOL, S_WEIGHT_RTOL, S_CONV1_RTOL = M3_LOSS_RTOL, M3_WEIGHT_RTOL, M3_CONV1_RTOL
S_TRAJ_LOSS_RTOL, S_TRAJ_CONV1_RTOL = 5e-5, 1e-2
S_POSE_BLOBS = ("conv1", "res5c_branch2c") + ENGINE_POSE_BLOBS[1:]
# S1's -mixed_precision step: bf16 convolutions on other row extents round
# other sums; held as T2 holds the mixed loss against f32.
S_MIXED_LOSS_RTOL = MIXED_LOSS_RTOL
# S3: the bf16 serving forward over two row blocks against one process on
# the same canvas: every conv ends in conv_epilogue's single rounding, but
# cuDNN sums each block's convolution in its own order, so a bf16 value may
# land one step away and carry on through the trunk, as fusing branch1 and
# branch2a does in phase G. Written before the first run: within
# FUSED_MAX_STEPS bf16 steps at each map's largest magnitude. The strict
# local maxima (tests/test_hd_multiperson.py) agree with the tiled path's
# wherever a peak stands clear of its neighbours and of the threshold by
# the two maps' distance (`keypoints_agree`); so do one process's full-frame maxima.
# int8, sharded against one process's int8 on the same scales: the same
# exact int32 GEMMs, so only the bf16 stem and heads' sum orders can
# separate them; held to the same bf16-step bound (phase Q's envelope is
# for int8 against float; the card read them equal bit for bit).
S_MAP_STEPS = FUSED_MAX_STEPS
S_HD = (1088, 1920)       # 1080p rounded up to the stride-8 canvas; 1088 % 16 == 0
S_TILE = 512              # the tiled path's max_size for the keypoint check
S_JOIN_S = 900


def draw_people(h, w, n_people, rng):
    """tests/test_hd_multiperson.py's synthetic multi-person frame: a
    textured background and n figures (head blob, torso bar, arms)."""
    img = rng.randint(0, 60, (h, w, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(n_people):
        cy, cx = rng.uniform(0.2 * h, 0.8 * h), rng.uniform(0.15 * w, 0.85 * w)
        s = rng.uniform(40, 90)
        col = rng.uniform(120, 255, 3)
        head = np.exp(-(((yy - (cy - 1.2 * s)) ** 2 + (xx - cx) ** 2) / (2 * (0.35 * s) ** 2)))
        torso = np.exp(-(((yy - cy) / (1.0 * s)) ** 2 + ((xx - cx) / (0.45 * s)) ** 2))
        for arm in (-1, 1):
            ax = cx + arm * 0.8 * s
            torso += np.exp(-(((yy - (cy - 0.4 * s)) / (0.7 * s)) ** 2
                              + ((xx - ax) / (0.18 * s)) ** 2))
        img += np.clip(head + torso, 0, 1)[:, :, None] * col[None, None, :]
    return np.clip(img, 0, 255).astype(np.uint8)


def local_maxima(sm, thr, margin=0.0):
    """{(joint, row, col)}: interior cells above thr that exceed each of
    their 8 neighbours by more than margin."""
    h, w, _ = sm.shape
    c = sm[1:-1, 1:-1]
    mask = c > thr
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                mask &= c > sm[1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx] + margin
    return {(int(j), int(y) + 1, int(x) + 1) for y, x, j in zip(*np.nonzero(mask))}


def keypoints_agree(sm_a: np.ndarray, sm_b: np.ndarray, what: str):
    """The multi-person keypoints of two (h, w, J) maps agree: with d the
    largest |a - b| and the threshold thr a's 0.999 quantile, every cell
    that stands clear (above thr + d and above each neighbour by more than
    2d) in either map is a strict local maximum above thr - d in the other,
    which d cannot change; -> (clear maxima of a, d). A disagreement joins
    S_FAILURES."""
    d = float(np.abs(sm_a - sm_b).max())
    thr = float(np.quantile(sm_a, 0.999))
    clear_a, clear_b = (local_maxima(m, thr + d, 2 * d) for m in (sm_a, sm_b))
    if not clear_a or not clear_a <= local_maxima(sm_b, thr - d) \
            or not clear_b <= local_maxima(sm_a, thr - d):
        S_FAILURES.append(f"{what}: {len(clear_a)} / {len(clear_b)} clear maxima, maps within "
                          f"{d:.3g}: {sorted(clear_a ^ clear_b)[:10]}")
    return len(clear_a), d


def _s1_pose(spec: dict, mesh) -> dict:
    """S1: PoseSolver at full width on one frame, S_STEPS f32 steps (TF32
    off, deterministic cuDNN; the weights kept after each), the eval hook
    decoding a frame at iteration 0 on the coordinator; on the mesh a
    snapshot after each step (`_s1_replay` takes the next step from it in
    one process) and the second step again from the first snapshot in
    another summation order (`_other_order`); then one -mixed_precision
    step from the same weights on the same batch."""
    from deepcut_tpu_torch.solver.solver import PoseSolver

    cfg = deepercut_config(spec["depth"], pairwise=False)
    feed = itertools.cycle(spec["pose_batches"])
    dev = mesh.device if mesh is not None else spec["device"]
    poses = []

    def eval_fn(params, it):
        est = PoseEstimator(params, cfg, folded=False, device=dev)
        poses.append(est.estimate_pose(spec["eval_frame"]))

    def weights(solver):
        return {n: solver.net_params[n]["w"].detach().cpu().numpy().copy() for n in S_POSE_BLOBS}

    sync = torch.device(dev).type == "cuda"
    with _deterministic():
        solver = PoseSolver(spec["pose_sp"], cfg, lambda: next(feed),
                            net_params=tame_params(cfg), mesh=mesh, target_cfg=spec["tcfg"],
                            target_stats=spec["stats"], handle_signals=False,
                            log=lambda *_: None, eval_fn=eval_fn,
                            device=None if mesh is not None else dev)
        out = {"before": weights(solver), "poses": poses, "ms": [], "losses": [],
               "steps": [], "snapshots": []}
        for k in range(1, S_STEPS + 1):
            ms, losses = _timed_steps(solver, 1, sync)
            out["ms"] += ms
            out["losses"] += losses
            out["steps"].append(weights(solver))
            if mesh is not None:
                Path(solver.params_cfg.snapshot_prefix).parent.mkdir(parents=True,
                                                                     exist_ok=True)
                out["snapshots"].append(solver.snapshot(export_caffemodel=False))
        out["weights"] = out["steps"][-1]
        if mesh is not None:
            solver.restore(out["snapshots"][0])
            with _other_order(dev):
                solver.step(1)
            out["reordered"] = (float(solver._loss_window[-1]), weights(solver),
                                _worst_leaf(solver, out["snapshots"][1]))
        if torch.device(dev).type == "cuda":
            out["profile"] = _device_profile(lambda: solver.step(1), steps=2)[:2]
        del solver
        mixed = PoseSolver(spec["pose_sp"], dataclasses.replace(cfg, mixed_train=True),
                           lambda: spec["pose_batches"][0], net_params=tame_params(cfg),
                           mesh=mesh, target_cfg=spec["tcfg"], target_stats=spec["stats"],
                           handle_signals=False, log=lambda *_: None,
                           device=None if mesh is not None else dev)
        out["mixed_ms"], out["mixed_losses"] = _timed_steps(
            mixed, 1, torch.device(dev).type == "cuda")
    return out


def _other_order(dev):
    """Other summation orders for the convolutions inside: cuDNN's
    benchmark-chosen algorithms on the card, oneDNN off on the CPU."""
    if torch.device(dev).type == "cuda":
        cudnn = torch.backends.cudnn
        return torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                                          allow_tf32=cudnn.allow_tf32)
    return torch.backends.mkldnn.flags(enabled=False)


def _worst_leaf(solver, path: str):
    """The largest gap of any param or solver-state leaf of `solver` from
    the snapshot at `path`, over that leaf's largest magnitude: -> (gap,
    leaf)."""
    from deepcut_tpu_torch.solver.solver import load_checkpoint

    params, state = load_checkpoint(path)
    trees = [("", params, solver.net_params)] + [
        (f"{key} ", state[key], solver.state[key]) for key in state if key != "iter"]
    worst = (0.0, "")
    for tag, want, live in trees:
        for n, entry in want.items():
            for k, v in entry.items():
                gap = _rel_gap(live[n][k].detach().cpu().numpy(), np.asarray(v))
                if gap > worst[0]:
                    worst = (gap, f"{tag}{n}.{k}")
    return worst


def _s1_replay(spec: dict, snapshots) -> dict:
    """S1's witness in one process: from the ranks' snapshot after step k,
    step k + 1 alone ("steps": its loss, its weights and the worst leaf
    against the ranks' snapshot after step k + 1), and from the first
    snapshot every later step ("free": where one process's own trajectory
    goes from the ranks' first step)."""
    from deepcut_tpu_torch.solver.solver import PoseSolver

    cfg = deepercut_config(spec["depth"], pairwise=False)
    feed = itertools.cycle(spec["pose_batches"])
    out = {"steps": [], "free": []}

    def taken(solver):
        return (float(solver._loss_window[-1]),
                {n: solver.net_params[n]["w"].detach().cpu().numpy().copy() for n in S_POSE_BLOBS})

    with _deterministic():
        solver = PoseSolver(spec["pose_sp"], cfg, lambda: next(feed),
                            net_params=tame_params(cfg), target_cfg=spec["tcfg"],
                            target_stats=spec["stats"], handle_signals=False,
                            log=lambda *_: None, device=spec["device"])
        for k in range(1, S_STEPS):
            solver.restore(snapshots[k - 1])
            solver.step(1)
            out["steps"].append(taken(solver) + (_worst_leaf(solver, snapshots[k]),))
            if k == 1:
                out["free"].append(taken(solver))
                for _ in range(S_STEPS - 2):
                    solver.step(1)
                    out["free"].append(taken(solver))
    return out


def _s2_graph(spec: dict, mesh) -> dict:
    """S2: E(b)'s ResNet prototxt with the heads' losses through GraphSolver
    on the staged batch (deterministic cuDNN): the first step's loss and
    update (as E(b)), then S_STEPS steps timed; the split it logged."""
    from deepcut_tpu_torch.core.graph import Net
    from deepcut_tpu_torch.solver.solver import GraphSolver

    dev = mesh.device if mesh is not None else spec["device"]
    lines = []
    with _deterministic():
        net = Net(spec["graph_proto"], weights=spec["graph_weights"], phase="TRAIN",
                  compute_dtype=None, device=dev)
        solver = GraphSolver(spec["graph_sp"], net, mesh=mesh, handle_signals=False,
                             log=lines.append, device=None if mesh is not None else dev)
        solver.extra_inputs = {k: torch.from_numpy(v).to(dev) for k, v in spec["staged"].items()}
        before = {n: net.params[n]["w"].detach().cpu().numpy().copy() for n in ENGINE_POSE_BLOBS}
        solver.step(1)
        out = {"loss": float(solver._loss_window[-1]),
               "weights": {n: net.params[n]["w"].detach().cpu().numpy().copy() for n in before},
               "before": before,
               "log": [ln for ln in lines if ln.startswith("spatial graph")], "boundary": None}
        out["ms"], out["losses"] = _timed_steps(solver, S_STEPS, torch.device(dev).type == "cuda")
        plans = list(getattr(solver._step_fn, "plans", {}).values())
        if plans:
            boundary, _, _, gather = plans[0]
            out["boundary"] = (boundary, net._plan[boundary][1].name, len(net._plan), gather)
        if torch.device(dev).type == "cuda":
            out["profile"] = _device_profile(lambda: solver.step(1), steps=2)[:2]
    solver.close()
    return out


def _s3_serving(spec: dict, mesh) -> dict:
    """S3: PoseEstimator(max_size=S_HD[1]) in bf16 over the HD frame and the
    688x688 frame, its pose through the decode's probability-map entry, then
    int8 calibrated on a 480x640 frame over the HD frame; each scoremaps
    call timed."""
    dev = mesh.device if mesh is not None else spec["device"]
    cuda = torch.device(dev).type == "cuda"
    params = spec["serve_params"]
    cfg = deepercut_config(spec["depth"])
    est = PoseEstimator({n: {k: torch.from_numpy(v) for k, v in e.items()}
                         for n, e in params.items()}, cfg, max_size=S_HD[1], mesh=mesh,
                        device=dev)
    out = {"maps": {}, "ms": {}, "profile": {}}
    for name, img in (("hd", spec["hd"]), ("688", spec["f688"])):
        out["maps"][name] = est.scoremaps(img)
        if cuda:
            out["ms"][name] = _events_ms(lambda: est.scoremaps(img), iters=3, warmup=1)
            out["profile"][name] = _device_profile(lambda: est.scoremaps(img), steps=2)[:2]
    out["pose"] = est.estimate_pose(spec["hd"])
    del est
    est8 = PoseEstimator({n: {k: torch.from_numpy(v) for k, v in e.items()}
                          for n, e in params.items()}, cfg, max_size=S_HD[1], mesh=mesh,
                         device=dev)
    est8.quantize_int8(spec["calib"])
    out["scales"] = dict(est8.model.act_scales)
    out["maps"]["int8"] = est8.scoremaps(spec["hd"])
    if cuda:
        out["ms"]["int8"] = _events_ms(lambda: est8.scoremaps(spec["hd"]), iters=3, warmup=1)
        out["profile"]["int8"] = _device_profile(lambda: est8.scoremaps(spec["hd"]), steps=2)[:2]
    return out


def _s_rank(rank: int, port: int, spec_path: str, out_dir: str, spawned: float) -> None:
    """One of S's two ranks: a gloo group on localhost, a (1, 2) mesh over
    CUDA tensors; its launches counted and its new launch geometries
    replayed against the plain kernels. `spawned`: the parent's time.time()
    at the spawn (the rank logs its start-up and its steps' seconds)."""
    import pickle

    log(f"S rank {rank}: started {time.time() - spawned:.1f} s after its spawn")
    time_phases(globals())

    from deepcut_tpu_torch.parallel import distributed
    from deepcut_tpu_torch.parallel.mesh import make_mesh

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    dev = distributed.initialize(f"tcp://127.0.0.1:{port}", 2, rank, device=spec["device"],
                                 backend="gloo")
    try:
        mesh = make_mesh(2, spatial=2, device=dev)
        if spec["device"] != "cpu":
            _zero_counts()
            _record_geometries(True)
        out = {"s1": _s1_pose(spec, mesh), "s2": _s2_graph(spec, mesh),
               "s3": _s3_serving(spec, mesh)}
        if spec["device"] != "cpu":
            out["counts"] = _counts()
            recorded = _record_geometries(False)
            out["replayed"] = replay_path_geometries(recorded, device=str(dev))
            out["im2col_pads"] = sorted({g[3] for g in recorded.get("int8_im2col", {})})
        with open(Path(out_dir) / f"s_rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        distributed.shutdown()


def _rel_gap(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


S_FAILURES: list = []   # phase S's readings outside their bounds, raised after its log


def _held(what: str, gap: float, bound: float) -> str:
    """gap as text; a gap above bound joins S_FAILURES."""
    if not gap <= bound:
        S_FAILURES.append(f"{what}: {gap:.3g} apart from one process (held to {bound})")
    return f"{gap:.3g}"


def phase_spatial(root: Path, card: str, device: str = "cuda", depth: int = 152,
                  size: int = 688, hd=S_HD, tile: int = S_TILE) -> dict:
    """S: the spatial axis on two spawned ranks of a (1, 2) mesh on the one
    card, over gloo, against one process: S1 PoseSolver at full width, S2
    the graph engine's spatial step, S3 HD serving (bf16 and int8), each
    compared and timed (one card over gloo: not a scaling measurement).
    `device`, `depth`, `size`, `hd` and `tile` other than the card's are
    for rehearsing off the card."""
    import multiprocessing as mp
    import pickle

    from deepcut_tpu_torch.models.convert import save_caffemodel
    from deepcut_tpu_torch.parallel.train_step import to_device
    from deepcut_tpu_torch.solver.solver import SolverParams

    cfg = deepercut_config(depth, pairwise=False)
    pose_sp, tcfg, stats, batches = pose_batches(root, "s1", 1, 1, size)
    pose_sp.config = dataclasses.replace(pose_sp.config, base_lr=M3_POSE_LR,
                                         stagelr=tuple(M3_POSE_LR for _ in pose_sp.config.stagelr))
    pose_sp.test_interval = 10 ** 6       # the eval hook at iteration 0 only
    # S2: E(b)'s net and staged batch (dense host targets), at M3's rate
    graph_sp = SolverParams.from_prototxt(str(write_solver(
        root, write_frames(root / "s2_frames", np.random.RandomState(SEED), 1, size, size),
        "s2", 10 ** 6, 0, display=0, no_jitter=True)))
    graph_sp.config = dataclasses.replace(graph_sp.config, base_lr=M3_POSE_LR,
                                          stagelr=tuple(M3_POSE_LR for _ in graph_sp.config.stagelr))
    from deepcut_tpu_torch.tools.cli import pose_data

    _, _, src, _ = pose_data(graph_sp, host_targets=True, workers=0)
    try:
        batch = src.next_batch(1)
    finally:
        src.close()
    weights = root / "s2_tamed.caffemodel"
    save_caffemodel(str(weights), tame_params(cfg))
    host = to_device(batch, "cpu")
    staged = {k: v.contiguous().numpy() for k, v in host.items() if k != "image"}
    staged["data"] = (host["image"].float() - torch.tensor(MEAN_BGR_T).reshape(1, 3, 1, 1)).numpy()
    serve = tame_params(deepercut_config(depth))
    for n in ("res5c_up_pose", "res3d_pose"):   # unsaturated pose maps: strict maxima exist
        serve[n] = {k: v / 30.0 for k, v in serve[n].items()}
    rng = np.random.RandomState(SEED + 9)
    spec = {"device": "cuda:0" if device == "cuda" else device, "depth": depth,
            "pose_sp": pose_sp, "tcfg": tcfg, "stats": stats, "pose_batches": batches,
            "eval_frame": frame(rng, 480, 640),
            "graph_proto": str(engine_pose_prototxt(root, cfg, batch)),
            "graph_weights": str(weights), "graph_sp": graph_sp, "staged": staged,
            "serve_params": {n: {k: v.numpy() for k, v in e.items()} for n, e in serve.items()},
            "hd": draw_people(hd[0], hd[1], 4, rng), "f688": frame(rng, size, size),
            "calib": frame(rng, 480, 640)}
    spec_path = root / "s_spec.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    t0 = time.perf_counter()
    single = {"s1": _s1_pose(spec, None), "s2": _s2_graph(spec, None)}
    # one process's serving on the ranks' conv routes: their row blocks'
    # halo geometry leaves conv3x3's rule, so every conv is cuDNN's
    # (conv3x3 against cuDNN is phase G's `CONV3X3_MAP_STEPS`)
    with _cudnn_routes():
        single["s3"] = _s3_serving(spec, None)
    if device == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_s_rank,
                         args=(r, port, str(spec_path), str(root), time.time()))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(S_JOIN_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if [p.exitcode for p in procs] != [0, 0]:
        raise AssertionError(f"S: the ranks exited {[p.exitcode for p in procs]} (gloo over "
                             "CUDA tensors, a (1, 2) mesh on one card; their errors are above)")
    t2 = time.perf_counter()
    ranks = []
    for r in range(2):
        with open(root / f"s_rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))

    # S1
    want = single["s1"]
    replay = _s1_replay(spec, ranks[0]["s1"]["snapshots"])

    def step_gaps(loss, w, w_prev, loss_ref, w_ref, w_ref_prev):
        """One step against another from the same state (or the same init):
        {what: (gap, bound)} at M3's bounds."""
        gaps = {"loss": (_rel_gap([loss], [loss_ref]), S_LOSS_RTOL),
                "conv1 update": (_rel_gap(w_prev["conv1"] - w["conv1"],
                                          w_ref_prev["conv1"] - w_ref["conv1"]), S_CONV1_RTOL)}
        gaps.update({n: (_rel_gap(w[n], w_ref[n]),
                         S_CONV1_RTOL if n == "conv1" else S_WEIGHT_RTOL) for n in S_POSE_BLOBS})
        return gaps

    def held_txt(what, gaps):
        return ", ".join(f"{k} {_held(f'{what} {k}', g, b)} (held to {b})"
                         for k, (g, b) in gaps.items())

    per_step = []
    for r, res in enumerate(ranks):
        got = res["s1"]
        texts = [held_txt(f"S1 rank {r} step 1", step_gaps(
            got["losses"][0], got["steps"][0], got["before"], want["losses"][0],
            want["steps"][0], want["before"]))]
        for k in range(1, S_STEPS):     # step k + 1 from rank 0's snapshot after step k
            loss, w, _ = replay["steps"][k - 1]
            texts.append(held_txt(f"S1 rank {r} step {k + 1} (from the ranks' step {k})",
                                  step_gaps(got["losses"][k], got["steps"][k],
                                            ranks[0]["s1"]["steps"][k - 1], loss, w,
                                            ranks[0]["s1"]["steps"][k - 1])))
        per_step.append("; ".join(f"step {k + 1}: {t}" for k, t in enumerate(texts)))
        traj = {"losses": (_rel_gap(got["losses"], want["losses"]), S_TRAJ_LOSS_RTOL)}
        traj.update({n: (_rel_gap(got["weights"][n], want["weights"][n]),
                         S_TRAJ_CONV1_RTOL if n == "conv1" else S_WEIGHT_RTOL)
                     for n in S_POSE_BLOBS})
        traj_txt = held_txt(f"S1 rank {r} step {S_STEPS}", traj)
        mixed = _held(f"S1 -mixed_precision rank {r} loss",
                      _rel_gap(got["mixed_losses"], want["mixed_losses"]), S_MIXED_LOSS_RTOL)
    # the witnesses: one process's own trajectory from the ranks' first
    # step; every leaf of each step against one process's from the same
    # state; the ranks' second step in another summation order
    free = [loss for loss, _ in replay["free"]]
    amp_loss = _rel_gap(want["losses"][:1] + free, want["losses"])
    amp_conv1 = _rel_gap(replay["free"][-1][1]["conv1"], want["weights"]["conv1"])
    leaves = ", ".join(f"step {k + 2} {g:.3g} ({leaf})"
                       for k, (_, _, (g, leaf)) in enumerate(replay["steps"]))
    r_loss, r_w, (r_gap, r_leaf) = ranks[0]["s1"]["reordered"]
    reordered = (f"loss {_rel_gap([r_loss], ranks[0]['s1']['losses'][1:2]):.3g}, conv1 update "
                 + "{:.3g}".format(_rel_gap(ranks[0]["s1"]["steps"][0]["conv1"] - r_w["conv1"],
                                            ranks[0]["s1"]["steps"][0]["conv1"]
                                            - ranks[0]["s1"]["steps"][1]["conv1"]))
                 + f", every leaf {r_gap:.3g} ({r_leaf})")
    twins = max(float(np.abs(a[n] - b[n]).max()) for a, b in
                zip(ranks[0]["s1"]["steps"], ranks[1]["s1"]["steps"]) for n in S_POSE_BLOBS)
    if len(ranks[0]["s1"]["poses"]) != 1 or ranks[1]["s1"]["poses"] or not all(
            np.isfinite(p).all() for p in ranks[0]["s1"]["poses"]):
        raise AssertionError("S1: the eval hook ran off the coordinator or gave a bad pose")
    log(f"S1 PoseSolver ResNet-{depth}, {size}x{size} frame (canvas "
        f"{batches[0]['image'].shape[1]}), batch 1, f32 (TF32 off), deterministic cuDNN, "
        f"(data=1, spatial=2) over gloo against one process: losses "
        f"{', '.join(f'{v:.7f}' for v in want['losses'])} (one process), "
        f"{', '.join(f'{v:.7f}' for v in ranks[0]['s1']['losses'])} (two ranks); relative gaps "
        f"(weights and updates over their largest magnitude) of each step against one "
        f"process's step from the same state (step 1 from the init, each later step from the "
        f"ranks' snapshot of the step before): " + " | ".join(per_step)
        + f"; the free trajectory after {S_STEPS} steps: {traj_txt}; the witnesses: one process "
        f"from the ranks' step-1 snapshot reaches step {S_STEPS} {amp_loss:.3g} (losses) and "
        f"{amp_conv1:.3g} (conv1) from its own trajectory; the largest gap of any param or "
        f"momentum leaf from one process's step from the same state: {leaves}; the ranks' step 2 "
        f"from the same state in another summation order against their own: {reordered}; the "
        f"two ranks' weights differ by "
        f"at most {twins:.3g}; -mixed_precision step loss {want['mixed_losses'][0]:.6f}, "
        f"relative {mixed} (held to {S_MIXED_LOSS_RTOL}); the eval hook decoded on rank 0 alone")
    # S2
    want = single["s2"]
    for r, res in enumerate(ranks):
        got = res["s2"]
        gaps = {"loss": (_rel_gap([got["loss"]], [want["loss"]]), S_LOSS_RTOL),
                "conv1 update": (_rel_gap(got["before"]["conv1"] - got["weights"]["conv1"],
                                          want["before"]["conv1"] - want["weights"]["conv1"]),
                                 S_CONV1_RTOL)}
        gaps.update({n: (_rel_gap(got["weights"][n], want["weights"][n]),
                         S_CONV1_RTOL if n == "conv1" else S_WEIGHT_RTOL)
                     for n in ENGINE_POSE_BLOBS})
        parts = ", ".join(f"{k} {_held(f'S2 rank {r} {k}', g, b)} (held to {b})"
                          for k, (g, b) in gaps.items())
    boundary = ranks[0]["s2"]["boundary"]
    if boundary is None or not boundary[1].startswith(("res5c_up_", "res3d_")) \
            or ranks[1]["s2"]["log"] or len(ranks[0]["s2"]["log"]) != 1:
        raise AssertionError(f"S2: the split {boundary}, logged {ranks[0]['s2']['log']} / "
                             f"{ranks[1]['s2']['log']}: the trunk should shard up to the heads")
    log(f"S2 GraphSolver on {Path(spec['graph_proto']).name} (ResNet-{depth} + the heads' "
        f"losses), (1, 2) mesh against one process: {ranks[0]['s2']['log'][0]}; the first "
        f"step's loss {want['loss']:.6f}; relative gaps (weights and conv1's update over their "
        f"largest magnitude): {parts}; then losses "
        + ", ".join(f"{v:.6f}" for v in want["losses"])
        + " (one process), " + ", ".join(f"{v:.6f}" for v in ranks[0]["s2"]["losses"])
        + " (two ranks)")
    # S3
    want = single["s3"]
    lines = []
    for r, res in enumerate(ranks):
        if res["s3"]["scales"] != want["scales"]:
            raise AssertionError(f"S3 int8 rank {r}: calibration scales differ from one "
                                 "process's")
    for name in ("hd", "688", "int8"):
        worst = 0.0
        for r, res in enumerate(ranks):
            steps = 0.0
            for g, w in zip(res["s3"]["maps"][name], want["maps"][name]):
                g, w = torch.from_numpy(g), torch.from_numpy(w)
                if g.shape != w.shape:
                    raise AssertionError(f"S3 {name} rank {r}: maps {g.shape} against {w.shape}")
                steps = max(steps, _steps_bf16(g, w, torch.full_like(w, float(w.abs().max()))))
            if not steps <= S_MAP_STEPS:
                S_FAILURES.append(f"S3 {name} rank {r}: {steps} bf16 steps off one process "
                                  f"(held to {S_MAP_STEPS})")
            worst = max(worst, steps)
        lines.append(f"{name} maps {tuple(g.shape)} within {worst:.3g} bf16 steps at each "
                     f"map's largest magnitude"
                     + (f" ({len(want['scales'])} scales equal to one process's)"
                        if name == "int8" else ""))
    try:
        agreement(ranks[0]["s3"]["pose"], want["pose"], "S3 HD pose (the decode's prob entry) "
                  "against one process's")
    except AssertionError as e:
        S_FAILURES.append(str(e))
    # the keypoints: the mesh's against one process's full frame and the tiled path
    tiled = PoseEstimator({n: {k: torch.from_numpy(v) for k, v in e.items()}
                           for n, e in spec["serve_params"].items()}, deepercut_config(depth),
                          max_size=tile, device=spec["device"])
    sm_m = ranks[0]["s3"]["maps"]["hd"][0]
    for what, other in (("one process", want["maps"]["hd"][0]),
                        (f"the tiled path (max_size {tile})", tiled.scoremaps(spec["hd"])[0])):
        n, d = keypoints_agree(sm_m, other, f"S3 keypoints against {what}")
        lines.append(f"{n} clear strict local maxima as {what}'s (maps within {d:.3g})")
    del tiled
    log(f"S3 PoseEstimator(max_size={hd[1]}, mesh=(1, 2)) ResNet-{depth} bf16 on a "
        f"{hd[0]}x{hd[1]} frame and a {size}x{size} frame against one process: "
        + "; ".join(lines))
    counts = {k: sum(res.get("counts", {}).get(k, 0) for res in ranks) for k in KERNELS}
    if device == "cuda":
        pads = sorted({p for res in ranks for p in res["im2col_pads"]})
        if not any(p[0] != p[1] for p in pads):
            raise AssertionError(f"S: no int8_im2col launch with pad_h != pad_w ({pads})")
        log(f"S: the ranks' new launch geometries replayed against the plain kernels, bit for "
            f"bit: {ranks[0]['replayed']} (rank 0), {ranks[1]['replayed']} (rank 1); "
            f"int8_im2col pads {pads}")
        busy = lambda res, k: "{:.3f} ms busy, {:.0f} ops".format(*res[k])  # noqa: E731
        log(f"time [{card}]: S (one card, two gloo ranks, not a scaling figure) S1 "
            f"PoseSolver.step ResNet-{depth} batch 1 f32: one process "
            + ", ".join(f"{v:.3f}" for v in single["s1"]["ms"]) + f" ms ({busy(single['s1'], 'profile')}"
            "); two ranks " + " | ".join(", ".join(f"{v:.3f}" for v in res["s1"]["ms"])
                                         + f" ({busy(res['s1'], 'profile')})" for res in ranks)
            + f" ms; mixed step one process {single['s1']['mixed_ms'][0]:.3f} ms, two ranks "
            + " | ".join(f"{res['s1']['mixed_ms'][0]:.3f}" for res in ranks)
            + f" ms. S2 GraphSolver.step: one process "
            + ", ".join(f"{v:.3f}" for v in single["s2"]["ms"]) + f" ms ({busy(single['s2'], 'profile')}"
            "); two ranks " + " | ".join(", ".join(f"{v:.3f}" for v in res["s2"]["ms"])
                                         + f" ({busy(res['s2'], 'profile')})" for res in ranks)
            + " ms (wall per step). S3 scoremaps (CUDA events per call; device busy per call "
            "from the profiler): " + "; ".join(
                f"{name}: one process {single['s3']['ms'][name]:.3f} ms "
                f"({busy(single['s3']['profile'], name)}), two ranks "
                + " | ".join(f"{res['s3']['ms'][name]:.3f} ms ({busy(res['s3']['profile'], name)})"
                             for res in ranks) for name in ("hd", "688", "int8")))
    log(f"phase S: one process {t1 - t0:.1f} s, the two ranks {t2 - t1:.1f} s with their start")
    if S_FAILURES:
        raise AssertionError("S: " + "; ".join(S_FAILURES))
    return {"single": single, "ranks": ranks, "counts": counts}


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


def _device_profile(fn, steps: int, top: int = 0, copies: bool = True, check: bool = False):
    """(device ms, device ops, the `top` kernels by device ms with their
    launches) per call of `fn`, from torch.profiler's device events over
    `steps` calls after as many warm-up calls under the profiler; with
    `copies` False the device's copies and fills (Memcpy, Memset) are left
    out. The tracer still drops a window's launches now and then (some or
    all of them; without the warm-up more often, at a window's start), so a
    total per call may read low: `_kernel_device_us` divides by the
    launches it recorded, and a window that lost some is read again where
    a count must be exact.

    The sums are taken over the profiler's raw events, filtered and named
    as `key_averages` names them: `key_averages` first parses every CPU op
    of the window into Python objects, which took most of the host time of
    a training step's window (seconds each). `check`: also read
    `key_averages` and flag a difference (PROFILER_FLAGS)."""
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    from torch.profiler import ProfilerActivity, profile, schedule

    skip = ("ProfilerStep",) if copies else ("ProfilerStep", "Memcpy", "Memset")
    torch.cuda.synchronize()  # no earlier work inside the window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    kernels = {}   # name -> [device ms, launches]
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA or _filter_name(e.name())
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        name = _rewrite_name(name=e.name(), with_wildcard=True)
        if not name.startswith(skip):
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += e.duration_ns() / 1e6
            k[1] += 1
    busy = sum(ms for ms, _ in kernels.values())
    ops = sum(n for _, n in kernels.values())
    if check:
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith(skip)]
        kbusy = sum(e.self_device_time_total for e in events) / 1000.0
        kops = sum(e.count for e in events)
        same = kops == ops and abs(kbusy - busy) <= 1e-6 * max(kbusy, 1e-9) + 1e-6
        log(f"profiler accounting: raw events {busy:.6f} ms over {ops} device ops, key_averages "
            f"{kbusy:.6f} ms over {kops}" + ("" if same else " (flagged: they differ)"))
        if not same:
            PROFILER_FLAGS.append(f"the raw device events ({busy:.6f} ms, {ops} ops) differ from "
                                  f"key_averages ({kbusy:.6f} ms, {kops} ops)")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return busy / steps, ops / steps, [(name, ms / steps, n / steps) for name, (ms, n) in ranked]


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
            # the raw-event accounting checked against key_averages once
            busy, ops, ranked = _device_profile(fn, steps=10, top=6,
                                                check=(label, bs, fn) == ("bf16", 1, forward))
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
    computing the same function; the decode's probability-map entry at the
    shapes its paths launch (PROB_SHAPES) in the same call."""
    from deepcut_tpu_torch.ops import conv_epilogue

    rng = np.random.RandomState(SEED + 3)
    n, h, w = 4, 88, 88
    logits = torch.from_numpy((rng.randn(n, h, w, J) * 3).astype(np.float32)).to(torch.bfloat16).float()
    loc = torch.from_numpy(rng.randn(n, h, w, 2 * J).astype(np.float32))
    fused = torch.cat([logits, loc], -1).cuda().permute(0, 3, 1, 2)
    vh = vw = [h] * n
    vht = torch.full((n,), h, dtype=torch.int32, device="cuda")
    rows = torch.arange(h, device="cuda").reshape(1, 1, -1, 1)
    masked = torch.where(rows < vht.reshape(-1, 1, 1, 1), torch.sigmoid(fused[:, :J]), float("-inf"))
    it = 500
    fn = lambda: cuda_decode.decode_fused(fused, J, vh, vw)  # noqa: E731
    ms = _events_ms(fn, it)
    plain_ms = _events_ms(lambda: cuda_decode.decode_fused_plain(fused, J, vh, vw), it)
    library_ms = _events_ms(lambda: torch.max(masked.flatten(2), 2), it)
    cells = n * J * h * w
    out = {"decode_pose": dict(shape=[n, 3 * J, h, w], ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms,
                               bound_ms=_bound_ms(cells * 4 + n * J * 2 * 4 + n * 5 * J * 4))}
    dev = _kernel_device_us("decode_pose", fn, 50, out["decode_pose"]["bound_ms"])
    log(f"time [{card}]: decode fused entry at {(n, 3 * J, h, w)}: {ms * 1000:.2f} us per call "
        f"(CUDA events over {it} calls), device time {dev}, plain PyTorch {plain_ms * 1000:.2f} "
        f"us, torch.max over masked prob {library_ms * 1000:.2f} us, bound "
        f"{out['decode_pose']['bound_ms'] * 1000:.3f} us")
    out["decode_pose_prob"] = prob_entry_times(card)[PROB_RECORD_SHAPE]

    shape = (4, 512, 88, 88)                  # a res3 block end: residual and ReLU
    y, bias, res = _epilogue_case(rng, shape, True)
    ms = _events_ms(lambda: conv_epilogue.conv_epilogue(y, bias, res, True), 200)
    plain_ms = _events_ms(lambda: conv_epilogue.conv_epilogue_plain(y, bias, res, True), 50)
    numel = y.numel()
    out["conv_epilogue"] = dict(shape=list(shape), ms=ms, plain_ms=plain_ms, library_ms=None,
                                bound_ms=_bound_ms(numel * 4 * 3 + shape[1] * 4))
    dev = _kernel_device_us("conv_epilogue", lambda: conv_epilogue.conv_epilogue(y, bias, res, True),
                            50, out["conv_epilogue"]["bound_ms"])
    log(f"time [{card}]: conv_epilogue at {shape} with residual and ReLU: {ms * 1000:.2f} us per "
        f"call, device time {dev}, plain PyTorch "
        f"{plain_ms * 1000:.2f} us, bound {out['conv_epilogue']['bound_ms'] * 1000:.2f} us "
        f"(reads y and the residual, writes y)")
    out["conv3x3"] = conv3x3_times(card)
    return out


def conv3x3_times(card: str) -> dict:
    """conv3x3 at each stage of the trunk (CONV3X3_STAGES), batch 4 and 1
    on the 704 canvas: device time per conv from a CUDA graph of 20
    launches (no host time) beside cuDNN's TF32 route (`exact_conv`, the
    route it replaces, as `library_ms`) and the FLOP bound at the card's
    bf16 rate; the sums over a forward's 50 convs. The JSON record's
    shape is res4 at batch 4, the stage of 36 of the 50."""
    from deepcut_tpu_torch.ops import conv3x3
    from deepcut_tpu_torch.ops.conv import exact_conv

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    record, sums = None, {}
    for n in (4, 1):
        for stage, (c, hw, dil, convs) in CONV3X3_STAGES.items():
            x, w = _conv3x3_case(gen, (n, c, hw, hw), c)
            wk = conv3x3.pack(w)
            with torch.inference_mode():
                ms = {"conv3x3": _graph_device_ms(lambda: [conv3x3.conv3x3(x, wk, dil)
                                                           for _ in range(20)]) / 20,
                      "cudnn": _graph_device_ms(lambda: [exact_conv(x, w, pad=dil, dilation=dil)
                                                         for _ in range(20)]) / 20}
            flops = 2.0 * n * hw * hw * c * c * 9
            bound_ms = flops / BF16_FLOPS * 1e3
            for k, v in ms.items():
                sums[(n, k)] = sums.get((n, k), 0.0) + v * convs
            log(f"time [{card}]: conv3x3 {stage} batch {n} ({n}, {c}, {hw}, {hw}) d={dil}: "
                f"{ms['conv3x3'] * 1000:.2f} us a conv ({flops / ms['conv3x3'] / 1e9:.0f} "
                f"TFLOP/s, {100 * bound_ms / ms['conv3x3']:.1f}% of the bf16 peak), cuDNN's "
                f"TF32 route {ms['cudnn'] * 1000:.2f} us ({ms['cudnn'] / ms['conv3x3']:.2f}x), "
                f"FLOP bound {bound_ms * 1000:.2f} us (device time, CUDA graph of 20)")
            if (n, stage) == (4, "res4"):
                plain_ms = _events_ms(lambda: conv3x3.conv3x3_plain(x, wk, dil), 20)
                record = dict(shape=[n, c, hw, hw], ms=ms["conv3x3"], plain_ms=plain_ms,
                              library_ms=ms["cudnn"], bound_ms=bound_ms)
        k, c = sums[(n, "conv3x3")], sums[(n, "cudnn")]
        log(f"time [{card}]: conv3x3, a forward's 50 3x3 convs at batch {n} on the 704 canvas: "
            f"{k:.4f} ms, cuDNN's TF32 route {c:.4f} ms, {c / k:.2f}x")
    return record


def prob_entry_times(card: str) -> dict:
    """The decode's probability-map entry at PROB_SHAPES, every cell valid,
    as its paths launch it: per call (CUDA events), device time (profiler),
    the plain version, torch.max over the masked map of the same shape, and
    the byte bound (each valid cell's f32 read once, the two loc values per
    joint, the (N, 5, J) pose written). -> {shape: record}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    records, it = {}, 100
    for shape, what in PROB_SHAPES:
        n, _, h, w = shape
        prob = torch.rand(shape, generator=gen, device="cuda")
        loc = torch.randn((n, 2 * J, h, w), generator=gen, device="cuda")
        vh, vw = [h] * n, [w] * n
        valid = tuple(torch.tensor(v, dtype=torch.int32, device="cuda") for v in (vh, vw))
        rows = torch.arange(h, device="cuda").reshape(1, 1, -1, 1)
        cols = torch.arange(w, device="cuda").reshape(1, 1, 1, -1)
        keep = (rows < valid[0].reshape(-1, 1, 1, 1)) & (cols < valid[1].reshape(-1, 1, 1, 1))
        masked = torch.where(keep, prob, float("-inf"))
        fn = lambda: cuda_decode.decode_pose(prob, loc, vh, vw)  # noqa: E731
        ms, library_ms = _alternating_ms((fn, lambda: torch.max(masked.flatten(2), 2)), it)
        rec = dict(shape=list(shape), ms=ms, library_ms=library_ms,
                   plain_ms=_events_ms(lambda: decode_pose_batch(prob, loc, valid_hw=valid), 100),
                   bound_ms=_bound_ms(n * J * h * w * 4 + n * J * 2 * 4 + n * 5 * J * 4))
        dev = _kernel_device_us(f"decode prob entry at {shape}", fn, 50, rec["bound_ms"],
                                match="decode_prob_kernel")
        lib_dev = _kernel_device_us(f"torch.max at {shape}", lambda: torch.max(masked.flatten(2), 2),
                                    50, rec["bound_ms"])
        log(f"time [{card}]: decode prob entry at {shape} ({what}): {rec['ms'] * 1000:.2f} us "
            f"per call (CUDA events, the median of {ROUNDS} runs of {it} calls taken in turns "
            f"with torch.max's), device time {dev}, plain PyTorch "
            f"{rec['plain_ms'] * 1000:.2f} us, torch.max over the masked map "
            f"{rec['library_ms'] * 1000:.2f} us (device time {lib_dev}), bound "
            f"{rec['bound_ms'] * 1000:.3f} us")
        records[shape] = rec
    return records


ROUNDS = 5


def _alternating_ms(fns, iters: int, rounds: int = ROUNDS, before=None) -> list:
    """The median over `rounds` of each fn's CUDA-event ms per call over
    `iters` calls, the fns timed in turns (forward, then backward order),
    so that a drift of the host's speed falls on each alike; `before` as
    `_events_ms` takes it."""
    times = [[] for _ in fns]
    for r in range(rounds):
        order = list(enumerate(fns))
        for k, fn in (order if r % 2 == 0 else order[::-1]):
            times[k].append(_events_ms(fn, iters, before=before))
    return [float(np.median(t)) for t in times]


def path_times(est, card: str) -> None:
    """The paths the probability-map entry lies on, bf16: estimate_pose on a
    720x1280 frame (the tiled path) and estimate_pose_avg at PYRAMID_SCALES
    on a 688x688 frame, each's wall (CUDA events), device busy, idle share
    and kernels per call; then the profiler's kernels per `_decode_whole`
    call on each path's own maps, which must be the prob entry alone."""
    rng = np.random.RandomState(SEED + 13)
    hd, f688 = frame(rng, 720, 1280), frame(rng, 688, 688)
    paths = ((f"estimate_pose 720x1280 frame (the tiled path, max_size {est.max_size})",
              lambda: est.estimate_pose(hd)),
             (f"estimate_pose_avg 688x688 frame, scales {PYRAMID_SCALES}",
              lambda: est.estimate_pose_avg(f688, PYRAMID_SCALES)))
    with decoded_wholes(est) as decoded:
        for _, fn in paths:
            fn()
    for what, fn in paths:
        _profiled(card, f"{what}, bf16", fn, bs=1, iters=10, steps=3, top=4)
    for (prob, loc, scale, _, _), (what, _) in zip(decoded, paths):
        for _ in range(5):   # until a window keeps all its launches (see _device_profile)
            _, _, ranked = _device_profile(lambda: est._decode_whole(prob, loc, scale), steps=20,
                                           top=64, copies=False)
            kernels = {name: n for name, _, n in ranked}
            if sum(kernels.values()) >= 1:
                break
        log(f"profile [{card}]: {what}: its _decode_whole of maps {tuple(prob.shape)} issues "
            f"{kernels} device kernels per call (copies apart)")
        if len(kernels) != 1 or "decode_prob_kernel" not in next(iter(kernels)) \
                or next(iter(kernels.values())) != 1:
            raise AssertionError(f"{what}: _decode_whole is not one launch of the prob entry: "
                                 f"{kernels}")


def _kernel_device_us(name: str, fn, steps: int, bound_ms: float, match: str = "") -> str:
    """The device time per launch of `fn`'s longest kernel (or its kernel
    whose name holds `match`; each of these calls launches it once) from
    the profiler, over the launches it recorded, as text, held against the
    kernel's byte bound: a reading under the bound, or a kernel the
    profiler did not record, is flagged (PROFILER_FLAGS) and rejected."""
    for _ in range(3):   # a window the tracer dropped whole is read again
        _, _, ranked = _device_profile(fn, steps=steps, top=64)
        hits = [(k, t, n) for k, t, n in ranked if match in k]
        if hits:
            break
    else:
        PROFILER_FLAGS.append(f"{name}: kernel not recorded by the profiler")
        return "not recorded by the profiler (flagged)"
    kname, dev_ms, per_call = hits[0]
    dev_ms /= per_call
    text = f"{dev_ms * 1000:.2f} us ({kname[:40]}" + (
        f"; {round(per_call * steps)} of {steps} launches recorded)" if per_call < 1 else ")")
    if dev_ms < bound_ms:
        PROFILER_FLAGS.append(f"{name}: profiler device time {dev_ms * 1000:.2f} us under its "
                              f"byte bound {bound_ms * 1000:.2f} us")
        return text + " UNDER ITS BYTE BOUND (flagged, rejected)"
    return text


def _timed(card: str, name: str, shape, fn, plain, bound_ms: float, iters: int = 200,
           before=None, match: str = "", library=None) -> dict:
    """A kernel's wrapper per call (CUDA events) at `shape` (its input's),
    its device time (profiler; its kernel's name holds `match`) and its
    plain version's time, logged beside its bound; `before` (an L2 flush)
    runs ahead of each call, outside its events. `library`, a
    (description, fn) pair: one PyTorch call timed as a yardstick, in turns
    with the kernel (the median of ROUNDS runs each)."""
    if library is None:
        ms, library_ms = _events_ms(fn, iters, before=before), None
    else:
        ms, library_ms = _alternating_ms((fn, library[1]), iters, before=before)
    plain_ms = _events_ms(plain, max(iters // 10, 5), before=before)
    dev = _kernel_device_us(name, fn if before is None else (lambda: (before(), fn())), 50,
                            bound_ms, match)
    log(f"time [{card}]: {name}: {ms * 1000:.2f} us per call, device time {dev}, plain PyTorch "
        f"{plain_ms * 1000:.2f} us, bound {bound_ms * 1000:.2f} us"
        + ("" if library is None else
           f", {library[0]} {library_ms * 1000:.2f} us (in turns with the kernel, the median "
           f"of {ROUNDS} runs of {iters} calls each)"))
    return dict(shape=list(shape), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                library_ms=library_ms)


L2_FLUSH_BYTES = 256 * 2**20  # five times the H100's 50 MB L2


def int8_kernel_times(card: str) -> dict:
    """The three int8 kernels at the int8 forward's shapes (704 canvas,
    batch 4), and torch._int_mm per GEMM shape against its int8 bound.
    No single PyTorch call computes what im2col or the epilogue does
    (F.unfold refuses int8 on the card). quantize_i8 is timed beside
    torch.quantize_per_tensor to qint8 at the same scale, a yardstick of
    time only: it divides by the scale and clamps at -128 where the kernel
    multiplies by the f32 reciprocal and clamps at -127."""
    from deepcut_tpu_torch.ops import int8_conv as ic

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    out = {}
    x = _i8(gen, (4, 64, 176, 176))           # res2's 3x3 input
    rows, k = 4 * 176 * 176, 9 * 64
    out["int8_im2col"] = _timed(
        card, "int8_im2col at res2 3x3 (4,64,176,176) -> (123904, 576)", x.shape,
        lambda: ic.int8_im2col(x, 3, pad=1), lambda: ic.int8_im2col_plain(x, 3, pad=1),
        _bound_ms(x.numel() + rows * k))
    shape = (4, 512, 88, 88)                  # a res3 block end
    acc, scale, bias, res = _i8_epilogue_case(gen, shape, 512, "f32")
    kw = dict(relu=True, requant_s=0.0517)
    n = acc.numel()
    out["int8_epilogue"] = _timed(
        card, f"int8_epilogue at {shape}: bf16 residual, ReLU, f32 out + requantized", shape,
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
        y.shape,
        lambda: ic.quantize_i8(y, 0.0371), lambda: ic.quantize_i8_plain(y, 0.0371),
        _bound_ms(y.numel() * 5), iters=50, before=flush.zero_, match="quantize",
        library=("torch.quantize_per_tensor(x, s, 0, torch.qint8)",
                 lambda: torch.quantize_per_tensor(y, 0.0371, 0, torch.qint8)))
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


def phase_make_forward(est, rng, device: str = "cuda", size: int = 688) -> dict:
    """6a. The public functional forward, `models.resnet.make_forward`, the
    JAX package's entry, at ResNet-152's full width: a 688x688 frame on the
    704 bucket, bf16, heads ("pose", "locref"), on phase 4's tamed params
    as a user prepares them (`fold_bn`, `cast_params`, on the card,
    channels_last). Its maps must equal `PoseEstimator`'s forward of the
    same canvas bit for bit; then, concatenated as the heads' map, they go
    through the decode's fused entry, which must give `estimate_pose`'s
    pose bit for bit. The references run first; the counts are zeroed
    before make_forward and read after the decode: returns them. (device,
    size: a rehearsal on the CPU at a cut depth.)"""
    from deepcut_tpu_torch.models.resnet import cast_params, fold_bn, make_forward
    from deepcut_tpu_torch.pose.estimate import _bucket

    cfg = est.cfg
    params = {name: {k: v.to(device, memory_format=torch.channels_last) if v.dim() == 4
                     else v.to(device) for k, v in entry.items()}
              for name, entry in cast_params(fold_bn(tame_params(cfg), cfg),
                                             cfg.compute_dtype).items()}
    f688 = frame(rng, size, size)
    ch = canvas_size(size, 1.0)
    bucket = _bucket(ch, est.bucket_step)
    x = est._canvas(f688, 1.0, bucket, bucket).permute(0, 3, 1, 2)
    with torch.inference_mode():
        want = est.model(x, heads=HEADS)
    want_pose = est.estimate_pose(f688)
    _zero_counts()
    with torch.inference_mode():
        got = make_forward(cfg, folded=True, heads=HEADS)(params, x)
    fused = torch.cat([got["fc_pose"], got["loc_pred"]], 1).contiguous(
        memory_format=torch.channels_last)
    cells = -(-ch // 8)
    pose = cuda_decode.decode_fused(fused, J, [cells], [cells], 1.0)[0].cpu()
    counts = _counts()
    for k in want:
        if got[k].shape != want[k].shape or not torch.equal(got[k], want[k]):
            raise AssertionError(f"make_forward's {k} differs from PoseEstimator's forward")
    if not _same(pose, torch.from_numpy(want_pose)):
        raise AssertionError(f"make_forward's maps through the fused decode: pose {pose} "
                             f"against estimate_pose's {want_pose}")
    maps = ", ".join(f"{k} {tuple(v.shape)}" for k, v in got.items())
    log(f"6a make_forward(folded=True, heads={HEADS}) on the tamed ResNet (depths {cfg.depths}), "
        f"bf16, {size}x{size} frame on the {bucket} bucket: maps {maps} "
        f"bit-equal to PoseEstimator's forward; through the fused decode "
        f"({tuple(fused.shape)}, {cells}x{cells} valid cells) the pose bit-equal to "
        f"estimate_pose's; launches {counts}")
    return counts


@contextlib.contextmanager
def _eager(est):
    """`est`'s batched paths with the network run eagerly, as before graphs."""
    est._graphable = lambda: False
    try:
        yield
    finally:
        del est._graphable


# the seam's name of each kernel the pose network launches -> its device
# kernel's name
NET_KERNELS = {"conv_epilogue": "conv_epilogue_kernel", "conv3x3": "conv3x3_kernel"}


def _epilogue_kernels(fn, steps: int, tries: int = 3):
    """(profiler busy ms, device ops, {kernel: (device events, the seam's
    count)}) per call of `fn` over the same calls for NET_KERNELS, read
    again where the tracer lost launches (`_device_profile`)."""
    from deepcut_tpu_torch import native

    for _ in range(tries):
        before = native.counts()
        busy, ops, ranked = _device_profile(fn, steps=steps, top=10**6)
        after = native.counts()
        events = {k: (sum(n for name, _, n in ranked if device in name),
                      (after.get(k, 0) - before.get(k, 0)) / (2 * steps))   # warm-up and active
                  for k, device in NET_KERNELS.items()}
        if all(traced == counted for traced, counted in events.values()):
            break
    return busy, ops, events


def _graph_hits(est, fn, what: str):
    """fn()'s result, and the launches it counted; `est`'s graph counters
    must show no capture and only replays (a hit share of 100%)."""
    from deepcut_tpu_torch.ops import conv_epilogue

    stats, launched = dict(est.graph_stats), conv_epilogue.launches
    out = fn()
    torch.cuda.synchronize()
    moved = {k: est.graph_stats[k] - stats[k] for k in stats}
    share = moved["replays"] / max(1, moved["replays"] + moved["eager"])
    log(f"P {what}: graph counters moved {moved}, hit share {100 * share:.1f}%")
    if moved["captures"] or moved["eager"] or not moved["replays"]:
        raise AssertionError(f"P {what}: the graph path did not take every chunk: {moved}")
    return out, conv_epilogue.launches - launched


def _per_frame_batch(est, frames, scale: float = 1.0) -> np.ndarray:
    """estimate_pose_batch as the estimator computed it before it staged
    chunks: each frame alone from pageable memory (`.to`, which waits),
    preprocessed alone, every canvas made before the first chunk's network,
    then per chunk the graph (or the eager network) and the decode, then
    the wait."""
    from deepcut_tpu_torch.pose.estimate import PAD_SIZE, _bucket, preprocess_on_device

    h, w = frames[0].shape[:2]
    ch, cw = canvas_size(h, scale), canvas_size(w, scale)
    bh, bw = _bucket(ch, est.bucket_step), _bucket(cw, est.bucket_step)
    out_h, out_w = int((h + PAD_SIZE) * scale), int((w + PAD_SIZE) * scale)
    mats = None
    if (out_h, out_w) != (h + PAD_SIZE, w + PAD_SIZE):
        mats = (est._matrix(h + PAD_SIZE, out_h), est._matrix(w + PAD_SIZE, out_w))
    canvases = torch.cat([preprocess_on_device(
        torch.from_numpy(np.ascontiguousarray(im)).to(est.device), out_h, out_w, bh, bw, mats)
        for im in frames])
    c, poses = est.BATCH_CHUNK, []
    for i in range(0, len(frames), c):
        vh, vw = [ch] * len(frames[i:i + c]), [cw] * len(frames[i:i + c])
        poses.append(est._graphs.run(canvases[i:i + c],
                                     lambda fused: est._decode_chunk(fused, vh, vw, scale)))
    return torch.cat(poses).cpu().numpy()


def _staging_check(est, rng, card: str) -> None:
    """P's check of the staged chunks: estimate_pose_batch calls back to
    back on 8 distinct 688x688 frames each (200 at scale 1, 40 at 0.8),
    no two calls in a row sharing a frame, each pose bit-equal to
    `_per_frame_batch`'s on the same frames: a page-locked staging block
    rewritten before its copy ran would show here. Then each path's wall
    ms per call (host clock; each call ends in its wait), in turns."""
    pool = [frame(rng, 688, 688) for _ in range(200)]
    sets = [pool[8 * k:8 * k + 8] for k in range(25)]
    for scale, calls in ((1.0, 200), (0.8, 40)):
        for s in sets[:2]:
            est.estimate_pose_batch(s, scale)            # graphs captured for the shape
        want = [_per_frame_batch(est, s, scale) for s in sets]
        t0 = time.perf_counter()
        got = [est.estimate_pose_batch(sets[i % len(sets)], scale) for i in range(calls)]
        secs = time.perf_counter() - t0
        bad = [i for i, pose in enumerate(got) if not np.array_equal(pose, want[i % len(sets)])]
        if bad:
            i = bad[0]
            raise AssertionError(
                f"P staging at scale {scale}: {len(bad)} of {calls} calls differ from the "
                f"per-frame path, first call {i}, max |d| "
                f"{np.abs(got[i] - want[i % len(sets)]).max()}")
        log(f"P staging at scale {scale}: {calls} estimate_pose_batch calls of 8 distinct frames "
            f"back to back ({secs * 1e3 / calls:.3f} ms a call), every pose bit-equal to the "
            f"per-frame path's")
    ms = {"per-frame": [], "staged": []}
    for side in ("per-frame", "staged", "staged", "per-frame") * 2:
        fn = _per_frame_batch if side == "per-frame" else PoseEstimator.estimate_pose_batch
        t0 = time.perf_counter()
        for i in range(20):
            fn(est, sets[i % len(sets)])
        ms[side].append((time.perf_counter() - t0) * 1e3 / 20)
    p, s = (float(np.median(ms[k])) for k in ("per-frame", "staged"))
    log(f"time [{card}]: P estimate_pose_batch, 8 frames, graphed: per-frame pageable canvases "
        f"{p:.3f} ms/call ({8000 / p:.2f} img/s), staged chunks {s:.3f} ms/call "
        f"({8000 / s:.2f} img/s), {p / s:.3f}x; runs "
        + json.dumps({k: [round(v, 3) for v in vs] for k, vs in ms.items()}))


def phase_pose_graphs(card: str, rng=None) -> None:
    """P. The estimator's CUDA graphs (`pose.graphs`) against its eager
    network on the tamed ResNet-152, bf16, 688x688 frames (the 704 bucket)
    unless said otherwise: a shape's first chunk runs eagerly, its second
    captures; each graphed pose bit-equal to the eager path's and its
    conv_epilogue count equal, for estimate_pose, estimate_pose_batch at 8
    frames (two chunks of 4, one shape) and at 5 (4 + 1), estimate_pose_many
    over two buckets (688x688 and 480x640); four threads' answers equal to
    the serial ones; the profiler's busy time of the graphed network held
    against `_graph_device_ms` and the eager path's, and the batch of 8's
    busy per frame against the eager path's; estimate_pose_batch's and
    estimate_pose's wall time per call, graphed and eager in turns;
    `_staging_check`; `_pose_graph_shapes`; the tiled, int8 and unfolded
    estimators never capturing."""
    from deepcut_tpu_torch.ops import conv_epilogue

    rng = np.random.RandomState(SEED + 18) if rng is None else rng
    cfg = deepercut_config(152)
    params = tame_params(cfg)
    est = PoseEstimator(params, cfg, device="cuda")
    if not est._graphable():
        raise AssertionError("P: the folded bf16 estimator on the card does not take graphs")
    f688 = [frame(rng, 688, 688) for _ in range(8)]
    f480 = [frame(rng, 480, 640) for _ in range(3)]
    calls = (("estimate_pose, 1 frame", lambda: est.estimate_pose(f688[0])),
             ("estimate_pose_batch, 8 frames", lambda: est.estimate_pose_batch(f688)),
             ("estimate_pose_batch, 5 frames", lambda: est.estimate_pose_batch(f688[:5])),
             ("estimate_pose_many, 2 buckets",
              lambda: est.estimate_pose_many([f688[1], f480[0], f688[2], f480[1], f480[2]])))
    serial = {}
    for what, fn in calls:
        with _eager(est):
            fn()                                     # cuDNN's plans for the eager reference
            before = conv_epilogue.launches
            want = fn()
            torch.cuda.synchronize()
            want_launches = conv_epilogue.launches - before
        first = fn()                                 # eager at a shape's first sight,
        second = fn()                                # captured at its second
        got, launches = _graph_hits(est, fn, what)
        for name, pose in (("first call", first), ("second call", second), ("replayed", got)):
            if not np.array_equal(pose, want):
                raise AssertionError(f"P {what}: the graphed pose ({name}) differs from the eager "
                                     f"path's: max |d| {np.abs(pose - want).max()}")
        if launches != want_launches:
            raise AssertionError(f"P {what}: {launches} conv_epilogue launches counted per "
                                 f"graphed call, {want_launches} eager")
        serial[what] = want
        log(f"P {what}: bit-equal to the eager path, first, second call and replayed; conv_epilogue "
            f"launches per call {launches} (eager {want_launches})")
    log(f"P graphs held: {sorted(est._graphs.entries)}; counters {est.graph_stats}")

    # four threads, each its own call, several times over, all on replays
    fns = [fn for _, fn in calls]
    stats = dict(est.graph_stats)
    out = _on_threads(lambda k: [fns[k]() for _ in range(5)], list(range(4)), together=True)
    for (what, _), (results, ms) in zip(calls, out):
        if not all(np.array_equal(r, serial[what]) for r in results):
            raise AssertionError(f"P {what}: a thread's answer differs from the serial one")
    moved = {k: est.graph_stats[k] - stats[k] for k in stats}
    if moved["captures"] or moved["eager"]:
        raise AssertionError(f"P threads: the graph path did not take every chunk: {moved}")
    log(f"P four threads, 5 calls each: every answer equal to the serial one; counters moved "
        f"{moved}")

    # the profiler records the replayed kernels
    c = est.BATCH_CHUNK
    canvases = torch.cat([est._canvas(im, 1.0, 704, 704) for im in f688[:c]])

    def net_graphed():
        est._graphs.run(canvases, lambda m: None)

    def net_eager():
        est._net_eager(canvases)

    with torch.inference_mode():
        dev = _graph_device_ms(lambda: est._forward_fused(canvases))
    busy_g, ops_g, _ = _device_profile(net_graphed, steps=10)
    busy_e, ops_e, _ = _device_profile(net_eager, steps=10)
    log(f"P network at batch {c} on the 704 canvas: profiler busy per call, graphed "
        f"{busy_g:.4f} ms over {ops_g:.0f} device ops, eager {busy_e:.4f} ms over {ops_e:.0f}; "
        f"its own graph's device time (CUDA events) {dev:.4f} ms")
    for name, ref in (("_graph_device_ms", dev), ("the eager path's busy", busy_e)):
        if abs(busy_g - ref) > 0.03 * ref:
            raise AssertionError(f"P: the graphed network's profiler busy {busy_g:.4f} ms is "
                                 f"more than 3% off {name} {ref:.4f} ms")
    batch8 = calls[1][1]
    busy8_g, ops8_g, events_g = _epilogue_kernels(batch8, steps=5)
    with _eager(est):
        busy8_e, ops8_e, events_e = _epilogue_kernels(batch8, steps=5)
    log(f"P estimate_pose_batch, 8 frames: profiler busy per frame graphed {busy8_g / 8:.4f} ms "
        f"({ops8_g:.0f} device ops a call), eager {busy8_e / 8:.4f} ms ({ops8_e:.0f}); "
        + "; ".join(f"{NET_KERNELS[k]} device events per call graphed {events_g[k][0]:g} (counter "
                    f"{events_g[k][1]:g}), eager {events_e[k][0]:g} (counter {events_e[k][1]:g})"
                    for k in NET_KERNELS))
    if abs(busy8_g - busy8_e) > 0.03 * busy8_e:
        raise AssertionError("P: estimate_pose_batch's busy per frame graphed is more than 3% "
                             "off the eager path's")
    for k in NET_KERNELS:
        if not events_g[k][0] == events_g[k][1] == events_e[k][0] == events_e[k][1]:
            raise AssertionError(f"P: the profiler's {NET_KERNELS[k]} events and the counter "
                                 f"disagree")
    # two chunks of 4 at 704: each chunk's 50 3x3 convs
    if events_g["conv3x3"][1] != 100:
        raise AssertionError(f"P: {events_g['conv3x3'][1]:g} conv3x3 launches a call of 8 "
                             f"frames, not 50 a chunk")

    # wall time per call, in turns: eager, graphed, graphed, eager
    for what, fn, frames in (("estimate_pose_batch, 8 frames", batch8, 8),
                             ("estimate_pose, 1 frame", calls[0][1], 1)):
        ms = {"eager": [], "graphed": []}
        for side in ("eager", "graphed", "graphed", "eager") * 2:
            with (_eager(est) if side == "eager" else contextlib.nullcontext()):
                ms[side].append(_events_ms(fn, iters=20))
        e, g = (float(np.median(ms[k])) for k in ("eager", "graphed"))
        log(f"time [{card}]: P {what}: eager {e:.3f} ms/call ({frames * 1000 / e:.2f} img/s), "
            f"graphed {g:.3f} ms/call ({frames * 1000 / g:.2f} img/s), {e / g:.3f}x; runs "
            + json.dumps({k: [round(v, 3) for v in vs] for k, vs in ms.items()}))
    _staging_check(est, rng, card)
    log(f"P memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB peak allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved, {len(est._graphs.entries)} "
        f"graphs held")

    _pose_graph_shapes(params, cfg, rng, card)

    # the paths that keep the eager network
    hd = frame(rng, 720, 1280)
    stats = dict(est.graph_stats)
    est.estimate_pose(hd)
    if est.graph_stats != stats:
        raise AssertionError(f"P: the tiled path moved the graph counters: {est.graph_stats}")
    for what, other in (("folded=False", PoseEstimator(params, cfg, folded=False, device="cuda")),
                        ("int8", PoseEstimator(params, cfg, device="cuda"))):
        if what == "int8":
            other.quantize_int8(f480[0])
        other.estimate_pose_batch(f688[:5])
        if other._graphable() or other.graph_stats != {"captures": 0, "replays": 0, "eager": 2}:
            raise AssertionError(f"P {what}: graph counters {other.graph_stats}")
        log(f"P {what}: eager, graph counters {other.graph_stats}")
        del other
    log("P: the tiled path, the unfolded and the int8 estimators kept the eager network")


# 12 frame sizes of 12 canvas buckets below max_size, from (256, 320) to (704, 704)
SHAPE_ROTATION = ((200, 300), (250, 250), (330, 420), (400, 300), (460, 520), (520, 380),
                  (580, 640), (640, 480), (300, 600), (688, 688), (480, 640), (360, 360))


def _mixed_batches(rng, sizes=((688, 688), (480, 640), (360, 360)), lengths=(2, 5, 7, 3, 9, 6)):
    """estimate_pose_many batches of frames of mixed sizes: a bucket's
    chunks of 4 and remainders of 1 to 3 give more chunk shapes than an
    estimator keeps graphs."""
    pool = [[frame(rng, h, w) for _ in range(3)] for h, w in sizes]
    out = []
    for n in lengths:
        picks = rng.randint(0, len(sizes), n)
        out.append([pool[k][rng.randint(0, 3)] for k in picks])
    return out


def _rounds(est, calls, rounds: int, what: str, card: str) -> None:
    """`calls` (a list of (name, fn)) in rounds on a fresh estimator: an
    eager round then a graphed round, `rounds` times, each pose bit-equal to
    the first eager round's; per round the wall ms of each side and the
    captures, and each capturing call's ms over its eager one (the cost of
    a miss). No capture after the second graphed round: the cache keeps its
    graphs however many shapes rotate."""
    want, eager_ms = [], {}
    with _eager(est):
        for _, fn in calls:                          # cuDNN's plans for every shape
            want.append(fn())
    per_round, misses = [], []
    for r in range(rounds):
        row = {}
        for side in ("eager", "graphed"):
            ms, caps = [], 0
            for k, (name, fn) in enumerate(calls):
                c0 = est.graph_stats["captures"]
                with (_eager(est) if side == "eager" else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    got = fn()
                    ms.append((time.perf_counter() - t0) * 1e3)
                if not np.array_equal(got, want[k]):
                    raise AssertionError(f"P {what}, round {r}, {name}: the {side} pose differs")
                if side == "eager":
                    eager_ms[k] = ms[-1]
                elif est.graph_stats["captures"] > c0:
                    caps += est.graph_stats["captures"] - c0
                    misses.append((ms[-1], ms[-1] - eager_ms[k], est.graph_stats["captures"] - c0))
            row[side] = sum(ms)
            if side == "graphed":
                row["captures"] = caps
        per_round.append(row)
    log(f"time [{card}]: P {what}, {len(calls)} calls a round, ms per round eager / graphed / "
        f"captures: " + "; ".join(f"{r['eager']:.1f} / {r['graphed']:.1f} / {r['captures']}"
                                   for r in per_round))
    if misses:
        log(f"time [{card}]: P {what}: {len(misses)} capturing calls took "
            + ", ".join(f"{ms:.1f} ms (+{d:.1f} over eager, {n} captured)" for ms, d, n in misses))
    log(f"P {what}: graphs held {sorted(est._graphs.entries)}; counters {est.graph_stats}")
    late = sum(r["captures"] for r in per_round[2:])
    if late:
        raise AssertionError(f"P {what}: {late} captures after the second round (thrashing)")


def _pose_graph_shapes(params, cfg, rng, card: str) -> None:
    """P's traffic of many shapes, each on a fresh estimator: estimate_pose
    over `SHAPE_ROTATION` (12 shapes for `GRAPH_SHAPES` graphs) and
    estimate_pose_many over `_mixed_batches`, in 5 rounds (`_rounds`)."""
    est = PoseEstimator(params, cfg, device="cuda")
    frames = [frame(rng, h, w) for h, w in SHAPE_ROTATION]
    _rounds(est, [(f"{im.shape[0]}x{im.shape[1]}", lambda im=im: est.estimate_pose(im))
                  for im in frames], 5, "estimate_pose over 12 frame sizes", card)
    del est
    est = PoseEstimator(params, cfg, device="cuda")
    batches = _mixed_batches(rng)
    _rounds(est, [(f"{len(b)} frames", lambda b=b: est.estimate_pose_many(b)) for b in batches],
            5, "estimate_pose_many over mixed batches", card)
    del est


def phase_times(est, est8, rng, card: str) -> dict:
    serving_times(est, rng, card)
    path_times(est, card)
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
    frames (20 crops, f32), Detector.detect_windows over 10 windows (f32)
    and its bf16 make_forward at batch 10; the
    ResNet-152 graph's make_forward at batch 1 and 4 on a 688 canvas beside
    the native DeeperCut bf16 forward of the same weights."""
    from deepcut_tpu_torch.models.resnet import fold_bn

    cls, frames = state["classifier"], state["frames"]
    _profiled(card, "CaffeNet Classifier.predict, 2 frames (20 crops of 227x227), f32 (TF32 off)",
              lambda: cls.predict(frames), 2, iters=5, steps=3)
    det, windows = state["detector"], state["windows"]
    _profiled(card, "CaffeNet Detector.detect_windows, 10 windows of 2 frames (context pad "
              f"{DETECTOR_CONTEXT_PAD}, crops from PNG files), f32 (TF32 off)",
              lambda: det.detect_windows(windows), 10, iters=5, steps=3)
    shutil.rmtree(Path(windows[0][0]).parent)
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
    "conv3x3": ("deepcut_tpu_torch/csrc/conv3x3.cu",
                "deepcut_tpu/ops/conv.py:83 (no TPU kernel: XLA's bf16 conv; cuDNN's here)"),
}


# the seam's kernel names (`native.counts`) under the names this check logs
COUNTED = {"conv_epilogue": "conv_epilogue", "decode_pose": "decode_fused",
           "decode_pose_prob": "decode_pose", "int8_im2col": "int8_im2col",
           "int8_epilogue": "int8_epilogue", "quantize_i8": "quantize_i8", "conv3x3": "conv3x3"}


def _counts() -> dict:
    from deepcut_tpu_torch import native

    counts = native.counts()
    return {name: counts.get(kernel, 0) for name, kernel in COUNTED.items()}


def _record_geometries(on: bool) -> dict:
    """Start recording the kernels' launch geometries, or stop; returns
    what was recorded until then, per kernel name."""
    from deepcut_tpu_torch import native

    return native.record_geometries(on) or {}


def _zero_counts() -> None:
    from deepcut_tpu_torch import native

    native.reset_counts()


# the phases and steps whose seconds main() logs (`time_phases`), in run order
PHASES = ("phase_build", "phase_kernels_vs_plain", "phase_slice", "phase_server", "phase_int8",
          "phase_train_cli", "phase_train_grads", "phase_train_learns", "phase_graph",
          "phase_data", "phase_examples", "phase_matcaffe", "phase_dp_world1",
          "phase_dp_two_ranks", "phase_spatial", "replay_path_geometries",
          "phase_engine_caffenet", "phase_engine_pose", "phase_make_forward",
          "phase_pose_graphs", "serving_times",
          "path_times", "kernel_times", "int8_kernel_times", "graph_times", "data_times",
          "phase_train_times",
          # their steps, M3's and S's in each rank too
          "run_cli", "tame_params", "pose_batches", "phase_graph_caffenet",
          "phase_graph_detector", "phase_graph_serving", "phase_graph_f32", "phase_graph_int8",
          "phase_examples_pose", "phase_examples_web", "phase_examples_scripts",
          "phase_examples_lenet", "_m3_caffenet", "_m3_pose", "_s1_pose", "_s2_graph",
          "_s3_serving", "_s1_replay")


def time_phases(namespace: dict) -> dict:
    """Wrap each function of PHASES in `namespace` (this script's globals(),
    or `vars()` of another checkout's copy of it), so that each call logs
    its seconds on the host clock; returns {name: seconds summed over
    calls}, filled as they run. (A spawned rank passes its own globals():
    there the script runs as __mp_main__ in a namespace of its own.)"""
    seconds = {}
    for name in PHASES:
        fn = namespace.get(name)
        if fn is None:
            continue

        def timed(*args, _fn=fn, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                secs = time.perf_counter() - t0
                seconds[_name] = seconds.get(_name, 0.0) + secs
                log(f"phase time: {_name} {secs:.1f} s")

        namespace[name] = timed
    return seconds


def main() -> int:
    t_start = time.perf_counter()
    seconds = time_phases(globals())
    card = phase_device()
    if sys.argv[1:] == ["--serving-times"]:
        serving_times(PoseEstimator(tame_params(deepercut_config(152)), device="cuda"),
                      np.random.RandomState(SEED), card)
        return 0
    if sys.argv[1:] == ["--pose-graphs"]:
        phase_build()
        phase_pose_graphs(card)
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
    data_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_data_")
    _zero_counts()                               # the data slice's path starts here
    data_state = phase_data(Path(data_dir.name), rng)
    data = _counts()                             # and ends here
    _zero_counts()                               # the examples' front ends start here
    examples = phase_examples(card, rng)         # (their served requests' launches)
    log(f"X's launches with its in-process references: {_counts()}")
    _zero_counts()                               # MatCaffe and data parallel start here
    phase_matcaffe_dp(card)
    matcaffe_dp = _counts()                      # and end here
    _zero_counts()                               # the spatial axis: its two ranks zero
    with tempfile.TemporaryDirectory(prefix="chip_smoke_s_") as tmp:   # their own counts
        spatial = phase_spatial(Path(tmp), card)["counts"]             # and read them here
    spatial_ref = _counts()                      # S's one-process references: not counted
    replay_path_geometries(_record_geometries(False))
    _zero_counts()                               # the engine's training path starts here
    phase_engine(card)
    engine = _counts()                           # and ends here
    log(f"kernel launches: serving path {serving}, int8 serving path {int8}, "
        f"training path {training}, graph engine path {graph}, data slice path {data}, "
        f"examples path {examples}, "
        f"MatCaffe + data-parallel path {matcaffe_dp}, spatial path (its two ranks) {spatial} "
        f"(and S's one-process references {spatial_ref}, not counted), engine training path "
        f"{engine}")
    if any(engine.values()):   # f32 training: no bf16 rounding, no int8
        raise AssertionError(f"the engine's f32 training launched {engine}")
    # conv3x3 serves the float network's trunk alone: the int8 network, the
    # row-sharded trunk (its halo leaves no padding on H) and training skip it
    no_3x3 = [k for k in KERNELS if k != "conv3x3"]
    for path, counts, need in (("serving", serving, ("conv_epilogue", "decode_pose",
                                                     "decode_pose_prob", "conv3x3")),
                               ("int8 serving", int8, no_3x3),
                               ("training", training, ("conv_epilogue", "decode_pose")),
                               ("graph engine", graph, ("conv_epilogue", "quantize_i8",
                                                        "int8_im2col", "int8_epilogue")),
                               ("data slice", data, ("conv_epilogue",)),
                               ("examples", examples, no_3x3),
                               ("MatCaffe + data-parallel", matcaffe_dp, ("decode_pose",)),
                               ("spatial", spatial, no_3x3)):
        idle = [k for k in need if counts[k] == 0]
        if idle:
            raise AssertionError(f"the {path} path never launched {idle}")
    make_fwd = phase_make_forward(est, rng)      # counts zeroed and read inside
    idle = [k for k in ("conv_epilogue", "decode_pose", "conv3x3") if make_fwd[k] == 0]
    if idle:
        raise AssertionError(f"the make_forward path never launched {idle}")
    phase_pose_graphs(card, rng)
    times = phase_times(est, est8, rng, card)
    del est, est8
    graph_times(graph_state, rng, card)
    del graph_state
    data_times(data_state, card)
    data_dir.cleanup()
    phase_train_times(card)
    log(f"phase seconds (host clock, {card}): "
        + json.dumps({k: round(v, 1) for k, v in seconds.items()})
        + f"; the script so far {time.perf_counter() - t_start:.1f} s")
    log(f"profiler checks: {len(PROFILER_FLAGS)} readings flagged"
        + "".join(f"\n  flagged: {f}" for f in PROFILER_FLAGS))
    paths = {"serving": serving, "int8 serving": int8, "training": training, "graph engine": graph,
             "data slice": data, "examples": examples,
             "MatCaffe + data-parallel": matcaffe_dp, "spatial": spatial,
             "engine training": engine, "make_forward": make_fwd}
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(counts[name] for counts in paths.values()),
         "launches_per_path": {path: counts[name] for path, counts in paths.items()},
         "shape": times[name]["shape"],
         "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": "FLOPs" if name == "conv3x3" else "bytes",
         "library_ms": times[name]["library_ms"]}
        for name, (src, rep) in KERNELS.items()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
