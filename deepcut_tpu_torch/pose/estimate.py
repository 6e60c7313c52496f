"""Full-image pose estimation pipeline, in PyTorch.

Counterpart of `deepcut_tpu.pose.estimate`. Per scale, as in the reference
(estimate_pose.py:81-128): pad 64 px bottom/right by edge replication,
bilinear-resize by the scale with PIL's rounding, subtract the BGR mean,
paste into a stride-aligned zero canvas, run the CNN (tiled above 700 px
with 224 px of receptive-field overlap), then the argmax + offset decode;
the best scale by its lowest joint confidence wins.

On the device: the preprocess (f32 interpolation-matrix products), the
network, and the decode, which is the hand-written CUDA kernel
(`ops.cuda_decode`) on a CUDA device, reading the heads' unsliced map on
the batched paths, so only the 5 x J pose crosses back to the host. On a
CUDA device the frames go up from page-locked memory without the host
waiting, and the frames of one size in a chunk are preprocessed as one
batch. The batched paths work chunk by chunk: a chunk's network and decode
are enqueued as soon as its canvases are, so the card runs one chunk while
the host stages the next, and the host waits once, for the whole call's
poses. Canvas sizes are rounded up to a bucket grid with the argmax
masked to each image's true grid, as in the JAX package; in place of its
per-bucket jit programs this estimator keeps a per-size cache of
device-resident bilinear matrices. The tiling plan is the JAX package's
stride-aligned one (see `_tile_plan`). `PoseEstimator.quantize_int8`
switches every path to the int8 model (`models.quantize`).

On the card the batched paths (`estimate_pose` below `max_size`,
`estimate_pose_batch`, `estimate_pose_many`'s buckets) replay the network
as one CUDA graph per chunk shape (`pose.graphs`): captured once a shape
recurs (its first chunk runs eagerly), kept for `GRAPH_SHAPES` shapes, its
map bit-equal to the eager forward's. Only the folded float model on a
CUDA device with no mesh is captured; the CPU, ``folded=False``, the int8
model, a mesh, and every path through `_maps` (tiles, scoremaps, pyramid
averages) run eagerly. ``graph_stats`` counts captures, replays and eager
network calls.

While a torch profiler records, each public method records a ``pose.call``
span, and inside it ``pose.canvas`` (a chunk's upload and preprocess),
``pose.net`` (a network call: an eager forward, or a graph's copy-in and
replay), ``pose.capture`` (a graph's capture, once per shape),
``pose.decode`` (a decode launch) and ``pose.wait`` (the copy back that
waits on the device) spans (`deepcut_tpu_torch.spans`).

With a ``mesh`` (`parallel.mesh.make_mesh`, a 'spatial' axis of S ranks)
frames up to S * max_size rows are computed full-frame with their rows
split over the axis (`parallel.spatial.RowShards`: halo exchange, the
heads on the gathered grid), in place of the host tiling loop. Serving is
SPMD: every rank of the axis calls the same method with the same frame and
gets the whole maps (and the same pose).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepcut_tpu_torch.constants import MEAN_BGR
from deepcut_tpu_torch.models.resnet import (
    DeeperCut, DeeperCutConfig, Params, cast_params, deepercut_config, fold_bn)
from deepcut_tpu_torch.ops import cuda_decode
from deepcut_tpu_torch.pose.decode import STRIDE
from deepcut_tpu_torch.pose.graphs import NetGraphs
from deepcut_tpu_torch.spans import (
    POSE_CALL, POSE_CANVAS, POSE_DECODE, POSE_NET, POSE_WAIT, span)

PAD_SIZE = 64                     # estimate_pose.py:89
MAX_SIZE = 700                    # _MAX_SIZE, estimate_pose.py:29
RF = 224                          # receptive field, estimate_pose.py:162
HEADS = ("pose", "locref")        # what the single-person decode reads


def canvas_size(dim: int, scale: float) -> int:
    """ceil(dim*scale/8)*8 (estimate_pose.py:85-88)."""
    return int(math.ceil(dim * scale / STRIDE) * STRIDE)


def _bucket(v: int, step: int = 64) -> int:
    return int(math.ceil(v / step) * step)


def _resized_size(dim: int, scale: float) -> int:
    # scipy.misc.imresize with a float scale TRUNCATES the target size
    # ((np.array(im.size) * scale).astype(int)); round() would disagree with
    # the reference's resample grid whenever frac >= 0.5
    return int((dim + PAD_SIZE) * scale)


def _bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """PIL-style bilinear resampling matrix (out, in): triangle filter with
    support widened by in/out on downscale (antialiasing), weights
    normalised — matches scipy.misc.imresize's PIL backend closely."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    A = np.zeros((out_size, in_size), np.float32)
    support = fscale  # triangle filter radius 1 scaled
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        lo = int(math.floor(center - support))
        hi = int(math.ceil(center + support))
        xs = np.arange(max(lo, 0), min(hi + 1, in_size))
        w = 1.0 - np.abs((xs - center) / fscale)
        w = np.clip(w, 0.0, None)
        s = w.sum()
        if s > 0:
            A[i, xs] = w / s
        else:
            A[i, np.clip(int(round(center)), 0, in_size - 1)] = 1.0
    return A


def _round_half_up(x: torch.Tensor) -> torch.Tensor:
    # PIL's fixed-point accumulate rounds HALF-UP; torch.round is
    # half-to-even, and exact .5 ties occur whenever in/out has a small
    # denominator
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def preprocess_on_device(image_u8: torch.Tensor, out_h: int, out_w: int,
                         canvas_h: int, canvas_w: int,
                         matrices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 BGR frames of one size on the device, (H, W, 3) or
    (n, H, W, 3) -> f32 canvases (n, canvas_h, canvas_w, 3), n = 1 for a
    single frame.

    Edge-replicate 64 px pad (bottom/right), bilinear resize to
    (out_h, out_w) by two interpolation-matrix products in f32, each pass
    rounded half-up to integers as PIL does on uint8, mean subtraction,
    top-left paste into a zero canvas (crop on overflow). At scale 1 the
    resize is skipped exactly. The frames are padded, mean-subtracted and
    pasted as one batch; each frame's resize runs as a single frame's
    (batched matrix products may round differently), so every canvas is
    bit-equal to its frame's alone. `matrices` optionally passes the
    (Ah, Aw) resampling matrices and `mean` the BGR mean already on the
    device; they are made here otherwise (a copy that waits for the device).
    """
    dev = image_u8.device
    frames = image_u8 if image_u8.dim() == 4 else image_u8[None]
    h, w = int(frames.shape[1]), int(frames.shape[2])
    ph, pw = h + PAD_SIZE, w + PAD_SIZE
    rows = torch.clamp(torch.arange(ph, device=dev), max=h - 1)
    cols = torch.clamp(torch.arange(pw, device=dev), max=w - 1)
    if (out_h, out_w) == (ph, pw):
        img = frames[:, rows][:, :, cols].to(torch.float32)
    else:
        if matrices is None:
            matrices = (torch.from_numpy(_bilinear_matrix(ph, out_h)).to(dev),
                        torch.from_numpy(_bilinear_matrix(pw, out_w)).to(dev))
        Ah, Aw = matrices

        def resize(frame: torch.Tensor) -> torch.Tensor:
            img = frame[rows][:, cols].to(torch.float32)
            img = _round_half_up(torch.einsum("ow,hwc->hoc", Aw, img))
            return _round_half_up(torch.einsum("oh,hwc->owc", Ah, img))
        img = torch.stack([resize(f) for f in frames])
    if mean is None:
        mean = torch.tensor(MEAN_BGR, dtype=torch.float32, device=dev)
    img = img - mean
    ch, cw = min(canvas_h, out_h), min(canvas_w, out_w)
    canvas = torch.zeros((len(frames), canvas_h, canvas_w, 3), dtype=torch.float32, device=dev)
    canvas[:, :ch, :cw] = img[:, :ch, :cw]
    return canvas


class PoseEstimator:
    """DeeperCut pose estimator on one device (``"cuda"`` by default).

    params: the port's Caffe-named torch param dict (`models.resnet.init_params`
    or `models.convert.params_from_numpy`). With folded=True (serving) BN is
    folded and conv weights cast to ``cfg.compute_dtype``; folded=False
    keeps the raw f32 forward."""

    # Frames per CNN chunk in the batched paths. The value was tuned for the
    # TPU; results do not depend on it, and it has not been retuned for the
    # card yet.
    BATCH_CHUNK = 4
    # Chunk shapes (rows, canvas bucket) whose CUDA graphs an estimator
    # keeps (`pose.graphs`); beyond it the least recently used gives way
    # only to a shape used more often.
    GRAPH_SHAPES = 8

    def __init__(self, params: Params, cfg: Optional[DeeperCutConfig] = None, *,
                 folded: bool = True, bucket_step: int = 64,
                 max_size: int = MAX_SIZE, device=None, mesh=None):
        """mesh: a `parallel.mesh.Mesh` whose 'spatial' axis row-shards
        frames of up to S * max_size rows (module docstring); every rank
        passes the same params. device: the mesh's by default, else the
        card."""
        self.cfg = cfg or deepercut_config(152)
        self.mesh = mesh
        self.device = torch.device(device if device is not None else
                                   mesh.device if mesh is not None else "cuda")
        if folded:
            if any(k.startswith("bn") for k in params):
                params = fold_bn(params, self.cfg)
            params = cast_params(params, self.cfg.compute_dtype)
        self.folded = folded
        self.model = DeeperCut(params, self.cfg, folded=folded).to(
            self.device, memory_format=torch.channels_last)
        self.bucket_step = bucket_step
        self.max_size = max_size
        self._matrices: Dict[Tuple[int, int], torch.Tensor] = {}
        self._mean = torch.tensor(MEAN_BGR, dtype=torch.float32, device=self.device)
        self._int8 = False
        self._graphs = NetGraphs(self._forward_fused, self._net_eager, self.GRAPH_SHAPES)
        # captures, replays and eager network calls of the batched paths
        self.graph_stats = self._graphs.stats

    # -- int8 serving --------------------------------------------------------
    @property
    def is_int8(self) -> bool:
        """True once `quantize_int8` has switched serving to the int8 model."""
        return self._int8

    def quantize_int8(self, calibration_image: np.ndarray, scale: float = 1.0, *,
                      int8_deconv: bool = False, percentile: float = 100.0) -> None:
        """Switch serving to the int8 model (`models.quantize`): per-channel
        symmetric int8 weights, activation scales calibrated on the given
        image's preprocessed canvas (one f32 forward, TF32 off), and every
        path (single, batched, tiled, averaged, scoremaps) on
        `models.quantize.DeeperCutInt8`. int8_deconv=True quantizes the
        transposed-conv heads too; percentile < 100 (e.g. 99.9) clips
        calibration outliers. As in the JAX package, the calibration canvas
        is the f32 one at the image's bucket size and the weights are the
        estimator's own (bf16-cast when folded), widened to f32.

        Call once with a representative image; a second call does nothing
        (the float model is gone after the first). With a mesh the
        calibration runs unsharded, as in the JAX package (the image must
        fit one device), and every rank takes rank 0's activation scales."""
        from deepcut_tpu_torch.models.quantize import prepare_int8

        if self._int8:
            return
        h, w = calibration_image.shape[:2]
        bh = _bucket(canvas_size(h, scale), self.bucket_step)
        bw = _bucket(canvas_size(w, scale), self.bucket_step)
        canvas = self._canvas(calibration_image, scale, bh, bw)
        params = {name: {k: v.detach().float() for k, v in entry.items()}
                  for name, entry in self.model.param_dict().items()}
        with torch.inference_mode():
            qparams, act_scales = prepare_int8(params, self.cfg, canvas.permute(0, 3, 1, 2),
                                               quantize_deconv=int8_deconv,
                                               percentile=percentile)
        if self.mesh is not None:
            import torch.distributed as dist

            keys = sorted(act_scales)
            flat = torch.stack([act_scales[k].float() for k in keys]).to(self.device)
            dist.broadcast(flat, src=0, group=self.mesh.group)
            act_scales = dict(zip(keys, flat.cpu().unbind(0)))
        self.serve_int8(qparams, act_scales, int8_deconv=int8_deconv)

    def serve_int8(self, qparams, act_scales, *, int8_deconv: bool = False) -> None:
        """Serve a given quantization (`models.quantize.prepare_int8`'s, or
        the JAX package's through `models.convert.qparams_from_numpy`)."""
        from deepcut_tpu_torch.models.quantize import DeeperCutInt8

        self.model = DeeperCutInt8(qparams, act_scales, self.cfg,
                                   int8_deconv=int8_deconv).to(self.device)
        self._int8 = True
        self._graphs.clear()

    # -- device pieces -----------------------------------------------------
    def _matrix(self, in_size: int, out_size: int) -> torch.Tensor:
        key = (in_size, out_size)
        if key not in self._matrices:
            self._matrices[key] = torch.from_numpy(
                _bilinear_matrix(in_size, out_size)).to(self.device)
        return self._matrices[key]

    def _upload(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """Host frames of one size -> (n, H, W, 3) on the device. On a CUDA
        device they are copied into page-locked memory and sent without the
        host waiting: torch's caching host allocator keeps the block from
        reuse until its copy has run."""
        dtype = torch.from_numpy(np.empty(0, images[0].dtype)).dtype
        host = torch.empty((len(images),) + images[0].shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")
        view = host.numpy()
        for k, im in enumerate(images):
            view[k] = im
        return host.to(self.device, non_blocking=True)

    def _canvases(self, images: Sequence[np.ndarray], scale: float, canvas_h: int,
                  canvas_w: int) -> torch.Tensor:
        """Host frames -> (n, canvas_h, canvas_w, 3) f32 canvases on the
        device, in order; the frames of each size uploaded and preprocessed
        as one batch (`preprocess_on_device`)."""
        with span(POSE_CANVAS):
            sizes: Dict[Tuple[int, int], List[int]] = {}
            for k, im in enumerate(images):
                sizes.setdefault(tuple(im.shape[:2]), []).append(k)
            slots: list = [None] * len(images)   # (its size's canvases, its row there)
            for (h, w), idx in sizes.items():
                out_h, out_w = _resized_size(h, scale), _resized_size(w, scale)
                mats = None
                if (out_h, out_w) != (h + PAD_SIZE, w + PAD_SIZE):
                    mats = (self._matrix(h + PAD_SIZE, out_h), self._matrix(w + PAD_SIZE, out_w))
                canvases = preprocess_on_device(self._upload([images[k] for k in idx]), out_h,
                                                out_w, canvas_h, canvas_w, mats, self._mean)
                if len(sizes) == 1:
                    return canvases
                for j, k in enumerate(idx):
                    slots[k] = (canvases, j)
            return torch.cat([c[j:j + 1] for c, j in slots])

    def _canvas(self, image: np.ndarray, scale: float, canvas_h: int,
                canvas_w: int) -> torch.Tensor:
        """Host frame -> (1, canvas_h, canvas_w, 3) f32 canvas on the device."""
        return self._canvases([image], scale, canvas_h, canvas_w)

    def _maps(self, canvases: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, H, W, 3) f32 canvases -> prob (N, J, h, w), loc (N, 2J, h, w),
        both f32 contiguous. The NHWC -> NCHW permute gives the channels_last
        memory the convs take. With a mesh this rank computes its block of
        the canvas rows and every rank gets the whole maps."""
        rows = None
        if self.mesh is not None and self.mesh.spatial > 1:
            from deepcut_tpu_torch.parallel.spatial import (
                RowPlan, RowShards, split_rows, trunk_heights)

            h, s = int(canvases.shape[1]), self.mesh.spatial
            rows = RowShards(self.mesh.spatial_axis,
                             RowPlan.for_heights(s, trunk_heights(h, self.cfg)))
            lo, hi = split_rows(h, s)[self.mesh.spatial_index]
            canvases = canvases[:, lo:hi]
        with torch.inference_mode(), span(POSE_NET):
            outs = self.model(canvases.permute(0, 3, 1, 2), heads=HEADS, rows=rows)
        return outs["prob"], outs["loc_pred"]

    def _decode_whole(self, prob: torch.Tensor, loc: torch.Tensor, scale: float) -> np.ndarray:
        """Unmasked decode of one image's (J, h, w) / (2J, h, w) maps -> (5, J):
        the decode's probability-map entry reads the views where they lie
        (a row-cropped map, the pyramid's average), their sizes passed by
        value, so on the card this is one kernel launch."""
        h, w = prob.shape[1:]
        with span(POSE_DECODE):
            pose = cuda_decode.decode_pose(prob[None], loc[None], [h], [w], scale)
        with span(POSE_WAIT):
            return pose[0].cpu().numpy()

    def _graphable(self) -> bool:
        """Whether `_batched` replays CUDA graphs (module docstring): the
        folded float model on a CUDA device, with no mesh."""
        return (self.device.type == "cuda" and self.folded and not self._int8
                and self.mesh is None)

    def _forward_fused(self, canvases: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) f32 canvases -> the heads' unsliced map. The NHWC ->
        NCHW permute gives the channels_last memory the convs take."""
        return self.model.fused_heads(canvases.permute(0, 3, 1, 2), heads=HEADS)

    def _net_eager(self, chunk: torch.Tensor) -> torch.Tensor:
        """`_forward_fused` run eagerly, op by op: where `_graphable` is
        false, and the card check's reference for the graphs."""
        with torch.inference_mode(), span(POSE_NET):
            return self._forward_fused(chunk)

    def _decode_chunk(self, fused: torch.Tensor, valid_h: Sequence[int],
                      valid_w: Sequence[int], scale: float) -> torch.Tensor:
        """The decode of a chunk's unsliced map, each image masked to its
        ceil(valid/8) cell grid, the valid sizes passed by value."""
        stride = int(STRIDE)
        # a no-op for the serving heads (f32, channels_last); the
        # training forwards' eval may hand bf16 or another layout
        fused = fused.to(torch.float32, memory_format=torch.channels_last)
        with span(POSE_DECODE):
            return cuda_decode.decode_fused(
                fused, self.cfg.num_joints, [-(-int(v) // stride) for v in valid_h],
                [-(-int(v) // stride) for v in valid_w], scale)

    def _batched(self, images: Sequence[np.ndarray], scale: float, canvas_h: int,
                 canvas_w: int, valid_h: Sequence[int], valid_w: Sequence[int]
                 ) -> torch.Tensor:
        """Canvases, CNN and decode over host frames in BATCH_CHUNK chunks
        -> (N, 5, J) poses on the device, not waited for (`_wait`). Each
        chunk's network and decode are enqueued right after its canvases
        (`_canvases`), before the next chunk's are made: the device runs
        chunk k while the host stages chunk k+1. The decode reads the heads'
        unsliced map: the CUDA kernel's fused entry on the card, its plain
        version on the CPU. Where `_graphable`, each chunk's network is its
        shape's CUDA graph once the shape recurs (`pose.graphs`), else the
        eager forward, op by op."""
        c = self.BATCH_CHUNK
        graphed = self._graphable()
        if not graphed:
            self._graphs.count_eager(-(-len(images) // c))
        poses = []
        for i in range(0, len(images), c):
            chunk = self._canvases(images[i:i + c], scale, canvas_h, canvas_w)
            vh, vw = valid_h[i:i + c], valid_w[i:i + c]
            if graphed:
                poses.append(self._graphs.run(
                    chunk, lambda fused: self._decode_chunk(fused, vh, vw, scale)))
            else:
                poses.append(self._decode_chunk(self._net_eager(chunk), vh, vw, scale))
        return torch.cat(poses)

    def _wait(self, poses: torch.Tensor) -> np.ndarray:
        """Device poses -> host numpy, waiting for the device."""
        with span(POSE_WAIT):
            return poses.cpu().numpy()

    # -- public API --------------------------------------------------------
    def estimate_pose(self, image: np.ndarray, scales: Optional[Sequence[float]] = None
                      ) -> Optional[np.ndarray]:
        """image: HxWx3 BGR uint8. Returns the reference's 5xJ pose
        [x, y, conf, off_y, off_x], best scale by min-confidence, or None
        when every scale's lowest joint confidence is exactly 0 (the
        reference starts its best confidence at 0)."""
        with span(POSE_CALL):
            best_pose, best_conf = None, 0.0
            for s in scales or [1.0]:
                pose = self._estimate_single_scale(image, s)
                minconf = float(np.min(pose[2]))
                if minconf > best_conf:
                    best_conf, best_pose = minconf, pose
            return best_pose

    def _max_dims(self) -> Tuple[int, int]:
        """The largest canvas (rows, columns) computed whole: a spatial axis
        of S ranks takes S times the rows."""
        nsp = self.mesh.spatial if self.mesh is not None else 1
        return self.max_size * nsp, self.max_size

    def _estimate_single_scale(self, image: np.ndarray, scale: float) -> np.ndarray:
        h, w = image.shape[:2]
        ch, cw = canvas_size(h, scale), canvas_size(w, scale)
        if self.mesh is not None:   # the row-sharded maps, the probability-map decode
            return self._decode_whole(*self._scoremaps_dev(image, scale), scale)
        if ch > self.max_size or cw > self.max_size:
            return self._decode_whole(*self._scoremaps_tiled(image, scale), scale)
        bh, bw = _bucket(ch, self.bucket_step), _bucket(cw, self.bucket_step)
        return self._wait(self._batched([image], scale, bh, bw, [ch], [cw]))[0]

    def estimate_pose_batch(self, images: Sequence[np.ndarray],
                            scale: float = 1.0) -> np.ndarray:
        """Batched inference for same-size frames (video serving); returns
        (N, 5, J). All frames must share H x W and fit one canvas. With a
        mesh each frame takes the row-sharded single path."""
        with span(POSE_CALL):
            h, w = images[0].shape[:2]
            for im in images:
                if im.shape[:2] != (h, w):
                    raise ValueError("estimate_pose_batch needs equal frame sizes")
            if self.mesh is not None:
                return np.stack([self._estimate_single_scale(im, scale) for im in images])
            ch, cw = canvas_size(h, scale), canvas_size(w, scale)
            bh, bw = _bucket(ch, self.bucket_step), _bucket(cw, self.bucket_step)
            n = len(images)
            return self._wait(self._batched(images, scale, bh, bw, [ch] * n, [cw] * n))

    def estimate_pose_many(self, images: Sequence[np.ndarray],
                           scale: float = 1.0) -> np.ndarray:
        """Mixed-size batched serving: images are grouped by canvas bucket,
        each group runs batched with per-image valid extents (the decode
        masks each image's own grid), the buckets one after the other with
        one wait at the end, and oversized frames take the tiled single
        path. Returns (N, 5, J) in input order; per-image results
        equal estimate_pose(image, [scale]) up to the batch's rounding. With
        a mesh each frame takes the row-sharded single path."""
        with span(POSE_CALL):
            out = np.zeros((len(images), 5, self.cfg.num_joints), np.float32)
            if self.mesh is not None:
                for idx, im in enumerate(images):
                    out[idx] = self._estimate_single_scale(im, scale)
                return out
            groups: Dict[Tuple[int, int], list] = {}
            for idx, im in enumerate(images):
                h, w = im.shape[:2]
                ch, cw = canvas_size(h, scale), canvas_size(w, scale)
                if ch > self.max_size or cw > self.max_size:  # HD: tiled single path
                    out[idx] = self._estimate_single_scale(im, scale)
                    continue
                bh, bw = _bucket(ch, self.bucket_step), _bucket(cw, self.bucket_step)
                groups.setdefault((bh, bw), []).append((idx, im, ch, cw))
            poses, where = [], []
            for (bh, bw), items in groups.items():   # every bucket enqueued, one wait
                poses.append(self._batched([it[1] for it in items], scale, bh, bw,
                                           [it[2] for it in items], [it[3] for it in items]))
                where += [it[0] for it in items]
            if poses:
                out[where] = self._wait(torch.cat(poses))
            return out

    def estimate_pose_avg(self, image: np.ndarray, scales: Sequence[float]) -> np.ndarray:
        """Multi-scale pyramid with SCOREMAP AVERAGING: each scale's maps are
        resampled to the scale-1 grid by interpolation-matrix products on the
        device and averaged before one decode."""
        with span(POSE_CALL):
            h, w = image.shape[:2]
            gh = canvas_size(h, 1.0) // int(STRIDE)
            gw = canvas_size(w, 1.0) // int(STRIDE)
            acc_sm = acc_loc = None
            for s in scales:
                sm, loc = self._scoremaps_dev(image, s)
                Ah = self._matrix(int(sm.shape[1]), gh)
                Aw = self._matrix(int(sm.shape[2]), gw)

                def resample(m):
                    m = torch.einsum("ow,chw->cho", Aw, m)
                    return torch.einsum("oh,chw->cow", Ah, m)
                acc_sm = resample(sm) if acc_sm is None else acc_sm + resample(sm)
                lr = resample(loc) / s
                acc_loc = lr if acc_loc is None else acc_loc + lr
            n = float(len(scales))
            return self._decode_whole(acc_sm / n, acc_loc / n, 1.0)

    def scoremaps(self, image: np.ndarray, scale: float = 1.0, *, exact: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Full scoremaps + locref for an image, host numpy in the JAX
        package's layout: (h, w, J) and (h, w, 2J). Frames beyond
        `_max_dims` are tiled; with a mesh the rest run row-sharded on a
        canvas padded with zero rows to a multiple of 8 * S (the maps are
        then those of the padded canvas, whose bottom cells can differ from
        the unpadded frame's), and exact=True sends a frame that needs that
        padding to the tiled path instead, as the JAX package does."""
        with span(POSE_CALL):
            sm, loc = self._scoremaps_dev(image, scale, exact=exact)
            with span(POSE_WAIT):
                return (sm.permute(1, 2, 0).cpu().numpy(), loc.permute(1, 2, 0).cpu().numpy())

    def _scoremaps_dev(self, image: np.ndarray, scale: float = 1.0, *, exact: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident (J, h, w) and (2J, h, w) maps on the unbucketed
        canvas, cropped to its ceil(canvas/8) cell grid."""
        h, w = image.shape[:2]
        ch, cw = canvas_size(h, scale), canvas_size(w, scale)
        max_h, max_w = self._max_dims()
        if ch > max_h or cw > max_w:
            return self._scoremaps_tiled(image, scale)
        pad_h = ch
        if self.mesh is not None:
            step = int(STRIDE) * self.mesh.spatial
            pad_h = -(-ch // step) * step
            if pad_h != ch and exact:
                return self._scoremaps_tiled(image, scale)
        canvas = self._canvas(image, scale, ch, cw)
        if pad_h != ch:
            canvas = torch.nn.functional.pad(canvas, (0, 0, 0, 0, 0, pad_h - ch))
        prob, loc = self._maps(canvas)
        gh = ch // int(STRIDE)
        return prob[0, :, :gh], loc[0, :, :gh]

    # -- tiling (estimate_pose.py:146-221, STRIDE-ALIGNED correction) -----
    def _scoremaps_tiled(self, image: np.ndarray, scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """HD scoremaps from tiles of at most max_size px, on the device.
        Tile origins sit on the stride-8 grid and the kept cells partition
        the global grid exactly (`_tile_plan`), so the result lands on the
        same grid as the full-frame computation."""
        h, w = image.shape[:2]
        ch, cw = canvas_size(h, scale), canvas_size(w, scale)
        canvas = self._canvas(image, scale, ch, cw)
        stride = int(STRIDE)
        rows_sm, rows_loc = [], []
        for (sy, ey, ay, by) in _tile_plan(ch, self.max_size):
            row_sm, row_loc = [], []
            for (sx, ex, ax, bx) in _tile_plan(cw, self.max_size):
                th = -(-(ey - sy) // stride) * stride
                tw = -(-(ex - sx) // stride) * stride
                buf = torch.zeros((1, th, tw, 3), dtype=torch.float32, device=self.device)
                buf[:, :ey - sy, :ex - sx] = canvas[:, sy:ey, sx:ex]
                prob, loc = self._maps(buf)
                row_sm.append(prob[0, :, ay:by, ax:bx])
                row_loc.append(loc[0, :, ay:by, ax:bx])
            rows_sm.append(torch.cat(row_sm, dim=2))
            rows_loc.append(torch.cat(row_loc, dim=2))
        return torch.cat(rows_sm, dim=1).contiguous(), torch.cat(rows_loc, dim=1).contiguous()


def _num_tiles(length: int, max_size: int, rf: int) -> int:
    """The reference's tile-count formula (estimate_pose.py:146-156), kept as
    a parity oracle; the tiled path uses `_tile_plan`, whose stride-aligned
    step can need one more tile."""
    if length <= max_size:
        return 1
    k = 0
    while True:
        new_size = (max_size - rf) * 2 + (max_size - 2 * rf) * k
        if new_size > length:
            break
        k += 1
    return 2 + k


def _tile_plan(length: int, max_size: int) -> List[Tuple[int, int, int, int]]:
    """Stride-aligned tiling plan: list of (start_px, end_px, keep_from_cell,
    keep_to_cell). Keep ranges are tile-local and partition the global
    ceil(length/STRIDE) cell grid exactly; tile origins are multiples of
    STRIDE; every kept cell has at least RF pixels of context inside its
    tile except at the frame borders."""
    stride, rf = int(STRIDE), int(RF)
    grid = -(-length // stride)
    if length <= max_size:
        return [(0, length, 0, grid)]
    cut = rf // stride
    step = ((max_size - 2 * rf) // stride) * stride
    n = -(-(length - max_size) // step) + 1
    plan = []
    for i in range(n):
        s = i * step
        e = min(s + max_size, length)
        o = s // stride
        a = 0 if i == 0 else o + cut
        b = grid if i == n - 1 else (i + 1) * step // stride + cut
        plan.append((s, e, a - o, b - o))
    return plan


_MODEL_CACHE: Dict = {}


def get_estimator(model_def: str = "", model_bin: str = "", device="cuda") -> PoseEstimator:
    """Cached PoseEstimator for (model_def, model_bin, device) — the
    module-global model cache of the reference (estimate_pose.py:69-75).
    With no weights the model is the random init of a seeded generator."""
    key = (model_def, model_bin, str(torch.device(device)))
    if key not in _MODEL_CACHE:
        if model_bin:
            from deepcut_tpu_torch.models.convert import load_caffemodel

            params = load_caffemodel(model_bin)
        else:
            from deepcut_tpu_torch.models.resnet import init_params

            params = init_params(torch.Generator().manual_seed(0), deepercut_config(152))
        _MODEL_CACHE[key] = PoseEstimator(params, device=device)
    return _MODEL_CACHE[key]


def estimate_pose(image: np.ndarray, model_def: str = "", model_bin: str = "",
                  scales: Optional[Sequence[float]] = None, device="cuda"
                  ) -> Optional[np.ndarray]:
    """Reference-compatible convenience wrapper (estimate_pose.py:37); the
    model is cached module-globally like the reference's _MODEL."""
    return get_estimator(model_def, model_bin, device).estimate_pose(image, scales)
