"""Host input pipeline: window-file dataset -> prefetched, bucketed batches.

The port's own copy of `deepcut_tpu.data.pipeline` (jax-free; held against the original
by tests/test_torch_data.py).

Replaces the reference's prefetch machinery (MultiBasePrefetchingDataLayer:
InternalThread + BlockingQueue + 3-deep ring + async GPU push,
multi_base_data_layer.cpp:52-80) with a Python producer thread feeding a
bounded queue; device transfer overlaps with compute because jax dispatch is
asynchronous.

Static-shape discipline: each sample's canvas is padded up to a size bucket
(multiple of `bucket_step`), targets padded with ignore-labels/zero-weights —
exactly loss-neutral (see ops/losses.py normalizer semantics) — so a handful
of compiled train-step programs cover the whole dataset.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from deepcut_tpu_torch.data.window_file import ImageRecord, JointStats, default_stats, parse_window_file
from deepcut_tpu_torch.pose import targets as T

from deepcut_tpu_torch.constants import MEAN_BGR
PAD_BORDER = 64  # pose_data_layer.cpp:637


def load_image_bgr(path: str) -> np.ndarray:
    """uint8 HxWx3 BGR (cv2.imread convention used by the reference).

    Decodes with cv2 (libjpeg-turbo SIMD — measured ~1.4x faster than PIL
    per core and BIT-IDENTICAL on JPEG/PNG: both wrap libjpeg's IDCT;
    tests/test_data_workers.py asserts the identity) and falls back to PIL
    when cv2 is unavailable. IGNORE_ORIENTATION matches PIL's
    no-EXIF-rotation convention — and the reference's cv::imread-era
    behavior (pose_data_layer.cpp:627)."""
    try:
        import cv2
        arr = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if arr is not None:
            return arr
    except ImportError:
        pass
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"))
    return arr[:, :, ::-1]


def prepare_canvas(
    image_bgr: np.ndarray, scale: float, input_h: int, input_w: int,
    mean=MEAN_BGR, *, uint8: bool = False,
) -> np.ndarray:
    """Reference image prep (pose_data_layer.cpp:627-667): bilinear resize by
    scale, 64px replicate pad (bottom/right), paste into a mean-filled canvas,
    subtract mean. Returns float32 (input_h, input_w, 3).

    uint8=True skips the subtraction and returns the mean-filled uint8
    canvas instead — the model does `x - mean` on device
    (models/resnet.prepare_input), bit-identically (the mean is integer),
    with 4x less host->device traffic and no full-canvas float pass here."""
    from PIL import Image

    h, w = image_bgr.shape[:2]
    nw, nh = int(round(w * scale)), int(round(h * scale))
    if (nw, nh) == (w, h):
        img = image_bgr  # PIL bilinear to the same size is the identity
    else:
        img = np.asarray(
            Image.fromarray(image_bgr[:, :, ::-1]).resize((nw, nh), Image.BILINEAR)
        )[:, :, ::-1]
    img = np.pad(img, ((0, PAD_BORDER), (0, PAD_BORDER), (0, 0)), mode="edge")
    ch = min(input_h, img.shape[0])
    cw = min(input_w, img.shape[1])
    if uint8:
        # the device-side subtract contract only holds for uint8 pixel data
        # and an integer mean (constants.MEAN_BGR) — anything else would be
        # silently wrapped/truncated by the uint8 buffer below
        if img.dtype != np.uint8:
            raise TypeError(
                f"uint8 canvas requires a uint8 image (got {img.dtype}); "
                "use uint8_images=False with float image loaders")
        mean_arr = np.asarray(mean, np.float32)
        if not np.all(mean_arr == np.round(mean_arr)) or \
                not np.all((0 <= mean_arr) & (mean_arr <= 255)):
            raise ValueError(
                f"uint8 canvas requires an integer mean in [0, 255] "
                f"(got {mean}); use uint8=False for custom means")
        canvas = np.empty((input_h, input_w, 3), np.uint8)
        canvas[:] = mean_arr.astype(np.uint8)
        canvas[:ch, :cw] = img[:ch, :cw]
        return canvas
    # mean-filled canvas minus mean == zeros outside the pasted region, so
    # build the subtraction fused into the paste (one full-canvas float
    # pass instead of three — this is the input pipeline's hottest line)
    canvas = np.zeros((input_h, input_w, 3), np.float32)
    canvas[:ch, :cw] = img[:ch, :cw] - np.asarray(mean, np.float32)
    return canvas


def load_canvas(path: str, M, scale: float, ih: int, iw: int, *,
                uint8: bool = False,
                loader: Optional[Callable[[str], np.ndarray]] = None,
                ) -> np.ndarray:
    """The RNG-free heavy phase of one sample: decode, optional affine warp,
    canvas prep. Pure function of its arguments — the SAME code runs on the
    calling thread (workers=0), thread-pool workers, and worker PROCESSES
    (data/worker.py), which is what makes the worker modes bit-identical to
    the serial path by construction.

    When augmenting with cv2 available, the scale resize is FUSED into the
    affine warp (scale*M is still affine): one resample instead of warp +
    PIL resize — ~2x faster and no double-blur. Joint coords are untouched
    (the rasterizer applies `scale` itself to the M-warped record). The
    non-augmented path keeps PIL resize for reference parity
    (scipy.misc.imresize semantics)."""
    image = (loader or load_image_bgr)(path)
    if M is not None:
        from deepcut_tpu_torch.pose.augment import _cv2, warp_image
        if _cv2 is not None and scale != 1.0:
            h, w = image.shape[:2]
            nh, nw = int(round(h * scale)), int(round(w * scale))
            image = warp_image(image, scale * np.asarray(M), (nh, nw))
            return prepare_canvas(image.astype(np.uint8), 1.0, ih, iw,
                                  uint8=uint8)
        image = warp_image(image, M, image.shape[:2]).astype(np.uint8)
        return prepare_canvas(image, scale, ih, iw, uint8=uint8)
    return prepare_canvas(image, scale, ih, iw, uint8=uint8)


def _bucket(v: int, step: int) -> int:
    return int(math.ceil(v / step) * step)


class PoseDataSource:
    """Training sample stream with reference-equivalent sampling semantics.

    - uniform random image choice, or epoch-shuffled when `cycle` (the fork's
      cycle_training_data, pose_data_layer.cpp:508-520);
    - per-sample scale jitter;
    - rejection of tiny (<100px) and oversize (> max_input_size^2) samples.
    """

    def __init__(
        self,
        source,
        cfg: T.TargetConfig = T.TargetConfig(),
        stats: Optional[JointStats] = None,
        *,
        root_folder: str = "",
        cycle: bool = False,
        seed: int = 0,
        bucket_step: int = 64,
        image_loader: Optional[Callable[[str], np.ndarray]] = None,
        augment: bool = False,
        max_rotation_deg: float = 15.0,
        workers: int = 0,
        worker_mode: str = "thread",
        uint8_images: bool = False,
        device_targets: bool = False,
        augment_device: bool = False,
        raw_bucket_step: Optional[int] = None,
    ):
        if isinstance(source, str):
            self.records = parse_window_file(source, root_folder)
        else:
            self.records = list(source)
        if not self.records:
            raise ValueError("empty window file")
        self.cfg = cfg
        self.stats = stats or default_stats(cfg.num_classes)
        self.cycle = cycle
        self.rng = np.random.RandomState(seed)
        self.bucket_step = bucket_step
        self.image_loader = image_loader or load_image_bgr
        self.augment = augment
        self.max_rotation_deg = max_rotation_deg
        # workers > 0: decode/warp/canvas of the samples in a batch run on a
        # pool. All RNG draws stay on the calling thread in sample order, so
        # the produced batches are BIT-IDENTICAL to workers=0 (tested).
        # worker_mode:
        # - "thread": PIL's jpeg decode and the cv2 warp release the GIL,
        #   but the numpy canvas work serializes on it. CONTRACT: a custom
        #   image_loader is called concurrently and must be thread-safe.
        # - "process": spawn-based worker processes (data/worker.py) run the
        #   whole heavy phase off the training process — the lever that
        #   takes augmented batch>=8 training off the host wall. CONTRACT:
        #   a custom image_loader must be picklable and self-contained
        #   (it runs in a fresh interpreter); paths must be readable there.
        self.workers = int(workers)
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', "
                             f"got {worker_mode!r}")
        self.worker_mode = worker_mode
        # uint8_images: emit mean-FILLED uint8 canvases instead of
        # mean-SUBTRACTED float32 ones; the train step subtracts on device
        # (models/resnet.prepare_input), bit-identically. 4x smaller batches.
        self.uint8_images = uint8_images
        # device_targets: ship compact `anno_*` annotation arrays instead of
        # dense target maps; the train step rasterizes them ON DEVICE
        # (pose/targets_device.py) — bit-identical targets, ~18x less
        # host->device traffic for the pairwise configuration. RPN and
        # segmentation targets (small) stay host-built either way.
        self.device_targets = device_targets
        # augment_device: ship the DECODED uint8 image plus 6 affine
        # coefficients and warp + scale + canvas-prep ON DEVICE inside the
        # train step (pose/augment_device.py). Host cost collapses to JPEG
        # decode; the RNG stream and all targets stay identical to the host
        # path (joints transform on the host, exactly) while pixels carry a
        # characterized couple-of-grey-levels filter drift vs cv2 (which
        # quantizes sample coords to 1/32 px). Works with or without
        # `augment` (without, it is a device-side scale+canvas). The
        # non-augment host path's PIL-resize parity is NOT preserved —
        # this mode trades it for a decode-only host.
        self.augment_device = augment_device
        if augment_device and bucket_step % 16:
            raise ValueError(
                f"augment_device requires bucket_step % 16 == 0 (got "
                f"{bucket_step}): the device warp blocks canvas rows by 16")
        # raw_bucket_step: bucket granularity for the RAW image dims that
        # augment_device adds as NEW static shape axes on top of the canvas
        # bucket. Remote TPU compiles cost 10-60 s/shape, so datasets with
        # heterogeneous source resolutions should set this COARSER than
        # bucket_step (e.g. 256) to collapse the raw-shape axis to a few
        # buckets; the warp ignores mean-padded rows/cols, so a coarse raw
        # bucket costs only a little extra warp FLOPs, never accuracy.
        self.raw_bucket_step = int(raw_bucket_step or bucket_step)
        if device_targets:
            from deepcut_tpu_torch.pose.targets_device import record_limits
            self._limits = record_limits(self.records)
        self._pool = None
        self._proc_pool = None
        self._order: List[int] = []
        self._pos = 0

    def _next_index(self) -> int:
        if self.cycle:
            if self._pos == 0:
                self._order = list(self.rng.permutation(len(self.records)))
            idx = self._order[self._pos]
            self._pos = (self._pos + 1) % len(self.records)
            return idx
        return int(self.rng.randint(len(self.records)))

    def close(self) -> None:
        """Shut down the decode pool (no-op for workers=0). Safe to call
        more than once; the source stays usable (a later batch just
        recreates the pool)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._proc_pool is not None:
            self._proc_pool.close()
            self._proc_pool = None

    def _get_proc_pool(self):
        if self._proc_pool is None:
            from deepcut_tpu_torch.data.worker import CanvasPool

            loader = (None if self.image_loader is load_image_bgr
                      else self.image_loader)
            self._proc_pool = CanvasPool(self.workers, loader)
        return self._proc_pool

    def _draw_spec(self):
        """The serial RNG phase of one sample: index/scale draws with
        rejection, augmentation parameter draws, and target rasterization —
        everything that consumes `self.rng`, in the exact order the serial
        path consumes it. Returns (maps, path, affine_M, scale); the image
        itself is untouched (the heavy phase is RNG-free)."""
        rejected = 0
        while True:
            rec = self.records[self._next_index()]
            scale = T.sample_scale(self.cfg, self.rng)
            if not T.accepts(self.cfg, rec.height, rec.width, scale):
                # the reference silently re-draws (pose_data_layer.cpp
                # max_input_size rejection) — but a dataset where EVERY
                # record is rejected would spin forever; fail loudly after
                # a full epoch's worth of consecutive misses
                rejected += 1
                if rejected >= max(20 * len(self.records), 100):
                    raise RuntimeError(
                        f"PoseDataSource: {rejected} consecutive samples "
                        f"rejected (min_image_size={self.cfg.min_image_size}, "
                        f"max_input_size={self.cfg.max_input_size}) — every "
                        "record seems outside the accepted size range")
                continue
            break
        M = None
        if self.augment:
            from deepcut_tpu_torch.pose.augment import draw_affine
            M, rec = draw_affine(rec, self.rng,
                                 max_rotation_deg=self.max_rotation_deg)
        if self.device_targets:
            from deepcut_tpu_torch.pose.targets_device import compact_sample
            maps = compact_sample(rec, self.cfg, self.stats, self.rng,
                                  scale=scale, limits=self._limits)
        else:
            maps = T.rasterize_native(rec, self.cfg, self.stats, self.rng,
                                      scale=scale)
        if self.augment_device:
            from deepcut_tpu_torch.pose.augment import device_warp_coef
            maps["aug_coef"], nhw = device_warp_coef(
                M, scale, rec.height, rec.width)
            # [nh, nw, input_h, input_w]: the device warp reproduces the
            # host canvas at the per-sample input_size (the edge-pad band is
            # cropped there, pipeline.prepare_canvas) and zero-fills the
            # bucket padding beyond it, like _collate does for host canvases
            maps["aug_nhw"] = np.concatenate(
                [nhw, maps["input_size"].astype(np.float32)])
        return maps, rec.path, M, scale

    def _load_canvas(self, path: str, M, scale: float, ih: int, iw: int) -> np.ndarray:
        """The RNG-free heavy phase: decode, optional affine warp, canvas
        prep (module-level `load_canvas`). Safe on a worker thread."""
        return load_canvas(path, M, scale, ih, iw, uint8=self.uint8_images,
                           loader=self.image_loader)

    def _finish(self, spec) -> Dict[str, np.ndarray]:
        maps, path, M, scale = spec
        if self.augment_device:
            # decode only — the warp/scale/canvas run on device
            maps["image_raw"] = self.image_loader(path)
            return maps
        ih, iw = int(maps["input_size"][0]), int(maps["input_size"][1])
        maps["image"] = self._load_canvas(path, M, scale, ih, iw)
        return maps

    def next_sample(self) -> Dict[str, np.ndarray]:
        """One rasterized sample (unbatched), retrying rejected images."""
        return self._finish(self._draw_spec())

    def _tasks(self, specs):
        """Worker-process task tuples for a list of _draw_spec results
        (augment_device: just the paths — workers only decode)."""
        if self.augment_device:
            return [path for _maps, path, _M, _scale in specs]
        return [(path, M, scale, int(maps["input_size"][0]),
                 int(maps["input_size"][1]), self.uint8_images)
                for maps, path, M, scale in specs]

    def _assemble(self, specs, canvases) -> Dict[str, np.ndarray]:
        key = "image_raw" if self.augment_device else "image"
        samples = []
        for (maps, _path, _M, _scale), canvas in zip(specs, canvases):
            maps[key] = canvas
            samples.append(maps)
        return self._collate(samples)

    def next_batch(self, batch_size: int = 1) -> Dict[str, np.ndarray]:
        """Batch of bucket-padded samples (pad with ignore/zero-weight).

        With workers > 0 the per-sample decode/warp/canvas work fans out to
        a thread pool or worker processes (worker_mode); the RNG phase stays
        serial, so batches equal the workers=0 output exactly."""
        specs = [self._draw_spec() for _ in range(batch_size)]
        if self.workers > 0 and self.worker_mode == "process":
            return self._assemble(
                specs, self._get_proc_pool().map(
                    self._tasks(specs), decode=self.augment_device))
        if self.workers > 0 and batch_size > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="deepcut-data")
            samples = list(self._pool.map(self._finish, specs))
        else:
            samples = [self._finish(s) for s in specs]
        return self._collate(samples)

    def _collate(self, samples) -> Dict[str, np.ndarray]:
        if "image_raw" in samples[0]:
            # device warp: the canvas never exists on the host — its bucket
            # comes from the per-sample input_size the rasterizer computed
            bh = _bucket(max(int(s["input_size"][0]) for s in samples),
                         self.bucket_step)
            bw = _bucket(max(int(s["input_size"][1]) for s in samples),
                         self.bucket_step)
        else:
            bh = _bucket(max(s["image"].shape[0] for s in samples), self.bucket_step)
            bw = _bucket(max(s["image"].shape[1] for s in samples), self.bucket_step)
        gh, gw = bh // T.STRIDE, bw // T.STRIDE
        out: Dict[str, np.ndarray] = {}
        keys = [k for k in samples[0] if k not in ("scale", "input_size")]
        if "image_raw" in samples[0]:
            # zero-byte shape token carrying the static canvas size into the
            # jitted warp (pose/augment_device.warp_batch); leading batch
            # dim so mesh batch-sharding specs apply uniformly
            out["aug_canvas"] = np.zeros((len(samples), bh, bw, 0), np.uint8)
        for k in keys:
            if k == "image_raw":
                # raw decoded images, bucket-padded with the MEAN pixel so
                # border taps blend toward the mean on device exactly like
                # the host warp's BORDER_CONSTANT fill
                rbh = _bucket(max(s[k].shape[0] for s in samples),
                              self.raw_bucket_step)
                rbw = _bucket(max(s[k].shape[1] for s in samples),
                              self.raw_bucket_step)
                raws = []
                for s in samples:
                    a = s[k]
                    # the device warp's mean-subtract contract only holds
                    # for uint8 pixels — same loud failure as the host
                    # uint8 path (prepare_canvas) instead of silent
                    # wrap/truncate into the uint8 buffer
                    if a.dtype != np.uint8:
                        raise TypeError(
                            f"augment_device requires a uint8 image loader "
                            f"(got {a.dtype}); use augment_device=False "
                            "with float image loaders")
                    rb = np.empty((rbh, rbw, 3), np.uint8)
                    rb[:] = np.asarray(MEAN_BGR, np.uint8)
                    rb[: a.shape[0], : a.shape[1]] = a
                    raws.append(rb)
                out[k] = np.stack(raws)
                continue
            if k in ("aug_coef", "aug_nhw"):
                out[k] = np.stack([s[k] for s in samples])
                continue
            if k.startswith("anno_"):
                if k == "anno_neg_mask":
                    ms = []
                    for s in samples:
                        a = s[k]
                        b = np.zeros((gh, gw), np.uint8)
                        b[: a.shape[0], : a.shape[1]] = a
                        ms.append(b)
                    out[k] = np.stack(ms)
                else:
                    # fixed per-source shapes (CompactLimits) — stack as-is
                    out[k] = np.stack([s[k] for s in samples])
                continue
            pads = []
            for s in samples:
                a = s[k]
                if k == "image" and a.dtype == np.uint8:
                    # uint8 canvases: bucket padding is the MEAN pixel (the
                    # device-side subtract turns it into the float path's 0)
                    b = np.empty((bh, bw, a.shape[2]), np.uint8)
                    b[:] = np.asarray(MEAN_BGR, np.uint8)
                    b[: a.shape[0], : a.shape[1]] = a
                    pads.append(b)
                    continue
                if k == "image":
                    pad_val, th, tw = 0.0, bh, bw
                elif k == "segm_cls_targets":
                    # may live on its own stride grid; pad to the BATCH max
                    # (a per-sample size would make np.stack fail for
                    # batch>1 under scale jitter)
                    pad_val = T.IGNORE_VALUE
                    th = _bucket(max(s[k].shape[0] for s in samples),
                                 max(self.bucket_step // 8, 1))
                    tw = _bucket(max(s[k].shape[1] for s in samples),
                                 max(self.bucket_step // 8, 1))
                elif k.endswith("cls_targets") or k == "part_score_targets":
                    # classification maps pad with ignore, regression/weight
                    # maps with 0 — both loss-neutral
                    pad_val, th, tw = T.IGNORE_VALUE, gh, gw
                else:
                    pad_val, th, tw = 0.0, gh, gw
                b = np.full((th, tw) + a.shape[2:], pad_val, np.float32)
                b[: a.shape[0], : a.shape[1]] = a
                pads.append(b)
            out[k] = np.stack(pads)
        return out

    def batches(self, batch_size: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        if self.workers > 0 and self.worker_mode == "process":
            # software-pipelined: while the pool decodes batch i, the
            # producer thread draws batch i+1's serial RNG phase and
            # collates batch i-1 — the worker processes never idle. Batch
            # CONTENT is unchanged (RNG draws happen in the same order).
            dec = self.augment_device
            pool = self._get_proc_pool()
            specs = [self._draw_spec() for _ in range(batch_size)]
            pending = pool.map_async(self._tasks(specs), decode=dec)
            while True:
                next_specs = [self._draw_spec() for _ in range(batch_size)]
                # re-resolve the pool every submission: close() between
                # batches terminates the captured one, and the contract is
                # that a later batch just recreates it
                next_pool = self._get_proc_pool()
                next_pending = next_pool.map_async(self._tasks(next_specs),
                                                   decode=dec)
                if self._proc_pool is not pool:
                    # close() invalidated the pool holding the in-flight
                    # batch; the heavy phase is RNG-free, so resubmitting
                    # the SAME specs reproduces it bit-identically
                    loaded = self._get_proc_pool().map(self._tasks(specs),
                                                       decode=dec)
                else:
                    loaded = pending.get()
                yield self._assemble(specs, loaded)
                specs, pending, pool = next_specs, next_pending, next_pool
        while True:
            yield self.next_batch(batch_size)


class _ProducerError:
    """Wrapper carrying a producer-thread exception through the queue."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Bounded-queue producer thread (PREFETCH_COUNT=3 like pose_layers.hpp:40)."""

    def __init__(self, make_batch: Callable[[], Dict[str, np.ndarray]], depth: int = 3):
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._make = make_batch
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    _MAX_CONSECUTIVE_ERRORS = 3

    def _run(self):
        errors = 0
        while not self._stop.is_set():
            try:
                batch = self._make()
                errors = 0
            except Exception as e:  # surface in the consumer, don't hang
                # (Exception only: SystemExit/KeyboardInterrupt propagate
                # and end the thread)
                batch = _ProducerError(e)
                errors += 1
            while not self._stop.is_set():
                try:
                    self.queue.put(batch, timeout=0.25)
                    break
                except queue.Full:
                    continue
            # transient errors don't kill the producer — a consumer that
            # skips the bad sample gets fresh batches on the next get();
            # PERSISTENT failure (several in a row) terminates the thread
            # instead of spinning forever holding the data source alive
            if errors >= self._MAX_CONSECUTIVE_ERRORS:
                return

    def get(self) -> Dict[str, np.ndarray]:
        batch = self.queue.get()
        if isinstance(batch, _ProducerError):
            # re-raise the producer thread's failure at the consumer call
            # site (the reference aborts via CHECK inside load_batch; a
            # silently dead thread would block this get() forever)
            raise batch.exc
        return batch

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
