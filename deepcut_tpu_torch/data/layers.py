"""Data-layer sources: host-side batch producers bound to graph data layers.

The port's own copy of `deepcut_tpu.data.layers` (jax-free; held against
the original by tests/test_torch_data_layers.py). In the reference these
are Layers with prefetch threads (DataLayer, ImageDataLayer, HDF5DataLayer,
MemoryDataLayer, WindowDataLayer, PoseDataLayer); here each is a
``next_batch() -> [numpy arrays, NCHW]`` producer that `core.graph.Net`
pulls from when a forward or a train step is not handed the tops, and
moves to the net's device. Every random draw (crop, mirror, shuffle,
window sampling) comes from the source's own ``np.random.RandomState(0)``
in the original's order, so batches are bit-equal across the packages.
h5py is imported only by the HDF5 paths, which raise ImportError naming
it where it is missing.
"""

from __future__ import annotations

import math as _math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepcut_tpu_torch.proto.text_format import PbNode
from deepcut_tpu_torch.data.transformer import DataTransformer
from deepcut_tpu_torch.data.datum import Datum


def _cround(v: float) -> int:
    """C round(): half away from zero — Python's round() is half-to-even,
    which diverges on exact .5 ties (window_data_layer.cpp uses ::round).
    Implemented by explicit fraction compare: the floor(v+0.5) idiom rounds
    up spuriously when v+0.5 crosses a float boundary (e.g. the largest
    double below 0.5)."""
    f = _math.floor(v)
    frac = v - f
    if frac > 0.5 or (frac == 0.5 and v > 0):
        return int(f) + 1
    return int(f)


class DataLayerSource:
    tops: List[str]

    def next_batch(self) -> List[np.ndarray]:  # pragma: no cover - interface
        raise NotImplementedError

    def top_shapes(self) -> Optional[List[Tuple[int, ...]]]:
        """The tops' shapes as the layer declares them, or None: the net
        then pulls a batch to learn them."""
        return None

    def close(self) -> None:
        """Release what the source holds (threads, worker pools)."""


class LMDBDataSource(DataLayerSource):
    """`Data` layer over LMDB or LevelDB (reference: data_layer.cpp +
    db_lmdb.cpp / db_leveldb.cpp, dispatched like db.cpp:9-20).

    Cycles the cursor like DataReader (one pass order, wrap at end).
    """

    def __init__(self, spec, phase: str):
        dp = spec.param("data_param")
        backend = str(dp.get_str("backend", "")).upper()
        if not backend:
            # caffe.proto:632 defaults DataParameter.backend to LEVELDB;
            # detect from the directory so either store opens without an
            # explicit field (a LevelDB dir has CURRENT, an LMDB a data.mdb)
            src = dp.get_str("source", "")
            if os.path.exists(os.path.join(src, "CURRENT")):
                backend = "LEVELDB"
            elif os.path.exists(os.path.join(src, "data.mdb")) or os.path.isfile(src):
                backend = "LMDB"
            else:
                backend = "LEVELDB"  # the reference default
        if backend == "LEVELDB":
            from deepcut_tpu_torch.data.leveldb_store import LevelDBReader

            self.reader = LevelDBReader(dp.get_str("source"))
        else:
            from deepcut_tpu_torch.data.lmdb_store import LMDBReader

            self.reader = LMDBReader(dp.get_str("source"))
        self.batch_size = dp.get_int("batch_size", 1)
        self.tops = list(spec.tops)
        self.transform = DataTransformer(spec.param("transform_param"), phase)
        # cursor semantics like DataReader (one pass order, wrap at end) —
        # iterate lazily instead of materializing the whole DB in host RAM
        if len(self.reader) == 0:
            raise ValueError(f"empty {backend} dataset")
        self._cursor = iter(self.reader.items())

    def _next_value(self) -> bytes:
        try:
            return next(self._cursor)[1]
        except StopIteration:
            self._cursor = iter(self.reader.items())
            return next(self._cursor)[1]

    def next_batch(self) -> List[np.ndarray]:
        data, labels = [], []
        for _ in range(self.batch_size):
            datum = Datum.decode(self._next_value())
            data.append(self.transform(datum.to_array()))
            labels.append(datum.label or 0)
        out = [np.stack(data)]
        if len(self.tops) > 1:
            out.append(np.asarray(labels, np.float32))
        return out


class ImageDataSource(DataLayerSource):
    """`ImageData` layer (image_data_layer.cpp): txt file of `path label`."""

    def __init__(self, spec, phase: str):
        ip = spec.param("image_data_param")
        self.tops = list(spec.tops)
        self.batch_size = ip.get_int("batch_size", 1)
        self.new_h = ip.get_int("new_height", 0)
        self.new_w = ip.get_int("new_width", 0)
        self.is_color = ip.get_bool("is_color", True)
        self.root = ip.get_str("root_folder", "")
        self.transform = DataTransformer(spec.param("transform_param"), phase)
        # split on the LAST whitespace: image paths may contain spaces
        # (same convention as tools/datasets.py convert_imageset)
        with open(ip.get_str("source")) as f:
            self.lines = [l.strip().rsplit(None, 1) for l in f if l.strip()]
        self.shuffle = ip.get_bool("shuffle", False)
        self.rng = np.random.RandomState(0)
        if self.shuffle:
            self.rng.shuffle(self.lines)
        self.pos = 0
        # rand_skip: random start offset (image_data_layer.cpp:57-59)
        skip = ip.get_int("rand_skip", 0)
        if skip:
            self.pos = int(self.rng.randint(skip)) % len(self.lines)

    def _load(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(self.root + path) as im:
            im = im.convert("RGB" if self.is_color else "L")
            if self.new_h and self.new_w:
                im = im.resize((self.new_w, self.new_h), Image.BILINEAR)
            arr = np.asarray(im, np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        else:
            arr = arr[:, :, ::-1]  # BGR
        return arr.transpose(2, 0, 1)

    def next_batch(self) -> List[np.ndarray]:
        data, labels = [], []
        for _ in range(self.batch_size):
            path, label = self.lines[self.pos][0], self.lines[self.pos][-1]
            self.pos += 1
            if self.pos >= len(self.lines):
                # epoch wrap: the reference reshuffles the list each epoch
                # (image_data_layer.cpp:154-155)
                self.pos = 0
                if self.shuffle:
                    self.rng.shuffle(self.lines)
            data.append(self.transform(self._load(path)))
            labels.append(float(label))
        return [np.stack(data), np.asarray(labels, np.float32)]


class MemoryDataSource(DataLayerSource):
    """`MemoryData` layer: arrays supplied via Net.set_input_arrays, served
    `batch_size` items at a time in order, wrapping at the end. Its declared
    shapes let a net materialise its params before the arrays are set (the
    JAX package pulls a batch instead)."""

    def __init__(self, spec, phase: str):
        mp = spec.param("memory_data_param")
        self.tops = list(spec.tops)
        self.batch_size = mp.get_int("batch_size", 1)
        self.chw = tuple(mp.get_int(k, 0) for k in ("channels", "height", "width"))
        self.data: Optional[np.ndarray] = None
        self.labels: Optional[np.ndarray] = None
        self.pos = 0

    def top_shapes(self) -> Optional[List[Tuple[int, ...]]]:
        """(batch, channels, height, width) and (batch,), as
        memory_data_param declares them (memory_data_layer.cpp
        DataLayerSetUp): a net learns its params' shapes before the arrays
        are set."""
        if not all(self.chw):
            return None
        return [(self.batch_size,) + self.chw, (self.batch_size,)][:len(self.tops)]

    def set_arrays(self, data: np.ndarray, labels: np.ndarray) -> None:
        self.data = np.asarray(data, np.float32)
        self.labels = np.asarray(labels, np.float32)
        self.pos = 0

    def next_batch(self) -> List[np.ndarray]:
        if self.data is None:
            raise RuntimeError("MemoryData: call set_input_arrays first")
        n = self.data.shape[0]
        idx = [(self.pos + i) % n for i in range(self.batch_size)]
        self.pos = (self.pos + self.batch_size) % n
        return [self.data[idx], self.labels[idx]]


class HDF5DataSource(DataLayerSource):
    """`HDF5Data` layer (hdf5_data_layer.cpp): source lists .h5 files; tops
    name the datasets."""

    def __init__(self, spec, phase: str):
        hp = spec.param("hdf5_data_param")
        self.tops = list(spec.tops)
        self.batch_size = hp.get_int("batch_size", 1)
        with open(hp.get_str("source")) as f:
            self.files = [l.strip() for l in f if l.strip()]
        if not self.files:
            raise ValueError("HDF5Data: empty source list")
        self.shuffle = hp.get_bool("shuffle", False)
        self.rng = np.random.RandomState(0)
        # one file resident at a time, row permutation within the file and a
        # file permutation over files, both redrawn per pass when shuffling
        # (hdf5_data_layer.cpp:55-66,97-110,137-147) — the reference never
        # concatenates files, so multi-GB datasets stream instead of OOMing
        self.file_perm = (self.rng.permutation(len(self.files))
                          if self.shuffle else np.arange(len(self.files)))
        self.file_idx = 0
        self._load_file(self.files[self.file_perm[0]])

    def _load_file(self, path: str) -> None:
        import h5py

        with h5py.File(path, "r") as h5:
            self.arrays = {t: np.asarray(h5[t], np.float32) for t in self.tops}
        self.n = len(next(iter(self.arrays.values())))
        self.perm = (self.rng.permutation(self.n) if self.shuffle
                     else np.arange(self.n))
        self.pos = 0

    def next_batch(self) -> List[np.ndarray]:
        rows: List[List[np.ndarray]] = []
        for _ in range(self.batch_size):
            r = self.perm[self.pos]
            rows.append([self.arrays[t][r] for t in self.tops])
            self.pos += 1
            if self.pos >= self.n:  # file exhausted: advance (maybe wrap)
                self.file_idx += 1
                if self.file_idx >= len(self.files):
                    self.file_idx = 0
                    if self.shuffle:
                        self.file_perm = self.rng.permutation(len(self.files))
                if len(self.files) > 1:
                    self._load_file(self.files[self.file_perm[self.file_idx]])
                else:  # single file: just redraw the row permutation
                    self.pos = 0
                    if self.shuffle:
                        self.perm = self.rng.permutation(self.n)
        return [np.stack([r[i] for r in rows]) for i in range(len(self.tops))]


class PoseDataSourceAdapter(DataLayerSource):
    """`PoseData` layer -> the native pipeline (data/pipeline.py)."""

    def __init__(self, spec, phase: str):
        from deepcut_tpu_torch.tools.cli import _target_config_from_layer
        from deepcut_tpu_torch.data.pipeline import PoseDataSource
        from deepcut_tpu_torch.data.window_file import parse_stats_file

        tcfg, pp = _target_config_from_layer(spec.node)
        stats = None
        if pp.get_str("joint_pairs_stats"):
            stats = parse_stats_file(pp.get_str("joint_pairs_stats"))
        self.tops = list(spec.tops)
        self.batch_size = pp.get_int("batch_size", 1)
        self.source = PoseDataSource(
            pp.get_str("source"), tcfg, stats,
            root_folder=pp.get_str("root_folder", ""),
            cycle=pp.get_bool("cycle_training_data", False),
        )
        self._key_order = ["part_score_targets", "part_score_weights",
                           "locref_targets", "locref_weights",
                           "pairwise_targets", "pairwise_weights",
                           "rpn_cls_targets", "rpn_reg_targets",
                           "rpn_reg_weights", "segm_cls_targets"]

    def next_batch(self) -> List[np.ndarray]:
        batch = self.source.next_batch(self.batch_size)
        outs = [batch["image"].transpose(0, 3, 1, 2)]
        for key in self._key_order:
            if key in batch and len(outs) < len(self.tops):
                outs.append(batch[key].transpose(0, 3, 1, 2))
        return outs

    def close(self) -> None:
        self.source.close()


class WindowDataSource(DataLayerSource):
    """`WindowData` layer (window_data_layer.cpp): R-CNN window file —
    `# idx / path / channels height width / num_windows / cls overlap x1 y1
    x2 y2` — sampled at fg_fraction by overlap thresholds, cropped with
    context padding, warped to crop_size, random-mirrored (any phase,
    like the reference's transform_param_.mirror())."""

    def __init__(self, spec, phase: str):
        wp = spec.param("window_data_param")
        tp = spec.param("transform_param")
        self.tops = list(spec.tops)
        self.batch_size = wp.get_int("batch_size", 1)
        # the reference layer reads crop_size/mirror from transform_param
        # (window_data_layer.cpp:69-70,172,242); the same-named
        # WindowDataParameter fields are the V0 legacy form kept as fallback
        self.crop_size = tp.get_int("crop_size",
                                    wp.get_int("crop_size", 227))
        self.mirror = tp.get_bool("mirror", wp.get_bool("mirror", False))
        self.scale = tp.get_float("scale", 1.0)
        self.context_pad = wp.get_int("context_pad", 0)
        self.use_square = wp.get_str("crop_mode", "warp") == "square"
        self.fg_threshold = wp.get_float("fg_threshold", 0.5)
        self.bg_threshold = wp.get_float("bg_threshold", 0.5)
        self.fg_fraction = wp.get_float("fg_fraction", 0.25)
        self.mean_values = [float(v) for v in
                            tp.get_list("mean_value")] or [0.0]
        # mean_file (window_data_layer.cpp:191-214): subtract the center
        # crop_size window of the mean blob, aligned with the pad offsets
        self._mean_blob = None
        if tp.get_str("mean_file", ""):
            from deepcut_tpu_torch.io import blobproto_bytes_to_array
            with open(tp.get_str("mean_file"), "rb") as f:
                arr = blobproto_bytes_to_array(f.read())
            self._mean_blob = np.ascontiguousarray(
                arr.reshape(arr.shape[-3:]).transpose(1, 2, 0), np.float32)
        self.phase = phase
        self.rng = np.random.RandomState(0)
        self.fg: List[Tuple[str, List[float]]] = []
        self.bg: List[Tuple[str, List[float]]] = []
        self._parse(wp.get_str("source"), wp.get_str("root_folder", ""))
        # the reference decodes per batch unless cache_images is set
        # (window_data_layer.cpp:65,102,285); an unconditional cache would
        # grow without bound on real window files
        self.cache_images = wp.get_bool("cache_images", False)
        self._cache: Dict[str, np.ndarray] = {}

    def _parse(self, source: str, root: str) -> None:
        with open(source) as f:
            toks = f.read().split()
        pos = 0
        while pos < len(toks):
            assert toks[pos] == "#"
            pos += 2
            path = root + toks[pos]; pos += 1
            pos += 3  # channels height width
            num = int(toks[pos]); pos += 1
            for _ in range(num):
                cls, overlap = float(toks[pos]), float(toks[pos + 1])
                box = [float(t) for t in toks[pos + 2:pos + 6]]
                pos += 6
                rec = (path, [cls] + box)
                if overlap >= self.fg_threshold:
                    self.fg.append(rec)
                elif overlap < self.bg_threshold:
                    self.bg.append((path, [0.0] + box))

    def _load(self, path: str) -> np.ndarray:
        from deepcut_tpu_torch.data.pipeline import load_image_bgr
        if not self.cache_images:
            return load_image_bgr(path)
        if path not in self._cache:
            self._cache[path] = load_image_bgr(path)
        return self._cache[path]

    def next_batch(self) -> List[np.ndarray]:
        from PIL import Image

        cs = self.crop_size
        n_fg = int(self.batch_size * self.fg_fraction)
        data, labels = [], []
        # the reference samples the bg quota first, then fg
        # (window_data_layer.cpp:265-276 num_samples = {bs - num_fg, num_fg})
        order = [False] * (self.batch_size - n_fg) + [True] * n_fg
        for is_fg in order:
            pool = self.fg if (is_fg and self.fg) else (self.bg or self.fg)
            path, window = pool[int(self.rng.randint(len(pool)))]
            cls = window[0]
            x1, y1, x2, y2 = (_cround(c) for c in window[1:])
            do_mirror = bool(self.mirror and self.rng.randint(2))  # any phase (ref :279)
            img = self._load(path)
            ih, iw = img.shape[:2]
            pad_w = pad_h = 0
            out_w = out_h = cs
            if self.context_pad > 0 or self.use_square:
                # expand the window so that warping it to cs x cs leaves
                # exactly context_pad on each side (ref :307-330)
                ctx = cs / float(cs - 2 * self.context_pad)
                half_h = (y2 - y1 + 1) / 2.0
                half_w = (x2 - x1 + 1) / 2.0
                cx, cy = x1 + half_w, y1 + half_h
                if self.use_square:
                    half_h = half_w = max(half_h, half_w)
                x1 = _cround(cx - half_w * ctx); x2 = _cround(cx + half_w * ctx)
                y1 = _cround(cy - half_h * ctx); y2 = _cround(cy + half_h * ctx)
                # clip to the image, tracking the out-of-image extent (:335-349)
                uw, uh = x2 - x1 + 1, y2 - y1 + 1
                px1, py1 = max(0, -x1), max(0, -y1)
                px2, py2 = max(0, x2 - iw + 1), max(0, y2 - ih + 1)
                x1 += px1; x2 -= px2; y1 += py1; y2 -= py2
                # warp the CLIPPED region by the UNCLIPPED scale factors and
                # paste at the scaled pad offset; padding stays at the mean
                # (zeros post-subtraction), ref :355-397
                sx, sy = cs / float(uw), cs / float(uh)
                out_w = _cround((x2 - x1 + 1) * sx)
                out_h = _cround((y2 - y1 + 1) * sy)
                px1 = _cround(px1 * sx); px2 = _cround(px2 * sx)
                py1 = _cround(py1 * sy)
                pad_h = py1
                pad_w = px2 if do_mirror else px1  # mirrored padding (:372-377)
                out_h = min(out_h, cs - pad_h)
                out_w = min(out_w, cs - pad_w)
            x1 = max(x1, 0); y1 = max(y1, 0)
            x2 = min(x2, iw - 1); y2 = min(y2, ih - 1)
            crop = img[y1:y2 + 1, x1:x2 + 1]
            if crop.size == 0:
                crop = img[:1, :1]
            warped = np.asarray(Image.fromarray(
                crop[:, :, ::-1].astype(np.uint8)).resize(
                (max(out_w, 1), max(out_h, 1)), Image.BILINEAR))[:, :, ::-1]
            if do_mirror:
                warped = warped[:, ::-1]
            if self._mean_blob is not None:
                # mean indexed at (h+mean_off+pad_h, w+mean_off+pad_w),
                # window_data_layer.cpp:409-413
                moff = (self._mean_blob.shape[1] - cs) // 2
                mh, mw = warped.shape[:2]
                mpatch = self._mean_blob[moff + pad_h:moff + pad_h + mh,
                                         moff + pad_w:moff + pad_w + mw]
                patch = (warped.astype(np.float32) - mpatch) * self.scale
            else:
                mv = (self.mean_values if len(self.mean_values) == 3
                      else self.mean_values * 3)
                patch = (warped.astype(np.float32)
                         - np.asarray(mv, np.float32)) * self.scale
            canvas = np.zeros((cs, cs, 3), np.float32)
            canvas[pad_h:pad_h + warped.shape[0],
                   pad_w:pad_w + warped.shape[1]] = patch
            data.append(np.ascontiguousarray(canvas.transpose(2, 0, 1)))
            labels.append(cls)
        return [np.stack(data), np.asarray(labels, np.float32)]


class HDF5OutputSink:
    """`HDF5Output` layer: collects bottoms, writes datasets on save()."""

    def __init__(self, spec):
        self.path = spec.param("hdf5_output_param").get_str("file_name", "out.h5")
        self.bottoms = list(spec.bottoms)
        self.collected: Dict[str, List[np.ndarray]] = {"data": [], "label": []}

    def append(self, arrays: Sequence[np.ndarray]) -> None:
        for name, arr in zip(("data", "label"), arrays):
            self.collected[name].append(np.asarray(arr))

    def save(self) -> None:
        import h5py

        with h5py.File(self.path, "w") as f:
            for name, chunks in self.collected.items():
                if chunks:
                    f.create_dataset(name, data=np.concatenate(chunks))


class PrefetchedSource(DataLayerSource):
    """3-deep background prefetch ring around a batch producer (reference:
    BasePrefetchingDataLayer / MultiBasePrefetchingDataLayer,
    PREFETCH_COUNT=3, pose_layers.hpp:40). The producer thread starts lazily
    on first use and keeps the accelerator fed while the previous step runs;
    FIFO order preserves the underlying cursor semantics exactly."""

    def __init__(self, src: DataLayerSource, depth: int = 3):
        self.src = src
        self.tops = list(src.tops)
        self.depth = depth
        self._pf = None

    def next_batch(self) -> List[np.ndarray]:
        if self._pf is None:
            from deepcut_tpu_torch.data.pipeline import Prefetcher

            self._pf = Prefetcher(self.src.next_batch, depth=self.depth)
        return self._pf.get()

    def stop(self) -> None:
        """Stop the producer thread (a later batch starts a new one)."""
        if self._pf is not None:
            self._pf.stop()
            self._pf = None

    def close(self) -> None:
        self.stop()
        self.src.close()

    def __getattr__(self, name):  # delegate set_arrays etc.
        if name == "src":  # avoid recursion before __init__ sets it
            raise AttributeError(name)
        return getattr(self.src, name)


# MemoryData is the one reference data layer WITHOUT a prefetch thread
# (arrays arrive synchronously via set_input_arrays).
PREFETCHED_TYPES = {"Data", "ImageData", "WindowData", "HDF5Data", "PoseData"}

DATA_SOURCES = {
    "Data": LMDBDataSource,
    "ImageData": ImageDataSource,
    "MemoryData": MemoryDataSource,
    "HDF5Data": HDF5DataSource,
    "WindowData": WindowDataSource,
    "PoseData": PoseDataSourceAdapter,
}
