"""Fused pose decode: the hand-written CUDA kernel and its wrappers.

The kernel replaces the TPU kernel `deepcut_tpu.ops.pallas_decode`
(`joint_argmax` / `decode_pose_pallas`) and the XLA decode around it on
every `PoseEstimator` path. Its source, `csrc/decode_pose.cu` (design notes
there), has two entries:

- `decode_fused` reads the heads' fused (N, C >= 3J, h, w) map before it is
  sliced, computes the sigmoid of the pose logits itself and takes the
  valid cell rows / columns as Python ints, passed by value: the serving
  path (`PoseEstimator._batched`);
- `decode_pose` reads f32 probability and locref maps where they lie (a
  row-cropped or channel-sliced view, any strides but a column stride of
  1) and takes the valid sizes as Python ints, passed by value: the paths
  that hold such maps (`scoremaps`, the tiled HD path, averaged pyramids,
  every frame under a mesh), through `PoseEstimator._decode_whole`.

The source is compiled with ``nvcc`` for ``sm_90a`` at the first launch
(`native.build`); importing this module builds nothing. A CPU tensor takes
the plain version (`pose.decode.decode_pose_batch`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Union

import torch

from deepcut_tpu_torch import native
from deepcut_tpu_torch.native import PKG, NativeLib
from deepcut_tpu_torch.pose.decode import decode_pose_batch


class _Geometry(ctypes.Structure):
    """The kernel's ProbGeometry: a checked (prob, loc) view geometry."""
    _fields_ = ([(f, ctypes.c_longlong) for f in ("pn", "pj", "ph", "ln", "lj", "lh")]
                + [(f, ctypes.c_int) for f in ("n", "J", "h", "w", "granule", "device")])


P, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
LIB = NativeLib(PKG / "csrc" / "decode_pose.cu", entries={
    "decode_pose_launch": [ctypes.POINTER(_Geometry)] + [P] * 4 + [F32, P],
    "decode_fused_launch": ([P] * 2 + [I64] * 2 + [I32] * 6 + [F32]
                            + [ctypes.POINTER(I32)] * 2 + [I32, P]),
    "decode_fused_cluster_size": [I32], "decode_pose_cluster": [], "decode_max_batch": [],
    "decode_fused_max_joints": [], "decode_fused_stage_floats": []})
FUSED = native.Kernel("decode_fused", LIB)
PROB = native.Kernel("decode_pose", LIB, device_arg=False)
# `launches` and `prob_launches`: the fused and probability-map entries'
# live launch counts (`native.counters`)
__getattr__ = native.counters(__name__, launches=FUSED, prob_launches=PROB)
_plans: Dict[tuple, tuple] = {}  # the prob entry's checked launch arguments per geometry


@functools.lru_cache(maxsize=None)
def _capacities() -> tuple:
    """Images per launch, the fused entry's joints and staged floats; read once."""
    lib = native.load(LIB)
    return lib.decode_max_batch(), lib.decode_fused_max_joints(), lib.decode_fused_stage_floats()


def fused_limits() -> dict:
    """The kernel's capacities, read from the library: images per launch,
    the fused entry's joints and staged floats per row, and the cluster
    sizes both entries launch with on the current device."""
    lib = native.load(LIB)
    max_batch, max_joints, stage_floats = _capacities()
    return {"max_batch": max_batch, "max_joints": max_joints, "stage_floats": stage_floats,
            "cluster": lib.decode_fused_cluster_size(torch.cuda.current_device()),
            "prob_cluster": lib.decode_pose_cluster()}


def decode_fused_plain(fused: torch.Tensor, num_joints: int, valid_h: Sequence[int],
                       valid_w: Sequence[int], scale: float = 1.0) -> torch.Tensor:
    """The plain version of `decode_fused`: `decode_pose_batch` over
    ``sigmoid(fused[:, :J])`` and ``fused[:, J:3J]`` in f32."""
    J = num_joints
    vh, vw = (torch.tensor([int(v) for v in valid], dtype=torch.int32) for valid in (valid_h, valid_w))
    return decode_pose_batch(torch.sigmoid(fused[:, :J].float()), fused[:, J:3 * J].float(),
                             scale=scale, valid_hw=(vh, vw))


def decode_fused(fused: torch.Tensor, num_joints: int, valid_h: Sequence[int],
                 valid_w: Sequence[int], scale: float = 1.0) -> torch.Tensor:
    """(N, C >= 3J, h, w) head map (pose logits, then the 2J locref
    channels) + each image's valid cell rows / columns -> (N, 5, J) f32
    pose. On the card the map must be f32 and channels_last-contiguous,
    as the serving heads give it."""
    if not native.on_card(fused, "decode_fused"):
        return decode_fused_plain(fused, num_joints, valid_h, valid_w, scale)
    if (fused.dtype != torch.float32 or fused.dim() != 4
            or not fused.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"decode_fused: the map must be 4-D f32 channels_last, got "
                         f"{tuple(fused.shape)} {fused.dtype} strides {fused.stride()}")
    max_batch, max_joints, stage_floats = _capacities()
    n, C, h, w = fused.shape
    J = int(num_joints)
    if not (1 <= n <= max_batch and 1 <= J <= max_joints and C >= 3 * J and h * w >= 1
            and -(-w * J // 4) * 4 <= stage_floats):
        raise ValueError(f"decode_fused: unsupported shape {tuple(fused.shape)} with J={J}")
    if len(valid_h) != n or len(valid_w) != n:
        raise ValueError(f"decode_fused: {len(valid_h)} / {len(valid_w)} valid sizes for {n} images")
    sn, _, sh, _ = fused.stride()
    # the widest copy (4, 2 or 1 floats) that a cell's logits allow
    granule = next(g for g in (4, 2, 1) if J % g == 0 and C % g == 0 and sn % g == 0
                   and sh % g == 0 and fused.data_ptr() % (4 * g) == 0)
    vh = (ctypes.c_int * n)(*[int(v) for v in valid_h])
    vw = (ctypes.c_int * n)(*[int(v) for v in valid_w])
    out = torch.empty((n, 5, J), dtype=torch.float32, device=fused.device)
    FUSED(fused.device, fused.data_ptr(), out.data_ptr(), sn, sh, n, J, h, w, C, granule,
          float(scale), vh, vw)
    return out


Sizes = Union[Sequence[int], torch.Tensor]


def _sizes(name: str, valid: Sizes, n: int) -> List[int]:
    """Each image's valid rows (or columns) as ints, from a sequence of ints
    or a CPU tensor (a CUDA tensor would have to be read on the host,
    waiting for the card)."""
    if isinstance(valid, torch.Tensor):
        if valid.device.type != "cpu":
            raise ValueError(f"decode_pose: {name} must be ints or a CPU tensor, got a tensor "
                             f"on {valid.device}")
        valid = valid.reshape(-1).tolist()
    out = [int(v) for v in valid]
    if len(out) != n:
        raise ValueError(f"decode_pose: {len(out)} {name} sizes for {n} images")
    return out


def _check(prob: torch.Tensor, loc: torch.Tensor) -> None:
    """Raises on what the kernel does not take; a view it takes is read in
    place (any non-negative strides, a column stride of 1)."""
    if prob.dim() != 4 or loc.dim() != 4:
        raise ValueError(f"decode_pose: prob and loc must be 4-D, got "
                         f"{tuple(prob.shape)} and {tuple(loc.shape)}")
    n, J, h, w = prob.shape
    if tuple(loc.shape) != (n, 2 * J, h, w):
        raise ValueError(f"decode_pose: loc {tuple(loc.shape)} does not match "
                         f"prob {tuple(prob.shape)} (want {(n, 2 * J, h, w)})")
    if n < 1 or not 1 <= J <= 65535 or h * w < 1 or h * w >= 2**31:
        raise ValueError(f"decode_pose: unsupported shape {tuple(prob.shape)}")
    for name, t in (("prob", prob), ("loc", loc)):
        if t.device != prob.device:
            raise ValueError(f"decode_pose: {name} on {t.device}, prob on {prob.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"decode_pose: {name} must be {torch.float32}, got {t.dtype}")
        if w > 1 and t.stride(3) != 1:
            raise ValueError(f"decode_pose: {name} must have a column stride of 1 (rows are "
                             f"read as runs of floats), got strides {t.stride()}")


def _plan(prob: torch.Tensor, loc: torch.Tensor) -> tuple:
    """A (prob, loc) view geometry, checked once: the kernel's geometry
    (with the widest load, 4, 2 or 1 floats, that the view's width and
    strides allow; the launch halves it until the base address is aligned)
    and a pointer to it."""
    _check(prob, loc)
    n, J, h, w = prob.shape
    strides = [s for s, d in zip(prob.stride()[:3], (n, J, h)) if d > 1]
    widest = next(g for g in (4, 2, 1) if w % g == 0 and all(s % g == 0 for s in strides))
    geometry = _Geometry(*prob.stride()[:3], *loc.stride()[:3], n, J, h, w, widest,
                         prob.device.index or 0)
    return geometry, ctypes.pointer(geometry)


def decode_pose(prob: torch.Tensor, loc: torch.Tensor, valid_h: Sizes, valid_w: Sizes,
                scale: float = 1.0) -> torch.Tensor:
    """(N, J, h, w) f32 prob + (N, 2J, h, w) f32 loc + each image's valid
    rows / columns of the cell grid (ints, or CPU tensors) -> (N, 5, J) f32
    pose, x, y and the offsets divided by `scale`. See `pose.decode` for the
    semantics. On the card prob and loc may be views (row-cropped, channel
    sliced, permuted) whose column stride is 1; they are read in place."""
    if prob.device.type not in ("cpu", "cuda"):
        _check(prob, loc)   # what the kernel would not take raises before "no kernel"
    if not native.on_card(prob, "decode_pose"):
        vh, vw = (v if isinstance(v, torch.Tensor) else torch.tensor([int(x) for x in v])
                  for v in (valid_h, valid_w))
        return decode_pose_batch(prob, loc, scale=scale, valid_hw=(vh, vw))
    # checked once per view geometry: a path repeats a few
    key = (prob.shape, prob.stride(), loc.shape, loc.stride(), prob.dtype, loc.dtype,
           prob.device, loc.device)
    plan = _plans.get(key)
    if plan is None:
        if len(_plans) >= 4096:   # frames of ever new sizes: start afresh
            _plans.clear()
        plan = _plans.setdefault(key, _plan(prob, loc))
    geometry, ref = plan
    n = geometry.n
    vh, vw = _sizes("valid_h", valid_h, n), _sizes("valid_w", valid_w, n)
    out = torch.empty((n, 5, geometry.J), dtype=torch.float32, device=prob.device)
    PROB(prob.device, ref, prob.data_ptr(), loc.data_ptr(), out.data_ptr(),
         (ctypes.c_int * (2 * n))(*vh, *vw), float(scale),
         count=-(-n // _capacities()[0]),   # one launch per kMaxBatch images
         geometry=lambda: ((native.view_geometry(prob), native.view_geometry(loc), tuple(vh),
                            tuple(vw)), (float(scale),)))
    return out
