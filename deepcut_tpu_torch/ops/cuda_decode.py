"""Fused pose decode: the hand-written CUDA kernel and its wrappers.

The kernel replaces the TPU kernel `deepcut_tpu.ops.pallas_decode`
(`joint_argmax` / `decode_pose_pallas`) and the XLA decode around it on
every `PoseEstimator` path. Its source, `csrc/decode_pose.cu` (design notes
there), has two entries:

- `decode_fused` reads the heads' fused (N, C >= 3J, h, w) map before it is
  sliced, computes the sigmoid of the pose logits itself and takes the
  valid cell rows / columns as Python ints, passed by value: the serving
  path (`PoseEstimator._batched`);
- `decode_pose` reads f32 probability and locref maps, for the paths that
  hold them (`scoremaps`, the tiled HD path, averaged pyramids).

The source is compiled with ``nvcc`` for ``sm_90a`` at the first launch
(`native.build`); importing this module builds nothing. A CPU tensor takes
the plain version (`pose.decode.decode_pose_batch`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import torch

from deepcut_tpu_torch.native import PKG, NativeLib, build
from deepcut_tpu_torch.pose.decode import decode_pose_batch

LIB = NativeLib(PKG / "csrc" / "decode_pose.cu")

launches = 0       # fused-entry launches since the last reset (CPU calls do not count)
prob_launches = 0  # probability-map entry launches, likewise
_lock = threading.Lock()
_lib = None
_caps = None  # the fused entry's (images, joints, staged floats) per launch, read once


def _library() -> ctypes.CDLL:
    global _lib, _caps
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(LIB)[0]))
            fn = lib.decode_pose_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = lib.decode_fused_launch
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 6
                           + [ctypes.c_float] + [ctypes.POINTER(ctypes.c_int)] * 2
                           + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.decode_fused_cluster_size.argtypes = [ctypes.c_int]
            _caps = (lib.decode_fused_max_batch(), lib.decode_fused_max_joints(),
                     lib.decode_fused_stage_floats())
            _lib = lib
    return _lib


def fused_limits() -> dict:
    """The fused entry's capacities, read from the library: images per
    launch, joints, staged floats per row, and the cluster size it launches
    with on the current device."""
    lib = _library()
    return {"max_batch": _caps[0], "max_joints": _caps[1], "stage_floats": _caps[2],
            "cluster": lib.decode_fused_cluster_size(torch.cuda.current_device())}


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
    global launches
    if fused.device.type == "cpu":
        return decode_fused_plain(fused, num_joints, valid_h, valid_w, scale)
    if fused.device.type != "cuda":
        raise ValueError(f"decode_fused: no kernel for device {fused.device}")
    if (fused.dtype != torch.float32 or fused.dim() != 4
            or not fused.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"decode_fused: the map must be 4-D f32 channels_last, got "
                         f"{tuple(fused.shape)} {fused.dtype} strides {fused.stride()}")
    lib = _library()
    max_batch, max_joints, stage_floats = _caps
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
    stream = torch.cuda.current_stream(fused.device).cuda_stream
    err = lib.decode_fused_launch(fused.data_ptr(), out.data_ptr(), sn, sh, n, J, h, w, C,
                                  granule, float(scale), vh, vw, fused.device.index, stream)
    if err != 0:
        raise RuntimeError(f"decode_fused kernel launch failed: cudaError {err}")
    with _lock:
        launches += 1
    return out


def _check(prob: torch.Tensor, loc: torch.Tensor, valid_h: torch.Tensor,
           valid_w: torch.Tensor) -> None:
    if prob.dim() != 4 or loc.dim() != 4:
        raise ValueError(f"decode_pose: prob and loc must be 4-D, got "
                         f"{tuple(prob.shape)} and {tuple(loc.shape)}")
    n, J, h, w = prob.shape
    if tuple(loc.shape) != (n, 2 * J, h, w):
        raise ValueError(f"decode_pose: loc {tuple(loc.shape)} does not match "
                         f"prob {tuple(prob.shape)} (want {(n, 2 * J, h, w)})")
    if n < 1 or J < 1 or h * w < 1 or n > 65535 or h * w >= 2**31:
        raise ValueError(f"decode_pose: unsupported shape {tuple(prob.shape)}")
    for name, t, dtype, shape in (("prob", prob, torch.float32, None),
                                  ("loc", loc, torch.float32, None),
                                  ("valid_h", valid_h, torch.int32, (n,)),
                                  ("valid_w", valid_w, torch.int32, (n,))):
        if t.device != prob.device:
            raise ValueError(f"decode_pose: {name} on {t.device}, prob on {prob.device}")
        if t.dtype != dtype:
            raise TypeError(f"decode_pose: {name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"decode_pose: {name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"decode_pose: {name} must be contiguous")


def decode_pose(prob: torch.Tensor, loc: torch.Tensor, valid_h: torch.Tensor,
                valid_w: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """(N, J, h, w) f32 prob + (N, 2J, h, w) f32 loc + (N,) int32 valid
    rows / columns of each cell grid -> (N, 5, J) f32 pose, x, y and the
    offsets divided by `scale`. See `pose.decode` for the semantics."""
    global prob_launches
    if prob.device.type == "cpu":
        return decode_pose_batch(prob, loc, scale=scale, valid_hw=(valid_h, valid_w))
    if prob.device.type != "cuda":
        raise ValueError(f"decode_pose: no kernel for device {prob.device}")
    _check(prob, loc, valid_h, valid_w)
    n, J, h, w = prob.shape
    fn = _library().decode_pose_launch
    out = torch.empty((n, 5, J), dtype=torch.float32, device=prob.device)
    stream = torch.cuda.current_stream(prob.device).cuda_stream
    err = fn(prob.data_ptr(), loc.data_ptr(), valid_h.data_ptr(), valid_w.data_ptr(),
             out.data_ptr(), n, J, h, w, float(scale), prob.device.index, stream)
    if err != 0:
        raise RuntimeError(f"decode_pose kernel launch failed: cudaError {err}")
    with _lock:
        prob_launches += 1
    return out
