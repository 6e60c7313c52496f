"""Fused pose decode: the hand-written CUDA kernel and its wrapper.

`decode_pose` replaces the TPU kernel `deepcut_tpu.ops.pallas_decode`
(`joint_argmax` / `decode_pose_pallas`) and the XLA decode around it on
every `PoseEstimator` path. The kernel source is `csrc/decode_pose.cu`
(design notes there). It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at its first launch, into
``build/deepcut_tpu_torch/`` beside the package, named by a hash of the
source and flags, and loaded with ctypes. Importing this module builds
nothing.

A CPU tensor takes the plain version (`pose.decode.decode_pose_batch`); a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from deepcut_tpu_torch.pose.decode import decode_pose_batch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "decode_pose.cu"
BUILD_DIR = _PKG.parent / "build" / "deepcut_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = 0  # kernel launches since the last reset (CPU calls do not count)
_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, then torch's CUDA_HOME, then PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build csrc/decode_pose.cu")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdecode_pose-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel unless this source and these flags were built
    already; returns the library. The compiler's report (registers, shared
    memory, spills from ``-Xptxas -v``) is kept beside it as ``.log``."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: another process never loads a partial file
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.decode_pose_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


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
    global launches
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
        launches += 1
    return out
