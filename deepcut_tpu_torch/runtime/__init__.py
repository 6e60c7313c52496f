"""The C++ target rasterizer of the input pipeline, loaded with ctypes.

The port's own copy of `deepcut_tpu.runtime`: the same `rasterizer.cpp`,
built with g++ at its first use into ``build/deepcut_tpu_torch/`` (see
`deepcut_tpu_torch.native`) instead of beside the source, or ahead of it
by ``python -m deepcut_tpu_torch.runtime.build``. It is a host
path: `pose.targets.rasterize_native` calls it, and where no g++ is found
it takes the numpy implementation, which stays the semantic oracle.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import Optional

from deepcut_tpu_torch import native

LIB = native.NativeLib(Path(__file__).resolve().parent / "rasterizer.cpp",
                ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"),
                lambda: "g++")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_lock = threading.Lock()


def load_library() -> Optional[ctypes.CDLL]:
    """The rasterizer, built first if need be; None where g++ is missing."""
    global _LIB, _TRIED
    with _lock:
        if _TRIED:
            return _LIB
        if shutil.which("g++") is None:
            _TRIED = True
            return None
        lib = ctypes.CDLL(str(native.build(LIB)[0]))
        import numpy as np
        from numpy.ctypeslib import ndpointer

        f32 = ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32 = ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64 = ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8 = ndpointer(np.uint8, flags="C_CONTIGUOUS")
        c = ctypes.c_int
        cf = ctypes.c_float
        lib.dc_rasterize.restype = ctypes.c_int
        lib.dc_rasterize.argtypes = [
            i32, f32, i32, c,          # entries
            i64, c, c, c,              # joint_index, num_people, J, skip_class
            c, c, c, c,                # th, tw, sh, sw
            cf, cf, c, cf,             # scale, fg_threshold, soft, sigma
            c, c, c,                   # multi_label, no_bg, use_fg_fraction
            c, c,                      # locref, allreg
            i32, f32, f32, c,          # edges, means, stds, E
            f32, f32, f32, f32, f32,   # labels, loc_t, loc_w, next_t, next_w
            u8, f32,                   # sample_mask, min_distance
        ]
        _LIB, _TRIED = lib, True
        return _LIB


def available() -> bool:
    return load_library() is not None
