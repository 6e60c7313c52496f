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
from pathlib import Path
from typing import Optional

import numpy as np
from numpy.ctypeslib import ndpointer

from deepcut_tpu_torch import native

f32, i32, i64, u8 = (ndpointer(t, flags="C_CONTIGUOUS")
                     for t in (np.float32, np.int32, np.int64, np.uint8))
c, cf = ctypes.c_int, ctypes.c_float
LIB = native.NativeLib(Path(__file__).resolve().parent / "rasterizer.cpp",
                       ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"),
                       lambda: "g++", entries={"dc_rasterize": [
                           i32, f32, i32, c,          # entries
                           i64, c, c, c,              # joint_index, num_people, J, skip_class
                           c, c, c, c,                # th, tw, sh, sw
                           cf, cf, c, cf,             # scale, fg_threshold, soft, sigma
                           c, c, c,                   # multi_label, no_bg, use_fg_fraction
                           c, c,                      # locref, allreg
                           i32, f32, f32, c,          # edges, means, stds, E
                           f32, f32, f32, f32, f32,   # labels, loc_t, loc_w, next_t, next_w
                           u8, f32,                   # sample_mask, min_distance
                       ]})


def load_library() -> Optional[ctypes.CDLL]:
    """The rasterizer, built first if need be; None where g++ is missing."""
    return native.load(LIB, missing_ok=True)


def available() -> bool:
    return load_library() is not None
