"""Build the port's native libraries ahead of their first use:

    python -m deepcut_tpu_torch.runtime.build

Counterpart of `deepcut_tpu.runtime.build`. The port otherwise builds each
library lazily, at its first call (`deepcut_tpu_torch.native`), so a
service would pay g++ and nvcc on its first request. This command builds
all five into ``build/deepcut_tpu_torch/`` at once, one compiler process
per source, all started together: the C++ target rasterizer (g++,
`runtime.LIB`) and the four CUDA sources for ``sm_90a`` (the decode
`ops.cuda_decode.LIB`, the serving conv's epilogue `ops.conv_epilogue.LIB`,
the int8 conv's pieces `ops.int8_conv.LIB` and the trunk's 3x3 convs
`ops.conv3x3.LIB`). A library already built
from the same source and flags is kept. It prints each library's path and
its compiler log, and exits 0 only when each one loads. Without nvcc it
fails and says so; it never skips a library.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List

from deepcut_tpu_torch import native


def libraries(cuda: bool = True) -> List[native.NativeLib]:
    """The host rasterizer and, with `cuda`, the four CUDA libraries."""
    from deepcut_tpu_torch import runtime

    libs = [runtime.LIB]
    if cuda:
        from deepcut_tpu_torch.ops import conv3x3, conv_epilogue, cuda_decode, int8_conv

        libs += [cuda_decode.LIB, conv_epilogue.LIB, int8_conv.LIB, conv3x3.LIB]
    return libs


def build(cuda: bool = True) -> List[Path]:
    """Build `libraries(cuda)` (the ones not built yet, in parallel), load
    each with its entry points (`native.load`) and print its path and
    compiler log; returns the paths. Raises where a compiler is missing or
    fails, or a library or an entry point does not load."""
    libs = libraries(cuda)
    paths = native.build(*libs)
    for lib, path in zip(libs, paths):
        native.load(lib)
        log = path.with_suffix(".log")
        print(f"built {path}, loads; its compiler log {log}:", flush=True)
        print((log.read_text().strip() if log.is_file() else "") or "(empty)", flush=True)
    return paths


if __name__ == "__main__":
    try:
        build()
    except (RuntimeError, OSError) as err:   # a compiler missing or failing, a load failing
        print(f"deepcut_tpu_torch.runtime.build: {err}", file=sys.stderr)
        sys.exit(1)
