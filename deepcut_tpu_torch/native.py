"""Build the port's native libraries: plain C interfaces loaded with ctypes.

Each library is one source file compiled at its first use into
``build/deepcut_tpu_torch/`` beside the package (git-ignored), named by a
hash of the source and the flags, so an edited source or a new flag builds
anew and a built one is never rebuilt. The compiler's output is kept beside
the library as ``.log`` (for nvcc: registers, shared memory and spills from
``-Xptxas -v``). `build` starts one compiler per missing library, all at
once, and waits for them together. Importing this module builds nothing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, List, Tuple

PKG = Path(__file__).resolve().parent
BUILD_DIR = PKG.parent / "build" / "deepcut_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, then torch's CUDA_HOME, then PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return found


@dataclasses.dataclass(frozen=True)
class NativeLib:
    """One source compiled into ``lib<stem>-<hash>.so``."""

    source: Path
    flags: Tuple[str, ...] = NVCC_FLAGS
    compiler: Callable[[], str] = nvcc_path

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes() + " ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{digest.hexdigest()[:16]}.so"


def build(*libs: NativeLib) -> List[Path]:
    """Compile every library not built yet, all compilers started together;
    returns the libraries' paths. Raises with the compiler's output if one
    fails. The rename into place is atomic, so another process never loads
    a partial file."""
    jobs = []
    for lib in libs:
        out = lib.path()
        if out.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [lib.compiler(), *lib.flags, "-o", str(tmp), str(lib.source)]
        jobs.append((lib, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for lib, out, tmp, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{lib.compiler()} failed on {lib.source} "
                          f"(exit {proc.returncode}):\n{text}")
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [lib.path() for lib in libs]
