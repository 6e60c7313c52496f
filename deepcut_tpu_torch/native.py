"""The port's native libraries: built, loaded with ctypes, launched, counted.

Each library is one source file compiled at its first use into
``build/deepcut_tpu_torch/`` beside the package (git-ignored), named by a
hash of the source and the flags, so an edited source or a new flag builds
anew and a built one is never rebuilt. The compiler's output is kept beside
the library as ``.log`` (for nvcc: registers, shared memory and spills from
``-Xptxas -v``). `build` starts one compiler per missing library, all at
once, and waits for them together. Importing this module builds nothing.

It is the one seam under every hand-written kernel: `load` binds a
library's entry table once, a `Kernel` launches an entry and counts it per
kernel name from any thread, `tally` keeps a graph capture's launches
apart, and `record_geometries` keeps each launch geometry for a replay
against the plain versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

if TYPE_CHECKING:   # the host libraries' users (the input pipeline's workers) need no torch
    import torch

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
    """One source compiled into ``lib<stem>-<hash>.so``; `entries`: each
    entry point's argument types, bound by `load`."""

    source: Path
    flags: Tuple[str, ...] = NVCC_FLAGS
    compiler: Callable[[], str] = nvcc_path
    entries: Mapping[str, Sequence] = dataclasses.field(default_factory=dict, compare=False)

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


_load_lock, _count_lock = threading.Lock(), threading.Lock()
_loaded: Dict[NativeLib, Optional[ctypes.CDLL]] = {}
_counts: Dict[str, int] = {}   # launches per kernel name since the last reset (not the CPU's)
_thread = threading.local()    # .tally: where this thread's launches go instead (`tally`)
# while a dict (`record_geometries`): per kernel name, each distinct launch
# geometry -> the first call's values
geometries: Optional[Dict[str, Dict[tuple, tuple]]] = None


def load(lib: NativeLib, missing_ok: bool = False) -> Optional[ctypes.CDLL]:
    """`lib`, built first if need be, loaded once with its `entries` bound
    (each returns a C int); None where `missing_ok` and its compiler is not
    on PATH. Lock-free after the first load."""
    if lib in _loaded:
        return _loaded[lib]
    with _load_lock:
        if lib not in _loaded:
            cdll = None
            if not (missing_ok and shutil.which(lib.compiler()) is None):
                cdll = ctypes.CDLL(str(build(lib)[0]))
                for name, argtypes in lib.entries.items():
                    fn = getattr(cdll, name)
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _loaded[lib] = cdll
    return _loaded[lib]


def _count(name: str, n: int, geometry: Optional[Callable[[], tuple]] = None) -> None:
    tally = getattr(_thread, "tally", None)
    with _count_lock:
        into = _counts if tally is None else tally
        into[name] = into.get(name, 0) + n
        if geometry is not None and geometries is not None:
            key, values = geometry()
            geometries.setdefault(name, {}).setdefault(key, values)


class Kernel:
    """`lib`'s entry ``<name>_launch``, which launches a CUDA kernel on the
    current stream: called with the caller's arguments, then (with
    `device_arg`) the device index, then the raw stream. A non-zero
    cudaError raises, naming `name`; else `count` launches are counted
    under it, and `geometry()` -> (key, values) is recorded while
    `record_geometries` is on."""

    def __init__(self, name: str, lib: NativeLib, device_arg: bool = True):
        self.name, self.lib, self.device_arg, self._fn = name, lib, device_arg, None

    def __call__(self, device: torch.device, *args, count: int = 1,
                 geometry: Optional[Callable[[], tuple]] = None) -> None:
        import torch

        if self._fn is None:
            self._fn = getattr(load(self.lib), f"{self.name}_launch")
        tail = (device.index,) if self.device_arg else ()
        err = self._fn(*args, *tail, torch._C._cuda_getCurrentRawStream(device.index))
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: cudaError {err}")
        _count(self.name, count, geometry)


def on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); raises on any other device."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return t.device.type == "cuda"


def counts() -> Dict[str, int]:
    with _count_lock:
        return dict(_counts)


def reset_counts() -> None:
    with _count_lock:
        _counts.clear()


def counters(module: str, **kernels: Kernel) -> Callable[[str], int]:
    """A module's ``__getattr__``: each of `kernels`' names reads that
    kernel's live count."""
    def __getattr__(attr: str) -> int:
        if attr not in kernels:
            raise AttributeError(f"module {module!r} has no attribute {attr!r}")
        return _counts.get(kernels[attr].name, 0)
    return __getattr__


@contextlib.contextmanager
def tally() -> Iterator[Dict[str, int]]:
    """The calling thread's launches in the block go to the dict it yields,
    not to the live counts (a graph's capture records launches without
    running them); other threads' count as before."""
    outer, _thread.tally = getattr(_thread, "tally", None), {}
    try:
        yield _thread.tally
    finally:
        _thread.tally = outer


def add_counts(launches: Mapping[str, int]) -> None:
    """Count `launches` per kernel name: those a graph's replay runs."""
    for name, n in launches.items():
        _count(name, n)


def record_geometries(on: bool = True) -> Optional[Dict[str, Dict[tuple, tuple]]]:
    """Start (afresh) or stop recording `geometries`; returns the record
    until now."""
    global geometries
    with _count_lock:
        recorded, geometries = geometries, ({} if on else None)
    return recorded


def view_geometry(t: Optional[torch.Tensor]):
    """A tensor view's (dtype, shape, strides, storage offset) or None."""
    if t is None:
        return None
    return (str(t.dtype), tuple(t.shape), tuple(t.stride()), t.storage_offset())
