"""Build the port's matcaffe MEX gateway (`caffe_.cpp` beside this file).

Two targets, both under ``build/deepcut_tpu_torch/`` (git-ignored), never
into the repository's ``matlab/`` folder:

* The test rig (no MATLAB), the default::

      python -m deepcut_tpu_torch.matlab.build

  compiles ``caffe_.cpp`` with ``g++`` against the repository's mex API
  stub (``matlab/mex_stub/``, read, not edited) and libpython into
  ``build/deepcut_tpu_torch/caffe_test-<hash>.so``, which
  tests/test_torch_matlab_mex.py drives through ctypes with the same mx*
  calls MATLAB makes.

* The MATLAB package::

      python -m deepcut_tpu_torch.matlab.build --matlab

  assembles ``build/deepcut_tpu_torch/matlab/+caffe/`` from the
  repository's matcaffe ``.m`` classes (``matlab/+caffe``, unchanged) and
  this ``caffe_.cpp`` under ``private/``, then compiles the MEX there with
  MATLAB's ``mex`` when it is on PATH, else prints the line to run inside
  MATLAB. Then, in MATLAB::

      addpath('<repo>/build/deepcut_tpu_torch/matlab')
      caffe.set_mode_gpu(); net = caffe.Net('deploy.prototxt', 'test');

  The MEX embeds CPython: ``deepcut_tpu_torch`` must be importable (set
  PYTHONPATH to the repository before starting MATLAB).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
BUILD_DIR = REPO / "build" / "deepcut_tpu_torch"
SOURCE = HERE / "caffe_.cpp"
STUB_DIR = REPO / "matlab" / "mex_stub"
MATCAFFE_M = REPO / "matlab" / "+caffe"


def _python_link_flags() -> List[str]:
    return [f"-L{sysconfig.get_config_var('LIBDIR') or ''}",
            f"-lpython{sysconfig.get_python_version()}"]


def build_test_so(verbose: bool = False) -> Path:
    """The test rig's shared object (built once per source and flags)."""
    stub = STUB_DIR / "mex_stub.cpp"
    flags = ["-O2", "-shared", "-fPIC", "-std=c++17", f"-I{STUB_DIR}",
             f"-I{sysconfig.get_path('include')}"]
    digest = hashlib.sha256(SOURCE.read_bytes() + stub.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"caffe_test-{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    # the libraries after the sources, as the linker resolves left to right
    cmd = ["g++", *flags, "-o", str(tmp), str(SOURCE), str(stub), *_python_link_flags()]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    os.replace(tmp, out)
    return out


def assemble_matlab_package(out_dir: Path = BUILD_DIR / "matlab") -> Path:
    """``out_dir/+caffe``: the matcaffe classes with the port's MEX source
    under ``private/``; the MEX compiled there when MATLAB's ``mex`` is on
    PATH. Returns the directory to ``addpath``."""
    pkg = out_dir / "+caffe"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(MATCAFFE_M, pkg, ignore=shutil.ignore_patterns(
        "caffe_.cpp", "caffe_test.so", "*.mex*"))
    (pkg / "private").mkdir(exist_ok=True)
    shutil.copy2(SOURCE, pkg / "private" / "caffe_.cpp")
    cmd = ["mex", "-outdir", str(pkg / "private"), str(pkg / "private" / "caffe_.cpp"),
           f"-I{sysconfig.get_path('include')}", *_python_link_flags()]
    if shutil.which("mex"):
        subprocess.run(cmd, check=True)
    else:
        print("MATLAB's mex is not on PATH; inside MATLAB run:\n  " + " ".join(cmd))
    return out_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matlab", action="store_true",
                    help="assemble the +caffe package for MATLAB instead of the test rig")
    args = ap.parse_args(argv)
    if args.matlab:
        print(f"addpath('{assemble_matlab_package()}')")
    else:
        print(f"built {build_test_so(verbose=True)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
