"""The port's example notebooks (`deepcut_tpu_torch/examples/**.ipynb`):
one for each of the JAX package's under `examples/`, at the same relative
path; each is valid nbformat 4 with code cells that compile, imports
neither `jax` nor `deepcut_tpu`, and picks its device in one line of its
first code cell (the card). The detection, net-surgery and siamese
walkthroughs execute on the CPU here, with that line set to the CPU, from
the repository's root as their readers run them.
"""

import json
import re
from pathlib import Path

import nbformat
import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "deepcut_tpu_torch" / "examples"
DEVICE_LINE = 'DEVICE = "cuda"  # the card; "cpu" runs this notebook without one'
NOTEBOOKS = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.ipynb"))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|deepcut_tpu)(\.|\s|$)", re.MULTILINE)


def _code(rel):
    nb = json.loads((PORT / rel).read_text())
    return nb, "\n\n".join("".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code")


def test_every_jax_notebook_has_a_port():
    jax_side = sorted(str(p.relative_to(REPO / "examples"))
                      for p in (REPO / "examples").rglob("*.ipynb"))
    assert len(jax_side) == 7 and NOTEBOOKS == jax_side


@pytest.mark.parametrize("rel", NOTEBOOKS)
def test_notebook_is_valid_and_free_of_jax(rel):
    nb, src = _code(rel)
    assert nb["nbformat"] == 4
    nbformat.validate(nbformat.reads(json.dumps(nb), as_version=4))
    assert {c["cell_type"] for c in nb["cells"]} == {"markdown", "code"}
    compile(src, rel, "exec")
    assert not FORBIDDEN.search(src), FORBIDDEN.search(src)
    assert "deepcut_tpu_torch" in src
    first = next(c for c in nb["cells"] if c["cell_type"] == "code")
    assert DEVICE_LINE in "".join(first["source"]) and src.count(DEVICE_LINE) == 1


def test_the_import_check_catches_jax():
    for line in ("import jax", "from jax import numpy", "import deepcut_tpu.compat as caffe",
                 "  from deepcut_tpu import io", "from deepcut_tpu.solver import x"):
        assert FORBIDDEN.search(line), line
    for line in ("import deepcut_tpu_torch.compat as caffe", "from deepcut_tpu_torch import io",
                 "# import jax"):
        assert not FORBIDDEN.search(line), line


@pytest.mark.parametrize("rel", ["detection.ipynb", "net_surgery.ipynb",
                                 "siamese/mnist_siamese.ipynb"])
def test_notebook_executes_on_the_cpu(rel, monkeypatch, capsys):
    import matplotlib
    matplotlib.use("Agg")
    _, src = _code(rel)
    monkeypatch.chdir(REPO)
    exec(compile(src.replace(DEVICE_LINE, 'DEVICE = "cpu"'), rel, "exec"), {"__name__": "__nb__"})
    out = capsys.readouterr().out
    expect = {"detection.ipynb": "-> class", "net_surgery.ipynb": "channel 1 unchanged: True",
              "siamese/mnist_siamese.ipynb": "(256, 2)"}[rel]
    assert expect in out, out
    if rel == "net_surgery.ipynb":
        assert "IP vs conv head at the training size: True" in out
        assert "score map shape on 96x96 input: (1, 4, 12, 12)" in out


def test_pyproject_ships_the_port_sources_and_notebooks():
    """The installed port carries what it builds at first use and the
    notebooks, and `deepcut-tpu-torch` names the port's CLI."""
    import importlib
    import tomllib

    project = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = project["tool"]["setuptools"]["package-data"]["deepcut_tpu_torch"]
    shipped = {p.relative_to(REPO / "deepcut_tpu_torch") for g in globs
               for p in (REPO / "deepcut_tpu_torch").glob(g)}
    for need in ("csrc/decode_pose.cu", "runtime/rasterizer.cpp", "matlab/caffe_.cpp",
                 "examples/detection.ipynb", "examples/siamese/mnist_siamese.ipynb"):
        assert Path(need) in shipped, need
    assert {str(p) for p in shipped if p.suffix == ".ipynb"} == {f"examples/{n}" for n in NOTEBOOKS}
    module, attr = project["project"]["scripts"]["deepcut-tpu-torch"].split(":")
    assert module == "deepcut_tpu_torch.tools.cli" and callable(
        getattr(importlib.import_module(module), attr))

