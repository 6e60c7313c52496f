"""Fixtures of the benchmark's own tests (run: python -m pytest portbench/tests -q).

Tests marked ``card`` need a CUDA device and skip without one; the look
for the card happens inside the `card` fixture, never at import.
"""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with python -m pytest portbench/tests -m card")
    return "cuda"


def tiny_copy(dst: Path) -> Path:
    """A copy of the benchmark (BENCHMARK.json and portbench/) whose pose
    configuration is cut to a tiny depth and width and whose mixes are cut
    to a few small items, so that a whole run fits a CPU test."""
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = dst / "portbench"
    edit(pb / "configs" / "deepercut-r152.json",
         depths=[1, 1, 2, 1], stage_widths=[8, 16, 32, 64], stem_channels=8)
    edit(pb / "traffic" / "pose-clip-688.json", item_hw=[96, 96], pool=8, batch=4,
         warmup_calls=1, trace_calls=1)
    edit(pb / "traffic" / "classify-227.json", pool=4, batch=2, warmup_calls=1, trace_calls=1)
    return dst


def edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data, indent=1))


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_copy(tmp_path)
