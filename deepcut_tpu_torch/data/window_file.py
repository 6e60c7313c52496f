"""Window-file and joint-stats-file parsers.

The port's own copy of `deepcut_tpu.data.window_file` (jax-free; held against the original
by tests/test_torch_data.py and tests/test_torch_surface_parity.py).

Window file format (reference: pose_data_layer.cpp:146-207):

    # <image_index>
    [multi <num_persons>] <img_path>
    <channels> <height> <width>
    per person: <num_joints> then <class> <x> <y> per joint

Joint-pair stats file (reference: util/SimpleMatrix.cpp:9-37): repeated
records of `# <name>` / `<rows> <cols>` / row-major values — three matrices:
edges (182x2, 1-based class pairs), means (182x2), std_devs (182x2).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Person:
    classes: np.ndarray  # (K,) int, 1-based joint classes (15 = "skip" marker)
    xy: np.ndarray       # (K, 2) float, original-image coordinates


@dataclasses.dataclass
class ImageRecord:
    path: str
    channels: int
    height: int
    width: int
    people: List[Person]
    multi: bool = False


def parse_window_file(path: str, root_folder: str = "") -> List[ImageRecord]:
    with open(path) as f:
        toks = f.read().split()
    records: List[ImageRecord] = []
    pos = 0

    def nxt() -> str:
        nonlocal pos
        t = toks[pos]
        pos += 1
        return t

    while pos < len(toks):
        hashtag = nxt()
        assert hashtag == "#", f"expected '#', got {hashtag!r}"
        nxt()  # image_index (unused, like the reference)
        first = nxt()
        multi = False
        num_persons = 1
        if first == "multi":
            multi = True
            num_persons = int(nxt())
            img_path = nxt()
        else:
            img_path = first
        channels, height, width = int(nxt()), int(nxt()), int(nxt())
        people = []
        for _ in range(num_persons):
            k = int(nxt())
            classes = np.zeros((k,), np.int32)
            xy = np.zeros((k, 2), np.float32)
            for i in range(k):
                classes[i] = int(nxt())
                xy[i, 0] = float(nxt())
                xy[i, 1] = float(nxt())
            people.append(Person(classes, xy))
        records.append(ImageRecord(root_folder + img_path, channels, height, width, people, multi))
    return records


def write_window_file(path: str, records: Sequence[ImageRecord]) -> None:
    """Inverse of parse_window_file (for tests / dataset tooling)."""
    lines = []
    for idx, r in enumerate(records):
        lines.append(f"# {idx}")
        if r.multi:
            lines.append(f"multi {len(r.people)}")
        lines.append(r.path)
        lines.append(f"{r.channels} {r.height} {r.width}")
        for p in r.people:
            lines.append(str(len(p.classes)))
            for c, (x, y) in zip(p.classes, p.xy):
                lines.append(f"{int(c)} {float(x)} {float(y)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@dataclasses.dataclass
class JointStats:
    edges: np.ndarray     # (E, 2) int, 1-based (cls, next_cls)
    means: np.ndarray     # (E, 2) float
    std_devs: np.ndarray  # (E, 2) float


def parse_stats_file(path: str) -> JointStats:
    mats = []
    with open(path) as f:
        toks = f.read().split()
    pos = 0
    while pos < len(toks):
        assert toks[pos] == "#", f"expected '#', got {toks[pos]!r}"
        pos += 2  # '#', name
        rows, cols = int(toks[pos]), int(toks[pos + 1])
        pos += 2
        vals = np.asarray([float(t) for t in toks[pos:pos + rows * cols]], np.float32)
        pos += rows * cols
        mats.append(vals.reshape(rows, cols))
    assert len(mats) >= 3, "stats file must contain edges/means/std_devs"
    return JointStats(mats[0].astype(np.int32), mats[1], mats[2])


def default_stats(num_joints: int = 14) -> JointStats:
    """All directed joint pairs (J*(J-1) = 182 edges for 14 joints), unit
    normalisation — for tests and training without a stats file."""
    edges = []
    for a in range(1, num_joints + 1):
        for b in range(1, num_joints + 1):
            if a != b:
                edges.append((a, b))
    e = np.asarray(edges, np.int32)
    return JointStats(e, np.zeros((len(e), 2), np.float32), np.ones((len(e), 2), np.float32))
