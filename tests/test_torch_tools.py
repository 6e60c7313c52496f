"""The port's own copies of the dataset and log tools
(`deepcut_tpu_torch.tools.{datasets,parse_log,log_tools,draw}`) against
the JAX package's, on the same seeded inputs. Tolerance: none; files are
compared byte for byte (the plot pixel for pixel), rows and text for
equality.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from deepcut_tpu.tools import datasets as j_ds
from deepcut_tpu.tools import draw as j_draw
from deepcut_tpu.tools import log_tools as j_lt
from deepcut_tpu.tools import parse_log as j_pl
from deepcut_tpu_torch.tools import datasets as t_ds
from deepcut_tpu_torch.tools import draw as t_draw
from deepcut_tpu_torch.tools import log_tools as t_lt
from deepcut_tpu_torch.tools import parse_log as t_pl
from deepcut_tpu_torch.proto import text_format as t_text
from deepcut_tpu.proto import text_format as j_text


def _files(path):
    if os.path.isfile(path):
        return {"": open(path, "rb").read()}
    return {n: open(os.path.join(path, n), "rb").read() for n in sorted(os.listdir(path))}


@pytest.fixture
def image_list(tmp_path):
    rng = np.random.RandomState(0)
    lines = []
    for i in range(6):
        shape = (10, 12, 3) if i % 2 else (14, 9, 3)
        p = tmp_path / f"im {i}.png"   # a path with a space: split on the last whitespace
        Image.fromarray(rng.randint(0, 255, shape, np.uint8)).save(p)
        lines.append(f"{p.name} {i % 3}")
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    return tmp_path


@pytest.mark.parametrize("flags", [["--resize", "10", "12"], ["--resize", "8", "8", "--shuffle"],
                                   ["--encoded"], ["--encoded", "--resize", "10", "12"],
                                   ["--backend", "leveldb", "--resize", "10", "12"]],
                         ids=["lmdb", "shuffle", "encoded", "encoded-resized", "leveldb"])
def test_convert_imageset_and_mean_byte_equal(image_list, flags, capsys):
    root = str(image_list) + "/"
    for who, main in (("t", t_ds.main), ("j", j_ds.main)):
        assert main(["convert_imageset", str(image_list / "list.txt"), str(image_list / f"{who}_db"),
                     "--root", root] + flags) == 0
    assert _files(str(image_list / "t_db")) == _files(str(image_list / "j_db"))
    if "--encoded" in flags and "--resize" not in flags:
        return  # frames of two sizes: the mean needs one size
    for who, main in (("t", t_ds.main), ("j", j_ds.main)):
        assert main(["compute_image_mean", str(image_list / f"{who}_db"),
                     str(image_list / f"{who}.binaryproto")]) == 0
    assert (image_list / "t.binaryproto").read_bytes() == (image_list / "j.binaryproto").read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[-2].replace("t.binaryproto", "j.binaryproto").replace("t_db", "j_db") == out[-1]


def test_resize_and_crop_byte_equal(tmp_path):
    rng = np.random.RandomState(1)
    src = tmp_path / "in"
    (src / "n01").mkdir(parents=True)
    for rel, (h, w) in zip(["n01/a.jpg", "n01/b.png", "c.png"], [(30, 17), (13, 40), (8, 8)]):
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(src / rel)
    for who, main in (("t", t_ds.main), ("j", j_ds.main)):
        assert main(["resize_and_crop", str(src), str(tmp_path / who), "--side", "8",
                     "--workers", "2"]) == 0
    for rel in ("n01/a.jpg", "n01/b.png", "c.png"):
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()
    assert t_ds.square_crop_geometry(30, 17, 8) == j_ds.square_crop_geometry(30, 17, 8)


LOG = """I1017 06:00:00.000000  1 solver.cpp] Solving with SGD, max_iter = 40
I1017 06:00:01.500000  1 solver.cpp] Iteration 0, loss = 2.5, lr = 0.01
I1017 06:00:02.250000  1 solver.cpp] Iteration 10, Testing net (#0)
    Test net output #0: accuracy = 0.25
    Test net output #1: loss = 2.1 (* 1 = 2.1 loss)
I1017 06:00:03.000000  1 solver.cpp] Iteration 10, loss = 1.5 (part_loss = 1.2, locref_loss = 0.3), lr = 0.01
I1017 06:00:04.125000  1 solver.cpp] Iteration 20, Testing net (#0)
    Test net output #0: accuracy = 0.5
    Test net output #1: loss = 1.4 (* 1 = 1.4 loss)
I1017 06:00:05.000000  1 solver.cpp] Iteration 20, loss = 1.2, lr = 0.001
garbage line
"""


def test_parse_log_same_rows_and_csv(tmp_path, capsys):
    log = tmp_path / "train.log"
    log.write_text(LOG)
    rows = t_pl.parse_log(str(log))
    assert rows == j_pl.parse_log(str(log))
    assert [r["NumIters"] for r in rows] == [0.0, 10.0, 20.0] and rows[1]["part_loss"] == 1.2
    for who, mod in (("t", t_pl), ("j", j_pl)):
        (tmp_path / who).mkdir()
        assert mod.main([str(log), str(tmp_path / who)]) == 0
    assert ((tmp_path / "t" / "train.log.train").read_bytes()
            == (tmp_path / "j" / "train.log.train").read_bytes())
    # the port's test rows (the reference tool's .test file)
    assert t_pl.parse_test_log(str(log)) == [
        {"NumIters": 10.0, "accuracy": 0.25, "loss": 2.1},
        {"NumIters": 20.0, "accuracy": 0.5, "loss": 1.4}]


def test_log_tools_same_output(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    log = tmp_path / "train.log"
    log.write_text(LOG)
    net = os.path.join(os.path.dirname(__file__), "..", "examples", "imagenet",
                       "caffenet_train_val.prototxt")
    texts = []
    for who, mod in (("t", t_lt), ("j", j_lt)):
        buf = io.StringIO()
        assert mod.summarize(net, out=buf) == 0
        texts.append(buf.getvalue())
        assert mod.main(["extract_seconds", str(log), str(tmp_path / f"{who}.txt")]) == 0
        assert mod.main(["plot", str(log), str(tmp_path / f"{who}.png"), "--x", "seconds"]) == 0
    assert texts[0] == texts[1] and "conv1" in texts[0]
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert (tmp_path / "t.txt").read_text().split()[:2] == ["1.500000", "2.250000"]
    a, b = (np.asarray(Image.open(tmp_path / f"{w}.png")) for w in "tj")
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rankdir", ["TB", "LR"])
def test_draw_same_dot(tmp_path, rankdir):
    net = os.path.join(os.path.dirname(__file__), "..", "examples", "imagenet",
                       "caffenet_train_val.prototxt")
    got = t_draw.net_to_dot(t_text.parse_file(net), rankdir=rankdir, show_blobs=True)
    assert got == j_draw.net_to_dot(j_text.parse_file(net), rankdir=rankdir, show_blobs=True)
    assert got.startswith('digraph "CaffeNet"')
    for who, mod in (("t", t_draw), ("j", j_draw)):
        assert mod.main([net, str(tmp_path / f"{who}.dot")]) in (0, None)
    assert (tmp_path / "t.dot").read_text() == (tmp_path / "j.dot").read_text()
