"""The harness finds every configuration, mix, cell and metric by name,
BENCHMARK.json keeps the contract's shape, and adding a cell, a
configuration, a mix and a metric needs new files and entries only."""

import hashlib
import json
import re
from pathlib import Path

import pytest

from portbench.harness import Cell, load_module, main

from .conftest import REPO, edit

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_name_finds_its_files():
    b = bench()
    pb = REPO / "portbench"
    for w in b["workloads"]:
        cell = Cell(w["name"], REPO)
        entry = cell.module("entries", cell.mix["entry"])
        assert all(hasattr(entry, f) for f in ("System", "served", "compare", "from_reference"))
        ref = cell.module("reference", cell.config["name"])
        assert hasattr(ref, "make_weights") and hasattr(ref, "serve")
        assert "flops_per_item" in cell.module("work", cell.config["name"]).counts(cell.cfg, cell.mix)
        assert {"deadline_s", "limits"} <= set(cell.spec)
        for m in cell.metrics(False) + cell.metrics(True):
            assert hasattr(cell.module("metrics", m["name"]), "read")
        assert cell.metrics(False) and cell.metrics(True)
    for m in b["end_to_end"] + b["per_layer"]:
        assert (pb / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert len(json.dumps(b)) < 64 * 1024


def digest(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_adding_a_cell_needs_no_edit(tiny_root, capsys):
    """A new configuration (a copy of the tiny ResNet under a new name, its
    reference and work counts as new files), a new mix, a new cell and a
    new per-layer metric: files and entries only. The run on the CPU
    reports the new metric, and no file that was there changed."""
    pb = tiny_root / "portbench"
    before = digest(tiny_root)
    cfg = json.loads((pb / "configs" / "deepercut-r152.json").read_text())
    cfg["name"] = "deepercut-tiny"
    (pb / "configs" / "deepercut-tiny.json").write_text(json.dumps(cfg))
    for kind in ("reference", "work"):
        (pb / kind / "deepercut-tiny.py").write_text((pb / kind / "deepercut-r152.py").read_text())
    mix = json.loads((pb / "traffic" / "pose-clip-688.json").read_text())
    mix.update(item_hw=[64, 80], batch=2)
    (pb / "traffic" / "pose-small.json").write_text(json.dumps(mix))
    (pb / "workloads" / "tiny-pose-b2.json").write_text(
        json.dumps({"deadline_s": 120, "limits": {"cell_logit_gap": 0.5, "conf_logit_err": 0.5, "px_err": 1.8}}))
    (pb / "metrics" / "pose.calls_traced.py").write_text(
        "def read(rec):\n    return None if rec.get('trace') is None else float(rec['trace']['calls'])\n")
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "deepercut-tiny", "source": "https://arxiv.org/abs/1605.03170",
                         "file": "portbench/configs/deepercut-tiny.json", "reduced": [],
                         "why": "a test's copy"})
    b["workloads"].append({"name": "tiny-pose-b2", "config": "deepercut-tiny",
                           "traffic": "pose-small", "chips": 1, "why": "a test's cell"})
    b["end_to_end"][0]["workloads"].append("tiny-pose-b2")
    b["per_layer"].append({"name": "pose.calls_traced", "unit": "calls", "better": "lower",
                           "source": "host_clock", "layer": "estimator", "moves": "pose_img_s",
                           "workloads": ["tiny-pose-b2"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))

    assert main(["--workload", "tiny-pose-b2", "--seed", "5", "--seconds", "0.5", "--trace", "1"],
                device="cpu", root=tiny_root) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and out["metrics"]["pose.calls_traced"]["value"] == 2.0
    after = digest(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("workload", ["r152-pose-b8", "caffenet-b256"])
def test_a_run_on_the_cpu(tiny_root, capsys, workload):
    """The rest of a run without the card: the result line's keys, the
    numbers compared last, each under its limit, and the same pool and
    weights from the same seed."""
    assert main(["--workload", workload, "--seed", str(2**31 + 7), "--seconds", "0.3",
                 "--trace", "0"], device="cpu", root=tiny_root) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "check" and out["correct"] and out["failed"] == 0
    assert set(out["check"]) == set(Cell(workload, tiny_root).spec["limits"])
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("key, value", [("loop", "open"), ("clients", 4)])
def test_a_mix_the_harness_cannot_drive_is_refused(key, value):
    from portbench.generator import Traffic

    mix = {"item_hw": [8, 8], "pool": 2, "batch": 1, key: value}
    with pytest.raises(ValueError, match="one closed-loop client"):
        Traffic(mix, 1, 2, "cpu")
