"""Training-log parsing (reference: tools/extra/parse_log.py).

Parses solver output lines of the form

    Iteration 120, loss = 0.01234 (part_loss = ..., locref_loss = ...), lr = 0.005

(and the reference's glog format ``Iteration N, loss = X`` / ``Iteration N,
lr = X``) into rows; writes `<log>.train` CSV like the reference tool.

Usage: python -m deepcut_tpu_torch.tools.parse_log train.log [out_dir]

`parse_test_log` (the reference tool's ``.test`` rows) is the port's
addition. The rest is the port's own copy of `deepcut_tpu.tools.parse_log`
(jax-free; held against the original by tests/test_torch_tools.py).
"""

from __future__ import annotations

import csv
import os
import re
import sys
from typing import Dict, List, Optional

_ITER_RE = re.compile(r"Iteration (\d+)[,\s]")
_LOSS_RE = re.compile(r"loss = ([0-9.eE+-]+)")
_LR_RE = re.compile(r"lr = ([0-9.eE+-]+)")
_METRIC_RE = re.compile(r"(\w+) = ([0-9.eE+-]+)")


def parse_log(path: str) -> List[Dict[str, float]]:
    rows: List[Dict[str, float]] = []
    with open(path) as f:
        for line in f:
            m = _ITER_RE.search(line)
            if not m or "loss" not in line:
                continue
            row: Dict[str, float] = {"NumIters": float(m.group(1))}
            lm = _LOSS_RE.search(line)
            if lm:
                row["loss"] = float(lm.group(1))
            lr = _LR_RE.search(line)
            if lr:
                row["LearningRate"] = float(lr.group(1))
            for name, val in _METRIC_RE.findall(line):
                if name not in ("loss", "lr", "Iteration"):
                    row[name] = float(val)
            rows.append(row)
    return rows


_TEST_ITER_RE = re.compile(r"Iteration (\d+), Testing net")
_TEST_OUT_RE = re.compile(r"Test net output #\d+: (\w+) = ([0-9.eE+-]+|nan|inf|-inf)")


def parse_test_log(path: str) -> List[Dict[str, float]]:
    """The test passes of a solver log (the reference tool's ``.test``
    rows): one row per ``Iteration N, Testing net`` line, holding each
    ``Test net output #k: name = value`` that follows it."""
    rows: List[Dict[str, float]] = []
    with open(path) as f:
        for line in f:
            m = _TEST_ITER_RE.search(line)
            if m:
                rows.append({"NumIters": float(m.group(1))})
                continue
            t = _TEST_OUT_RE.search(line)
            if t and rows:
                rows[-1][t.group(1)] = float(t.group(2))
    return rows


def write_csv(rows: List[Dict[str, float]], out_path: str) -> None:
    if not rows:
        return
    fields: List[str] = []
    for r in rows:
        for k in r:
            if k not in fields:
                fields.append(k)
    with open(out_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for r in rows:
            w.writerow(r)


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    log_path = argv[0]
    out_dir = argv[1] if len(argv) > 1 else os.path.dirname(log_path) or "."
    rows = parse_log(log_path)
    out = os.path.join(out_dir, os.path.basename(log_path) + ".train")
    write_csv(rows, out)
    print(f"wrote {out} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
