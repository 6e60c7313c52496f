"""On the card, at the cells' own sizes: the program reads within each
limit, and the control (the reference with its operands in float8, put in
the program's place) fails a number on three seeds.

    python -m pytest portbench/tests -m card -q      (on the card)
"""

import json

import pytest

from portbench.control import reading
from portbench.harness import Cell

from .conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def fails(cell, numbers):
    return any(not numbers[k] <= v for k, v in cell.spec["limits"].items())


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(card, workload):
    cell = Cell(workload, REPO)
    assert not fails(cell, reading(cell, 31, 3.0, "", card)["numbers"])
    for seed in (41, 42, 43):
        assert fails(cell, reading(cell, seed, 3.0, "fp8", card)["numbers"]), seed
