"""The readings a cell's correctness limits are set from, in one process.

    python3 -m portbench.control --workload <cell> --seeds 1 2 ... \
        --control-seeds 7 8 9 [--controls int8 fp8] [--seconds 3]

For each seed of ``--seeds``: the program as the cell runs it (set-up, a
closed loop of ``--seconds`` at the cell's own load, the reference, the
numbers `compare` gives). For each of ``--control-seeds`` and each control:

- ``int8``: the program with its own int8 path switched on (the entry's
  `System(control="int8")`), run the same way;
- ``fp8``: the reference itself with every conv's and InnerProduct's
  operands rounded to float8, in the program's place, over every pool item.

One JSON line per reading on standard output. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import List, Optional

import numpy as np

from portbench.harness import Cell, Run, log


def reading(cell: Cell, seed: int, seconds: float, control: str, device: str) -> dict:
    import torch

    from portbench.generator import Traffic, split_seed

    t0 = time.perf_counter()
    if control == "fp8":
        entry = cell.module("entries", cell.mix["entry"])
        ref = cell.module("reference", cell.config["name"])
        wseed, pseed, oseed = split_seed(seed, 3)
        traffic = Traffic(cell.mix, pseed, oseed, torch.device(device))
        weights = ref.make_weights(cell.cfg, wseed, torch.device(device))
        low = ref.serve(cell.cfg, cell.mix, weights, traffic.pool, device, low=True)
        want = ref.serve(cell.cfg, cell.mix, weights, traffic.pool, device)
        items = np.arange(len(traffic.pool))
        numbers = entry.compare(cell.cfg, cell.mix, entry.from_reference(low, items), want)
        calls = 0
    else:
        run = Run(cell, seed, device, control=control)
        run.setup()
        win = run.window(seconds)
        numbers = run.check()
        calls = len(win["latencies"])
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return {"cell": cell.name, "control": control or "program", "seed": seed, "calls": calls,
            "seconds": time.perf_counter() - t0, "numbers": numbers}


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--controls", nargs="*", default=["int8", "fp8"])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = Cell(args.workload)
    jobs = [(s, "") for s in args.seeds]
    jobs += [(s, c) for c in args.controls for s in args.control_seeds]
    for seed, control in jobs:
        out = reading(cell, seed, args.seconds, control, device)
        log(f"{out['cell']} {out['control']} seed {seed}: {out['numbers']} "
            f"({out['calls']} calls, {out['seconds']:.1f} s)")
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
