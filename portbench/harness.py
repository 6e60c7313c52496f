"""The harness: one run of one cell, driven by the files named in BENCHMARK.json.

A cell (``workloads`` in BENCHMARK.json) names a configuration and a
traffic mix; everything else is found by name under ``portbench/``:

- ``configs/<file>``: the configuration's sizes (the ``file`` of its entry);
- ``traffic/<mix>.json``: the mix's parameters, read by `generator.Traffic`;
  its ``entry`` names ``entries/<entry>.py``, which drives one entry point
  of the program (`System`) and judges what it served (`compare`);
- ``workloads/<cell>.json``: the cell's deadline and its correctness limits;
- ``reference/<config>.py``: the plain reference and the seeded weights;
- ``work/<config>.py``: the work counts per item, from shapes;
- ``metrics/<metric>.py``: one reader per metric (`readers`).

A run builds the program from the seed, warms up the cell's shapes, serves
a closed loop for ``seconds`` (and, traced, a few calls more under the
profiler), frees the program, runs the reference over every pool item and
compares every answer served. A watchdog ends any run that has not printed
its result by the cell's deadline.
"""

from __future__ import annotations

import faulthandler
import gc
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

PB = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deepcut_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux's process start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)


_T0 = time.perf_counter()
_AGE0 = process_age_s()


def since_start() -> float:
    return _AGE0 + time.perf_counter() - _T0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path):
    """A file of the benchmark found by name, imported by its path."""
    name = "portbench_" + re.sub(r"\W", "_", str(path.relative_to(path.parents[1]))[:-3])
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Cell:
    """A cell of BENCHMARK.json and the files it names, under `root`."""

    def __init__(self, name: str, root: Path = PB.parent):
        self.root, self.pb = Path(root), Path(root) / "portbench"
        self.bench = load_json(self.root / "BENCHMARK.json")
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.workload = name, found[0]
        self.config = next(c for c in self.bench["configs"] if c["name"] == self.workload["config"])
        cfg_file = self.root / self.config["file"]
        self.cfg, self.config_dir = load_json(cfg_file), cfg_file.parent
        self.mix = load_json(self.pb / "traffic" / f"{self.workload['traffic']}.json")
        self.spec = load_json(self.pb / "workloads" / f"{name}.json")

    def module(self, kind: str, name: str):
        return load_module(self.pb / kind / f"{name}.py")

    def metrics(self, traced: bool) -> List[dict]:
        """The metrics this cell reports: untraced its end-to-end metrics,
        traced its per-layer ones (listed for it, or, unlisted, wherever the
        end-to-end metric they move is reported)."""
        e2e = [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name] if m["moves"] in names else [])]


class Watchdog:
    """Ends the run at its deadline (seconds since process start): prints a
    failed result line and exits 3. faulthandler backs it up, a little
    later, for a hang that holds the interpreter lock."""

    def __init__(self, deadline_s: float, failed_line: Callable[[], dict]):
        self.deadline_s, self._failed_line = deadline_s, failed_line
        self._done, self._lock = threading.Event(), threading.Lock()
        left = max(deadline_s - since_start(), 0.0)
        faulthandler.dump_traceback_later(left + 30.0, exit=True, file=sys.__stderr__)
        threading.Thread(target=self._wait, args=(left,), daemon=True).start()

    def _wait(self, left: float) -> None:
        if self._done.wait(left):
            return
        with self._lock:
            if self._done.is_set():
                return
            log(f"watchdog: no result {self.deadline_s:.0f} s after the process started; "
                "the run is ended. Threads:")
            faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)
            print(json.dumps(self._failed_line()), flush=True)
            os._exit(3)

    def finish(self) -> None:
        """Called before the result is printed; the watchdog stands down."""
        self._lock.acquire()
        self._done.set()
        faulthandler.cancel_dump_traceback_later()


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Run:
    """One run of a cell (see the module docstring). `state` is what the
    watchdog's failed line reports."""

    def __init__(self, cell: Cell, seed: int, device, control: str = ""):
        self.cell, self.seed, self.device, self.control = cell, seed, device, control
        self.state = {"attempted": 0, "failed": 0,
                      "device": {"platform": "gpu" if str(device).startswith("cuda") else "cpu",
                                 "kind": "not read", "count": 1, "memory_peak_bytes": 0}}
        self.records: List = []

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        import torch

        from portbench.generator import Traffic, split_seed

        cell, dev = self.cell, torch.device(self.device)
        self.cuda = dev.type == "cuda"
        t = time.perf_counter()
        phases = {"imports": since_start()}

        def mark(name):
            nonlocal t
            self.sync()
            now = time.perf_counter()
            phases[name] = now - t
            t = now

        if self.cuda:
            self.state["device"]["kind"] = torch.cuda.get_device_name(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        self.entry = cell.module("entries", cell.mix["entry"])
        self.ref = cell.module("reference", cell.config["name"])
        self.work = cell.module("work", cell.config["name"]).counts(cell.cfg, cell.mix)
        self.wseed, pseed, oseed = split_seed(self.seed, 3)
        self.traffic = Traffic(cell.mix, pseed, oseed, dev)
        mark("traffic")
        weights = self.ref.make_weights(cell.cfg, self.wseed, dev)
        mark("weights")
        self.system = self.entry.System(cell.cfg, cell.mix, weights, self.traffic, dev,
                                        control=self.control, config_dir=cell.config_dir)
        del weights
        mark("program")
        self.calls = 0
        for _ in range(int(cell.mix["warmup_calls"])):
            self.system.call(self.calls)
            self.calls += 1
            mark(f"warm-up call {self.calls}")
        self.counted = self.system.counters()
        log("set-up seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    # -- the window ------------------------------------------------------
    def _call(self, i: int) -> int:
        self.state["attempted"] += 1
        items, record = self.system.call(i)
        self.records.append(record)
        return items

    def window(self, seconds: float) -> dict:
        """The closed loop: calls back to back until `seconds` have passed;
        the window runs from the first call's start to the last one's end."""
        latencies, items = [], 0
        cpu0 = time.process_time()
        start = time.perf_counter()
        end = start + seconds
        while True:
            t0 = time.perf_counter()
            try:
                items += self._call(self.calls)
            except Exception:   # a request that fails ends the loop; the run reports it
                self.state["failed"] += 1
                log("a call failed in the window:\n" + traceback.format_exc())
                break
            t1 = time.perf_counter()
            self.calls += 1
            latencies.append(t1 - t0)
            if t1 >= end:
                break
        stop = time.perf_counter()
        return {"seconds": stop - start, "items": items, "latencies": latencies,
                "cpu_s": time.process_time() - cpu0}

    def traced(self) -> dict:
        from portbench.trace import profile_calls

        n = int(self.cell.mix["trace_calls"])
        out = profile_calls(self._call, self.calls, n, self.device, self.system.counters)
        self.calls += 2 * n
        return out

    # -- the check -------------------------------------------------------
    def check(self) -> Dict[str, float]:
        """Frees the program, runs the reference over the pool, compares
        every answer served. Two numbers more hold the cell to the precision
        it states: ``int8_launches``, the program's int8 kernel launches
        since set-up (the card's only: the port counts no CPU call), and
        ``int8_serving``, 1 where the program reports its int8 model."""
        import torch

        counted = self.system.counters()
        precision = {"int8_launches": float(sum(counted[k] - self.counted[k] for k in counted
                                                if k.startswith("int8"))),
                     "int8_serving": float(self.system.quantized())}
        self.system.close()
        del self.system
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        cell = self.cell
        t0 = time.perf_counter()
        weights = self.ref.make_weights(cell.cfg, self.wseed, torch.device(self.device))
        ref = self.ref.serve(cell.cfg, cell.mix, weights, self.traffic.pool, self.device)
        del weights
        t1 = time.perf_counter()
        numbers = self.entry.compare(cell.cfg, cell.mix, self.entry.served(self.records), ref)
        log(f"reference over {len(self.traffic.pool)} pool items {t1 - t0:.3f} s, "
            f"{len(self.records)} answers compared {time.perf_counter() - t1:.3f} s")
        return {**numbers, **precision}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; one that is not finite is written as a
    string, which JSON can hold, and fails."""
    return {k: {"value": v if math.isfinite(v) else repr(v), "limit": limits[k]}
            for k, v in ((k, float(numbers[k])) for k in limits)}


def main(argv: Optional[List[str]] = None, device: Optional[str] = None,
         root: Path = PB.parent, control: str = "") -> int:
    """One run (`python -m portbench.run`); `device` set skips the look for
    a card (tests drive the rest of a run on the CPU that way, may name
    another checkout's `root`, and may put a `control` of the entry in the
    program's place)."""
    import argparse

    p = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                description="One run of one benchmark cell of deepcut_tpu_torch.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = Cell(args.workload, root)
    run = Run(cell, args.seed, device or "cuda", control=control)
    dog = Watchdog(float(cell.spec["deadline_s"]), lambda: {
        "correct": False, "attempted": run.state["attempted"], "failed": run.state["failed"],
        "metrics": {}, "device": run.state["device"],
        "check": {"seconds": {"value": since_start(), "limit": cell.spec["deadline_s"]}}})

    import torch

    if device is None:
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"portbench: the cell needs {chips} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
    run.setup()
    setup_s = since_start()
    log(f"set-up {setup_s:.3f} s")
    win = run.window(args.seconds)
    lat = win["latencies"]
    fifths = [statistics.median(lat[k * len(lat) // 5:(k + 1) * len(lat) // 5]) * 1e3
              for k in range(5)] if len(lat) >= 5 else []
    log(f"window {win['seconds']:.3f} s: {len(lat)} calls, {win['items']} items; median ms "
        "by fifth of the window: " + ", ".join(f"{m:.3f}" for m in fifths))
    trace = run.traced() if args.trace else None
    run.sync()
    if trace is not None:
        log(f"traced {trace['calls']} calls, {trace['items']} items; at {since_start():.3f} s")
    if run.cuda:
        run.state["device"]["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    numbers = run.check()
    log(f"reference and comparison done at {since_start():.3f} s")
    found = forbidden_modules()
    if found:
        log(f"portbench: the run loaded {found}; the benchmark measures the port alone")
        return 1

    peaks = load_json(cell.pb / "peaks.json")
    rec = {"setup_s": setup_s, "window": win, "trace": trace, "work": run.work,
           "peak": peaks.get(run.state["device"]["kind"]) if run.cuda else None}
    metrics = {}
    for m in cell.metrics(bool(args.trace)):
        value = cell.module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(run.state["device"])
    if trace is not None and trace.get("busy_s") is not None:
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    check = judge(numbers, cell.spec["limits"])
    correct = (run.state["failed"] == 0 and win["items"] > 0
               and all(isinstance(c["value"], float) and c["value"] <= c["limit"]
                       for c in check.values()))
    out = {"correct": correct, "attempted": run.state["attempted"], "failed": run.state["failed"],
           "metrics": metrics, "device": dev}
    if trace is not None:
        from portbench.trace import breakdown

        bd = breakdown(trace)
        if bd is not None:
            out["breakdown"] = bd
    out["card"] = power_limit() if run.cuda else "cpu"
    out["samples"] = len(win["latencies"])
    out["check"] = check
    dog.finish()
    log(f"card: {out['card']}; calls in the window: {out['samples']}, median "
        f"{statistics.median(win['latencies']) * 1e3:.3f} ms; result at {since_start():.3f} s")
    for k, c in check.items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0
