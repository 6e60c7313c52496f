"""Arithmetic the metric readers share (each metric is a file of its own
under metrics/, found by its name in BENCHMARK.json).

A reader takes the run's record and returns a number, or None where the
run has nothing for it to read (no trace, no device trace off the card, no
peak for the card), and the harness then leaves the metric out. The record:

- ``setup_s``: process start to the first timed call;
- ``window``: the measured window's ``seconds`` (first call's start to the
  last call's end), ``items`` served, every call's ``latencies`` (seconds)
  and the process's CPU seconds ``cpu_s``;
- ``trace`` (``--trace 1``): the traced cycle (`trace.profile_calls`);
- ``work``: the configuration's work counts per item (work/<config>.py);
- ``peak``: the card's peaks (peaks.json), or None.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np


def rate(rec: dict) -> float:
    """Items served per second of the window."""
    return rec["window"]["items"] / rec["window"]["seconds"]


def latency_ms(rec: dict, q: float) -> float:
    """The q-th percentile of the window's call latencies, ms."""
    return float(np.percentile(np.asarray(rec["window"]["latencies"]), q)) * 1e3


def host_cpu_ms_per_item(rec: dict) -> float:
    """The process's CPU time over the window, per item served."""
    return rec["window"]["cpu_s"] * 1e3 / rec["window"]["items"]


def _device(rec: dict) -> Optional[dict]:
    t = rec.get("trace")
    return t if t and t.get("busy_s") is not None else None


def busy_ms_per_item(rec: dict) -> Optional[float]:
    """Device busy time (the union of its operations) per item traced."""
    t = _device(rec)
    return None if t is None else t["busy_s"] * 1e3 / t["items"]


def idle_pct(rec: dict) -> Optional[float]:
    """The share of the traced window in which nothing ran on the device."""
    t = _device(rec)
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(rec: dict) -> Optional[float]:
    """The window's FLOP rate (the work counts' FLOPs per item times items
    per second) over the card's dense bf16 peak."""
    if rec.get("peak") is None:
        return None
    return 100.0 * rec["work"]["flops_per_item"] * rate(rec) / rec["peak"]["bf16_flops_s"]


def kernel_seconds(rec: dict, patterns: Iterable[str]) -> Optional[tuple]:
    """(device seconds, launches) of the traced kernels whose names hold any
    of the patterns."""
    t = _device(rec)
    if t is None:
        return None
    hits = [v for k, v in t["kernels"].items() if any(p in k for p in patterns)]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def roofline_pct(rec: dict, bytes_key: str, patterns: Iterable[str], counter: str
                 ) -> Optional[float]:
    """A kernel's share of its byte roofline: the bytes its work needs (the
    work counts per item times the items traced) at the card's HBM rate,
    over its device time. Where the tracer lost launches (fewer recorded
    than the program's counter launched), the bytes are taken in the share
    of the launches recorded. None where nothing was recorded."""
    got = kernel_seconds(rec, patterns)
    if got is None or got[1] == 0 or rec.get("peak") is None:
        return None
    t = rec["trace"]
    launched = t["counters"].get(counter, 0)
    if launched <= 0:
        return None
    need = rec["work"][bytes_key] * t["items"] * min(1.0, got[1] / launched)
    return 100.0 * need / rec["peak"]["hbm_bytes_s"] / got[0]
