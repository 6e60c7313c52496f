"""The traced window: torch.profiler's raw device events over a few calls.

The sums are taken over the profiler's raw events, filtered and named as
`key_averages` names them, since `key_averages` first parses every CPU op
of the window into Python objects, which costs seconds of host time per
window. (The same arithmetic as chip_smoke.py's `_device_profile`, which
checked it against `key_averages` to the last digit.) The tracer can drop a
window's launches now and then; the counts per kernel are returned so that
a reader can divide by the launches recorded.
"""

from __future__ import annotations

import heapq
import time
from typing import Callable, Dict, List, Optional

SKIP = ("ProfilerStep",)


def profile_calls(call: Callable[[int], int], first: int, calls: int, device,
                  counters: Callable[[], Dict[str, int]]) -> dict:
    """Run `calls` calls from call `first` as the profiler's warm-up cycle,
    then as many more traced. Returns the traced cycle's window (host
    seconds), items, the program's counters moved over it, and the
    device's record (None off the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    items = 0
    sync()
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for i in range(first, first + calls):
            call(i)
        sync()
        prof.step()
        before = counters()
        t0 = time.perf_counter()
        for i in range(first + calls, first + 2 * calls):
            items += call(i)
        sync()
        window = time.perf_counter() - t0
        after = counters()
        prof.step()
    out = {"window_s": window, "items": items, "calls": 2 * calls,
           "counters": {k: after[k] - before[k] for k in after}}
    out.update(summarize(prof.profiler.kineto_results.events()) if cuda else
               {"busy_s": None, "kernels": {}, "gaps": {}})
    return out


def _union(intervals: List[List[int]]) -> List[List[int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events) -> dict:
    """busy_s (the union of the device's operations), kernels {name:
    [device seconds, launches]} and the idle gaps between device operations
    summed by the innermost host op running at each gap's middle."""
    import torch
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    cuda = torch.autograd.DeviceType.CUDA
    kernels: Dict[str, List[float]] = {}
    spans, host = [], []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if _filter_name(name) or getattr(e, "is_hidden_event", lambda: False)():
                continue
            name = _rewrite_name(name=name, with_wildcard=True)
            if name.startswith(SKIP):
                continue
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += e.duration_ns() / 1e9
            k[1] += 1
            spans.append([e.start_ns(), e.start_ns() + e.duration_ns()])
        elif not name.startswith(SKIP):
            host.append((e.start_ns(), e.end_ns(), name))
    merged = _union(spans)
    busy = sum(b - a for a, b in merged) / 1e9
    # each gap is labelled by the host op that started last among those
    # running at its middle: a sweep over the mids in order, the running
    # ops in a heap by start, those ended before a mid dropped for good
    host.sort()
    running: List[tuple] = []
    gaps: Dict[str, float] = {}
    j = 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(running, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while running and running[0][1] < mid:
            heapq.heappop(running)
        label = running[0][2] if running else "no host op recorded"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    return {"busy_s": busy, "kernels": kernels, "gaps": gaps}


def top(table: Dict[str, float], n: int = 10, width: int = 120) -> List[list]:
    """The n largest entries as [name, seconds] pairs, names cut to width."""
    ranked = sorted(table.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:width], secs] for name, secs in ranked]


def breakdown(trace: Optional[dict]) -> Optional[dict]:
    """The result line's breakdown: the device operations that took most
    time and the longest idle gaps by what the host was doing."""
    if not trace or trace.get("busy_s") is None:
        return None
    return {"device_ops": top({k: v[0] for k, v in trace["kernels"].items()}),
            "idle_gaps": top(trace["gaps"])}
