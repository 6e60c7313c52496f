"""The program's spans in a traced cycle, and the arithmetic on them.

While a torch profiler records, the port opens a span at each boundary of
its layers (`deepcut_tpu_torch.spans`): CPU events named ``pose.*`` and
``graph.*``, in the same raw event stream, and on the same clock, as the
device's operations. `collect` takes them from a traced cycle's events as
intervals, with the device's merged busy intervals and the traced step's
own interval; `span_ms_per_item` and `idle_pct` are what a per-layer
metric reads from that record (``rec["trace"]["program"]``), and return
None where it is absent. Intervals are [start, end] in nanoseconds.

The harness's record does not carry ``program`` yet: `trace.profile_calls`
has to put ``collect``'s result beside `trace.summarize`'s.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from portbench.trace import SKIP, _union

PREFIXES = ("pose.", "graph.")


def collect(events) -> dict:
    """From a profiler's raw (kineto) events: {"spans": {name: [[start,
    end], ...]}, "busy": the device's merged operations (None without
    device events), "window": the traced step, the longest ProfilerStep}."""
    import torch
    from torch.autograd.profiler_util import _filter_name

    cuda = torch.autograd.DeviceType.CUDA
    spans: Dict[str, List[List[int]]] = {}
    busy: List[List[int]] = []
    window: Optional[List[int]] = None
    device = False
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            device = True
            if (_filter_name(name) or getattr(e, "is_hidden_event", lambda: False)()
                    or name.startswith(SKIP)):
                continue
            busy.append([e.start_ns(), e.start_ns() + e.duration_ns()])
        elif name.startswith(PREFIXES):
            spans.setdefault(name, []).append([e.start_ns(), e.end_ns()])
        elif name.startswith(SKIP) and (window is None
                                        or e.end_ns() - e.start_ns() > window[1] - window[0]):
            window = [e.start_ns(), e.end_ns()]
    return {"spans": spans, "busy": _union(busy) if device else None, "window": window}


def total_ns(intervals: Iterable[List[int]]) -> int:
    return sum(b - a for a, b in intervals)


def overlap_ns(a: List[List[int]], b: List[List[int]]) -> int:
    """The time two merged (sorted, disjoint) interval lists share."""
    i = j = shared = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        shared += max(hi - lo, 0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return shared


def _program(rec: dict) -> Optional[dict]:
    t = rec.get("trace")
    return t.get("program") if t else None


def span_ms_per_item(rec: dict, name: str, minus: str = "") -> Optional[float]:
    """The union of the span `name`'s intervals, less the part the span
    `minus` covers, per item traced, ms. None where the record has no
    spans or the program opened no span of that name."""
    p = _program(rec)
    if p is None or name not in p["spans"]:
        return None
    own = _union(p["spans"][name])
    ns = total_ns(own) - overlap_ns(own, _union(p["spans"].get(minus, [])))
    return ns / 1e6 / rec["trace"]["items"]


def idle_pct(rec: dict, name: str, inside: bool) -> Optional[float]:
    """The share of the traced step in which nothing ran on the device and
    the host was inside an interval of the span `name` (or, with inside
    False, in none), by interval overlap. None off the card, where the
    record has no spans, or where the program opened no span of that name."""
    p = _program(rec)
    if p is None or p["busy"] is None or p["window"] is None or name not in p["spans"]:
        return None
    lo, hi = p["window"]
    busy = [[max(a, lo), min(b, hi)] for a, b in p["busy"] if b > lo and a < hi]
    idle, at = [], lo
    for a, b in busy:
        if a > at:
            idle.append([at, a])
        at = max(at, b)
    if at < hi:
        idle.append([at, hi])
    within = overlap_ns(idle, _union(p["spans"][name]))
    return 100.0 * (within if inside else total_ns(idle) - within) / (hi - lo)
