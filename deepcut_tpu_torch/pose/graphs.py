"""The pose estimator's network replayed as CUDA graphs, one per chunk shape.

`NetGraphs` keeps, for one `PoseEstimator`, the folded forward
``model.fused_heads`` captured into a ``torch.cuda.CUDAGraph`` per chunk
shape ``(rows, canvas height, canvas width)``: a chunk's ~370 launches
(cuDNN's convs with their host-side planning, the conv epilogue's ctypes
launches, the heads' casts) become one replay. The replay runs the very
kernels the eager forward runs, with the same cuDNN algorithms, in the same
order, on the same memory layout, so its map is bit-equal to the eager one.

A capture costs far more than an eager forward (it synchronises the card,
collects garbage, empties the allocator's cache and runs one eager warm-up
first), so a shape is captured only once it recurs: its first chunk runs
eagerly, and its `ADMIT`-th captures it. A shape with no graph takes the
place of the least recently used graph only once it has been used `ADMIT`
times more, so a rotation over more shapes than the cache holds keeps the
graphs it has and runs the rest eagerly instead of capturing on every call
(the margin outlasts the rounding of a halving). The use counts are halved
every `AGE` uses per place in the cache, so shapes that stop coming give
way to new ones.

The warm-up runs on a side stream (so cuDNN's plans and workspace exist),
then the capture under a ``pose.capture`` span. Each chunk after that copies
its canvases into the graph's static input and replays it inside the
caller's ``pose.net`` span; every span stays outside the capture, where the
profiler can record it. The kernels' launch counts (`native.counts`) count
what the device runs: the launches the capture's thread records go to the
graph's own tally (`native.tally`), and each replay adds them
(`native.add_counts`).

The graphs of one estimator share one memory pool, so their intermediates
share memory. One lock serialises their use, from the copy-in until the
consumer of the map (the decode) is enqueued; callers share the device's
default stream, whose order keeps the next replay from overwriting a map
before its consumer has read it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Tuple, TypeVar

import torch

from deepcut_tpu_torch import native
from deepcut_tpu_torch.spans import POSE_CAPTURE, POSE_NET, span

Key = Tuple[int, int, int]
T = TypeVar("T")

ADMIT = 2   # a shape's uses before it is captured: a shape seen once stays eager
AGE = 16    # uses per place in the cache between two halvings of the use counts


class NetGraph:
    """One captured forward: its static NHWC input, the graph, its static
    output (the map the forward returned) and the hand-written kernels'
    launches one replay runs, per kernel name."""

    __slots__ = ("static_in", "graph", "static_out", "launches")

    def __init__(self, static_in: torch.Tensor, graph, static_out: torch.Tensor,
                 launches: Dict[str, int]):
        self.static_in, self.graph = static_in, graph
        self.static_out, self.launches = static_out, launches

    def replay(self, chunk: torch.Tensor) -> torch.Tensor:
        """The forward of `chunk` (the static input's shape): copied in,
        replayed; returns the static output."""
        self.static_in.copy_(chunk)
        self.graph.replay()
        return self.static_out


def capture(forward: Callable[[torch.Tensor], torch.Tensor], chunk: torch.Tensor,
            pool) -> NetGraph:
    """`forward` over a static copy of `chunk`, warmed up eagerly on a side
    stream and captured into a CUDA graph in `pool` (under inference mode,
    capture errors confined to this thread, so other threads may keep
    using the card). The graph's launches are this thread's during the
    capture: other threads' eager launches meanwhile are not in it."""
    dev = chunk.device
    static_in = chunk.clone(memory_format=torch.contiguous_format)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side), torch.inference_mode():
        forward(static_in)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with native.tally() as launches, span(POSE_CAPTURE), torch.inference_mode(), \
            torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        static_out = forward(static_in)
    return NetGraph(static_in, graph, static_out, launches)


class NetGraphs:
    """The captured forwards of one estimator, keyed by chunk shape (module
    docstring); `eager` runs a chunk's forward op by op where `graphable()`
    is false or a shape has no graph. ``stats`` counts ``captures``,
    ``replays`` and ``eager`` network calls (those run eagerly and each
    capture's warm-up): the hit share is replays over replays plus eager
    calls."""

    def __init__(self, forward: Callable[[torch.Tensor], torch.Tensor],
                 eager: Callable[[torch.Tensor], torch.Tensor], capacity: int,
                 graphable: Callable[[], bool]):
        self.forward, self.eager, self.capacity = forward, eager, capacity
        self.graphable = graphable
        self.entries: "OrderedDict[Key, NetGraph]" = OrderedDict()
        self.uses: Dict[Key, int] = {}   # per shape, halved every AGE * capacity uses
        self.stats: Dict[str, int] = {"captures": 0, "replays": 0, "eager": 0}
        self._lock = threading.Lock()
        self._pool = None
        self._since_aged = 0

    def _use(self, key: Key) -> int:
        """Count a use of `key`; its count after any halving."""
        self.uses[key] = self.uses.get(key, 0) + 1
        self._since_aged += 1
        if self._since_aged >= AGE * max(1, self.capacity):
            self._since_aged = 0
            self.uses = {k: n // 2 for k, n in self.uses.items() if n > 1}
        return self.uses.get(key, 0)

    def _admit(self, uses: int) -> bool:
        """Whether a shape with no graph, used `uses` times, is captured now."""
        if uses < ADMIT or self.capacity < 1:
            return False
        if len(self.entries) < self.capacity:
            return True
        return uses >= self.uses.get(next(iter(self.entries)), 0) + ADMIT

    def _entry(self, chunk: torch.Tensor):
        """The graph of `chunk`'s shape, captured now if admitted; None
        where the shape runs eagerly."""
        key: Key = tuple(int(d) for d in chunk.shape[:3])
        uses = self._use(key)
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
            return entry
        if not self._admit(uses):
            return None
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        entry = capture(self.forward, chunk, self._pool)
        self.stats["eager"] += 1
        self.stats["captures"] += 1
        if len(self.entries) >= self.capacity:    # the capture synchronised the
            self.entries.popitem(last=False)      # card: no replay is in flight
        self.entries[key] = entry
        return entry

    def run(self, chunk: torch.Tensor, consume: Callable[[torch.Tensor], T]) -> T:
        """`consume(map)` of the forward of `chunk`, an (n, H, W, 3) f32
        canvas batch: by its shape's graph, or eagerly where `graphable()`
        is false or the shape has none. A graph's map is its static output:
        `consume` enqueues its reads on the stream before the next replay
        can overwrite it."""
        with self._lock:
            entry = self._entry(chunk) if self.graphable() else None
            if entry is not None:
                with span(POSE_NET):
                    out = entry.replay(chunk)
                native.add_counts(entry.launches)
                self.stats["replays"] += 1
                return consume(out)
            self.stats["eager"] += 1
        return consume(self.eager(chunk))
