"""Named spans at the boundaries of the port's layers, for torch.profiler.

``with span(POSE_CANVAS): ...`` records a CPU event under the name while a
torch profiler records, on the calling thread, nested in the spans around it
and in the same event stream (and on the same clock) as the aten ops inside
it; with no profiler running it records nothing and costs under a
microsecond. It is torch's fast RecordFunction, not `record_function`: its
events are not user annotations, so a CUDA build's profiler projects none of
them onto the device timeline. A CUDA-graph replay records no span: keep
spans outside a capture.

The names are a closed set: the estimator's six, ``graph.forward`` and one
``graph.<layer>`` per plan step of the graph engine (`layer_span`).
"""

from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast

POSE_CALL = "pose.call"      # each public PoseEstimator method
POSE_CANVAS = "pose.canvas"  # a chunk's upload and preprocess
POSE_NET = "pose.net"        # a network call
POSE_DECODE = "pose.decode"  # a decode launch
POSE_WAIT = "pose.wait"      # a copy back that waits on the device
POSE_CAPTURE = "pose.capture"  # a network's capture into a CUDA graph (`pose.graphs`)
GRAPH_FORWARD = "graph.forward"  # a make_forward call
GRAPH_PREFIX = "graph."


def layer_span(layer: str) -> str:
    """The span name of a graph-engine layer's plan step."""
    return GRAPH_PREFIX + layer


def span(name: str) -> _RecordFunctionFast:
    """A context manager recording `name` while a torch profiler records."""
    return _RecordFunctionFast(name)
