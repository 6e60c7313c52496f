"""The 95th percentile of the latency of every estimate_pose_batch call in
the window, ms (a clip's wait)."""

from portbench.readers import latency_ms


def read(rec):
    return latency_ms(rec, 95)
