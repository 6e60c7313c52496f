"""The process's CPU time over the window, per image."""

from portbench.readers import host_cpu_ms_per_item


def read(rec):
    return host_cpu_ms_per_item(rec)
