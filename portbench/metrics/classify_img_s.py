"""Images classified, per second of the window."""

from portbench.readers import rate


def read(rec):
    return rate(rec)
