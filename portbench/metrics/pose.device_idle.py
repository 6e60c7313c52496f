"""The share of the traced window in which nothing ran on the device."""

from portbench.readers import idle_pct


def read(rec):
    return idle_pct(rec)
