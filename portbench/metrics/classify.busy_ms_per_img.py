"""Device busy time (the union of its operations) per image traced."""

from portbench.readers import busy_ms_per_item


def read(rec):
    return busy_ms_per_item(rec)
