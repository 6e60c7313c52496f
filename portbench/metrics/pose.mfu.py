"""The whole step's share of the card's dense bf16 peak: the work counts'
FLOPs per image times the window's images per second."""

from portbench.readers import mfu_pct


def read(rec):
    return mfu_pct(rec)
