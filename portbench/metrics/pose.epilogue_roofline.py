"""The conv epilogue kernel's share of its byte roofline: each conv's f32
output read and written once, the residual and the bias read once (the work
counts), at the card's HBM rate, over the kernel's device time."""

from portbench.readers import roofline_pct

KERNELS = ("conv_epilogue_kernel",)


def read(rec):
    return roofline_pct(rec, "epilogue_bytes_per_item", KERNELS, "conv_epilogue")
