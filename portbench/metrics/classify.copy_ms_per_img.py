"""Device time of the dtype and layout copies per image traced: the casts
and memory-format copies around each layer, and cuDNN's layout transforms."""

from portbench.readers import kernel_seconds

KERNELS = ("copy_kernel", "nchwToNhwc", "nhwcToNchw")


def read(rec):
    got = kernel_seconds(rec, KERNELS)
    return None if got is None else got[0] * 1e3 / rec["trace"]["items"]
