"""Least time of the op-suffix decode attention of the launches
dispatched in the window over the device time of their decode kernels
(profiler; the work counts of the model's reference family)."""
from bench.harness.readers import roofline

KERNELS = ("decode_partial_kernel", "decode_combine_kernel")


def read(ctx):
    return roofline(ctx, KERNELS, "decode")
