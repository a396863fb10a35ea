"""Least time of the extend attention of the launches dispatched in the
window over the device time of their flash extend kernels (profiler;
the work counts of the model's reference family)."""
from bench.harness.readers import roofline

KERNELS = ("flash_attention_tc_kernel", "flash_attention_kernel")


def read(ctx):
    return roofline(ctx, KERNELS, "extend")
