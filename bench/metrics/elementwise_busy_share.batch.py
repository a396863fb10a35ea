"""Share of device-busy time in kernels that are neither matrix products
nor the port's attention kernels (profiler)."""
from bench.harness.readers import busy_share_of


def read(ctx):
    return busy_share_of(ctx, "other")
