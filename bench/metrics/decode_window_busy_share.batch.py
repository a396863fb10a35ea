"""Device-busy share of the launches' op-suffix decode windows on the
device's clock (phase-mark event to completion event), launches
dispatched in the window (profiler)."""
from bench.harness.phases import window_busy_share


def read(ctx):
    return window_busy_share(ctx, "decode")
