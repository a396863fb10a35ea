"""Device-busy share of the launches' extend windows on the device's
clock (start event to phase-mark event), launches dispatched in the
window (profiler)."""
from bench.harness.phases import window_busy_share


def read(ctx):
    return window_busy_share(ctx, "extend")
