"""The host's enqueue of a launch's extend phase (its inputs' device
copies, the gather, the extend, the scatter), per launch: the program's
``extend_dispatch_s`` span."""
from bench.harness.phases import mean_ms


def read(ctx):
    return mean_ms(ctx.records, "extend_dispatch_s")
