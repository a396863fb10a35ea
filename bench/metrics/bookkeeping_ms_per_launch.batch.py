"""The server step's own host time per launch: its duration less the
completion waits and the enqueues it made (the scheduler's pick,
eviction, batch assembly, routing, billing, queue pushes): the program's
``step_host_s`` span."""
from bench.harness.phases import mean_ms


def read(ctx):
    return mean_ms(ctx.records, "step_host_s")
