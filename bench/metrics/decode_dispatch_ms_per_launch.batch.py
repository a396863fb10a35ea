"""The host's enqueue of a launch's op-suffix decode phase (the undo
window's save, the decode steps, the restore), per launch: the program's
``decode_dispatch_s`` span."""
from bench.harness.phases import mean_ms


def read(ctx):
    return mean_ms(ctx.records, "decode_dispatch_s")
