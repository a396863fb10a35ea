"""The garbage collector's pauses over the window's seconds (the
program's ``gc_s`` on each launch record)."""
from bench.harness.phases import gc_pause_share as read  # noqa: F401
