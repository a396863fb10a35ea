"""The host's non-blocking enqueue of a launch's stage step, per
launch (telemetry timeline)."""
from bench.harness.readers import dispatch_ms_per_launch as read  # noqa: F401
