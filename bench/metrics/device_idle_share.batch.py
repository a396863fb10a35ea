"""Share of the window with no device operation running (profiler)."""
from bench.harness.readers import device_idle_share as read  # noqa: F401
