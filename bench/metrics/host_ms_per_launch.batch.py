"""Host time in the server's step that is not the wait on a launch,
per launch (telemetry timeline, harness clock)."""
from bench.harness.readers import host_ms_per_launch as read  # noqa: F401
