"""Real documents per launch (telemetry launch records)."""
from bench.harness.readers import docs_per_launch as read  # noqa: F401
