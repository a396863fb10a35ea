"""Documents resolved in the window over its seconds (host clock)."""
from bench.harness.readers import docs_per_s as read  # noqa: F401
