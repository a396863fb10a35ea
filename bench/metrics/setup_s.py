"""Set-up: process start to the window's open (loading, weights made on
the card, warm-up of the cell's own traffic)."""
from bench.harness.readers import setup_s as read  # noqa: F401
