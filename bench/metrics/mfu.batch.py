"""Useful model operations of the launches dispatched in the window over
the seconds until the device finished them, at the card's published bf16
peak (bench/work/formulas.py over the model's reference family)."""
from bench.harness.readers import mfu as read  # noqa: F401
