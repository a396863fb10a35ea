"""Cached document tokens over all billed document tokens in the window
(ServeStats)."""
from bench.harness.readers import cached_token_share as read  # noqa: F401
