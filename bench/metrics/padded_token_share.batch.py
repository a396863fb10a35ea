"""Share of the row-tokens the window's launches computed that were
padding: rows up to the launch width, and bucket PAD in each extend
chunk (the program's ``rows_computed`` and ``tokens_real`` counters)."""
from bench.harness.phases import padded_token_share as read  # noqa: F401
