"""Checkpoints: async, atomic, keep-N."""
