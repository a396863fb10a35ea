"""Tokenizers and synthetic corpora."""
