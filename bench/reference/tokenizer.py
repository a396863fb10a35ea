"""Frozen copy of the program's ``HashWordTokenizer``: whitespace words
hashed (blake2b, 4 bytes) into a fixed vocabulary above the special and
class-answer ids."""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List

PAD = 0
CLASS_BASE = 8           # class c answers with token CLASS_BASE + c
MAX_CLASSES = 8


def class_token(c: int) -> int:
    if not 0 <= c < MAX_CLASSES:
        raise ValueError(f"class {c} out of range")
    return CLASS_BASE + c


@dataclass(frozen=True)
class Tokenizer:
    vocab_size: int

    def encode(self, text: str) -> List[int]:
        first = CLASS_BASE + MAX_CLASSES
        span = self.vocab_size - first
        return [first + int.from_bytes(
            hashlib.blake2b(w.lower().encode(), digest_size=4).digest(),
            "little") % span for w in text.split()]
