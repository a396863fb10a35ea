"""Deterministic offline tokenizers (no external vocab files).

``HashWordTokenizer`` — whitespace words hashed into a fixed vocab; stable
across processes (blake2).  Reserves low ids for specials and class-answer
tokens so the cascade engine can read class confidences off the LM head.

``ByteTokenizer`` — raw UTF-8 bytes + specials; used by tiny training
examples where a 256-way output keeps the model small.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

PAD, BOS, EOS = 0, 1, 2
N_SPECIALS = 8           # pad/bos/eos + up to 5 reserved
CLASS_BASE = 8           # class c answer token = CLASS_BASE + c
MAX_CLASSES = 8


def class_token(c: int) -> int:
    assert 0 <= c < MAX_CLASSES
    return CLASS_BASE + c


@dataclass(frozen=True)
class HashWordTokenizer:
    vocab_size: int = 50_304

    @property
    def first_word_id(self) -> int:
        return CLASS_BASE + MAX_CLASSES

    def _word_id(self, w: str) -> int:
        h = hashlib.blake2b(w.lower().encode(), digest_size=4).digest()
        span = self.vocab_size - self.first_word_id
        return self.first_word_id + int.from_bytes(h, "little") % span

    def encode(self, text: str, *, bos: bool = False) -> List[int]:
        ids = [BOS] if bos else []
        ids += [self._word_id(w) for w in text.split()]
        return ids

    def encode_batch(self, texts: Sequence[str], seq_len: int,
                     *, bos: bool = True) -> np.ndarray:
        out = np.full((len(texts), seq_len), PAD, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, bos=bos)[:seq_len]
            out[i, : len(ids)] = ids
        return out


@dataclass(frozen=True)
class ByteTokenizer:
    vocab_size: int = 256 + N_SPECIALS

    def encode(self, text: str, *, bos: bool = False) -> List[int]:
        ids = [BOS] if bos else []
        ids += [N_SPECIALS + b for b in text.encode("utf-8")]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i - N_SPECIALS for i in ids
                     if i >= N_SPECIALS).decode("utf-8", "replace")
