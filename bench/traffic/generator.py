"""The benchmark's document generator (one for every mix).

A frozen copy of the program's synthetic corpus (``data/documents.py``'s
``generate_corpus``: filler lines, a few class-signal lines, distractor
lines), with two changes for a benchmark:

* lengths are log-normal in TOKENS (the tokenizer maps one whitespace
  word to one token), clipped to ``[min_tokens, max_tokens]``;
* lengths and labels are stratified: every block of ``block`` documents
  holds the log-normal's lengths at the quantiles ``(i + 0.5) / block``
  and each class equally often, dealt in an order the seed draws.  The
  words of every document are drawn afresh from the seed, so no document
  repeats within a run, and every seed gets the same sizes.

A traffic mix is a JSON file of parameters (``bench/traffic/<mix>.json``)
that ``make_traffic`` reads; nothing here knows a mix by name.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List, Mapping

import numpy as np

FILLER = ("the quick brown fox jumps over lazy dogs while market conditions "
          "remain stable and committee review proceeds according to standard "
          "schedule with no material findings reported during the interim "
          "period as stakeholders await further guidance on pending matters "
          "from relevant departments and administrative units across regions"
          ).split()

CLASS_SIGNALS = [
    ["overturn", "reversed", "vacated", "remanded"],
    ["affirmed", "upheld", "sustained", "denied"],
]

DISTRACTOR_SIGNALS = ["footnote", "docket", "stipulated", "continuance",
                      "exhibits", "transcript", "scheduling", "amended"]

LINE_WORDS = 10          # words a line, as the program's corpus has them


@dataclass(frozen=True)
class Doc:
    doc_id: int          # unique over the run (all tenants)
    tenant: int
    n_tokens: int
    text: str


def length_grid(spec: Mapping, n: int) -> np.ndarray:
    """``n`` token lengths at the quantiles ``(i + 0.5) / n`` of a
    log-normal of median ``median_tokens`` and log-sd ``sigma``, clipped."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    lens = np.exp(math.log(spec["median_tokens"]) + spec["sigma"] * z)
    return np.clip(np.rint(lens), spec["min_tokens"],
                   spec["max_tokens"]).astype(np.int64)


def make_text(rng: np.random.Generator, n_tokens: int, label: int,
              n_relevant: int, distractor_p: float) -> str:
    """A document of exactly ``n_tokens`` words in lines of
    ``LINE_WORDS``: ``n_relevant`` lines carry two signal words of
    ``label``, a share ``distractor_p`` of the others one distractor."""
    words = np.asarray(FILLER, dtype=object)[
        rng.integers(len(FILLER), size=n_tokens)]
    n_lines = -(-n_tokens // LINE_WORDS)
    width = np.minimum(LINE_WORDS,
                       n_tokens - np.arange(n_lines) * LINE_WORDS)
    rel = rng.choice(n_lines, size=min(n_relevant, n_lines), replace=False)
    sig = np.asarray(CLASS_SIGNALS[label], dtype=object)
    for li in rel:
        at = rng.choice(width[li], size=min(2, width[li]), replace=False)
        words[li * LINE_WORDS + at] = sig[rng.integers(len(sig),
                                                       size=len(at))]
    other = np.ones(n_lines, dtype=bool)
    other[rel] = False
    dl = np.flatnonzero(other & (rng.random(n_lines) < distractor_p))
    at = (rng.random(len(dl)) * width[dl]).astype(np.int64)
    dis = np.asarray(DISTRACTOR_SIGNALS, dtype=object)
    words[dl * LINE_WORDS + at] = dis[rng.integers(len(dis), size=len(dl))]
    return "\n".join(" ".join(words[i:i + LINE_WORDS])
                     for i in range(0, n_tokens, LINE_WORDS))


class Traffic:
    """Documents per tenant in submission order.  ``more`` makes further
    blocks of the same stream, so a run that outpaces the first ones goes
    on with the documents any other run of the seed would see."""

    def __init__(self, mix: Mapping, seed: int, n_tenants: int):
        self.mix, self.n_tenants = mix, n_tenants
        self.rng = np.random.default_rng([abs(int(seed)), int(seed < 0)])
        self.lens = length_grid(mix["length"], int(mix["block"]))
        self.docs: List[List[Doc]] = [[] for _ in range(n_tenants)]
        self.made = 0

    def more(self, n_docs: int) -> None:
        """At least ``n_docs`` more documents, in whole blocks."""
        mix, block = self.mix, len(self.lens)
        n_classes = int(mix.get("n_classes", 2))
        for _ in range(-(-n_docs // block)):
            order = self.rng.permutation(block)
            labels = self.rng.permutation(np.arange(block) % n_classes)
            for j in range(block):
                n, i = int(self.lens[order[j]]), self.made
                text = make_text(self.rng, n, int(labels[j]),
                                 mix.get("n_relevant", 3),
                                 mix.get("distractor_p", 0.05))
                self.docs[i % self.n_tenants].append(
                    Doc(i, i % self.n_tenants, n, text))
                self.made += 1


def make_traffic(mix: Mapping, seed: int, n_docs: int,
                 n_tenants: int) -> Traffic:
    """At least ``n_docs`` documents (whole blocks) from ``mix`` for
    ``seed``, dealt to ``n_tenants`` tenants in turn."""
    t = Traffic(mix, seed, n_tenants)
    t.more(n_docs)
    return t
