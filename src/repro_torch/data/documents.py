"""Synthetic text corpora with planted relevance structure.

Real-text twin of the score-level simulator: documents are actual line
sequences (so §4 document restructuring runs for real — line splitting,
oracle range labeling, chunking, classifier training, reordering), with a
known ground truth for tests:

  * each document has a class label;
  * a few *relevant* lines carry class-signal keywords;
  * remaining lines are filler drawn from a shared word pool;
  * distractor lines mention signal words of OTHER classes (so a naive
    keyword grep is not enough and the learned classifier has work to do).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

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
    ["merger", "acquisition", "quarterly", "dividend"],
    ["tournament", "playoff", "championship", "score"],
    ["genome", "protein", "clinical", "cohort"],
    ["satellite", "quantum", "processor", "algorithm"],
]

# lines that LOOK substantive but are irrelevant to the operation (they make
# naive keyword retrieval imperfect without creating contradictory labels)
DISTRACTOR_SIGNALS = ["footnote", "docket", "stipulated", "continuance",
                      "exhibits", "transcript", "scheduling", "amended"]


@dataclass
class SyntheticDoc:
    doc_id: int
    lines: List[str]
    label: int
    relevant_lines: List[int]

    @property
    def text(self) -> str:
        return "\n".join(self.lines)

    def reordered(self, order: Sequence[int]) -> "SyntheticDoc":
        inv = list(order)
        return SyntheticDoc(
            self.doc_id, [self.lines[i] for i in inv], self.label,
            [inv.index(r) for r in self.relevant_lines if r in inv])


def _filler_line(rng: np.random.Generator, width: int = 10) -> str:
    return " ".join(rng.choice(FILLER, size=width))


def _signal_line(rng: np.random.Generator, cls: int, width: int = 10) -> str:
    words = list(rng.choice(FILLER, size=width - 2))
    sig = rng.choice(CLASS_SIGNALS[cls], size=2)
    pos = sorted(rng.choice(width - 2, size=2, replace=False))
    for p, s in zip(pos, sig):
        words.insert(int(p), str(s))
    return " ".join(words)


def generate_corpus(
    n_docs: int,
    n_classes: int = 2,
    avg_lines: int = 40,
    n_relevant: int = 3,
    distractor_p: float = 0.05,
    seed: int = 0,
) -> List[SyntheticDoc]:
    assert n_classes <= len(CLASS_SIGNALS)
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n_docs):
        label = int(rng.integers(0, n_classes))
        n_lines = max(int(rng.normal(avg_lines, avg_lines * 0.25)),
                      n_relevant + 4)
        rel = sorted(rng.choice(n_lines, size=n_relevant, replace=False))
        lines = []
        for li in range(n_lines):
            if li in rel:
                lines.append(_signal_line(rng, label))
            elif rng.random() < distractor_p:
                words = list(rng.choice(FILLER, size=8))
                words.insert(int(rng.integers(8)),
                             str(rng.choice(DISTRACTOR_SIGNALS)))
                lines.append(" ".join(words))
            else:
                lines.append(_filler_line(rng))
        docs.append(SyntheticDoc(i, lines, label, [int(r) for r in rel]))
    return docs


def doc_contains_signal(doc_text: str, cls: int) -> bool:
    t = doc_text.lower()
    return any(s in t for s in CLASS_SIGNALS[cls])
