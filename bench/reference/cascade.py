"""The cascade's semantics as the program states them, worked out again:
which tokens each stage reads, how a document's chunks fall, and what
each stage bills.

* A document is bucketed by its token count into the next of
  ``BUCKETS``; a stage at fraction ``f`` runs to the padded length
  ``ceil(bucket * f)`` and reads the document's first ``ceil(n * f)``
  tokens, followed by the operation's tokens.
* Per model, the document's cache grows in chunks: a stage extends from
  the padded length the model holds to its own padded length (one chunk,
  PAD past the document's end) and re-reads the cache when it holds
  enough; every operation token is a chunk of one.
* Billing per stage: ``new * rate + cached * rate * discount`` with
  ``new`` the document tokens the chunk adds plus the operation's tokens
  and ``cached`` the document tokens it reuses, summed over the stages in
  order.
* Routing: a stage with thresholds resolves a document when the softmax
  over the class tokens gives its top class a probability at or above
  that class's threshold; the oracle's stage always resolves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Mapping, Optional, Sequence, Tuple

BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_len(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


def frac_len(n: int, fraction: float) -> int:
    return max(int(math.ceil(n * fraction)), 1)


@dataclass(frozen=True)
class Stage:
    model: str
    op: str
    fraction: float
    thresholds: Optional[Tuple[float, ...]]     # None: the oracle's stage


@dataclass
class StageRun:
    """One stage of one document: the tokens the model reads, the chunk
    layout of the document part (``(start, end, padded chunk length)``),
    and the stage's bill."""
    stage: int
    model: str
    doc_len: int                 # document tokens read
    chunks: List[Tuple[int, int, int]] = field(default_factory=list)
    new: int = 0
    cached: int = 0
    cost: float = 0.0


def stage_table(tenant_stages: Sequence[Mapping], oracle_op: str
                ) -> List[Stage]:
    """A tenant's stages from the cell file, with the oracle's appended."""
    out = [Stage(s["model"], s["op"], float(s["fraction"]),
                 tuple(float(t) for t in s["thresholds"]))
           for s in tenant_stages]
    return out + [Stage("oracle", oracle_op, 1.0, None)]


def walk(stages: Sequence[Stage], n_tokens: int, exit_stage: int,
         rates: Mapping[str, float], discount: float,
         op_lens: Mapping[str, int]) -> List[StageRun]:
    """The stages ``0..exit_stage`` of a document of ``n_tokens`` tokens
    that no eviction touched; ``op_lens`` gives each operation's token
    count."""
    bucket = bucket_len(n_tokens)
    held = {}                    # model -> (padded cached length, true)
    runs = []
    for i in range(exit_stage + 1):
        st = stages[i]
        f_len = frac_len(bucket, st.fraction)
        c_pad, c_true = held.get(st.model, (0, 0))
        eff_c = min(c_pad, f_len)
        run = StageRun(i, st.model, frac_len(n_tokens, st.fraction))
        if f_len - eff_c > 0:
            lo, hi = min(eff_c, n_tokens), min(f_len, n_tokens)
            run.new, run.cached = hi - lo, lo
            held[st.model] = (f_len, hi)
            run.chunks = _chunks_of(st.model, runs, eff_c, f_len)
        else:
            run.cached = min(c_true, run.doc_len)
            run.chunks = _chunks_of(st.model, runs, None, None)
        run.new += op_lens[st.op]
        rate = rates[st.model]
        run.cost = run.new * rate + run.cached * rate * discount
        runs.append(run)
    return runs


def _chunks_of(model, runs, start, end):
    """Chunk layout of the model's cache after this stage: the previous
    stage's on the same model, plus the new chunk ``[start, end)``."""
    prev = next((r.chunks for r in reversed(runs) if r.model == model), [])
    out = list(prev)
    if start is not None:
        out.append((start, end, end - start))
    return out


def total_cost(runs: Sequence[StageRun]) -> float:
    cost = 0.0
    for r in runs:
        cost += r.cost
    return cost


def decide(stage: Stage, probs: Sequence[float]) -> Tuple[int, float, bool]:
    """(top class, its probability, resolves here) for one stage."""
    top = max(range(len(probs)), key=lambda c: probs[c])
    p = float(probs[top])
    return top, p, stage.thresholds is None or p >= stage.thresholds[top]
