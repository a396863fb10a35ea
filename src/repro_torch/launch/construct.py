"""Construct a task cascade from engine scores, then serve it (paper
Figure 2, steps 1-5 of ``examples/serve_cascade_torch.py``).

1. ``restructure``: fit the §4 document restructurer on the dev split
   with an oracle labeler, reorder every document (one relevance kernel
   launch per feed of up to 4096 chunks);
2. ``score_candidates``: run each candidate (model, operation, fraction)
   through a backend's stage step over length buckets -> ``TaskScores``;
3. ``doc_cost_model``: the token cost model of the dev documents;
4. ``assemble``: Algorithm 2 thresholds, then Algorithm 4 greedy
   assembly under the cost model;
5. ``serve_two_queries``: the assembled cascade and a strict-threshold
   variant registered on one server, fed the test split with Poisson
   arrival stamps and drained.

Every function runs on whatever device the restructurer and the engine
were built on.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from ..core.assembly import AssemblyTrace, greedy_assembly
from ..core.cost_model import CascadeCostModel
from ..core.restructure import DocumentRestructurer, SyntheticOracle
from ..core.tasks import Cascade, Task, TaskConfig, TaskScores
from ..core.thresholds import filter_tasks
from ..data.documents import SyntheticDoc
from ..models.runtime import DeviceLike
from ..serving.engine import CascadeServer, EngineResult
from ..serving.scheduler import make_buckets
from .serve import poisson_arrivals

OPS = {
    "o_orig": "does this opinion overturn a lower court decision",
    "sur_court": "is any lower court mentioned overturn reversed vacated",
    "sur_affirm": "does it say affirmed upheld sustained",
}
FRACTIONS = (0.25, 1.0)
RATES = {"proxy": 0.15e-6, "oracle": 2.50e-6}
ORACLE_NOISE = 0.1      # labeling noise of the restructurer's oracle
ALPHA = 0.85            # accuracy target of Algorithms 2 and 4
MIN_COVERAGE = 0.10     # g of Algorithm 2
STRICT_SHIFT = 0.10     # threshold raise of the strict tenant
ARRIVAL_RATE = 8.0      # Poisson stamps of the served feed, per second
ARRIVAL_SEED = 3


def restructure(docs: Sequence[SyntheticDoc], n_dev: int, *,
                device: DeviceLike = "cuda"
                ) -> Tuple[DocumentRestructurer, Dict[int, str]]:
    """Fit on ``docs[:n_dev]`` for the original operation with a noisy
    ``SyntheticOracle``; return the restructurer and every document's
    reordered text by id, all scored in one ``score_corpus``."""
    restr = DocumentRestructurer(OPS["o_orig"], device=device).fit(
        docs[:n_dev], SyntheticOracle(noise=ORACLE_NOISE))
    return restr, {d.doc_id: r.text
                   for d, r in zip(docs, restr.reorder_corpus(docs))}


def candidate_configs() -> List[TaskConfig]:
    """Proxy candidates: every operation at every fraction."""
    return [TaskConfig("proxy", o, f) for o in OPS for f in FRACTIONS]


def score_candidates(engine: CascadeServer, docs: Mapping[int, str],
                     configs: Sequence[TaskConfig], batch_size: int
                     ) -> Dict[TaskConfig, TaskScores]:
    """Single-stage scores of each candidate over ``docs`` (in key order):
    one ``run_stage`` per length bucket, no thresholds."""
    ids = list(docs)
    pos = {d: k for k, d in enumerate(ids)}
    scores = {}
    for cfg in configs:
        be = engine.backends[cfg.model]
        be.reset()
        toks = {i: np.asarray(be.tokenizer.encode(docs[i]), np.int32)
                for i in ids}
        lens = {i: len(toks[i]) for i in ids}
        op_toks = np.asarray(
            be.tokenizer.encode(engine.operations[cfg.operation]), np.int32)
        pred = np.zeros(len(ids), np.int64)
        conf = np.zeros(len(ids))
        for blen, group in make_buckets(ids, lens, batch_size):
            p, c, *_ = be.run_stage(group, toks, blen, cfg.fraction,
                                    op_toks, engine.n_classes)
            for j, d in enumerate(group):
                pred[pos[d]], conf[pos[d]] = p[j], c[j]
        scores[cfg] = TaskScores(cfg, pred, conf)
    return scores


def doc_cost_model(tokenizer, texts: Sequence[str]) -> CascadeCostModel:
    """Token cost model of ``texts`` under ``OPS`` and ``RATES``."""
    return CascadeCostModel(
        np.asarray([len(tokenizer.encode(t)) for t in texts]),
        {o: len(tokenizer.encode(t)) for o, t in OPS.items()},
        rates=dict(RATES))


def assemble(scores: Mapping[TaskConfig, TaskScores],
             oracle_pred: np.ndarray, cost_model: CascadeCostModel,
             n_classes: int = 2
             ) -> Tuple[List[Task], Cascade, AssemblyTrace]:
    """Algorithm 2 filter, then Algorithm 4 greedy assembly."""
    eligible = filter_tasks(list(scores.values()), oracle_pred, n_classes,
                            alpha=ALPHA, g=MIN_COVERAGE)
    cascade, trace = greedy_assembly(eligible, scores, oracle_pred,
                                     cost_model, n_classes, alpha=ALPHA)
    return eligible, cascade, trace


def strict_variant(cascade: Cascade) -> Cascade:
    """The same task configs under thresholds raised by STRICT_SHIFT."""
    return cascade.with_thresholds([
        {c: min(v + STRICT_SHIFT, 1.0) for c, v in t.thresholds.items()}
        for t in cascade.tasks])


@dataclass
class Served:
    """Results of the two-query session of ``serve_two_queries``."""
    main: EngineResult
    strict: EngineResult
    wall_s: float
    launches: int
    occupancy: float


def serve_two_queries(server: CascadeServer, cascade: Cascade,
                      docs: Mapping[int, str]) -> Served:
    """Register ``cascade`` and its strict variant on a reset server,
    submit every document to both with Poisson arrival stamps, and step
    the shared queue until it is idle."""
    server.reset()
    h_main = server.register(cascade, accuracy_target=ALPHA)
    h_strict = server.register(strict_variant(cascade),
                               accuracy_target=0.95)
    arrivals = poisson_arrivals(sorted(docs), rate=ARRIVAL_RATE,
                                seed=ARRIVAL_SEED)
    t0 = time.perf_counter()
    for d in sorted(docs):
        h_main.submit(d, docs[d], arrival=arrivals[d])
        h_strict.submit(d, docs[d], arrival=arrivals[d])
    while server.pending():
        CascadeServer.step(server)
    wall = time.perf_counter() - t0
    return Served(h_main.result(), h_strict.result(), wall,
                  server.stats().batches, server.occupancy())
