"""Greedy cascade assembly (paper Algorithm 4) + the MSSC reduction (§3.1).

Starting from the empty cascade (oracle-only), greedily append the eligible
task that most reduces total dev-set inference cost, subject to EVERY task
in the candidate cascade holding per-task accuracy >= alpha on the subset
of documents it classifies.  Stops when no append reduces cost.

Also provided:
  * ``selectivity_ordering`` — the (selectivity-1)/cost predicate-ordering
    baseline from §7.1.3 (ablation: 7.5x worse in the paper).
  * ``mssc_instance_to_tasks`` / ``greedy_mssc`` — the §3.1 NP-hardness
    reduction materialized: a MIN-SUM-SET-COVER instance becomes a cascade
    assembly problem; tests verify cascade cost == MSSC objective and the
    greedy 4-approximation bound.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from .cost_model import CascadeCostModel
from .tasks import (Cascade, CascadeResult, Task, TaskConfig, TaskScores,
                    run_cascade)


PER_TASK_MARGIN_Z = 0.25   # small-sample conservatism (paper §3.2.2 notes
                          # per-task enforcement exists to aid generalization)


def per_task_accuracy_ok(res: CascadeResult, cascade: Cascade,
                         scores, oracle_pred: np.ndarray,
                         alpha: float) -> bool:
    """Every task's accuracy on its classified subset >= alpha (with a
    z * sqrt(a(1-a)/n) one-sided buffer against dev-set optimism)."""
    for task, mask in zip(cascade.tasks, res.per_task_classified):
        n = int(mask.sum())
        if n == 0:
            continue
        ts = scores[task.config]
        acc = float(np.mean(ts.pred[mask] == oracle_pred[mask]))
        margin = PER_TASK_MARGIN_Z * np.sqrt(alpha * (1 - alpha) / n)
        if acc < alpha + margin:
            return False
    return True


@dataclass
class AssemblyTrace:
    steps: List[Tuple[str, float]]          # (task key str, cost after)
    considered: int = 0


def greedy_assembly(
    eligible: Sequence[Task],
    scores: Mapping[TaskConfig, TaskScores],
    oracle_pred: np.ndarray,
    cost_model: CascadeCostModel,
    n_classes: int,
    alpha: float,
) -> Tuple[Cascade, AssemblyTrace]:
    """Algorithm 4: greedy min-cost cascade under per-task accuracy."""
    cascade = Cascade([])
    best_cost = run_cascade(cascade, scores, oracle_pred, cost_model,
                            n_classes).total_cost()
    unused = list(eligible)
    trace = AssemblyTrace(steps=[("<oracle-only>", best_cost)])

    while unused:
        best_task: Optional[Task] = None
        best_task_cost = best_cost
        for task in unused:
            cand = cascade.with_task(task)
            res = run_cascade(cand, scores, oracle_pred, cost_model,
                              n_classes)
            trace.considered += 1
            if res.total_cost() >= best_task_cost:
                continue
            if not per_task_accuracy_ok(res, cand, scores, oracle_pred,
                                        alpha):
                continue
            best_task = task
            best_task_cost = res.total_cost()
        if best_task is None:
            break
        cascade = cascade.with_task(best_task)
        best_cost = best_task_cost
        unused = [t for t in unused if t is not best_task]
        trace.steps.append((str(best_task.config.key()), best_cost))
    return cascade, trace


def selectivity_ordering(
    eligible: Sequence[Task],
    scores: Mapping[TaskConfig, TaskScores],
    oracle_pred: np.ndarray,
    cost_model: CascadeCostModel,
    n_classes: int,
    alpha: float,
) -> Cascade:
    """Ablation baseline: order by (selectivity - 1) / cost (Hellerstein-
    style predicate ordering), keeping tasks whose standalone accuracy on
    their classified subset meets alpha."""
    ranked = []
    n = len(oracle_pred)
    for task in eligible:
        ts = scores[task.config]
        tvec = task.threshold_vector(n_classes)
        classified = ts.conf >= tvec[ts.pred]
        if classified.any():
            acc = float(np.mean(ts.pred[classified] ==
                                oracle_pred[classified]))
            if acc < alpha:
                continue
        selectivity = float(np.mean(~classified))   # fraction passed down
        cost, _ = cost_model.task_cost(
            task.config, np.zeros((n,), np.int64))
        rank = (selectivity - 1.0) / max(float(np.mean(cost)), 1e-12)
        ranked.append((rank, task))
    # paper §7.1.3: "prioritizing operations with the HIGHEST
    # (selectivity-1)/cost ratio" — note this inverts Hellerstein's
    # ascending rule and is what makes the baseline pathological (7.5x
    # worse in the paper's Table 3).
    ranked.sort(key=lambda rt: rt[0], reverse=True)
    return Cascade([t for _, t in ranked])


# ---------------------------------------------------------------------------
# §3.1 MSSC reduction
# ---------------------------------------------------------------------------

def mssc_instance_to_scores(
    universe: Sequence[int],
    sets: Sequence[Set[int]],
) -> Tuple[List[Task], Dict[TaskConfig, TaskScores], np.ndarray,
           CascadeCostModel]:
    """Materialize the §3.1 reduction: items -> documents, sets -> tasks.

    Task i predicts TRUE (class 1) with confidence 1 on d_u iff u in S_i,
    and a random answer with confidence 0 otherwise.  Document tokens cost
    0 (fully cached); each operation costs 1 token at unit rate, so running
    any task on any doc costs exactly 1 and the cascade cost of covering
    item u equals the index of the first covering set — the MSSC objective.
    """
    n = len(universe)
    idx = {u: i for i, u in enumerate(universe)}
    oracle_pred = np.ones((n,), np.int64)
    tasks: List[Task] = []
    scores: Dict[TaskConfig, TaskScores] = {}
    rng = np.random.default_rng(0)
    for si, s in enumerate(sets):
        cfg = TaskConfig("proxy", f"set_{si}", 1.0)
        pred = np.where(
            np.isin(np.arange(n), [idx[u] for u in s]),
            1, rng.integers(0, 2, n)).astype(np.int64)
        conf = np.isin(np.arange(n), [idx[u] for u in s]).astype(np.float64)
        scores[cfg] = TaskScores(cfg, pred, conf)
        tasks.append(Task(cfg, {0: 1.0, 1: 1.0}))
    cm = CascadeCostModel(
        doc_tokens=np.zeros((n,), np.int64),
        op_tokens={f"set_{si}": 1 for si in range(len(sets))} | {"o_orig": 0},
        rates={"proxy": 1.0, "oracle": 0.0},
        cached_discount=0.0,
    )
    return tasks, scores, oracle_pred, cm


def greedy_mssc(universe: Set[int], sets: Sequence[Set[int]]) -> Tuple[List[int], int]:
    """Feige et al. greedy for MSSC: pick the set covering most uncovered.

    Returns (order of set indices, total MSSC cost).  4-approximation.
    """
    uncovered = set(universe)
    order: List[int] = []
    cost = 0
    pos = 0
    remaining = list(range(len(sets)))
    while uncovered and remaining:
        pos += 1
        best = max(remaining, key=lambda i: len(sets[i] & uncovered))
        gained = sets[best] & uncovered
        if not gained:
            break
        cost += pos * len(gained)
        uncovered -= gained
        order.append(best)
        remaining.remove(best)
    return order, cost


def brute_force_mssc(universe: Set[int], sets: Sequence[Set[int]]) -> int:
    """Exact MSSC optimum by permutation search (tiny instances only)."""
    import itertools
    best = None
    for perm in itertools.permutations(range(len(sets))):
        uncovered = set(universe)
        cost = 0
        for pos, si in enumerate(perm, start=1):
            gained = sets[si] & uncovered
            cost += pos * len(gained)
            uncovered -= gained
            if not uncovered:
                break
        if uncovered:
            continue
        best = cost if best is None else min(best, cost)
    return best if best is not None else -1
