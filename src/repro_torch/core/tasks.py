"""Task-cascade datatypes (paper §2.1) and the vectorized dev-set executor.

A *task config* is (model, operation, fraction); a *task* adds per-class
confidence thresholds; a *cascade* is an ordered task sequence with the
oracle task (m_oracle, o_orig, f=1, no thresholds) implicit at the end.

``TaskScores`` holds a task config's predictions + confidences on the dev
set — the interface between cascade construction (this package) and
whatever produced the scores (the LM serving engine or the calibrated
simulator).  ``run_cascade`` executes a cascade over score matrices in a
fully vectorized way (no per-document Python loop over D_dev).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

ORACLE = "oracle"
PROXY = "proxy"


@dataclass(frozen=True)
class TaskConfig:
    model: str                      # "proxy" | "oracle" (or an arch id)
    operation: str                  # operation id; "o_orig" is the original
    fraction: float                 # document fraction f in (0, 1]

    def key(self) -> Tuple[str, str, float]:
        return (self.model, self.operation, self.fraction)


@dataclass(frozen=True)
class Task:
    config: TaskConfig
    # per-class threshold; classes absent -> infinity (never exit on them)
    thresholds: Mapping[int, float]

    def threshold_vector(self, n_classes: int) -> np.ndarray:
        t = np.full((n_classes,), np.inf)
        for c, v in self.thresholds.items():
            t[c] = v
        return t


@dataclass(frozen=True)
class TaskScores:
    """A task config's behaviour on the dev set."""
    config: TaskConfig
    pred: np.ndarray                # [N] int class predictions
    conf: np.ndarray                # [N] float confidence of pred

    def __post_init__(self):
        assert self.pred.shape == self.conf.shape


@dataclass
class Cascade:
    tasks: List[Task] = field(default_factory=list)

    def configs(self) -> List[TaskConfig]:
        return [t.config for t in self.tasks]

    def stage_entries(
        self, n_classes: int, oracle_model: str = ORACLE,
        oracle_op: str = "o_orig",
    ) -> List[Tuple[str, str, float, Optional[np.ndarray]]]:
        """Serving-stage table: ``(model, op, fraction, thresholds|None)``
        per task plus the implicit oracle fall-through (no thresholds, so
        every document resolves).  This is what a serving query handle
        walks its stage cursor over — the bridge between cascade
        construction and the multi-tenant server."""
        return [
            (t.config.model, t.config.operation, t.config.fraction,
             t.threshold_vector(n_classes))
            for t in self.tasks
        ] + [(oracle_model, oracle_op, 1.0, None)]

    def with_task(self, task: Task) -> "Cascade":
        return Cascade(self.tasks + [task])

    def with_thresholds(self, new_thresholds: List[Mapping[int, float]]
                        ) -> "Cascade":
        assert len(new_thresholds) == len(self.tasks)
        return Cascade([
            Task(t.config, th) for t, th in zip(self.tasks, new_thresholds)])

    def __len__(self) -> int:
        return len(self.tasks)


@dataclass
class CascadeResult:
    """Vectorized execution record of a cascade on N documents."""
    exit_stage: np.ndarray          # [N] int; len(tasks) means oracle
    pred: np.ndarray                # [N] final prediction
    cost: np.ndarray                # [N] per-document $ cost
    per_task_classified: List[np.ndarray]   # boolean [N] mask per task

    def accuracy(self, oracle_pred: np.ndarray) -> float:
        return float(np.mean(self.pred == oracle_pred))

    def total_cost(self) -> float:
        return float(np.sum(self.cost))

    def oracle_mask(self) -> np.ndarray:
        return self.exit_stage == len(self.per_task_classified)


def run_cascade(
    cascade: Cascade,
    scores: Mapping[TaskConfig, TaskScores],
    oracle_pred: np.ndarray,
    cost_model: "CascadeCostModel",
    n_classes: int,
) -> CascadeResult:
    """Execute ``cascade`` on the dev set (vectorized).

    Documents exit at the first task whose predicted-class confidence clears
    that task's class threshold; the rest fall through to the oracle task.
    """
    n = len(oracle_pred)
    exit_stage = np.full((n,), len(cascade.tasks), np.int64)
    pred = oracle_pred.copy()
    unresolved = np.ones((n,), bool)
    per_task_classified: List[np.ndarray] = []

    for si, task in enumerate(cascade.tasks):
        ts = scores[task.config]
        tvec = task.threshold_vector(n_classes)
        passes = ts.conf >= tvec[ts.pred]
        takes = unresolved & passes
        exit_stage[takes] = si
        pred[takes] = ts.pred[takes]
        per_task_classified.append(takes)
        unresolved &= ~takes

    cost = cost_model.cascade_cost(cascade.configs(), exit_stage)
    return CascadeResult(exit_stage, pred, cost, per_task_classified)
