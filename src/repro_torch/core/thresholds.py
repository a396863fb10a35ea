"""Per-task threshold selection and filtering (paper Algorithm 2).

For each candidate task and each class c: find the LOWEST confidence
threshold t such that predictions of class c with confidence >= t have
accuracy >= alpha on the dev set (vs the oracle).  If no t works the class
is disabled (tau_c = inf).  A task survives filtering iff the selected
thresholds let it classify at least g * |D_dev| documents.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .tasks import Task, TaskScores

DEFAULT_G = 0.10


MIN_SUPPORT = 5   # suffix sets smaller than this are too noisy to trust


def select_class_threshold(conf: np.ndarray, correct: np.ndarray,
                           alpha: float) -> Optional[float]:
    """Lowest t with accuracy(conf >= t) >= alpha, or None.

    conf/correct restricted to documents predicted as the class in question.
    Scans unique confidences ascending (paper's loop); vectorized via suffix
    means over the sorted order.
    """
    if conf.size == 0:
        return None
    order = np.argsort(conf, kind="stable")
    cs = conf[order]
    cc = correct[order].astype(np.float64)
    # suffix accuracy starting at index i (threshold = cs[i])
    suffix_correct = np.cumsum(cc[::-1])[::-1]
    suffix_count = np.arange(len(cs), 0, -1)
    suffix_acc = suffix_correct / suffix_count
    # first index of each unique threshold value
    uniq_first = np.ones(len(cs), bool)
    uniq_first[1:] = cs[1:] != cs[:-1]
    ok = uniq_first & (suffix_acc >= alpha) & (suffix_count >= MIN_SUPPORT)
    idx = np.argmax(ok) if ok.any() else -1
    if idx < 0:
        return None
    return float(cs[idx])


def find_task_thresholds(
    scores: TaskScores,
    oracle_pred: np.ndarray,
    n_classes: int,
    alpha: float,
    g: float = DEFAULT_G,
) -> Optional[Task]:
    """Algorithm 2: thresholds for one candidate task, or None to discard."""
    thresholds: Dict[int, float] = {}
    total = 0
    correct = scores.pred == oracle_pred
    for c in range(n_classes):
        mask = scores.pred == c
        t = select_class_threshold(scores.conf[mask], correct[mask], alpha)
        if t is None:
            continue
        thresholds[c] = t
        total += int(np.sum(mask & (scores.conf >= t)))
    if total >= g * len(oracle_pred) and thresholds:
        return Task(scores.config, thresholds)
    return None


def filter_tasks(
    all_scores: Sequence[TaskScores],
    oracle_pred: np.ndarray,
    n_classes: int,
    alpha: float,
    g: float = DEFAULT_G,
):
    """Apply Algorithm 2 over the candidate set; keep survivors."""
    out = []
    for s in all_scores:
        t = find_task_thresholds(s, oracle_pred, n_classes, alpha, g)
        if t is not None:
            out.append(t)
    return out
