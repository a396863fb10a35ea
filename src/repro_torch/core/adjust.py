"""Threshold adjustment with statistical guarantees (paper Alg. 3 + 5).

Splits D_dev into i.i.d. halves D_T (construction) / D_V (certification).
For each (task, class) a *shift list* of candidate thresholds is built from
the confidences observed on D_T strictly above the base threshold tau_c:

    shift s = s_max  -> most conservative (s-th confidence above tau_c)
    shift s = 0      -> the original tau_c

The loop walks s from s_max down to 0, re-runs the cascade on D_V at each
shift, and applies the WSR estimator; it returns the LEAST conservative
shift whose predecessors all certified, stopping at the first failure
(Algorithm 5's early-exit).  The estimator budget is union-bounded over the
(s_max + 1) applications so total failure stays <= delta.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .estimator import wsr_certify
from .tasks import Cascade, CascadeResult, TaskConfig, TaskScores, run_cascade

S_MAX = 5


def build_shift_lists(
    cascade: Cascade,
    train_scores: Mapping[TaskConfig, TaskScores],
    n_classes: int,
    s_max: int = S_MAX,
) -> List[Dict[int, List[float]]]:
    """Per task, per class: [tau_c, p_1, ..., p_s_max] ascending.

    §3.2.3 requires the initial offset to be "large ... highly
    conservative", so the p_i are QUANTILE-spaced over the confidences
    observed above tau_c on D_T: p_{s_max} sits at the top of the observed
    distribution (almost nothing exits -> near-oracle accuracy), p_1 just
    above tau_c.  With the API-style confidences of the paper (few unique
    values concentrated near 1) this coincides with their next-k-values
    construction; with smooth confidences it preserves the intended
    conservative-to-original sweep.
    """
    out = []
    for task in cascade.tasks:
        ts = train_scores[task.config]
        lists: Dict[int, List[float]] = {}
        for c, tau in task.thresholds.items():
            above = np.sort(ts.conf[(ts.pred == c) & (ts.conf > tau)])
            if len(above) == 0:
                lists[c] = [float(tau)]
                continue
            # power-2 spacing: dense near tau (cheap shifts), coarse at the
            # conservative end — the walk-down usually stops in the dense
            # region, keeping certified cascades close to the base cost.
            qs = [float(np.quantile(above, (i / s_max) ** 2))
                  for i in range(1, s_max + 1)]
            lists[c] = [float(tau)] + qs
        out.append(lists)
    return out


def thresholds_at_shift(
    shift_lists: Sequence[Dict[int, List[float]]],
    s: int,
) -> List[Dict[int, float]]:
    """Thresholds with shift index s (s beyond list length disables class)."""
    out = []
    for lists in shift_lists:
        th: Dict[int, float] = {}
        for c, plist in lists.items():
            th[c] = plist[s] if s < len(plist) else float("inf")
        out.append(th)
    return out


@dataclass
class AdjustResult:
    cascade: Optional[Cascade]      # None -> revert to oracle-only
    shift: int                      # selected shift index
    certified: bool
    history: List[Tuple[int, bool, float]]  # (shift, certified, acc on D_V)


def adjust_thresholds(
    cascade: Cascade,
    train_scores: Mapping[TaskConfig, TaskScores],
    val_scores: Mapping[TaskConfig, TaskScores],
    val_oracle_pred: np.ndarray,
    cost_model,
    n_classes: int,
    alpha: float,
    delta: float,
    s_max: int = S_MAX,
    rng: Optional[np.random.Generator] = None,
) -> AdjustResult:
    """Algorithm 3/5: certified threshold selection on the validation split."""
    if len(cascade.tasks) == 0:
        return AdjustResult(cascade, 0, True, [])
    shift_lists = build_shift_lists(cascade, train_scores, n_classes, s_max)
    # No union bound over shifts is needed (paper Thm 3.2 proof): the loop
    # stops at the FIRST failing estimate, so a bad threshold is returned
    # only if E certifies the single first-truly-bad candidate t_{i*} —
    # one event, probability <= delta by Lemma A.1.
    delta_each = delta
    rng = rng or np.random.default_rng(0)
    # fixed random presentation order for the martingale (i.i.d. requirement)
    order = rng.permutation(len(val_oracle_pred))

    best: Optional[Cascade] = None
    best_shift = -1
    history: List[Tuple[int, bool, float]] = []
    for s in range(s_max, -1, -1):
        cand = cascade.with_thresholds(thresholds_at_shift(shift_lists, s))
        res = run_cascade(cand, val_scores, val_oracle_pred, cost_model,
                          n_classes)
        x = (res.pred == val_oracle_pred).astype(np.float64)[order]
        ok = wsr_certify(x, alpha, delta_each)
        history.append((s, ok, float(np.mean(x))))
        if ok:
            best, best_shift = cand, s
        else:
            break
    if best is None:
        return AdjustResult(None, -1, False, history)
    return AdjustResult(best, best_shift, True, history)
