"""End-to-end task-cascade construction (paper Algorithm 1) + baselines.

``build_task_cascade`` wires the pieces together: initial candidate set
(o_orig x models x fractions) -> agentic loop (assemble -> failure analysis
-> propose surrogates -> extend) -> optional statistical-guarantee pass
(split D_T / D_V, re-assemble on D_T, certify thresholds on D_V).

Baselines for the evaluation tables:
  * ``oracle_only_cost``
  * ``model_cascade``            — 2-Model Cascade (LOTUS-style per-class
                                   combined-accuracy thresholds)
  * variant knobs on BuildConfig — No Surrogates / Single-Iteration /
                                   No Filtering / Restructure(top-25%) /
                                   Selectivity Ordering (see §7.1.3)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .adjust import AdjustResult, adjust_thresholds
from .assembly import greedy_assembly, selectivity_ordering
from .cost_model import CascadeCostModel
from .simulation import FRACTIONS, O_ORIG, SimSubset, SimWorkload
from .surrogate import Agent, AgentContext, SyntheticAgent
from .tasks import (ORACLE, PROXY, Cascade, Task, TaskConfig, TaskScores,
                    run_cascade)
from .thresholds import filter_tasks


@dataclass(frozen=True)
class BuildConfig:
    alpha: float = 0.90
    delta: float = 0.25
    fractions: Tuple[float, ...] = FRACTIONS
    n_s: int = 5
    n_a: int = 3
    g: float = 0.10
    s_max: int = 5
    guarantee: bool = False
    lite: bool = False                  # surrogate candidates: proxy only
    use_surrogates: bool = True
    single_iteration: bool = False      # all surrogates in one batch
    ordering: str = "greedy"            # greedy | selectivity
    seed: int = 0


@dataclass
class BuildOutput:
    cascade: Cascade
    scores: Dict[TaskConfig, TaskScores]
    candidate_configs: List[TaskConfig]
    reverted_to_oracle: bool = False
    adjust: Optional[AdjustResult] = None
    rounds_run: int = 0


def _initial_configs(fractions: Sequence[float]) -> List[TaskConfig]:
    out = []
    for m in (PROXY, ORACLE):
        for f in fractions:
            if m == ORACLE and f == 1.0:
                continue                 # that's the terminal oracle task
            out.append(TaskConfig(m, O_ORIG, f))
    return out


def _eval_all(backend, configs) -> Dict[TaskConfig, TaskScores]:
    return {c: backend.eval_config(c) for c in configs}


def _assemble(backend, configs, cost_model, bc: BuildConfig):
    scores = _eval_all(backend, configs)
    eligible = filter_tasks(list(scores.values()), backend.oracle_pred,
                            backend.n_classes, bc.alpha, bc.g)
    if bc.ordering == "selectivity":
        cascade = selectivity_ordering(
            eligible, scores, backend.oracle_pred, cost_model,
            backend.n_classes, bc.alpha)
        trace = None
    else:
        cascade, trace = greedy_assembly(
            eligible, scores, backend.oracle_pred, cost_model,
            backend.n_classes, bc.alpha)
    return cascade, scores, eligible


def build_task_cascade(
    backend,                           # SimWorkload / SimSubset / LM engine
    bc: BuildConfig = BuildConfig(),
    agent: Optional[Agent] = None,
) -> BuildOutput:
    """Algorithm 1, end to end."""
    rng = np.random.default_rng(bc.seed)
    n = len(backend.oracle_pred)

    if bc.guarantee:
        perm = rng.permutation(n)
        train_idx, val_idx = perm[: n // 2], perm[n // 2:]
        train = backend.subset(train_idx)
        val = backend.subset(val_idx)
    else:
        train, val = backend, None

    if agent is None and bc.use_surrogates:
        agent = SyntheticAgent(
            pattern_coverage=backend.spec.pattern_coverage, seed=bc.seed)

    configs = _initial_configs(bc.fractions)
    cost_model = train.cost_model()

    n_rounds = 1 if (bc.single_iteration or not bc.use_surrogates) else bc.n_a
    n_s = bc.n_s * bc.n_a if bc.single_iteration else bc.n_s

    cascade, scores, eligible = _assemble(train, configs, cost_model, bc)
    best_cost = run_cascade(cascade, scores, train.oracle_pred, cost_model,
                            train.n_classes).total_cost()
    rounds_run = 0

    if bc.use_surrogates:
        previous_ops: List[str] = []
        for r in range(n_rounds):
            rounds_run = r + 1
            res = run_cascade(cascade, scores, train.oracle_pred, cost_model,
                              train.n_classes)
            failures = train.oracle_pred[res.oracle_mask()]
            stats = []
            selected = {t.config for t in cascade.tasks}
            for cfg in configs:
                st = {"config": cfg, "selected": cfg in selected}
                op = train.surrogates.get(cfg.operation)
                if op is not None:
                    st["family"] = op.family
                stats.append(st)
            ctx = AgentContext(
                round=r, failure_labels=failures, task_stats=stats,
                previous_ops=previous_ops, n_classes=train.n_classes)
            new_specs = agent.propose(ctx, n_s)
            for spec in new_specs:
                train.register_surrogate(spec)
                previous_ops.append(spec.op_id)
                models = (PROXY,) if bc.lite else (PROXY, ORACLE)
                for m in models:
                    for f in bc.fractions:
                        configs.append(TaskConfig(m, spec.op_id, f))
            cost_model = train.cost_model()     # new op token entries
            cascade, scores, eligible = _assemble(
                train, configs, cost_model, bc)
            cost = run_cascade(cascade, scores, train.oracle_pred,
                               cost_model, train.n_classes).total_cost()
            if cost >= best_cost * 0.999:
                break
            best_cost = cost

    if not bc.guarantee:
        return BuildOutput(cascade, scores, configs, rounds_run=rounds_run)

    # ---- guarantee pass: certify on the held-out validation split --------
    val_scores = _eval_all(val, [t.config for t in cascade.tasks])
    adj = adjust_thresholds(
        cascade, scores, val_scores, val.oracle_pred, val.cost_model(),
        train.n_classes, bc.alpha, bc.delta, bc.s_max,
        rng=np.random.default_rng(bc.seed + 1))
    if adj.cascade is None:
        return BuildOutput(Cascade([]), scores, configs,
                           reverted_to_oracle=True, adjust=adj,
                           rounds_run=rounds_run)
    return BuildOutput(adj.cascade, scores, configs, adjust=adj,
                       rounds_run=rounds_run)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def model_cascade(
    backend,
    alpha: float,
    *,
    guarantee: bool = False,
    delta: float = 0.25,
    s_max: int = 5,
    seed: int = 0,
) -> BuildOutput:
    """2-Model Cascade baseline (§7.1.2): proxy on the full doc with
    per-class thresholds set so that [proxy-above-t] + [oracle-below-t]
    combined accuracy >= alpha, minimizing cost."""
    rng = np.random.default_rng(seed)
    n = len(backend.oracle_pred)
    if guarantee:
        perm = rng.permutation(n)
        train_idx, val_idx = perm[: n // 2], perm[n // 2:]
        train, val = backend.subset(train_idx), backend.subset(val_idx)
    else:
        train, val = backend, None

    cfg = TaskConfig(PROXY, O_ORIG, 1.0)
    s = train.eval_config(cfg)
    oracle_pred = train.oracle_pred
    thresholds: Dict[int, float] = {}
    for c in range(train.n_classes):
        mask = s.pred == c
        if not mask.any():
            continue
        conf = s.conf[mask]
        correct = (s.pred[mask] == oracle_pred[mask]).astype(np.float64)
        order = np.argsort(conf, kind="stable")
        cs, cc = conf[order], correct[order]
        m = len(cs)
        # combined acc at threshold cs[i]: below-i docs go to the oracle
        # (always "correct" vs itself); above: proxy correctness.
        above_correct = np.cumsum(cc[::-1])[::-1]
        combined = (np.arange(m) + above_correct) / m
        ok = combined >= alpha
        if ok.any():
            thresholds[c] = float(cs[np.argmax(ok)])
    cascade = Cascade([Task(cfg, thresholds)])

    if not guarantee:
        return BuildOutput(cascade, {cfg: s}, [cfg])

    val_scores = {cfg: val.eval_config(cfg)}
    adj = adjust_thresholds(
        cascade, {cfg: s}, val_scores, val.oracle_pred, val.cost_model(),
        train.n_classes, alpha, delta, s_max,
        rng=np.random.default_rng(seed + 1))
    if adj.cascade is None:
        return BuildOutput(Cascade([]), {cfg: s}, [cfg],
                           reverted_to_oracle=True, adjust=adj)
    return BuildOutput(adj.cascade, {cfg: s}, [cfg], adjust=adj)


def restructure_top25(backend, alpha: float) -> BuildOutput:
    """Ablation: proxy(o_orig, f=0.25) -> oracle, thresholds via Alg 2."""
    cfg = TaskConfig(PROXY, O_ORIG, 0.25)
    s = backend.eval_config(cfg)
    from .thresholds import find_task_thresholds
    t = find_task_thresholds(s, backend.oracle_pred, backend.n_classes,
                             alpha, g=0.0)
    cascade = Cascade([t]) if t is not None else Cascade([])
    return BuildOutput(cascade, {cfg: s}, [cfg])


def evaluate_on(backend, out: BuildOutput) -> Dict[str, float]:
    """Run a built cascade on a (test) backend; report accuracy + cost."""
    scores = _eval_all(backend, [t.config for t in out.cascade.tasks])
    cm = backend.cost_model()
    res = run_cascade(out.cascade, scores, backend.oracle_pred, cm,
                      backend.n_classes)
    n = len(backend.oracle_pred)
    return {
        "accuracy": res.accuracy(backend.oracle_pred),
        "total_cost": res.total_cost(),
        "cost_per_doc": res.total_cost() / n,
        "oracle_cost": cm.oracle_only_cost(),
        "oracle_frac": float(np.mean(res.oracle_mask())),
        "n_tasks": len(out.cascade.tasks),
    }
