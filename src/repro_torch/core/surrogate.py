"""Surrogate operation generation: agent interface + agentic loop (§5, Alg 6).

The agent is an interface: production deployments plug an LLM; offline we
ship two implementations —

``SyntheticAgent``  proposes surrogate *specs* against the calibrated
    simulator.  It is deliberately imperfect: proposal quality is sampled
    (some surrogates are weak and get filtered by Algorithm 2), and
    refinement works exactly as in the paper — each round sees the current
    cascade's failure cases and per-task statistics, biases target classes
    toward what the oracle says about the failures, probes *new* pattern
    families, and sharpens strength estimates for families that tested well.

``ScriptedAgent``   replays a fixed proposal list (deterministic tests).

Both emit the paper's four surrogate types: keyword, class-specific,
semantic-pattern, and sequential-decomposition (Appendix C taxonomy).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from .simulation import N_FAMILIES, SurrogateSpec
from .tasks import Cascade, TaskConfig

KINDS = ("keyword", "class_specific", "semantic", "decomposition")


@dataclass
class AgentContext:
    """What the agent sees each round (Alg 6 lines 4-8)."""
    round: int
    failure_labels: np.ndarray              # oracle labels of unresolved docs
    task_stats: List[Dict]                  # per candidate: selected, coverage
    previous_ops: List[str]
    n_classes: int


class Agent(Protocol):
    def propose(self, ctx: AgentContext, n_s: int) -> List[SurrogateSpec]:
        ...


@dataclass
class SyntheticAgent:
    """Stochastic surrogate proposer over the simulator's latent families."""

    pattern_coverage: float                  # workload ceiling
    seed: int = 0
    _counter: int = 0
    _family_quality: Dict[int, float] = field(default_factory=dict)

    def propose(self, ctx: AgentContext, n_s: int) -> List[SurrogateSpec]:
        rng = np.random.default_rng(self.seed + 7919 * ctx.round)
        out: List[SurrogateSpec] = []
        # target the classes the cascade is failing on
        if len(ctx.failure_labels):
            counts = np.bincount(ctx.failure_labels,
                                 minlength=ctx.n_classes).astype(float)
            class_p = (counts + 0.5) / (counts + 0.5).sum()   # smoothed
        else:
            class_p = np.full(ctx.n_classes, 1.0 / ctx.n_classes)

        used_families = {
            st["family"] for st in ctx.task_stats if "family" in st}
        good_families = {
            st["family"] for st in ctx.task_stats
            if st.get("selected") and "family" in st}

        for j in range(n_s):
            self._counter += 1
            kind = KINDS[int(rng.integers(0, len(KINDS)))]
            # refinement: revisit families that tested well, else explore
            if good_families and rng.random() < 0.4:
                family = int(rng.choice(sorted(good_families)))
                strength_bonus = 0.15
            else:
                fresh = [f for f in range(N_FAMILIES)
                         if f not in used_families]
                family = int(rng.choice(fresh)) if fresh \
                    else int(rng.integers(0, N_FAMILIES))
                strength_bonus = 0.0
            if kind == "decomposition":
                targets = tuple(range(ctx.n_classes))
            elif kind == "class_specific":
                targets = (int(rng.choice(ctx.n_classes, p=class_p)),)
            else:
                k = int(rng.integers(1, max(ctx.n_classes // 2, 1) + 1))
                targets = tuple(sorted(rng.choice(
                    ctx.n_classes, size=k, replace=False,
                    p=class_p).tolist()))
            # quality is noisy: later rounds are better (test-and-refine),
            # but bad proposals still happen and must be filtered
            base_strength = rng.beta(2.5 + ctx.round + 4 * strength_bonus, 2.0)
            coverage = self.pattern_coverage * rng.beta(6.0, 2.0)
            false_fire = float(rng.beta(1.2, 28.0))
            out.append(SurrogateSpec(
                op_id=f"sur_{self._counter}_{kind}",
                kind=kind,
                target_classes=targets,
                coverage=float(coverage),
                strength=float(np.clip(base_strength, 0.3, 0.99)),
                false_fire=false_fire,
                op_tokens=int(rng.integers(16, 48)),
                family=family,
            ))
        return out


@dataclass
class ScriptedAgent:
    """Deterministic agent for tests: replays ``specs`` n_s at a time."""
    specs: List[SurrogateSpec]
    _pos: int = 0

    def propose(self, ctx: AgentContext, n_s: int) -> List[SurrogateSpec]:
        out = self.specs[self._pos:self._pos + n_s]
        self._pos += len(out)
        return out
