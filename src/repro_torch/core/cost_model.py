"""Cost models (paper §2.1 inference cost, §6 optimization cost).

Inference cost with prefix caching: the document rides *before* the
operation in every prompt, so two tasks on the same model share the cached
document prefix; extending the fraction from f_j to f_i > f_j pays the
cached rate on |x_{f_j}| and the full rate only on the new suffix.

    Cost(T_i, x) = |x_cached| λ_cached(m) + |x_new| λ_in(m) + |o_i| λ_in(m)

``cascade_cost`` evaluates this for every document simultaneously, walking
the cascade stage list once (cost accrues up to each document's exit
stage).  On the serving plane the same arithmetic has a physical twin:
cached tokens == KV-prefix reuse (``extend`` path), and λ ratios are
replaced by measured FLOP/byte terms; see ``serving/engine.py``.

Optimization cost (§6): C_opt = C_doc + C_eval + C_agent, with the paper's
closed forms, used by the break-even benchmark (Table 4).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Sequence

import numpy as np

from .tasks import ORACLE, PROXY, TaskConfig

# OpenAI pricing used in the paper (USD per token)
DEFAULT_RATES = {
    ORACLE: 2.50e-6,      # GPT-4o input
    PROXY: 0.15e-6,       # GPT-4o-mini input
}
CACHED_DISCOUNT = 0.5     # 50% prefix-cache discount
EMBED_RATE = 0.02e-6      # text-embedding-3-small
AGENT_RATES = (1.10e-6, 4.40e-6)   # o1-mini (in, out)


@dataclass
class CascadeCostModel:
    """Per-document-token cost accounting for a fixed document set."""

    doc_tokens: np.ndarray                    # [N] tokens per full document
    op_tokens: Mapping[str, int]              # operation id -> prompt tokens
    rates: Mapping[str, float] = field(default_factory=lambda: dict(DEFAULT_RATES))
    cached_discount: float = CACHED_DISCOUNT

    def frac_tokens(self, fraction: float) -> np.ndarray:
        return np.ceil(self.doc_tokens * fraction).astype(np.int64)

    def task_cost(self, cfg: TaskConfig, cached: np.ndarray) -> np.ndarray:
        """Vector cost of running ``cfg`` given per-doc cached token counts
        for cfg.model.  Returns (cost [N], new cached [N])."""
        lam = self.rates[cfg.model]
        ft = self.frac_tokens(cfg.fraction)
        cached_part = np.minimum(ft, cached)
        new_part = np.maximum(ft - cached, 0)
        cost = (cached_part * lam * self.cached_discount
                + new_part * lam
                + self.op_tokens[cfg.operation] * lam)
        return cost, np.maximum(cached, ft)

    def cascade_cost(self, configs: Sequence[TaskConfig],
                     exit_stage: np.ndarray) -> np.ndarray:
        """Per-document cost of a cascade run.

        ``exit_stage[i] == s`` means doc i exits at stage s (s == len(configs)
        -> falls through to the oracle task on the full document).
        """
        n = len(exit_stage)
        cached: Dict[str, np.ndarray] = {}
        cost = np.zeros((n,), np.float64)
        for si, cfg in enumerate(configs):
            active = exit_stage >= si
            c = cached.setdefault(cfg.model, np.zeros((n,), np.int64))
            stage_cost, new_cached = self.task_cost(cfg, c)
            cost += np.where(active, stage_cost, 0.0)
            cached[cfg.model] = np.where(active, new_cached, c)
        # oracle fallthrough on the full document
        oracle_cfg = TaskConfig(ORACLE, "o_orig", 1.0)
        active = exit_stage >= len(configs)
        c = cached.setdefault(ORACLE, np.zeros((n,), np.int64))
        stage_cost, _ = self.task_cost(oracle_cfg, c)
        cost += np.where(active, stage_cost, 0.0)
        return cost

    def oracle_only_cost(self) -> float:
        oracle_cfg = TaskConfig(ORACLE, "o_orig", 1.0)
        cost, _ = self.task_cost(oracle_cfg, np.zeros_like(self.doc_tokens))
        return float(np.sum(cost))


# ---------------------------------------------------------------------------
# Optimization (offline) cost — paper §6
# ---------------------------------------------------------------------------

@dataclass
class OptimizationCost:
    """Closed-form optimization cost C_opt = C_doc + C_eval + C_agent."""

    n_dev: int                       # N
    avg_doc_tokens: float            # L
    prompt_tokens: float             # P
    fractions: Sequence[float]       # F
    n_s: int = 5
    n_a: int = 3
    rates: Mapping[str, float] = field(default_factory=lambda: dict(DEFAULT_RATES))
    embed_rate: float = EMBED_RATE
    agent_in_tokens: float = 20_000.0
    agent_out_tokens: float = 2_000.0
    lite: bool = False               # exclude oracle from candidate evals

    def c_labels(self) -> float:
        return self.n_dev * (self.avg_doc_tokens + self.prompt_tokens) \
            * self.rates[ORACLE]

    def c_doc(self) -> float:
        return (self.n_dev * (self.avg_doc_tokens + self.prompt_tokens)
                * 2 * self.rates[ORACLE]
                + self.n_dev * self.avg_doc_tokens * self.embed_rate)

    def c_eval(self) -> float:
        s_f = float(sum(self.fractions))
        lam = self.rates[PROXY] if self.lite \
            else self.rates[ORACLE] + self.rates[PROXY]
        return self.n_dev * self.n_s * self.n_a * (
            self.avg_doc_tokens * s_f * lam
            + self.prompt_tokens * len(self.fractions) * lam)

    def c_agent(self) -> float:
        lin, lout = AGENT_RATES
        return self.n_a * (self.agent_in_tokens * lin
                           + self.agent_out_tokens * lout)

    def total(self) -> float:
        return self.c_doc() + self.c_eval() + self.c_agent()

    def model_cascade_cost(self) -> float:
        """2-Model Cascade optimization: proxy + oracle pass over dev set."""
        lam = self.rates[ORACLE] + self.rates[PROXY]
        return self.n_dev * (self.avg_doc_tokens + self.prompt_tokens) * lam


def break_even_docs(opt_cost: float, per_doc_cost: float,
                    oracle_per_doc: float) -> float:
    """Documents until opt_cost + n*c_method < n*c_oracle."""
    gain = oracle_per_doc - per_doc_cost
    return float("inf") if gain <= 0 else opt_cost / gain
