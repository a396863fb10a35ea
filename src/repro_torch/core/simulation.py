"""Calibrated synthetic workloads + LLM behaviour simulator.

The paper's evaluation runs against OpenAI APIs on eight document
workloads.  Offline, we reproduce the *regime* with a seeded generative
model calibrated to Table 2/3: per-workload document-length distributions,
class counts, proxy/oracle accuracy gaps, pattern (surrogate) coverage, and
confidence miscalibration ("scores heavily concentrated near 1", §3.2.4).

Latent document state (per doc i):
    y_i          true class
    delta_i      difficulty in [0,1] (Beta; most docs easy)
    n_tokens_i   LogNormal around the workload's avg words x 1.3
    rel_pos_i    positions of relevant chunks (uniform; small count)
    u_i[s]       per-surrogate-family uniform (pattern presence)

Model behaviour for task (m, o, f):
    coverage     fraction of relevant chunks inside the top-f of the
                 (re)ordered document — restructuring quality moves
                 relevant chunks to the front with prob ``reorder_recall``
    p_correct    logistic in (model skill, 1 - difficulty, coverage)
    pred         y_i w.p. p_correct else a wrong class
    conf         sigmoid(logit(p_correct) + N(0, conf_noise)) — correlated
                 with correctness but miscalibrated, concentrated near 1

All randomness is a pure function of (workload seed, doc index, config),
so repeated evaluation of a config returns identical scores (the cascade
builder re-executes candidates hundreds of times) and every experiment is
reproducible.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .cost_model import CascadeCostModel
from .tasks import ORACLE, PROXY, TaskConfig, TaskScores

O_ORIG = "o_orig"
FRACTIONS = (0.1, 0.25, 0.5, 1.0)


# ---------------------------------------------------------------------------
# Surrogate operation spec (what the simulator needs to "execute" one)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SurrogateSpec:
    op_id: str
    kind: str                        # keyword | class_specific | semantic | decomposition
    target_classes: Tuple[int, ...]  # classes it can emit
    coverage: float                  # P(pattern present | doc in target class)
    strength: float                  # P(detected | present & visible); proxy skill on it
    false_fire: float                # P(fires wrongly on non-target docs)
    op_tokens: int = 24
    family: int = 0                  # latent pattern family (ties presence
                                     # across surrogates probing the same cue)


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    n_classes: int
    avg_words: float
    corpus_size: int
    proxy_skill: float               # logit-scale skill on o_orig
    oracle_skill: float
    easy_frac: float                 # fraction of "easy" docs (controls the
                                     # selective-classification keep rate)
    relevance_spread: float          # 0 = concentrated, 1 = uniform relevance
    pattern_coverage: float          # max coverage achievable by surrogates
    reorder_recall: float            # learned-restructuring front-load quality
    rag_recall: float                # naive-RAG front-load quality (lower)
    conf_noise: float = 0.50
    cov_coef: float = 3.5            # logit penalty slope for missing context
    surrogate_reliability: float = 1.0   # scales surrogate fire correctness
    op_tokens: int = 60              # |o_orig| prompt tokens
    seed: int = 0


# Table 2 + observed Table 3 behaviour, compressed into generator knobs.
# easy_frac is set so the 2-Model Cascade baseline's escalation fraction at
# alpha=0.9 lands near the paper's implied values (MC$/oracle$ - proxy rate).
WORKLOADS: Dict[str, WorkloadSpec] = {
    "agnews": WorkloadSpec("agnews", 4, 37, 128_000, proxy_skill=3.4,
                           oracle_skill=4.0, easy_frac=0.97,
                           relevance_spread=0.9, pattern_coverage=0.45,
                           reorder_recall=0.55, rag_recall=0.50,
                           cov_coef=3.5, seed=11),
    "court": WorkloadSpec("court", 2, 3_700, 36_000, proxy_skill=2.2,
                          oracle_skill=3.4, easy_frac=0.74,
                          relevance_spread=0.25, pattern_coverage=0.60,
                          reorder_recall=0.88, rag_recall=0.55,
                          cov_coef=3.0, seed=12),
    "enron": WorkloadSpec("enron", 2, 1_500, 500_000, proxy_skill=3.6,
                          oracle_skill=4.0, easy_frac=0.96,
                          relevance_spread=0.15, pattern_coverage=0.85,
                          reorder_recall=0.97, rag_recall=0.70,
                          cov_coef=1.5, seed=13),
    "fever": WorkloadSpec("fever", 2, 5_100, 185_000, proxy_skill=3.3,
                          oracle_skill=3.9, easy_frac=0.96,
                          relevance_spread=0.75, pattern_coverage=0.18,
                          reorder_recall=0.80, rag_recall=0.45,
                          cov_coef=3.0, surrogate_reliability=0.75, seed=14),
    "games": WorkloadSpec("games", 2, 1_100, 6_400_000, proxy_skill=2.4,
                          oracle_skill=3.4, easy_frac=0.80,
                          relevance_spread=0.45, pattern_coverage=0.20,
                          reorder_recall=0.80, rag_recall=0.55, conf_noise=0.8,
                          cov_coef=3.5, surrogate_reliability=0.90, seed=15),
    "legal": WorkloadSpec("legal", 2, 8_000, 510, proxy_skill=2.0,
                          oracle_skill=3.4, easy_frac=0.70,
                          relevance_spread=0.10, pattern_coverage=0.70,
                          reorder_recall=0.90, rag_recall=0.60,
                          cov_coef=2.5, seed=16),
    "pubmed": WorkloadSpec("pubmed", 6, 3_100, 133_000, proxy_skill=3.5,
                           oracle_skill=4.0, easy_frac=0.96,
                           relevance_spread=0.35, pattern_coverage=0.35,
                           reorder_recall=0.85, rag_recall=0.55,
                           cov_coef=3.0, seed=17),
    "wiki_talk": WorkloadSpec("wiki_talk", 2, 900, 125_000, proxy_skill=3.4,
                              oracle_skill=3.9, easy_frac=0.95,
                              relevance_spread=0.40, pattern_coverage=0.30,
                              reorder_recall=0.70, rag_recall=0.55,
                              cov_coef=2.5, seed=18),
}

WORDS_PER_TOKEN = 0.75
N_REL_CHUNKS = 3
N_FAMILIES = 8        # latent pattern families per workload


def _unit(seed: int, *keys) -> np.ndarray:
    """Deterministic uniforms from a hash of (seed, keys).  Last key may be
    an int n -> returns n values."""
    *tags, n = keys
    h = hashlib.blake2b(
        ("|".join(map(str, (seed,) + tuple(tags)))).encode(),
        digest_size=8).digest()
    rng = np.random.default_rng(int.from_bytes(h, "little"))
    return rng.random(n)


@dataclass
class SimWorkload:
    """A sampled document set + deterministic model simulator."""

    spec: WorkloadSpec
    n_docs: int
    reorder_mode: str = "learned"    # learned | rag | none
    _score_cache: Dict[Tuple, TaskScores] = field(default_factory=dict)
    surrogates: Dict[str, SurrogateSpec] = field(default_factory=dict)

    def __post_init__(self):
        s = self.spec
        rng = np.random.default_rng(s.seed)
        n = self.n_docs
        self.y = rng.integers(0, s.n_classes, n)
        # difficulty mixture: most docs easy, a hard tail the proxy cannot
        # confidently resolve (controls the risk-coverage curve)
        is_easy = rng.random(n) < s.easy_frac
        self.difficulty = np.where(
            is_easy, rng.beta(1.0, 20.0, n), rng.beta(6.0, 2.0, n))
        avg_tokens = s.avg_words / WORDS_PER_TOKEN
        self.doc_tokens = np.maximum(
            rng.lognormal(np.log(avg_tokens), 0.5, n), 16).astype(np.int64)
        # relevant chunk positions as quantiles in [0, 1]
        conc = max(s.relevance_spread, 0.02)
        self.rel_pos = rng.random((n, N_REL_CHUNKS)) ** (1.0 / conc) \
            if conc < 1.0 else rng.random((n, N_REL_CHUNKS))
        # pattern-family presence per doc
        self.family_u = rng.random((n, N_FAMILIES))
        # oracle full-doc predictions ARE the accuracy target
        self.oracle_pred = self._predict(
            ORACLE, O_ORIG, 1.0, force_exact=True)[0]

    # ------------------------------------------------------------- coverage
    def _recall(self) -> float:
        s = self.spec
        return {"learned": s.reorder_recall, "rag": s.rag_recall,
                "none": -1.0}[self.reorder_mode]

    def coverage(self, fraction: float) -> np.ndarray:
        """Fraction of relevant chunks visible in the top-f of the doc."""
        if fraction >= 1.0:
            return np.ones((self.n_docs,))
        recall = self._recall()
        if recall < 0:
            # no reordering: chunk visible iff its natural position < f
            vis = self.rel_pos < fraction
        else:
            # reordered: a relevant chunk lands in front w.p. recall,
            # mildly degraded at tiny fractions (front-of-front ranking
            # noise); else it stays at its natural position
            eff = recall * (fraction ** 0.05)
            u = _unit(self.spec.seed, "reorder", self.reorder_mode,
                      self.n_docs * N_REL_CHUNKS).reshape(
                self.n_docs, N_REL_CHUNKS)
            vis = (u < eff) | (self.rel_pos < fraction)
        return vis.mean(axis=1)

    # ------------------------------------------------------------- predict
    def _conf(self, p_correct: np.ndarray, tag: str) -> np.ndarray:
        s = self.spec
        z = np.log(np.maximum(p_correct, 1e-6)
                   / np.maximum(1 - p_correct, 1e-6))
        noise = np.asarray(_unit(s.seed, "confn", tag, self.n_docs))
        gauss = np.sqrt(2.0) * _erfinv(2 * noise - 1)
        conf = 1.0 / (1.0 + np.exp(-(z + s.conf_noise * gauss)))
        return np.clip(conf, 1.0 / s.n_classes, 1.0)

    def _predict(self, model: str, op: str, fraction: float,
                 force_exact: bool = False):
        s = self.spec
        skill = s.oracle_skill if model == ORACLE else s.proxy_skill
        cov = self.coverage(fraction)
        if op == O_ORIG:
            z = skill * (1.0 - 2.0 * self.difficulty) + s.cov_coef * (cov - 1.0)
            p = 1.0 / (1.0 + np.exp(-z))
            p = np.maximum(p, 1.0 / s.n_classes + 0.02)   # chance floor
            if force_exact:
                pred = np.where(
                    _unit(s.seed, "oracle_gt", self.n_docs) < p,
                    self.y, self._wrong(self.y, "oracle_gt_w"))
                return pred, np.ones((self.n_docs,))
            u = _unit(s.seed, "pred", model, op, fraction, self.n_docs)
            # "correct" = matches the oracle full-doc label
            target = self.oracle_pred
            pred = np.where(u < p, target, self._wrong(target, f"{model}{op}{fraction}"))
            conf = self._conf(p, f"{model}|{op}|{fraction}")
            return pred, conf
        # surrogate operation
        spec = self.surrogates[op]
        present = self.family_u[:, spec.family] < spec.coverage
        in_target = np.isin(self.oracle_pred, spec.target_classes)
        visible = cov > 0.45            # the pattern sits in relevant chunks
        eff = skill - s.proxy_skill if model == PROXY else 1.5
        fire_p = np.where(
            present & in_target & visible,
            spec.strength * (1.0 / (1.0 + np.exp(-(2.5 + eff)))),
            spec.false_fire)
        u = _unit(s.seed, "fire", model, op, fraction, self.n_docs)
        fires = u < fire_p
        # when it fires, it emits (mostly) the right target class
        right_p = (0.93 + 0.06 * spec.strength) \
            * (0.82 + 0.18 * s.surrogate_reliability)
        u2 = _unit(s.seed, "right", model, op, fraction, self.n_docs)
        tc = np.asarray(spec.target_classes)
        tgt_match = np.where(in_target, self.oracle_pred,
                             tc[(_unit(s.seed, "tclass", op,
                                       self.n_docs) * len(tc)).astype(int)])
        pred_fire = np.where(u2 < right_p, tgt_match,
                             self._wrong(tgt_match, f"sf{op}"))
        pred_nofire = self._wrong(self.oracle_pred, f"nf{op}{model}{fraction}")
        pred = np.where(fires, pred_fire, pred_nofire)
        p_conf = np.where(fires, np.where(u2 < right_p, 0.95, 0.70), 0.25)
        conf = self._conf(p_conf, f"{model}|{op}|{fraction}")
        return pred, conf

    def _wrong(self, target: np.ndarray, tag: str) -> np.ndarray:
        s = self.spec
        u = _unit(s.seed, "wrong", tag, self.n_docs)
        off = 1 + (u * (s.n_classes - 1)).astype(np.int64)
        return (target + off) % s.n_classes

    # ---------------------------------------------------------------- API
    def eval_config(self, cfg: TaskConfig) -> TaskScores:
        key = cfg.key() + (self.reorder_mode,)
        if key not in self._score_cache:
            pred, conf = self._predict(cfg.model, cfg.operation, cfg.fraction)
            self._score_cache[key] = TaskScores(cfg, pred, conf)
        return self._score_cache[key]

    def register_surrogate(self, spec: SurrogateSpec):
        self.surrogates[spec.op_id] = spec

    def op_token_table(self) -> Dict[str, int]:
        t = {O_ORIG: self.spec.op_tokens}
        t.update({k: v.op_tokens for k, v in self.surrogates.items()})
        return t

    def cost_model(self) -> CascadeCostModel:
        return CascadeCostModel(self.doc_tokens, self.op_token_table())

    @property
    def n_classes(self) -> int:
        return self.spec.n_classes

    def subset(self, idx: np.ndarray) -> "SimSubset":
        return SimSubset(self, idx)


@dataclass
class SimSubset:
    """A view of a SimWorkload restricted to index set ``idx`` (dev/val)."""
    base: SimWorkload
    idx: np.ndarray

    def eval_config(self, cfg: TaskConfig) -> TaskScores:
        s = self.base.eval_config(cfg)
        return TaskScores(cfg, s.pred[self.idx], s.conf[self.idx])

    @property
    def oracle_pred(self) -> np.ndarray:
        return self.base.oracle_pred[self.idx]

    @property
    def n_classes(self) -> int:
        return self.base.n_classes

    def cost_model(self) -> CascadeCostModel:
        return CascadeCostModel(self.base.doc_tokens[self.idx],
                                self.base.op_token_table())

    def register_surrogate(self, spec: SurrogateSpec):
        self.base.register_surrogate(spec)

    @property
    def surrogates(self):
        return self.base.surrogates

    @property
    def spec(self):
        return self.base.spec

    def subset(self, idx: np.ndarray) -> "SimSubset":
        return SimSubset(self.base, self.idx[idx])


def _erfinv(x: np.ndarray) -> np.ndarray:
    """Vectorized inverse error function (Winitzki approximation)."""
    a = 0.147
    ln = np.log(np.maximum(1 - x * x, 1e-12))
    t1 = 2.0 / (np.pi * a) + ln / 2.0
    return np.sign(x) * np.sqrt(np.sqrt(t1 * t1 - ln / a) - t1)


def make_workload(name: str, n_docs: int = 1000, seed_offset: int = 0,
                  reorder_mode: str = "learned") -> SimWorkload:
    spec = WORKLOADS[name]
    if seed_offset:
        spec = replace(spec, seed=spec.seed + 1000 * seed_offset)
    return SimWorkload(spec, n_docs, reorder_mode=reorder_mode)
