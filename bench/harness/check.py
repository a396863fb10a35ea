"""How ``correct`` is decided: the window's answers against the plain
reference (``bench/reference``), each number beside its limit.

* ``margin_err``: over a sample of resolved documents, drawn from the
  seed with the longest among them, the widest gap between the served
  answer's log-odds, ``log(conf / (1 - conf))``, and the reference's
  log-odds of the same class at the exit stage (its logit less the
  log-sum-exp of the other classes').  It covers every layer of the model
  that answered: the paged extend, the op-suffix decode, both kernels,
  M-RoPE, the MoE.
* ``routing_gap``: over the same sample, at every stage of the served
  path, how far the reference's top probability lies on the other side
  of that stage's threshold where the reference routes otherwise
  (escalated where it would resolve, resolved where it would escalate);
  0 when they agree.
* ``oracle_margin_p50``, where the cell file asks for
  ``check_oracle_docs: n``: the median of the same margin error over
  ``n`` more resolved documents that exited at the oracle's stage, drawn
  from the seed apart from the sample above (which it leaves as it is).
  The oracle's answers alone, so that a fault in the oracle's layers
  shows however few of the sample's documents reach it.
* ``billing_mismatch``: resolved documents whose $ differs from what the
  reference bills for the served path (exact: limit 0).
* ``unresolved``: documents judged that never resolved (limit 0).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..reference.cascade import decide, stage_table, total_cost, walk
from ..reference.layers import Seq
from ..reference.tokenizer import Tokenizer, class_token

NOTHING = 1e30          # a number read over no document fails its limit


def op_lens(cfg: Mapping) -> Dict[str, int]:
    tok = Tokenizer(cfg["tokenizer_vocab"])
    return {k: len(tok.encode(v)) for k, v in cfg["operations"].items()}


def sample_docs(docs, seed: int, k: int) -> list:
    """``k`` resolved documents drawn from the seed, the longest first."""
    done = sorted((r for r in docs if r.status == "resolved"),
                  key=lambda r: r.doc.doc_id)
    if not done:
        return []
    longest = max(done, key=lambda r: (r.doc.n_tokens, -r.doc.doc_id))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([abs(int(seed)), 0x5EED])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def oracle_docs(docs, seed: int, k: int, stages, taken) -> list:
    """``k`` resolved documents that exited at their tenant's last stage
    (the oracle's), drawn from the seed among those not in ``taken``."""
    skip = {id(r) for r in taken}
    pool = sorted((r for r in docs if r.status == "resolved"
                   and id(r) not in skip
                   and r.exit_stage == len(stages[r.doc.tenant]) - 1),
                  key=lambda r: r.doc.doc_id)
    rng = np.random.default_rng([abs(int(seed)), 0x0AC1E])
    pick = rng.choice(len(pool), size=min(k, len(pool)), replace=False)
    return [pool[i] for i in sorted(pick)]


def stage_logits(cell, params: Mapping, docs, upto: Sequence[int],
                 precision: str = "f32") -> List[List[np.ndarray]]:
    """Reference class logits of each document at stages ``0..upto[i]``
    (float64 numpy, one array a stage)."""
    cfg = cell.config
    tok = Tokenizer(cfg["tokenizer_vocab"])
    ops = {k: tok.encode(v) for k, v in cfg["operations"].items()}
    classes = [class_token(c) for c in range(cfg["n_classes"])]
    tables = [stage_table(t["stages"], cell.serve["oracle_op"])
              for t in cell.serve["tenants"]]
    rates = cfg["rates_per_token"]
    per_model: Dict[str, List[Tuple[int, int, Seq]]] = {}
    for i, rec in enumerate(docs):
        stages = tables[rec.doc.tenant]
        toks = tok.encode(rec.doc.text)
        for run in walk(stages, rec.doc.n_tokens, upto[i], rates,
                        cfg["cached_discount"], op_lens(cfg)):
            st = stages[run.stage]
            seq = Seq(toks[:run.doc_len] + ops[st.op], run.chunks,
                      run.doc_len)
            per_model.setdefault(run.model, []).append((i, run.stage, seq))
    out: List[List[Optional[np.ndarray]]] = [
        [None] * (u + 1) for u in upto]
    for model, items in per_model.items():
        spec = cfg["models"][model]["port"]
        lg = cell.family(model).class_logits(
            spec, params[model], [s for _, _, s in items], classes,
            precision).double().cpu().numpy()
        for (i, s, _), row in zip(items, lg):
            out[i][s] = row
    return out


def _softmax(x: np.ndarray) -> np.ndarray:
    z = np.exp(x - x.max())
    return z / z.sum()


def log_odds(logits: np.ndarray, c: int) -> float:
    others = np.delete(logits, c)
    m = others.max()
    return float(logits[c] - (m + math.log(np.exp(others - m).sum())))


def conf_log_odds(conf: float) -> float:
    conf = min(max(conf, 1e-300), 1.0 - 1e-16)
    return math.log(conf) - math.log1p(-conf)


def path_numbers(stages, exit_stage: int, pred: int, conf: float,
                 ref: Sequence[np.ndarray]) -> Tuple[float, float]:
    """(margin error, routing gap) of one served path against the
    reference's logits at its stages."""
    margin = abs(conf_log_odds(conf) - log_odds(ref[exit_stage], pred))
    gap = 0.0
    for s in range(exit_stage + 1):
        top, p, resolves = decide(stages[s], _softmax(ref[s]))
        if s < exit_stage and resolves:
            gap = max(gap, p - stages[s].thresholds[top])
        elif s == exit_stage and not resolves:
            gap = max(gap, stages[s].thresholds[top] - p)
    return margin, gap


def judge(ctx, params: Mapping, cell, detail: Optional[dict] = None
          ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit; ``detail``, where given,
    receives the judged documents (``sample``, ``extra``: the oracle
    draw) and their (margin error, routing gap) pairs (``nums``)."""
    serve, cfg = cell.serve, cell.config
    limits = serve["limits"]
    resolved = [r for r in ctx.docs if r.status == "resolved"]
    mismatch = 0
    lens = op_lens(cfg)
    for r in resolved:
        runs = walk(ctx.stages[r.doc.tenant], r.doc.n_tokens, r.exit_stage,
                    cfg["rates_per_token"], cfg["cached_discount"], lens)
        if total_cost(runs) != r.cost:
            mismatch += 1
    sample = sample_docs(ctx.docs, ctx.seed, int(serve["check_docs"]))
    extra = oracle_docs(ctx.docs, ctx.seed,
                        int(serve.get("check_oracle_docs", 0)), ctx.stages,
                        sample)
    values = dict.fromkeys(("margin_err", "routing_gap"), NOTHING)
    if "check_oracle_docs" in serve:
        values["oracle_margin_p50"] = NOTHING
    judged, nums = sample + extra, []
    if judged:
        ref = stage_logits(cell, params, judged,
                           [r.exit_stage for r in judged])
        nums = [path_numbers(ctx.stages[r.doc.tenant], r.exit_stage, r.pred,
                             r.conf, ref[i]) for i, r in enumerate(judged)]
        if sample:
            values.update(sample_numbers(nums[:len(sample)]))
        if extra:
            values["oracle_margin_p50"] = float(
                np.median([m for m, _ in nums[len(sample):]]))
    if detail is not None:
        detail.update(sample=sample, extra=extra, nums=nums)
    checks = {n: {"value": values[n], "limit": lim}
              for n, lim in limits.items()}
    checks["billing_mismatch"] = {"value": mismatch, "limit": 0}
    checks["unresolved"] = {"value": len(ctx.docs) - len(resolved),
                            "limit": 0}
    return checks


def sample_numbers(nums: Sequence[Tuple[float, float]]) -> Dict[str, float]:
    """The compared numbers over a sample's (margin error, routing gap)
    pairs."""
    margins = [m for m, _ in nums]
    return {"margin_err": max(margins),
            "routing_gap": max(g for _, g in nums)}


def control_path(stages, logits: Sequence[np.ndarray]
                 ) -> Tuple[int, int, float]:
    """(exit stage, pred, conf) that a program answering with ``logits``
    at every stage would serve."""
    for s, st in enumerate(stages):
        top, p, resolves = decide(st, _softmax(logits[s]))
        if resolves:
            return s, top, p
    raise ValueError("the oracle's stage always resolves")
