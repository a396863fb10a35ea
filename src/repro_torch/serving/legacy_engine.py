"""Seed (pre-arena) serving data plane, kept as the benchmark baseline.

This is the engine's original per-document dict cache: every stage
re-stacks per-doc state lists into a batch (``_stack_states``), runs the
model eagerly, and re-slices the batch back into per-doc entries
(``_slice_states``).  Mixed cached lengths within a bucket force a full
re-prefill (the ``have_cache`` check below).  The arena engine
(``serving.engine``) is measured against this path; do not use it for
new work.

States are the port's per-layer lists of leaf dicts, every leaf batched
on axis 0 (``models.model``).  The reference relies on functional state:
its op extension's new states are dropped and each document's cached
snapshot stays intact.  Here ``extend`` writes attention caches in place,
so ``_stack_states`` builds a fresh batch (``torch.stack`` copies) and
``_slice_states`` clones each document's row: no cached snapshot shares
memory with a batch that a later ``extend`` writes.

``host_overhead_s`` accumulates wall-clock spent in the Python data plane
(state stacking/slicing and token-batch assembly) so a benchmark can
report dispatch overhead without profiling machinery.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..core.tasks import Cascade
from ..data.tokenizer import PAD, HashWordTokenizer, class_token
from .scheduler import ServeStats, make_buckets

States = List[Dict[str, torch.Tensor]]


def _stack_states(states_list: Sequence[States]) -> States:
    """Per-document states -> one batch (new tensors)."""
    return [{n: torch.stack([s[li][n] for s in states_list], 0)
             for n in layer}
            for li, layer in enumerate(states_list[0])]


def _slice_states(states: States, i: int) -> States:
    """Row ``i`` of a batch, as copies that own their memory."""
    return [{n: t[i].clone() for n, t in layer.items()} for layer in states]


@dataclass
class DictCacheLMBackend:
    """Seed backend: model + params with a per-doc state cache, on the
    model's device."""

    name: str
    model: Any                       # models.model.LM (or compatible)
    params: Any
    tokenizer: HashWordTokenizer
    rate_per_token: float = 1.0      # $ parity with the analytical model
    cached_discount: float = 0.5
    s_alloc: int = 4096
    # doc_id -> (padded_cached_len, true_cached_tokens, per-doc states)
    _cache: Dict[int, Tuple[int, int, States]] = field(default_factory=dict)
    host_overhead_s: float = 0.0     # stack/slice/assembly wall-clock

    def reset(self) -> None:
        self._cache.clear()
        self.host_overhead_s = 0.0

    def cached_len(self, doc_id: int) -> int:
        e = self._cache.get(doc_id)
        return e[0] if e is not None else 0

    def release(self, doc_id: int) -> None:
        self._cache.pop(doc_id, None)

    def class_confidences(self, logits: torch.Tensor, n_classes: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Softmax over the class answer tokens -> (pred, conf)."""
        toks = [class_token(c) for c in range(n_classes)]
        cls_logits = logits[:, toks].float().cpu().numpy().astype(np.float64)
        z = cls_logits - cls_logits.max(axis=1, keepdims=True)
        probs = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
        return probs.argmax(axis=1), probs.max(axis=1)

    def _tokens(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.model.device)

    def run_stage(
        self,
        doc_ids: Sequence[int],
        doc_tokens: Mapping[int, np.ndarray],
        bucket: int,                             # padded full-doc length
        fraction: float,
        op_tokens: np.ndarray,
        n_classes: int,
    ) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """Run (op, fraction) over one bucket batch (seed semantics).

        Returns (pred [B], conf [B], new_tokens, cached_tokens) with TRUE
        (unpadded) token counts for $ accounting.
        """
        B = len(doc_ids)
        f_len = max(int(math.ceil(bucket * fraction)), 1)
        entries = [self._cache.get(d) for d in doc_ids]
        have_cache = all(e is not None for e in entries) and \
            len({e[0] for e in entries if e is not None}) == 1
        c_len = entries[0][0] if have_cache and entries[0] else 0
        if have_cache and c_len > f_len:
            # cached prefix already covers this fraction: reuse as-is
            t0 = time.perf_counter()
            states = _stack_states([e[2] for e in entries])
            self.host_overhead_s += time.perf_counter() - t0
            q_off = c_len
            new_true = 0
            cached_true = sum(min(e[1], self._true_len(doc_tokens[d],
                                                       fraction))
                              for e, d in zip(entries, doc_ids))
        else:
            if not have_cache:
                c_len = 0
            n_new = f_len - c_len
            t0 = time.perf_counter()
            new_tok = np.full((B, max(n_new, 1)), PAD, np.int32)
            new_true = 0
            cached_true = 0
            for i, d in enumerate(doc_ids):
                toks = doc_tokens[d]
                seg = toks[min(c_len, len(toks)): min(f_len, len(toks))]
                new_tok[i, : len(seg)] = seg
                new_true += len(seg)
                cached_true += min(c_len, len(toks)) if have_cache else 0
            self.host_overhead_s += time.perf_counter() - t0
            if have_cache and c_len > 0:
                t0 = time.perf_counter()
                states = _stack_states([e[2] for e in entries])
                self.host_overhead_s += time.perf_counter() - t0
                _, states = self.model.extend(
                    self.params, {"tokens": self._tokens(new_tok)},
                    states, q_offset=c_len)
            else:
                _, states = self.model.prefill(
                    self.params, {"tokens": self._tokens(new_tok)},
                    s_alloc=self.s_alloc)
            q_off = f_len
            t0 = time.perf_counter()
            for i, d in enumerate(doc_ids):
                toks = doc_tokens[d]
                true_cached = min(f_len, len(toks))
                self._cache[d] = (f_len, true_cached,
                                  _slice_states(states, i))
            self.host_overhead_s += time.perf_counter() - t0

        # operation extension: it writes the batch ``states``, never a
        # document's cached snapshot (those are clones); its new states
        # are dropped
        opb = np.broadcast_to(op_tokens[None],
                              (B, len(op_tokens))).astype(np.int32)
        logits, _ = self.model.extend(
            self.params, {"tokens": self._tokens(opb)}, states,
            q_offset=q_off)
        pred, conf = self.class_confidences(logits, n_classes)
        return pred, conf, new_true + B * len(op_tokens), cached_true

    @staticmethod
    def _true_len(toks: np.ndarray, fraction: float) -> int:
        return max(int(math.ceil(len(toks) * fraction)), 1)


@dataclass
class SeedCascadeEngine:
    """The seed control loop: length-bucket batches only (no cached-length
    grouping, no slot arena).  Benchmark baseline twin of
    ``engine.CascadeEngine``; returns (pred, cost, stats)."""

    backends: Dict[str, DictCacheLMBackend]
    operations: Dict[str, str]
    n_classes: int
    batch_size: int = 8

    def run(self, cascade: Cascade, docs: Mapping[int, str],
            oracle_model: str = "oracle"):
        stats = ServeStats()
        tok: Dict[str, Dict[int, np.ndarray]] = {m: {} for m in self.backends}
        full_len: Dict[int, int] = {}
        for m, be in self.backends.items():
            be.reset()
            for d, text in docs.items():
                ids = np.asarray(be.tokenizer.encode(text), np.int32)
                tok[m][d] = ids
                full_len[d] = len(ids)
        unresolved = list(docs.keys())
        pred: Dict[int, int] = {}
        cost = 0.0
        stages = list(cascade.tasks) + [None]
        for si, task in enumerate(stages):
            if not unresolved:
                break
            if task is None:
                model, op_id, fraction, thr = oracle_model, "o_orig", 1.0, None
            else:
                model = task.config.model
                op_id = task.config.operation
                fraction = task.config.fraction
                thr = task.threshold_vector(self.n_classes)
            be = self.backends[model]
            op_toks = np.asarray(
                be.tokenizer.encode(self.operations[op_id]), np.int32)
            survivors = []
            for blen, ids in make_buckets(unresolved, full_len,
                                          self.batch_size):
                p, c, new_t, cached_t = be.run_stage(
                    ids, tok[model], blen, fraction, op_toks, self.n_classes)
                batch_cost = (new_t * be.rate_per_token
                              + cached_t * be.rate_per_token
                              * be.cached_discount)
                stats.record(si, len(ids), new_t, cached_t, batch_cost)
                stats.batches += 1
                cost += batch_cost
                for i, d in enumerate(ids):
                    if thr is None or c[i] >= thr[p[i]]:
                        pred[d] = int(p[i])
                    else:
                        survivors.append(d)
            unresolved = survivors
        return pred, cost, stats
