"""Document restructuring (paper §4): granularity search, oracle-supervised
relevance classifier, and chunk reordering.

Pipeline (faithful to §4):
  1. split documents into 80-char lines;
  2. oracle labels minimal relevant line ranges per dev document;
  3. merged ranges are checked: does the oracle's answer on the REDUCED
     document match its full-document answer on >= alpha of the dev set?
     if not, expand every range by one line each side (<= e=3 times);
  4. chunk granularity := average merged-range length;
  5. build an oracle-labeled chunk dataset (relevant = oracle-pointed
     chunks; irrelevant = non-overlapping s-line windows), upsample
     positives, embed chunks, fit a logistic regression initialized at the
     operation embedding with Adam + early stopping on held-out F1;
  6. at serving time: score chunks (the fused mean-pool + logistic CUDA
     kernel, ``kernels.ops.relevance_score``), sort descending,
     concatenate.

Embeddings are hashed word vectors (deterministic, offline) standing in
for text-embedding-3-small; the classifier, training loop, and kernel
path are the real thing.  The numpy helpers are the JAX package's, line
for line; the classifier trains with torch autograd on an explicit
device and the scores come from the CUDA kernel on a CUDA device (its
plain version on the CPU).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from ..data.documents import SyntheticDoc
from ..kernels import ops
from ..models.runtime import DeviceLike, resolve_device

EMBED_DIM = 256
MAX_CHUNK_WORDS = 64


# ---------------------------------------------------------------------------
# line / range plumbing
# ---------------------------------------------------------------------------

def split_lines(text: str, width: int = 80) -> List[str]:
    out = []
    for raw in text.split("\n"):
        while len(raw) > width:
            out.append(raw[:width])
            raw = raw[width:]
        out.append(raw)
    return out


def merge_ranges(ranges: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge OVERLAPPING inclusive line ranges.

    The paper's §4 worked example keeps [22,26],[27,31] separate (adjacent)
    and merges only once they overlap ([21,27],[26,32] -> [21,32]), so
    adjacency alone does not merge.
    """
    if not ranges:
        return []
    rs = sorted(ranges)
    out = [list(rs[0])]
    for s, e in rs[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(r) for r in out]


def expand_ranges(ranges: Sequence[Tuple[int, int]], n_lines: int
                  ) -> List[Tuple[int, int]]:
    return merge_ranges([(max(s - 1, 0), min(e + 1, n_lines - 1))
                         for s, e in ranges])


class OracleLabeler(Protocol):
    """The oracle model's two §4 roles."""

    def relevant_ranges(self, doc: SyntheticDoc) -> List[Tuple[int, int]]:
        ...

    def answer(self, doc: SyntheticDoc,
               lines: Optional[Sequence[int]] = None) -> int:
        ...


@dataclass
class SyntheticOracle:
    """Knows the planted relevance (with optional labeling noise)."""
    noise: float = 0.0
    seed: int = 0

    def relevant_ranges(self, doc):
        rng = np.random.default_rng(self.seed + doc.doc_id)
        out = []
        for r in doc.relevant_lines:
            if rng.random() < self.noise:
                continue
            jitter = int(rng.integers(-1, 2)) if self.noise > 0 else 0
            s = int(np.clip(r + jitter, 0, len(doc.lines) - 1))
            out.append((s, s))
        return merge_ranges(out) or [(0, 0)]

    def answer(self, doc, lines=None):
        if lines is None:
            return doc.label
        has_rel = any(r in set(lines) for r in doc.relevant_lines)
        if has_rel:
            return doc.label
        rng = np.random.default_rng(self.seed + 31 * doc.doc_id)
        return int(rng.integers(0, 2)) if rng.random() < 0.8 else doc.label


# ---------------------------------------------------------------------------
# granularity search (§4 steps 1-5)
# ---------------------------------------------------------------------------

def determine_granularity(
    docs: Sequence[SyntheticDoc],
    oracle: OracleLabeler,
    alpha: float,
    max_expansions: int = 3,
) -> Tuple[int, List[List[Tuple[int, int]]]]:
    """Returns (chunk granularity s, per-doc final merged ranges)."""
    per_doc = [merge_ranges(oracle.relevant_ranges(d)) for d in docs]
    for expansion in range(max_expansions + 1):
        correct = 0
        for d, ranges in zip(docs, per_doc):
            lines = [li for s, e in ranges for li in range(s, e + 1)]
            if oracle.answer(d, lines) == oracle.answer(d):
                correct += 1
        if correct >= alpha * len(docs) or expansion == max_expansions:
            break
        per_doc = [expand_ranges(r, len(d.lines))
                   for d, r in zip(docs, per_doc)]
    lengths = [e - s + 1 for ranges in per_doc for s, e in ranges]
    gran = max(int(round(float(np.mean(lengths)))), 1) if lengths else 1
    return gran, per_doc


# ---------------------------------------------------------------------------
# hashed word embeddings (offline stand-in for text-embedding-3-small)
# ---------------------------------------------------------------------------

def _word_vec(word: str, dim: int = EMBED_DIM) -> np.ndarray:
    h = hashlib.blake2b(word.lower().encode(), digest_size=8).digest()
    rng = np.random.default_rng(int.from_bytes(h, "little"))
    return rng.standard_normal(dim).astype(np.float32) / np.sqrt(dim)


@dataclass
class HashEmbedder:
    dim: int = EMBED_DIM
    _cache: dict = field(default_factory=dict)

    def word(self, w: str) -> np.ndarray:
        if w not in self._cache:
            self._cache[w] = _word_vec(w, self.dim)
        return self._cache[w]

    def tokens(self, text: str, max_words: int = MAX_CHUNK_WORDS
               ) -> Tuple[np.ndarray, int]:
        """Per-word embeddings [max_words, dim] + true length."""
        words = text.split()[:max_words]
        out = np.zeros((max_words, self.dim), np.float32)
        for i, w in enumerate(words):
            out[i] = self.word(w)
        return out, max(len(words), 1)

    def pooled(self, text: str) -> np.ndarray:
        toks, n = self.tokens(text)
        return toks[:n].mean(axis=0)


# ---------------------------------------------------------------------------
# relevance classifier (torch logistic regression, §4)
# ---------------------------------------------------------------------------

def _f1(pred: np.ndarray, y: np.ndarray) -> float:
    tp = float(np.sum((pred == 1) & (y == 1)))
    fp = float(np.sum((pred == 1) & (y == 0)))
    fn = float(np.sum((pred == 0) & (y == 1)))
    if tp == 0:
        return 0.0
    p, r = tp / (tp + fp), tp / (tp + fn)
    return 2 * p * r / (p + r)


def train_relevance_classifier(
    x_train: np.ndarray, y_train: np.ndarray,
    x_test: np.ndarray, y_test: np.ndarray,
    init_w: Optional[np.ndarray] = None,
    lr: float = 0.3, epochs: int = 800, patience: int = 80,
    upsample: bool = True, seed: int = 0,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, float, float]:
    """Binary logistic regression: Adam + early stopping on held-out F1.

    Weights initialize at the operation embedding (paper §4) so the model
    starts as "similarity to the operation" and learns corrections.  The
    loss and its gradient run in f32 on ``device`` (autograd); held-out F1
    is computed on the host each epoch.  The Adam bias corrections
    ``1 - 0.9**t`` and ``1 - 0.999**t`` are computed in f32 from an f32
    step count, as the jitted JAX step computes them, so both packages
    follow the same trajectory.  Returns (weights [D], bias, best F1).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if upsample and 0 < y_train.sum() < len(y_train):
        pos = np.where(y_train == 1)[0]
        neg = np.where(y_train == 0)[0]
        if len(pos) < len(neg):
            extra = rng.choice(pos, size=len(neg) - len(pos), replace=True)
            keep = np.concatenate([np.arange(len(y_train)), extra])
            x_train, y_train = x_train[keep], y_train[keep]

    f32 = torch.float32
    x = torch.as_tensor(np.asarray(x_train, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(y_train, np.float32), device=dev)
    w0 = init_w if init_w is not None else np.zeros(x.shape[1])
    params = [torch.as_tensor(np.asarray(w0, np.float32), device=dev),
              torch.zeros((), dtype=f32, device=dev)]

    def loss_fn(w, b):
        logits = x @ w + b
        # numerically stable BCE-with-logits
        return torch.mean(torch.clamp_min(logits, 0) - logits * y
                          + torch.log1p(torch.exp(-torch.abs(logits))))

    beta1 = torch.tensor(0.9, dtype=f32, device=dev)
    beta2 = torch.tensor(0.999, dtype=f32, device=dev)

    def adam_step(params, m, v, t):
        w, b = (p.detach().requires_grad_(True) for p in params)
        g = torch.autograd.grad(loss_fn(w, b), (w, b))
        tf = torch.tensor(float(t), dtype=f32, device=dev)
        c1 = 1 - beta1 ** tf
        c2 = 1 - beta2 ** tf
        out_p, out_m, out_v = [], [], []
        with torch.no_grad():
            for p, gi, mi, vi in zip(params, g, m, v):
                mi = 0.9 * mi + 0.1 * gi
                vi = 0.999 * vi + 0.001 * gi * gi
                mh = mi / c1
                vh = vi / c2
                out_p.append(p - lr * mh / (torch.sqrt(vh) + 1e-8))
                out_m.append(mi)
                out_v.append(vi)
        return out_p, out_m, out_v

    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    best = (params[0].cpu().numpy(), float(params[1]), -1.0)
    stale = 0
    for epoch in range(1, epochs + 1):
        params, m, v = adam_step(params, m, v, epoch)
        w_np, b_np = params[0].cpu().numpy(), float(params[1])
        pred = (x_test @ w_np + b_np > 0).astype(int)
        f1 = _f1(pred, y_test)
        if f1 > best[2]:
            best = (w_np, b_np, f1)
            stale = 0
        else:
            stale += 1
            if stale >= patience:
                break
    return best


# ---------------------------------------------------------------------------
# end-to-end restructurer
# ---------------------------------------------------------------------------

@dataclass
class DocumentRestructurer:
    """Fit on D_dev with the oracle; reorder any document at serving time.

    ``device`` is where the classifier trains and the chunks are scored:
    CUDA (the default; raises without a GPU) runs the relevance kernel,
    ``"cpu"`` its plain version."""

    operation_text: str
    alpha: float = 0.9
    embedder: HashEmbedder = field(default_factory=HashEmbedder)
    granularity: int = 1
    w: Optional[np.ndarray] = None
    b: float = 0.0
    f1: float = 0.0
    device: DeviceLike = "cuda"

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def chunks_of(self, doc: SyntheticDoc) -> List[str]:
        s = self.granularity
        return [" ".join(doc.lines[i: i + s])
                for i in range(0, len(doc.lines), s)]

    def fit(self, docs: Sequence[SyntheticDoc], oracle: OracleLabeler,
            test_split: float = 0.3, seed: int = 0) -> "DocumentRestructurer":
        self.granularity, per_doc = determine_granularity(
            docs, oracle, self.alpha)
        s = self.granularity
        xs, ys, doc_of = [], [], []
        for d, ranges in zip(docs, per_doc):
            rel_starts = {max(0, st) for st, _ in ranges}
            rel_lines = {li for st, e in ranges for li in range(st, e + 1)}
            # relevant: s-line chunk at each oracle-pointed start
            for st in rel_starts:
                text = " ".join(d.lines[st: st + s])
                xs.append(self.embedder.pooled(text))
                ys.append(1)
                doc_of.append(d.doc_id)
            # irrelevant: non-overlapping windows that avoid relevant lines
            for w0 in range(0, len(d.lines) - s + 1, s):
                if any(li in rel_lines for li in range(w0, w0 + s)):
                    continue
                text = " ".join(d.lines[w0: w0 + s])
                xs.append(self.embedder.pooled(text))
                ys.append(0)
                doc_of.append(d.doc_id)
        x = np.stack(xs)
        y = np.asarray(ys)
        # split by document (the paper partitions D_dev into D_train/D_test)
        rng = np.random.default_rng(seed)
        doc_ids = np.unique(doc_of)
        test_docs = set(rng.choice(
            doc_ids, size=max(int(len(doc_ids) * test_split), 1),
            replace=False).tolist())
        is_test = np.asarray([d in test_docs for d in doc_of])
        init_w = self.embedder.pooled(self.operation_text)
        self.w, self.b, self.f1 = train_relevance_classifier(
            x[~is_test], y[~is_test], x[is_test], y[is_test],
            init_w=init_w, seed=seed, device=self.device)
        return self

    def chunk_inputs(self, doc: SyntheticDoc
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The kernel's inputs for ``doc`` on the restructurer's device:
        token embeddings [C, T, D] f32 (zero rows past each chunk's
        words) and int32 word counts [C]."""
        toks, lens = zip(*(self.embedder.tokens(c)
                           for c in self.chunks_of(doc)))
        x = torch.from_numpy(np.stack(toks)).to(self.device)
        lengths = torch.from_numpy(np.asarray(lens, np.int32)).to(self.device)
        return x, lengths

    def head(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fitted classifier as device tensors: w [D] and b [1]."""
        w = torch.as_tensor(np.asarray(self.w, np.float32),
                            device=self.device)
        b = torch.tensor([self.b], dtype=torch.float32, device=self.device)
        return w, b

    def score_chunks(self, doc: SyntheticDoc) -> np.ndarray:
        """Chunk relevance scores [C] through the fused kernel path."""
        x, lengths = self.chunk_inputs(doc)
        w, b = self.head()
        return ops.relevance_score(x, lengths, w, b).cpu().numpy()

    def order_lines(self, doc: SyntheticDoc, scores: np.ndarray) -> List[int]:
        """Line order that puts chunks by descending score (stable)."""
        order = np.argsort(-scores, kind="stable")
        s = self.granularity
        return [li for ci in order
                for li in range(ci * s, min((ci + 1) * s, len(doc.lines)))]

    def reorder(self, doc: SyntheticDoc) -> SyntheticDoc:
        """Sort chunks by predicted relevance (desc); concatenate."""
        return doc.reordered(self.order_lines(doc, self.score_chunks(doc)))
