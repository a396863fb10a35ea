"""Operations and bytes of the served work, from logical shapes only.

Nothing here reads the program: the shapes come from the configuration
file and each launch's documents (their true lengths and the query
tokens), so the yardstick reads the same work whatever implements it.

Attention (one layer, one call over a launch's documents):

* extend: a document with ``c`` cached and ``n`` new tokens runs ``n``
  queries, query ``i`` over ``c + i + 1`` keys (causal).  Operations
  ``4 * Hq * Dh * sum(keys)`` (QK^T and PV); bytes: Q and O once
  (``2 * n * Hq * Dh`` elements), K and V once (``2 * (c + n) * Hkv *
  Dh`` elements).
* decode: one query over ``kv`` keys: ``4 * Hq * Dh * kv`` operations;
  ``2 * Hq * Dh + 2 * kv * Hkv * Dh`` elements.

The least time of a call is the larger of its bytes over the peak
bandwidth and its operations over the peak rate.

Whole step (``model_flops``): ``2 * active parameters`` per real token
through the layers (the MoE at its top-k experts and its router), the
causal attention above, and ``2 * d * V`` per head row computed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence, Tuple

# one NVIDIA H100 SXM, dense, published (bf16 tensor cores; HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


@dataclass(frozen=True)
class Shape:
    heads: int
    kv_heads: int
    head_dim: int
    layers: int
    elem_bytes: int = 2


def shape_of(spec: Mapping) -> Shape:
    return Shape(spec["num_heads"], spec["num_kv_heads"], spec["head_dim"],
                 spec["num_layers"],
                 2 if spec.get("dtype", "bfloat16") == "bfloat16" else 4)


def extend_call(sh: Shape, docs: Iterable[Tuple[int, int]]
                ) -> Tuple[float, float]:
    """(operations, bytes) of one layer's extend over ``(cached, new)``
    per document."""
    flops = elems = 0.0
    for c, n in docs:
        if n <= 0:
            continue
        keys = n * c + n * (n + 1) / 2
        flops += 4.0 * sh.heads * sh.head_dim * keys
        elems += 2.0 * n * sh.heads * sh.head_dim \
            + 2.0 * (c + n) * sh.kv_heads * sh.head_dim
    return flops, elems * sh.elem_bytes


def decode_call(sh: Shape, kvs: Iterable[int]) -> Tuple[float, float]:
    """(operations, bytes) of one layer's decode step over each
    document's key count."""
    flops = elems = 0.0
    for kv in kvs:
        flops += 4.0 * sh.heads * sh.head_dim * kv
        elems += 2.0 * sh.heads * sh.head_dim \
            + 2.0 * kv * sh.kv_heads * sh.head_dim
    return flops, elems * sh.elem_bytes


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def active_params(spec: Mapping) -> float:
    """Parameters a token passes through in the layers (no embedding, no
    head)."""
    d, H, KV, dh = (spec["d_model"], spec["num_heads"], spec["num_kv_heads"],
                    spec["head_dim"])
    attn = d * H * dh * 2 + d * KV * dh * 2
    moe = spec.get("moe")
    if moe:
        ffn = moe["top_k"] * 3 * d * spec["d_ff"] + d * moe["num_experts"]
    else:
        ffn = 3 * d * spec["d_ff"]
    return float(spec["num_layers"] * (attn + ffn))


@dataclass(frozen=True)
class DocStep:
    """One document in one launch: cached and new document tokens, the
    key count its operation suffix starts from, and the suffix length."""
    cached: int
    new: int
    kv: int
    op_len: int


def launch_model_flops(spec: Mapping, docs: Sequence[DocStep]) -> float:
    """Useful operations of one launch: the extend over the new tokens
    and the op-suffix decode, real documents only."""
    sh = shape_of(spec)
    p2 = 2.0 * active_params(spec)
    head = 2.0 * spec["d_model"] * spec["vocab_size"]
    flops = 0.0
    for d in docs:
        f_ext, _ = extend_call(sh, [(d.cached, d.new)])
        f_dec, _ = decode_call(sh, [d.kv + t + 1 for t in range(d.op_len)])
        flops += (d.new + d.op_len) * p2 + sh.layers * (f_ext + f_dec)
        flops += head * ((1 if d.new > 0 else 0) + d.op_len)
    return flops
