"""Operations and bytes of the served work, from logical shapes only.

Nothing here reads the program: the shapes come from the configuration
file and each launch's documents (their true lengths and the query
tokens), so the yardstick reads the same work whatever implements it.
The counts of one model's block (its attention calls, its active
parameters, its head) come from the model's reference family
(``bench/reference/families/``); this file holds the card's peaks and
what every family shares.

The least time of a call is the larger of its bytes over the peak
bandwidth and its operations over the peak rate.

Whole step (``launch_model_flops``): ``2 * active parameters`` per real
token through the layers, the causal attention of every attention
layer, and ``2 * head parameters`` per head row computed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

# one NVIDIA H100 SXM, dense, published (bf16 tensor cores; HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


@dataclass(frozen=True)
class DocStep:
    """One document in one launch: cached and new document tokens, the
    key count its operation suffix starts from, and the suffix length."""
    cached: int
    new: int
    kv: int
    op_len: int


def launch_model_flops(family, spec, docs: Sequence[DocStep]) -> float:
    """Useful operations of one launch of a model of ``family``: the
    extend over the new tokens and the op-suffix decode, real documents
    only."""
    layers = family.attention_layers(spec)
    p2 = 2.0 * family.active_params(spec)
    head = 2.0 * family.head_params(spec)
    flops = 0.0
    for d in docs:
        f_ext, _ = family.extend_call(spec, [(d.cached, d.new)])
        f_dec, _ = family.decode_call(
            spec, [d.kv + t + 1 for t in range(d.op_len)])
        flops += (d.new + d.op_len) * p2 + layers * (f_ext + f_dec)
        flops += head * ((1 if d.new > 0 else 0) + d.op_len)
    return flops
