"""Plain building blocks that the reference families share
(``bench/reference/families/``): the sequence a family runs, float32
with TF32 off, the control's float8 rounding, RMS norm, rotary
positions and the gated MLP.  No kernels, no cache, no batching.

``precision="fp8"`` is the control: every matrix product read through
``Lin`` takes its weight and its input rounded to float8 e4m3 (per
tensor for weights, per row for inputs, scaled to the format's range);
what a family computes outside ``Lin`` (attention scores and sums)
stays in float32.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

FP8_MAX = 448.0


@dataclass
class Seq:
    tokens: List[int]
    # MoE chunks over the document part: (start, end, padded length)
    chunks: List[Tuple[int, int, int]]
    doc_len: int


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """No autograd, and float32 products in float32: TF32 off for the
    block, restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def q8(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    amax = (t.abs().amax() if dim is None
            else t.abs().amax(dim=dim, keepdim=True))
    s = torch.clamp(amax, min=1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Lin:
    """A weight widened to f32 (or rounded through fp8) for ``x @ w``."""

    def __init__(self, w: torch.Tensor, precision: str):
        self.fp8 = precision == "fp8"
        w = w.float()
        self.w = q8(w, None) if self.fp8 else w

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = q8(x, -1)
        return x @ self.w


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
         sections: Optional[Sequence[int]]) -> torch.Tensor:
    """x [S, H, Dh], pos [S]: rotate-half rotary positions; with M-RoPE
    sections, frequency i turns by the position channel of its section
    (all three channels carry ``pos`` for text)."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    if sections is not None:
        pos3 = torch.stack([pos, pos, pos], -1).float()        # [S, 3]
        sec = torch.tensor([c for c, n in enumerate(sections)
                            for _ in range(n)], device=x.device)
        ang = pos3[:, sec] * inv
    else:
        ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """q, k [S, H, Dq], v [S, H, Dv] -> [S, H * Dv]: softmax of the
    scaled scores under a causal mask, in float32."""
    S, H = q.shape[:2]
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * v.shape[-1])


def gated_mlp(h, lin) -> torch.Tensor:
    return lin["w2"](torch.nn.functional.silu(lin["w1"](h)) * lin["w3"](h))
