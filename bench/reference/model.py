"""Plain forward pass of the served models, in float32 with TF32 off.

One function covers the four published models the benchmark serves, as
the configuration file states them (``bench/configs/<config>.json``,
``"port"``): token embedding, pre-norm blocks of grouped-query causal
attention (per-head q/k RMS norm where ``qk_norm``; rotary positions,
M-RoPE sections where ``mrope_sections``, a text-only input putting the
same position on all three channels) and a gated MLP or a top-k
mixture of experts, a final RMS norm and the tied head.  No kernels, no
cache, no batching: each sequence runs whole, layer by layer, so a
layer's weights are widened to float32 once for all sequences.

The mixture of experts follows the capacity rule the program states
(``models/moe.py``): per chunk of ``s`` padded tokens every expert takes
``int(s * top_k * (capacity_factor * 1.6) / E)`` assignments (at least
1, rounded up to a multiple of 128 from 128 on), in token-major order,
and drops the rest; the router's softmax top-k weights are renormalised.

``precision="fp8"`` is the control: every matrix product of the layers
and the head reads its weight and its input rounded to float8 e4m3 (per
tensor for weights, per row for inputs, scaled to the format's range);
attention scores and sums stay in float32.  ``precision="router_bf16"``
is float32 with only the router's input rounded to bfloat16: it shows
how far the experts' discrete choice alone moves an answer.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, Tuple

import torch

FP8_MAX = 448.0


@dataclass
class Seq:
    tokens: List[int]
    # MoE chunks over the document part: (start, end, padded length)
    chunks: List[Tuple[int, int, int]]
    doc_len: int


def _q8(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    amax = (t.abs().amax() if dim is None
            else t.abs().amax(dim=dim, keepdim=True))
    s = torch.clamp(amax, min=1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Lin:
    """A weight widened to f32 (or rounded through fp8) for ``x @ w``."""

    def __init__(self, w: torch.Tensor, precision: str):
        self.fp8 = precision == "fp8"
        w = w.float()
        self.w = _q8(w, None) if self.fp8 else w

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = _q8(x, -1)
        return x @ self.w


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
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


def _attention(h, lp, spec, lin) -> torch.Tensor:
    S = h.shape[0]
    a = lp["attn"]
    d, H, dh = a["wq"].shape
    kvh = a["wk"].shape[1]
    q = lin["wq"](h).view(S, H, dh)
    k = lin["wk"](h).view(S, kvh, dh)
    v = lin["wv"](h).view(S, kvh, dh)
    eps = spec["norm_eps"]
    if spec.get("qk_norm"):
        q = _rms(q, a["q_norm"]["scale"], eps)
        k = _rms(k, a["k_norm"]["scale"], eps)
    pos = torch.arange(S, device=h.device)
    sec = spec.get("mrope_sections")
    q = _rope(q, pos, spec["rope_theta"], sec)
    k = _rope(k, pos, spec["rope_theta"], sec)
    g = H // kvh
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(dh)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    o = torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * dh)
    return lin["wo"](o)


def _mlp(h, lin) -> torch.Tensor:
    return lin["w2"](torch.nn.functional.silu(lin["w1"](h)) * lin["w3"](h))


def row_capacity(s: int, top_k: int, cf: float, n_exp: int) -> int:
    cap = max(int(s * top_k * (cf * 1.6) / n_exp), 1)
    return ((cap + 127) // 128) * 128 if cap >= 128 else cap


def _moe(h, seq: Seq, lp, spec, precision) -> torch.Tensor:
    m = lp["moe"]
    moe = spec["moe"]
    K, E = moe["top_k"], m["router"].shape[1]
    hr = h.bfloat16().float() if precision == "router_bf16" else h
    logits = hr @ m["router"].float()
    w, ids = torch.topk(torch.softmax(logits, -1), K, -1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    keep = torch.zeros_like(ids, dtype=torch.bool)
    segs = [(a, min(b, seq.doc_len), s) for a, b, s in seq.chunks
            if a < seq.doc_len]
    segs += [(t, t + 1, 1) for t in range(seq.doc_len, h.shape[0])]
    for a, b, s in segs:
        cap = row_capacity(s, K, moe["capacity_factor"], E)
        flat = ids[a:b].reshape(-1)
        onehot = torch.nn.functional.one_hot(flat, E)
        pos = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
        keep[a:b] = (pos < cap).view(b - a, K)
    out = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero((ids == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        lin = {n: _Lin(m[n][e], precision) for n in ("w1", "w3", "w2")}
        y = _mlp(h[tok], lin)
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out


def class_logits(spec: Mapping, params: Mapping, seqs: Sequence[Seq],
                 classes: Sequence[int], precision: str = "f32"
                 ) -> torch.Tensor:
    """Logits of the class tokens at each sequence's last position,
    [len(seqs), len(classes)] in float32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _class_logits(spec, params, seqs, classes, precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _class_logits(spec, params, seqs, classes, precision):
    table = params["embed"]["table"]
    dev = table.device
    eps = spec["norm_eps"]
    xs = [table[torch.tensor(s.tokens, device=dev)].float() for s in seqs]
    for lp in params["layers"]:
        a = lp["attn"]
        d = a["wq"].shape[0]
        lin = {n: _Lin(a[n].reshape(d, -1), precision)
               for n in ("wq", "wk", "wv")}
        lin["wo"] = _Lin(a["wo"].reshape(-1, d), precision)
        if "mlp" in lp:
            lin.update({n: _Lin(lp["mlp"][n], precision)
                        for n in ("w1", "w3", "w2")})
        for i, s in enumerate(seqs):
            x = xs[i]
            x = x + _attention(_rms(x, lp["norm1"]["scale"], eps), lp, spec,
                               lin)
            h2 = _rms(x, lp["norm2"]["scale"], eps)
            x = x + (_moe(h2, s, lp, spec, precision) if "moe" in lp
                     else _mlp(h2, lin))
            xs[i] = x
        del lin
    head = _Lin(table[torch.tensor(list(classes), device=dev)].t(),
                precision)
    last = torch.stack([x[-1] for x in xs])
    return head(_rms(last, params["final_norm"]["scale"], eps))
