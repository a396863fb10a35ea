"""The default reference family: pre-norm blocks of grouped-query causal
attention with a gated MLP or a softmax top-k mixture of experts, as the
four published models the benchmark first served have them.

A model entry of ``bench/configs/<config>.json`` names its family with
``"reference"``; without the key it is this one.  The spec is the entry's
``"port"``.

Weights (``make_params``): random, made by the benchmark on the device
from a seed, in the layout that the program's ``LM`` takes
(``LMBackend(params=...)``) and the reference reads: ``embed.table``
``[V, d]``, ``final_norm.scale``, and per layer ``norm1``, ``attn``
(``wq [d, H, Dh]``, ``wk``/``wv [d, KV, Dh]``, ``wo [H, Dh, d]``, the
q/k norms where the model has them), ``norm2`` and ``mlp`` (``w1``/``w3
[d, F]``, ``w2 [F, d]``) or ``moe`` (``router [d, E]`` in float32,
``w1``/``w3 [E, d, F]``, ``w2 [E, F, d]``).  Each tensor is one call of
``normal_`` in the served dtype on a ``torch.Generator`` of the device:
matrices at standard deviation ``1 / sqrt(fan_in)``, the embedding at
0.02, norm scales at one.

Forward pass (``class_logits``), float32 with TF32 off: token embedding,
the blocks (per-head q/k RMS norm where ``qk_norm``; rotary positions,
M-RoPE sections where ``mrope_sections``, a text-only input putting the
same position on all three channels), a final RMS norm and the tied
head.  Each sequence runs whole, layer by layer, so a layer's weights
are widened to float32 once for all sequences.

The mixture of experts follows the capacity rule the program states
(``models/moe.py``): per chunk of ``s`` padded tokens every expert takes
``int(s * top_k * (capacity_factor * 1.6) / E)`` assignments (at least
1, rounded up to a multiple of 128 from 128 on), in token-major order,
and drops the rest; the router's softmax top-k weights are renormalised.
``precision="router_bf16"`` is float32 with only the router's input
rounded to bfloat16: it shows how far the experts' discrete choice alone
moves an answer.  ``precision="fp8"`` is the control
(``bench/reference/layers.py``).

Work counts, from logical shapes only (one layer, one call over a
launch's documents):

* extend: a document with ``c`` cached and ``n`` new tokens runs ``n``
  queries, query ``i`` over ``c + i + 1`` keys (causal).  Operations
  ``4 * Hq * Dh * sum(keys)`` (QK^T and PV); bytes: Q and O once
  (``2 * n * Hq * Dh`` elements), K and V once (``2 * (c + n) * Hkv *
  Dh`` elements).
* decode: one query over ``kv`` keys: ``4 * Hq * Dh * kv`` operations;
  ``2 * Hq * Dh + 2 * kv * Hkv * Dh`` elements.
* active parameters a token: the layers' attention and MLP, the MoE at
  its top-k experts and its router; the head: ``d * V``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Sequence, Tuple

import torch

from bench.reference.layers import (Lin, Seq, causal_attention, exact_f32,
                                    gated_mlp, rms, rope)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ----------------------------------------------------------------- weights
def make_params(spec: Mapping, seed: int, device) -> Dict[str, Any]:
    dt = DTYPES[spec["dtype"]]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d, H, KV = spec["d_model"], spec["num_heads"], spec["num_kv_heads"]
    dh, F, V = spec["head_dim"], spec["d_ff"], spec["vocab_size"]

    def mat(shape, fan_in, dtype=dt):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, fan_in ** -0.5, generator=gen)

    def ones(n):
        return {"scale": torch.ones(n, dtype=torch.float32, device=device)}

    table = torch.empty((V, d), dtype=dt, device=device)
    layers = []
    for _ in range(spec["num_layers"]):
        attn = {"wq": mat((d, H, dh), d), "wk": mat((d, KV, dh), d),
                "wv": mat((d, KV, dh), d), "wo": mat((H, dh, d), H * dh)}
        if spec.get("qk_norm"):
            attn["q_norm"], attn["k_norm"] = ones(dh), ones(dh)
        lp = {"norm1": ones(d), "attn": attn, "norm2": ones(d)}
        moe = spec.get("moe")
        if moe:
            E = moe["num_experts"]
            lp["moe"] = {"router": mat((d, E), d, torch.float32),
                         "w1": mat((E, d, F), d), "w3": mat((E, d, F), d),
                         "w2": mat((E, F, d), F)}
        else:
            lp["mlp"] = {"w1": mat((d, F), d), "w3": mat((d, F), d),
                         "w2": mat((F, d), F)}
        layers.append(lp)
    table.normal_(0.0, 0.02, generator=gen)
    return {"embed": {"table": table}, "final_norm": ones(d),
            "layers": layers}


def looks(spec: Mapping) -> Tuple[str, ...]:
    """The precisions beside f32 and fp8 that say something of this
    model: the router's alone where it has experts."""
    return ("router_bf16",) if spec.get("moe") else ()


# ---------------------------------------------------------------- forward
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
        q = rms(q, a["q_norm"]["scale"], eps)
        k = rms(k, a["k_norm"]["scale"], eps)
    pos = torch.arange(S, device=h.device)
    sec = spec.get("mrope_sections")
    q = rope(q, pos, spec["rope_theta"], sec)
    k = rope(k, pos, spec["rope_theta"], sec)
    g = H // kvh
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    return lin["wo"](causal_attention(q, k, v))


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
        lin = {n: Lin(m[n][e], precision) for n in ("w1", "w3", "w2")}
        y = gated_mlp(h[tok], lin)
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out


def class_logits(spec: Mapping, params: Mapping, seqs: Sequence[Seq],
                 classes: Sequence[int], precision: str = "f32"
                 ) -> torch.Tensor:
    """Logits of the class tokens at each sequence's last position,
    [len(seqs), len(classes)] in float32."""
    with exact_f32():
        return _class_logits(spec, params, seqs, classes, precision)


def _class_logits(spec, params, seqs, classes, precision):
    table = params["embed"]["table"]
    dev = table.device
    eps = spec["norm_eps"]
    xs = [table[torch.tensor(s.tokens, device=dev)].float() for s in seqs]
    for lp in params["layers"]:
        a = lp["attn"]
        d = a["wq"].shape[0]
        lin = {n: Lin(a[n].reshape(d, -1), precision)
               for n in ("wq", "wk", "wv")}
        lin["wo"] = Lin(a["wo"].reshape(-1, d), precision)
        if "mlp" in lp:
            lin.update({n: Lin(lp["mlp"][n], precision)
                        for n in ("w1", "w3", "w2")})
        for i, s in enumerate(seqs):
            x = xs[i]
            x = x + _attention(rms(x, lp["norm1"]["scale"], eps), lp, spec,
                               lin)
            h2 = rms(x, lp["norm2"]["scale"], eps)
            x = x + (_moe(h2, s, lp, spec, precision) if "moe" in lp
                     else gated_mlp(h2, lin))
            xs[i] = x
        del lin
    head = Lin(table[torch.tensor(list(classes), device=dev)].t(),
               precision)
    last = torch.stack([x[-1] for x in xs])
    return head(rms(last, params["final_norm"]["scale"], eps))


# ------------------------------------------------------------ work counts
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


def attention_layers(spec: Mapping) -> int:
    return spec["num_layers"]


def extend_call(spec: Mapping, docs: Iterable[Tuple[int, int]]
                ) -> Tuple[float, float]:
    """(operations, bytes) of one layer's extend over ``(cached, new)``
    per document."""
    sh = shape_of(spec)
    flops = elems = 0.0
    for c, n in docs:
        if n <= 0:
            continue
        keys = n * c + n * (n + 1) / 2
        flops += 4.0 * sh.heads * sh.head_dim * keys
        elems += 2.0 * n * sh.heads * sh.head_dim \
            + 2.0 * (c + n) * sh.kv_heads * sh.head_dim
    return flops, elems * sh.elem_bytes


def decode_call(spec: Mapping, kvs: Iterable[int]) -> Tuple[float, float]:
    """(operations, bytes) of one layer's decode step over each
    document's key count."""
    sh = shape_of(spec)
    flops = elems = 0.0
    for kv in kvs:
        flops += 4.0 * sh.heads * sh.head_dim * kv
        elems += 2.0 * sh.heads * sh.head_dim \
            + 2.0 * kv * sh.kv_heads * sh.head_dim
    return flops, elems * sh.elem_bytes


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


def head_params(spec: Mapping) -> float:
    """Parameters of the head a computed row passes through: its
    ``vocab_size`` rows of width ``d_model``."""
    return float(spec["d_model"] * spec["vocab_size"])
