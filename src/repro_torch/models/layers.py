"""Primitive layers: RMS and layer norms, rotary embeddings (M-RoPE
included), SwiGLU and plain GELU MLPs, sinusoidal positions, embedding and
the tied LM head.

Functional pairs ``init_*(gen, ...) -> params`` / ``*_apply(params, x)``
over plain dicts of tensors, with the JAX package's parameter layouts so
converted weights drop in unchanged.  Initializers draw from an explicit
``torch.Generator`` on the target device.

Tensor parallelism (``tp_mesh``, a mesh whose ``model`` axis is larger
than 1, with the parameters held as this rank's shards of their
``spec_*``): the gated MLP is column-parallel in ``w1``/``w3`` and
row-parallel in ``w2`` (``copy_to_model``, the local columns, the local
rows, ``reduce_from_model``), and so is whisper's GELU ``mlp2`` in
``w1``/``b1`` and ``w2``, its replicated ``b2`` added once after the
sum; the embedding looks up the rows of its vocab shard, masks the
others and sums over ``model``; the tied head gives this rank's shard of
the logits, ``[..., V / tp]``.  The norms act on the residual stream,
which every rank holds whole, with replicated scales (and layer-norm
biases): they have no tensor-parallel form.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.collectives import copy_to_model, reduce_from_model
from ..distributed.compat import axis_index


def _dense_init(gen: torch.Generator, shape, in_axis_size: int,
                dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return ((u * 2.0 - 1.0) * scale).to(dtype)


def init_dense(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return _dense_init(gen, shape, shape[0], dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def spec_rmsnorm():
    return {"scale": (None,)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def spec_layernorm():
    return {"scale": (None,), "bias": (None,)}


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    """LayerNorm in f32 (population variance), cast back to ``x.dtype``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Standard RoPE.  x: [B, S, H, Dh]; positions: [B, S] (int)."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                # [dh/2]
    ang = positions[..., None].float() * inv             # [B, S, dh/2]
    cos = torch.cos(ang)[:, :, None, :]                  # [B, S, 1, dh/2]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: [B, S, H, Dh]; positions3: [B, S, 3] (t, h, w) position ids.
    ``sections`` counts the frequency PAIRS of each of t, h, w
    (``sum(sections) == Dh // 2``): frequency ``i`` rotates by the position
    channel of its section, in f32, as the JAX package's ``apply_mrope``.
    """
    dh = x.shape[-1]
    half = dh // 2
    assert sum(sections) == half, (sections, dh)
    inv = rope_freqs(dh, theta, x.device)                # [half]
    # each frequency's position channel, by slicing: no index tensor is
    # copied to the device, so a CUDA graph can capture the layer
    p3 = positions3.float()
    pos = torch.cat([p3[..., c:c + 1].expand(*p3.shape[:-1], n)
                     for c, n in enumerate(sections)], dim=-1)  # [B, S, half]
    ang = pos * inv
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs (SwiGLU; plain two-layer GELU for whisper)
# ---------------------------------------------------------------------------

# "gelu" is the tanh approximation, jax.nn.gelu's default
ACTS = {"silu": F.silu, "gelu": functools.partial(F.gelu, approximate="tanh"),
        "relu": F.relu}


def init_mlp(gen: torch.Generator, d: int, f: int, dtype) -> dict:
    return {
        "w1": _dense_init(gen, (d, f), d, dtype),
        "w3": _dense_init(gen, (d, f), d, dtype),
        "w2": _dense_init(gen, (f, d), f, dtype),
    }


def spec_mlp():
    return {"w1": (None, "tp"), "w3": (None, "tp"), "w2": ("tp", None)}


def mlp_apply(params, x: torch.Tensor, act: str = "silu",
              tp_mesh=None) -> torch.Tensor:
    a = ACTS[act]
    if tp_mesh is not None:
        x = copy_to_model(x, tp_mesh)
    h = a(x @ params["w1"]) * (x @ params["w3"])
    y = h @ params["w2"]
    return y if tp_mesh is None else reduce_from_model(y, tp_mesh)


def init_mlp2(gen: torch.Generator, d: int, f: int, dtype) -> dict:
    """Plain 2-layer MLP (whisper-style, no gating); biases in f32."""
    return {
        "w1": _dense_init(gen, (d, f), d, dtype),
        "b1": torch.zeros((f,), dtype=torch.float32, device=gen.device),
        "w2": _dense_init(gen, (f, d), f, dtype),
        "b2": torch.zeros((d,), dtype=torch.float32, device=gen.device),
    }


def spec_mlp2():
    return {"w1": (None, "tp"), "b1": ("tp",), "w2": ("tp", None),
            "b2": (None,)}


def mlp2_apply(params, x: torch.Tensor, act: str = "gelu",
               tp_mesh=None) -> torch.Tensor:
    """``act(x W1 + b1) W2 + b2``, the f32 biases cast to ``x.dtype``
    (tensor-parallel: the module docstring)."""
    if tp_mesh is not None:
        x = copy_to_model(x, tp_mesh)
    h = ACTS[act](x @ params["w1"] + params["b1"].to(x.dtype))
    y = h @ params["w2"]
    if tp_mesh is not None:
        y = reduce_from_model(y, tp_mesh)
    return y + params["b2"].to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal encodings in f32: positions [...] -> [..., d] (sines,
    then cosines; the JAX package's ``max(half - 1, 1)`` denominator)."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d: int, dtype) -> dict:
    t = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32) * 0.02
    return {"table": t.to(dtype)}


def spec_embed():
    # vocab-parallel embedding: rows sharded over the model axis
    return {"table": ("tp", None)}


def embed_apply(params, tokens: torch.Tensor, tp_mesh=None) -> torch.Tensor:
    table = params["table"]
    if tp_mesh is None:
        return table[tokens]
    lo = axis_index(tp_mesh, "model") * table.shape[0]
    local = tokens.long() - lo
    mine = (local >= 0) & (local < table.shape[0])
    x = table[torch.where(mine, local, 0)]
    return reduce_from_model(torch.where(mine[..., None], x, 0.0).to(
        table.dtype), tp_mesh)


class _HeadMatmul(torch.autograd.Function):
    """``x2 @ table.T`` of two bf16 operands with an f32 result, on the
    tensor cores (``torch.mm(..., out_dtype=float32)``, which has no
    derivative of its own).  The backward rounds the f32 logit gradient
    to the operands' dtype, then accumulates both products in f32."""

    @staticmethod
    def forward(ctx, x2, table):
        ctx.save_for_backward(x2, table)
        return torch.mm(x2, table.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, table = ctx.saved_tensors
        g = g.to(table.dtype)
        dx = dt = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, table, out_dtype=torch.float32).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dt = torch.mm(g.t(), x2, out_dtype=torch.float32).to(
                table.dtype)
        return dx, dt


def lm_head_apply(params, x: torch.Tensor,
                  softcap: Optional[float] = None,
                  tp_mesh=None) -> torch.Tensor:
    """Tied head: logits = x @ table.T with f32 ACCUMULATION and f32 out.

    On the card a bf16 table stays in its storage dtype (cuBLAS bf16
    product with an f32 result) instead of materializing an f32 copy of
    the whole vocab table every step, in training too (``_HeadMatmul``);
    on the CPU the product runs in f32.  ``meta`` tensors (the dry-run)
    take the card's route, which is what the dry-run counts.
    """
    table = params["table"]
    if tp_mesh is not None:
        x = copy_to_model(x, tp_mesh)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == torch.float32 and table.dtype == torch.float32:
        logits = x2 @ table.t()
    elif x2.is_cuda or x2.is_meta:
        logits = _HeadMatmul.apply(x2, table)
    else:
        logits = x2.float() @ table.float().t()
    logits = logits.reshape(*lead, table.shape[0])
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
