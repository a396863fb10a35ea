"""Blocked flash attention with prefix-extend semantics.

Two entry points share one CUDA body (``csrc/flash_attention.cu``):

``flash_attention``
    dense k/v [B, Skv, Hkv, Dh] (strided views allowed) — prefill and the
    gather plane's extend.

``paged_flash_attention``
    keys read straight from a slot arena [N_rows, S_alloc, Hkv, Dh] at
    positions ``[0, kv_valid)`` through ``slots`` [B] or per-block
    ``block_tables`` — the paged plane's prefill-into-arena and fraction
    extension.

Queries q [B, Sq, Hq, Dh] are the suffix ``[q_offset, q_offset + Sq)`` of
each sequence.  Masks: causal or bidirectional, sliding ``window``,
per-row ``kv_len``, GQA.  They replace ``flash_attention_pallas`` and
``paged_flash_attention_pallas`` of the JAX package.  Both take CUDA
tensors only and raise otherwise; ``*_plain`` are the plain PyTorch
versions.  ``LAUNCHES`` counts kernel launches per entry point.
``work`` is the bytes and operations of one call, the card's lower
bound: ``chip_smoke.py``'s bounds and the dry-run's counts
(``flash_attention_meta``, for tensors on the ``meta`` device, which
compute nothing) both come from it.  ``tile`` is the tensor-core body's
query and key tile at a head_dim (``TcTile`` in the CUDA source).

bf16 q with a bf16 cache runs the tensor-core body (bf16 products, the
softmax weights rounded to bf16 for P.V, f32 accumulation), which needs
16-byte aligned q/k/v data and strides that are multiples of 8 elements;
an f32 q or cache runs the f32 FMA body.

Training: ``FlashAttentionFn`` is the differentiable dense entry.  Its
forward is the kernel on a CUDA tensor (the plain version on a CPU
tensor); its backward is ``flash_attention_grad``, PyTorch on any
device.  No Pallas kernel of the JAX package has a backward: it trains
through ``xla_flash_attention``, a blocked ``lax.scan`` that XLA
differentiates, so the backward here is the same gradient written out
(f32 recomputed scores, the ``rowsum(dout * out)`` identity), not a
port of a TPU kernel.  Its cost on the card stands beside SDPA's in
``PERF.md``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build, ref
from .meta import compute_dtype, meta_call

LAUNCHES: Dict[str, int] = {"flash_attention": 0,
                            "paged_flash_attention": 0}

_SLOT_BLOCK = 1 << 30       # table granularity meaning "one row per sequence"


def _launch(q, k, v, rows, rows_stride: int, table_block: int, *,
            kv_valid: int, causal: bool, window: Optional[int],
            q_offset: int, kv_len: Optional[torch.Tensor],
            sm_scale: Optional[float], where: str) -> torch.Tensor:
    tensors = [q, k, v] + ([] if kv_len is None else [kv_len]) \
        + ([] if rows is None else [rows])
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{where}: expects CUDA tensors on one device")
    if q.dtype not in _build.DTYPE_CODES or k.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{where}: dtypes {q.dtype}/{k.dtype} unsupported")
    if v.dtype != k.dtype or v.shape != k.shape or q.dim() != 4 \
            or k.dim() != 4:
        raise ValueError(f"{where}: q [B, Sq, Hq, Dh] and k/v "
                         "[rows, S, Hkv, Dh] of one shape and dtype")
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    if k.shape[3] != Dh or Dh not in _build.HEAD_DIMS or Hq % Hkv:
        raise ValueError(f"{where}: head_dim {Dh} / heads {Hq}:{Hkv} "
                         "unsupported")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{where}: head_dim axes must be contiguous")
    if q.dtype == k.dtype == torch.bfloat16 and not all(
            t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape)
                    if n > 1) for t in (q, k, v)):
        # the tensor-core body copies 16-byte pieces of q/k/v rows
        raise ValueError(f"{where}: bf16 q/k/v need 16-byte aligned data "
                         "and strides that are multiples of 8 elements")
    if not 0 < kv_valid <= k.shape[1]:
        raise ValueError(f"{where}: kv_valid {kv_valid} outside "
                         f"(0, {k.shape[1]}]")
    if kv_len is not None and (kv_len.dtype != torch.int32
                               or kv_len.shape != (B,)):
        raise ValueError(f"{where}: kv_len must be int32 [B]")
    if rows is not None and (rows.dtype != torch.int32
                             or not rows.is_contiguous()
                             or rows.shape[0] != B):
        raise ValueError(f"{where}: row ids must be contiguous int32 "
                         "with batch rows")
    scale = sm_scale if sm_scale is not None else 1.0 / (Dh ** 0.5)
    out = torch.empty((B, Sq, Hq, Dh), dtype=q.dtype, device=q.device)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if rows is None else rows.data_ptr(), rows_stride,
            table_block, None if kv_len is None else kv_len.data_ptr(),
            B, Sq, Hq, Hkv, kv_valid, Dh,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), int(window or 0), int(q_offset), scale,
            _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, where)
    LAUNCHES[where] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, kv_len: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Dense flash attention over k/v [B, Skv, Hkv, Dh].  CUDA kernel."""
    if k.shape[0] != q.shape[0]:
        raise ValueError("flash_attention: k/v batch != query batch")
    return _launch(q, k, v, None, 0, _SLOT_BLOCK, kv_valid=k.shape[1],
                   causal=causal, window=window, q_offset=q_offset,
                   kv_len=kv_len, sm_scale=sm_scale,
                   where="flash_attention")


def paged_flash_attention(q: torch.Tensor, k_arena: torch.Tensor,
                          v_arena: torch.Tensor, slots: torch.Tensor, *,
                          kv_valid: int,
                          block_tables: Optional[torch.Tensor] = None,
                          table_block: Optional[int] = None,
                          causal: bool = True, window: Optional[int] = None,
                          q_offset: int = 0,
                          kv_len: Optional[torch.Tensor] = None,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """Prefix-extend attention reading K/V straight from the arena (keys
    ``[0, kv_valid)`` of the addressed rows).  CUDA kernel.  Row ids are
    validated by callers on the host (see ``kernels.ops``)."""
    if block_tables is None:
        rows, stride, tb = slots, 1, _SLOT_BLOCK
    else:
        if table_block is None or table_block <= 0:
            raise ValueError("paged_flash_attention: block_tables needs a "
                             "positive table_block")
        rows, stride, tb = block_tables, block_tables.shape[1], table_block
    return _launch(q, k_arena, v_arena, rows, stride, tb, kv_valid=kv_valid,
                   causal=causal, window=window, q_offset=q_offset,
                   kv_len=kv_len, sm_scale=sm_scale,
                   where="paged_flash_attention")


def tile(head_dim: int) -> Tuple[int, int]:
    """(query rows, keys) of a tensor-core block at ``head_dim``: 16 rows
    a warp, 8 warps from Dh 128 and 4 below; 64-key tiles, 32 at Dh
    256 (``TcTile`` in ``csrc/flash_attention.cu``)."""
    return (128 if head_dim >= 128 else 64), (32 if head_dim >= 256 else 64)


def work(B: int, Sq: int, Hq: int, Hkv: int, Dh: int, Skv: int, *,
         causal: bool = True, window: Optional[int] = None,
         q_offset: int = 0, kv_len: Optional[Sequence[int]] = None,
         q_itemsize: int = 2, kv_itemsize: int = 2, rows: bool = False
         ) -> Tuple[float, float]:
    """(bytes, operations) one call must spend at the least.  Query ``i``
    sits at ``q_offset + i`` and sees keys below ``n_b = min(kv_len[b],
    Skv)`` (all ``Skv`` when ``kv_len`` is None, as on ``meta`` tensors),
    at or before itself when ``causal``, within ``window`` of it.  Bytes:
    K and V of each key some query of a sequence sees, read once; q read
    and the output written once; ``kv_len`` and, for the paged entry
    (``rows``), the row ids read once.  Operations: 4 * Dh a query head
    and visible (query, key) pair (q.k and p.v, a multiply and an add
    each)."""
    n = np.full(B, Skv, np.int64) if kv_len is None \
        else np.clip(np.asarray(kv_len, np.int64), 0, Skv)
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi_q = qpos + 1 if causal else np.full(Sq, Skv, np.int64)
    lo_q = np.maximum(qpos - window + 1, 0) if window \
        else np.zeros(Sq, np.int64)
    top = q_offset + Sq if causal else Skv
    bottom = max(q_offset - window + 1, 0) if window else 0
    pairs = keys = 0.0
    for nb in np.unique(n):
        count = int((n == nb).sum())
        pairs += count * float(np.clip(np.minimum(hi_q, nb) - lo_q, 0,
                                       None).sum())
        keys += count * float(max(min(nb, top) - bottom, 0))
    nbytes = (keys * Hkv * Dh * kv_itemsize * 2 + 2 * B * Sq * Hq * Dh
              * q_itemsize + B * 4 * ((kv_len is not None) + rows))
    return nbytes, 4.0 * Hq * Dh * pairs


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         q_offset: int = 0, kv_len=None):
    """The dense entry on ``meta`` tensors: (output stand-in, bytes,
    operations, compute dtype), every key below ``Skv`` counted as valid
    (a ``meta`` ``kv_len`` holds no values; its bytes are counted)."""
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    nbytes, flops = work(B, Sq, Hq, Hkv, Dh, Skv, causal=causal,
                         window=window, q_offset=q_offset,
                         q_itemsize=q.element_size(),
                         kv_itemsize=k.element_size())
    if kv_len is not None:
        nbytes += B * 4
    return (torch.empty(q.shape, dtype=q.dtype, device="meta"), nbytes,
            flops, compute_dtype(q, k))


def flash_attention_plain(q, k, v, *, causal=True, window=None, q_offset=0,
                          kv_len=None, sm_scale=None):
    """Plain PyTorch version of :func:`flash_attention`."""
    return ref.mha_reference(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_len=kv_len,
                             sm_scale=sm_scale)


def paged_flash_attention_plain(q, k_arena, v_arena, slots, *, kv_valid,
                                block_tables=None, table_block=None,
                                causal=True, window=None, q_offset=0,
                                kv_len=None, sm_scale=None):
    """Plain PyTorch version of :func:`paged_flash_attention`: gather the
    addressed rows' first ``kv_valid`` keys, then the dense reference."""
    k = ref.gather_rows(k_arena, slots, block_tables, table_block)
    v = ref.gather_rows(v_arena, slots, block_tables, table_block)
    return ref.mha_reference(q, k[:, :kv_valid], v[:, :kv_valid],
                             causal=causal, window=window, q_offset=q_offset,
                             kv_len=kv_len, sm_scale=sm_scale)


# Score elements (f32) a backward query block may hold at once: 64 Mi
# elements, 256 MiB per [B, Hq, block, Skv] temporary.
GRAD_BLOCK_ELEMS = 1 << 26


def _grad_mask(i0: int, i1: int, k0: int, k1: int, *, causal: bool,
               window: Optional[int], q_offset: int,
               kv_len: Optional[torch.Tensor], device) -> torch.Tensor:
    """The forward's mask predicate for queries ``[i0, i1)`` over keys
    ``[k0, k1)``: [B or 1, i1 - i0, k1 - k0] bool, True = visible."""
    qpos = q_offset + torch.arange(i0, i1, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    mask = torch.ones((i1 - i0, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None and window > 0:
        mask &= kpos > qpos - window
    mask = mask[None]
    if kv_len is not None:
        mask = mask & (kpos[None] < kv_len.to(device).long()[:, None, None])
    return mask


def flash_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, dout: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         q_offset: int = 0,
                         kv_len: Optional[torch.Tensor] = None,
                         sm_scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` for the upstream ``dout``.

    Recomputes the masked scores in f32 one query block at a time (at
    most ``GRAD_BLOCK_ELEMS`` score elements), over only the keys that the
    causal and window masks leave visible to some query of the block;
    normalises them as the forward does (masked keys weigh 0, a row's sum
    clamped at 1e-30), and forms ``dS = P * (dout V^T - rowsum(dout *
    out))``.  dk and dv sum the query heads of each GQA group.  A query
    row with no visible key gets zero gradients, as its forward output is
    zero.  Returns dq in q's dtype, dk and dv in k's."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (Dh ** 0.5)
    kf = k.float().permute(0, 2, 1, 3)                   # [B, Hkv, Skv, Dh]
    vf = v.float().permute(0, 2, 1, 3)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dq = torch.zeros((B, Sq, Hq, Dh), dtype=torch.float32, device=q.device)
    bq = max(1, min(Sq, GRAD_BLOCK_ELEMS // max(B * Hq * Skv, 1)))

    def heads(t):   # [B, n, Hq, Dh] -> [B, Hkv, g * n, Dh] (f32)
        n = t.shape[1]
        return (t.float().reshape(B, n, Hkv, g, Dh).permute(0, 2, 3, 1, 4)
                .reshape(B, Hkv, g * n, Dh))

    for i0 in range(0, Sq, bq):
        i1 = min(i0 + bq, Sq)
        n = i1 - i0
        # keys some query of the block may see: causal caps the top,
        # the window the bottom
        k1 = min(Skv, q_offset + i1) if causal else Skv
        k0 = max(0, q_offset + i0 - window + 1) if window else 0
        if k1 <= k0:
            continue
        kb, vb = kf[:, :, k0:k1], vf[:, :, k0:k1]
        qs = heads(q[:, i0:i1]) * scale
        do = heads(dout[:, i0:i1])
        s = (qs @ kb.transpose(-1, -2)).view(B, Hkv, g, n, k1 - k0)
        mask = _grad_mask(i0, i1, k0, k1, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len,
                          device=q.device)[:, None, None]
        s = torch.where(mask, s, ref.NEG_INF)
        p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
        p = p.view(B, Hkv, g * n, k1 - k0)
        dp = do @ vb.transpose(-1, -2)
        rowsum = (do * heads(out[:, i0:i1])).sum(-1, keepdim=True)
        ds = p * (dp - rowsum)
        dv[:, :, k0:k1] += p.transpose(-1, -2) @ do
        dk[:, :, k0:k1] += ds.transpose(-1, -2) @ qs
        dq[:, i0:i1] = ((ds @ kb) * scale).view(B, Hkv, g, n, Dh) \
            .permute(0, 3, 1, 2, 4).reshape(B, n, Hq, Dh)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable dense flash attention.  Forward: the CUDA kernel on
    a CUDA ``q`` (through ``flash_attention``, counted in ``LAUNCHES``),
    the plain version on a CPU one; backward: ``flash_attention_grad``.
    No gradient flows to ``kv_len``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, window, q_offset, sm_scale):
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_len=kv_len, sm_scale=sm_scale)
        if q.is_cuda:
            out = flash_attention(q, k, v, **kw)
        elif q.is_meta:
            out = meta_call("flash_attention", *flash_attention_meta(
                q, k, causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len))
        else:
            out = flash_attention_plain(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, kv_len)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset,
                      sm_scale=sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, kv_len = ctx.saved_tensors
        dq, dk, dv = flash_attention_grad(q, k, v, out, dout,
                                          kv_len=kv_len, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
