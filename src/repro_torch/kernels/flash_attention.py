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

bf16 q with a bf16 cache runs the tensor-core body (bf16 products, the
softmax weights rounded to bf16 for P.V, f32 accumulation), which needs
16-byte aligned q/k/v data and strides that are multiples of 8 elements;
an f32 q or cache runs the f32 FMA body.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build, ref

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
