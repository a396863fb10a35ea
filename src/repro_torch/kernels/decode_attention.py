"""Flash-decoding: one new query token per sequence over a KV cache.

Two entry points share one CUDA body (``csrc/decode_attention.cu``):

``decode_attention``
    dense cache — q [B, Hq, Dh] over k/v [B, S, Hkv, Dh]: row b of the
    cache belongs to sequence b (the body reads row b directly).

``paged_decode_attention``
    paged cache — k/v are a slot ARENA [N_rows, S, Hkv, Dh] and sequence b
    reads row ``slots[b]``, or row ``block_tables[b, pos // table_block]``
    per cache block.  The scratch row ``N_rows - 1`` is a legal, repeatable
    sentinel.

They replace ``decode_attention_pallas`` and
``paged_decode_attention_pallas`` of the JAX package.  Both take CUDA
tensors only and raise otherwise; ``*_plain`` are the plain PyTorch
versions of the same functions, which ``kernels.ops`` uses for CPU tensors
and ``chip_smoke.py`` holds the kernels against on the card.
``LAUNCHES`` counts kernel launches per entry point.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build, ref

LAUNCHES: Dict[str, int] = {"decode_attention": 0,
                            "paged_decode_attention": 0}

_SLOT_BLOCK = 1 << 30       # table granularity meaning "one row per sequence"


def _check_common(q, k, v, kv_len, where: str) -> None:
    tensors = (q, k, v, kv_len)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{where}: expects CUDA tensors")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{where}: tensors on different devices")
    if q.dtype not in _build.DTYPE_CODES or k.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{where}: dtypes {q.dtype}/{k.dtype} unsupported")
    if v.dtype != k.dtype or v.shape != k.shape:
        raise ValueError(f"{where}: k/v must share shape and dtype")
    if q.dim() != 3 or k.dim() != 4 or not q.is_contiguous():
        raise ValueError(f"{where}: q must be contiguous [B, Hq, Dh] and "
                         "the cache [rows, S, Hkv, Dh]")
    B, Hq, Dh = q.shape
    if k.shape[3] != Dh or Dh not in _build.HEAD_DIMS or Hq % k.shape[2]:
        raise ValueError(f"{where}: head_dim {Dh} / heads {Hq}:{k.shape[2]} "
                         "unsupported")
    if k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{where}: cache head_dim axis must be contiguous")
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise ValueError(f"{where}: kv_len must be int32 [B]")


def _launch(q, k, v, rows, rows_stride: int, table_block: int, kv_len,
            sm_scale: Optional[float], where: str) -> torch.Tensor:
    B, Hq, Dh = q.shape
    _, S, Hkv, _ = k.shape
    scale = sm_scale if sm_scale is not None else 1.0 / (Dh ** 0.5)
    out = torch.empty_like(q)
    lib = _build.library("decode_attention")
    with torch.cuda.device(q.device):
        err = lib.repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if rows is None else rows.data_ptr(), rows_stride,
            table_block, kv_len.data_ptr(), B, Hq, Hkv, S, Dh,
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), scale,
            _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, where)
    LAUNCHES[where] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """Dense decode: q [B, Hq, Dh] over k/v [B, S, Hkv, Dh] (strided views
    allowed), keys at or past ``kv_len[b]`` masked.  CUDA kernel."""
    _check_common(q, k, v, kv_len, "decode_attention")
    if k.shape[0] != q.shape[0]:
        raise ValueError("decode_attention: cache batch != query batch")
    return _launch(q, k, v, None, 0, _SLOT_BLOCK, kv_len, sm_scale,
                   "decode_attention")


def paged_decode_attention(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, slots: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           block_tables: Optional[torch.Tensor] = None,
                           table_block: Optional[int] = None,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode straight from the arena (no gather copy).  CUDA kernel.

    Row ids are NOT range-checked here (that would cost a device->host
    sync per layer); callers validate them on the host once per launch
    (``kernels.ops._check_slots``)."""
    _check_common(q, k_arena, v_arena, kv_len, "paged_decode_attention")
    if block_tables is None:
        rows, stride, tb = slots, 1, _SLOT_BLOCK
    else:
        rows, stride, tb = block_tables, block_tables.shape[1], table_block
        if tb is None or tb <= 0:
            raise ValueError("paged_decode_attention: block_tables needs a "
                             "positive table_block")
    if (not rows.is_cuda or rows.device != q.device
            or rows.dtype != torch.int32 or not rows.is_contiguous()
            or rows.shape[0] != q.shape[0]):
        raise ValueError("paged_decode_attention: row ids must be a "
                         "contiguous int32 CUDA tensor with batch rows")
    return _launch(q, k_arena, v_arena, rows, stride, tb, kv_len, sm_scale,
                   "paged_decode_attention")


def decode_attention_plain(q, k, v, kv_len, *, sm_scale=None):
    """Plain PyTorch version of :func:`decode_attention`."""
    return ref.decode_reference(q, k, v, kv_len=kv_len, sm_scale=sm_scale)


def paged_decode_attention_plain(q, k_arena, v_arena, slots, kv_len, *,
                                 block_tables=None, table_block=None,
                                 sm_scale=None):
    """Plain PyTorch version of :func:`paged_decode_attention`: gather the
    addressed rows (a pure bit move), then the dense reference."""
    k = ref.gather_rows(k_arena, slots, block_tables, table_block)
    v = ref.gather_rows(v_arena, slots, block_tables, table_block)
    return ref.decode_reference(q, k, v, kv_len=kv_len, sm_scale=sm_scale)
