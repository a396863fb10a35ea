"""Flash-decoding: one new query token per sequence over a KV cache.

Three entry points share one CUDA body (``csrc/decode_attention.cu``):

``decode_attention``
    dense cache — q [B, Hq, Dh] over k/v [B, S, Hkv, Dh]: row b of the
    cache belongs to sequence b (the body reads row b directly).

``paged_decode_attention``
    paged cache — k/v are a slot ARENA [N_rows, S, Hkv, Dh] and sequence b
    reads row ``slots[b]``, or row ``block_tables[b, pos // table_block]``
    per cache block.  The scratch row ``N_rows - 1`` is a legal, repeatable
    sentinel.

``decode_attention_lse``
    the dense entry's log-sum-exp parts: f32 ``[B, Hq, Dh + 2]`` holding
    the merged unnormalized ``acc[Dh]``, then ``l`` and ``m`` (scores
    scaled by ``sm_scale``, natural-log base; ``m = -inf``, ``l = 0``,
    ``acc = 0`` for a row with no visible key).  It is the local body of
    sequence-parallel decode (``distributed.collectives``), which merges
    the ranks' parts: the JAX package's ``_local_decode_lse``.

They replace ``decode_attention_pallas`` and
``paged_decode_attention_pallas`` of the JAX package.  Both take CUDA
tensors only and raise otherwise; ``*_plain`` are the plain PyTorch
versions of the same functions, which ``kernels.ops`` uses for CPU tensors
and ``chip_smoke.py`` holds the kernels against on the card.
``LAUNCHES`` counts calls per entry point (each call is two kernel
launches on the current stream, counted once).  ``work`` is the bytes
and operations of one call, the card's lower bound: ``chip_smoke.py``'s
bounds and the dry-run's counts (``decode_attention_meta``, for tensors
on the ``meta`` device, which compute nothing) both come from it.

Split-KV schedule: the key axis is cut into chunks of ``KV_CHUNK`` keys
(a compile-time constant of the CUDA source, the same for every call).
The first kernel writes, for every (b, query head, chunk) whose chunk
starts below ``n = min(kv_len[b], S)``, the chunk's unnormalized
``acc[Dh]``, its running max ``m`` and denominator ``l`` into an f32
workspace ``[B, Hq, ceil(S / KV_CHUNK), Dh + 2]`` that the wrapper
allocates with ``torch.empty``.  The second merges chunks
``0 .. ceil(n / KV_CHUNK) - 1`` in that order (log-sum-exp rule, no
atomics) and writes ``acc / max(l, 1e-30)`` in q's dtype (the LSE entry
writes ``acc``, ``l`` and ``m`` as they are).  The chunks merged depend
on ``n`` alone, so the output is deterministic, the same
for the paged and dense entries, and independent of the rest of the
batch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build, ref
from .meta import compute_dtype

LAUNCHES: Dict[str, int] = {"decode_attention": 0,
                            "paged_decode_attention": 0,
                            "decode_attention_lse": 0}

KV_CHUNK = 128              # keys per split-KV chunk; == kKvChunk in the .cu
_SLOT_BLOCK = 1 << 30       # table granularity meaning "one row per sequence"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("decode_attention")
    if lib.repro_decode_kv_chunk() != KV_CHUNK:
        raise RuntimeError("decode_attention: the CUDA library's chunk "
                           f"{lib.repro_decode_kv_chunk()} != KV_CHUNK "
                           f"{KV_CHUNK}")
    return lib


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
    # the kernel reads each key's row in 16-byte pieces
    for t in (k, v):
        if t.data_ptr() % 16 or any(t.stride(i) * t.element_size() % 16
                                    for i in range(3)):
            raise ValueError(f"{where}: cache base and row/seq/head strides "
                             "must be 16-byte aligned")
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise ValueError(f"{where}: kv_len must be int32 [B]")


def _launch(q, k, v, rows, rows_stride: int, table_block: int, kv_len,
            sm_scale: Optional[float], where: str,
            lse: bool = False) -> torch.Tensor:
    B, Hq, Dh = q.shape
    _, S, Hkv, _ = k.shape
    scale = sm_scale if sm_scale is not None else 1.0 / (Dh ** 0.5)
    if lse:
        out = torch.empty((B, Hq, Dh + 2), dtype=torch.float32,
                          device=q.device)
    else:
        out = torch.empty_like(q)
    part = torch.empty((B, Hq, -(-S // KV_CHUNK), Dh + 2), dtype=torch.float32,
                       device=q.device)
    lib = _library()
    entry = lib.repro_decode_attention_lse if lse else \
        lib.repro_decode_attention
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            part.data_ptr(),
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


def decode_attention_lse(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, kv_len: torch.Tensor, *,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """The log-sum-exp parts of dense decode, f32 [B, Hq, Dh + 2]:
    ``acc[Dh]``, ``l``, ``m`` (see the module docstring).  CUDA kernel."""
    _check_common(q, k, v, kv_len, "decode_attention_lse")
    if k.shape[0] != q.shape[0]:
        raise ValueError("decode_attention_lse: cache batch != query batch")
    return _launch(q, k, v, None, 0, _SLOT_BLOCK, kv_len, sm_scale,
                   "decode_attention_lse", lse=True)


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


def work(B: int, Hq: int, Hkv: int, Dh: int, S: int, *,
         kv_len: Optional[Sequence[int]] = None, q_itemsize: int = 2,
         kv_itemsize: int = 2, rows: bool = False, lse: bool = False
         ) -> Tuple[float, float]:
    """(bytes, operations) one call must spend at the least: the K and V
    rows of every visible key (``min(kv_len[b], S)`` a sequence; all ``S``
    when ``kv_len`` is None, as on ``meta`` tensors) read once, q read
    and the output written once (f32 ``[B, Hq, Dh + 2]`` for ``lse``),
    ``kv_len`` and, for the paged entry (``rows``), the row ids read
    once; 4 * Dh operations a query head and visible key (q.k and p.v,
    a multiply and an add each)."""
    if kv_len is None:
        keys = float(B * S)
    else:
        keys = float(np.clip(np.asarray(kv_len, np.int64), 0, S).sum())
    out = B * Hq * (Dh + 2) * 4 if lse else B * Hq * Dh * q_itemsize
    nbytes = (keys * Hkv * Dh * kv_itemsize * 2 + B * Hq * Dh * q_itemsize
              + out + B * 4 * (2 if rows else 1))
    return nbytes, 4.0 * Hq * Dh * keys


def decode_attention_meta(q: torch.Tensor, k: torch.Tensor, *,
                          lse: bool = False):
    """The dense entry on ``meta`` tensors: (output stand-in, bytes,
    operations, compute dtype), every key of the cache counted as
    visible.  The split-KV workspace is allocated as the wrapper
    allocates it, so the dry-run's memory count sees it."""
    B, Hq, Dh = q.shape
    _, S, Hkv, _ = k.shape
    nbytes, flops = work(B, Hq, Hkv, Dh, S, q_itemsize=q.element_size(),
                         kv_itemsize=k.element_size(), lse=lse)
    shape, dtype = ((B, Hq, Dh + 2), torch.float32) if lse \
        else ((B, Hq, Dh), q.dtype)
    out = torch.empty(shape, dtype=dtype, device="meta")
    torch.empty((B, Hq, -(-S // KV_CHUNK), Dh + 2), dtype=torch.float32,
                device="meta")
    return out, nbytes, flops, compute_dtype(q, k)


def decode_attention_plain(q, k, v, kv_len, *, sm_scale=None):
    """Plain PyTorch version of :func:`decode_attention`."""
    return ref.decode_reference(q, k, v, kv_len=kv_len, sm_scale=sm_scale)


def decode_attention_lse_plain(q, k, v, kv_len, *, sm_scale=None):
    """Plain PyTorch version of :func:`decode_attention_lse`: the JAX
    package's ``_local_decode_lse`` over the keys ``[0, kv_len[b])``."""
    B, S, Hkv, Dh = k.shape
    g = q.shape[1] // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (Dh ** 0.5)
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", qf, kf)                  # [B, Hq, S]
    valid = (torch.arange(S, device=q.device)[None, :]
             < kv_len.to(q.device).long()[:, None])[:, None, :]
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(dim=-1)                                          # [B, Hq]
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(valid, torch.exp(s - m_safe[..., None]), 0.0)
    acc = torch.einsum("bhk,bkhd->bhd", p, vf)
    return torch.cat([acc, p.sum(-1)[..., None], m[..., None]], dim=-1)


def paged_decode_attention_plain(q, k_arena, v_arena, slots, kv_len, *,
                                 block_tables=None, table_block=None,
                                 sm_scale=None):
    """Plain PyTorch version of :func:`paged_decode_attention`: gather the
    addressed rows (a pure bit move), then the dense reference."""
    k = ref.gather_rows(k_arena, slots, block_tables, table_block)
    v = ref.gather_rows(v_arena, slots, block_tables, table_block)
    return ref.decode_reference(q, k, v, kv_len=kv_len, sm_scale=sm_scale)
