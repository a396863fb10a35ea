"""Public kernel API: dispatch on the tensor's device.

A CPU tensor goes to the plain PyTorch version of a kernel; a CUDA tensor
goes to the hand-written CUDA kernel (``decode_attention`` /
``flash_attention`` / ``relevance_score``), whose wrapper raises on
anything it does not take.
There is no switch that sends a CUDA tensor to the plain path and no
fallback: every CUDA call runs a kernel, ragged shapes included (the
kernels mask their own edges).

All functions take q/k/v in [B, S, H, Dh] layout (model-side convention);
arenas are [N_rows, S_alloc, Hkv, Dh].
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import decode_attention as _dec
from . import flash_attention as _fla
from . import ref
from . import relevance_score as _rel
from . import sanitize


def _check_slots(slots, n_rows: int, where: str) -> None:
    """Validate the arena-slot contract where it costs no device sync.

    Contract: every slot must lie in ``[0, n_rows)`` where ``n_rows`` is
    the arena's row count; the LAST row (index ``n_slots == n_rows - 1``)
    is the serving engine's scratch row and is an explicitly legal
    sentinel that may appear any number of times (batch padding).
    Anything outside that range is a caller bug: a gather would read an
    unrelated row and the paged kernels would read out of bounds.

    Numpy arrays and CPU tensors are checked here.  CUDA tensors are not:
    reading them would cost one device->host sync per layer and step, so
    the serving engine validates its host-side slot arrays once per
    launch (``LMBackend.dispatch_group``) instead.
    """
    if isinstance(slots, torch.Tensor):
        if slots.is_cuda:
            return
        s = slots.numpy()
    else:
        s = np.asarray(slots)
    if s.size and (int(s.min()) < 0 or int(s.max()) >= n_rows):
        raise ValueError(
            f"{where}: slot ids must be in [0, {n_rows}) — the scratch "
            f"row {n_rows - 1} is the only padding sentinel — got "
            f"min={int(s.min())} max={int(s.max())}")


def _block_granularity(bt: torch.Tensor, S: int, where: str) -> int:
    """Infer (and validate) the cache-block size a block table addresses.

    A block table is full-width by contract: ``[B, S // block]`` with
    column ``j`` naming the arena row holding positions
    ``[j * block, (j + 1) * block)``, so the granularity is recoverable
    from the table's width."""
    if bt.dim() != 2 or bt.shape[1] == 0 or S % bt.shape[1] != 0:
        raise ValueError(
            f"{where}: block table must be [B, S // block] with a width "
            f"dividing the arena cache axis {S}, got shape {tuple(bt.shape)}")
    return S // bt.shape[1]


def _gather_block_rows(arena: torch.Tensor, bt: torch.Tensor,
                       block: int) -> torch.Tensor:
    """Assemble per-sequence caches [B, S, H, D] from a block table —
    the bitwise reference for the paged kernels' in-kernel indirection."""
    return ref.gather_rows(arena, None, bt, block)


def _i32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if t is None:
        return None
    return t.to(torch.int32).contiguous()


def attention(
    q: torch.Tensor,               # [B, Sq, Hq, Dh]
    k: torch.Tensor,               # [B, Skv, Hkv, Dh]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,   # [B] valid kv length
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Prefill / prefix-extend attention.

    ``kv_len`` [B] masks per-row KV padding: serving batches are bucket-
    padded, so a document shorter than its bucket carries PAD keys past its
    true length — with ``kv_len`` those keys are invisible to every query.

    With grad mode on and q, k or v requiring grad (training), the call
    goes through ``FlashAttentionFn``: the same forward (the kernel on a
    CUDA tensor), plus its backward.  Otherwise nothing is recorded.
    """
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              sm_scale=sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        kl = _i32(kv_len) if q.is_cuda else kv_len
        return _fla.FlashAttentionFn.apply(q, k, v, kl, causal, window,
                                           q_offset, sm_scale)
    if q.is_cuda:
        return _fla.flash_attention(q, k, v, kv_len=_i32(kv_len), **kw)
    return _fla.flash_attention_plain(q, k, v, kv_len=kv_len, **kw)


def decode_attention(
    q: torch.Tensor,               # [B, Hq, Dh]
    k: torch.Tensor,               # [B, S, Hkv, Dh]
    v: torch.Tensor,
    kv_len: torch.Tensor,          # [B]
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over a (possibly padded) KV cache."""
    if q.is_cuda:
        return _dec.decode_attention(q.contiguous(), k, v, _i32(kv_len),
                                     sm_scale=sm_scale)
    return _dec.decode_attention_plain(q, k, v, kv_len, sm_scale=sm_scale)


def decode_attention_lse(
    q: torch.Tensor,               # [B, Hq, Dh]
    k: torch.Tensor,               # [B, S, Hkv, Dh]
    v: torch.Tensor,
    kv_len: torch.Tensor,          # [B] valid keys of this cache
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode's log-sum-exp parts, f32 [B, Hq, Dh + 2]: ``acc``, ``l``,
    ``m`` (the local body of sequence-parallel decode)."""
    if q.is_cuda:
        return _dec.decode_attention_lse(q.contiguous(), k, v, _i32(kv_len),
                                         sm_scale=sm_scale)
    return _dec.decode_attention_lse_plain(q, k, v, kv_len,
                                           sm_scale=sm_scale)


def arena_decode_attention(
    q: torch.Tensor,               # [B, Hq, Dh]
    k_arena: torch.Tensor,         # [N_rows, S, Hkv, Dh] persistent arena
    v_arena: torch.Tensor,
    slots: torch.Tensor,           # [B] arena row per sequence
    kv_len: torch.Tensor,          # [B] valid cache entries per sequence
    *,
    block_tables: Optional[torch.Tensor] = None,   # [B, S // block]
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention reading straight from a slot arena — the paged
    entry point.

    ``block_tables`` [B, S // block] switches the indirection from one
    arena row per sequence to one row per cache block (column ``j`` names
    the row holding positions ``[j * block, (j+1) * block)``); its
    granularity is inferred from its width and need not match the
    kernel's tile.  Slot contract as in ``_check_slots``.
    """
    S = k_arena.shape[1]
    rows = slots if block_tables is None else block_tables
    where = ("arena_decode_attention" if block_tables is None
             else "arena_decode_attention block_tables")
    _check_slots(rows, k_arena.shape[0], where)
    sanitize.notify_rows(where, rows, k_arena.shape[0] - 1)
    tb = None
    if block_tables is not None:
        tb = _block_granularity(block_tables, S, "arena_decode_attention")
    if q.is_cuda:
        return _dec.paged_decode_attention(
            q.contiguous(), k_arena, v_arena, _i32(slots), _i32(kv_len),
            block_tables=_i32(block_tables), table_block=tb,
            sm_scale=sm_scale)
    return _dec.paged_decode_attention_plain(
        q, k_arena, v_arena, slots, kv_len, block_tables=block_tables,
        table_block=tb, sm_scale=sm_scale)


def attention_paged(
    q: torch.Tensor,               # [B, Sq, Hq, Dh]
    k_arena: torch.Tensor,         # [N_rows, S_alloc, Hkv, Dh] arena
    v_arena: torch.Tensor,
    slots: torch.Tensor,           # [B] arena row per sequence
    *,
    kv_valid: int,                 # attend keys [0, kv_valid)
    block_tables: Optional[torch.Tensor] = None,   # [B, S_alloc // block]
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Prefix-extend attention over a slot arena (paged extend path).

    The paged twin of ``attention`` for the serving engine's extend step:
    queries are the suffix at ``q_offset`` and cached keys live in
    ``k_arena[slots[b], :kv_valid]`` (the caller scatters the new chunk's
    KV into the arena first).  ``block_tables`` is the per-block
    indirection of ``arena_decode_attention``.  Slot contract as in
    ``_check_slots``.
    """
    S_alloc = k_arena.shape[1]
    rows = slots if block_tables is None else block_tables
    where = ("attention_paged" if block_tables is None
             else "attention_paged block_tables")
    _check_slots(rows, k_arena.shape[0], where)
    sanitize.notify_rows(where, rows, k_arena.shape[0] - 1)
    tb = None
    if block_tables is not None:
        tb = _block_granularity(block_tables, S_alloc, "attention_paged")
    kw = dict(kv_valid=kv_valid, table_block=tb, causal=causal,
              window=window, q_offset=q_offset, sm_scale=sm_scale)
    if q.is_cuda:
        return _fla.paged_flash_attention(
            q, k_arena, v_arena, _i32(slots),
            block_tables=_i32(block_tables), kv_len=_i32(kv_len), **kw)
    return _fla.paged_flash_attention_plain(
        q, k_arena, v_arena, slots, block_tables=block_tables,
        kv_len=kv_len, **kw)


def relevance_score(
    x: torch.Tensor,               # [C, T, D] f32 chunk token embeddings
    lengths: torch.Tensor,         # [C] int32 valid tokens per chunk
    w: torch.Tensor,               # [D] f32 classifier weights
    b: torch.Tensor,               # one-element f32 bias
) -> torch.Tensor:
    """Chunk relevance ``sigmoid(meanpool(x) @ w + b)`` -> [C] f32.  A CUDA
    ``x`` runs the fused kernel (which raises on anything it does not
    take); a CPU ``x`` the plain version."""
    if x.is_cuda:
        return _rel.relevance_score(x, lengths, w, b)
    return _rel.relevance_score_plain(x, lengths, w, b)
