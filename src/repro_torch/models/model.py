"""The decoder-only LM: embed -> layers -> norm -> tied head.

The JAX package scans one compiled superblock over layer-stacked
parameters; here the layers are a Python loop over per-layer parameter
dicts (``params["layers"][i]``), and serve states are per-layer KV caches
(``states[i] = {"k": [B, S_alloc, KV, Dh], "v": ...}``).

Entry points, one per serving phase:

    prefill(params, batch, s_alloc)            -> (last logits, states)
    extend(params, batch, states, q_offset)    -> (last logits, states)
    decode_step(params, tokens, states, pos)   -> (logits [B, V], states)

``extend`` is the task-cascade primitive: document fraction f_j -> f_i reuse
(the KV prefix for [0, q_offset) is already in ``states``).  ``extend`` and
``decode_step`` update ``states`` IN PLACE and return the same object.

``LM(rcfg, device=...)`` runs on the CUDA device by default and raises
when none is present; tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..config import ATTN_FULL, ResolvedConfig
from . import blocks
from .layers import embed_apply, init_embed, init_rmsnorm, lm_head_apply, \
    rmsnorm_apply
from .runtime import DTYPES, DeviceLike, resolve_device

States = List[Dict[str, torch.Tensor]]


class LM:
    """Dense full-attention decoder LM (ATTN_FULL blocks, dense FFN)."""

    def __init__(self, rcfg: ResolvedConfig, device: DeviceLike = "cuda"):
        blocks.check_supported(rcfg)
        self.rcfg = rcfg
        self.device = resolve_device(device)

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.rcfg.base.dtype]

    @property
    def num_layers(self) -> int:
        return self.rcfg.base.num_layers

    # ---------------------------------------------------------------- params
    def init(self, seed: int) -> Dict[str, Any]:
        """Random parameters drawn from ``torch.Generator(seed)`` on the
        model's device (JAX layouts, so converted weights compare)."""
        b = self.rcfg.base
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return {
            "embed": init_embed(gen, self.rcfg.padded_vocab, b.d_model,
                                self.dtype),
            "final_norm": init_rmsnorm(b.d_model, self.device),
            "layers": [blocks.init_block(gen, self.rcfg, self.dtype)
                       for _ in range(self.num_layers)],
        }

    # ---------------------------------------------------------------- states
    def init_states(self, batch: int, s_alloc: int, kv_dtype=None) -> States:
        """Zeroed per-layer KV caches; ``kv_dtype`` overrides the storage
        dtype (bf16 arenas for f32 models)."""
        dt = kv_dtype or self.dtype
        return [blocks.init_block_state(self.rcfg, batch, s_alloc, dt,
                                        self.device)
                for _ in range(self.num_layers)]

    def state_shapes(self, batch: int, s_alloc: int, kv_dtype=None
                     ) -> List[Dict[str, Tuple[Tuple[int, ...],
                                               torch.dtype]]]:
        """(shape, dtype) of every state leaf, allocating nothing."""
        dt = kv_dtype or self.dtype
        shape = (batch, s_alloc, self.rcfg.padded_kv_heads,
                 self.rcfg.head_dim)
        return [{"k": (shape, dt), "v": (shape, dt)}
                for _ in range(self.num_layers)]

    # ------------------------------------------------------- arena state API
    # Every state leaf is batched on axis 0, which is how the serving
    # engine's slot arena gathers/scatters sub-batches.

    def take_states(self, states: States, idx: torch.Tensor) -> States:
        """Gather per-sequence states at ``idx`` [B'] -> batch-B' copies."""
        return [{n: t.index_select(0, idx) for n, t in layer.items()}
                for layer in states]

    def put_states(self, arena: States, idx: torch.Tensor,
                   states: States) -> States:
        """Scatter a batch-B' state list into arena rows ``idx`` in place.
        Duplicate ids are permitted (scratch-slot padding); which duplicate
        wins is unspecified."""
        for a, s in zip(arena, states):
            for n in a:
                a[n][idx] = s[n].to(a[n].dtype)
        return arena

    @property
    def supports_paged_kv(self) -> bool:
        """True when every layer's serve-state is a full-attention KV
        cache, so the slot arena can be addressed IN PLACE by the paged
        kernels (``slots=`` on ``extend``/``decode_step``)."""
        return all(k == ATTN_FULL for k in self.rcfg.base.layer_kinds())

    @staticmethod
    def _kv_window_idx(slots: torch.Tensor, start: torch.Tensor,
                       length: int):
        win = start[:, None] + torch.arange(length, dtype=start.dtype,
                                            device=start.device)[None]
        return slots[:, None], win                       # [B, 1], [B, L]

    def take_kv_window(self, states: States, slots: torch.Tensor,
                       start: torch.Tensor, length: int) -> States:
        """Copy cache rows [start[b], start[b]+length) of every KV leaf at
        arena rows ``slots`` -> per-layer [B, length, KV, Dh].  With
        ``put_kv_window`` this is the paged op-suffix UNDO LOG."""
        si, win = self._kv_window_idx(slots, start, length)
        return [{n: t[si, win] for n, t in layer.items()}
                for layer in states]

    def put_kv_window(self, states: States, slots: torch.Tensor,
                      start: torch.Tensor, length: int,
                      window: States) -> States:
        """Write a ``take_kv_window`` snapshot back into the arena in
        place.  Duplicate rows (scratch padding) are permitted; which one
        wins is unspecified — scratch contents are never read unmasked."""
        si, win = self._kv_window_idx(slots, start, length)
        for layer, sub in zip(states, window):
            for n, t in layer.items():
                t[si, win] = sub[n]
        return states

    # ------------------------------------------------------------------ core
    def _run_layers(self, params, x, *, mode, states=None, cache_len=None,
                    q_offset=0, kv_len=None, slots=None, block_tables=None,
                    positions=None):
        new_states = []
        for i, lp in enumerate(params["layers"]):
            x, ns = blocks.block_apply(
                lp, x, rcfg=self.rcfg, mode=mode,
                state=None if states is None else states[i],
                cache_len=cache_len, q_offset=q_offset, kv_len=kv_len,
                slots=slots, block_tables=block_tables, positions=positions)
            new_states.append(ns)
        return x, new_states

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        b = self.rcfg.base
        x = rmsnorm_apply(params["final_norm"], x, b.norm_eps)
        return lm_head_apply(params["embed"], x, b.logit_softcap)[:, 0]

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return embed_apply(params["embed"], tokens).to(self.dtype)

    # ------------------------------------------------------------ entry pts
    def prefill(self, params, batch: Dict[str, torch.Tensor], *,
                s_alloc: Optional[int] = None):
        """Full prompt pass -> (last-token logits [B, V], states)."""
        x = self._embed(params, batch["tokens"])
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        if s_alloc:
            # prefill writes into preallocated caches via extend at offset 0
            states = self.init_states(B, s_alloc)
            x, new_states = self._run_layers(
                params, x, mode="extend", states=states, q_offset=0,
                positions=positions,
                cache_len=torch.zeros((B,), dtype=torch.int32,
                                      device=x.device))
        else:
            x, new_states = self._run_layers(params, x, mode="prefill",
                                             positions=positions)
        return self._head(params, x[:, -1:]), new_states

    def extend(self, params, batch: Dict[str, torch.Tensor], states: States,
               q_offset: int, kv_len: Optional[torch.Tensor] = None,
               slots: Optional[torch.Tensor] = None,
               block_tables: Optional[torch.Tensor] = None):
        """Cascade fraction-extension: new tokens at [q_offset, q_offset+S).

        ``kv_len`` [B] is the TRUE (unpadded) sequence length including this
        chunk: keys at positions >= kv_len[b] are bucket PAD and masked for
        every query.  ``slots`` [B] switches to PAGED mode: ``states`` is
        the slot arena and row ``slots[b]`` is extended in place.
        ``block_tables`` [B, nblocks] (paged mode only) redirects READS per
        cache block; writes still land in row ``slots[b]``.
        """
        x = self._embed(params, batch["tokens"])
        B, S, _ = x.shape
        positions = q_offset + torch.arange(S, device=x.device)[None].expand(
            B, S)
        x, new_states = self._run_layers(
            params, x, mode="extend", states=states, q_offset=q_offset,
            kv_len=kv_len, slots=slots, block_tables=block_tables,
            positions=positions)
        return self._head(params, x[:, -1:]), new_states

    def decode_step(self, params, tokens: torch.Tensor, states: States,
                    pos: torch.Tensor, slots: Optional[torch.Tensor] = None,
                    block_tables: Optional[torch.Tensor] = None):
        """One decode step. tokens [B], pos [B] -> (logits [B, V], states).

        ``slots`` [B] switches to PAGED mode: ``states`` is the slot arena
        and the step writes the token's KV at position ``pos[b]`` of row
        ``slots[b]`` in place (callers that must not dirty the row bracket
        the steps with ``take_kv_window``/``put_kv_window``)."""
        x = self._embed(params, tokens[:, None])
        x, new_states = self._run_layers(
            params, x, mode="decode", states=states, cache_len=pos,
            slots=slots, block_tables=block_tables, positions=pos[:, None])
        return self._head(params, x), new_states
