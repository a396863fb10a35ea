"""Whisper-base: encoder-decoder with cross-attention.

The JAX package's ``WhisperModel``, in PyTorch.  The conv/mel frontend is
a stub: batches carry precomputed frame embeddings ``frame_emb`` [B,
S_enc, D], projected by ``frame_proj``.  6 bidirectional encoder layers;
6 decoder layers of (causal self-attention, cross-attention over the
encoder output, GELU MLP); LayerNorms; sinusoidal positions on both
sides (no rotary embedding); tied LM head.

Parameters are ``{"embed", "frame_proj", "enc": [layer], "enc_norm",
"dec": [layer], "dec_norm"}``, the JAX layout with lists for its layer
tuples.  Serving states are ``{"self": [{"k", "v"}], "cross": [{"k",
"v"}]}`` per decoder layer: the self-attention caches (updated IN PLACE
by ``decode_step``, as the LM's are) and the cross-attention K/V,
computed once from the encoder output at prefill; decode steps never
touch the encoder again.

On the card: the encoder's bidirectional attention, the cross-attention
(one query a sequence at decode, the prompt at prefill) and the decoder's
prefill run the dense flash kernel; decode steps run the dense decode
kernel over the self cache.  ``WhisperModel(rcfg, device=...)`` runs on
the CUDA device by default and raises when none is present.
``state_specs`` gives the logical specs of the serving states, the JAX
package's.

``WhisperModel(..., mesh=, sharded=True)`` holds the parameters as this
rank's shards of ``param_specs`` (``convert.shard_params``); over a
``model`` axis larger than 1 every layer is tensor-parallel, as the
LM's are: ``frame_proj``'s columns are gathered into the residual
stream (``gather_from_model``); the encoder's bidirectional attention
and the decoder's self-attention run the rank's heads (whisper-base's 8
heads padded to 16 at ``tp`` 16), the self caches hold the rank's KV
heads; the cross-attention K/V are projected with the rank's
``wk``/``wv`` shards and read by the rank's query heads; the GELU MLPs
are column- then row-parallel (``layers.mlp2_apply``); the embedding,
the tied head and ``loss`` are vocab-parallel (``model
.vocab_parallel_xent``), and ``forward``, ``prefill`` and
``decode_step`` give this rank's vocab shard of the logits.  The serving
states are this rank's shards of ``state_specs``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..config import ResolvedConfig
from ..distributed.collectives import copy_to_model, gather_from_model
from ..distributed.compat import axis_names, axis_size
from .attention import (_proj, attention_apply, init_attention,
                        init_kv_cache, spec_attention)
from .layers import (embed_apply, init_embed, init_layernorm, init_mlp2,
                     layernorm_apply, lm_head_apply, mlp2_apply,
                     sinusoidal_positions, spec_embed, spec_layernorm,
                     spec_mlp2)
from .model import token_xent, vocab_parallel_xent
from .runtime import DTYPES, DeviceLike, resolve_device


class WhisperModel:
    def __init__(self, rcfg: ResolvedConfig, device: DeviceLike = "cuda",
                 mesh=None, sharded: bool = False):
        if not rcfg.base.encoder_layers:
            raise ValueError(f"{rcfg.base.name}: no encoder layers")
        self.rcfg = rcfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.sharded = sharded and mesh is not None
        if self.tp_mesh is not None and rcfg.tp != axis_size(mesh, "model"):
            raise ValueError(f"resolved for tp {rcfg.tp}, mesh model axis "
                             f"{axis_size(mesh, 'model')}")

    @property
    def tp_mesh(self):
        """The mesh when the layers are tensor-parallel (``sharded`` over
        a ``model`` axis larger than 1), else None."""
        if self.sharded and "model" in axis_names(self.mesh) \
                and axis_size(self.mesh, "model") > 1:
            return self.mesh
        return None

    @property
    def _kv_sharded(self) -> bool:
        return self.rcfg.padded_kv_heads >= self.rcfg.tp

    @property
    def _self_kv_heads(self) -> int:
        """The KV heads of this rank's self-attention caches."""
        r = self.rcfg
        if self.tp_mesh is not None and self._kv_sharded:
            return r.padded_kv_heads // r.tp
        return r.padded_kv_heads

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.rcfg.base.dtype]

    @property
    def n_enc(self) -> int:
        return self.rcfg.base.encoder_layers

    @property
    def n_dec(self) -> int:
        return self.rcfg.base.num_layers

    # ---------------------------------------------------------------- params
    def _attn(self, gen, kv_heads: int) -> Dict[str, torch.Tensor]:
        r = self.rcfg
        return init_attention(gen, r.base.d_model, r.padded_heads, kv_heads,
                              r.head_dim, self.dtype)

    def init(self, seed: int) -> Dict[str, Any]:
        """Random parameters from ``torch.Generator(seed)`` on the
        model's device."""
        r, b, dev = self.rcfg, self.rcfg.base, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        d = b.d_model
        enc = [{"norm1": init_layernorm(d, dev),
                "attn": self._attn(gen, r.padded_kv_heads),
                "norm2": init_layernorm(d, dev),
                "mlp": init_mlp2(gen, d, b.d_ff, self.dtype)}
               for _ in range(self.n_enc)]
        dec = [{"norm1": init_layernorm(d, dev),
                "self_attn": self._attn(gen, r.padded_kv_heads),
                "norm2": init_layernorm(d, dev),
                "cross_attn": self._attn(gen, r.padded_heads),
                "norm3": init_layernorm(d, dev),
                "mlp": init_mlp2(gen, d, b.d_ff, self.dtype)}
               for _ in range(self.n_dec)]
        frame_proj = torch.randn((d, d), generator=gen, device=dev,
                                 dtype=torch.float32) * 0.02
        return {
            "embed": init_embed(gen, r.padded_vocab, d, self.dtype),
            "frame_proj": frame_proj.to(self.dtype),
            "enc": enc,
            "enc_norm": init_layernorm(d, dev),
            "dec": dec,
            "dec_norm": init_layernorm(d, dev),
        }

    def param_specs(self) -> Dict[str, Any]:
        """Logical specs of ``init``'s tree, the JAX package's."""
        kv_sharded = self.rcfg.padded_kv_heads >= self.rcfg.tp
        enc = {"norm1": spec_layernorm(),
               "attn": spec_attention(kv_sharded, False),
               "norm2": spec_layernorm(), "mlp": spec_mlp2()}
        dec = {"norm1": spec_layernorm(),
               "self_attn": spec_attention(kv_sharded, False),
               "norm2": spec_layernorm(),
               "cross_attn": spec_attention(True, False),
               "norm3": spec_layernorm(), "mlp": spec_mlp2()}
        return {
            "embed": spec_embed(),
            "frame_proj": (None, "tp"),
            "enc": [dict(enc) for _ in range(self.n_enc)],
            "enc_norm": spec_layernorm(),
            "dec": [dict(dec) for _ in range(self.n_dec)],
            "dec_norm": spec_layernorm(),
        }

    def state_specs(self, *, batch_sharded: bool, seq_sharded: bool = False
                    ) -> Dict[str, Any]:
        """Logical specs of ``state_shapes``' leaves, the JAX package's:
        self-attention caches shard their KV heads over ``tp`` when they
        divide, cross caches always (they hold every query head)."""
        dp = "dp" if batch_sharded else None
        kv = "tp" if self.rcfg.padded_kv_heads >= self.rcfg.tp else None
        self_kv = [{"k": (dp, None, kv, None), "v": (dp, None, kv, None)}
                   for _ in range(self.n_dec)]
        cross = [{"k": (dp, None, "tp", None), "v": (dp, None, "tp", None)}
                 for _ in range(self.n_dec)]
        return {"self": self_kv, "cross": cross}

    # ---------------------------------------------------------------- states
    def state_shapes(self, batch: int, s_alloc: int
                     ) -> Dict[str, List[Dict[str, Tuple[Tuple[int, ...],
                                                          torch.dtype]]]]:
        """(shape, dtype) of every state leaf, allocating nothing."""
        r = self.rcfg
        self_kv = (batch, s_alloc, r.padded_kv_heads, r.head_dim)
        cross = (batch, r.base.encoder_seq_len, r.padded_heads, r.head_dim)
        leaf = lambda shape: {"k": (shape, self.dtype),      # noqa: E731
                              "v": (shape, self.dtype)}
        return {"self": [leaf(self_kv) for _ in range(self.n_dec)],
                "cross": [leaf(cross) for _ in range(self.n_dec)]}

    def init_states(self, batch: int, s_alloc: int
                    ) -> Dict[str, List[Dict[str, torch.Tensor]]]:
        """Zeroed serving states, tensor-parallel this rank's shards of
        ``state_specs`` (the self caches' KV heads where they divide,
        the cross K/V's heads)."""
        r = self.rcfg
        n = r.tp if self.tp_mesh is not None else 1
        shapes = {"self": (batch, s_alloc, self._self_kv_heads, r.head_dim),
                  "cross": (batch, r.base.encoder_seq_len,
                            r.padded_heads // n, r.head_dim)}
        return {part: [{k: torch.zeros(shape, dtype=self.dtype,
                                       device=self.device)
                        for k in ("k", "v")} for _ in range(self.n_dec)]
                for part, shape in shapes.items()}

    # ------------------------------------------------------------------ core
    def _positions(self, x: torch.Tensor, positions: torch.Tensor
                   ) -> torch.Tensor:
        return x + sinusoidal_positions(positions, x.shape[-1]).to(x.dtype)

    def encode(self, params, frame_emb: torch.Tensor) -> torch.Tensor:
        """frame_emb [B, S_enc, D] (stub frontend output) -> encoder
        states [B, S_enc, D]."""
        S = frame_emb.shape[1]
        tp = self.tp_mesh
        x = frame_emb.to(self.dtype)
        if tp is None:
            x = x @ params["frame_proj"]
        else:
            x = gather_from_model(copy_to_model(x, tp) @ params["frame_proj"],
                                  tp, -1)
        x = self._positions(x, torch.arange(S, device=x.device)[None])
        for lp in params["enc"]:
            h = layernorm_apply(lp["norm1"], x)
            mix, _ = attention_apply(lp["attn"], h, mode="full",
                                     causal=False, use_rope=False,
                                     tp_mesh=tp, kv_sharded=self._kv_sharded)
            x = x + mix
            x = x + mlp2_apply(lp["mlp"], layernorm_apply(lp["norm2"], x),
                               "gelu", tp)
        return layernorm_apply(params["enc_norm"], x)

    def _cross_kv(self, params, enc_out: torch.Tensor
                  ) -> List[Dict[str, torch.Tensor]]:
        """Cross-attention K/V of every decoder layer [B, S_enc, H, Dh]
        (tensor-parallel: the rank's heads)."""
        if self.tp_mesh is not None:
            enc_out = copy_to_model(enc_out, self.tp_mesh)
        return [{"k": _proj(enc_out, lp["cross_attn"]["wk"]),
                 "v": _proj(enc_out, lp["cross_attn"]["wv"])}
                for lp in params["dec"]]

    def _dec_layer(self, lp, x, *, mode, self_cache, cross_kv, positions,
                   cache_len):
        tp = self.tp_mesh
        h = layernorm_apply(lp["norm1"], x)
        mix, new_cache = attention_apply(
            lp["self_attn"], h, mode=mode, causal=True, positions=positions,
            cache=self_cache, cache_len=cache_len,
            want_cache=(mode != "full"), use_rope=False, tp_mesh=tp,
            kv_sharded=self._kv_sharded)
        x = x + mix
        mix, _ = attention_apply(lp["cross_attn"],
                                 layernorm_apply(lp["norm2"], x),
                                 kv_ctx=(cross_kv["k"], cross_kv["v"]),
                                 tp_mesh=tp)
        x = x + mix
        x = x + mlp2_apply(lp["mlp"], layernorm_apply(lp["norm3"], x),
                           "gelu", tp)
        return x, new_cache

    def _embed(self, params, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        x = embed_apply(params["embed"], tokens, self.tp_mesh).to(self.dtype)
        return self._positions(x, positions)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        return lm_head_apply(params["embed"],
                             layernorm_apply(params["dec_norm"], x),
                             tp_mesh=self.tp_mesh)

    # ------------------------------------------------------------ entry pts
    def forward(self, params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward -> (logits [B, S, V] f32, aux = 0)."""
        cross = self._cross_kv(params, self.encode(params,
                                                   batch["frame_emb"]))
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x = self._embed(params, tokens, positions)
        for lp, ckv in zip(params["dec"], cross):
            x, _ = self._dec_layer(lp, x, mode="full", self_cache=None,
                                   cross_kv=ckv, positions=positions,
                                   cache_len=None)
        return (self._logits(params, x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def loss(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy of ``labels`` (no aux term)."""
        logits, _ = self.forward(params, batch)
        if self.tp_mesh is not None:
            return vocab_parallel_xent(logits, batch, self.tp_mesh)
        return token_xent(logits, batch)

    def prefill(self, params, batch: Dict[str, torch.Tensor], *,
                s_alloc: Optional[int] = None):
        """Encode, then teacher-force the prompt into self caches of
        ``s_alloc`` positions -> (last-token logits [B, V], states)."""
        cross = self._cross_kv(params, self.encode(params,
                                                   batch["frame_emb"]))
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x = self._embed(params, tokens, positions)
        zero = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
        new_self = []
        for lp, ckv in zip(params["dec"], cross):
            cache = init_kv_cache(B, s_alloc or S, self._self_kv_heads,
                                  self.rcfg.head_dim, self.dtype,
                                  tokens.device)
            x, nc = self._dec_layer(lp, x, mode="extend", self_cache=cache,
                                    cross_kv=ckv, positions=positions,
                                    cache_len=zero)
            new_self.append(nc)
        logits = self._logits(params, x[:, -1:])[:, 0]
        return logits, {"self": new_self, "cross": cross}

    def decode_step(self, params, tokens: torch.Tensor, states,
                    pos: torch.Tensor):
        """tokens [B], pos [B] -> (logits [B, V], states); the self caches
        take the token's K/V at ``pos`` in place."""
        x = self._embed(params, tokens[:, None], pos[:, None])
        for lp, sc, ckv in zip(params["dec"], states["self"],
                               states["cross"]):
            x, _ = self._dec_layer(lp, x, mode="decode", self_cache=sc,
                                   cross_kv=ckv, positions=pos[:, None],
                                   cache_len=pos)
        return self._logits(params, x)[:, 0], states
