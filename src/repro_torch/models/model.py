"""The decoder-only LM: embed -> layers -> norm -> tied head.

The JAX package scans one compiled superblock over layer-stacked
parameters; here the layers are a Python loop over per-layer parameter
dicts (``params["layers"][i]``), and serve states are per-layer dicts of
leaves batched on axis 0: KV caches (``{"k": [B, S_alloc, KV, Dh], "v":
...}``, a sliding-window layer's a ring of ``min(sliding_window,
S_alloc)`` positions) or recurrent states (mLSTM ``C, n, m``; sLSTM ``c,
n, h, m``; RG-LRU ``h, conv``; all f32).  Layer ``i`` has kind
``block_pattern[i % len(block_pattern)]``, the JAX package's
repetition-major order (gemma3: five local layers, one global, repeated,
then a local tail; recurrentgemma: two RG-LRU layers and one local, then
two RG-LRU).

qwen2-vl inputs may carry ``patch_emb`` [B, S_img, D] (the stubbed vision
frontend), prepended to the token embeddings, and ``positions3`` [B, S, 3]
(t, h, w) for M-RoPE; text-only input and decode take t = h = w =
position.

Entry points, one per training or serving phase:

    forward(params, batch)                     -> (logits [B, S, V], aux)
    loss(params, batch)                        -> scalar (train)
    prefill(params, batch, s_alloc)            -> (last logits, states)
    extend(params, batch, states, q_offset)    -> (last logits, states)
    decode_step(params, tokens, states, pos)   -> (logits [B, V], states)

``extend`` is the task-cascade primitive: document fraction f_j -> f_i reuse
(the KV prefix for [0, q_offset) is already in ``states``).  ``extend`` and
``decode_step`` update attention caches IN PLACE; recurrent layers return
new state tensors, so callers use the returned states.  ``forward`` runs
the blocks' ``train`` mode: no state, no cache, and attention through
``ops.attention``'s differentiable route when the parameters require
grad.

``LM(rcfg, device=...)`` runs on the CUDA device by default and raises
when none is present; tests pass ``device="cpu"``.

``LM(..., mesh=, sp_decode=)`` places the model on a device mesh
(``distributed.compat``; every rank runs the same program on its own
shard): MoE layers take the mesh strategies (``models.moe``), and with
``sp_decode`` every full-attention cache is cut along its sequence over
the ``data`` axis (``init_states`` allocates ``s_alloc / n_data``
positions a rank) and decode steps go through
``distributed.collectives.sp_decode_attention``, as the JAX package's
``Runtime(mesh=, sp_decode=)``; sliding-window rings and recurrent states
stay whole along the sequence.  ``param_specs`` gives the logical spec
of every parameter, the JAX package's with the stacked layer axis
dropped.

``LM(..., mesh=, sharded=True)`` holds the parameters as this rank's
shards of ``param_specs`` over the mesh (``distributed.sharding
.local_shard``; ``convert.shard_params`` cuts them), which is what GSPMD
makes of the reference's specs: over a ``model`` axis larger than 1 the
layers are tensor-parallel (Megatron's column/row split of the heads,
the MLP and the vocab: ``models.layers``, ``models.attention``; the
recurrent mixers' columns: ``models.ssm``), MoE experts are this rank's
slices, the serving states are this rank's shards of ``state_specs``
(``init_states`` allocates them), and ``forward``, ``prefill``,
``extend`` and ``decode_step`` give this rank's vocab shard of the
logits.  ``loss`` is then the vocab-parallel cross-entropy
(``vocab_parallel_xent``).  Without ``sharded`` the dense layers compute
replicated on full parameters.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import ATTN_FULL, ResolvedConfig
from . import blocks
from ..distributed.collectives import reduce_from_model
from ..distributed.compat import axis_group, axis_index, axis_names, \
    axis_size
from ..distributed.sharding import batch_pspec
from .layers import embed_apply, init_embed, init_rmsnorm, lm_head_apply, \
    rmsnorm_apply, spec_embed, spec_rmsnorm
from .runtime import DTYPES, DeviceLike, resolve_device

States = List[Dict[str, torch.Tensor]]


def token_xent(logits: torch.Tensor, batch: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """Mean cross-entropy of ``batch["labels"]`` under ``logits`` [B, S, V]
    (f32 log-softmax), weighted by ``batch["loss_mask"]`` when present.
    Gathers ``logp[label]``, which equals the reference's one-hot product
    exactly."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_ll = logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return _masked_mean_ll(tok_ll, batch)


def _masked_mean_ll(tok_ll: torch.Tensor, batch) -> torch.Tensor:
    mask = batch.get("loss_mask")
    if mask is None:
        return -tok_ll.sum() / max(tok_ll.numel(), 1)
    mask = mask.float()
    return -(tok_ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def vocab_parallel_xent(logits: torch.Tensor,
                        batch: Dict[str, torch.Tensor], mesh
                        ) -> torch.Tensor:
    """``token_xent`` over logits cut along the vocab over ``model``
    (``[B, S, V / tp]`` on each rank; the padded columns included, as the
    reference's log-softmax over the padded vocab has them), in f32: the
    global max (a MAX all-reduce; log-softmax does not depend on it), the
    sum of exponentials and the target's logit, each summed over
    ``model`` in rank order.  Every rank returns the same loss."""
    lf = logits.float()
    v_loc = lf.shape[-1]
    m = lf.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=axis_group(mesh, "model"))
    sumexp = reduce_from_model(torch.exp(lf - m[..., None]).sum(-1), mesh)
    lab = batch["labels"].long() - axis_index(mesh, "model") * v_loc
    mine = (lab >= 0) & (lab < v_loc)
    tgt = lf.gather(-1, torch.where(mine, lab, 0)[..., None])[..., 0]
    tgt = reduce_from_model(torch.where(mine, tgt, 0.0), mesh)
    return _masked_mean_ll(tgt - m - torch.log(sumexp), batch)


class LM:
    """Decoder LM: full-attention, sliding-window, mLSTM, sLSTM and RG-LRU
    blocks; dense, MoE or no FFN; optional ``sqrt(d_model)`` embedding
    scale (gemma3, recurrentgemma); M-RoPE and vision patches (qwen2-vl)."""

    def __init__(self, rcfg: ResolvedConfig, device: DeviceLike = "cuda",
                 mesh=None, sp_decode: bool = False, sharded: bool = False):
        blocks.check_supported(rcfg)
        self.rcfg = rcfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.sp_decode = sp_decode and mesh is not None
        self.sharded = sharded and mesh is not None
        if self.tp_mesh is not None:
            if rcfg.tp != axis_size(mesh, "model"):
                raise ValueError(f"resolved for tp {rcfg.tp}, mesh model "
                                 f"axis {axis_size(mesh, 'model')}")

    @property
    def _sp_mesh(self):
        return self.mesh if self.sp_decode else None

    @property
    def tp_mesh(self):
        """The mesh when the layers are tensor-parallel (``sharded`` over
        a ``model`` axis larger than 1), else None."""
        if self.sharded and "model" in axis_names(self.mesh) \
                and axis_size(self.mesh, "model") > 1:
            return self.mesh
        return None

    @property
    def _tp_shards(self) -> int:
        return self.rcfg.tp if self.tp_mesh is not None else 1

    @property
    def _seq_shards(self) -> int:
        return axis_size(self.mesh, "data") if self.sp_decode else 1

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.rcfg.base.dtype]

    @property
    def num_layers(self) -> int:
        return self.rcfg.base.num_layers

    @property
    def kinds(self) -> Tuple[str, ...]:
        return self.rcfg.base.layer_kinds()

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
            "layers": [blocks.init_block(gen, self.rcfg, kind, self.dtype)
                       for kind in self.kinds],
        }

    def param_specs(self) -> Dict[str, Any]:
        """Logical specs of ``init``'s tree (one dict a layer)."""
        return {
            "embed": spec_embed(),
            "final_norm": spec_rmsnorm(),
            "layers": [blocks.spec_block(self.rcfg, kind)
                       for kind in self.kinds],
        }

    def state_specs(self, *, batch_sharded: bool, seq_sharded: bool
                    ) -> List[Dict[str, Any]]:
        return [blocks.spec_block_state(self.rcfg, kind,
                                        batch_sharded=batch_sharded,
                                        seq_sharded=seq_sharded)
                for kind in self.kinds]

    # ---------------------------------------------------------------- states
    def init_states(self, batch: int, s_alloc: int, kv_dtype=None) -> States:
        """Fresh per-layer states: zeroed KV caches, recurrent states at
        their initial values.  ``kv_dtype`` overrides the storage dtype of
        the KV caches only (bf16 arenas for f32 models); recurrent states
        stay f32.  With ``sp_decode`` a full-attention cache holds this
        rank's ``s_alloc / n_data`` positions; tensor-parallel, every leaf
        is this rank's shard of ``state_specs``."""
        dt = kv_dtype or self.dtype
        return [blocks.init_block_state(self.rcfg, kind, batch, s_alloc, dt,
                                        self.device, self._seq_shards,
                                        self._tp_shards)
                for kind in self.kinds]

    def state_shapes(self, batch: int, s_alloc: int, kv_dtype=None
                     ) -> List[blocks.LeafShapes]:
        """(shape, dtype) of every state leaf, allocating nothing: what
        ``init_states`` allocates, per layer kind."""
        dt = kv_dtype or self.dtype
        return [blocks.state_shape(self.rcfg, kind, batch, s_alloc, dt,
                                   self._seq_shards, self._tp_shards)
                for kind in self.kinds]

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
        kernels (``slots=`` on ``extend``/``decode_step``).  Ring caches
        (sliding-window layers) keep a model on the gather plane."""
        return all(k == ATTN_FULL for k in self.kinds)

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
                    positions=None, positions3=None):
        """-> (x, new states, summed MoE aux loss in ``train``, else
        0.0)."""
        new_states = []
        aux = 0.0
        dp_spec = None if self.mesh is None else batch_pspec(self.mesh,
                                                             None, None)
        for i, (lp, kind) in enumerate(zip(params["layers"], self.kinds)):
            x, ns, a = blocks.block_apply(
                lp, x, kind=kind, rcfg=self.rcfg, mode=mode,
                state=None if states is None else states[i],
                cache_len=cache_len, q_offset=q_offset, kv_len=kv_len,
                slots=slots, block_tables=block_tables, positions=positions,
                positions3=positions3, mesh=self.mesh, dp_spec=dp_spec,
                sp_mesh=self._sp_mesh, tp_mesh=self.tp_mesh,
                sharded=self.sharded)
            new_states.append(ns)
            if mode == "train":       # serving passes discard the aux loss
                aux = aux + a
        return x, new_states, aux

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        b = self.rcfg.base
        x = rmsnorm_apply(params["final_norm"], x, b.norm_eps)
        return lm_head_apply(params["embed"], x, b.logit_softcap,
                             self.tp_mesh)[:, 0]

    def embed_inputs(self, params, batch: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
        """Token embeddings, with qwen2-vl's ``patch_emb`` (the stubbed
        vision frontend) prepended, then the embedding scale."""
        x = embed_apply(params["embed"], batch["tokens"],
                        self.tp_mesh).to(self.dtype)
        if (self.rcfg.base.frontend_stub == "vision_patches"
                and "patch_emb" in batch):
            x = torch.cat([batch["patch_emb"].to(self.dtype), x], dim=1)
        if self.rcfg.base.embed_scale:
            # the multiplier rounded to the model dtype first, as the JAX
            # package multiplies by ``jnp.asarray(sqrt(d), dtype)``
            scale = torch.tensor(self.rcfg.base.d_model ** 0.5,
                                 dtype=self.dtype).item()
            x = x * scale
        return x

    # ------------------------------------------------------------ entry pts
    def forward(self, params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training/eval forward -> (logits [B, S, V] f32, MoE aux); the
        logits are this rank's ``[B, S, V / tp]`` when tensor-parallel."""
        x = self.embed_inputs(params, batch)
        B, S, _ = x.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x, _, aux = self._run_layers(params, x, mode="train",
                                     positions=positions,
                                     positions3=batch.get("positions3"))
        b = self.rcfg.base
        x = rmsnorm_apply(params["final_norm"], x, b.norm_eps)
        return (lm_head_apply(params["embed"], x, b.logit_softcap,
                              self.tp_mesh),
                torch.as_tensor(aux, dtype=torch.float32, device=x.device))

    def loss(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy (+ 0.01 MoE aux); ``labels``
        [B, S_total], optional ``loss_mask``."""
        logits, aux = self.forward(params, batch)
        if self.tp_mesh is not None:
            return vocab_parallel_xent(logits, batch, self.tp_mesh) \
                + 0.01 * aux
        return token_xent(logits, batch) + 0.01 * aux

    def prefill(self, params, batch: Dict[str, torch.Tensor], *,
                s_alloc: Optional[int] = None):
        """Full prompt pass -> (last-token logits [B, V], states).
        ``batch`` may carry ``patch_emb`` and ``positions3`` (qwen2-vl)."""
        x = self.embed_inputs(params, batch)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        positions3 = batch.get("positions3")
        if s_alloc:
            # prefill writes into preallocated caches via extend at offset 0
            states = self.init_states(B, s_alloc)
            x, new_states, _ = self._run_layers(
                params, x, mode="extend", states=states, q_offset=0,
                positions=positions, positions3=positions3,
                cache_len=torch.zeros((B,), dtype=torch.int32,
                                      device=x.device))
        else:
            x, new_states, _ = self._run_layers(params, x, mode="prefill",
                                             positions=positions,
                                             positions3=positions3)
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
        x = self.embed_inputs(params, batch)
        B, S, _ = x.shape
        positions = q_offset + torch.arange(S, device=x.device)[None].expand(
            B, S)
        x, new_states, _ = self._run_layers(
            params, x, mode="extend", states=states, q_offset=q_offset,
            kv_len=kv_len, slots=slots, block_tables=block_tables,
            positions=positions, positions3=batch.get("positions3"))
        return self._head(params, x[:, -1:]), new_states

    def decode_step(self, params, tokens: torch.Tensor, states: States,
                    pos: torch.Tensor, slots: Optional[torch.Tensor] = None,
                    block_tables: Optional[torch.Tensor] = None):
        """One decode step. tokens [B], pos [B] -> (logits [B, V], states).

        ``slots`` [B] switches to PAGED mode: ``states`` is the slot arena
        and the step writes the token's KV at position ``pos[b]`` of row
        ``slots[b]`` in place (callers that must not dirty the row bracket
        the steps with ``take_kv_window``/``put_kv_window``)."""
        x = self.embed_inputs(params, {"tokens": tokens[:, None]})
        positions3 = None
        if self.rcfg.base.mrope_sections is not None:
            positions3 = pos[:, None, None].expand(pos.shape[0], 1, 3)
        x, new_states, _ = self._run_layers(
            params, x, mode="decode", states=states, cache_len=pos,
            slots=slots, block_tables=block_tables, positions=pos[:, None],
            positions3=positions3)
        return self._head(params, x), new_states
