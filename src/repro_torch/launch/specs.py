"""Per-(arch x shape) input specs and the sharded steps of one cell.

The JAX package's ``launch/specs.py`` for the port, over the shape table

    train_4k      train_step(params, opt, batch)         B=256  S=4096
    prefill_32k   serve_prefill(params, batch)           B=32   S=32768
    decode_32k    serve_step(params, tok, states, pos)   B=128  KV=32768
    long_500k     serve_step ...                         B=1    KV=524288

``build_case`` assembles (fn, argument stand-ins, in/out specs) for one
cell on one mesh; ``batch_override`` cuts the shape's global batch (a
cell run on one card, where the full batch does not fit).  The steps
are the port's own, over a model built with ``sharded=True``
(``models.model``): the sharded train step of ``train.train_loop`` with
ZeRO-1 moments (``train.optimizer``), the model's ``prefill`` and
``decode_step``.  Each rank runs the same
``fn`` on its own shards, so the stand-ins are tensors on the ``meta``
device at ONE RANK's local shapes (nothing is allocated; the parameter
shapes come from ``init`` under ``FakeTensorMode``), and
``in_shardings``/``out_shardings`` are the trees of mesh specs
(``distributed.sharding``) the shards are cut by.  Every arch's layers
are tensor-parallel over the ``model`` axis: attention, MLP and MoE,
the recurrent mixers (``models.ssm``) and whisper's encoder-decoder
(``models.whisper``); ``long_500k`` builds ``LM(sp_decode=True)`` for
every decoder (gemma3-27b's global layers cut their caches over
``data`` and their KV heads over ``model``; sliding-window rings and
recurrent states stay whole along the sequence).  Whisper's batch adds
``frame_emb`` (the stub frontend's frames), cut over the batch axes
like the tokens.  ``donate_argnums``
is kept as metadata: the port's steps update parameters, moments and
caches in place anyway.  A mesh may be a ``compat.MeshShape`` (the
production meshes) for the specs and shapes; running ``fn`` needs a
``DeviceMesh`` over a joined world.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..config import ResolvedConfig, ShapeConfig, resolve, shape_config
from ..configs import cut_layers, get_config
from ..distributed.compat import dp_axes, mesh_shape
from ..distributed.sharding import Spec, batch_pspec, shard_shape, \
    tree_pspecs
from ..models.model import LM
from ..models.whisper import WhisperModel
from ..train.optimizer import OptState, moment_shapes, zero_layout
from ..train.train_loop import TrainConfig, make_train_step
from ..tree import tree_map

I32 = torch.int32
BF16 = torch.bfloat16


def dp_size(mesh) -> int:
    sizes = mesh_shape(mesh)
    n = 1
    for a in dp_axes(mesh):
        n *= sizes[a]
    return n


def make_model(arch: str, mesh, shape_name: str,
               n_rep_override: Optional[int] = None, device="cuda"):
    """(model, rcfg) for one cell: resolved at ``tp`` = the mesh's model
    axis, built ``sharded`` over the mesh, sequence-parallel decode for
    ``long_500k`` (every decoder: gemma3-27b, xlstm-350m and
    recurrentgemma-2b have the cell); ``n_rep_override`` cuts
    ``num_layers`` to that many repetitions of the block pattern (plus
    its tail; whisper keeps its 6 + 6 layers)."""
    cfg = cut_layers(get_config(arch), n_rep_override)
    rcfg = resolve(cfg, tp=mesh_shape(mesh)["model"] if mesh else 1)
    kw = dict(device=device, mesh=mesh, sharded=mesh is not None)
    if cfg.family == "audio":
        return WhisperModel(rcfg, **kw), rcfg
    return LM(rcfg, sp_decode=(shape_name == "long_500k"), **kw), rcfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _local_structs(full: Any, specs: Any, mesh) -> Any:
    """Meta tensors at one rank's shapes of a tree (dicts and lists) of
    full tensors or ``(shape, dtype)`` pairs, cut by a spec tree."""
    if isinstance(full, dict):
        return {k: _local_structs(v, specs[k], mesh) for k, v in full.items()}
    if isinstance(full, list):
        return [_local_structs(v, s, mesh) for v, s in zip(full, specs)]
    shape, dtype = (full.shape, full.dtype) if hasattr(full, "shape") \
        else full
    return _meta(shard_shape(shape, specs, mesh), dtype)


def param_structs(model, mesh) -> Any:
    """One rank's parameter shards as meta tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        # a CPU twin draws the shapes: a generator cannot live on ``meta``
        full = type(model)(model.rcfg, device="cpu").init(0)
    return _local_structs(full, tree_pspecs(model.param_specs(), mesh), mesh)


def _batch_structs(rcfg: ResolvedConfig, sh: ShapeConfig
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The GLOBAL batch: ``(shape, dtype)`` per input."""
    b = rcfg.base
    B, S = sh.global_batch, sh.seq_len
    if b.frontend_stub == "vision_patches":
        return {"tokens": ((B, S - b.frontend_len), I32),
                "patch_emb": ((B, b.frontend_len, b.d_model), BF16),
                "positions3": ((B, S, 3), I32),
                "labels": ((B, S), I32)}
    if b.frontend_stub == "audio_frames":
        return {"frame_emb": ((B, b.encoder_seq_len, b.d_model), BF16),
                "tokens": ((B, S), I32), "labels": ((B, S), I32)}
    return {"tokens": ((B, S), I32), "labels": ((B, S), I32)}


def _batch_pspecs(rcfg: ResolvedConfig, sh: ShapeConfig, mesh
                  ) -> Dict[str, Spec]:
    dp = batch_pspec(mesh)[0] if sh.global_batch % dp_size(mesh) == 0 \
        else None
    return {k: (dp,) + (None,) * (len(shape) - 1)
            for k, (shape, _) in _batch_structs(rcfg, sh).items()}


@dataclass
class DryRunCase:
    """Everything one (arch x shape x mesh) cell runs: ``fn(*args)`` on
    every rank, with ``args`` one rank's meta stand-ins, and the model
    ``fn`` runs."""
    name: str
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Any
    out_shardings: Any
    model: Any
    donate_argnums: Tuple[int, ...] = ()


def _unsharded(model):
    """The same model without a mesh: the GLOBAL state shapes."""
    return type(model)(model.rcfg, device=model.device)


def build_case(arch: str, shape_name: str, mesh,
               n_rep_override: Optional[int] = None,
               device="cuda",
               batch_override: Optional[int] = None) -> DryRunCase:
    model, rcfg = make_model(arch, mesh, shape_name, n_rep_override, device)
    sh = shape_config(shape_name, batch_override)
    name = f"{arch}|{shape_name}"
    pspecs = tree_pspecs(model.param_specs(), mesh)
    params = param_structs(model, mesh)
    batch_specs = _batch_pspecs(rcfg, sh, mesh)
    batch_sharded = sh.global_batch % dp_size(mesh) == 0
    dp = batch_pspec(mesh)[0] if batch_sharded else None

    if sh.kind == "train":
        layout = zero_layout(params, pspecs, mesh)
        moments = iter(moment_shapes(params, layout))
        mu = tree_map(lambda p: _meta(next(moments), torch.float32), params)
        zit = iter([zl.zspec for zl in layout.leaves])
        zspecs = tree_map(lambda _: next(zit), params)
        opt = OptState(_meta((), I32), mu,
                       tree_map(lambda t: _meta(t.shape, t.dtype), mu))
        batch = _local_structs(_batch_structs(rcfg, sh),
                               batch_specs, mesh)
        # the int8 pod hop stays off, as in the reference's sharded step
        step = make_train_step(model, mesh,
                               TrainConfig(compress_pod_grads=False))
        opt_specs = OptState((), zspecs, zspecs)
        metrics = {"loss": (), "grad_norm": (), "lr": ()}
        return DryRunCase(name, step, (params, opt, batch),
                          (pspecs, opt_specs, batch_specs),
                          (pspecs, opt_specs, metrics), model,
                          donate_argnums=(0, 1))

    if sh.kind == "prefill":
        structs = _batch_structs(rcfg, sh)
        structs.pop("labels")
        bspecs = {k: v for k, v in batch_specs.items() if k in structs}
        st_specs = tree_pspecs(model.state_specs(
            batch_sharded=batch_sharded, seq_sharded=False), mesh)

        def prefill_fn(params, batch):
            return model.prefill(params, batch, s_alloc=sh.seq_len)

        return DryRunCase(name, prefill_fn,
                          (params, _local_structs(structs, bspecs, mesh)),
                          (pspecs, bspecs), ((dp, "model"), st_specs), model)

    # decode kinds (decode_32k / long_500k): one-token serve_step
    B = sh.global_batch
    st_specs = tree_pspecs(model.state_specs(
        batch_sharded=batch_sharded,
        seq_sharded=(shape_name == "long_500k")), mesh)
    states = _local_structs(_unsharded(model).state_shapes(B, sh.seq_len),
                            st_specs, mesh)
    tok = _meta(shard_shape((B,), (dp,), mesh), I32)

    def decode_fn(params, tokens, states, pos):
        return model.decode_step(params, tokens, states, pos)

    return DryRunCase(name, decode_fn, (params, tok, states, tok),
                      (pspecs, (dp,), st_specs, (dp,)),
                      ((dp, "model"), st_specs), model, donate_argnums=(2,))
