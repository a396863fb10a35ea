"""Training step and the checkpointed driver.

``make_train_step`` builds the step for any model of the port (``LM`` or
``WhisperModel``): loss and gradients over the batch, with microbatch
accumulation in f32 when ``accum_steps > 1`` (the reference's
``lax.scan`` body, as a loop), then the in-place AdamW update.  Batches
may hold numpy arrays (the data pipeline's) or tensors; they are moved to
the model's device.

With a device mesh (``distributed.compat``) the step is data-parallel,
one process a device: every rank passes the GLOBAL batch, takes its
shard of it over ``("pod", "data")`` (``sharding.batch_pspec``), and
holds the parameters and moments replicated.  Each rank's loss and
gradients are mean-reduced over ``data`` in f32 (``dp_reduce_grads``);
over ``pod`` too, or, with ``compress_pod_grads`` and a pod axis larger
than 1, through ``collectives.compressed_psum`` leaf by leaf (the
reference's ``_pod_compressed_grads``: int8 on the slowest hop, its
error feedback re-derived each step).  The model itself runs without a
mesh there: ranks along ``model`` compute the same gradients.  This
step stays beside the sharded one below because ``launch/train.py``,
its collective checkpoints and their tests feed every rank the global
batch and keep replicated moments (ROADMAP Queue 1).

A model built with ``sharded=True`` (``LM(..., mesh=, sharded=True)``,
the step ``launch/specs.build_case`` gives) takes the sharded step, the
reference's GSPMD step made explicit.  Every rank passes its OWN batch
shard and holds the parameters as its ``local_shard``s of
``tree_pspecs(model.param_specs())``: over a ``model`` axis larger than
1 the layers are tensor-parallel, and the gradients of ``model``-sharded
leaves stay local (the collectives of the layers leave every rank the
complete gradient of what it holds).  ``zero_reduce_grads`` then takes
the data-axis mean in f32, in rank order: as a reduce-scatter onto the
rank's ZeRO-1 slice where the leaf has one (``optimizer.zero_layout``),
as a division alone for expert slices sharded over ``data`` (the
all-to-all's backward has already summed every rank's tokens into
them), as an all-reduce otherwise; the pod hop follows as above.  AdamW
updates the slices and all-gathers them (``optimizer``).  Over one rank
it is the mesh-less step bit for bit.
With ``mesh=None`` and an unsharded model the step is the single-device
one.

``TrainDriver`` is the fault-tolerant loop: periodic async checkpoints,
restart from the latest, and a ``distributed.fault.HeartbeatMonitor``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..distributed.collectives import compressed_psum, group_sum, \
    reduce_scatter
from ..distributed.compat import axis_group, axis_names, mesh_shape
from ..distributed.sharding import batch_pspec, local_shard, spec_axes, \
    tree_pspecs
from ..models.convert import jax_ndims
from ..tree import leaves, tree_map
from .optimizer import OptimizerConfig, ZeroLayout, adamw_update, \
    zero_layout


@dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1
    compress_pod_grads: bool = False
    opt: OptimizerConfig = OptimizerConfig()


def batch_to_device(batch: Dict[str, Any], device
                    ) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """[B, ...] per leaf -> n batches of [B / n, ...]."""
    parts = {k: v.chunk(n) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def make_loss_fn(model) -> Callable:
    def loss_fn(params, batch):
        return model.loss(params, batch)
    return loss_fn


def local_batch(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's shard of a global batch: the leading axis over the
    mesh's dp axes."""
    return {k: local_shard(v, batch_pspec(mesh, *([None] * (v.dim() - 1))),
                           mesh) for k, v in batch.items()}


def _mean_over(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Mean of ``t`` over a mesh axis, in f32, back in t's dtype (at an
    axis of size 1 that is ``t`` bit for bit)."""
    n = mesh_shape(mesh)[axis]
    f = t.to(torch.float32, copy=True)
    dist.all_reduce(f, group=axis_group(mesh, axis))
    return (f / n).to(t.dtype)


def dp_reduce_grads(grads: Any, mesh, compress_pod: bool = False) -> Any:
    """Mean of every rank's gradients over the mesh's dp axes: ``data`` in
    f32, then ``pod`` in f32 or, with ``compress_pod``, through
    ``compressed_psum`` (int8 payload with error feedback)."""
    if "data" in axis_names(mesh):
        grads = tree_map(lambda g: _mean_over(g, mesh, "data"), grads)
    it = iter(_pod_hop(leaves(grads), mesh, compress_pod))
    return tree_map(lambda _: next(it), grads)


def _pod_hop(grads: list, mesh, compress_pod: bool) -> list:
    if "pod" not in axis_names(mesh):
        return grads
    if compress_pod and mesh_shape(mesh)["pod"] > 1:
        return [compressed_psum(g, mesh, "pod")[0] for g in grads]
    return [_mean_over(g, mesh, "pod") for g in grads]


def zero_reduce_grads(grads: Any, layout: ZeroLayout,
                      compress_pod: bool = False) -> Any:
    """The data-axis mean of a sharded step's gradients, each leaf as its
    ZeRO-1 layout holds it (module docstring), then the pod hop."""
    mesh = layout.mesh
    n = mesh_shape(mesh).get("data", 1)
    out = []
    for g, zl in zip(leaves(grads), layout.leaves):
        if n > 1:
            group = axis_group(mesh, "data")
            f = g.float()
            if "data" in spec_axes(zl.spec):
                f = f / n
            elif zl.dim is not None:
                f = reduce_scatter(f, group, zl.dim) / n
            else:
                f = group_sum(f, group) / n
            g = f.to(g.dtype)
        out.append(g)
    it = iter(_pod_hop(out, mesh, compress_pod))
    return tree_map(lambda _: next(it), grads)


def make_train_step(model, mesh: Optional[Any] = None,
                    tc: TrainConfig = TrainConfig()) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``params`` and the moments are updated in place.  With a
    ``mesh`` the step is data-parallel over it; a ``sharded`` model takes
    the sharded step over its own mesh (module docstring)."""
    if getattr(model, "sharded", False):
        if mesh is not None and mesh is not model.mesh:
            raise ValueError("a sharded model's step runs over its mesh")
        mesh = model.mesh
    loss_fn = make_loss_fn(model)
    ndims = None
    layout = None

    def value_and_grad(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, batch)
        grads = iter(torch.autograd.grad(loss, leaves(live)))
        return loss.detach(), tree_map(lambda _: next(grads), params)

    def grads_of(params, batch):
        if tc.accum_steps <= 1:
            return value_and_grad(params, batch)
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        for mb in _split_microbatches(batch, tc.accum_steps):
            loss, grads = value_and_grad(params, mb)
            loss_sum += loss
            tree_map(lambda a, g: a.add_(g), acc, grads)
        inv = 1.0 / tc.accum_steps
        return loss_sum * inv, tree_map(lambda g: g * inv, acc)

    def step(params, opt_state, batch):
        nonlocal ndims, layout
        if ndims is None:
            ndims = jax_ndims(params, model.rcfg)
            if getattr(model, "sharded", False):
                layout = zero_layout(
                    params, tree_pspecs(model.param_specs(), mesh), mesh)
        batch = batch_to_device(batch, model.device)
        if mesh is not None and layout is None:
            batch = local_batch(batch, mesh)
        loss, grads = grads_of(params, batch)
        if layout is not None:
            grads = zero_reduce_grads(grads, layout, tc.compress_pod_grads)
        elif mesh is not None:
            grads = dp_reduce_grads(grads, mesh, tc.compress_pod_grads)
        if mesh is not None:
            for a in ("data", "pod"):
                if a in axis_names(mesh):
                    loss = _mean_over(loss, mesh, a)
        params, opt_state, metrics = adamw_update(tc.opt, params, grads,
                                                  opt_state, ndims, layout)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


# ---------------------------------------------------------------------------
# fault-tolerant driver
# ---------------------------------------------------------------------------

@dataclass
class TrainDriver:
    """Checkpointed training loop with restart and heartbeat hooks."""

    step_fn: Callable
    checkpointer: Any = None            # checkpoint.Checkpointer
    ckpt_every: int = 100
    monitor: Any = None                 # fault.HeartbeatMonitor
    log_every: int = 10
    log_fn: Callable[[str], None] = print

    def run(self, params, opt_state, data_iter, n_steps: int,
            start_step: int = 0):
        """Runs steps ``[start_step, n_steps)``; resumable via (params,
        opt_state, start_step).  Returns (params, opt_state, [(step,
        loss)] at every ``log_every``-th step)."""
        history = []
        t0 = time.time()
        for step in range(start_step, n_steps):
            batch = next(data_iter)
            if self.monitor is not None:
                self.monitor.beat("train", step)
            params, opt_state, metrics = self.step_fn(
                params, opt_state, batch)
            if step % self.log_every == 0:
                loss = float(metrics["loss"])
                history.append((step, loss))
                self.log_fn(f"step {step} loss {loss:.4f} "
                            f"({time.time() - t0:.1f}s)")
            if self.checkpointer is not None and step > 0 \
                    and step % self.ckpt_every == 0:
                self.checkpointer.save(
                    step, {"params": params, "opt": opt_state})
        if self.checkpointer is not None:
            self.checkpointer.save(n_steps, {"params": params,
                                             "opt": opt_state})
            self.checkpointer.wait()
        return params, opt_state, history

    def restore_latest(self, params_like, opt_like):
        """(params, opt_state, step) from the newest checkpoint, or
        None."""
        if self.checkpointer is None:
            return None
        latest = self.checkpointer.latest_step()
        if latest is None:
            return None
        tree = self.checkpointer.restore(
            latest, {"params": params_like, "opt": opt_like})
        return tree["params"], tree["opt"], latest
