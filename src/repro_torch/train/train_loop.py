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
error feedback re-derived each step).  Ranks along ``model`` hold the
same batch shard and compute the same gradients: dense parameters are
replicated over ``model`` here, where the JAX package lets GSPMD shard
them by ``param_specs`` (tensor parallelism is not ported).  The model
itself runs without a mesh (its MoE mesh strategies are forward only).
With ``mesh=None`` the step is the single-device one.

``TrainDriver`` is the fault-tolerant loop: periodic async checkpoints,
restart from the latest, and a ``distributed.fault.HeartbeatMonitor``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..distributed.collectives import compressed_psum
from ..distributed.compat import axis_group, axis_names, mesh_shape
from ..distributed.sharding import batch_pspec, local_shard
from ..models.convert import jax_ndims
from ..tree import leaves, tree_map
from .optimizer import OptimizerConfig, adamw_update


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
    names = axis_names(mesh)
    if "data" in names:
        grads = tree_map(lambda g: _mean_over(g, mesh, "data"), grads)
    if "pod" in names:
        if compress_pod and mesh_shape(mesh)["pod"] > 1:
            grads = tree_map(
                lambda g: compressed_psum(g, mesh, "pod")[0], grads)
        else:
            grads = tree_map(lambda g: _mean_over(g, mesh, "pod"), grads)
    return grads


def make_train_step(model, mesh: Optional[Any] = None,
                    tc: TrainConfig = TrainConfig()) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``params`` and the moments are updated in place.  With a
    ``mesh`` the step is data-parallel over it (module docstring)."""
    loss_fn = make_loss_fn(model)
    ndims = None

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
        nonlocal ndims
        if ndims is None:
            ndims = jax_ndims(params, model.rcfg)
        batch = batch_to_device(batch, model.device)
        if mesh is not None:
            batch = local_batch(batch, mesh)
        loss, grads = grads_of(params, batch)
        if mesh is not None:
            grads = dp_reduce_grads(grads, mesh, tc.compress_pod_grads)
            for a in ("data", "pod"):
                if a in axis_names(mesh):
                    loss = _mean_over(loss, mesh, a)
        params, opt_state, metrics = adamw_update(tc.opt, params, grads,
                                                  opt_state, ndims)
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
