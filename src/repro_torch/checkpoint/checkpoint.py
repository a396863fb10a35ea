"""Checkpointing of the port's trees: async, atomic, keep-N.

The JAX package's on-disk layout, one directory per step:

    <dir>/step_00000123/
        MANIFEST.json        { leaf_path: {shape, dtype, stored, shards,
                                           shard_axis} }
        <leaf>__shard<i>.npy one file per (leaf, shard): the largest axis
                             cut into ``shards_per_leaf`` equal slices
                             where it divides, else one file
    <dir>/step_00000123.done commit marker (the step directory is renamed
                             from ``.tmp`` first, then the marker written)

Leaf paths name dict keys, list indices and NamedTuple fields
(``params/layers/0/attn/wq``, ``opt/mu/embed/table``, ``opt/step``).
numpy has no bfloat16, so a bf16 leaf is stored bit for bit as its
``uint16`` view, named ``"stored": "uint16"`` beside ``"dtype":
"bfloat16"`` in the manifest.

``save`` copies every tensor to the host before it returns (so training
may update parameters in place at once) and writes on a background
thread; ``wait`` joins.  ``restore`` rebuilds a tree shaped like
``tree_like``, each leaf on the device and in the dtype of its
counterpart there.  A checkpoint written by the JAX package (its stacked
layer tree) is not read here.

Under a device mesh (``Checkpointer(mesh=...)``, every rank holding the
same checkpointer) ``save`` is collective: each leaf is gathered whole
(``sharding.gather_full`` for a leaf given a ``NamedSharding``, as is
for a replicated one), rank 0 writes, and every rank waits at a barrier
until the step is committed.  The layout on disk does not depend on the
mesh, so ``restore(step, tree_like, shardings)`` onto another mesh is
elastic: each rank reads (memory-mapped) only its ``local_shard`` of
every leaf given a ``NamedSharding``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.sharding import NamedSharding, gather_full, shard_slices
from ..tree import leaves_with_paths, tree_map


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(numpy array, dtype name) of a tensor; bf16 as its uint16 bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _shard_slices(shape, n_shards: int, axis: int):
    """Split ``axis`` into n_shards contiguous slices."""
    if not shape or n_shards <= 1:
        yield tuple(slice(None) for _ in shape)
        return
    per = shape[axis] // n_shards
    for i in range(n_shards):
        sl = [slice(None)] * len(shape)
        sl[axis] = slice(i * per, (i + 1) * per)
        yield tuple(sl)


def _pick_shard_axis(shape) -> int:
    """The largest dim is the shard axis (balanced file sizes)."""
    return int(np.argmax(shape)) if shape else 0


def _sharding_at(shardings: Any, path: str) -> Optional[NamedSharding]:
    """The ``NamedSharding`` at a leaf path of ``shardings``, or None (the
    leaf whole)."""
    node = shardings
    for part in path.split("/"):
        if isinstance(node, dict):
            node = node.get(part)
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            node = getattr(node, part)
        elif isinstance(node, (list, tuple)):
            node = node[int(part)]
        else:
            break
    return node if isinstance(node, NamedSharding) else None


def _read(d: str, key: str, meta: dict, want) -> np.ndarray:
    """A leaf's region ``want`` (slices of its full shape, or None for
    all of it), reading from each shard file only the rows it needs."""
    base = os.path.join(d, key.replace("/", "__"))
    shape = tuple(meta["shape"])
    if not shape or 0 in shape:
        return np.load(f"{base}__shard0.npy").reshape(shape)
    want = want or tuple(slice(0, n) for n in shape)
    ax, n_files = meta["shard_axis"], meta["shards"]
    per = shape[ax] // n_files
    lo, hi = want[ax].start, want[ax].stop
    parts = []
    for i in range(lo // per, -(-hi // per)):
        part = np.load(f"{base}__shard{i}.npy", mmap_mode="r")
        sl = list(want)
        sl[ax] = slice(max(lo - i * per, 0), min(hi - i * per, per))
        parts.append(np.array(part[tuple(sl)]))
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=ax)


@dataclass
class Checkpointer:
    directory: str
    keep: int = 3
    shards_per_leaf: int = 4
    mesh: Any = None                    # collective save under a mesh
    _pool: ThreadPoolExecutor = field(
        default_factory=lambda: ThreadPoolExecutor(max_workers=2))
    _pending: List[Future] = field(default_factory=list)

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, shardings: Any = None) -> None:
        """Async checkpoint of a tree of tensors (host copies taken now).
        Under a mesh: collective and synchronous (module docstring);
        ``shardings`` names the leaves that ranks hold in shards."""
        if self.mesh is None:
            host = [(k, *_to_host(v)) for k, v in leaves_with_paths(tree)]
            self._pending = [f for f in self._pending if not f.done()]
            self._pending.append(self._pool.submit(self._write, step, host))
            return
        host = []
        for k, v in leaves_with_paths(tree):
            sh = _sharding_at(shardings, k)
            if sh is not None:
                v = gather_full(v, sh.spec, sh.mesh)
            if dist.get_rank() == 0:
                host.append((k, *_to_host(v)))
        if dist.get_rank() == 0:
            self._write(step, host)
        dist.barrier()

    def _write(self, step: int,
               host: List[Tuple[str, np.ndarray, str]]) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {}
        for key, arr, dtype in host:
            base = key.replace("/", "__")
            axis = _pick_shard_axis(arr.shape)
            n_shards = self.shards_per_leaf if arr.ndim and \
                arr.shape[axis] % self.shards_per_leaf == 0 else 1
            for i, sl in enumerate(_shard_slices(arr.shape, n_shards, axis)):
                np.save(os.path.join(tmp, f"{base}__shard{i}.npy"),
                        np.ascontiguousarray(arr[sl]))
            manifest[key] = {"shape": list(arr.shape), "dtype": dtype,
                             "stored": str(arr.dtype), "shards": n_shards,
                             "shard_axis": axis}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic commit
        with open(final + ".done", "w") as f:
            f.write("ok")
        self._gc()

    def wait(self) -> None:
        """Join every pending write; re-raises a write's exception."""
        for f in self._pending:
            f.result()
        self._pending = []

    # --------------------------------------------------------------- restore
    def restore(self, step: int, tree_like: Any,
                shardings: Any = None) -> Any:
        """The tree saved at ``step``, shaped like ``tree_like``; each
        leaf on the device and in the dtype of its counterpart.
        ``shardings`` (a tree of ``sharding.NamedSharding`` in
        ``tree_like``'s structure, None leaves or subtrees whole) targets
        a possibly different mesh than the one the checkpoint was written
        under: each such leaf is this rank's ``local_shard``."""
        self.wait()
        d = self._step_dir(step)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        loaded = {}
        for key, _ in leaves_with_paths(tree_like):
            meta = manifest[key]
            sh = _sharding_at(shardings, key)
            want = None if sh is None else shard_slices(
                meta["shape"], sh.spec, sh.mesh)
            loaded[key] = _from_host(_read(d, key, meta, want),
                                     meta["dtype"])
        keys = iter(k for k, _ in leaves_with_paths(tree_like))
        return tree_map(lambda like: loaded[next(keys)].to(
            device=like.device, dtype=like.dtype), tree_like)

    # ------------------------------------------------------------------ meta
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps(self) -> List[int]:
        """Committed steps (a ``.done`` marker beside its directory)."""
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)\.done", name)
            if m and os.path.isdir(self._step_dir(int(m.group(1)))):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            try:
                os.remove(self._step_dir(s) + ".done")
            except OSError:
                pass
