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


@dataclass
class Checkpointer:
    directory: str
    keep: int = 3
    shards_per_leaf: int = 4
    _pool: ThreadPoolExecutor = field(
        default_factory=lambda: ThreadPoolExecutor(max_workers=2))
    _pending: List[Future] = field(default_factory=list)

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any) -> None:
        """Async checkpoint of a tree of tensors (host copies taken now)."""
        host = [(k, *_to_host(v)) for k, v in leaves_with_paths(tree)]
        self._pending = [f for f in self._pending if not f.done()]
        self._pending.append(self._pool.submit(self._write, step, host))

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
    def restore(self, step: int, tree_like: Any) -> Any:
        """The tree saved at ``step``, shaped like ``tree_like``; each
        leaf on the device and in the dtype of its counterpart."""
        self.wait()
        d = self._step_dir(step)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        loaded = {}
        for key, _ in leaves_with_paths(tree_like):
            meta = manifest[key]
            parts = [np.load(os.path.join(
                d, f"{key.replace('/', '__')}__shard{i}.npy"))
                for i in range(meta["shards"])]
            arr = parts[0] if len(parts) == 1 else np.concatenate(
                parts, axis=meta["shard_axis"])
            # a 0-d leaf was saved as shape (1,) (np.ascontiguousarray)
            arr = arr.reshape(meta["shape"])
            loaded[key] = _from_host(arr, meta["dtype"])
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
