"""Persistent slot-based KV arena for the cascade serving engine.

One ``BucketArena`` per (backend, length bucket): per-layer KV caches of
shape ``[n_slots + 1, s_alloc, KV, Dh]`` preallocated on the device.  Each
live document owns one slot for its lifetime (``scheduler.SlotAllocator``);
the last row is a *scratch slot* used to pad partial batches up to the
static launch width, so every launch addresses exactly ``B`` rows and
writes from padding land harmlessly in scratch.  The scratch row index
(``n_slots`` == ``capacity``) is the one legal out-of-document sentinel
of the kernel slot contract (``kernels.ops``): slot ids must lie in
``[0, capacity]``, duplicates are allowed only for scratch, and scratch
contents are never read unmasked.

Slot lifecycle
--------------
  alloc   first time a document's bucket is touched by any launch;
  fill    ``extend`` writes the fraction slice [cached_len, f_len) into the
          slot (cached_len == 0 is prefill-into-arena);
  reuse   later launches address the slot again.  On the PAGED data plane
          (the default on CUDA) nothing is copied: the extend writes only
          the new chunk's KV into the row and the kernels read the arena in
          place through slot ids; operation suffixes decode in place behind
          a tiny [B, op_len] KV-window undo log (save -> decode -> restore),
          so the document prefix stays bitwise pristine.  The gather plane
          instead gathers the rows, extends the copy, scatters back, and
          drops the op-suffix copy — same contract, O(B * s_alloc) copy
          traffic per launch;
  free    the document exits the cascade; the slot returns to the free
          list and may be re-issued to a new document (streaming);
  evict   under slot-budget pressure the backend preempts the lowest-
          priority live slot (``LMBackend.evict_for_room``): the slot is
          freed exactly like an exit and the document re-enters the
          request queue with ``cached_len = 0`` — its next launch
          re-prefills over the recycled slot (``clear_slot``);
  retire  a bucket whose live-slot count stays zero for ``retire_after``
          launches is dropped wholesale (``LMBackend.retire``): the arena
          tensors are released so a drifting length mix does not pin device
          memory.  ``nbytes()`` is the byte accounting used by the budget.

The arena grows by doubling (reallocate on the device and copy the old
rows) when a bucket's live set exceeds capacity; growth preserves slot
contents, so it is safe mid-cascade.  Stage steps update the arena
tensors in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..models.runtime import resolve_device


def _grow_leaf(leaf: torch.Tensor, extra: int) -> torch.Tensor:
    """Reallocate ``leaf`` with ``extra`` zero rows on axis 0 and copy
    the old rows over (every state leaf is batched on axis 0)."""
    grown = torch.zeros((leaf.shape[0] + extra,) + tuple(leaf.shape[1:]),
                        dtype=leaf.dtype, device=leaf.device)
    grown[: leaf.shape[0]].copy_(leaf)
    return grown


@dataclass
class BucketArena:
    """Preallocated per-bucket KV/state arena plus host-side slot metadata."""

    model: Any                     # models.model.LM (or compatible)
    bucket: int                    # padded full-document length
    s_alloc: int                   # per-slot sequence allocation
    capacity: int                  # usable slots (scratch row excluded)
    states: Any = None             # per-layer KV caches, rows = capacity + 1
    # storage dtype override for KV-cache leaves (bf16 compression of f32
    # models); None keeps the model compute dtype.  ``nbytes()`` bills the
    # stored dtype automatically (leaves carry it).
    kv_dtype: Any = None
    # where the arena lives: must be the model's device (CUDA by default;
    # resolving "cuda" raises when no GPU is present)
    device: Any = "cuda"
    # host metadata, indexed by slot
    cached_len: np.ndarray = field(default=None)   # padded cached prefix
    true_len: np.ndarray = field(default=None)     # true cached doc tokens
    growths: int = 0               # capacity doublings (telemetry counter:
    #                                each one is a device-side realloc+copy)
    # Optional runtime race detector (analysis.sanitizer.ArenaSanitizer,
    # installed by LMBackend when ARENA_SANITIZE=1 / sanitize=True).  The
    # arena reports row recycling; the backend brackets launches.  None
    # (the default) costs nothing.
    sanitizer: Any = field(default=None, repr=False)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.device != self.model.device:
            raise ValueError(f"arena device {self.device} != model device "
                             f"{self.model.device}")
        if self.states is None:
            self.states = self.model.init_states(
                self.capacity + 1, self.s_alloc, kv_dtype=self.kv_dtype)
        if self.cached_len is None:
            self.cached_len = np.zeros(self.capacity, np.int64)
        if self.true_len is None:
            self.true_len = np.zeros(self.capacity, np.int64)

    @property
    def scratch_slot(self) -> int:
        return self.capacity

    def ensure_capacity(self, n_slots: int) -> None:
        """Grow (doubling) until at least ``n_slots`` usable slots exist."""
        if n_slots <= self.capacity:
            return
        new_cap = max(self.capacity, 1)
        while new_cap < n_slots:
            new_cap *= 2
        extra = new_cap - self.capacity
        self.states = [{n: _grow_leaf(t, extra) for n, t in layer.items()}
                       for layer in self.states]
        self.cached_len = np.concatenate(
            [self.cached_len, np.zeros(extra, np.int64)])
        self.true_len = np.concatenate(
            [self.true_len, np.zeros(extra, np.int64)])
        self.capacity = new_cap
        self.growths += 1

    def clear_slot(self, slot: int) -> None:
        """Reset metadata when a slot is re-issued to a new document.

        Device state is NOT zeroed: the new document's prefill overwrites
        [0, f_len) and every read is masked by per-slot valid lengths, so
        stale KV past the new prefix is never visible.
        """
        if self.sanitizer is not None:
            self.sanitizer.note_clear(self.bucket, slot)
        self.cached_len[slot] = 0
        self.true_len[slot] = 0

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for layer in self.states for t in layer.values())
