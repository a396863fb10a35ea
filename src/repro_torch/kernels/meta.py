"""Kernel calls on the ``meta`` device: shapes without data.

The dry-run (``launch.dryrun``) runs a whole step on ``meta`` stand-ins
to count what it does.  A kernel's plain version would count the wrong
work there (the plain attention materializes a ``[B, H, Sq, Skv]`` score
tensor, which the kernel never writes), so ``kernels.ops`` sends a
``meta`` tensor to the kernel's meta function instead: it returns an
output of the kernel's shape and the bytes and operations of the kernel's
``work``, which ``meta_call`` hands to every observer (``observe``).  A
``meta`` tensor computes nothing, and a CUDA tensor still always runs its
kernel.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List

import torch

# (name, bytes, operations, dtype the kernel computes in)
Observer = Callable[[str, float, float, torch.dtype], None]

_OBSERVERS: List[Observer] = []


@contextlib.contextmanager
def observe(fn: Observer) -> Iterator[None]:
    """Call ``fn(name, bytes, operations, dtype)`` for every kernel call
    on ``meta`` tensors inside the block."""
    _OBSERVERS.append(fn)
    try:
        yield
    finally:
        _OBSERVERS.remove(fn)


def meta_call(name: str, out: torch.Tensor, nbytes: float, flops: float,
              dtype: torch.dtype) -> torch.Tensor:
    """Report one kernel call's work and return its output stand-in."""
    for fn in list(_OBSERVERS):
        fn(name, nbytes, flops, dtype)
    return out


def compute_dtype(q: torch.Tensor, k: torch.Tensor) -> torch.dtype:
    """The dtype an attention kernel multiplies in: f32 when q or the
    cache is f32 (the FMA body), else q's (the tensor cores)."""
    return torch.float32 if torch.float32 in (q.dtype, k.dtype) else q.dtype
