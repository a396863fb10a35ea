"""Fused chunk relevance scoring: masked mean-pool + logistic head.

``relevance_score(x, lengths, w, b)`` computes, per chunk ``c``,
``sigmoid(sum_{t < min(len_c, T)} x[c, t] . w / max(len_c, 1) + b)`` with
the CUDA kernel of ``csrc/relevance_score.cu``; the ``[C, D]`` pooled
matrix is never written.  It replaces ``relevance_score_pallas`` of the
JAX package and returns exactly ``[C]`` scores: the kernel masks its own
edge, so the chunk axis is never padded.

The kernel reads only the rows ``t < min(len_c, T)`` of each chunk.  For
finite ``x`` that equals multiplying the padding rows by a zero mask, as
the plain version does; the restructurer's embedder zero-fills its
padding rows anyway (``core.restructure.HashEmbedder.tokens``).  The order
of every sum is fixed by ``(T, D)`` alone, so a chunk's score is bitwise
the same whatever other chunks share the call and at whatever index it
sits: a corpus may be scored in one call, or split into feeds, with the
same bits as one call per document.

The wrapper takes CUDA tensors only and raises otherwise: ``x`` f32
``[C, T, D]`` contiguous (``D`` a multiple of 4, at most 1024),
``lengths`` int32 ``[C]``, ``w`` f32 ``[D]``, ``b`` an f32 tensor of one
element on the same device (read on the device, so a launch never waits
on the host).  ``relevance_score_plain`` is the plain PyTorch version,
used by ``kernels.ops`` for CPU tensors and by ``chip_smoke.py`` as the
kernel's yardstick of correctness.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import _build, ref

LAUNCHES: Dict[str, int] = {"relevance_score": 0}

MAX_D = 1024


def _check(x, lengths, w, b) -> None:
    where = "relevance_score"
    tensors = (x, lengths, w, b)
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        raise ValueError(f"{where}: expects CUDA tensors")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{where}: tensors on different devices")
    if (x.dtype != torch.float32 or w.dtype != torch.float32
            or b.dtype != torch.float32 or lengths.dtype != torch.int32):
        raise ValueError(f"{where}: x, w, b must be float32 and lengths "
                         f"int32, got {x.dtype}/{w.dtype}/{b.dtype}/"
                         f"{lengths.dtype}")
    if x.dim() != 3 or x.shape[1] == 0:
        raise ValueError(f"{where}: x must be [C, T, D] with T > 0, got "
                         f"{tuple(x.shape)}")
    C, _, D = x.shape
    if D == 0 or D % 4 or D > MAX_D:
        raise ValueError(f"{where}: D must be a multiple of 4 in "
                         f"[4, {MAX_D}], got {D}")
    if lengths.shape != (C,) or w.shape != (D,) or b.numel() != 1:
        raise ValueError(f"{where}: lengths must be [C], w [D] and b one "
                         f"element, got {tuple(lengths.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{where}: tensors must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{where}: x and w must be 16-byte aligned "
                         "(float4 loads)")


def relevance_score(x: torch.Tensor, lengths: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """[C] relevance scores from the CUDA kernel, on the current stream."""
    _check(x, lengths, w, b)
    C, T, D = x.shape
    out = torch.empty(C, dtype=torch.float32, device=x.device)
    if C == 0:
        return out
    lib = _build.library("relevance_score")
    with torch.cuda.device(x.device):
        err = lib.repro_relevance_score(
            x.data_ptr(), lengths.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), C, T, D,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "relevance_score")
    LAUNCHES["relevance_score"] += 1
    return out


def relevance_score_plain(x, lengths, w, b) -> torch.Tensor:
    """Plain PyTorch version of :func:`relevance_score`."""
    return ref.relevance_reference(x, lengths, w, b)
