"""One CUDA graph per launch signature for the paged op-suffix decode.

The paged stage step (``LMBackend._paged_step``) is the extend of the
document chunk, then the op-suffix decode: the undo-window save,
``op_len`` decode steps of the whole model and the restore.  The decode
is some 75 small kernels a layer a step, so the host takes far longer
to enqueue it than the device takes to run it.  Here the whole decode
phase is captured once per launch signature as one
``torch.cuda.CUDAGraph`` and replayed on every later launch of that
signature: a few device copies into the graph's static inputs, one graph
launch and one copy of its logits.

Signature: ``(bucket, op_len, width)`` on one arena object at one
``growths`` count.  The operation's token values, the slots and the
true lengths are data, copied into the graph's static buffers before
each replay, so two operations of one length share a graph.  The graph
holds the arena's device pointers, so an entry is good only for the
arena object and capacity it was captured on: a growth
(``BucketArena.ensure_capacity`` reallocates every leaf) drops the
bucket's entries at the next lookup, and ``LMBackend.retire`` /
``reset`` drop them at once.

The capture runs nothing on the device, so a raise inside it leaves the
arena as it was; no entry is stored and the exception propagates.  The
first launch of a signature captures and then replays, in place of its
eager decode.  A backend's graphs share one memory pool and one capture
stream; they replay in stream order on the launching stream, never
concurrently.  The logits are copied out of the graph's static output
right after the replay, on the same stream, so a later replay of the
same graph (``inflight`` > 1) cannot overwrite a launch's logits before
``complete_group`` reads them.

Eligibility (``eligible``) follows state the code can observe: a CUDA
device, the arena's sanitizer off (its per-kernel row hooks cannot read
device ids under capture) and ``models.moe.DROP_LOG`` unset (it appends a
tensor per call).  Elsewhere the decode runs eagerly, as do the gather
and prefix planes always.

The kernels' ``LAUNCHES`` counters count Python wrapper calls, which a
replay skips: each replay adds the counts its capture recorded, so the
counters still count calls.
"""
from __future__ import annotations

import gc
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import decode_attention as _dec
from ..kernels import flash_attention as _fla
from ..models import moe

REPLAY = "replay"
CAPTURE = "capture"
EAGER = "eager"

_COUNTERS = (_dec.LAUNCHES, _fla.LAUNCHES)


def eligible(device: torch.device, arena: Any) -> bool:
    """May the paged op-suffix decode over ``arena`` run as a graph?"""
    return (device.type == "cuda" and arena.sanitizer is None
            and moe.DROP_LOG is None)


@dataclass
class _Entry:
    graph: Any                           # torch.cuda.CUDAGraph
    arena: Any                           # weakref to the BucketArena
    growths: int
    inputs: Tuple[torch.Tensor, ...]     # static input buffers
    out: torch.Tensor                    # static logits
    launches: List[Tuple[Dict[str, int], str, int]]


@dataclass
class DecodeGraphs:
    """A backend's decode graphs, keyed by ``(bucket, op_len, width)``."""

    captures: int = 0
    replays: int = 0
    _entries: Dict[Tuple[int, int, int], _Entry] = field(
        default_factory=dict)
    _pool: Any = None
    _stream: Any = None

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, arena: Any, key: Tuple[int, int, int]
               ) -> Optional[_Entry]:
        """The entry of ``key`` if it was captured on this arena object
        at its current capacity; a stale entry drops its whole bucket."""
        e = self._entries.get(key)
        if e is not None and (e.arena() is not arena
                              or e.growths != arena.growths):
            self.drop_bucket(key[0])
            e = None
        return e

    def store(self, key: Tuple[int, int, int], entry: _Entry) -> None:
        self._entries[key] = entry

    def drop_bucket(self, bucket: int) -> None:
        for k in [k for k in self._entries if k[0] == bucket]:
            del self._entries[k]

    def clear(self) -> None:
        self._entries.clear()

    def run(self, arena: Any, op_len: int,
            fn: Callable[..., torch.Tensor],
            inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, str]:
        """``fn(*inputs)`` through the signature's graph, captured first
        where the signature is new.  ``inputs`` are this launch's device
        tensors (slots first, whose length is the launch width).  Returns
        (logits from the ordinary allocator, ``REPLAY`` or ``CAPTURE``)."""
        key = (arena.bucket, op_len, int(inputs[0].shape[0]))
        e = self.lookup(arena, key)
        mode = REPLAY
        if e is None:
            e = self._capture(arena, fn, inputs)
            self.store(key, e)
            self.captures += 1
            mode = CAPTURE
        for buf, src in zip(e.inputs, inputs):
            buf.copy_(src)
        e.graph.replay()
        if mode == REPLAY:
            self.replays += 1
            for counter, name, n in e.launches:
                counter[name] += n
        return e.out.clone(), mode

    def _capture(self, arena: Any, fn: Callable[..., torch.Tensor],
                 inputs: Sequence[torch.Tensor]) -> _Entry:
        if self._stream is None:
            self._stream = torch.cuda.Stream(inputs[0].device)
        if not self._entries:
            # a pool lives while a graph captured into it does: with none
            # left (or none yet), the capture opens a new one
            self._pool = torch.cuda.graph_pool_handle()
        static = tuple(torch.empty_like(t) for t in inputs)
        graph = torch.cuda.CUDAGraph()
        before = [dict(c) for c in _COUNTERS]
        # torch.cuda.graph would also synchronise and empty the cache
        # before each capture; nothing runs during one, so neither is
        # needed, and both cost set-up time.  The collector stays off: a
        # collection inside the capture could destroy a CUDA graph or
        # event of unreachable objects, a call the capture forbids and
        # that invalidates it.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool)
                try:
                    out = fn(*static)
                except BaseException:
                    _end_failed_capture(graph)
                    raise
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        launches = [(c, k, c[k] - b[k]) for c, b in zip(_COUNTERS, before)
                    for k in c if c[k] != b[k]]
        return _Entry(graph=graph, arena=weakref.ref(arena),
                      growths=arena.growths, inputs=static, out=out,
                      launches=launches)


def _end_failed_capture(graph: Any) -> None:
    """End a capture that raised, so the stream leaves capture mode; the
    graph is dropped.  A capture the device runtime invalidated fails to
    end as well: the first error is the one that propagates."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass
