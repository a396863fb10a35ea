"""Cascade serving: a long-lived multi-tenant ``CascadeServer`` running a
continuous-batching request loop over PyTorch models (slot-arena data
plane).

This is the data-plane twin of the analytical cost model: API prompt
caching becomes PHYSICAL KV-prefix reuse.  Documents ride *before*
operations in the token stream, so

  * extending a document from fraction f_j to f_i > f_j runs the model's
    ``extend`` path over only the new suffix (cached doc-prefix KV reused);
  * switching operations on the same model at the same fraction re-runs
    ONLY the operation tokens against the cached document KV;
  * the engine never merges operation tokens into the cached document
    state: on the paged data plane op suffixes decode over the arena in
    place behind a tiny KV-window undo log, on the gather plane against a
    row copy that is dropped — either way the cached document prefix
    survives bitwise untouched.

Multi-tenant serving API
------------------------
One server owns the LM backends, their KV arenas, and the global
``scheduler.RequestQueue``; many queries (cascades) are registered and
served CONCURRENTLY over that shared substrate:

    server = CascadeServer(backends, operations, n_classes)
    handle = server.register(cascade, accuracy_target=0.9)   # QueryHandle
    fut    = handle.submit(doc_id, text)                     # DocFuture
    server.step()                            dispatch ONE launch (any query)
    handle.poll()                            this query's fresh resolutions
    handle.result() / server.stats(qid)      per-query results, stats, $
    server.drain()                           step until idle (all queries)

Every submitted document becomes a ``scheduler.DocRequest`` carrying its
owning ``query_id``; the stage cursor resolves ``(model, op, fraction)``
through the handle's stage table.  The launch signature ``(backend,
bucket, cached_len, op, f_len)`` carries neither stage index nor query
id, so ``RequestQueue.next_launch`` packs ready documents ACROSS queries.
Results, ``ServeStats`` and $-accounting stay partitioned per query.
``CascadeEngine`` is the single-query compatibility wrapper (``run()``
submits everything and drains).

Arena layout and memory control
-------------------------------
Per (backend, length bucket) the server keeps one persistent
``arena.BucketArena``: per-layer KV caches ``[n_slots + 1, s_alloc, KV,
Dh]`` (s_alloc = bucket + operation reserve; the extra row is scratch for
batch padding).  A document keeps its slot until it exits its cascade
unless a backend budget binds (``slot_budget`` / ``byte_budget``, with
fewest-cached-tokens-lost eviction and bucket retirement).

Stage steps run eagerly and update the arena tensors IN PLACE.
Prefill-into-arena is the ``cached_len == 0`` case of extend, fraction
extension writes the suffix at an offset with per-row true lengths
masking bucket PAD out of the chunk, and the operation suffix runs as
masked decode steps whose per-document ``kv_len`` rides through the
decode kernel.

Paged data plane (the default on CUDA for models whose serve-state is
all full-attention KV caches): the stage step never copies arena rows.
Slot ids go to the hand-written paged kernels
(``ops.arena_decode_attention`` / ``ops.attention_paged``), which read
arena rows in place, so extend writes only the chunk's KV and decode
reads the arena directly.  Results are BITWISE identical to the gather
plane (``paged=False``) — preds, confs, per-document $, and the arena
contents — because the dense kernels are the same CUDA bodies reading
row ``b`` for sequence ``b``.  Slot ids are validated once per launch on
the host, never per layer on the device.

Dispatch is asynchronous: ``dispatch_group`` enqueues the step on the
current CUDA stream and records a ``torch.cuda.Event`` after the logits;
``complete_group`` waits on that event.  On the CPU the step runs
synchronously.

Failure model
-------------
Every submitted document reaches exactly one terminal state —
``RESOLVED``, ``FAILED``, or ``TIMED_OUT`` — surfaced on its
``DocFuture``: failed launches retry solo with capped-exponential
backoff (``RetryPolicy``), deadlines bound wall-clock, non-finite
confidences are quarantined, a per-backend circuit breaker reroutes
stages, a watchdog raises ``ServerStalledError`` instead of spinning,
and a write-ahead ``RequestJournal`` enables ``CascadeServer.recover``.
Not ported yet: prefix sharing (``prefix_sharing=True`` raises) and the
fault injector with its arena-loss events.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

from ..core.tasks import Cascade
from ..data.tokenizer import PAD, HashWordTokenizer, class_token
from ..kernels.ops import _check_slots
from ..launch.roofline import bandwidth_utilization
from ..models.runtime import DTYPES, resolve_device
from .arena import BucketArena
from .scheduler import (FAILED, RESOLVED, TIMED_OUT, DocRequest, LaunchSpec,
                        RequestQueue, RetryPolicy, SchedulingPolicy,
                        ServeStats, SlotAllocator, StageConfig, fraction_len)
from .telemetry import (EV_ESCALATE, EV_EVICT, EV_LAUNCH, EV_QUARANTINE,
                        EV_RETRY, EV_SUBMIT, LaunchRecord, Telemetry)


class ServerStalledError(RuntimeError):
    """``drain()``/``step()`` detected a live-locked server: ``stall_limit``
    consecutive steps made no progress (no launch, no resolution) while
    nothing was legitimately waiting out a retry backoff.  ``stuck`` lists
    ``(query_id, ext_id, stage, retries, not_before)`` per wedged request.
    """

    def __init__(self, message: str,
                 stuck: List[Tuple[int, int, int, int, float]]):
        super().__init__(message)
        self.stuck = stuck


@dataclass
class BackendHealth:
    """Consecutive-failure circuit breaker state for one backend.

    ``threshold`` straight launch failures open the breaker for
    ``cooldown`` launch attempts (server-global attempt counter); while
    open, the server reroutes the backend's queued stages to the next
    cascade stage.  After the cooldown the breaker half-opens: the next
    launch probes the backend, and a further failure re-trips it.
    """

    threshold: int = 3
    cooldown: int = 8
    consecutive_failures: int = 0
    opened_at: Optional[int] = None     # attempt index the breaker opened
    trips: int = 0

    def record_failure(self, attempt_idx: int) -> bool:
        """Note one launch failure; True when this failure TRIPS the
        breaker (fresh trip or re-trip after an expired cooldown)."""
        self.consecutive_failures += 1
        if (self.consecutive_failures >= self.threshold
                and not self.is_open(attempt_idx)):
            self.opened_at = attempt_idx
            self.trips += 1
            return True
        return False

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self.opened_at = None

    def is_open(self, attempt_idx: int) -> bool:
        return (self.opened_at is not None
                and attempt_idx < self.opened_at + self.cooldown)


class RequestJournal:
    """Write-ahead request journal enabling warm-restart recovery.

    ``record_submit`` runs BEFORE the request enters the queue and
    ``record_resolution`` after a terminal state is reached, so at any
    crash point the journal names every admitted document and exactly
    which ones are unresolved.  ``CascadeServer.recover(journal)`` on a
    fresh server (same cascades registered in the same order) restores
    resolved documents verbatim — original pred/conf/$, no recompute —
    and re-submits unresolved ones with identical external ids,
    arrivals, and deadline semantics.
    """

    def __init__(self) -> None:
        self.registrations: List[int] = []          # qids in register order
        self.submits: List[Dict[str, Any]] = []
        self.resolutions: Dict[Tuple[int, int], Dict[str, Any]] = {}

    def record_register(self, query_id: int) -> None:
        self.registrations.append(query_id)

    def record_submit(self, query_id: int, ext_id: int, text: str,
                      arrival: Optional[float], stage: int,
                      deadline_s: Optional[float]) -> None:
        self.submits.append(dict(
            query_id=query_id, ext_id=ext_id, text=text, arrival=arrival,
            stage=stage, deadline_s=deadline_s))

    def record_resolution(self, req: DocRequest) -> None:
        self.resolutions[(req.query_id, req.ext_id)] = dict(
            status=req.status, pred=req.pred, conf=req.conf,
            exit_stage=req.exit_stage, cost=float(req.cost),
            error=req.error)

    def unresolved(self) -> List[Dict[str, Any]]:
        return [s for s in self.submits
                if (s["query_id"], s["ext_id"]) not in self.resolutions]


@dataclass
class GroupTicket:
    """One in-flight stage launch: the non-blocking ``dispatch_group``
    half returns this; ``complete_group`` consumes it.

    ``logits`` is a device tensor whose producing work may still be
    running; ``event`` (CUDA only) is recorded on the stream right after
    it, so completion waits for exactly this launch.  The sanitizer
    bracket (``san_ticket``) stays OPEN across the ticket's lifetime, so
    any structural arena operation that touches the ticket's rows while
    it is in flight raises ``ArenaRaceError``.  Host-side billing
    metadata (``new_d``/``cached_d``/``op_len``) and structural traffic
    (``copy_bytes``/``hbm_bytes``) are captured at dispatch."""

    ids: List[int]
    bucket: int
    width: int                       # padded launch rows
    n_classes: int
    logits: torch.Tensor             # [Bp, vocab] f32, maybe still running
    event: Optional[Any]             # torch.cuda.Event after the logits
    new_d: np.ndarray                # per-doc new true tokens
    cached_d: np.ndarray             # per-doc cached true tokens
    op_len: int                      # billed op suffix
    san: Any                         # ArenaSanitizer or None
    san_ticket: Any                  # open begin_launch bracket (or None)
    timing: Dict[str, float]         # host/dispatch at dispatch; +device
    ts_enqueue: float                # step call began (dispatch segment)
    ts_dispatched: float             # dispatch_group returned control
    copy_bytes: int
    hbm_bytes: Optional[float]
    ts_sync: float = 0.0             # completion wait entered
    ts_ready: float = 0.0            # device results host-visible


@dataclass
class LMBackend:
    """A model + params behind the server, with a slot-based KV arena."""

    name: str
    model: Any                       # models.model.LM
    params: Any
    tokenizer: HashWordTokenizer
    rate_per_token: float = 1.0      # $ parity with the analytical model
    cached_discount: float = 0.5
    # NOTE: arenas size per-slot allocation as bucket + op_reserve;
    # ``s_alloc`` is kept for API compatibility and does not bound arena
    # memory.
    s_alloc: int = 4096
    op_reserve: int = 64             # suffix headroom past the bucket length
    init_slots: int = 8              # initial arena capacity per bucket
    slot_budget: Optional[int] = None  # max live slots across buckets
    byte_budget: Optional[int] = None  # max device bytes across arenas
    retire_after: int = 64           # idle launches before bucket retirement
    # Paged data plane: None = auto (on when the model lives on CUDA and is
    # paged-capable — every serve-state leaf a full-attention KV cache).
    # True forces it (on the CPU the kernels' plain versions gather rows
    # per call); False forces the gather/scatter stage step.
    paged: Optional[bool] = None
    # Arena STORAGE dtype for KV-cache leaves ("bfloat16" compresses an
    # f32 model's arenas to half the bytes).  Quantization happens on the
    # extend/decode write; the kernels upcast to f32 at read, so the
    # $-ledger — billed from token counts — is unchanged.  None stores the
    # compute dtype.
    kv_dtype: Optional[str] = None
    # Prefix sharing (op-first layout over block tables) is not ported
    # yet: True raises NotImplementedError.
    prefix_sharing: bool = False
    # Device of the model and its arenas: CUDA unless the caller asks for
    # the CPU ("cuda" raises when no GPU is present).
    device: Any = "cuda"
    _arenas: Dict[int, BucketArena] = field(default_factory=dict)
    _alloc: SlotAllocator = field(default_factory=SlotAllocator)
    _doc_slot: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    _idle: Dict[int, int] = field(default_factory=dict)
    _slot_nbytes: Dict[int, int] = field(default_factory=dict)
    pressure_retired: int = 0        # buckets freed mid-eviction (byte budget)
    # host assembly + async dispatch wall-clock; the per-launch
    # decomposition (host/dispatch/device) lives in ``last_timing``
    host_overhead_s: float = 0.0
    telemetry: Optional[Any] = field(default=None, repr=False)  # Telemetry
    last_timing: Optional[Dict[str, float]] = field(default=None, repr=False)
    last_copy_bytes: int = field(default=0, repr=False)
    last_hbm_bytes: Optional[float] = field(default=None, repr=False)
    _params_nbytes: Optional[int] = field(default=None, repr=False)
    # Runtime arena sanitizer (analysis.sanitizer.ArenaSanitizer): per-row
    # ownership epochs + launch read/write-set brackets.  None = follow the
    # ARENA_SANITIZE env var; True/False force it.  Host-side only.
    sanitize: Optional[bool] = None
    # callback rid -> {"query":..., "doc":...} installed by CascadeServer
    doc_info: Optional[Any] = field(default=None, repr=False)
    _sanitizer: Optional[Any] = field(default=None, repr=False)

    def __post_init__(self) -> None:
        if self.prefix_sharing:
            raise NotImplementedError(
                "prefix sharing is not ported to the PyTorch engine yet")
        self.device = resolve_device(self.device)
        if self.device != self.model.device:
            raise ValueError(f"backend {self.name!r} device {self.device} "
                             f"!= model device {self.model.device}")

    def sanitizer(self):
        """The active ``ArenaSanitizer`` (lazily built), or None when off."""
        enabled = self.sanitize
        if enabled is None:
            from ..analysis.sanitizer import env_enabled
            enabled = env_enabled()
        if not enabled:
            return None
        if self._sanitizer is None:
            from ..analysis.sanitizer import ArenaSanitizer
            self._sanitizer = ArenaSanitizer(backend=self.name,
                                             doc_info=lambda rid: (
                                                 self.doc_info(rid)
                                                 if self.doc_info else None),
                                             telemetry=self.telemetry)
        self._sanitizer.telemetry = self.telemetry   # server may install late
        return self._sanitizer

    def reset(self) -> None:
        self._arenas.clear()
        self._alloc.reset()
        self._doc_slot.clear()
        self._idle.clear()
        self.pressure_retired = 0
        self.host_overhead_s = 0.0
        self.last_timing = None
        self.last_copy_bytes = 0
        self.last_hbm_bytes = None
        if self._sanitizer is not None:
            self._sanitizer.reset()

    def params_nbytes(self) -> int:
        """Device bytes of the parameter set (memoized): the fixed term
        of the decode-launch HBM-traffic estimate."""
        if self._params_nbytes is None:
            def walk(t):
                if isinstance(t, torch.Tensor):
                    return t.numel() * t.element_size()
                if isinstance(t, dict):
                    return sum(walk(v) for v in t.values())
                return sum(walk(v) for v in t)
            self._params_nbytes = int(walk(self.params))
        return self._params_nbytes

    def _note_launch_traffic(self, bucket: int, batch: int, op_len: int,
                             n_new: int, kv_true: np.ndarray) -> None:
        """Per-launch structural traffic for the telemetry timeline:
        copy/undo-log bytes and, for decode-only launches, the estimated
        device bytes the step streams (params once per suffix token + the
        batch's live KV)."""
        if self.uses_paged_kv():
            self.last_copy_bytes = self.paged_copy_bytes_per_launch(
                bucket, batch, op_len)
        else:
            self.last_copy_bytes = self.gather_bytes_per_launch(bucket,
                                                                batch)
        if n_new == 0:
            s_alloc = self._s_alloc_for(bucket)
            kv_bytes = (float(kv_true[:batch].sum())
                        * self.slot_nbytes(bucket) / s_alloc)
            self.last_hbm_bytes = op_len * (self.params_nbytes() + kv_bytes)
        else:
            self.last_hbm_bytes = None

    # ------------------------------------------------------------ slot admin
    def cached_len(self, doc_id: int) -> int:
        """Padded cached-prefix length of ``doc_id`` (0 when uncached)."""
        bs = self._doc_slot.get(doc_id)
        if bs is None:
            return 0
        bucket, slot = bs
        return int(self._arenas[bucket].cached_len[slot])

    def true_cached_len(self, doc_id: int) -> int:
        """TRUE (unpadded) cached tokens of ``doc_id`` — what an eviction
        would actually lose (and re-bill as new tokens)."""
        bs = self._doc_slot.get(doc_id)
        if bs is None:
            return 0
        bucket, slot = bs
        return int(self._arenas[bucket].true_len[slot])

    def has_slot(self, doc_id: int) -> bool:
        return doc_id in self._doc_slot

    def live_slots(self) -> int:
        return len(self._doc_slot)

    def live_docs(self) -> List[int]:
        return list(self._doc_slot)

    def release(self, doc_id: int) -> None:
        """Free the document's slot (it exited the cascade or was evicted)."""
        bs = self._doc_slot.pop(doc_id, None)
        if bs is not None:
            bucket, slot = bs
            ar = self._arenas.get(bucket)
            if ar is not None and ar.sanitizer is not None:
                ar.sanitizer.note_release(bucket, slot)
            self._alloc.release(bucket, doc_id)

    # ------------------------------------------------------- memory control
    def arena_nbytes(self) -> int:
        """Total device bytes pinned by this backend's arenas."""
        return sum(ar.nbytes() for ar in self._arenas.values())

    def _kv_torch_dtype(self) -> Optional[torch.dtype]:
        return None if self.kv_dtype is None else DTYPES[self.kv_dtype]

    def slot_nbytes(self, bucket: int) -> int:
        """Device bytes one arena row of ``bucket`` pins, computed from
        state SHAPES at the STORED dtype (nothing is allocated), so the
        byte budget can project a bucket whose arena does not exist yet
        and the billing matches ``arena.nbytes()`` exactly."""
        n = self._slot_nbytes.get(bucket)
        if n is None:
            shapes = self.model.state_shapes(
                1, self._s_alloc_for(bucket), kv_dtype=self._kv_torch_dtype())
            n = sum(int(math.prod(shape)) * dt.itemsize
                    for layer in shapes for shape, dt in layer.values())
            self._slot_nbytes[bucket] = n
        return n

    def _initial_capacity(self, bucket: int) -> int:
        """Capacity a NEW arena for ``bucket`` opens with: ``init_slots``,
        shrunk to what the byte budget can host beside existing arenas
        (>= 1 — a single slot always proceeds, even over budget)."""
        cap = self.init_slots
        if self.byte_budget is not None:
            s = self.slot_nbytes(bucket)
            avail = (self.byte_budget - self.arena_nbytes()) // s - 1
            cap = min(cap, avail)
        return max(cap, 1)

    def projected_nbytes(self, bucket: int, need_new: int) -> int:
        """Arena bytes after ``bucket`` grows to host ``need_new`` more
        slots (free-list reuse, budget-capped initial capacity, and
        capacity doubling modelled exactly)."""
        total = self.arena_nbytes()
        free = self._alloc.high_water(bucket) - self._alloc.live(bucket)
        grow_to = self._alloc.high_water(bucket) + max(need_new - free, 0)
        ar = self._arenas.get(bucket)
        if ar is None:
            if need_new <= 0:
                return total
            rows_now, new_cap = 0, self._initial_capacity(bucket)
        else:
            rows_now, new_cap = ar.capacity + 1, ar.capacity
        while new_cap < grow_to:
            new_cap *= 2
        return total + ((new_cap + 1) - rows_now) * self.slot_nbytes(bucket)

    def over_budget(self, bucket: int, need_new: int) -> bool:
        """Would hosting ``need_new`` fresh slots in ``bucket`` bust either
        budget?  Slots and bytes are checked independently — eviction
        triggers on whichever binds first."""
        if (self.slot_budget is not None
                and self.live_slots() + need_new > self.slot_budget):
            return True
        if (self.byte_budget is not None
                and self.projected_nbytes(bucket, need_new) > self.byte_budget):
            return True
        return False

    def admissible_new(self, bucket: int, need: int) -> int:
        """Largest prefix of ``need`` fresh allocations both budgets can
        host (>= 1: a single document always proceeds, so launches cannot
        livelock under an impossibly small budget)."""
        k = need
        while k > 1 and self.over_budget(bucket, k):
            k -= 1
        return k

    def evict_for_room(self, bucket: int, need_new: int,
                       victims: Sequence[int]) -> List[int]:
        """Preempt slots until ``need_new`` allocations for ``bucket`` fit
        both budgets.

        ``victims`` is the caller's priority order, lowest first (the
        server passes fewest-cached-tokens-lost first, newest arrival
        breaking ties, and excludes the launch being packed).  Returns the
        evicted doc ids; the caller re-queues them with ``cached_len = 0``.
        Under byte pressure a bucket emptied by eviction is retired
        IMMEDIATELY (``pressure_retired`` counts them for stats) — slot
        recycling alone frees no bytes, dropping the arena does.  Stops
        early when the victim list runs out — the launch is then trimmed
        by the server rather than over-committing the arena.
        """
        evicted: List[int] = []
        if self.slot_budget is None and self.byte_budget is None:
            return evicted
        for d in victims:
            if not self.over_budget(bucket, need_new):
                break
            bs = self._doc_slot.get(d)
            if bs is None:
                continue
            vb = bs[0]
            slot_over = (self.slot_budget is not None
                         and self.live_slots() + need_new > self.slot_budget)
            if not slot_over:
                # byte pressure alone: a same-bucket victim only helps by
                # avoiding GROWTH (freed slots are recycled; releasing
                # them frees no bytes).  An arena already irreducibly
                # over budget must not thrash its residents' caches.
                grows = (self.projected_nbytes(bucket, need_new)
                         > self.arena_nbytes())
                if vb == bucket and not grows:
                    continue
            self.release(d)
            evicted.append(d)
            if (self.byte_budget is not None and vb != bucket
                    and vb in self._arenas and self._alloc.live(vb) == 0):
                self.retire(vb)
                self.pressure_retired += 1
        return evicted

    def note_launch(self) -> int:
        """Bucket retirement hook, called once per server step (on every
        backend, so one that stops receiving launches still ticks).

        A bucket whose live-slot count has been zero for ``retire_after``
        consecutive ticks has drifted out of the workload's length mix:
        its device arena is freed (``retire``).  Returns how many buckets
        were retired.
        """
        retired = 0
        for bucket in list(self._arenas):
            if self._alloc.live(bucket) == 0:
                self._idle[bucket] = self._idle.get(bucket, 0) + 1
                if self._idle[bucket] >= self.retire_after:
                    self.retire(bucket)
                    retired += 1
            else:
                self._idle[bucket] = 0
        return retired

    def retire(self, bucket: int) -> None:
        """Free an idle bucket's arena (no live slots)."""
        assert self._alloc.live(bucket) == 0, \
            f"bucket {bucket} retired with live slots"
        ar = self._arenas.pop(bucket, None)
        if ar is not None and ar.sanitizer is not None:
            ar.sanitizer.note_retire(bucket)
        self._alloc.retire_bucket(bucket)
        self._idle.pop(bucket, None)

    def _s_alloc_for(self, bucket: int) -> int:
        # the CUDA kernels mask ragged cache lengths themselves, so the row
        # needs no rounding to a kernel tile
        return bucket + self.op_reserve

    def _arena(self, bucket: int) -> BucketArena:
        ar = self._arenas.get(bucket)
        if ar is None:
            ar = BucketArena(self.model, bucket, self._s_alloc_for(bucket),
                             capacity=self._initial_capacity(bucket),
                             kv_dtype=self._kv_torch_dtype(),
                             device=self.device,
                             sanitizer=self.sanitizer())
            self._arenas[bucket] = ar
        return ar

    def _slot_for(self, bucket: int, doc_id: int, arena: BucketArena) -> int:
        prev = self._doc_slot.get(doc_id)
        assert prev is None or prev[0] == bucket, \
            f"doc {doc_id} already staged in bucket {prev[0]}, got {bucket}"
        slot = self._alloc.peek(bucket, doc_id)
        if slot < 0:
            slot = self._alloc.slot_of(bucket, doc_id)
            arena.ensure_capacity(self._alloc.high_water(bucket))
            arena.clear_slot(slot)
            if arena.sanitizer is not None:
                arena.sanitizer.note_alloc(bucket, slot, doc_id)
            self._doc_slot[doc_id] = (bucket, slot)
        return slot

    # --------------------------------------------------------------- compute
    def uses_paged_kv(self) -> bool:
        """Resolve the ``paged`` switch (None = auto): the paged stage step
        needs a paged-capable model and pays off where the kernels read
        slots in place, i.e. on CUDA."""
        if self.paged is None:
            self.paged = bool(self.device.type == "cuda"
                              and self.model.supports_paged_kv)
        if self.paged:
            assert self.model.supports_paged_kv, \
                "paged=True requires a model whose serve-state is all " \
                "full-attention KV caches (LM.supports_paged_kv)"
        return self.paged

    def _gather_step(self, arena_states, slots, new_tok, op_tok, kv_true,
                     ext_true, *, c_len: int, op_len: int):
        model, params = self.model, self.params
        st = model.take_states(arena_states, slots)
        if new_tok.shape[1] > 0:
            # prefill (c_len == 0) / fraction-extend into the arena;
            # ext_true = per-row REAL extent of cache + chunk, so
            # bucket-PAD keys are invisible inside the chunk too
            _, st = model.extend(params, {"tokens": new_tok}, st,
                                 q_offset=c_len, kv_len=ext_true)
            model.put_states(arena_states, slots, st)
        # operation suffix: masked decode steps over the gathered COPY
        # (kv_true = per-doc TRUE prefix length -> pad KV is invisible;
        # the doc snapshot in the arena survives untouched)
        logits = None
        B = slots.shape[0]
        for t in range(op_len):
            tok = op_tok[t].expand(B)
            logits, st = model.decode_step(params, tok, st, kv_true + t)
        return logits

    def _paged_step(self, arena_states, slots, new_tok, op_tok, kv_true,
                    ext_true, *, c_len: int, op_len: int):
        # PAGED data plane: the arena is never row-copied.  The extend
        # writes only the chunk's KV into the addressed rows and the
        # kernels read arena rows through slot ids.
        model, params = self.model, self.params
        if new_tok.shape[1] > 0:
            model.extend(params, {"tokens": new_tok}, arena_states,
                         q_offset=c_len, kv_len=ext_true, slots=slots)
        # operation suffix: masked decode steps run IN PLACE over the
        # arena.  The op tokens' KV lands at [kv_true, kv_true+op_len) of
        # each row — positions that may hold live document KV (the true
        # fraction can undershoot the padded cache) — so the window is
        # snapshotted first and restored after: an O(B * op_len) undo log
        # instead of an O(B * s_alloc) row copy, and the arena leaves the
        # step bitwise identical to the gather path's.
        logits = None
        B = slots.shape[0]
        saved = model.take_kv_window(arena_states, slots, kv_true, op_len)
        for t in range(op_len):
            tok = op_tok[t].expand(B)
            logits, _ = model.decode_step(params, tok, arena_states,
                                          kv_true + t, slots=slots)
        model.put_kv_window(arena_states, slots, kv_true, op_len, saved)
        return logits

    # ----------------------------------------------------- paged accounting
    def gather_bytes_per_launch(self, bucket: int, batch: int) -> int:
        """Device bytes the GATHER stage step copies per launch just to
        address the arena: ``take_states`` materializes a [batch, s_alloc]
        row copy of every state leaf (and extend scatters it back).
        Decode-only launches pay this too.  The paged step eliminates it."""
        return batch * self.slot_nbytes(bucket)

    def paged_copy_bytes_per_launch(self, bucket: int, batch: int,
                                    op_len: int) -> int:
        """Bytes the PAGED stage step copies per launch: the op-suffix
        undo log (save + restore of the ``op_len`` dirtied cache rows)."""
        s_alloc = self._s_alloc_for(bucket)
        row = self.slot_nbytes(bucket)
        return 2 * batch * op_len * (row // s_alloc)

    def class_confidences(self, logits: np.ndarray, n_classes: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Softmax over the class answer tokens -> (pred, conf)."""
        toks = [class_token(c) for c in range(n_classes)]
        cls_logits = np.asarray(logits, np.float64)[:, toks]
        z = cls_logits - cls_logits.max(axis=1, keepdims=True)
        probs = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
        return probs.argmax(axis=1), probs.max(axis=1)

    def run_stage(
        self,
        doc_ids: Sequence[int],
        doc_tokens: Mapping[int, np.ndarray],
        bucket: int,                             # padded full-doc length
        fraction: float,
        op_tokens: np.ndarray,
        n_classes: int,
    ) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """Run (op, fraction) over one bucket batch (stage-synchronous API).

        Documents may carry heterogeneous cached prefixes: the batch is
        split into per-``cached_len`` launches (each reusing its cache)
        rather than re-prefilling everyone.  Returns (pred [B], conf [B],
        new_tokens, cached_tokens) with TRUE (unpadded) token counts for $
        accounting.
        """
        B = len(doc_ids)
        f_len = fraction_len(bucket, fraction)
        pred = np.zeros(B, np.int64)
        conf = np.zeros(B, np.float64)
        pos_of = {d: i for i, d in enumerate(doc_ids)}
        new_true_total = 0
        cached_true_total = 0

        groups: Dict[int, List[int]] = {}
        for d in doc_ids:
            eff_c = min(self.cached_len(d), f_len)
            groups.setdefault(eff_c, []).append(d)

        for eff_c in sorted(groups):
            ids = groups[eff_c]
            p, c, new_d, cached_d = self.run_group(
                ids, doc_tokens, bucket, f_len, fraction, eff_c,
                op_tokens, n_classes, width=B)
            for j, d in enumerate(ids):
                pred[pos_of[d]] = p[j]
                conf[pos_of[d]] = c[j]
            new_true_total += int(new_d.sum())
            cached_true_total += int(cached_d.sum())
        return pred, conf, new_true_total, cached_true_total

    def run_group(self, ids, doc_tokens, bucket, f_len, fraction, eff_c,
                  op_tokens, n_classes, *, width: int,
                  op_id: Optional[str] = None):
        """One launch: all ``ids`` share ``eff_c``; synchronous
        composition ``complete_group(dispatch_group(...))``.

        Returns (pred [B], conf [B], new_tokens [B], cached_tokens [B])
        with PER-DOCUMENT true token counts."""
        return self.complete_group(self.dispatch_group(
            ids, doc_tokens, bucket, f_len, fraction, eff_c, op_tokens,
            n_classes, width=width, op_id=op_id))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def dispatch_group(self, ids, doc_tokens, bucket, f_len, fraction,
                       eff_c, op_tokens, n_classes, *, width: int,
                       op_id: Optional[str] = None) -> GroupTicket:
        """Non-blocking half of ``run_group``: pick slots, assemble the
        launch arrays, enqueue the stage step on the current stream
        (control returns while the device works), and hand back a
        ``GroupTicket`` whose sanitizer bracket stays OPEN until
        ``complete_group``.  Host bookkeeping that does not depend on
        device results — billing token counts, cached-length advances,
        structural traffic, slot-range validation — happens here.
        ``op_id`` is accepted for signature parity with prefix sharing.

        Every launch is padded to ``width`` rows (the server's batch
        size; scratch rows fill the rest), so every matrix product's
        shape is independent of how many documents share the launch.  On
        the card cuBLAS picks its algorithm by shape, so a fixed width
        keeps each document's numbers independent of its cohort: results
        are bitwise schedule-independent (inflight=K == inflight=1).
        """
        assert len(op_tokens) > 0, "operations must encode to >= 1 token"
        assert len(op_tokens) <= self.op_reserve, \
            f"operation longer than op_reserve ({len(op_tokens)})"
        t0 = time.perf_counter()
        arena = self._arena(bucket)
        slots = [self._slot_for(bucket, d, arena) for d in ids]
        B = len(ids)
        if B > width:
            raise ValueError(f"launch of {B} documents exceeds width {width}")
        Bp = width
        n_new = f_len - eff_c                     # 0 => decode-only launch
        op_len = len(op_tokens)

        slots_arr = np.full(Bp, arena.scratch_slot, np.int32)
        slots_arr[:B] = slots
        # validated once per launch on the host: the kernels read rows
        # without a per-layer device->host check
        _check_slots(slots_arr, arena.capacity + 1, "dispatch_group")
        new_tok = np.full((Bp, n_new), PAD, np.int32)
        kv_true = np.ones(Bp, np.int32)
        ext_true = np.ones(Bp, np.int32)
        new_d = np.zeros(B, np.int64)
        cached_d = np.zeros(B, np.int64)
        for i, d in enumerate(ids):
            toks = doc_tokens[d]
            slot = slots[i]
            if n_new > 0:
                seg = toks[min(eff_c, len(toks)): min(f_len, len(toks))]
                new_tok[i, : len(seg)] = seg
                new_d[i] = len(seg)
                cached_d[i] = min(eff_c, len(toks))
                ext_true[i] = min(eff_c, len(toks)) + len(seg)
            else:
                cached_d[i] = min(int(arena.true_len[slot]),
                                  self._true_len(toks, fraction))
            kv_true[i] = self._true_len(toks, fraction)
        t1 = time.perf_counter()
        self.host_overhead_s += t1 - t0

        step = self._paged_step if self.uses_paged_kv() else \
            self._gather_step
        t2 = time.perf_counter()
        san = arena.sanitizer
        ticket = None
        if san is not None:
            ticket = san.begin_launch(
                bucket, (self.name, "step", bucket, eff_c, f_len, B),
                reads=set(slots), writes=set(slots),
                scratch=arena.scratch_slot)
        try:
            with torch.no_grad():
                logits = step(
                    arena.states, self._to_device(slots_arr),
                    self._to_device(new_tok),
                    self._to_device(np.asarray(op_tokens, np.int32)),
                    self._to_device(kv_true), self._to_device(ext_true),
                    c_len=eff_c, op_len=op_len)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
        except BaseException:
            if san is not None:
                san.end_launch(ticket)
            raise
        t3 = time.perf_counter()
        self.host_overhead_s += t3 - t2    # async dispatch
        self._note_launch_traffic(bucket, B, op_len, n_new, kv_true)
        if n_new > 0:
            for i, d in enumerate(ids):
                slot = slots[i]
                arena.cached_len[slot] = f_len
                arena.true_len[slot] = min(f_len, len(doc_tokens[d]))
        return GroupTicket(
            ids=list(ids), bucket=bucket, width=Bp, n_classes=n_classes,
            logits=logits, event=event, new_d=new_d,
            cached_d=cached_d, op_len=op_len, san=san, san_ticket=ticket,
            timing={"host": t1 - t0, "dispatch": t3 - t2},
            ts_enqueue=t2, ts_dispatched=t3,
            copy_bytes=self.last_copy_bytes,
            hbm_bytes=self.last_hbm_bytes)

    def complete_group(self, ticket: GroupTicket):
        """Blocking half of ``run_group``: wait for the ticket's event,
        close its sanitizer bracket, and read out the routing
        confidences.  Later launches on the same stream were enqueued
        after the event, so the wait covers exactly this launch (arena
        writes included).  The bracket closes in ``finally`` so a device
        error surfacing at sync still releases the ticket's rows."""
        t0 = time.perf_counter()
        ticket.ts_sync = t0
        try:
            if ticket.event is not None:
                ticket.event.synchronize()
            B = len(ticket.ids)
            logits = ticket.logits[:B].cpu().numpy()
        finally:
            if ticket.san is not None:
                ticket.san.end_launch(ticket.san_ticket)
        t1 = time.perf_counter()
        ticket.ts_ready = t1
        ticket.timing["device"] = t1 - t0
        self.last_timing = dict(ticket.timing)
        pred, conf = self.class_confidences(logits, ticket.n_classes)
        return pred, conf, ticket.new_d + ticket.op_len, ticket.cached_d

    @staticmethod
    def _true_len(toks: np.ndarray, fraction: float) -> int:
        return max(int(math.ceil(len(toks) * fraction)), 1)


@dataclass
class EngineResult:
    pred: Dict[int, int]          # RESOLVED documents only
    conf: Dict[int, float]
    exit_stage: Dict[int, int]
    cost: float
    stats: ServeStats
    stage_cost: List[float] = field(default_factory=list)
    doc_cost: Dict[int, float] = field(default_factory=dict)   # all terminal
    status: Dict[int, str] = field(default_factory=dict)       # all terminal


# stage-table entry: (model, op_id, fraction, threshold_vector-or-None)
_StageEntry = Tuple[str, str, float, Optional[np.ndarray]]


@dataclass
class DocFuture:
    """Resolution handle for one submitted document.

    ``handle.submit`` returns one; it stays live until the server resolves
    the document (``done``), after which ``pred``/``conf``/``exit_stage``/
    ``cost`` are populated.  ``result()`` steps the server until this
    document resolves (other queries' work is served along the way — the
    future never bypasses the scheduler).

    ``done`` covers every TERMINAL state — ``status`` distinguishes
    ``RESOLVED`` from ``FAILED``/``TIMED_OUT`` (``error`` carries the
    diagnostic); ``pred``/``conf``/``exit_stage`` stay None for
    non-resolved terminals and ``result()`` raises for them.
    """

    query_id: int
    doc_id: int                       # the CALLER's id (ext_id)
    _req: DocRequest = field(repr=False)
    _server: "CascadeServer" = field(repr=False)

    @property
    def done(self) -> bool:
        return self._req.done

    @property
    def status(self) -> str:
        """Lifecycle state: pending / resolved / failed / timed_out."""
        return self._req.status

    @property
    def error(self) -> Optional[str]:
        """Diagnostic for FAILED/TIMED_OUT terminals (None otherwise)."""
        return self._req.error

    @property
    def pred(self) -> Optional[int]:
        return self._req.pred

    @property
    def conf(self) -> Optional[float]:
        return self._req.conf

    @property
    def exit_stage(self) -> Optional[int]:
        return self._req.exit_stage

    @property
    def cost(self) -> float:
        return self._req.cost

    @property
    def evictions(self) -> int:
        return self._req.evictions

    def result(self) -> Tuple[int, float, int]:
        """Block (stepping the server) until terminal: (pred, conf, stage).

        Raises ``RuntimeError`` when the document terminates FAILED or
        TIMED_OUT — a terminal state is always reached, never a hang.
        """
        while not self._req.done:
            assert self._server.pending(), \
                "server idle before this document resolved"
            if not self._server.step():
                self._server._idle_wait()
        if self._req.status != RESOLVED:
            raise RuntimeError(
                f"document {self.doc_id} (query {self.query_id}) "
                f"{self._req.status}: {self._req.error}")
        return self._req.pred, self._req.conf, self._req.exit_stage


@dataclass
class QueryHandle:
    """One registered query's view of a ``CascadeServer``.

    Returned by ``server.register(cascade, ...)``.  ``submit`` admits
    documents into the SHARED request queue (they may merge into launches
    with other queries' documents); ``poll``/``result``/``stats``/``cost``
    are partitioned to this query.  ``accuracy_target`` is the caller's
    declared accuracy floor (the alpha the cascade was assembled for) —
    recorded for admission/monitoring; the thresholds baked into the
    cascade are what enforce it.
    """

    query_id: int
    stages: List[_StageEntry] = field(repr=False)
    _server: "CascadeServer" = field(repr=False)
    accuracy_target: Optional[float] = None

    def stage_config(self, stage: int) -> StageConfig:
        model, op_id, fraction, _ = self.stages[stage]
        return model, op_id, fraction

    def submit(self, doc_id: int, text: str,
               arrival: Optional[float] = None, stage: int = 0,
               arrival_ts: Optional[float] = None,
               deadline_s: Optional[float] = None) -> DocFuture:
        """Admit a document into this query (streaming arrival).

        ``arrival`` is the scheduling priority — any comparable float
        (logical sequence numbers are fine); lower runs first, ACROSS
        queries.  ``arrival_ts`` is an absolute ``time.perf_counter()``
        timestamp anchoring the latency measurement — streaming drivers
        pass the SCHEDULED arrival so pre-submit queueing counts; it
        defaults to submit time.  ``arrival`` defaults to ``arrival_ts``
        so priority follows real arrival order when only timestamps are
        given.  ``stage`` lets pre-screened documents enter the cascade
        mid-way (clamped to the oracle).  Document ids are scoped to the
        query: two queries may both submit a document ``7``.

        ``deadline_s`` bounds the document's wall-clock from submit: past
        it the document resolves ``TIMED_OUT`` instead of launching
        again (retry backoff does not extend the deadline).  Raises
        ``ValueError`` for empty/whitespace-only text or a ``doc_id``
        already submitted to this query.
        """
        return self._server._submit(self, doc_id, text, arrival=arrival,
                                    stage=stage, arrival_ts=arrival_ts,
                                    deadline_s=deadline_s)

    def pending(self) -> int:
        """This query's documents admitted but not yet resolved."""
        return self._server.pending(self.query_id)

    def poll(self) -> Dict[int, Tuple[int, float, int]]:
        """This query's results resolved since the last poll:
        doc -> (pred, conf, exit_stage)."""
        return self._server._poll_query(self.query_id)

    def result(self) -> EngineResult:
        """Everything this query has resolved so far (per-query stats/$)."""
        return self._server.result(self.query_id)

    def drain(self) -> EngineResult:
        """Step the server until THIS query is idle (other queries' work
        is served along the way), then return its result."""
        while self.pending():
            if not self._server.step():
                self._server._idle_wait()
        return self.result()

    @property
    def stats(self) -> ServeStats:
        return self._server.stats(self.query_id)

    @property
    def cost(self) -> float:
        return self._server.cost(self.query_id)


@dataclass
class _Flight:
    """One dispatched-but-uncompleted launch in the server's ahead-of-time
    dispatch window.  ``group`` is the backend's ``GroupTicket`` (None
    only on the failed-dispatch record path); ``attempt`` pins the
    attempt index at dispatch time so timeline records stay dense even
    though ``_attempts`` advances past the flight before it completes."""

    launch: LaunchSpec
    be: Any
    group: Any
    attempt: int
    t_begin: float
    t_sched: float


@dataclass
class CascadeServer:
    """Long-lived multi-tenant executor of task cascades over shared
    backends.

    ``register`` / ``handle.submit`` / ``step`` / ``poll`` / ``drain`` is
    the serving API; the server owns the backends, their KV arenas, and
    one global request queue, and serves every registered query
    concurrently.  See the module docstring for the scheduling contract.
    """

    backends: Dict[str, Any]                # "proxy"/"oracle" -> backend
    operations: Dict[str, str]              # op id -> operation text
    n_classes: int
    batch_size: int = 8
    policy: Optional[SchedulingPolicy] = None   # None = oldest_head_first
    # ---- fault-tolerance knobs (see the module docstring's failure model)
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    breaker_threshold: int = 3       # consecutive failures to open a breaker
    breaker_cooldown: int = 8        # launch attempts a breaker stays open
    stall_limit: int = 256           # no-progress steps before stall error
    journal: Optional[RequestJournal] = None    # write-ahead request journal
    # Observability hub (serving/telemetry.py): metric registry + launch
    # timeline on by default ("counters"); per-doc span traces opt in via
    # level="trace".  Host-side only — the data plane stays bitwise
    # identical at every level.
    telemetry: Telemetry = field(default_factory=Telemetry, repr=False)
    idle_wait_cap: float = 0.25      # max seconds one _idle_wait sleeps
    # Overlapped ahead-of-time dispatch: keep up to ``inflight`` launches
    # enqueued on the device before blocking for the oldest one's routing
    # confidences.  1 (default) is bitwise the pre-overlap behavior; K>1
    # hides scheduler/host bookkeeping behind device compute.  Safe by
    # construction: in-flight documents are out of the ready queue (so
    # concurrent launches own disjoint arena rows) and every structural
    # path (eviction, reset) drains conflicting tickets first — with the
    # sanitizer's open brackets auditing exactly that.
    inflight: int = 1
    # Device every backend runs on: CUDA unless the caller asks for the
    # CPU ("cuda" raises when no GPU is present).
    device: Any = "cuda"
    _op_tok_cache: Dict[Tuple[str, str], np.ndarray] = field(
        default_factory=dict, repr=False)
    # ---- serving state (shared queue; per-query partitions keyed by qid)
    _handles: Dict[int, QueryHandle] = field(default_factory=dict, repr=False)
    _queue: RequestQueue = field(default_factory=RequestQueue, repr=False)
    _requests: Dict[int, DocRequest] = field(default_factory=dict, repr=False)
    _ids: Dict[Tuple[int, int], int] = field(default_factory=dict, repr=False)
    _tok: Dict[str, Dict[int, np.ndarray]] = field(
        default_factory=dict, repr=False)
    _query_stats: Dict[int, ServeStats] = field(
        default_factory=dict, repr=False)
    _departed: ServeStats = field(default_factory=ServeStats, repr=False)
    _query_cost: Dict[int, float] = field(default_factory=dict, repr=False)
    _fresh: Dict[int, List[int]] = field(default_factory=dict, repr=False)
    _pending: Dict[int, int] = field(default_factory=dict, repr=False)
    _launches: int = field(default=0, repr=False)
    _retired: int = field(default=0, repr=False)
    _flights: List[_Flight] = field(default_factory=list, repr=False)
    _max_inflight_seen: int = field(default=0, repr=False)
    _seq: int = field(default=0, repr=False)
    _next_qid: int = field(default=0, repr=False)
    # ---- fault-tolerance state
    _health: Dict[str, BackendHealth] = field(default_factory=dict,
                                              repr=False)
    _ledger: List[Tuple[int, int, int, float]] = field(
        default_factory=list, repr=False)   # (launch, qid, rid, cost)
    _attempts: int = field(default=0, repr=False)   # launches tried (+failed)
    _stalled_steps: int = field(default=0, repr=False)
    _breaker_trips: int = field(default=0, repr=False)
    _failed_launches: int = field(default=0, repr=False)
    # ---- shared-substrate memory counters (mirrored into query stats)
    _arena_bytes_peak: int = field(default=0, repr=False)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        for name, be in self.backends.items():
            if be.device != self.device:
                raise ValueError(f"backend {name!r} runs on {be.device}, "
                                 f"the server on {self.device}")
        if not self._tok:
            self._tok = {m: {} for m in self.backends}
        for be in self.backends.values():   # share the hub with backends
            be.telemetry = self.telemetry
            # sanitizer diagnostics name the owning query/document
            be.doc_info = self._doc_info

    def _doc_info(self, rid: int) -> Optional[Dict[str, Any]]:
        """Owner lookup for arena-sanitizer diagnostics: server request id
        -> the owning query and caller document ids (None if unknown)."""
        req = self._requests.get(rid)
        if req is None:
            return None
        return {"query": req.query_id, "doc": req.ext_id}

    def _op_tokens(self, backend, op_id: str) -> np.ndarray:
        key = (backend.name, op_id)
        toks = self._op_tok_cache.get(key)
        if toks is None:
            toks = np.asarray(
                backend.tokenizer.encode(self.operations[op_id]), np.int32)
            self._op_tok_cache[key] = toks
        return toks

    # ------------------------------------------------------------- lifecycle
    def reset(self) -> None:
        """Drop every query and in-flight request; reset backends/arenas.

        Compiled stage steps and op-token memos survive (they close over
        models and operation text only).
        """
        assert not self._flights, \
            "reset with launches in flight; drain them first"
        for be in self.backends.values():
            be.reset()
        self._queue.clear()
        self._handles.clear()
        self._requests.clear()
        self._ids.clear()
        self._tok = {m: {} for m in self.backends}
        self._query_stats.clear()
        self._departed = ServeStats()
        self._query_cost.clear()
        self._fresh.clear()
        self._pending.clear()
        self._launches = 0
        self._retired = 0
        self._max_inflight_seen = 0
        self._seq = 0
        self._next_qid = 0
        self._health.clear()
        self._ledger.clear()
        self._attempts = 0
        self._stalled_steps = 0
        self._breaker_trips = 0
        self._failed_launches = 0
        self._arena_bytes_peak = 0
        self.telemetry.clear()          # traces reference dropped requests
        if self.journal is not None:    # dropped queries: journal restarts
            self.journal = RequestJournal()

    def register(self, cascade: Cascade,
                 accuracy_target: Optional[float] = None,
                 oracle_model: str = "oracle",
                 oracle_op: str = "o_orig") -> QueryHandle:
        """Register a query (cascade) for serving; returns its handle.

        Backends and arenas are NOT reset — registration is cheap and
        concurrent queries share the serving substrate.  The oracle
        fall-through (``oracle_model``, ``oracle_op``, f=1, no
        thresholds) is appended so every submitted document resolves.
        """
        qid = self._next_qid
        self._next_qid += 1
        handle = QueryHandle(
            query_id=qid,
            stages=cascade.stage_entries(self.n_classes, oracle_model,
                                         oracle_op),
            _server=self, accuracy_target=accuracy_target)
        self._handles[qid] = handle
        self._query_stats[qid] = ServeStats()
        self._query_cost[qid] = 0.0
        self._fresh[qid] = []
        self._pending[qid] = 0
        if self.journal is not None:
            self.journal.record_register(qid)
        return handle

    def unregister(self, handle: QueryHandle) -> None:
        """Withdraw a query and free its bookkeeping (results included —
        read ``handle.result()`` first).  Asserts the query is idle:
        drain it before unregistering.  The query's contribution to the
        server-wide aggregate (``stats()``/``occupancy()``) is retained —
        launch history does not shrink when a tenant departs."""
        qid = handle.query_id
        assert self._pending.get(qid, 0) == 0, \
            "unregister with documents pending; drain the query first"
        gone = self._query_stats.get(qid)
        if gone is not None:
            self._merge_stats(self._departed, gone)
        self._handles.pop(qid, None)
        self._query_stats.pop(qid, None)
        self._query_cost.pop(qid, None)
        self._fresh.pop(qid, None)
        self._pending.pop(qid, None)
        for (q, d), rid in list(self._ids.items()):
            if q == qid:
                del self._ids[(q, d)]
                self._requests.pop(rid, None)
                for tok in self._tok.values():
                    tok.pop(rid, None)

    def _submit(self, handle: QueryHandle, doc_id: int, text: str,
                arrival: Optional[float] = None, stage: int = 0,
                arrival_ts: Optional[float] = None,
                deadline_s: Optional[float] = None) -> DocFuture:
        qid = handle.query_id
        assert self._handles.get(qid) is handle, \
            "handle is not registered with this server"
        if not isinstance(text, str) or not text.strip():
            raise ValueError(
                f"doc {doc_id!r} (query {qid}): document text is empty or "
                "whitespace-only")
        key = (qid, doc_id)
        if key in self._ids:
            raise ValueError(
                f"doc {doc_id!r} already submitted to query {qid} "
                "(doc ids must be unique within a query)")
        if arrival_ts is None:
            arrival_ts = time.perf_counter()
        if arrival is None:
            arrival = arrival_ts
        if self.journal is not None:    # write-ahead: journal BEFORE admit
            self.journal.record_submit(qid, doc_id, text, arrival, stage,
                                       deadline_s)
        rid = self._seq                   # server-global request id == seq
        self._seq += 1
        req = DocRequest(
            doc_id=rid, query_id=qid, ext_id=doc_id,
            stage=min(max(int(stage), 0), len(handle.stages) - 1),
            arrival=arrival, seq=rid, arrival_ts=arrival_ts)
        if deadline_s is not None:
            req.deadline = arrival_ts + deadline_s
        enc: Dict[int, np.ndarray] = {}     # backends often share a tokenizer
        for m, be in self.backends.items():
            ids = enc.get(id(be.tokenizer))
            if ids is None:
                ids = np.asarray(be.tokenizer.encode(text), np.int32)
                enc[id(be.tokenizer)] = ids
            self._tok[m][rid] = ids
            req.tok_len[m] = len(ids)
        self._requests[rid] = req
        self._ids[key] = rid
        self._pending[qid] += 1
        self._queue.push(req)
        tm = self.telemetry
        if tm.enabled:
            tm.count("serve_docs_submitted_total", 1, query=qid)
            if tm.tracing:
                tm.register_doc(rid, qid, doc_id)
                tm.event(rid, EV_SUBMIT, time.perf_counter(),
                         {"stage": req.stage})
        return DocFuture(query_id=qid, doc_id=doc_id, _req=req, _server=self)

    def pending(self, query_id: Optional[int] = None) -> int:
        """Documents admitted but not yet resolved (one query, or all).

        Counts documents riding in-flight launches too — drain loops
        must keep stepping until every open ticket has completed, not
        just until the ready queue empties."""
        if query_id is None:
            return (len(self._queue)
                    + sum(len(f.launch.doc_ids) for f in self._flights))
        return self._pending.get(query_id, 0)

    # ------------------------------------------------------------ scheduling
    def _stage_of(self, req: DocRequest) -> StageConfig:
        """Resolve a request's current stage through its owning query."""
        return self._handles[req.query_id].stage_config(req.stage)

    def _victim_order(self, be, protected: Set[int]) -> List[int]:
        """Eviction priority, lowest first: fewest-cached-tokens-lost,
        newest arrival breaking ties (two stable sorts, reversed-arrival
        first).  Documents riding open tickets are never victims — the
        dispatch loop drains conflicting flights before evicting, and
        this filter is the belt-and-braces guarantee the sanitizer's
        open brackets would otherwise turn into an ``ArenaRaceError``."""
        inflight = {d for f in self._flights for d in f.launch.doc_ids}
        victims = sorted(
            (d for d in be.live_docs()
             if d not in protected and d not in inflight),
            key=lambda d: self._requests[d].key(), reverse=True)
        victims.sort(key=be.true_cached_len)
        return victims

    def _make_room(self, be, launch: LaunchSpec) -> LaunchSpec:
        """Enforce the backend's slot/byte budgets for one launch.

        First preempts live slots outside the launch (fewest cached
        tokens lost first); if the budgets still cannot host every new
        allocation, the newest tail of the launch is deferred back to the
        queue (at least one document always proceeds).
        """
        if (getattr(be, "slot_budget", None) is None
                and getattr(be, "byte_budget", None) is None):
            return launch
        need = sum(1 for d in launch.doc_ids if not be.has_slot(d))
        if not be.over_budget(launch.bucket, need):
            return launch
        victims = self._victim_order(be, set(launch.doc_ids))
        # snapshot BEFORE eviction releases the slots: the true cached
        # tokens each victim loses is exactly what its next launch must
        # re-prefill (the capacity metric the benchmark gates on)
        lost = {d: be.true_cached_len(d) for d in victims}
        tm = self.telemetry
        for d in be.evict_for_room(launch.bucket, need, victims):
            req = self._requests[d]
            req.cached[be.name] = 0
            req.evictions += 1
            st = self._query_stats[req.query_id]
            st.evictions += 1
            st.re_prefill_tokens += lost[d]
            if tm.enabled:
                tm.count("serve_evictions_total", 1, backend=launch.model)
                if tm.tracing:
                    tm.event(d, EV_EVICT, time.perf_counter(),
                             {"backend": launch.model,
                              "lost_tokens": lost[d], "reason": "budget"})
        retired = getattr(be, "pressure_retired", 0)
        if retired:
            be.pressure_retired = 0
            self._note_retired(retired)
        room = be.admissible_new(launch.bucket, need)
        if need <= room:
            return launch
        # trim: keep the oldest prefix whose new allocations fit (>= 1 doc)
        keep_ids: List[int] = []
        keep_stages: List[int] = []
        used = 0
        for d, s in zip(launch.doc_ids, launch.stages):
            cost = 0 if be.has_slot(d) else 1
            if keep_ids and used + cost > room:
                self._queue.push(self._requests[d])  # defer to a later launch
                continue
            keep_ids.append(d)
            keep_stages.append(s)
            used += cost
        return LaunchSpec(
            model=launch.model, op_id=launch.op_id, fraction=launch.fraction,
            bucket=launch.bucket, cached_len=launch.cached_len,
            f_len=launch.f_len, doc_ids=tuple(keep_ids),
            stages=tuple(keep_stages))

    def _note_retired(self, n: int) -> None:
        # arenas are shared: retirement is a server-wide memory event,
        # mirrored into every query's stats (aggregate counts it once)
        self._retired += n
        for st in self._query_stats.values():
            st.retired_buckets += n

    def step(self) -> List[Tuple[int, int]]:
        """Fill the dispatch window, then complete the oldest launch.

        Ahead-of-time dispatch: up to ``inflight`` launches are enqueued
        non-blocking (``dispatch_group`` returns a ticket while the
        device works), then exactly one — the oldest — is completed,
        because the scheduler needs ITS confidences to route its
        documents' next stages.  At ``inflight=1`` this is bitwise the
        classic dispatch-then-block step.  Launches may mix documents
        from several registered queries (same static signature).
        Returns the ``(query_id, doc_id)`` pairs that reached a TERMINAL
        state this step (may be empty).  No-op when idle.  A failed
        launch never raises out of ``step``: its documents are
        re-enqueued solo with backoff (or finished FAILED/TIMED_OUT past
        their retry/deadline budgets) — see the module docstring's
        failure model.

        Telemetry: each launch's wall time decomposes into
        scheduler-pick / host / dispatch / device segments (host is the
        residual, so the four sum to the record's wall clock exactly);
        overlapped launches additionally stamp their in-flight window
        (``inflight_s``) — see ``serving/telemetry.py``.
        """
        t_begin = now = time.perf_counter()
        terminal: List[Tuple[int, int]] = []
        for req in self._queue.pop_expired(now):    # deadline beats backoff
            self._finish(req, TIMED_OUT, now, error="deadline exceeded")
            terminal.append((req.query_id, req.ext_id))
        self._reroute_sick()
        k = max(int(self.inflight), 1)
        dispatched = False
        while len(self._flights) < k:
            # the first pick reuses the step-entry stamp (inflight=1 parity:
            # sched_s measures queue grouping, not work done meanwhile)
            t_pick = time.perf_counter() if dispatched else t_begin
            launch = self._queue.next_launch(
                self._stage_of, self.batch_size, policy=self.policy,
                now=t_pick)
            t_sched = time.perf_counter()
            if launch is None:
                break
            be = self.backends[launch.model]
            if self._flights and self._room_needed(be, launch):
                # eviction releases rows open tickets may still read or
                # write: drain every in-flight launch before making room
                self._complete_flights(terminal)
            launch = self._make_room(be, launch)
            self._attempts += 1
            fl = _Flight(launch=launch, be=be, group=None,
                         attempt=self._attempts - 1, t_begin=t_pick,
                         t_sched=t_sched)
            try:
                fl.group = be.dispatch_group(
                    list(launch.doc_ids), self._tok[launch.model],
                    launch.bucket, launch.f_len, launch.fraction,
                    launch.cached_len, self._op_tokens(be, launch.op_id),
                    self.n_classes, width=self.batch_size,
                    op_id=launch.op_id)
            except Exception as exc:    # noqa: BLE001 — isolate the launch
                # fresh stamp: retry/terminal events must postdate any
                # fault events the injector recorded DURING the failed
                # launch (and the retry backoff anchors at the failure)
                self._on_launch_failure(launch, exc, time.perf_counter(),
                                        terminal)
                self._record_flight(fl, ok=False, error=str(exc))
                self._note_progress(True)
                return terminal
            self._flights.append(fl)
            dispatched = True
            self._max_inflight_seen = max(self._max_inflight_seen,
                                          len(self._flights))
        if self._flights:
            self._complete_one(terminal)
            self._note_progress(True)
        else:
            self._note_progress(bool(terminal) or dispatched)
        return terminal

    def _room_needed(self, be, launch: LaunchSpec) -> bool:
        """Whether ``_make_room`` would have to evict for this launch
        (same budget arithmetic, zero side effects) — the dispatch loop
        drains open tickets first when it would."""
        if (getattr(be, "slot_budget", None) is None
                and getattr(be, "byte_budget", None) is None):
            return False
        need = sum(1 for d in launch.doc_ids if not be.has_slot(d))
        return bool(be.over_budget(launch.bucket, need))

    def _complete_flights(self, terminal: List[Tuple[int, int]]) -> None:
        """Drain every in-flight launch (FIFO) ahead of a structural
        operation that could touch open tickets' rows (eviction)."""
        while self._flights:
            self._complete_one(terminal)

    def _complete_one(self, terminal: List[Tuple[int, int]]) -> None:
        """Complete the OLDEST in-flight launch and route its documents.

        FIFO completion keeps billing-ledger order a pure function of
        dispatch order.  Dispatch order itself may legally differ from
        ``inflight=1`` — the window fills with already-ready cohorts
        before a completion re-queues escalated documents — but every
        document still runs exactly its stage ladder, so per-document
        preds/confs/$ (and the arena state they leave behind) are
        bitwise schedule-independent."""
        tm = self.telemetry
        fl = self._flights.pop(0)
        launch, be = fl.launch, fl.be
        ids = list(launch.doc_ids)
        try:
            p, c, new_d, cached_d = be.complete_group(fl.group)
        except Exception as exc:        # noqa: BLE001 — isolate the launch
            # device errors surface at sync, so retry/terminal stamps
            # postdate the failure
            self._on_launch_failure(launch, exc, time.perf_counter(),
                                    terminal)
            self._record_flight(fl, ok=False, error=str(exc))
            return
        health = self._health.get(launch.model)
        if health is not None:
            health.record_success()
        now = time.perf_counter()
        if tm.tracing:
            sig = (launch.model, launch.op_id, launch.bucket,
                   launch.cached_len, launch.f_len)
            for i, rid in enumerate(ids):
                tm.event(rid, EV_LAUNCH, now,
                         {"sig": sig, "batch": len(ids),
                          "stage": self._requests[rid].stage,
                          "launch": self._launches})
        touched: Dict[int, None] = {}           # queries in this launch
        for i, rid in enumerate(ids):
            req = self._requests[rid]
            qid = req.query_id
            touched[qid] = None
            stats = self._query_stats[qid]
            thr = self._handles[qid].stages[req.stage][3]
            cost_d = (new_d[i] * be.rate_per_token
                      + cached_d[i] * be.rate_per_token * be.cached_discount)
            stats.record(req.stage, 1, int(new_d[i]), int(cached_d[i]),
                         cost_d)
            self._query_cost[qid] += cost_d
            req.cost += cost_d
            self._ledger.append((self._launches, qid, rid, float(cost_d)))
            req.cached[be.name] = be.cached_len(rid)
            if not np.isfinite(c[i]):
                self._quarantine(req, stats, now, terminal)
                continue
            if thr is None or c[i] >= thr[p[i]]:
                self._finish(req, RESOLVED, now, pred=int(p[i]),
                             conf=float(c[i]), exit_stage=req.stage)
                terminal.append((qid, req.ext_id))
            else:
                req.stage += 1
                req.solo = False        # rejoin cohort launches
                if tm.tracing:
                    tm.event(rid, EV_ESCALATE, now,
                             {"to": req.stage, "reason": "threshold"})
                self._queue.push(req)
        self._launches += 1
        if tm.enabled:
            tm.count("serve_tokens_total", int(new_d.sum()),
                     backend=launch.model, kind="new")
            tm.count("serve_tokens_total", int(cached_d.sum()),
                     backend=launch.model, kind="cached")
        self._sync_shared_counters()
        for qid in touched:       # a query's ``batches`` = launches it rode
            self._query_stats[qid].batches += 1
        # retirement ticks on EVERY backend: one that stops receiving
        # launches must still free arenas its drifted length mix pinned
        # (safe under open tickets: their live docs keep buckets unretired)
        retired = sum(b.note_launch() for b in self.backends.values()
                      if hasattr(b, "note_launch"))
        if retired:
            self._note_retired(retired)
        self._record_flight(fl, ok=True)

    def _record_flight(self, fl: _Flight, ok: bool,
                       error: Optional[str] = None) -> None:
        """Close out one launch's timeline record.  Dispatch and device
        segments come from the ticket's direct measurement around the
        stage step and its sync; scheduler-pick is the pre-launch
        boundary stamp; the host segment is the residual, so the four
        sum to the record's wall clock exactly.  Overlapped records also
        carry the dispatch-return -> sync-begin window (``inflight_s``)
        and their enqueue/ready stamps for the gap histogram."""
        tm = self.telemetry
        if not tm.enabled:
            return
        t_end = time.perf_counter()
        g = fl.group
        timing = (g.timing if g is not None else None) or {}
        dispatch = timing.get("dispatch", 0.0)
        device = timing.get("device", 0.0)
        launch = fl.launch
        batch = len(launch.doc_ids)
        wall = t_end - fl.t_begin
        sched = fl.t_sched - fl.t_begin
        host = max(wall - sched - dispatch - device, 0.0)
        rec = LaunchRecord(
            index=fl.attempt, ts_start=fl.t_begin, model=launch.model,
            op_id=launch.op_id, bucket=launch.bucket,
            cached_len=launch.cached_len, f_len=launch.f_len, batch=batch,
            width=g.width if g is not None else self.batch_size,
            sched_s=sched, host_s=host,
            dispatch_s=dispatch, device_s=device, wall_s=wall,
            copy_bytes=g.copy_bytes if (ok and g is not None) else 0,
            ok=ok, error=error,
            ts_enqueue=g.ts_enqueue if g is not None else 0.0,
            ts_ready=g.ts_ready if g is not None else 0.0,
            inflight_s=(max(g.ts_sync - g.ts_dispatched, 0.0)
                        if g is not None and g.ts_sync > 0.0 else 0.0))
        if ok and rec.decode_only:
            hbm = g.hbm_bytes if g is not None else None
            if hbm and device > 0.0:
                rec.hbm_bytes = hbm
                rec.bw_util = bandwidth_utilization(hbm, device)
        tm.record_launch(rec)
        tm.set_gauge("serve_queue_depth", len(self._queue))

    def _sync_shared_counters(self) -> None:
        """Refresh shared-substrate memory counters after a launch and
        mirror them into every query's stats (like breaker trips: the
        substrate is shared, so per-query stats report the server-wide
        values and the aggregate counts them once)."""
        tm = self.telemetry
        nbytes = 0
        for name, b in self.backends.items():
            if not hasattr(b, "arena_nbytes"):
                continue
            bn = b.arena_nbytes()
            nbytes += bn
            if tm.enabled:
                tm.set_gauge("serve_arena_bytes", bn, backend=name)
                tm.set_gauge("serve_arena_growths",
                             sum(ar.growths
                                 for ar in getattr(b, "_arenas", {}
                                                   ).values()),
                             backend=name)
        self._arena_bytes_peak = max(self._arena_bytes_peak, nbytes)
        if tm.enabled:
            tm.set_gauge("serve_arena_bytes_peak", self._arena_bytes_peak)
        # sanitizer check totals ride the PRIVATE per-sanitizer registries
        # (never the hub — its gated series must be sanitize-inert); the
        # stats mirror is how runs assert coverage (checks > 0)
        san_checks = sum(b._sanitizer.checks
                         for b in self.backends.values()
                         if getattr(b, "_sanitizer", None) is not None)
        for st in self._query_stats.values():
            st.arena_bytes_peak = self._arena_bytes_peak
            st.sanitizer_checks = san_checks

    # ------------------------------------------------------- fault handling
    def _finish(self, req: DocRequest, status: str, now: float,
                pred: Optional[int] = None, conf: Optional[float] = None,
                exit_stage: Optional[int] = None,
                error: Optional[str] = None) -> None:
        """Move one request to a terminal state (the ONLY exit path):
        bookkeeping, slot release, latency/fault counters, journal."""
        qid = req.query_id
        stats = self._query_stats[qid]
        req.done = True
        req.status = status
        req.error = error
        if status == RESOLVED:
            req.pred = pred
            req.conf = conf
            req.exit_stage = exit_stage
            stats.latencies.append(max(now - req.arrival_ts, 0.0))
        elif status == TIMED_OUT:
            stats.timeouts += 1
        elif status == FAILED:
            stats.failures += 1
        for b in self.backends.values():
            if hasattr(b, "release"):
                b.release(req.doc_id)
        for tok in self._tok.values():
            tok.pop(req.doc_id, None)
        self._fresh[qid].append(req.doc_id)
        self._pending[qid] -= 1
        if self.journal is not None:
            self.journal.record_resolution(req)
        tm = self.telemetry
        if tm.enabled:
            tm.count("serve_docs_terminal_total", 1, query=qid,
                     status=status)
            if status == RESOLVED:
                tm.observe("serve_doc_latency_seconds",
                           max(now - req.arrival_ts, 0.0), query=qid)
            if tm.tracing:       # terminal kinds == scheduler status strings
                attrs = ({"stage": exit_stage} if status == RESOLVED
                         else {"error": error})
                tm.event(req.doc_id, status, now, attrs)

    def _on_launch_failure(self, launch: LaunchSpec, exc: Exception,
                           now: float,
                           terminal: List[Tuple[int, int]]) -> None:
        """Launch-level isolation: the failed cohort's documents retry
        INDIVIDUALLY (solo singleton groups) with capped-exponential
        backoff; retry/deadline budgets exhausted -> FAILED/TIMED_OUT.
        Backends commit arena state only after a successful step, so
        there is no partial state to unwind.  Feeds the breaker."""
        self._failed_launches += 1
        tm = self.telemetry
        if tm.enabled:
            tm.count("serve_launch_failures_total", 1, backend=launch.model)
        health = self._health.get(launch.model)
        if health is None:
            health = BackendHealth(threshold=self.breaker_threshold,
                                   cooldown=self.breaker_cooldown)
            self._health[launch.model] = health
        if health.record_failure(self._attempts):
            self._breaker_trips += 1
            # breakers guard a SHARED backend: mirror the trip into every
            # query's stats (the aggregate counts it once)
            for st in self._query_stats.values():
                st.breaker_trips += 1
        for rid in launch.doc_ids:
            req = self._requests[rid]
            stats = self._query_stats[req.query_id]
            req.retries += 1
            stats.retries += 1
            if tm.enabled:
                tm.count("serve_retries_total", 1, query=req.query_id)
            if req.deadline is not None and req.deadline <= now:
                self._finish(req, TIMED_OUT, now, error="deadline exceeded")
                terminal.append((req.query_id, req.ext_id))
            elif req.retries > self.retry.max_retries:
                self._finish(
                    req, FAILED, now,
                    error=f"launch failed {req.retries}x (last: {exc})")
                terminal.append((req.query_id, req.ext_id))
            else:
                req.solo = True
                backoff = self.retry.backoff(req.retries)
                req.not_before = now + backoff
                self._queue.push(req)
                if tm.tracing:
                    tm.event(rid, EV_RETRY, now,
                             {"retries": req.retries, "backoff_s": backoff})

    def _quarantine(self, req: DocRequest, stats: ServeStats, now: float,
                    terminal: List[Tuple[int, int]]) -> None:
        """Non-finite confidence: the launch itself succeeded (and was
        billed), but this document's output is garbage.  First offense
        retries solo at the same stage; a repeat escalates straight to
        the final stage (graceful degradation — the oracle re-reads the
        document from scratch); non-finite at the FINAL stage fails."""
        stats.quarantines += 1
        req.quarantines += 1
        tm = self.telemetry
        if tm.enabled:
            tm.count("serve_quarantines_total", 1, query=req.query_id)
            if tm.tracing:
                tm.event(req.doc_id, EV_QUARANTINE, now,
                         {"count": req.quarantines})
        final = len(self._handles[req.query_id].stages) - 1
        if req.quarantines < 2:
            req.solo = True             # isolate the retry
            self._queue.push(req)
        elif req.stage < final:
            req.stage = final
            req.solo = True
            if tm.tracing:
                tm.event(req.doc_id, EV_ESCALATE, now,
                         {"to": final, "reason": "quarantine"})
            self._queue.push(req)
        else:
            self._finish(req, FAILED, now,
                         error="non-finite confidence at final stage")
            terminal.append((req.query_id, req.ext_id))

    def _reroute_sick(self) -> None:
        """Advance queued stages past backends whose breaker is open: the
        document runs its NEXT cascade stage instead (billed as that
        stage).  The final stage is never skipped — documents whose only
        remaining stage is sick wait out the cooldown (or their retry/
        deadline budget)."""
        if not self._health:
            return
        for req in self._queue.ready():
            handle = self._handles[req.query_id]
            final = len(handle.stages) - 1
            advanced = False
            while req.stage < final:
                h = self._health.get(handle.stages[req.stage][0])
                if h is None or not h.is_open(self._attempts):
                    break
                req.stage += 1
                advanced = True
            if advanced:
                if self.telemetry.tracing:
                    self.telemetry.event(
                        req.doc_id, EV_ESCALATE, time.perf_counter(),
                        {"to": req.stage, "reason": "breaker"})

    def _note_progress(self, progressed: bool) -> None:
        """Liveness watchdog: ``stall_limit`` consecutive no-progress
        steps with nothing legitimately waiting out a finite backoff
        raise ``ServerStalledError`` instead of spinning forever."""
        if progressed:
            self._stalled_steps = 0
            return
        wait = self._queue.next_eligible_in()
        if wait is None or (wait > 0 and math.isfinite(wait)):
            self._stalled_steps = 0     # idle, or a legitimate backoff wait
            return
        self._stalled_steps += 1
        if self._stalled_steps >= self.stall_limit:
            stuck = [(r.query_id, r.ext_id, r.stage, r.retries,
                      r.not_before) for r in self._queue.ready()]
            raise ServerStalledError(
                f"no progress in {self._stalled_steps} consecutive steps; "
                f"stuck requests (qid, doc, stage, retries, not_before): "
                f"{stuck}", stuck)

    def _idle_wait(self) -> None:
        """Sleep out the shortest pending retry backoff so drain loops do
        not busy-spin while every request is backing off.

        Sleeps the ACTUAL eligible interval (capped at ``idle_wait_cap``)
        instead of a fixed 50 ms slice — a 0.5 s backoff used to cost ten
        wakeups; now it costs at most ``ceil(0.5 / cap)``.  The measured
        sleep time accumulates into the launch timeline
        (``telemetry.idle_wait_s``) so drain-side idle waits are visible
        next to sched/host/dispatch/device in ``telemetry_snapshot()``."""
        wait = self._queue.next_eligible_in()
        if wait is not None and wait > 0 and math.isfinite(wait):
            t0 = time.perf_counter()
            time.sleep(min(wait, self.idle_wait_cap))
            self.telemetry.add_idle_wait(time.perf_counter() - t0)

    def ledger(self) -> List[Tuple[int, int, int, float]]:
        """Per-document billing ledger: ``(launch, query_id, request_id,
        cost)`` in billing order — replaying the entries per query with
        ``+=`` reproduces ``cost(qid)`` EXACTLY (same float additions in
        the same order).  Restored journal entries use launch == -1."""
        return list(self._ledger)

    # --------------------------------------------------------------- results
    def _poll_query(self, query_id: int) -> Dict[int, Tuple[int, float, int]]:
        out = {}
        for rid in self._fresh.get(query_id, []):
            req = self._requests[rid]
            out[req.ext_id] = (req.pred, req.conf, req.exit_stage)
        self._fresh[query_id] = []
        return out

    def poll(self) -> Dict[Tuple[int, int], Tuple[int, float, int]]:
        """Server-wide results resolved since the last poll:
        (query_id, doc_id) -> (pred, conf, exit_stage)."""
        out = {}
        for qid in list(self._fresh):
            for d, v in self._poll_query(qid).items():
                out[(qid, d)] = v
        return out

    def cost(self, query_id: int) -> float:
        """Accumulated $ of one query."""
        return self._query_cost[query_id]

    def stats(self, query_id: Optional[int] = None) -> ServeStats:
        """Per-query stats, or the server-wide aggregate (query_id=None).

        Aggregation counts each launch ONCE however many queries shared
        it (``batches`` = server launches), sums stage vectors by index,
        and concatenates latencies.  A query's own ``batches`` counts the
        launches that carried at least one of its documents, so per-query
        batches can sum to more than the aggregate — that overlap is the
        multi-tenant packing win.
        """
        if query_id is not None:
            return self._query_stats[query_id]
        agg = ServeStats()
        for st in [self._departed, *self._query_stats.values()]:
            self._merge_stats(agg, st)
        agg.batches = self._launches
        agg.retired_buckets = self._retired
        agg.breaker_trips = self._breaker_trips   # shared, counted once
        agg.arena_bytes_peak = self._arena_bytes_peak
        return agg

    @staticmethod
    def _merge_stats(dst: ServeStats, src: ServeStats) -> None:
        """Fold one query's stats into ``dst``.

        Delegates to ``ServeStats.merge_from``, which walks
        ``dataclasses.fields`` and applies each field's declared merge
        strategy — a new counter added to ``ServeStats`` is merged by
        default ("sum") instead of silently dropping here.  Launch and
        breaker counters are declared "shared" (launches and backends
        are shared across queries) and skipped; ``stats()`` overwrites
        them from server-global state."""
        dst.merge_from(src)

    def occupancy(self) -> float:
        """Mean documents per launch across every query the server has
        served — departed queries included (the packing metric: higher
        than any single query could reach alone means cross-query
        launches are being merged)."""
        docs = sum(sum(st.stage_docs)
                   for st in [self._departed, *self._query_stats.values()])
        return docs / self._launches if self._launches else 0.0

    def telemetry_snapshot(self) -> Dict[str, Any]:
        """Structured observability snapshot: the telemetry subsystem's
        counters + launch timeline (``Telemetry.snapshot``) plus a
        ``server`` section of scheduler-level state and — at
        ``level="trace"`` — a ``spans`` section from
        ``Telemetry.validate_spans`` (terminal events required only once
        the queue is idle; in-flight documents legitimately have open
        spans)."""
        snap = self.telemetry.snapshot()
        snap["server"] = {
            "launches": self._launches,
            "attempts": self._attempts,
            "failed_launches": self._failed_launches,
            "queue_depth": len(self._queue),
            "occupancy": self.occupancy(),
            # peak dispatch-window depth actually reached (the CI overlap
            # gate requires >= 2 on the --inflight legs)
            "max_inflight": self._max_inflight_seen,
        }
        if self.telemetry.tracing:
            snap["spans"] = self.telemetry.validate_spans(
                require_terminal=not self.pending())
        return snap

    def result(self, query_id: int) -> EngineResult:
        """One query's terminal documents (keyed by the caller's doc ids),
        with per-query cost/stats and deterministic per-document $.

        ``pred``/``conf``/``exit_stage`` cover RESOLVED documents;
        ``status``/``doc_cost`` cover every terminal state (FAILED and
        TIMED_OUT documents have billed partial work too)."""
        done = [r for r in self._requests.values()
                if r.done and r.query_id == query_id]
        ok = [r for r in done if r.status == RESOLVED]
        stats = self._query_stats[query_id]
        return EngineResult(
            pred={r.ext_id: r.pred for r in ok},
            conf={r.ext_id: r.conf for r in ok},
            exit_stage={r.ext_id: r.exit_stage for r in ok},
            cost=self._query_cost[query_id], stats=stats,
            stage_cost=list(stats.stage_cost),
            doc_cost={r.ext_id: r.cost for r in done},
            status={r.ext_id: r.status for r in done})

    def drain(self) -> Dict[int, EngineResult]:
        """Step until the shared queue is idle; per-query results.

        Terminal-state guarantee: every admitted document leaves the
        queue as RESOLVED, FAILED, or TIMED_OUT (the watchdog raises
        ``ServerStalledError`` rather than spinning), so ``drain``
        always returns."""
        while self.pending():
            if not self.step():
                self._idle_wait()
        return {qid: self.result(qid) for qid in self._handles}

    # -------------------------------------------------------- warm restart
    def recover(self, journal: RequestJournal
                ) -> Dict[Tuple[int, int], DocFuture]:
        """Warm-restart from a prior server's write-ahead journal.

        Call on a FRESH server after re-registering the same cascades in
        the same order (journal registration order maps onto this
        server's registration order).  Documents the journal shows
        resolved are restored verbatim — original pred/conf/status/$,
        no recompute, ``cost(qid)`` re-accumulated in journal order so
        accounting matches exactly.  Unresolved documents are
        re-submitted with identical external ids, arrivals, and deadline
        budgets (``recovered_docs`` counts them); step/drain as usual to
        finish them.  Returns ``(query_id, ext_id) -> DocFuture`` for
        every journaled document.
        """
        if len(journal.registrations) != len(self._handles):
            raise ValueError(
                f"journal has {len(journal.registrations)} registered "
                f"queries, this server has {len(self._handles)}; register "
                "the same cascades (in order) before recover()")
        qid_map = dict(zip(journal.registrations, sorted(self._handles)))
        futures: Dict[Tuple[int, int], DocFuture] = {}
        for sub in journal.submits:
            handle = self._handles[qid_map[sub["query_id"]]]
            res = journal.resolutions.get((sub["query_id"], sub["ext_id"]))
            if res is None:
                fut = handle.submit(
                    sub["ext_id"], sub["text"], arrival=sub["arrival"],
                    stage=sub["stage"], deadline_s=sub["deadline_s"])
                self._query_stats[handle.query_id].recovered_docs += 1
            else:
                fut = self._restore(handle, sub, res)
            futures[(handle.query_id, sub["ext_id"])] = fut
        return futures

    def _restore(self, handle: QueryHandle, sub: Dict[str, Any],
                 res: Dict[str, Any]) -> DocFuture:
        """Re-materialize one already-terminal journaled document:
        request record, result fields, $-accounting (ledger entry with
        launch == -1), and this server's own journal — no model work."""
        qid = handle.query_id
        rid = self._seq
        self._seq += 1
        req = DocRequest(
            doc_id=rid, query_id=qid, ext_id=sub["ext_id"], stage=0,
            arrival=sub["arrival"], seq=rid, arrival_ts=time.perf_counter())
        req.done = True
        req.status = res["status"]
        req.pred = res["pred"]
        req.conf = res["conf"]
        req.exit_stage = res["exit_stage"]
        req.cost = res["cost"]
        req.error = res["error"]
        self._requests[rid] = req
        self._ids[(qid, sub["ext_id"])] = rid
        self._query_cost[qid] += res["cost"]
        self._ledger.append((-1, qid, rid, res["cost"]))
        self._fresh[qid].append(rid)
        tm = self.telemetry
        tm.count("serve_docs_restored_total", 1, query=qid)
        if tm.tracing:
            # Restored documents get a degenerate span (submit + terminal
            # at the same stamp): span validation sees a complete span
            # without pretending to know the original timings.
            ts = req.arrival_ts
            tm.register_doc(rid, qid, sub["ext_id"])
            tm.event(rid, EV_SUBMIT, ts,
                     {"stage": sub["stage"], "restored": True})
            attrs = ({"stage": req.exit_stage} if req.status == RESOLVED
                     else {"error": req.error})
            attrs["restored"] = True
            tm.event(rid, req.status, ts, attrs)
        if self.journal is not None:
            self.journal.record_submit(
                qid, sub["ext_id"], sub["text"], sub["arrival"],
                sub["stage"], sub["deadline_s"])
            self.journal.record_resolution(req)
        return DocFuture(query_id=qid, doc_id=sub["ext_id"], _req=req,
                         _server=self)


@dataclass
class CascadeEngine(CascadeServer):
    """Single-query compatibility wrapper over ``CascadeServer``.

    ``start(cascade)`` resets the server session and registers exactly one
    query; ``submit/step/poll/drain/result`` operate on it with the
    pre-server signatures, and ``run()`` (submit everything + drain) is
    bit-identical — preds, confs, per-document $ — to the single-tenant
    engine on static corpora: one registered query produces exactly the
    same launch sequence through the shared queue.
    """

    _handle: Optional[QueryHandle] = field(default=None, repr=False)

    # single-query views used by tests/tools (the server partitions these)
    @property
    def _reqs(self) -> Dict[int, DocRequest]:
        qid = self._handle.query_id
        return {r.ext_id: r for r in self._requests.values()
                if r.query_id == qid}

    @property
    def _stats(self) -> ServeStats:
        return self._query_stats[self._handle.query_id]

    # ------------------------------------------------------------- lifecycle
    def start(self, cascade: Cascade, oracle_model: str = "oracle") -> None:
        """Begin a single-query serving session: reset backends, clear the
        queue, register the cascade."""
        self.reset()
        self._handle = self.register(cascade, oracle_model=oracle_model)

    def submit(self, doc_id: int, text: str,
               arrival: Optional[float] = None, stage: int = 0,
               arrival_ts: Optional[float] = None,
               deadline_s: Optional[float] = None) -> DocFuture:
        """Admit a document into the session (see ``QueryHandle.submit``)."""
        assert self._handle is not None, "call start(cascade) before submit()"
        return self._handle.submit(doc_id, text, arrival=arrival,
                                   stage=stage, arrival_ts=arrival_ts,
                                   deadline_s=deadline_s)

    def step(self) -> List[int]:
        """Dispatch one launch; returns the doc ids resolved by it."""
        assert self._handle is not None, "call start(cascade) before step()"
        return [d for _, d in super().step()]

    def poll(self) -> Dict[int, Tuple[int, float, int]]:
        """Results resolved since the last poll: doc -> (pred, conf, stage)."""
        return self._handle.poll()

    def result(self, query_id: Optional[int] = None) -> EngineResult:
        if query_id is None:
            query_id = self._handle.query_id
        return super().result(query_id)

    def drain(self) -> EngineResult:
        """Step until the queue is idle; result covers the whole session."""
        while self.pending():
            if not CascadeServer.step(self):
                self._idle_wait()
        return self.result()

    # -------------------------------------------------------- batch wrapper
    def run(self, cascade: Cascade, docs: Mapping[int, str],
            oracle_model: str = "oracle",
            enter_stage: Optional[Mapping[int, int]] = None) -> EngineResult:
        """docs: doc_id -> (already reordered) document text.

        Thin batch wrapper over the request loop: submit every document,
        drain the queue.  ``enter_stage`` (doc_id -> stage index) admits
        documents mid-cascade; stage indices are clamped to the oracle
        stage, so every admitted document resolves.
        """
        requested = dict(enter_stage or {})
        for d in requested:
            if d not in docs:
                raise KeyError(f"enter_stage doc {d!r} not in docs")
        self.start(cascade, oracle_model)
        for d, text in docs.items():
            self.submit(d, text, stage=requested.get(d, 0))
        return self.drain()
