"""Serving scheduler: request lifecycle, the cross-stage ready queue,
bucketed batching, slot allocation, batch packing.

TPU serving wants a small set of compiled shapes.  Documents are grouped
into power-of-two *length buckets*; within a bucket each document owns a
**slot** in a persistent KV arena for its lifetime (``SlotAllocator``), so
survivor compaction between launches is an index gather, not a pytree
rebuild.

Continuous batching rides on two pieces here:

``DocRequest``
    per-document lifecycle state — owning query, stage cursor, arrival
    time, per-backend cached/tokenized lengths, resolution status,
    eviction count, accumulated $ cost.  The server owns one per
    submitted document from ``submit()`` to resolution.  ``query_id``
    names the registered query whose stage table the cursor walks;
    ``ext_id`` is the caller's document id (``doc_id`` is the
    server-global request id used as the slot/token key, so documents
    from different queries never collide).

``RequestQueue``
    the global ready queue, shared by every registered query.
    ``next_launch`` packs the *entire* ready set — every stage of every
    query at once — into static-signature launches keyed by ``(backend,
    bucket, cached_len, op, f_len)``.  The signature carries neither a
    stage index nor a query id, so a stage-0 prefill for one query and a
    stage-2 decode for another merge into ONE launch whenever their
    static shapes agree (cross-query packing), and mixed-query launches
    reuse the same compiled steps.  Which ready group dispatches next is
    a pluggable ``policy``: the default ``oldest_head_first`` pops the
    group whose head document is oldest (FIFO head-of-line — admission
    is fair across queries because ``(arrival, seq)`` is server-global),
    while ``largest_ready_group`` trades per-document latency for batch
    occupancy under overload.

Failure model (fault-tolerant serving plane)
--------------------------------------------
A request is no longer guaranteed to resolve: it reaches exactly one of
three TERMINAL states — ``RESOLVED`` (a stage cleared its threshold or
the oracle fall-through ran), ``FAILED`` (a launch kept failing past
``RetryPolicy.max_retries``, or confidences stayed non-finite at the
final stage), or ``TIMED_OUT`` (its deadline elapsed before
resolution).  The scheduler's half of that contract:

  * ``RetryPolicy`` — capped exponential backoff for failed launches;
    a retried request carries ``not_before`` (the earliest wall-clock
    instant it may launch again) and ``next_launch(now=...)`` treats
    requests still in backoff as invisible;
  * launch-level isolation — a request re-enqueued after a failure or a
    non-finite-confidence quarantine is marked ``solo`` and forms a
    SINGLETON launch group, so one poisoned document in a packed
    cross-query launch can never fail its (healthy) cohort twice;
  * per-request ``deadline`` (absolute ``time.perf_counter`` instant) —
    ``pop_expired(now)`` sweeps expired requests out of the ready set
    before packing, and the server resolves them ``TIMED_OUT``;
  * ``next_eligible_in(now)`` — how long until the earliest backoff
    expires, so ``drain()`` can sleep instead of spinning (and the
    engine's no-progress watchdog can tell backoff from a true stall).

``pack_stage_batches`` (the PR-1 stage-synchronous packer) is retained for
per-stage scoring paths; it emits ``StageBatch`` launches grouped by
``(bucket, cached_len)`` within one stage.  Documents whose cached prefix
already covers the requested fraction share a single decode-only launch
per bucket (the per-document valid length rides in ``kv_len``, which is
dynamic).

A straggler policy can migrate queued work between serving shards
(distributed.fault.StragglerPolicy).
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)

# Request lifecycle states.  PENDING is the only non-terminal state; every
# submitted document must end in exactly one of the other three (the chaos
# benchmark's all-docs-terminal invariant).
PENDING = "pending"
RESOLVED = "resolved"
FAILED = "failed"
TIMED_OUT = "timed_out"
TERMINAL_STATES = (RESOLVED, FAILED, TIMED_OUT)


@dataclass(frozen=True)
class RetryPolicy:
    """Retry budget + capped exponential backoff for failed launches.

    A launch failure (raised exception — injected or real) re-enqueues
    each member document individually; the document's ``retries`` counter
    increments and its next launch is delayed by ``backoff(retries)``
    seconds: ``backoff_base * 2**(retries - 1)`` capped at
    ``backoff_cap``.  A document whose ``retries`` exceeds
    ``max_retries`` resolves terminally as ``FAILED`` instead of
    retrying forever.  ``backoff_base = 0`` disables the delay (retries
    become immediately eligible) — deterministic chaos tests use that.
    """

    max_retries: int = 3
    backoff_base: float = 0.05
    backoff_cap: float = 1.0

    def backoff(self, retries: int) -> float:
        if self.backoff_base <= 0.0:
            return 0.0
        return min(self.backoff_base * (2.0 ** max(retries - 1, 0)),
                   self.backoff_cap)


def bucket_len(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class Bucket:
    seq_len: int
    doc_ids: List[int] = field(default_factory=list)


def make_buckets(doc_ids: Iterable[int], lengths: Dict[int, int],
                 batch_size: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS
                 ) -> List[Tuple[int, List[int]]]:
    """Group docs by length bucket, then split into <= batch_size batches.

    Returns [(bucket_seq_len, [doc_id, ...]), ...]; batches are full except
    possibly the last per bucket (compaction).
    """
    by_bucket: Dict[int, List[int]] = {}
    for d in doc_ids:
        by_bucket.setdefault(bucket_len(lengths[d], buckets), []).append(d)
    out = []
    for blen in sorted(by_bucket):
        ids = by_bucket[blen]
        for i in range(0, len(ids), batch_size):
            out.append((blen, ids[i: i + batch_size]))
    return out


# ---------------------------------------------------------------------------
# Request lifecycle (continuous batching)
# ---------------------------------------------------------------------------

@dataclass
class DocRequest:
    """Per-document lifecycle state for the continuous-batching loop.

    A request is created by a query handle's ``submit`` and lives until
    the document resolves (``done``).  ``query_id`` names the registered
    query whose stage table ``stage`` indexes (len(tasks) == the oracle
    fall-through); ``ext_id`` is the caller's document id while
    ``doc_id`` is the server-global request id used as the slot/token
    key — two queries may both submit a document "7" without colliding.
    ``cached`` mirrors each backend's padded cached-prefix length so the
    scheduler can compute launch signatures without touching arenas.
    Eviction resets the victim backend's entry to 0 — the document re-
    enters the queue at its current stage and re-prefills as new tokens.
    ``cost`` accumulates this document's own $ across its launches
    (deterministic per-doc accounting regardless of launch composition).

    Fault-tolerance state: ``status`` moves PENDING -> exactly one of
    ``RESOLVED``/``FAILED``/``TIMED_OUT`` (``done`` mirrors terminality);
    ``retries``/``quarantines`` count failed launches and non-finite
    confidence events; ``not_before`` is the backoff gate (the request is
    invisible to ``next_launch`` until then); ``deadline`` is an absolute
    ``perf_counter`` instant after which the request times out; ``solo``
    marks a retried/quarantined request that must launch alone
    (launch-level isolation); ``error`` carries the last failure message
    for terminal diagnostics.
    """

    doc_id: int
    stage: int = 0                    # stage cursor
    arrival: float = 0.0              # arrival order (scheduling priority)
    seq: int = 0                      # admission order (tie-break)
    arrival_ts: float = 0.0           # perf_counter latency anchor
    tok_len: Dict[str, int] = field(default_factory=dict)   # backend -> len
    cached: Dict[str, int] = field(default_factory=dict)    # backend -> pad len
    query_id: int = 0                 # owning registered query
    ext_id: Optional[int] = None      # caller's doc id (defaults to doc_id)
    cost: float = 0.0                 # accumulated per-document $
    pred: Optional[int] = None
    conf: Optional[float] = None
    exit_stage: Optional[int] = None
    evictions: int = 0
    done: bool = False
    # --- fault-tolerance lifecycle
    status: str = PENDING
    retries: int = 0                  # failed launches survived
    quarantines: int = 0              # non-finite confidence events
    not_before: float = 0.0           # backoff gate (perf_counter instant)
    deadline: Optional[float] = None  # absolute timeout (perf_counter)
    solo: bool = False                # launch alone (failure isolation)
    error: Optional[str] = None       # last failure diagnostic

    def __post_init__(self) -> None:
        if self.ext_id is None:
            self.ext_id = self.doc_id

    def key(self) -> Tuple[float, int]:
        return (self.arrival, self.seq)


@dataclass(frozen=True)
class LaunchSpec:
    """One dispatch of the request loop: all docs share the static step
    signature ``(model, op_id, bucket, cached_len, f_len)`` regardless of
    which cascade stage each is at (``stages`` is per-doc bookkeeping for
    thresholds/accounting, not part of the compiled shape)."""

    model: str
    op_id: str
    fraction: float
    bucket: int
    cached_len: int                   # static q_offset (== f_len: decode-only)
    f_len: int
    doc_ids: Tuple[int, ...]
    stages: Tuple[int, ...]


# (model, op_id, fraction) of a request's current stage
StageConfig = Tuple[str, str, float]
# static launch signature: (model, op_id, fraction, bucket, cached, f_len,
# isolation key).  The last element is -1 for normal requests; a ``solo``
# request contributes its own doc_id, so it always forms a singleton group
# (launch-level failure isolation).
SignatureKey = Tuple[str, str, float, int, int, int, int]
# scheduling policy: pick which ready group dispatches next
SchedulingPolicy = Callable[
    [Mapping[SignatureKey, List[DocRequest]],
     Mapping[SignatureKey, Tuple[float, int]]], SignatureKey]


def oldest_head_first(
    groups: Mapping[SignatureKey, List[DocRequest]],
    heads: Mapping[SignatureKey, Tuple[float, int]],
) -> SignatureKey:
    """Default policy: the group whose head (oldest) request has the
    smallest ``(arrival, seq)`` — head-of-line FIFO.  Veterans deep in
    the cascade are never starved by a stream of new arrivals, and
    because ``(arrival, seq)`` is server-global, admission stays fair
    across registered queries."""
    return min(heads, key=heads.get)


def largest_ready_group(
    groups: Mapping[SignatureKey, List[DocRequest]],
    heads: Mapping[SignatureKey, Tuple[float, int]],
) -> SignatureKey:
    """Throughput policy: the group with the most ready documents (oldest
    head breaks ties).  Under sustained overload this keeps launches full
    — trading head-of-line latency (p50) for batch occupancy."""
    return min(groups, key=lambda k: (-len(groups[k]), heads[k]))


class RequestQueue:
    """Global cross-stage, cross-query ready queue for the
    continuous-batching loop.

    Holds every unresolved, not-in-flight ``DocRequest`` across ALL
    registered queries.  ``next_launch`` groups the whole ready set by
    static signature and pops up to ``batch_size`` documents from the
    group a ``policy`` selects (default: ``oldest_head_first``).  The
    signature carries neither stage index nor query id, so requests from
    different queries (and different stages) merge into one launch
    whenever their compiled shapes agree.
    """

    def __init__(self) -> None:
        self._ready: Dict[int, DocRequest] = {}        # doc_id -> request

    def __len__(self) -> int:
        return len(self._ready)

    def __contains__(self, doc_id: int) -> bool:
        return doc_id in self._ready

    def push(self, req: DocRequest) -> None:
        """Admit a request (also how deferred/surviving requests return)."""
        self._ready[req.doc_id] = req

    def clear(self) -> None:
        self._ready.clear()

    def ready(self) -> List[DocRequest]:
        """Snapshot of every queued request (backoff included)."""
        return list(self._ready.values())

    def pop_expired(self, now: float) -> List[DocRequest]:
        """Remove and return requests whose deadline has elapsed.

        Deadline beats backoff: a request sitting out a retry delay still
        times out on schedule.  The caller resolves the returned requests
        as ``TIMED_OUT``.
        """
        out = [r for r in self._ready.values()
               if r.deadline is not None and r.deadline <= now]
        for r in out:
            del self._ready[r.doc_id]
        return out

    def next_eligible_in(self, now: Optional[float] = None
                         ) -> Optional[float]:
        """Seconds until the earliest queued request leaves backoff.

        ``<= 0`` means work is dispatchable right now; ``None`` means the
        queue is empty; ``inf`` means every queued request is gated
        forever (a stall, not a wait — the engine watchdog treats it so).
        """
        if not self._ready:
            return None
        if now is None:
            now = time.perf_counter()
        return min(r.not_before for r in self._ready.values()) - now

    def next_launch(
        self,
        stage_config: Callable[[DocRequest], StageConfig],
        batch_size: int,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        policy: Optional[SchedulingPolicy] = None,
        now: Optional[float] = None,
        blocked: Optional[Callable[[SignatureKey], bool]] = None,
    ) -> Optional[LaunchSpec]:
        """Pop the next launch, or None when nothing is dispatchable.

        ``stage_config(req) -> (model, op_id, fraction)`` resolves a
        request's CURRENT stage through its owning query (the oracle
        fall-through included) — multi-tenant serving passes a resolver
        that dispatches on ``req.query_id``, so two queries whose stages
        share a static signature land in the same group.  ``policy``
        picks which ready group dispatches (None = ``oldest_head_first``;
        ``largest_ready_group`` favours occupancy under overload).

        Requests still in retry backoff (``not_before > now``) are
        invisible this call; ``solo`` requests form singleton groups so a
        poisoned document retries alone (see the module docstring's
        failure model).  ``now`` defaults to ``time.perf_counter()``.

        ``blocked(key) -> bool`` vetoes whole signature groups before the
        policy picks one: overlapped ahead-of-time dispatch passes the
        server's conflict check so no launch is co-scheduled onto arena
        rows an open ticket still owns (documents in flight are already
        out of the ready set — this guards the SHARED rows, e.g. a
        first-touch prefix-row prefill against open readers).  Vetoed
        groups stay queued and become visible again once the conflicting
        tickets complete.
        """
        if not self._ready:
            return None
        if now is None:
            now = time.perf_counter()
        # one O(N) pass: bin by signature, tracking each group's head so
        # only the SELECTED group is sorted (not every group every step)
        groups: Dict[SignatureKey, List[DocRequest]] = {}
        heads: Dict[SignatureKey, Tuple[float, int]] = {}
        for req in self._ready.values():
            if req.not_before > now:          # still backing off
                continue
            model, op_id, fraction = stage_config(req)
            blen = bucket_len(req.tok_len[model], buckets)
            f_len = fraction_len(blen, fraction)
            eff_c = min(req.cached.get(model, 0), f_len)
            key = (model, op_id, fraction, blen, eff_c, f_len,
                   req.doc_id if req.solo else -1)
            groups.setdefault(key, []).append(req)
            if key not in heads or req.key() < heads[key]:
                heads[key] = req.key()
        if blocked is not None and groups:
            groups = {k: v for k, v in groups.items() if not blocked(k)}
            heads = {k: heads[k] for k in groups}
        if not groups:
            return None
        best_key = (policy or oldest_head_first)(groups, heads)
        model, op_id, fraction, blen, eff_c, f_len = best_key[:6]
        take = sorted(groups[best_key], key=DocRequest.key)[:batch_size]
        for req in take:
            del self._ready[req.doc_id]
        return LaunchSpec(
            model=model, op_id=op_id, fraction=fraction, bucket=blen,
            cached_len=eff_c, f_len=f_len,
            doc_ids=tuple(r.doc_id for r in take),
            stages=tuple(r.stage for r in take))


# ---------------------------------------------------------------------------
# Slot allocation (document -> arena slot, per bucket)
# ---------------------------------------------------------------------------

class SlotAllocator:
    """Assigns each document a per-bucket arena slot for its lifetime.

    Slots freed by resolved documents are recycled before the high-water
    mark grows, so a streaming workload's arena footprint tracks the live
    set, not the corpus.
    """

    def __init__(self) -> None:
        self._slot: Dict[int, Dict[int, int]] = {}     # bucket -> doc -> slot
        self._free: Dict[int, List[int]] = {}          # bucket -> free slots
        self._high: Dict[int, int] = {}                # bucket -> high water

    def slot_of(self, bucket: int, doc: int) -> int:
        """Slot of ``doc`` (allocating one on first touch)."""
        slots = self._slot.setdefault(bucket, {})
        if doc in slots:
            return slots[doc]
        free = self._free.setdefault(bucket, [])
        if free:
            s = free.pop()
        else:
            s = self._high.get(bucket, 0)
            self._high[bucket] = s + 1
        slots[doc] = s
        return s

    def peek(self, bucket: int, doc: int) -> int:
        """Slot of ``doc`` or -1 without allocating."""
        return self._slot.get(bucket, {}).get(doc, -1)

    def release(self, bucket: int, doc: int) -> None:
        slots = self._slot.get(bucket, {})
        s = slots.pop(doc, None)
        if s is not None:
            self._free.setdefault(bucket, []).append(s)

    def high_water(self, bucket: int) -> int:
        return self._high.get(bucket, 0)

    def live(self, bucket: int) -> int:
        return len(self._slot.get(bucket, {}))

    def live_total(self) -> int:
        return sum(len(s) for s in self._slot.values())

    def retire_bucket(self, bucket: int) -> None:
        """Drop all allocation state for an idle bucket (arena retired)."""
        assert not self._slot.get(bucket), \
            f"bucket {bucket} retired with live slots"
        self._slot.pop(bucket, None)
        self._free.pop(bucket, None)
        self._high.pop(bucket, None)

    def reset(self) -> None:
        self._slot.clear()
        self._free.clear()
        self._high.clear()


# ---------------------------------------------------------------------------
# Stage batch packing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StageBatch:
    """One launch: all docs share ``bucket`` and the static ``cached_len``.

    ``cached_len == f_len`` (the fraction slice for this bucket) marks a
    decode-only launch: every doc's cache already covers the fraction and
    only the operation suffix runs (per-doc valid lengths are dynamic).
    """
    bucket: int
    cached_len: int            # static q_offset of the extension (== f_len
                               # for decode-only launches)
    doc_ids: Tuple[int, ...]


def fraction_len(bucket: int, fraction: float) -> int:
    return max(int(math.ceil(bucket * fraction)), 1)


def pack_stage_batches(
    doc_ids: Iterable[int],
    lengths: Mapping[int, int],
    cached_len: Mapping[int, int],
    fraction: float,
    batch_size: int,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
) -> List[StageBatch]:
    """Pack one stage's documents into static-signature launches.

    Groups by (bucket, effective cached length) where the effective length
    clamps to the stage's fraction slice — caches that already cover the
    fraction collapse into one decode-only group per bucket.  Within a
    group, batches fill to ``batch_size`` (survivor compaction).
    """
    groups: Dict[Tuple[int, int], List[int]] = {}
    for d in doc_ids:
        blen = bucket_len(lengths[d], buckets)
        f_len = fraction_len(blen, fraction)
        eff_c = min(cached_len.get(d, 0), f_len)
        groups.setdefault((blen, eff_c), []).append(d)
    out = []
    for (blen, eff_c) in sorted(groups):
        ids = groups[(blen, eff_c)]
        for i in range(0, len(ids), batch_size):
            out.append(StageBatch(blen, eff_c,
                                  tuple(ids[i: i + batch_size])))
    return out


# ---------------------------------------------------------------------------
# Serving statistics ($-aware)
# ---------------------------------------------------------------------------

# ServeStats aggregation strategies, declared per-field via dataclass
# metadata so ``merge_from`` can iterate ``dataclasses.fields`` instead of
# a hand-maintained list (a new counter defaults to "sum" and can never
# silently drop out of ``server.stats()`` aggregation):
#   sum     additive per-query counter
#   max     high-water mark
#   concat  per-document sample list
#   stage   per-stage vectors, folded jointly through ``record``
#   shared  mirror of a server-wide substrate counter (launches, breaker
#           trips, retired buckets, prefix memo hits): summing would
#           double-count, so merge skips it and the server's aggregate
#           overwrites it from its own global state
MERGE_STRATEGIES = ("sum", "max", "concat", "stage", "shared")


def _stat(merge: str, **kw: Any) -> Any:
    assert merge in MERGE_STRATEGIES
    return field(metadata={"merge": merge}, **kw)


@dataclass
class ServeStats:
    stage_docs: List[int] = _stat("stage", default_factory=list)
    stage_new_tokens: List[int] = _stat("stage", default_factory=list)
    stage_cached_tokens: List[int] = _stat("stage", default_factory=list)
    stage_cost: List[float] = _stat("stage", default_factory=list)
    batches: int = _stat("shared", default=0)   # launches this query rode
    evictions: int = _stat("sum", default=0)    # slots preempted under budget
    retired_buckets: int = _stat("shared", default=0)  # idle arenas freed
    latencies: List[float] = _stat("concat",
                                   default_factory=list)  # submit->resolve s
    # fault-tolerance counters (see the module docstring's failure model)
    retries: int = _stat("sum", default=0)      # re-enqueues after failures
    quarantines: int = _stat("sum", default=0)  # non-finite confs caught
    timeouts: int = _stat("sum", default=0)     # docs resolved TIMED_OUT
    failures: int = _stat("sum", default=0)     # docs resolved FAILED
    breaker_trips: int = _stat("shared", default=0)  # circuit-breaker opens
    recovered_docs: int = _stat("sum", default=0)    # arena-loss replays +
    #                                                  journal resubmits
    # memory/prefix-sharing counters (PR-7 capacity accounting)
    arena_bytes_peak: int = _stat("max", default=0)  # max arena device bytes
    re_prefill_tokens: int = _stat("sum", default=0)  # true cached tokens
    #                                    lost to eviction or arena loss
    prefix_hits: int = _stat("shared", default=0)  # docs attached to an
    #                                    existing shared op-prefix row
    cow_copies: int = _stat("shared", default=0)   # copy-on-write partial-
    #                                    block copies (prefix -> private)
    sanitizer_checks: int = _stat("shared", default=0)  # arena-sanitizer
    #   launch brackets validated (ARENA_SANITIZE=1; 0 when off).  Mirrored
    #   from the sanitizers' PRIVATE registries — hub metrics stay inert.

    def latency_quantile(self, q: float) -> float:
        if not self.latencies:
            return 0.0
        return float(np.quantile(np.asarray(self.latencies), q))

    def merge_from(self, src: "ServeStats") -> None:
        """Fold ``src`` into ``self``, dispatching on each field's
        declared merge strategy (see ``MERGE_STRATEGIES`` above).  The
        per-stage vectors are folded jointly through ``record`` once."""
        staged = False
        for f in dataclasses.fields(self):
            kind = f.metadata.get("merge", "sum")
            if kind == "stage":
                if not staged:
                    for s in range(len(src.stage_docs)):
                        self.record(s, src.stage_docs[s],
                                    src.stage_new_tokens[s],
                                    src.stage_cached_tokens[s],
                                    src.stage_cost[s])
                    staged = True
            elif kind == "sum":
                setattr(self, f.name,
                        getattr(self, f.name) + getattr(src, f.name))
            elif kind == "max":
                setattr(self, f.name,
                        max(getattr(self, f.name), getattr(src, f.name)))
            elif kind == "concat":
                getattr(self, f.name).extend(getattr(src, f.name))
            else:
                assert kind == "shared", \
                    f"unknown merge strategy {kind!r} on " \
                    f"ServeStats.{f.name}"

    def record(self, stage: int, docs: int, new_tokens: int,
               cached_tokens: int, cost: float = 0.0) -> None:
        while len(self.stage_docs) <= stage:
            self.stage_docs.append(0)
            self.stage_new_tokens.append(0)
            self.stage_cached_tokens.append(0)
            self.stage_cost.append(0.0)
        self.stage_docs[stage] += docs
        self.stage_new_tokens[stage] += new_tokens
        self.stage_cached_tokens[stage] += cached_tokens
        self.stage_cost[stage] += cost

    def total_new_tokens(self) -> int:
        return sum(self.stage_new_tokens)

    def total_cached_tokens(self) -> int:
        return sum(self.stage_cached_tokens)

    def total_cost(self) -> float:
        return sum(self.stage_cost)

    def cache_hit_rate(self) -> float:
        tot = self.total_new_tokens() + self.total_cached_tokens()
        return self.total_cached_tokens() / tot if tot else 0.0
