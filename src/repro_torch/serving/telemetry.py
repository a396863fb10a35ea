"""Bounded-memory tracing + metrics for the cascade serving plane.

Zero external dependencies (numpy only), zero device work: every probe is
a host-side ``time.perf_counter()`` read or a dict update around the
jitted stage steps, so the fault-free data plane stays bitwise identical
whether telemetry is off, at ``"counters"`` (the default), or at
``"trace"``.  All storage is fixed-capacity — ring buffers for events and
launch records, a capped label-set registry for metrics — so memory stays
bounded under million-document traffic.

Levels
------
``off``       every probe is a no-op.
``counters``  metric registry + per-launch timeline records (default).
``trace``     additionally records per-document span events.

Event schema (span traces, ``level="trace"``)
---------------------------------------------
Every event is a ``(ts, rid, kind, attrs)`` tuple appended to the shared
``TraceBuffer`` ring (drop-oldest; ``dropped_events`` counts overwrites).
``ts`` is a raw ``time.perf_counter()`` stamp, ``rid`` the server-global
request id of the owning ``DocRequest`` (``register_doc`` maps it to the
caller's ``(query_id, ext_id)``), ``attrs`` a small dict or None.  Kinds:

==============  =========================================================
``submit``      document admitted (attrs: ``stage``; ``restored=True``
                for journal-restored documents on warm restart)
``launch``      document rode a dispatched launch (attrs: ``sig`` —
                the static launch signature ``(model, op, bucket,
                cached_len, f_len)`` — plus ``batch``, ``stage``,
                ``launch`` index)
``escalate``    stage advance (attrs: ``to`` stage and ``reason`` —
                ``threshold`` | ``breaker`` | ``quarantine``)
``retry``       re-enqueued solo after a failed launch (attrs:
                ``retries``, ``backoff_s``)
``evict``       slot preempted (attrs: ``backend``, ``lost_tokens``,
                ``reason`` — ``budget`` | ``arena_loss``)
``quarantine``  non-finite confidence caught (attrs: ``count``)
``prefix_hit``  attached to a shared op-prefix row (attrs: ``backend``)
``cow_copy``    partial-block copy-on-write copy (attrs: ``backend``)
``fault``       injected fault touched this doc's launch (attrs:
                ``kind`` — ``launch_failure``|``nan_conf``|``spike``)
``resolved`` /  terminal states; exactly one per span, always last
``failed`` /    (attrs: ``stage`` for resolved, ``error`` otherwise).
``timed_out``
==============  =========================================================

A *well-formed* span starts with ``submit``, ends with exactly one
terminal event, and has non-decreasing timestamps — ``validate_spans``
checks all three and the smoke gate requires zero violations.

Launch timeline (``level="counters"`` and up)
---------------------------------------------
``CascadeServer.step()`` decomposes each launch's wall time into four
disjoint segments that sum to the record's wall clock:

``sched_s``     scheduler pick: deadline sweep, breaker rerouting,
                ``RequestQueue.next_launch``
``host_s``      host bookkeeping: eviction, batch assembly, billing,
                threshold routing, queue pushes (the residual of the
                other three — everything that is not dispatch/device)
``dispatch_s``  the stage-step call returning (async dispatch)
``device_s``    the completion-side wait on the launch's CUDA event

SEGMENT SEMANTICS UNDER OVERLAPPED DISPATCH (``CascadeServer.inflight``
> 1): timing is PER-TICKET and never forces synchronization — the
dispatch segment stamps around the non-blocking ``dispatch_group``
enqueue, the device segment stamps around ``complete_group``'s sync,
and the window in between (dispatch returned, sync not yet entered:
the launch computing on-device while the host schedules/dispatches
OTHER launches) is recorded separately as the record's ``inflight_s``.
``inflight_s`` is NOT one of the four wall-clock segments: a record's
wall spans dispatch of younger launches at K>1, so walls of
consecutive records overlap and ``host_s`` — still the residual —
absorbs the in-flight window (the four segments still sum to ``wall_s``
exactly).  The hidden window is the overlap win:
``timeline["overlap_hidden_frac"] = inflight / (inflight + device)``
(≈0 at ``inflight=1``, → 1 when sched+host work fully hides device
waits), and ``timeline["mean_launch_gap_ms"]`` measures
``max(enqueue(next) - ready(prev), 0)`` over consecutive ok records —
the device idle window between launches, which ahead-of-time dispatch
drives toward zero.  At ``inflight=1`` every stamp reduces to the
pre-overlap decomposition (``device_s`` measured immediately after
dispatch; ``inflight_s`` ~ 0).

The old ``LMBackend.host_overhead_s`` scalar survives as a derived view:
it accumulates ``host assembly + dispatch`` exactly as before, and
``snapshot()["timeline"]["host_overhead_s"]`` derives the same quantity
from the segment totals.  Each ``LaunchRecord`` also carries batch
occupancy, structural copy/undo-log bytes, and — for decode-only
launches — a ``launch/roofline.py``-derived HBM bandwidth-utilization
estimate.

Exporters
---------
``chrome_trace``/``write_chrome_trace``  Chrome trace-event JSON,
    loadable in Perfetto / chrome://tracing: one process track per
    backend (launch slices with nested segment slices), one per query
    (per-document span slices with instant events), doc spans tied to
    launches via the ``launch`` arg on their instants.
``MetricRegistry.to_prometheus``  Prometheus text exposition format.
``Telemetry.snapshot``  plain-dict summary embedded by
    ``benchmarks/serve_engine.py --smoke`` (structural counters gated by
    ``check_regression.py``, timings ungated).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

LEVEL_OFF = "off"
LEVEL_COUNTERS = "counters"
LEVEL_TRACE = "trace"
LEVELS = (LEVEL_OFF, LEVEL_COUNTERS, LEVEL_TRACE)

# span event kinds (terminals intentionally equal scheduler's status
# strings so ``_finish`` can pass ``req.status`` straight through)
EV_SUBMIT = "submit"
EV_LAUNCH = "launch"
EV_ESCALATE = "escalate"
EV_RETRY = "retry"
EV_EVICT = "evict"
EV_QUARANTINE = "quarantine"
EV_PREFIX_HIT = "prefix_hit"
EV_COW_COPY = "cow_copy"
EV_FAULT = "fault"
# Runtime arena-sanitizer violation (analysis.sanitizer): emitted per
# owning request right before ``ArenaRaceError`` aborts the run.  The
# sanitizer's per-launch *check* counters deliberately live on a private
# registry (``ArenaSanitizer.counters()``) rather than the hub, so an
# ARENA_SANITIZE=1 run stays counter-inert vs. the shared benchmark
# baseline; only violations — which abort anyway — touch hub metrics
# (``serve_sanitizer_violations_total``) and the trace buffer.
EV_SANITIZER = "sanitizer_violation"
EV_RESOLVED = "resolved"
EV_FAILED = "failed"
EV_TIMED_OUT = "timed_out"
TERMINAL_EVENTS = (EV_RESOLVED, EV_FAILED, EV_TIMED_OUT)


class TraceBuffer:
    """Fixed-capacity ring buffer, drop-oldest on overflow.

    ``append`` past capacity overwrites the oldest item and increments
    ``dropped`` (the ``dropped_events`` counter of the tentpole
    contract); ``items()`` returns the surviving tail oldest-first.
    ``total`` counts every append ever made, so ``total - len(buf)``
    is the number of items no longer inspectable.
    """

    def __init__(self, capacity: int):
        assert capacity > 0, "TraceBuffer capacity must be positive"
        self.capacity = capacity
        self._buf: List[Any] = [None] * capacity
        self._next = 0
        self._len = 0
        self.dropped = 0
        self.total = 0

    def append(self, item: Any) -> None:
        if self._len == self.capacity:
            self.dropped += 1
        else:
            self._len += 1
        self._buf[self._next] = item
        self._next = (self._next + 1) % self.capacity
        self.total += 1

    def items(self) -> List[Any]:
        if self._len < self.capacity:
            return self._buf[: self._len]
        return self._buf[self._next:] + self._buf[: self._next]

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._next = 0
        self._len = 0
        self.dropped = 0
        self.total = 0

    def __len__(self) -> int:
        return self._len


# --------------------------------------------------------------- metrics
def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


def default_time_buckets() -> Tuple[float, ...]:
    """Geometric 1us..~34s bucket bounds (p50/p99 within ~2x resolution
    without storing samples), plus +inf."""
    return tuple(1e-6 * 2.0 ** i for i in range(25)) + (math.inf,)


class Histogram:
    """Fixed-bucket histogram: quantiles from cumulative bucket counts
    (linear interpolation inside the bucket), no sample storage."""

    __slots__ = ("bounds", "counts", "sum", "count", "max_seen")

    def __init__(self, bounds: Optional[Iterable[float]] = None):
        self.bounds = tuple(bounds) if bounds is not None \
            else default_time_buckets()
        assert self.bounds and self.bounds[-1] == math.inf, \
            "histogram bounds must end with +inf"
        self.counts = [0] * len(self.bounds)
        self.sum = 0.0
        self.count = 0
        self.max_seen = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        self.max_seen = max(self.max_seen, v)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = max(q, 0.0) * self.count
        cum = 0
        lo = 0.0
        for bound, c in zip(self.bounds, self.counts):
            if c and cum + c >= target:
                hi = bound if math.isfinite(bound) else self.max_seen
                frac = (target - cum) / c
                # clamp: interpolation inside the top bucket must not
                # report a value no observation ever reached
                return min(lo + frac * max(hi - lo, 0.0), self.max_seen)
            cum += c
            if math.isfinite(bound):
                lo = bound
        return self.max_seen

    def p50(self) -> float:
        return self.quantile(0.50)

    def p99(self) -> float:
        return self.quantile(0.99)


class MetricRegistry:
    """Labeled counters/gauges/histograms with a hard series cap.

    Per-query and per-backend labels keep cardinality small in practice;
    the cap (``max_series``) bounds memory regardless — series past it
    land in a shared ``_overflow`` sink and ``dropped_series`` counts
    them, so callers never crash and the loss is observable.
    """

    def __init__(self, max_series: int = 4096):
        self.max_series = max_series
        self._metrics: Dict[str, Tuple[str, Dict[Tuple, Any]]] = {}
        self.dropped_series = 0
        self._overflow = {"counter": Counter(), "gauge": Gauge(),
                          "histogram": Histogram()}

    def _series(self, kind: str, name: str, labels: Dict[str, Any],
                factory) -> Any:
        typ, series = self._metrics.setdefault(name, (kind, {}))
        assert typ == kind, f"metric {name!r} re-registered as {kind}"
        key = _label_key(labels)
        m = series.get(key)
        if m is None:
            if self.series_count() >= self.max_series:
                self.dropped_series += 1
                return self._overflow[kind]
            m = factory()
            series[key] = m
        return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._series("counter", name, labels, Counter)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._series("gauge", name, labels, Gauge)

    def histogram(self, name: str, bounds: Optional[Iterable[float]] = None,
                  **labels: Any) -> Histogram:
        return self._series("histogram", name, labels,
                            lambda: Histogram(bounds))

    def series_count(self) -> int:
        return sum(len(s) for _, s in self._metrics.values())

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view: ``name{k=v,...}`` -> value (histograms ->
        {count, sum, p50, p99})."""
        out: Dict[str, Any] = {}
        for name, (kind, series) in sorted(self._metrics.items()):
            for key, m in sorted(series.items()):
                lbl = ",".join(f"{k}={v}" for k, v in key)
                tag = f"{name}{{{lbl}}}" if lbl else name
                if kind == "histogram":
                    out[tag] = {"count": m.count, "sum": m.sum,
                                "p50": m.p50(), "p99": m.p99()}
                else:
                    out[tag] = m.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (text/plain; version 0.0.4)."""
        lines: List[str] = []
        for name, (kind, series) in sorted(self._metrics.items()):
            lines.append(f"# TYPE {name} {kind}")
            for key, m in sorted(series.items()):
                lbl = ",".join(f'{k}="{v}"' for k, v in key)
                if kind == "histogram":
                    cum = 0
                    for bound, c in zip(m.bounds, m.counts):
                        cum += c
                        le = "+Inf" if math.isinf(bound) else repr(bound)
                        sep = "," if lbl else ""
                        lines.append(
                            f'{name}_bucket{{{lbl}{sep}le="{le}"}} {cum}')
                    suffix = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{name}_sum{suffix} {m.sum}")
                    lines.append(f"{name}_count{suffix} {m.count}")
                else:
                    suffix = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{name}{suffix} {m.value}")
        return "\n".join(lines) + "\n"


# -------------------------------------------------------- launch timeline
@dataclass
class LaunchRecord:
    """One dispatched launch: signature, occupancy, copy traffic, and the
    scheduler/host/dispatch/device wall-time decomposition (the four
    segments are disjoint and sum to ``wall_s`` by construction)."""

    index: int                     # server launch index (attempt order)
    ts_start: float                # perf_counter at step entry
    model: str = ""
    op_id: Optional[str] = None
    bucket: int = 0
    cached_len: int = 0
    f_len: int = 0
    batch: int = 0                 # true documents in the launch
    width: int = 0                 # padded static launch width
    sched_s: float = 0.0
    host_s: float = 0.0
    dispatch_s: float = 0.0
    device_s: float = 0.0
    wall_s: float = 0.0
    copy_bytes: int = 0            # gather copy / paged undo-log bytes
    hbm_bytes: Optional[float] = None   # est. device bytes moved (decode)
    bw_util: Optional[float] = None     # fraction of the HBM roof achieved
    ok: bool = True
    error: Optional[str] = None
    # per-ticket overlap stamps (0.0 when the launch never dispatched)
    ts_enqueue: float = 0.0        # perf_counter entering the jit call
    ts_ready: float = 0.0          # perf_counter after block_until_ready
    inflight_s: float = 0.0        # dispatched->sync window hidden behind
    #                                other launches' sched/host work; NOT
    #                                a wall-clock segment (see docstring)

    @property
    def occupancy(self) -> float:
        return self.batch / self.width if self.width else 0.0

    @property
    def decode_only(self) -> bool:
        return self.cached_len == self.f_len

    def segments(self) -> Dict[str, float]:
        return {"sched": self.sched_s, "host": self.host_s,
                "dispatch": self.dispatch_s, "device": self.device_s}


# --------------------------------------------------------------- telemetry
_DOC_META_FACTOR = 4     # doc-meta map capacity, in trace capacities


class Telemetry:
    """The serving plane's observability hub (see module docstring).

    One instance per ``CascadeServer``, shared with its backends and the
    fault injector.  Every method is safe to call at any level — probes
    cheaply no-op below their level.
    """

    def __init__(self, level: str = LEVEL_COUNTERS,
                 trace_capacity: int = 65536,
                 timeline_capacity: int = 8192,
                 max_series: int = 4096):
        assert level in LEVELS, f"telemetry level must be one of {LEVELS}"
        self.level = level
        self.events = TraceBuffer(trace_capacity)
        self.launches = TraceBuffer(timeline_capacity)
        self.registry = MetricRegistry(max_series=max_series)
        self.idle_wait_s = 0.0
        # running totals survive ring overwrites
        self.event_kinds: Dict[str, int] = {}
        self.launch_total = 0
        self.failed_launch_total = 0
        self.sched_total_s = 0.0
        self.host_total_s = 0.0
        self.dispatch_total_s = 0.0
        self.device_total_s = 0.0
        self.wall_total_s = 0.0
        self.inflight_total_s = 0.0
        self._prev_ready = 0.0      # last ok record's ts_ready (gap histo)
        self._doc_meta: Dict[int, Tuple[int, int]] = {}

    # -- levels ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.level != LEVEL_OFF

    @property
    def tracing(self) -> bool:
        return self.level == LEVEL_TRACE

    # -- span events -----------------------------------------------------
    def register_doc(self, rid: int, query_id: int, ext_id: int) -> None:
        """Map a request id to the caller-visible (query, doc) identity
        for exporters; bounded alongside the event ring."""
        if not self.tracing:
            return
        cap = _DOC_META_FACTOR * self.events.capacity
        if len(self._doc_meta) >= cap:
            for k in list(self._doc_meta)[: cap // 4]:
                del self._doc_meta[k]
        self._doc_meta[rid] = (query_id, ext_id)

    def event(self, rid: int, kind: str, ts: float,
              attrs: Optional[Dict[str, Any]] = None) -> None:
        if not self.tracing:
            return
        self.events.append((ts, rid, kind, attrs))
        self.event_kinds[kind] = self.event_kinds.get(kind, 0) + 1

    def spans(self) -> Dict[int, List[Tuple]]:
        """Group surviving events by request id, in recorded order."""
        out: Dict[int, List[Tuple]] = {}
        for ev in self.events.items():
            out.setdefault(ev[1], []).append(ev)
        return out

    def validate_spans(self, require_terminal: bool = True
                       ) -> Dict[str, Any]:
        """Well-formedness over every surviving span: ``submit`` first,
        exactly one terminal event (last), non-decreasing timestamps.
        Spans that lost events to ring overwrites are skipped (their
        head is gone by construction); ``dropped_events`` reports that
        separately."""
        spans = self.spans()
        violations: List[str] = []
        checked = 0
        partial = self.events.dropped > 0
        for rid, evs in spans.items():
            if partial and evs[0][2] != EV_SUBMIT:
                continue                     # head lost to the ring
            checked += 1
            if evs[0][2] != EV_SUBMIT:
                violations.append(f"rid {rid}: first event {evs[0][2]!r}, "
                                  "expected submit")
            terms = [i for i, e in enumerate(evs)
                     if e[2] in TERMINAL_EVENTS]
            if require_terminal and len(terms) != 1:
                violations.append(
                    f"rid {rid}: {len(terms)} terminal events")
            elif terms and terms[-1] != len(evs) - 1:
                violations.append(f"rid {rid}: events after terminal")
            ts = [e[0] for e in evs]
            if any(b < a for a, b in zip(ts, ts[1:])):
                violations.append(f"rid {rid}: non-monotone timestamps")
        return {"spans": len(spans), "checked": checked,
                "violations": violations, "ok": not violations}

    # -- metrics ---------------------------------------------------------
    def count(self, name: str, value: float = 1.0, **labels: Any) -> None:
        if self.enabled:
            self.registry.counter(name, **labels).inc(value)

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        if self.enabled:
            self.registry.gauge(name, **labels).set(value)

    def observe(self, name: str, value: float, **labels: Any) -> None:
        if self.enabled:
            self.registry.histogram(name, **labels).observe(value)

    def add_idle_wait(self, seconds: float) -> None:
        self.idle_wait_s += seconds
        if self.enabled:
            self.registry.counter("serve_idle_wait_seconds_total"
                                  ).inc(seconds)

    # -- launch timeline -------------------------------------------------
    def record_launch(self, rec: LaunchRecord) -> None:
        if not self.enabled:
            return
        self.launches.append(rec)
        self.launch_total += 1
        if not rec.ok:
            self.failed_launch_total += 1
        self.sched_total_s += rec.sched_s
        self.host_total_s += rec.host_s
        self.dispatch_total_s += rec.dispatch_s
        self.device_total_s += rec.device_s
        self.wall_total_s += rec.wall_s
        self.inflight_total_s += rec.inflight_s
        if rec.ok and rec.ts_enqueue > 0.0:
            # gap histogram: device idle between one launch becoming
            # ready and the next entering the queue (0 under overlap)
            if self._prev_ready > 0.0:
                self.observe("serve_launch_gap_seconds",
                             max(rec.ts_enqueue - self._prev_ready, 0.0))
            self._prev_ready = rec.ts_ready
        be = rec.model or "?"
        self.count("serve_launches_total", 1, backend=be,
                   ok=str(rec.ok).lower())
        self.observe("serve_launch_wall_seconds", rec.wall_s, backend=be)
        for seg, v in rec.segments().items():
            self.observe("serve_launch_segment_seconds", v, segment=seg)
        if rec.bw_util is not None:
            self.observe("serve_decode_bw_utilization", rec.bw_util,
                         backend=be)

    def mean_launch_gap_s(self) -> float:
        """Mean device idle window between consecutive surviving launch
        records — the gap ROADMAP item 2's async dispatch targets.

        When both records carry per-ticket stamps the gap is
        ``max(enqueue(next) - ready(prev), 0)``: zero whenever the next
        launch was enqueued before the previous one's results were
        needed (the overlap win), so zeros COUNT toward the mean.
        Stamp-less records (never dispatched) fall back to the legacy
        wall-clock formula over positive gaps."""
        recs = [r for r in self.launches.items() if r.ok]
        gaps: List[float] = []
        for a, b in zip(recs, recs[1:]):
            if a.ts_ready > 0.0 and b.ts_enqueue > 0.0:
                gaps.append(max(b.ts_enqueue - a.ts_ready, 0.0))
            elif b.ts_start >= a.ts_start + a.wall_s:
                gaps.append(b.ts_start - (a.ts_start + a.wall_s))
        return sum(gaps) / len(gaps) if gaps else 0.0

    # -- summaries -------------------------------------------------------
    def segments_sum_ok(self, rel_tol: float = 0.05) -> bool:
        """Acceptance check: per-launch segments sum to the step wall
        time within ``rel_tol`` (they are disjoint sub-intervals, so
        this should hold exactly up to float addition)."""
        for r in self.launches.items():
            if not r.ok:
                continue
            s = r.sched_s + r.host_s + r.dispatch_s + r.device_s
            if abs(s - r.wall_s) > rel_tol * max(r.wall_s, 1e-9):
                return False
        return True

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict summary: ``counters`` are structural (gateable),
        ``timeline`` are wall-clock timings (never gated)."""
        # local import: roofline depends only on stdlib, but serving
        # modules must stay importable without the launch package cycle
        from ..launch.roofline import overlap_hidden_fraction
        utils = [r.bw_util for r in self.launches.items()
                 if r.bw_util is not None]
        return {
            "level": self.level,
            "counters": {
                "events_total": self.events.total,
                "events_by_kind": dict(sorted(self.event_kinds.items())),
                "dropped_events": self.events.dropped,
                "launch_records": self.launch_total,
                "failed_launch_records": self.failed_launch_total,
                "dropped_launch_records": self.launches.dropped,
                "metric_series": self.registry.series_count(),
                "dropped_metric_series": self.registry.dropped_series,
                "segments_sum_ok": self.segments_sum_ok(),
            },
            "timeline": {
                "sched_s": self.sched_total_s,
                "host_s": self.host_total_s,
                "dispatch_s": self.dispatch_total_s,
                "device_s": self.device_total_s,
                "wall_s": self.wall_total_s,
                # derived view of the pre-telemetry lumped scalar
                "host_overhead_s": self.host_total_s + self.dispatch_total_s,
                "idle_wait_s": self.idle_wait_s,
                "inflight_s": self.inflight_total_s,
                "overlap_hidden_frac": overlap_hidden_fraction(
                    self.inflight_total_s, self.device_total_s),
                "mean_launch_gap_ms": 1e3 * self.mean_launch_gap_s(),
                "decode_bw_util_mean": (sum(utils) / len(utils)
                                        if utils else 0.0),
            },
        }

    def clear(self) -> None:
        self.events.clear()
        self.launches.clear()
        self.registry = MetricRegistry(max_series=self.registry.max_series)
        self.idle_wait_s = 0.0
        self.event_kinds.clear()
        self.launch_total = 0
        self.failed_launch_total = 0
        self.sched_total_s = 0.0
        self.host_total_s = 0.0
        self.dispatch_total_s = 0.0
        self.device_total_s = 0.0
        self.wall_total_s = 0.0
        self.inflight_total_s = 0.0
        self._prev_ready = 0.0
        self._doc_meta.clear()


# --------------------------------------------------------------- exporters
def chrome_trace(tm: Telemetry) -> Dict[str, Any]:
    """Chrome trace-event JSON (Perfetto-loadable) from a telemetry hub.

    Track layout: one process per backend — launch slices ("X" events)
    with the four wall-time segments as nested child slices — and one
    process per query with one thread per document: the document's span
    is a slice from its first to last event, every span event an instant
    on it (``launch`` instants carry the launch index that ties them to
    the backend track).
    """
    recs = list(tm.launches.items())
    spans = tm.spans()
    stamps = [r.ts_start for r in recs]
    stamps += [evs[0][0] for evs in spans.values() if evs]
    t0 = min(stamps) if stamps else 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    events: List[Dict[str, Any]] = []
    pids: Dict[str, int] = {}

    def pid_for(label: str) -> int:
        pid = pids.get(label)
        if pid is None:
            pid = len(pids) + 1
            pids[label] = pid
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": label}})
        return pid

    for r in recs:
        pid = pid_for(f"backend:{r.model or '?'}")
        args = {"launch": r.index, "op": r.op_id, "bucket": r.bucket,
                "cached_len": r.cached_len, "f_len": r.f_len,
                "batch": r.batch, "width": r.width,
                "occupancy": round(r.occupancy, 4),
                "copy_bytes": r.copy_bytes, "ok": r.ok}
        if r.bw_util is not None:
            args["bw_util"] = round(r.bw_util, 6)
        if r.error:
            args["error"] = r.error
        events.append({"ph": "X", "pid": pid, "tid": 0,
                       "name": f"launch {r.index} {r.op_id or ''}"
                               f"@{r.bucket}",
                       "cat": "launch", "ts": us(r.ts_start),
                       "dur": round(r.wall_s * 1e6, 3), "args": args})
        cursor = r.ts_start
        for seg, dur in r.segments().items():
            events.append({"ph": "X", "pid": pid, "tid": 0, "name": seg,
                           "cat": "segment", "ts": us(cursor),
                           "dur": round(dur * 1e6, 3)})
            cursor += dur

    for rid, evs in sorted(spans.items()):
        qid, ext = tm._doc_meta.get(rid, (-1, rid))
        pid = pid_for(f"query:{qid}" if qid >= 0 else "query:?")
        tid = rid
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": f"doc {ext}"}})
        start, end = evs[0][0], evs[-1][0]
        events.append({"ph": "X", "pid": pid, "tid": tid,
                       "name": f"doc {ext} [{evs[-1][2]}]", "cat": "span",
                       "ts": us(start),
                       "dur": round(max(end - start, 0.0) * 1e6, 3),
                       "args": {"rid": rid, "query": qid, "doc": ext,
                                "events": len(evs)}})
        for ts, _rid, kind, attrs in evs:
            events.append({"ph": "i", "pid": pid, "tid": tid, "name": kind,
                           "cat": "span", "s": "t", "ts": us(ts),
                           "args": dict(attrs or {})})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(tm: Telemetry, path: str) -> Dict[str, Any]:
    """Serialize ``chrome_trace`` to ``path``; returns the trace dict."""
    trace = chrome_trace(tm)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace
