"""Deterministic fault injection for the cascade serving plane.

This module is the chaos half of the fault-tolerance contract: it wraps a
server's ``LMBackend``s in proxies that inject the failure classes the
engine must survive, from a single seeded RNG so every chaos run is
exactly reproducible.

Injected fault classes
----------------------
launch failure   the launch is poisoned at DISPATCH (the model step is
                 never enqueued, so no partial state exists) but the
                 ``InjectedLaunchFailure`` SURFACES at completion — where
                 a real device-side error would surface under async
                 dispatch; the engine re-enqueues each member document
                 solo with backoff.
non-finite conf  one document's confidence entry in the returned batch is
                 overwritten with NaN at completion, *after* a successful
                 step — the billing already happened, mirroring a real
                 model emitting garbage logits.  The engine quarantines
                 that document.
latency spike    completion sleeps ``spike_s`` before syncing (a slow
                 device launch: the host pays the stall when it needs the
                 results), exercising deadline/timeout paths without
                 touching results.
arena loss       at a planned launch index the injector reports the
                 (backend, bucket) holding the most live documents as
                 lost; the engine replays the eviction path (release slot,
                 zero cached length) so the next launch re-prefills.

Determinism: the injector draws a FIXED number of uniforms per dispatch
(one per probabilistic fault class, drawn whether or not the fault
fires) plus one per NaN event — drawn at completion — to pick the
victim row, so the fault schedule depends only on ``FaultPlan.seed`` and
the sequence of launches — not on which faults happened to fire earlier.
With one launch in flight the draw/pick interleaving is exactly the
pre-split order; with K>1, dispatch-order draws plus FIFO-completion
picks keep the schedule a pure function of the dispatch sequence.

Usage::

    injector = FaultInjector(FaultPlan(seed=7, launch_failure_p=0.2))
    injector.install(server)        # wraps server.backends in place
    ... submit / drain as usual ...
    injector.counts                 # {"launch_failures": ..., ...}

The wrappers forward every attribute to the wrapped backend, so the
engine's slot/eviction/billing paths run unmodified; with all
probabilities zero and no arena-loss event the wrapped server is
behaviourally identical to the bare one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import time

import numpy as np

from .telemetry import EV_FAULT


class InjectedFault(RuntimeError):
    """Base class for faults raised by the injection harness."""


class InjectedLaunchFailure(InjectedFault):
    """A launch that failed before its model step committed any state."""


@dataclass(frozen=True)
class FaultPlan:
    """Seeded description of which faults to inject and how often.

    Probabilities are per ``run_group`` call.  ``arena_loss_at`` names the
    1-based launch index *after* which the arena-loss event fires (None
    disables it); ``arena_loss_backend`` pins the victim backend by name
    (None picks the backend+bucket with the most live documents).
    """

    seed: int = 0
    launch_failure_p: float = 0.0
    nan_p: float = 0.0
    latency_spike_p: float = 0.0
    spike_s: float = 0.0
    arena_loss_at: Optional[int] = None
    arena_loss_backend: Optional[str] = None


class FaultInjector:
    """Draws the fault schedule and wraps backends with injecting proxies."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed)
        self.calls = 0
        self.counts: Dict[str, int] = {
            "launch_failures": 0,
            "nan_confidences": 0,
            "latency_spikes": 0,
            "arena_losses": 0,
        }
        self._arena_loss_armed = plan.arena_loss_at is not None

    # -- per-call schedule -------------------------------------------------
    def draw(self) -> Tuple[bool, bool, bool]:
        """(fail_launch, corrupt_conf, spike) for the next run_group call.

        Always burns exactly three uniforms so the schedule is a pure
        function of the seed and the call index.
        """
        u_fail, u_nan, u_spike = self.rng.uniform(size=3)
        self.calls += 1
        return (u_fail < self.plan.launch_failure_p,
                u_nan < self.plan.nan_p,
                u_spike < self.plan.latency_spike_p)

    def pick_victim(self, n: int) -> int:
        """Row index whose confidence gets corrupted (extra draw)."""
        return int(self.rng.integers(n))

    # -- arena loss --------------------------------------------------------
    def poll_arena_loss(self, launch_idx: int, backends: Dict[str, Any]
                        ) -> List[Tuple[str, int]]:
        """(backend name, bucket) pairs lost after launch ``launch_idx``.

        Fires at most once, at ``plan.arena_loss_at``; the victim is the
        (backend, bucket) with the most live slots — losing an idle arena
        would test nothing.
        """
        if not self._arena_loss_armed or launch_idx < self.plan.arena_loss_at:
            return []
        self._arena_loss_armed = False
        best: Optional[Tuple[str, int]] = None
        best_live = 0
        for name, be in backends.items():
            inner = getattr(be, "_inner", be)
            if (self.plan.arena_loss_backend is not None
                    and name != self.plan.arena_loss_backend):
                continue
            live_by_bucket: Dict[int, int] = {}
            for bucket, _slot in inner._doc_slot.values():
                live_by_bucket[bucket] = live_by_bucket.get(bucket, 0) + 1
            for bucket, live in live_by_bucket.items():
                if live > best_live:
                    best, best_live = (name, bucket), live
        if best is None:
            return []
        self.counts["arena_losses"] += 1
        return [best]

    # -- installation ------------------------------------------------------
    def wrap(self, backend: Any) -> "FaultyBackend":
        return FaultyBackend(backend, self)

    def install(self, server: Any) -> "FaultInjector":
        """Wrap every backend of ``server`` in place and register self."""
        server.backends = {name: self.wrap(be)
                           for name, be in server.backends.items()}
        server.faults = self
        return self


class _InjectedTicket:
    """Fault wrapper around a backend's ``GroupTicket``: carries the
    completion-time effects (spike sleep, injected failure, NaN
    corruption) decided at dispatch.  Poisoned tickets (injected launch
    failure) have NO inner ticket — the failure was decided before the
    model step was enqueued, so no state was committed — and present
    inert defaults for the timeline fields the server reads on the
    failed-record path."""

    __slots__ = ("inner", "fail_exc", "corrupt", "spike_s", "ids")

    # every ticket field the server reads on the failed-record path
    # (``CascadeServer._record_flight``): width 0 records that no rows
    # were launched, and there is no completion event to wait on
    _POISONED_DEFAULTS = {"timing": None, "ts_enqueue": 0.0,
                          "ts_dispatched": 0.0, "ts_sync": 0.0,
                          "ts_ready": 0.0, "copy_bytes": 0, "width": 0,
                          "event": None}

    def __init__(self, inner: Any, fail_exc: Optional[Exception],
                 corrupt: bool, spike_s: float, ids: List[int]):
        self.inner = inner
        self.fail_exc = fail_exc
        self.corrupt = corrupt
        self.spike_s = spike_s
        self.ids = ids

    def __getattr__(self, name: str) -> Any:
        inner = object.__getattribute__(self, "inner")
        if inner is not None:
            return getattr(inner, name)
        try:
            return _InjectedTicket._POISONED_DEFAULTS[name]
        except KeyError:
            raise AttributeError(name) from None


class FaultyBackend:
    """Transparent ``LMBackend`` proxy that injects planned faults.

    Everything except the launch path (``dispatch_group`` /
    ``complete_group`` / ``run_group``) forwards to the wrapped backend,
    so slot allocation, eviction, retirement and byte accounting behave
    exactly as without injection.  The fault schedule is drawn at
    dispatch; the fault EFFECTS (sleep, raise, NaN) land at completion —
    where async dispatch surfaces real device errors.
    """

    def __init__(self, inner: Any, injector: FaultInjector):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_injector", injector)

    def __getattr__(self, name: str) -> Any:
        return getattr(object.__getattribute__(self, "_inner"), name)

    def __setattr__(self, name: str, value: Any) -> None:
        setattr(object.__getattribute__(self, "_inner"), name, value)

    def dispatch_group(self, *args, **kwargs) -> _InjectedTicket:
        """Draw this launch's fault schedule, then enqueue the real step
        (unless the launch is poisoned — then nothing is enqueued and no
        state commits, exactly the pre-split raise-before-step
        contract).  Counts and EV_FAULT trace events stamp at draw time
        so the injection is visible next to the dispatch that chose it."""
        inj: FaultInjector = object.__getattribute__(self, "_injector")
        inner = object.__getattribute__(self, "_inner")
        # The inner backend shares the server's telemetry handle; injected
        # faults land in the owning documents' span traces (EV_FAULT) so a
        # Perfetto view shows the injection next to the retry/quarantine
        # it provokes.  RNG draw order is untouched: telemetry reads the
        # schedule, it never draws.
        tm = getattr(inner, "telemetry", None)
        ids = args[0] if args else kwargs.get("ids", [])
        fail, corrupt, spike = inj.draw()
        spike_s = inj.plan.spike_s if (spike
                                       and inj.plan.spike_s > 0.0) else 0.0
        if spike_s:
            inj.counts["latency_spikes"] += 1
            if tm is not None and tm.enabled:
                tm.count("serve_injected_faults_total", 1,
                         kind="latency_spike", backend=inner.name)
                if tm.tracing:
                    ts = time.perf_counter()
                    for d in ids:
                        tm.event(d, EV_FAULT, ts,
                                 {"kind": "latency_spike",
                                  "backend": inner.name,
                                  "spike_s": inj.plan.spike_s})
        if fail:
            inj.counts["launch_failures"] += 1
            if tm is not None and tm.enabled:
                tm.count("serve_injected_faults_total", 1,
                         kind="launch_failure", backend=inner.name)
                if tm.tracing:
                    ts = time.perf_counter()
                    for d in ids:
                        tm.event(d, EV_FAULT, ts,
                                 {"kind": "launch_failure",
                                  "backend": inner.name})
            exc = InjectedLaunchFailure(
                f"injected launch failure (call {inj.calls}, "
                f"model={inner.name})")
            return _InjectedTicket(None, exc, False, spike_s, list(ids))
        ticket = inner.dispatch_group(*args, **kwargs)
        return _InjectedTicket(ticket, None, corrupt, spike_s, list(ids))

    def complete_group(self, ticket: _InjectedTicket):
        """Apply the ticket's planned effects where async dispatch
        surfaces them: sleep out a latency spike, raise a poisoned
        launch's failure, and corrupt the victim confidence after a
        successful sync."""
        inj: FaultInjector = object.__getattribute__(self, "_injector")
        inner = object.__getattribute__(self, "_inner")
        tm = getattr(inner, "telemetry", None)
        if ticket.spike_s:
            time.sleep(ticket.spike_s)
        if ticket.fail_exc is not None:
            raise ticket.fail_exc
        pred, conf, new_d, cached_d = inner.complete_group(ticket.inner)
        if ticket.corrupt:
            inj.counts["nan_confidences"] += 1
            conf = np.array(conf, dtype=np.float64, copy=True)
            victim = inj.pick_victim(conf.shape[0])
            conf[victim] = np.nan
            if tm is not None and tm.enabled:
                tm.count("serve_injected_faults_total", 1,
                         kind="nan_conf", backend=inner.name)
                if tm.tracing and victim < len(ticket.ids):
                    tm.event(ticket.ids[victim], EV_FAULT,
                             time.perf_counter(),
                             {"kind": "nan_conf", "backend": inner.name})
        return pred, conf, new_d, cached_d

    def run_group(self, *args, **kwargs):
        """Synchronous composition (one ticket in flight): exactly the
        pre-split fault semantics and RNG draw order."""
        return self.complete_group(self.dispatch_group(*args, **kwargs))
