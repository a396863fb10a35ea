"""Runtime arena sanitizer: per-row ownership epochs for the KV arenas.

ROADMAP item 2 (ahead-of-time dispatch, K launches in flight, donated
arena buffers) rests on the claim that in-flight launches touching
disjoint arena rows cannot alias.  The serving engine today is
synchronous, so the claim is vacuously true — and therefore unchecked.
This module makes it checkable: when sanitizing is on
(``ARENA_SANITIZE=1`` in the environment, or ``LMBackend.sanitize=True``)
every launch registers its read/write row sets before dispatch
(``begin_launch``) and withdraws them after the device sync
(``end_launch``); slot lifecycle events (alloc / release / pin / unpin /
bucket retirement) keep a host-side shadow of row ownership.  Any of the
following raises :class:`ArenaRaceError` with both launch signatures,
the overlapping rows, and the owning doc/query ids:

  * overlapping in-flight **write/write** or **write/read** row sets;
  * a **write to a pinned** refcounted prefix row outside the COW path
    (``cow()`` context — prefix prefill and partial-block copies);
  * **use-after-release**: a launch addressing a row that is FREE, or a
    row of a retired bucket.

Row states::

    FREE --note_alloc--> LIVE --note_pin--> PINNED
      ^                   |  ^                 |
      +---note_release----+  +---note_unpin----+

``note_retire(bucket)`` drops every row of the bucket (the arena pytree
is gone); later references diagnose as use-after-retire.  Each
transition bumps the row's **epoch**, so a stale ticket naming a
recycled row is distinguishable from the row's new owner in the
diagnostic.

Inertness contract: the sanitizer is pure host-side Python over ids the
engine already computes — it never touches device arrays, RNG streams,
or the shared :class:`~repro_torch.serving.telemetry.Telemetry` registry on
the clean path.  Its ``serve_sanitizer_checks_total`` /
``serve_sanitizer_rows_checked_total`` counters live on a private
per-sanitizer registry (``counters()``) and are mirrored into
``ServeStats.sanitizer_checks`` by the server, precisely so the hub's
metric series (gated exactly by ``benchmarks/check_regression.py``)
stay bitwise identical with sanitizing on or off.  Only a *violation*
(which aborts the launch anyway) emits into the hub: a
``serve_sanitizer_violations_total`` count plus an ``EV_SANITIZER``
span event per owning request when tracing.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, FrozenSet, Iterable, List, Optional,
                    Set, Tuple)

FREE = "free"
LIVE = "live"
PINNED = "pinned"


class ArenaRaceError(RuntimeError):
    """A launch's registered row sets violate arena ownership.

    Carries structured diagnostics beside the message: ``rows`` (the
    conflicting arena rows), ``bucket``, ``kind`` (``overlap`` /
    ``pinned_write`` / ``use_after_release`` / ``double_alloc`` /
    ``unregistered_rows``), and ``signatures`` (the launch signatures
    involved — two for overlaps, one otherwise).
    """

    def __init__(self, message: str, *, kind: str, bucket: Optional[int],
                 rows: Iterable[int], signatures: Tuple[Any, ...] = ()):
        super().__init__(message)
        self.kind = kind
        self.bucket = bucket
        self.rows = sorted(set(int(r) for r in rows))
        self.signatures = signatures


@dataclass
class _Row:
    state: str = FREE
    owner: Optional[int] = None     # doc id (server rid; < 0 = prefix row)
    op: Optional[str] = None        # pinning op for PINNED rows
    epoch: int = 0                  # bumped on every state transition


@dataclass
class _Ticket:
    launch_id: int
    bucket: int
    signature: Any
    reads: FrozenSet[int]
    writes: FrozenSet[int]
    scratch: Optional[int]


@dataclass
class ArenaSanitizer:
    """Shadow ownership tracker for one backend's bucket arenas."""

    backend: str = ""
    # optional diagnostics callback: doc id -> {"query": qid, "doc": ext}
    # (the CascadeServer installs one so races name the owning tenant)
    doc_info: Optional[Callable[[int], Any]] = None
    telemetry: Any = None           # violation reporting only (see module doc)
    checks: int = 0                 # launches bracketed (cumulative)
    rows_checked: int = 0           # row memberships validated (cumulative)
    kernel_checks: int = 0          # eager kernel-wrapper row sets validated
    violations: int = 0
    inflight_peak: int = 0          # max simultaneously-open brackets seen
    _rows: Dict[int, Dict[int, _Row]] = field(default_factory=dict)
    _retired: Set[int] = field(default_factory=set)
    _inflight: Dict[int, _Ticket] = field(default_factory=dict)
    _cow_depth: Dict[int, int] = field(default_factory=dict)
    _next_launch: int = 0

    # ------------------------------------------------------------ lifecycle
    def reset(self) -> None:
        """Forget all row state (arenas were reset); counters survive."""
        assert not self._inflight, \
            "sanitizer reset with launches in flight"
        self._rows.clear()
        self._retired.clear()
        self._cow_depth.clear()

    def counters(self) -> Dict[str, int]:
        """Private metric registry (kept OFF the shared telemetry hub so
        the hub's gated series are identical with sanitizing on/off)."""
        return {
            "serve_sanitizer_checks_total": self.checks,
            "serve_sanitizer_rows_checked_total": self.rows_checked,
            "serve_sanitizer_kernel_checks_total": self.kernel_checks,
            "serve_sanitizer_violations_total": self.violations,
            "serve_sanitizer_inflight_peak": self.inflight_peak,
        }

    def _bucket(self, bucket: int) -> Dict[int, _Row]:
        return self._rows.setdefault(bucket, {})

    def _row(self, bucket: int, row: int) -> _Row:
        return self._bucket(bucket).setdefault(row, _Row())

    # --------------------------------------------------- slot state changes
    def note_alloc(self, bucket: int, row: int, doc_id: int) -> None:
        """A slot was issued to ``doc_id`` (FREE -> LIVE)."""
        self._retired.discard(bucket)       # bucket is in use again
        r = self._row(bucket, row)
        if r.state != FREE:
            self._raise(
                "double_alloc", bucket, [row],
                f"row {row} issued to doc {doc_id} while {r.state} "
                f"(owner {self._owner_str(r)}, epoch {r.epoch})")
        r.state, r.owner, r.op = LIVE, doc_id, None
        r.epoch += 1

    def note_clear(self, bucket: int, row: int) -> None:
        """``BucketArena.clear_slot``: a row is being recycled.  Legal on
        FREE/LIVE rows that no in-flight launch holds; clearing a PINNED
        row or an in-flight row is a race."""
        r = self._bucket(bucket).get(row)
        if r is not None and r.state == PINNED:
            self._raise(
                "pinned_write", bucket, [row],
                f"row {row} (pinned for op {r.op!r}) cleared for reuse "
                f"while still a shared prefix row")
        holders = [t for t in self._inflight.values()
                   if t.bucket == bucket and
                   (row in t.reads or row in t.writes)]
        if holders:
            t = holders[0]
            self._raise(
                "overlap", bucket, [row],
                f"row {row} cleared while launch #{t.launch_id} "
                f"sig={t.signature!r} is in flight over it",
                signatures=(t.signature,))

    def note_release(self, bucket: int, row: int) -> None:
        """A document's slot returned to the free list (LIVE -> FREE)."""
        r = self._bucket(bucket).get(row)
        if r is None or r.state == FREE:
            self._raise(
                "use_after_release", bucket, [row],
                f"row {row} released twice (already free)")
        if r.state == PINNED:
            self._raise(
                "pinned_write", bucket, [row],
                f"row {row} released while pinned for op {r.op!r} "
                f"(unpin first)")
        self.note_clear(bucket, row)        # must not be in flight either
        r.state, r.owner, r.op = FREE, None, None
        r.epoch += 1

    def note_pin(self, bucket: int, row: int, op_id: str) -> None:
        """A LIVE row became a shared (refcounted) op-prefix row."""
        r = self._row(bucket, row)
        if r.state != LIVE:
            self._raise(
                "pinned_write", bucket, [row],
                f"row {row} pinned for op {op_id!r} while {r.state}")
        r.state, r.op = PINNED, op_id
        r.epoch += 1

    def note_unpin(self, bucket: int, row: int) -> None:
        """A prefix row's memo was dropped (PINNED -> LIVE; the caller
        releases the backing slot next)."""
        r = self._bucket(bucket).get(row)
        if r is None or r.state != PINNED:
            state = "unknown" if r is None else r.state
            self._raise(
                "use_after_release", bucket, [row],
                f"row {row} unpinned while {state}")
        r.state, r.op = LIVE, None
        r.epoch += 1

    def note_retire(self, bucket: int) -> None:
        """The bucket's arena pytree was dropped; every row dies with it."""
        for t in self._inflight.values():
            if t.bucket == bucket:
                self._raise(
                    "overlap", bucket, sorted(t.reads | t.writes),
                    f"bucket {bucket} retired while launch "
                    f"#{t.launch_id} sig={t.signature!r} is in flight",
                    signatures=(t.signature,))
        self._rows.pop(bucket, None)
        self._retired.add(bucket)

    @contextmanager
    def cow(self, bucket: int):
        """Legal-write window for pinned rows: op-prefix prefill and the
        partial-block copy-on-write read both happen inside this."""
        self._cow_depth[bucket] = self._cow_depth.get(bucket, 0) + 1
        try:
            yield self
        finally:
            self._cow_depth[bucket] -= 1

    def in_cow(self, bucket: int) -> bool:
        return self._cow_depth.get(bucket, 0) > 0

    # ------------------------------------------------------ launch brackets
    def begin_launch(self, bucket: int, signature: Any,
                     reads: Iterable[int], writes: Iterable[int],
                     scratch: Optional[int] = None) -> _Ticket:
        """Register one launch's row sets; raises on any violation.

        ``reads``/``writes`` are arena row ids (slots plus block-table
        columns; a pinned prefix row in ``reads`` is the legal
        shared-read).  ``scratch`` names the arena's scratch row, exempt
        from ownership (padding writes land there by design).  Returns a
        ticket for :meth:`end_launch` (use try/finally)."""
        w = frozenset(int(r) for r in writes) - {scratch}
        rd = frozenset(int(r) for r in reads) - {scratch}
        self.checks += 1
        self.rows_checked += len(w | rd)
        # 1. every addressed row must be LIVE or PINNED in this bucket
        dead = []
        for row in sorted(w | rd):
            r = self._bucket(bucket).get(row)
            if r is None or r.state == FREE:
                dead.append(row)
        if dead:
            why = ("bucket was retired"
                   if bucket in self._retired else "rows are free/unknown")
            self._raise(
                "use_after_release", bucket, dead,
                f"launch sig={signature!r} addresses released rows "
                f"{dead} ({why})", signatures=(signature,))
        # 2. writes to pinned prefix rows are legal only on the COW path
        pinned_w = [row for row in sorted(w)
                    if self._bucket(bucket)[row].state == PINNED]
        if pinned_w and not self.in_cow(bucket):
            ops = {row: self._bucket(bucket)[row].op for row in pinned_w}
            self._raise(
                "pinned_write", bucket, pinned_w,
                f"launch sig={signature!r} writes pinned prefix rows "
                f"{ops!r} outside the COW path", signatures=(signature,))
        # 3. overlap with in-flight launches: write/write or write/read
        for t in self._inflight.values():
            if t.bucket != bucket:
                continue
            ww = w & t.writes
            wr = (w & t.reads) | (rd & t.writes)
            clash = ww | wr
            if clash:
                kind = "write/write" if ww else "write/read"
                self._raise(
                    "overlap", bucket, clash,
                    f"in-flight {kind} overlap on rows "
                    f"{sorted(clash)}: launch sig={signature!r} vs "
                    f"launch #{t.launch_id} sig={t.signature!r}; "
                    f"owners: {self._owners_str(bucket, clash)}",
                    signatures=(signature, t.signature))
        ticket = _Ticket(self._next_launch, bucket, signature, rd, w, scratch)
        self._next_launch += 1
        self._inflight[ticket.launch_id] = ticket
        if len(self._inflight) > self.inflight_peak:
            self.inflight_peak = len(self._inflight)
        return ticket

    def end_launch(self, ticket: _Ticket) -> None:
        self._inflight.pop(ticket.launch_id, None)

    # ------------------------------------------------------- kernel bridge
    def kernel_hook(self) -> Callable[[str, Any, int], None]:
        """Hook for ``kernels.sanitize``: validates concrete slot /
        block-table row ids observed by the (eagerly-called) kernel
        wrappers against [0, n_rows] and, when launches are in flight,
        against their registered row sets."""
        def hook(where: str, rows: Any, n_rows: int) -> None:
            import numpy as np
            flat = set(int(r) for r in np.asarray(rows).ravel())
            self.kernel_checks += 1
            bad = sorted(r for r in flat if r < 0 or r > n_rows)
            if bad:
                self._raise(
                    "unregistered_rows", None, bad,
                    f"{where}: rows {bad} outside [0, {n_rows}]")
            if self._inflight:
                allowed: Set[int] = set()
                for t in self._inflight.values():
                    allowed |= t.reads | t.writes
                    if t.scratch is not None:
                        allowed.add(t.scratch)
                allowed.add(n_rows)         # scratch by convention
                unreg = sorted(flat - allowed)
                if unreg:
                    sigs = tuple(t.signature
                                 for t in self._inflight.values())
                    self._raise(
                        "unregistered_rows", None, unreg,
                        f"{where}: rows {unreg} not registered by any "
                        f"in-flight launch ({len(self._inflight)} "
                        f"in flight)", signatures=sigs)
        return hook

    # -------------------------------------------------------- diagnostics
    def _owner_str(self, r: _Row) -> str:
        if r.owner is None:
            return "none"
        extra = ""
        if self.doc_info is not None:
            info = self.doc_info(r.owner)
            if info is not None:
                extra = f" {info}"
        return f"doc {r.owner}{extra}"

    def _owners_str(self, bucket: int, rows: Iterable[int]) -> str:
        parts = []
        for row in sorted(rows):
            r = self._bucket(bucket).get(row) or _Row()
            parts.append(f"row {row} -> {self._owner_str(r)} "
                         f"[{r.state}, epoch {r.epoch}]")
        return "; ".join(parts)

    def _raise(self, kind: str, bucket: Optional[int], rows: Iterable[int],
               detail: str, signatures: Tuple[Any, ...] = ()) -> None:
        self.violations += 1
        msg = (f"arena sanitizer [{self.backend or 'backend'}"
               f"{'' if bucket is None else f'/bucket {bucket}'}] "
               f"{kind}: {detail}")
        tm = self.telemetry
        if tm is not None and getattr(tm, "enabled", False):
            tm.count("serve_sanitizer_violations_total", 1,
                     backend=self.backend or "unknown", kind=kind)
            if getattr(tm, "tracing", False):
                from ..serving.telemetry import EV_SANITIZER  # lazy import
                ts = time.perf_counter()
                owners = [] if bucket is None else [
                    self._bucket(bucket).get(r, _Row()).owner
                    for r in rows]
                for rid in {o for o in owners if o is not None and o >= 0}:
                    tm.event(rid, EV_SANITIZER, ts,
                             {"kind": kind, "rows": sorted(set(rows)),
                              "backend": self.backend})
        raise ArenaRaceError(msg, kind=kind, bucket=bucket, rows=rows,
                             signatures=signatures)


def env_enabled(env: Optional[Dict[str, str]] = None) -> bool:
    """Resolve the ``ARENA_SANITIZE`` environment switch ("", "0" = off)."""
    import os
    val = (env if env is not None else os.environ).get("ARENA_SANITIZE", "0")
    return val not in ("", "0")
