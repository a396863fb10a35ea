"""Readers of what the program records on each launch: the two phases of
the stage step (the extend, then the op-suffix decode) on the host's
clock and, in traced runs on the card, on the device's; the rows a
launch computed against its real tokens; the collector's pauses; and the
server step's own host time.

The program puts these on its launch records (``LaunchRecord`` of
``repro_torch.serving.telemetry``).  A record without a field, as a
program that predates it writes, makes its reader return None, and the
harness then leaves the metric out.  Shares are in percent.

The device windows join the profiler's operations in one sweep: the
operations' union is merged once into busy intervals with running sums,
and each window's busy time is then two binary searches.  The windows'
stamps are on ``perf_counter`` by the program's clock anchor, the
operations by the trace's marker kernels; each launch's end event is
paired with the end of the last device operation that ended before it,
and the largest and the median distance are logged.  An end event the
host recorded late (after a stall) lies past that operation by the
stall, so a single distance says little of the clocks; where the median
passes ``CLOCKS_AGREE_S`` the two maps disagree for most launches, and
the windows are left out.
"""
from __future__ import annotations

import sys
from bisect import bisect_right
from statistics import median
from typing import List, Optional, Sequence, Tuple

from .trace import Op, busy_intervals

CLOCKS_AGREE_S = 1e-3

Window = Tuple[float, float, float]      # (start, split, end), host clock


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _fields(records, name: str) -> Optional[List[float]]:
    vals = [getattr(r, name, None) for r in records]
    if not vals or any(v is None for v in vals):
        return None
    return vals


def mean_ms(records, name: str) -> Optional[float]:
    """Mean of a record field in seconds, in milliseconds."""
    vals = _fields(records, name)
    return None if vals is None else sum(vals) / len(vals) * 1e3


def padded_token_share(ctx) -> Optional[float]:
    """Share of the row-tokens the window's launches computed that were
    padding: ``1 - sum(tokens_real) / sum(rows_computed)``."""
    rows = _fields(ctx.records, "rows_computed")
    real = _fields(ctx.records, "tokens_real")
    if rows is None or real is None or sum(rows) <= 0:
        return None
    return 100.0 * (1.0 - sum(real) / sum(rows))


def gc_pause_share(ctx) -> Optional[float]:
    """The collector's pauses on the window's records over the window."""
    vals = _fields(ctx.records, "gc_s")
    if vals is None or ctx.window_s <= 0:
        return None
    return 100.0 * sum(vals) / ctx.window_s


# ------------------------------------------------------- device windows
class BusyIndex:
    """Busy seconds of any interval over a set of device operations:
    their union merged once, with the busy time before each interval."""

    def __init__(self, ops: Sequence[Op]):
        merged = busy_intervals(sorted(ops, key=lambda o: o.start),
                                float("-inf"), float("inf"))
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.before: List[float] = []
        acc = 0.0
        for s, e in merged:
            self.before.append(acc)
            acc += e - s

    def upto(self, t: float) -> float:
        i = bisect_right(self.starts, t) - 1
        if i < 0:
            return 0.0
        return self.before[i] + min(t, self.ends[i]) - self.starts[i]

    def busy(self, a: float, b: float) -> float:
        return max(self.upto(b) - self.upto(a), 0.0)


def end_residuals(windows: Sequence[Window], ops: Sequence[Op]
                  ) -> List[Tuple[float, float]]:
    """(end event, end of the last device operation that ended before
    it) of each window whose launch has one; ``ops`` sorted by start.
    An operation that begins before the event and ends after it, such as
    an earlier launch's logits copied back right behind this launch's
    end event on the stream, is passed over."""
    starts = [o.start for o in ops]
    out = []
    for _, _, end in windows:
        j = bisect_right(starts, end) - 1
        while j >= 0 and ops[j].end > end:
            j -= 1
        if j >= 0:
            out.append((end, ops[j].end))
    return out


def phase_windows(ctx) -> Optional[List[Window]]:
    """The device windows of the launches dispatched in the window, on
    the operations' clock, or None where the records hold no device
    stamps or the two clocks disagree.  Computed once a run."""
    cached = getattr(ctx, "_phase_windows", False)
    if cached is not False:
        return cached
    wins = None
    if ctx.launches and ctx.ops:
        wins = [(r.dev_start, r.dev_split, r.dev_end)
                for r in (l["rec"] for l in ctx.launches)
                if getattr(r, "dev_start", None) is not None]
        wins = wins or None
    if wins is not None:
        dist = sorted(abs(x - y) for x, y in end_residuals(wins, ctx.ops))
        mid = median(dist) if dist else 0.0
        _log(f"phases: {len(wins)} launch windows; end events against the "
             f"last device operation ended before each: largest distance "
             f"{(dist[-1] if dist else 0.0) * 1e3:.4f} ms, median "
             f"{mid * 1e3:.4f} ms")
        if mid > CLOCKS_AGREE_S:
            _log("phases: the clocks disagree; windows left out")
            wins = None
    ctx._phase_windows = wins
    return wins


def window_busy_share(ctx, phase: str) -> Optional[float]:
    """Device-busy seconds inside the launches' ``extend`` windows
    (``[dev_start, dev_split]``) or ``decode`` windows (``[dev_split,
    dev_end]``) over those windows' seconds."""
    wins = phase_windows(ctx)
    if wins is None:
        return None
    lo, hi = (0, 1) if phase == "extend" else (1, 2)
    index = getattr(ctx, "_busy_index", None)
    if index is None:
        index = ctx._busy_index = BusyIndex(ctx.ops)
    total = busy = 0.0
    for w in wins:
        total += w[hi] - w[lo]
        busy += index.busy(w[lo], w[hi])
    return 100.0 * busy / total if total > 0 else None
