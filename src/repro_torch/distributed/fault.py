"""Fault tolerance: heartbeats, elastic remesh planning, straggler policy.

On a real deployment these hooks watch per-host liveness; offline they are
driven by tests/examples injecting failures.  The decisions they produce
are the production-relevant artifacts:

``HeartbeatMonitor``   tracks last-beat per participant, flags dead ones
                       (timeout) and stragglers (slowest vs median beat
                       interval), with hysteresis.

``plan_remesh``        given surviving chip count, pick the largest
                       supported mesh <= survivors and emit the restore
                       plan (checkpoint reshard + data-pipeline failover) —
                       elastic scaling uses the mesh-agnostic checkpoint
                       layout (checkpoint.py) and deterministic shard
                       reassignment (data/pipeline.py).

``StragglerPolicy``    serving-side mitigation: re-bucket documents queued
                       on slow shards onto fast ones once slowdown crosses
                       a threshold (see serving/scheduler.py).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class HeartbeatMonitor:
    timeout_s: float = 30.0
    straggler_factor: float = 2.0
    clock: callable = time.monotonic
    _last: Dict[str, float] = field(default_factory=dict)
    _intervals: Dict[str, List[float]] = field(default_factory=dict)

    def beat(self, who: str, step: Optional[int] = None) -> None:
        now = self.clock()
        if who in self._last:
            self._intervals.setdefault(who, []).append(now - self._last[who])
            self._intervals[who] = self._intervals[who][-16:]
        self._last[who] = now

    def dead(self) -> List[str]:
        now = self.clock()
        return [w for w, t in self._last.items()
                if now - t > self.timeout_s]

    def stragglers(self) -> List[str]:
        avgs = {w: sum(v) / len(v) for w, v in self._intervals.items()
                if len(v) >= 3}
        if len(avgs) < 2:
            return []
        med = sorted(avgs.values())[len(avgs) // 2]
        return [w for w, a in avgs.items()
                if a > self.straggler_factor * max(med, 1e-9)]


# meshes we know how to run, largest first: (shape, axis names)
SUPPORTED_MESHES: Tuple[Tuple[Tuple[int, ...], Tuple[str, ...]], ...] = (
    ((2, 16, 16), ("pod", "data", "model")),
    ((16, 16), ("data", "model")),
    ((8, 16), ("data", "model")),
    ((4, 16), ("data", "model")),
    ((2, 16), ("data", "model")),
    ((1, 16), ("data", "model")),
    ((1, 8), ("data", "model")),
    ((2, 2), ("data", "model")),      # dev-scale fallbacks
    ((1, 4), ("data", "model")),
    ((1, 2), ("data", "model")),
    ((1, 1), ("data", "model")),
)


@dataclass(frozen=True)
class RemeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    chips: int
    batch_scale: float            # new dp size / old dp size
    notes: str = ""

    def dp_size(self) -> int:
        return int(self.chips // self.shape[-1])


def plan_remesh(surviving_chips: int,
                old_dp: int = 16) -> Optional[RemeshPlan]:
    """Largest supported mesh that fits the survivors.

    The model axis is held at 16 (param layout stays valid); the data/pod
    axes shrink, and the caller rescales global batch or raises
    accumulation steps by ``batch_scale`` to keep the optimizer schedule
    meaningful.  Returns None when fewer than one model group survives.
    """
    for shape, axes in SUPPORTED_MESHES:
        chips = 1
        for s in shape:
            chips *= s
        if chips <= surviving_chips:
            dp = chips // shape[-1]
            return RemeshPlan(
                shape, axes, chips, batch_scale=dp / old_dp,
                notes=(f"restore latest checkpoint resharded to {shape}; "
                       f"data pipeline failover keeps shard determinism"))
    return None


@dataclass
class StragglerPolicy:
    """Decide when to migrate queued work off slow serving shards."""
    slowdown_threshold: float = 1.5

    def migrations(self, shard_rates: Dict[int, float]
                   ) -> List[Tuple[int, int]]:
        """shard -> docs/s.  Returns [(from_shard, to_shard), ...]."""
        if len(shard_rates) < 2:
            return []
        items = sorted(shard_rates.items(), key=lambda kv: kv[1])
        med = items[len(items) // 2][1]
        out = []
        fast = [s for s, r in items if r >= med][::-1]
        fi = 0
        for s, r in items:
            if r > 0 and med / r >= self.slowdown_threshold and fast:
                out.append((s, fast[fi % len(fast)]))
                fi += 1
        return out
