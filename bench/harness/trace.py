"""Device trace of a run's window: ``torch.profiler`` over CUDA activity.

The trace's clock is tied to the host's ``time.perf_counter`` by two
marker kernels (``torch.cuda._sleep``), one launched on an idle device at
the window's open and one at its close; every device operation is then
placed on the host's clock, so idle gaps can be labelled by what the host
was doing.

Kernel classes follow the program's smoke run (``chip_smoke.py``'s
``_kernel_class``): the port's attention kernels by name, matrix products
by cuBLAS/CUTLASS name fragments, and the rest (elementwise, norms,
copies, indexing).
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

MARKER = "spin_kernel"
MARKER_CYCLES = 20000
MATMUL_TAGS = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")
ATTENTION_TAGS = ("flash_attention_kernel", "flash_attention_tc_kernel",
                  "decode_partial_kernel", "decode_combine_kernel")


def kernel_class(name: str) -> str:
    if any(t in name for t in ATTENTION_TAGS):
        return "attention"
    if any(t in name.lower() for t in MATMUL_TAGS):
        return "matmul"
    return "other"


@dataclass
class Op:
    name: str
    start: float            # perf_counter seconds
    end: float


class DeviceTrace:
    """Profiler over one window.  ``open()`` starts it and marks the
    clock; ``close()`` marks again and stops it; ``ops`` are then the
    device operations on the host's clock, markers removed."""

    def __init__(self) -> None:
        self.prof = None
        self.marks: List[float] = []
        self.ops: List[Op] = []

    def _mark(self) -> None:
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()

    def open(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._mark()

    def close(self) -> None:
        self._mark()
        self.prof.__exit__(None, None, None)
        raw = device_events(self.prof)
        self.prof = None
        self.ops = place_ops(raw, self.marks[0], self.marks[-1])


def place_ops(raw: Sequence[Tuple[str, float, float]], h0: float,
              h1: float) -> List[Op]:
    """The device operations of ``raw`` (name, start us, end us) on the
    host's clock, markers removed: the open and close markers sit at the
    host stamps ``h0`` and ``h1``.  Where the profiler dropped one of the
    two records (a window of ~2.5 million operations has lost one), the
    other ties the clocks at the trace's own rate of a microsecond."""
    marks = sorted(r for r in raw if MARKER in r[0])
    ops = [r for r in raw if MARKER not in r[0]]
    if len(marks) >= 2:
        (_, a0, _), (_, a1, _) = marks[0], marks[-1]
        scale = (h1 - h0) / max(a1 - a0, 1e-9)       # host s per trace us
    elif len(marks) == 1 and ops:
        a, scale = marks[0][1], 1e-6
        before = sum(s < a for _, s, _ in ops)
        # the open marker precedes the window's operations, the close
        # marker follows them
        a0 = a if 2 * before < len(ops) else a - (h1 - h0) / scale
        print(f"device trace: one marker of two found (the "
              f"{'close' if a0 == a else 'open'} marker's record lost), "
              f"clocks tied by the other", file=sys.stderr, flush=True)
    else:
        raise RuntimeError(f"device trace: {len(marks)} marker kernels "
                           f"found of 2 ({len(raw)} device ops)")
    out = [Op(n, h0 + (s - a0) * scale, h0 + (e - a0) * scale)
           for n, s, e in ops]
    out.sort(key=lambda o: o.start)
    return out


def device_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every device operation: from the raw
    Kineto results, which skips building the host-side event tree."""
    from torch.autograd import DeviceType
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None and hasattr(res, "events"):
        out = []
        for e in res.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns() / 1e3
                out.append((e.name(), s, s + e.duration_ns() / 1e3))
        return out
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_intervals(ops: Sequence[Op], t0: float, t1: float
                   ) -> List[Tuple[float, float]]:
    """Union of device operations clipped to ``[t0, t1]``."""
    out: List[Tuple[float, float]] = []
    for o in ops:
        s, e = max(o.start, t0), min(o.end, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_seconds(ops: Sequence[Op], t0: float, t1: float) -> float:
    return sum(e - s for s, e in busy_intervals(ops, t0, t1))


def time_by(ops: Sequence[Op], key) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for o in ops:
        k = key(o.name)
        out[k] = out.get(k, 0.0) + (o.end - o.start)
    return out


def idle_gaps(ops: Sequence[Op], t0: float, t1: float
              ) -> List[Tuple[float, float]]:
    gaps, cur = [], t0
    for s, e in busy_intervals(ops, t0, t1):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


def _label_sweep(gaps, segs) -> List[Optional[str]]:
    """For each gap (sorted by start), the name of the segment that
    overlaps it most, or None: one sweep over segments sorted by start."""
    segs = sorted(segs)
    out: List[Optional[str]] = []
    active: list = []
    i = 0
    for g0, g1 in gaps:
        while i < len(segs) and segs[i][0] < g1:
            active.append(segs[i])
            i += 1
        active = [a for a in active if a[1] > g0]
        best, label = 0.0, None
        for s0, s1, name in active:
            ov = min(s1, g1) - max(s0, g0)
            if ov > best:
                best, label = ov, name
        out.append(label)
    return out


def labelled_gaps(ops: Sequence[Op], t0: float, t1: float, records
                  ) -> List[Tuple[str, float]]:
    """Every idle gap of the window as (host segment under it, seconds):
    the scheduler's pick (``sched``), the non-blocking dispatch
    (``dispatch``) or the wait on a launch (``device_wait``) that overlaps
    it most; else the rest of a launch's wall (``host``); else the
    harness's own loop (``harness``)."""
    fine, wall = [], []
    for r in records:
        t = r.ts_start
        fine.append((t, t + r.sched_s, "sched"))
        if r.ts_enqueue > 0:
            fine.append((r.ts_enqueue, r.ts_enqueue + r.dispatch_s,
                         "dispatch"))
        if r.ts_ready > 0 and r.device_s > 0:
            fine.append((r.ts_ready - r.device_s, r.ts_ready,
                         "device_wait"))
        wall.append((t, t + r.wall_s, "host"))
    gaps = idle_gaps(ops, t0, t1)
    return [(a or b or "harness", g[1] - g[0]) for g, a, b in
            zip(gaps, _label_sweep(gaps, fine), _label_sweep(gaps, wall))]


def breakdown(ops: Sequence[Op], t0: float, t1: float, records,
              top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps labelled by the host segment under them."""
    clipped = [Op(o.name, max(o.start, t0), min(o.end, t1)) for o in ops
               if o.end > t0 and o.start < t1]
    by_name = sorted(time_by(clipped, lambda n: n).items(),
                     key=lambda kv: -kv[1])[:top]
    gaps = sorted(labelled_gaps(ops, t0, t1, records),
                  key=lambda g: -g[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in by_name],
            "idle_gaps": [[lab, sec] for lab, sec in gaps]}


def gap_medians(ops: Sequence[Op], t0: float, t1: float, records
                ) -> Dict[str, Tuple[int, float]]:
    """(count, median seconds) of idle gaps by host segment."""
    by: Dict[str, List[float]] = {}
    for lab, sec in labelled_gaps(ops, t0, t1, records):
        by.setdefault(lab, []).append(sec)
    return {k: (len(v), sorted(v)[len(v) // 2]) for k, v in by.items()}
