"""Device roofline helpers used by serving telemetry.

The peak memory bandwidth is read from the CUDA device itself
(``2 * memory_clock_rate * memory_bus_width / 8``: double data rate, bus
width in bits), never from a constant for some other accelerator.  On
the CPU there is no device roof, so utilization is ``None``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch


@functools.lru_cache(maxsize=None)
def device_peak_bandwidth(index: int = 0) -> Optional[float]:
    """Peak device-memory bandwidth of CUDA device ``index`` in bytes/s,
    or ``None`` when no CUDA device is present."""
    if not torch.cuda.is_available():
        return None
    props = torch.cuda.get_device_properties(index)
    clock_khz = getattr(props, "memory_clock_rate", None)
    bus_bits = getattr(props, "memory_bus_width", None)
    if not clock_khz or not bus_bits:
        return None
    return 2.0 * clock_khz * 1e3 * bus_bits / 8.0


def bandwidth_utilization(bytes_moved: float, seconds: float,
                          bw: Optional[float] = None) -> Optional[float]:
    """Fraction of the device-memory roof a measured transfer achieved,
    or ``None`` when there is no device roof to compare with (CPU).
    ``bw`` overrides the roof read from the device."""
    if bw is None:
        bw = device_peak_bandwidth()
    if bw is None:
        return None
    if seconds <= 0.0:
        return 0.0
    return (float(bytes_moved) / float(seconds)) / bw


def overlap_hidden_fraction(hidden_s: float, exposed_s: float) -> float:
    """Fraction of device time hidden behind host work by ahead-of-time
    dispatch: ``hidden / (hidden + exposed)``.

    ``hidden_s`` is the summed in-flight window (dispatch returned, sync
    not yet entered) and ``exposed_s`` the summed completion waits the
    host actually paid.  0.0 at ``inflight=1`` (nothing overlaps), -> 1.0
    when completion never blocks.  Returns 0.0 when both terms are ~0."""
    total = float(hidden_s) + float(exposed_s)
    if total <= 0.0:
        return 0.0
    return float(hidden_s) / total
