"""Command line of ``bench/run.py``."""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path
from typing import List, Optional

from . import guard
from .core import log, run_cell
from .spec import load_benchmark, load_cell


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def main(argv: List[str], t_start: float, root: str) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(load_benchmark(Path(root)), args.workload)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card only")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} devices, "
            f"{torch.cuda.device_count()} present")
        return 3
    print(f"device: {torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, nvidia-smi name,power.limit: "
          f"{power_limit()}", flush=True)
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", t_start)
    except ImportError as exc:
        if "import guard" in str(exc):
            log(str(exc))
            return 4
        raise
    guard.check("before the result")
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0
