"""Readings that set a cell's limits: the program's numbers over many
seeds and the control's, in one process on the card.

    python bench/tools/control.py --workload <cell> --seconds 15 \\
        --seeds 11 12 13 ...

For each seed a short window at the cell's own load (the models and the
server are built once; the server is drained between seeds), then over
the check's sample of resolved documents:

* ``port``: ``margin_err``, ``routing_gap`` and, where the cell asks for
  ``check_oracle_docs``, ``oracle_margin_p50`` of the served answers
  against the float32 reference, as a benchmark run computes them;
* ``control``: the same numbers of the reference computed through float8
  (``precision="fp8"``, the step below the configuration's bf16), put in
  the program's place: over the sample its own path through the cascade
  and its own answer, over the oracle draw the oracle's answer, against
  the float32 reference;
* ``<precision>_only``: the same as the control for each precision that
  a model's reference family names (``looks``), such as the router's
  input alone in bfloat16.

The models' reference families come from the configuration file, as in
a benchmark run.  Prints one JSON line per seed, with each draw's margin
errors sorted (``*_oracle_margins``), so that a quantile other than the
median can be read where the median does not separate.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402

from bench.harness.check import (conf_log_odds, control_path,  # noqa: E402
                                 log_odds, path_numbers, sample_numbers,
                                 stage_logits)


def readings(cell, ctx, params, sample, extra, ref, precision):
    """The compared numbers of the reference through ``precision`` put in
    the program's place, against the float32 reference ``ref`` at every
    stage of ``sample + extra`` (the check's sample, then its oracle
    draw); and the draw's margin errors, sorted."""
    judged = sample + extra
    last = [len(ctx.stages[r.doc.tenant]) - 1 for r in judged]
    alt = stage_logits(cell, params, judged, last, precision)
    nums = []
    for i, r in enumerate(sample):
        stages = ctx.stages[r.doc.tenant]
        e, p, c = control_path(stages, alt[i])
        nums.append(path_numbers(stages, e, p, c, ref[i]))
    out = sample_numbers(nums) if nums else {}
    margins = []
    for i in range(len(sample), len(judged)):
        # the oracle's own answer: its stage alone, which always resolves
        _, pred, conf = control_path(ctx.stages[judged[i].doc.tenant][-1:],
                                     alt[i][-1:])
        margins.append(abs(conf_log_odds(conf)
                           - log_odds(ref[i][last[i]], pred)))
    if margins:
        out["oracle_margin_p50"] = float(np.median(margins))
    return out, sorted(margins)


def main() -> None:
    from pathlib import Path

    import torch

    from bench.harness.check import judge
    from bench.harness.core import Run
    from bench.harness.spec import load_benchmark, load_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--warm", type=float, default=None,
                    help="warm-up seconds of every run after the first "
                         "(default: the cell's)")
    args = ap.parse_args()
    cell = load_cell(load_benchmark(Path(ROOT)), args.workload)
    looks = sorted({p for m, e in cell.config["models"].items()
                    for p in cell.family(m).looks(e["port"])})
    prev = None
    for seed in args.seeds:
        run = Run(cell, seed, args.seconds, False, args.device,
                  time.perf_counter())
        if prev is not None and args.warm is not None:
            cell.serve = dict(cell.serve, warm_seconds=args.warm)
        run.build(reuse=prev)
        run.window()
        ctx = run.ctx
        t = time.perf_counter()
        got = {}
        port = judge(ctx, run.params, cell, got)
        sample, extra = got["sample"], got["extra"]
        by_model = {}
        for r, (m, _) in zip(sample, got["nums"]):
            model = ctx.stages[r.doc.tenant][r.exit_stage].model
            by_model[model] = max(by_model.get(model, 0.0), m)
        last = [len(ctx.stages[r.doc.tenant]) - 1 for r in sample + extra]
        ref = stage_logits(cell, run.params, sample + extra, last)
        ctl, ctl_draw = readings(cell, ctx, run.params, sample, extra, ref,
                                 "fp8")
        exits = {}
        for r in ctx.docs:
            if r.exit_stage is not None:
                exits[r.exit_stage] = exits.get(r.exit_stage, 0) + 1
        out = {"seed": seed, "docs": len(ctx.docs),
               "exit_stages": dict(sorted(exits.items())),
               "port": {n: c["value"] for n, c in port.items()},
               "port_margin_err_by_exit_model": by_model,
               "port_oracle_margins": sorted(
                   round(m, 5) for m, _ in got["nums"][len(sample):]),
               "control": ctl,
               "control_oracle_margins": [round(m, 5) for m in ctl_draw]}
        for prec in looks:
            out[f"{prec}_only"], _ = readings(cell, ctx, run.params, sample,
                                              extra, ref, prec)
        out["check_s"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
        run.drain()
        prev = run
        if args.device == "cuda":
            torch.cuda.synchronize()


if __name__ == "__main__":
    main()
