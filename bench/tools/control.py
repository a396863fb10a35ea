"""Readings that set a cell's limits: the program's numbers over many
seeds and the control's, in one process on the card.

    python bench/tools/control.py --workload <cell> --seconds 15 \\
        --seeds 11 12 13 ...

For each seed a short window at the cell's own load (the models and the
server are built once; the server is drained between seeds), then over
the check's sample of resolved documents:

* ``port``: ``margin_err`` and ``routing_gap`` of the served answers
  against the float32 reference, as a benchmark run computes them;
* ``control``: the same numbers of the reference computed through float8
  (``precision="fp8"``, the step below the configuration's bf16), put in
  the program's place: its own path through the cascade and its own
  answer, against the float32 reference.

Prints one JSON line per seed.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> None:
    from pathlib import Path

    import torch

    from bench.harness.check import (control_path, judge, path_numbers,
                                     sample_docs, sample_numbers,
                                     stage_logits)
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
    prev = None
    for seed in args.seeds:
        run = Run(cell, seed, args.seconds, False, args.device,
                  time.perf_counter())
        if prev is not None and args.warm is not None:
            cell.serve = dict(cell.serve, warm_seconds=args.warm)
        run.build(reuse=prev)
        run.window()
        ctx, k = run.ctx, int(cell.serve["check_docs"])
        t = time.perf_counter()
        port = judge(ctx, run.params, cell)
        sample = sample_docs(ctx.docs, seed, k)
        last = [len(ctx.stages[r.doc.tenant]) - 1 for r in sample]
        ref = stage_logits(cell, run.params, sample, last)
        ctl = stage_logits(cell, run.params, sample, last, "fp8")
        port_nums, ctl_nums, by_model = [], [], {}
        for i, r in enumerate(sample):
            stages = ctx.stages[r.doc.tenant]
            pn = path_numbers(stages, r.exit_stage, r.pred, r.conf, ref[i])
            port_nums.append(pn)
            model = stages[r.exit_stage].model
            by_model[model] = max(by_model.get(model, 0.0), pn[0])
            e, p, c = control_path(stages, ctl[i])
            ctl_nums.append(path_numbers(stages, e, p, c, ref[i]))
        out = {"seed": seed, "docs": len(ctx.docs), "sample": len(sample),
               "port": dict(sample_numbers(port_nums),
                            billing_mismatch=port["billing_mismatch"]
                            ["value"]),
               "port_margin_err_by_exit_model": by_model,
               "control": sample_numbers(ctl_nums)}
        if any(m["port"].get("moe") for m in cell.config["models"].values()):
            # the look: f32 with only the router's input rounded to bf16
            look = stage_logits(cell, run.params, sample, last,
                                "router_bf16")
            gaps = []
            for i, r in enumerate(sample):
                stages = ctx.stages[r.doc.tenant]
                e, p, c = control_path(stages, look[i])
                gaps.append(path_numbers(stages, e, p, c, ref[i]))
            out["router_bf16_only"] = sample_numbers(gaps)
        out["check_s"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
        run.drain()
        prev = run
        if args.device == "cuda":
            torch.cuda.synchronize()


if __name__ == "__main__":
    main()
