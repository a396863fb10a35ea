"""Find a cell's routing thresholds on the card, once, when the cell is
defined: the confidence quantiles that send about half of the documents
out at stage 0 and half of the rest out at stage 1.

    python bench/tools/calibrate.py --workload <cell> --docs 256 --seed 1

Runs each stage of the cell's tenants through the program's stage-step
API (``LMBackend.run_stage``) over ``--docs`` documents of the cell's
traffic and prints the confidence quartiles and the thresholds, which go
into ``bench/workloads/<cell>.json`` by hand.
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
    import numpy as np
    import torch

    from bench.harness.core import Run
    from bench.harness.spec import load_benchmark, load_cell
    from bench.reference.cascade import bucket_len

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--docs", type=int, default=256)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    cell = load_cell(load_benchmark(__import__("pathlib").Path(ROOT)),
                     args.workload)
    cell.serve = dict(cell.serve, docs=args.docs)
    run = Run(cell, args.seed, 1.0, False, "cuda", time.perf_counter())
    run.build()
    server, B = run.server, cell.serve["batch"]
    be = server.backends["proxy"]
    docs = [d for ds in run.traffic.docs for d in ds]
    toks = {d.doc_id: np.asarray(be.tokenizer.encode(d.text), np.int32)
            for d in docs}

    def stage(ids, op, frac):
        conf = {}
        optok = np.asarray(be.tokenizer.encode(cell.config["operations"][op]),
                           np.int32)
        by = {}
        for d in ids:
            by.setdefault(bucket_len(len(toks[d])), []).append(d)
        t = time.perf_counter()
        for bucket, group in sorted(by.items()):
            for i in range(0, len(group), B):
                part = group[i:i + B]
                _, c, _, _ = be.run_stage(part, toks, bucket, frac, optok,
                                          cell.config["n_classes"])
                conf.update(zip(part, c.tolist()))
        torch.cuda.synchronize()
        print(f"stage {op}@{frac}: {len(ids)} docs in "
              f"{time.perf_counter() - t:.3f} s; conf quartiles "
              f"{np.quantile(list(conf.values()), [0, .25, .5, .75, 1])}",
              flush=True)
        return conf

    ids = [d.doc_id for d in docs]
    out = {}
    for k, t in enumerate(cell.serve["tenants"]):
        s0, s1 = t["stages"]
        c0 = stage(ids, s0["op"], s0["fraction"])
        t0 = float(np.quantile(list(c0.values()), 0.5))
        rest = [d for d in ids if c0[d] < t0]
        c1 = stage(rest, s1["op"], s1["fraction"])
        t1 = float(np.quantile(list(c1.values()), 0.5))
        out[f"tenant{k}"] = [t0, t1]
        for d in ids:
            be.release(d)
    print("thresholds " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
