"""Find a cell's routing thresholds on the card, once, when the cell is
defined: the confidence quantiles that send a share of the documents
that reach each stage out there (``--exit-shares``, one a stage with
thresholds; by default half at stage 0 and half of the rest at stage 1).

    python bench/tools/calibrate.py --workload <cell> --docs 256 --seed 1 \
        --exit-shares 0.5 0.5

Builds the cell as a run does (the models' weights from their reference
families), runs each stage of the cell's tenants through the program's
stage-step API (``LMBackend.run_stage``) over ``--docs`` documents of the
cell's traffic and prints the confidence quartiles and the thresholds,
which go into ``bench/workloads/<cell>.json`` by hand.
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
    ap.add_argument("--exit-shares", type=float, nargs="+",
                    default=[0.5, 0.5])
    args = ap.parse_args()
    cell = load_cell(load_benchmark(__import__("pathlib").Path(ROOT)),
                     args.workload)
    cell.serve = dict(cell.serve, docs=args.docs)
    run = Run(cell, args.seed, 1.0, False, "cuda", time.perf_counter())
    run.build()
    server, B = run.server, cell.serve["batch"]
    docs = [d for ds in run.traffic.docs for d in ds]
    tok = next(iter(server.backends.values())).tokenizer
    toks = {d.doc_id: np.asarray(tok.encode(d.text), np.int32)
            for d in docs}

    def stage(ids, model, op, frac):
        be = server.backends[model]
        conf = {}
        optok = np.asarray(tok.encode(cell.config["operations"][op]),
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

    out = {}
    for k, t in enumerate(cell.serve["tenants"]):
        ids, out[f"tenant{k}"] = [d.doc_id for d in docs], []
        for st, share in zip(t["stages"], args.exit_shares):
            c = stage(ids, st["model"], st["op"], st["fraction"])
            th = float(np.quantile(list(c.values()), 1.0 - share))
            out[f"tenant{k}"].append(th)
            ids = [d for d in ids if c[d] < th]
        for be in server.backends.values():
            for d in docs:
                be.release(d.doc_id)
    print("thresholds " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
