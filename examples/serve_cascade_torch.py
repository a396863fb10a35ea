"""Construct a task cascade from engine scores and serve it, on the
PyTorch/CUDA port (``src/repro_torch``).

    PYTHONPATH=src python examples/serve_cascade_torch.py [--device cpu]
        [--full-width]

Steps 1-5 of ``examples/serve_cascade.py`` (the paper's Figure 2):
  1. generate a synthetic corpus with planted relevance, fit the §4
     document restructurer (oracle line ranges -> granularity -> relevance
     classifier) and reorder every document through the relevance kernel;
  2. build the proxy (llama3.2-1b) and oracle (qwen3-1.7b) backends with
     random weights from seeds 1 and 2;
  3. score the candidate tasks (proxy x operation x fraction) on the dev
     split through the serving engine, against the oracle's predictions;
  4. Algorithm 2 thresholds + Algorithm 4 greedy assembly;
  5. serve the test split multi-tenant: the assembled cascade and a
     strict-threshold variant registered on one ``CascadeServer``, then
     the oracle-only run for cost and agreement.

``--device`` defaults to the CUDA device (hand-written kernels); ``cpu``
runs their plain PyTorch versions.  The models are the reduced 2-layer
f32 configs (batch 4) unless ``--full-width`` asks for the published
widths in bf16 (batch 8).  Models are untrained, so "accuracy" is
agreement with the oracle MODEL, the paper's alpha definition.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.core.tasks import Cascade  # noqa: E402
from repro_torch.data.documents import generate_corpus  # noqa: E402
from repro_torch.launch import construct  # noqa: E402
from repro_torch.launch.serve import build_engine, warm_arena  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true")
    args = ap.parse_args()
    batch = 8 if args.full_width else 4
    t0 = time.time()

    print("1. corpus + restructuring")
    docs = generate_corpus(28, n_classes=2, avg_lines=16, seed=11)
    restr, reordered = construct.restructure(docs, 12, device=args.device)
    dev_ids = [d.doc_id for d in docs[:12]]
    test_ids = [d.doc_id for d in docs[12:]]
    print(f"   granularity={restr.granularity} lines, "
          f"classifier F1={restr.f1:.2f}")

    print("2. backends (untrained llama3.2-1b proxy + qwen3-1.7b oracle)")
    engine = build_engine(batch, None, 64, device=args.device,
                          full_width=args.full_width,
                          operations=construct.OPS)

    print("3. candidate evaluation on the dev split (engine-backed)")
    dev_docs = {i: reordered[i] for i in dev_ids}
    oracle_ref = engine.run(Cascade([]), dev_docs)
    oracle_pred = np.asarray([oracle_ref.pred[i] for i in dev_ids])
    scores = construct.score_candidates(
        engine, dev_docs, construct.candidate_configs(), batch)
    cm = construct.doc_cost_model(engine.backends["proxy"].tokenizer,
                                  list(dev_docs.values()))

    print("4. Alg 2 thresholds + Alg 4 greedy assembly")
    eligible, cascade, _ = construct.assemble(scores, oracle_pred, cm)
    print(f"   eligible tasks: {len(eligible)}; assembled: "
          f"{[t.config.key() for t in cascade.tasks]}")

    print("5. multi-tenant serving: two queries, one CascadeServer")
    test_docs = {i: reordered[i] for i in test_ids}
    warm_arena(engine, cascade, test_docs, engine.batch_size)
    served = construct.serve_two_queries(engine, cascade, test_docs)
    oracle_only = engine.run(Cascade([]), test_docs)
    res, strict = served.main, served.strict
    agree = np.mean([res.pred[i] == oracle_only.pred[i] for i in test_ids])
    stats = res.stats
    print(f"   served 2x{len(test_ids)} docs in {served.wall_s:.1f}s; "
          f"occupancy {served.occupancy:.2f} docs/launch")
    print(f"   query 0: latency p50 "
          f"{1e3 * stats.latency_quantile(0.5):.0f} ms / p99 "
          f"{1e3 * stats.latency_quantile(0.99):.0f} ms; cost "
          f"${res.cost * 1e3:.4f}m vs oracle-only "
          f"${oracle_only.cost * 1e3:.4f}m "
          f"({res.cost / oracle_only.cost:.2f}x)")
    print(f"   query 1 (strict): cost ${strict.cost * 1e3:.4f}m")
    print(f"   agreement with oracle: {agree:.1%}; KV cache hit rate "
          f"{stats.cache_hit_rate():.1%}; launches {served.launches}")
    print(f"done in {time.time() - t0:.1f}s on {engine.device}")


if __name__ == "__main__":
    main()
