"""Construct a task cascade from engine scores and serve it, on the
PyTorch/CUDA port (``src/repro_torch``).

    PYTHONPATH=src python examples/serve_cascade_torch.py [--device cpu]
        [--full-width]

Steps 1-10 of ``examples/serve_cascade.py`` (1-5 are the paper's
Figure 2):
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
     the oracle-only run for cost and agreement;
  6. replay the feed under injected faults (seeded launch failures, NaN
     confidences, one arena loss): every document reaches a terminal
     state; then crash the server after four steps and warm-restart a
     fresh one from its write-ahead journal;
  7. re-serve the cascade on prefix-sharing bf16 arenas: each operation
     prefix prefills once per (backend, op, bucket) into a pinned row that
     every document's block table points at;
  8. record a Perfetto trace of a two-tenant chaos run;
  9. lint the port with its static-analysis linter (rules RSA001-RSA005
     against the committed baseline), then replay the chaos feed under
     the runtime arena sanitizer (every launch's row sets bracketed;
     zero violations);
 10. re-serve the feed with four launches in flight: preds, confs and $
     bitwise those of one in flight.

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
from repro_torch.launch.serve import (build_engine,  # noqa: E402
                                      poisson_arrivals, warm_arena)
from repro_torch.serving.engine import (CascadeEngine,  # noqa: E402
                                        CascadeServer, LMBackend,
                                        RequestJournal)
from repro_torch.serving.faults import FaultInjector, FaultPlan  # noqa: E402
from repro_torch.serving.scheduler import RESOLVED, RetryPolicy  # noqa: E402
from repro_torch.serving.telemetry import write_chrome_trace  # noqa: E402

CHAOS = dict(seed=5, launch_failure_p=0.25, nan_p=0.2, arena_loss_at=3)
NO_BACKOFF = RetryPolicy(max_retries=2, backoff_base=0.0)


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
    backends = engine.backends
    strict = construct.strict_variant(cascade)
    feed = sorted(test_docs)[:8]

    def server(**kw):
        for be in backends.values():
            be.reset()
        return CascadeServer(backends, engine.operations, n_classes=2,
                             batch_size=batch, device=engine.device, **kw)

    print("6. failure model: injected faults, terminal states, warm restart")
    # Failed launches retry solo with backoff, non-finite confidences are
    # quarantined, a lost arena replays the eviction path; backoff 0 keeps
    # the launch schedule a pure function of the chaos seed.
    chaos = server(retry=NO_BACKOFF, journal=RequestJournal())
    h_chaos = chaos.register(cascade)
    inj = FaultInjector(FaultPlan(**CHAOS)).install(chaos)
    for k, d in enumerate(feed):
        h_chaos.submit(d, test_docs[d], arrival=float(k))
    for _ in range(4):                  # partial progress, then "crash"
        chaos.step()
    crashed = chaos.journal
    print(f"   pre-crash: {len(crashed.resolutions)} of {len(feed)} docs "
          f"terminal after 4 steps ({inj.counts['launch_failures']} launch "
          f"failures, {inj.counts['nan_confidences']} NaN confidences, "
          f"{inj.counts['arena_losses']} arena losses)")
    warm = server(retry=NO_BACKOFF, journal=RequestJournal())
    warm.register(cascade)
    FaultInjector(FaultPlan(seed=5, nan_p=0.2)).install(warm)
    futures = warm.recover(crashed)
    warm.drain()
    statuses = [f.status for f in futures.values()]
    cst = warm.stats()
    print(f"   recovered server: {len(futures)} docs -> "
          f"{sum(s == RESOLVED for s in statuses)} RESOLVED, "
          f"{sum(s != RESOLVED for s in statuses)} FAILED/TIMED_OUT; "
          f"retries={cst.retries} quarantines={cst.quarantines} "
          f"recovered_docs={cst.recovered_docs} (every submitted doc is "
          f"terminal: {all(f.done for f in futures.values())})")

    print("7. prefix sharing + bf16 arenas: more live docs per HBM byte")
    # Op-first layout: each operation prefix prefills ONCE per (backend,
    # op, bucket) into a pinned row aliased by every document's block
    # table (copy-on-write on the partial block); the arena stores KV in
    # bf16.  Billing follows the token-accounting contract: same-op
    # ladders bill exactly as the doc-before-op plane, an op switch
    # re-prefills (the document's KV attends to the op prefix).
    def shared(be, kv_dtype="bfloat16"):
        return LMBackend(name=be.name, model=be.model, params=be.params,
                         tokenizer=be.tokenizer,
                         rate_per_token=be.rate_per_token,
                         prefix_sharing=True, kv_dtype=kv_dtype,
                         device=be.device)

    shared_be = {n: shared(be) for n, be in backends.items()}
    res_shared = CascadeEngine(shared_be, engine.operations, n_classes=2,
                               batch_size=batch,
                               device=engine.device).run(cascade, test_docs)
    sst = res_shared.stats
    b_f32 = shared(backends["proxy"], "float32").slot_nbytes(1024)
    b_bf16 = shared_be["proxy"].slot_nbytes(1024)
    assert b_bf16 == b_f32 // 2 and sst.prefix_hits > 0
    print(f"   prefix_hits={sst.prefix_hits} cow_copies={sst.cow_copies} "
          f"arena_bytes_peak={sst.arena_bytes_peak / 1e6:.1f}MB; slot row "
          f"{b_f32 / 1e6:.2f}MB f32 -> {b_bf16 / 1e6:.2f}MB bf16")
    print(f"   cost ${res_shared.cost * 1e3:.4f}m vs doc-before-op "
          f"${res.cost * 1e3:.4f}m (same-op ladders bill identically; "
          f"op switches re-prefill)")

    print("8. telemetry: Perfetto trace of a two-tenant chaos run")
    traced = server(retry=NO_BACKOFF)
    traced.telemetry.level = "trace"
    FaultInjector(FaultPlan(**CHAOS)).install(traced)
    t_main, t_strict = traced.register(cascade), traced.register(strict)
    for k, d in enumerate(feed):
        t_main.submit(d, test_docs[d], arrival=float(k))
        t_strict.submit(d, test_docs[d], arrival=float(k))
    traced.drain()
    snap = traced.telemetry_snapshot()
    tl = snap["timeline"]
    write_chrome_trace(traced.telemetry, "serve_trace.json")
    print(f"   {snap['counters']['events_total']} span events over "
          f"{snap['spans']['checked']} doc spans, "
          f"{snap['counters']['launch_records']} launch records "
          f"({snap['counters']['failed_launch_records']} failed); spans "
          f"well-formed: {snap['spans']['ok']}")
    print(f"   wall decomposition: sched {1e3 * tl['sched_s']:.1f} ms | "
          f"host {1e3 * tl['host_s']:.1f} ms | dispatch "
          f"{1e3 * tl['dispatch_s']:.1f} ms | device "
          f"{1e3 * tl['device_s']:.1f} ms; wrote serve_trace.json (open "
          f"at https://ui.perfetto.dev)")

    print("9. static analysis + sanitized chaos drain")
    # The port's AST linter (rules RSA001-RSA005: autograd.Function
    # hygiene, CUDA binding conventions, in-place arena writes committed
    # on success, merge metadata, explicit random streams — catalogue in
    # ``repro_torch.analysis.__doc__``) gates the tree against the
    # committed suppression baseline.  Then every launch's read/write row
    # sets are bracketed: slot-aliasing races, pinned-prefix writes
    # outside copy-on-write and use-after-release raise
    # ``ArenaRaceError`` instead of corrupting KV.
    from repro_torch.analysis import lint as rsa_lint
    rc = rsa_lint.main(["src/repro_torch"])
    assert rc == 0, "linter found new violations (see output above)"
    for be in backends.values():
        be.sanitize = True          # or ARENA_SANITIZE=1 in the env
        be._sanitizer = None
    sane = server(retry=NO_BACKOFF)
    FaultInjector(FaultPlan(**CHAOS)).install(sane)
    s_main = sane.register(cascade)
    for k, d in enumerate(feed):
        s_main.submit(d, test_docs[d], arrival=float(k))
    sane.drain()
    sans = [b._sanitizer for b in backends.values()
            if b._sanitizer is not None]
    checks = sum(s.checks for s in sans)
    assert checks > 0 and sum(s.violations for s in sans) == 0
    print(f"   {checks} launch brackets, "
          f"{sum(s.rows_checked for s in sans)} row memberships, "
          f"0 violations")
    for be in backends.values():
        be.sanitize = None          # leave the backends env-driven

    print("10. overlapped dispatch: four launches in flight")
    # dispatch_group enqueues a stage step without waiting; the server
    # syncs a ticket only when routing needs its confidences, so depth
    # changes when the host blocks, never what it computes.
    arrivals = poisson_arrivals(sorted(test_docs), rate=construct.ARRIVAL_RATE,
                                seed=construct.ARRIVAL_SEED)
    overlap = {}
    for depth in (1, 4):
        deep = server(inflight=depth)
        h_deep = deep.register(cascade)
        for d in sorted(test_docs):
            h_deep.submit(d, test_docs[d], arrival=arrivals[d])
        deep.drain()
        overlap[depth] = (h_deep.result(), deep.telemetry_snapshot())
    (r1, snap1), (rk, snapk) = overlap[1], overlap[4]
    assert rk.pred == r1.pred and rk.conf == r1.conf
    assert rk.doc_cost == r1.doc_cost
    tl1, tlk = snap1["timeline"], snapk["timeline"]
    print(f"   max_inflight={snapk['server']['max_inflight']} (window 4); "
          f"preds/confs/$ bitwise equal to inflight=1; overlap-hidden "
          f"fraction {tl1['overlap_hidden_frac']:.1%} -> "
          f"{tlk['overlap_hidden_frac']:.1%}")
    print(f"done in {time.time() - t0:.1f}s on {engine.device}")


if __name__ == "__main__":
    main()
