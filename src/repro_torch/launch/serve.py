"""Serving entry point: multi-tenant continuous-batching cascade serving
over concurrent arrival streams.

    python -m repro_torch.launch.serve --docs 32 --rate 20 --batch 8 \\
        --tenants 2 [--device cuda|cpu] [--full-width]

Simulates a production document feed: each tenant registers its own
cascade on ONE shared ``serving.engine.CascadeServer`` and its Poisson
arrivals are submitted as they land on the wall clock.  The request loop
packs launches across stages AND across tenants (documents from different
queries that share a static signature ride one launch), and per-tenant
latency (submit -> resolve) is reported as p50/p99 alongside batch
occupancy, KV-cache hit rate, evictions, and shared arena bytes.
``--slot-budget`` / ``--byte-budget`` exercise the arena memory-control
paths (preemption + re-prefill; bytes or slots, whichever binds first).

The backends are a llama3.2-1b proxy and a qwen3-1.7b oracle with random
weights from seeds 1 and 2: reduced (2 layers, vocab 512, f32) by
default, or at full width in bf16 with ``--full-width``.
``build_engine(oracle_arch="gemma3_27b")`` puts the paper's oracle class,
sliding-window gemma3, behind the proxy instead (on the gather plane:
its ring caches are not paged); ``proxy_arch``/``oracle_arch`` take any
ported architecture: ``qwen2_vl_2b`` and ``phi3_5_moe`` serve on the paged
plane, ``xlstm_350m`` and ``recurrentgemma_2b`` (recurrent state) on the
gather plane.  ``--device``
defaults to the CUDA device (the hand-written kernels); ``cpu`` runs the
plain PyTorch versions.

The module also exports the stream loops: ``poisson_arrivals``,
``drive_request_loop`` (single-query ``CascadeEngine``), and
``drive_server`` (N concurrent streams on one server).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..config import resolve
from ..configs import get_config, get_reduced
from ..core.tasks import Cascade, Task, TaskConfig
from ..data.documents import generate_corpus
from ..data.tokenizer import HashWordTokenizer
from ..models.model import LM
from ..models.runtime import DeviceLike
from ..serving.engine import (CascadeEngine, CascadeServer, EngineResult,
                              LMBackend, QueryHandle)

# the full-width tokenizer's vocabulary: llama3.2-1b's (128256), or the
# smaller vocabulary of a backend that has one (phi3.5-moe 32064, xlstm
# 50304), so every token id is in range for both models
FULL_VOCAB = 128256
REDUCED_VOCAB = 512


def poisson_arrivals(doc_ids, rate: float, seed: int = 0
                     ) -> Dict[int, float]:
    """Arrival offsets (seconds from stream start) with exponential gaps."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, len(doc_ids))
    return dict(zip(doc_ids, np.cumsum(gaps)))


def drive_request_loop(
    engine: CascadeEngine,
    cascade: Cascade,
    docs: Mapping[int, str],
    arrivals: Mapping[int, float],
    oracle_model: str = "oracle",
) -> Tuple[EngineResult, float]:
    """Run one streaming session against the wall clock.

    Documents are submitted the moment their arrival offset elapses — i.e.
    mid-cascade, between launches, not at stage boundaries — and the
    engine steps whenever work is ready.  The *scheduled* arrival is
    passed as the latency anchor (``arrival_ts``), so recorded latencies
    include any queueing delay.  Returns (result, wall seconds).
    """
    engine.start(cascade, oracle_model)
    order = sorted(docs, key=lambda d: (arrivals[d], d))
    t0 = time.perf_counter()
    i = 0
    while i < len(order) or engine.pending():
        now = time.perf_counter() - t0
        while i < len(order) and arrivals[order[i]] <= now:
            d = order[i]
            engine.submit(d, docs[d], arrival=arrivals[d],
                          arrival_ts=t0 + arrivals[d])
            i += 1
        if engine.pending():
            engine.step()
        elif i < len(order):
            time.sleep(min(arrivals[order[i]] - now, 0.05))
    return engine.result(), time.perf_counter() - t0


def drive_server(
    server: CascadeServer,
    streams: Sequence[Tuple[QueryHandle, Mapping[int, str],
                            Mapping[int, float]]],
) -> Tuple[Dict[int, EngineResult], float]:
    """Run N concurrent query streams against the wall clock on ONE server.

    ``streams`` is ``[(handle, docs, arrivals), ...]`` — every handle must
    be registered on ``server``; arrival offsets share one time axis, so
    the streams genuinely interleave and documents from different queries
    merge into shared launches whenever their signatures agree.  The
    SCHEDULED arrival anchors each latency measurement (pre-submit
    queueing counts).  Returns ({query_id: EngineResult}, wall seconds).
    """
    events: List[Tuple[float, int, int, QueryHandle, str]] = []
    for handle, docs, arrivals in streams:
        for d in docs:
            events.append((arrivals[d], handle.query_id, d, handle, docs[d]))
    events.sort(key=lambda e: e[:3])
    t0 = time.perf_counter()
    i = 0
    while i < len(events) or server.pending():
        now = time.perf_counter() - t0
        while i < len(events) and events[i][0] <= now:
            arr, _, d, handle, text = events[i]
            handle.submit(d, text, arrival=arr, arrival_ts=t0 + arr)
            i += 1
        if server.pending():
            server.step()
        elif i < len(events):
            time.sleep(min(events[i][0] - now, 0.05))
    return ({h.query_id: h.result() for h, _, _ in streams},
            time.perf_counter() - t0)


def warm_arena(engine: CascadeEngine, cascade: Cascade,
               docs: Mapping[int, str], batch_size: int) -> None:
    """Warm the server before a timed or streamed session.

    The port compiles nothing per launch signature (PyTorch runs eagerly)
    and pads every launch to the server's batch size, so the narrow
    partial launches of a stream run the same shapes as full ones.  One
    run at the server's width, with thresholds forced IMPOSSIBLE so every
    warm document walks every stage, touches every stage's shapes and
    grows each bucket's arena to the corpus's live set.  ``batch_size``
    is kept for the signature of the JAX package's ``warm_arena`` and
    must not exceed the server's width.
    """
    if batch_size > engine.batch_size:
        raise ValueError(f"batch_size {batch_size} exceeds the server's "
                         f"launch width {engine.batch_size}")
    forced = Cascade([
        Task(t.config, {c: 2.0 for c in range(engine.n_classes)})
        for t in cascade.tasks])
    engine.run(forced, docs)


def build_engine(batch_size: int, slot_budget: Optional[int],
                 retire_after: int, proxy_arch: str = "llama3_2_1b",
                 oracle_arch: str = "qwen3_1_7b",
                 byte_budget: Optional[int] = None, *,
                 device: DeviceLike = "cuda",
                 full_width: bool = False,
                 operations: Optional[Mapping[str, str]] = None
                 ) -> CascadeEngine:
    """Untrained proxy/oracle backends with random weights (seeds 1, 2).

    Reduced configs (2 layers, vocab 512, f32) by default, the mechanics
    demo the JAX package runs on the CPU; ``full_width=True`` builds the
    published widths in bf16 (for the card).  ``operations`` replaces the
    two default operation prompts.  Returns a ``CascadeEngine``
    — which IS a ``CascadeServer``, so callers can either drive the
    single-query compatibility API (``run``) or ``register`` several
    queries on it.
    """
    vocab = REDUCED_VOCAB
    if full_width:
        vocab = min(FULL_VOCAB, get_config(proxy_arch).vocab_size,
                    get_config(oracle_arch).vocab_size)
    tokz = HashWordTokenizer(vocab_size=vocab)

    def mk(name, arch, seed, rate):
        cfg = get_config(arch) if full_width else get_reduced(
            arch, dtype="float32", vocab_size=REDUCED_VOCAB, num_layers=2)
        m = LM(resolve(cfg, tp=1), device=device)
        return LMBackend(name=name, model=m, params=m.init(seed=seed),
                         tokenizer=tokz, rate_per_token=rate,
                         slot_budget=slot_budget, byte_budget=byte_budget,
                         retire_after=retire_after, device=device)

    ops = dict(operations or {
        "o_orig": "does this opinion overturn a lower court decision",
        "sur_court": "is any lower court mentioned overturn reversed vacated",
    })
    backends = {"proxy": mk("proxy", proxy_arch, 1, 0.15e-6),
                "oracle": mk("oracle", oracle_arch, 2, 2.50e-6)}
    return CascadeEngine(backends, ops, n_classes=2, batch_size=batch_size,
                         device=device)


def tenant_cascades(n: int) -> List[Cascade]:
    """``n`` distinct query cascades that still OVERLAP in signatures.

    All tenants open with the same cheap surrogate screen (so their
    stage-0 launches merge), then diverge: even tenants escalate to the
    full-document original operation, odd tenants re-run the surrogate at
    full length with tighter thresholds.  The oracle fall-through is
    shared by construction.
    """
    out = []
    for k in range(n):
        if k % 2 == 0:
            out.append(Cascade([
                Task(TaskConfig("proxy", "sur_court", 0.25),
                     {0: 0.6, 1: 0.6}),
                Task(TaskConfig("proxy", "o_orig", 1.0), {0: 0.65, 1: 0.65}),
            ]))
        else:
            out.append(Cascade([
                Task(TaskConfig("proxy", "sur_court", 0.25),
                     {0: 0.6, 1: 0.6}),
                Task(TaskConfig("proxy", "sur_court", 1.0),
                     {0: 0.7, 1: 0.7}),
            ]))
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=32,
                    help="documents per tenant stream")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="mean Poisson arrivals per second, per tenant")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tenants", type=int, default=2,
                    help="concurrent queries registered on one server")
    ap.add_argument("--slot-budget", type=int, default=None,
                    help="per-backend live-slot cap (eviction pressure)")
    ap.add_argument("--byte-budget", type=int, default=None,
                    help="per-backend arena byte cap (eviction pressure)")
    ap.add_argument("--retire-after", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain "
                         "versions)")
    ap.add_argument("--full-width", action="store_true",
                    help="published widths in bf16 instead of the reduced "
                         "2-layer f32 models")
    ap.add_argument("--trace-out", type=str, default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace-event JSON of the "
                         "measured serving pass (enables level='trace' "
                         "telemetry; open at https://ui.perfetto.dev)")
    args = ap.parse_args(argv)

    server = build_engine(args.batch, args.slot_budget, args.retire_after,
                          byte_budget=args.byte_budget, device=args.device,
                          full_width=args.full_width)
    if args.trace_out:
        server.telemetry.level = "trace"
    cascades = tenant_cascades(args.tenants)

    # one corpus, sliced into per-tenant streams on a shared time axis
    corpus = generate_corpus(args.docs * args.tenants, avg_lines=12,
                             seed=args.seed)
    docs = {d.doc_id: d.text for d in corpus}
    ids = sorted(docs)
    streams_docs = [{d: docs[d] for d in ids[k::args.tenants]}
                    for k in range(args.tenants)]

    # warm pass over the COMBINED corpus; tenants sharing a cascade
    # signature share one warm pass
    distinct = {tuple(t.config.key() for t in c.tasks): c for c in cascades}
    for cascade in distinct.values():
        warm_arena(server, cascade, docs, args.batch)

    server.reset()
    handles = [server.register(c) for c in cascades]
    streams = [
        (h, sd, poisson_arrivals(sorted(sd), args.rate, args.seed + k))
        for k, (h, sd) in enumerate(zip(handles, streams_docs))]
    results, wall = drive_server(server, streams)

    n = sum(len(r.pred) for r in results.values())
    print(f"streamed {n} docs ({args.tenants} tenants x "
          f"{args.docs}) on {server.device} in {wall:.2f}s "
          f"({n / max(wall, 1e-9):.1f} docs/s; "
          f"arrival rate {args.rate}/s per tenant)")
    for h in handles:
        r = results[h.query_id]
        st = r.stats
        exits = [r.exit_stage[d] for d in r.pred]
        print(f"  query {h.query_id}: p50 "
              f"{1e3 * st.latency_quantile(0.5):.0f} ms  p99 "
              f"{1e3 * st.latency_quantile(0.99):.0f} ms; "
              f"cache hit {st.cache_hit_rate():.1%}; "
              f"cost ${r.cost * 1e3:.4f}m; exit stages " + ", ".join(
                  f"{s}:{exits.count(s)}" for s in sorted(set(exits))))
    agg = server.stats()
    print(f"server: {agg.batches} launches; occupancy "
          f"{server.occupancy():.2f} docs/launch; evictions "
          f"{agg.evictions}; retired buckets {agg.retired_buckets}")
    print("arena bytes " + ", ".join(
        f"{m}={be.arena_nbytes():,}" for m, be in server.backends.items()))
    tl = server.telemetry_snapshot()["timeline"]
    print(f"timeline: sched {1e3 * tl['sched_s']:.1f} ms, host "
          f"{1e3 * tl['host_s']:.1f} ms, dispatch "
          f"{1e3 * tl['dispatch_s']:.1f} ms, device "
          f"{1e3 * tl['device_s']:.1f} ms (host wait), idle wait "
          f"{1e3 * tl['idle_wait_s']:.1f} ms, gc {1e3 * tl['gc_s']:.1f} ms")
    print(f"phases: enqueue extend {1e3 * tl['extend_dispatch_s']:.1f} ms, "
          f"decode {1e3 * tl['decode_dispatch_s']:.1f} ms; device extend "
          f"{1e3 * tl['extend_device_s']:.1f} ms, decode "
          f"{1e3 * tl['decode_device_s']:.1f} ms, mean gap between "
          f"launches {tl['mean_launch_gap_ms']:.3f} ms (device clock; 0 "
          f"without one)")
    if args.trace_out:
        from ..serving.telemetry import write_chrome_trace
        write_chrome_trace(server.telemetry, args.trace_out)
        print(f"wrote Perfetto trace to {args.trace_out} "
              f"(open at https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
