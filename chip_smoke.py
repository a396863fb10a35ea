#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printed as it runs; any failure raises and the script exits
non-zero without printing a result:

1. device   the card's name and power limit as ``nvidia-smi`` reports them;
            the hand-written kernels are built from ``csrc/`` (one ``nvcc``
            per source, all at once) and their register use is printed.
2. kernels  every attention entry point at main-path shapes (B=8, bf16
            arena, buckets 256..1024, slots with the scratch sentinel
            repeated, block tables) twice: at llama3.2-1b's heads (32 query
            / 8 KV, head_dim 64) and at qwen3-1.7b's (16 / 8, head_dim
            128); each against its plain PyTorch version on the card,
            paged == dense bitwise, and CUDA-event times of kernel, plain
            version and ``F.scaled_dot_product_attention`` over the
            gathered rows (a yardstick only; the port never calls it),
            beside the bound.
3. serving  a ``CascadeServer`` with proxy and oracle backends, both
            full-width llama3.2-1b in bf16 (random weights, seeds 1 and 2),
            serving two registered queries over a 32-document corpus, three
            times: paged plane at inflight 1, paged at inflight 3, gather
            plane.  Launch counters are zeroed before each run and read
            after it; every document must resolve, the kernel launch counts
            must match the launches the server made, and preds, confs and
            per-document $ must be bitwise equal across the three runs.
4. build    the paper's construct-and-serve path (Figure 2, steps 1-5) at
            full width: llama3.2-1b proxy, qwen3-1.7b oracle (per-head q/k
            norm), bf16, batch 8, paged plane.  Restructure 28 documents
            (classifier fit on 12, every document reordered through the
            ``relevance_score`` kernel, one launch per document, orders
            equal to those of the plain version's scores), score the six
            proxy candidates through the engine, Algorithm 2 + 4, serve
            16 test documents under the assembled cascade and its strict
            variant (attention launches must match the server's), then the
            oracle alone.  Every document must resolve; an empty assembled
            cascade is a legal outcome with random weights.
5. relevance ``relevance_score`` against its plain version on every
            document of the path, a ragged chunk count with ``len = 0`` and
            ``len > T`` chunks, and 4096 chunks; timed at one document and
            at 4096 chunks, beside its bound.
   With ``--profile``: ``torch.profiler`` counts of device kernels, their
   busy time against the wall clock, and the split between our attention
   kernels, cuBLAS products and everything else, for one decode step of
   each model and one serving run.
6. a ``{"kernels": [...]}`` JSON line (launches: the serving and build
   runs, each counted from zero), then the result line
   ``{"ok": true, "device": {...}}``.

It imports only ``repro_torch`` (from ``src/`` beside this file).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor rate
PEAK_F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
# Kernel against plain version, bf16 outputs.  rtol 2**-7 is one bf16 ulp
# of the output (both sides round f32 to bf16, so a value near a rounding
# edge may land one ulp apart).  Decode accumulates in f32 exactly as its
# plain version does (measured max error 2.4e-7 on the H100), so atol is
# 1e-4; extend rounds the softmax weights to bf16 for the P.V product
# (measured 2.0e-3), so atol is 4e-3, two bf16 ulps at 0.25-0.5.  A mask
# off by a few keys moves an output by ~|v|/400 per key and fails both.
DECODE_TOL = dict(atol=1e-4, rtol=2 ** -7)
EXTEND_TOL = dict(atol=4e-3, rtol=2 ** -7)
# relevance_score against its plain version, f32 scores in (0, 1): both
# sum in f32 in different orders (the kernel sums tokens per column, then
# dots with w; the plain version pools then multiplies), so they differ by
# a few f32 ulps (measured 3.6e-7 at 4096 chunks on the H100; one ulp is
# 6e-8 at 0.5-1).  atol 2e-6 keeps a 5x margin and is tighter than the
# JAX package's own Pallas-vs-reference bound (atol 2e-5, rtol 1e-5); a
# chunk that pooled one row too many or too few moves its score by
# ~|x.w| / (4 len), orders above it.
REL_TOL = dict(atol=2e-6, rtol=0.0)

OPS = {
    "o_orig": "does this opinion overturn a lower court decision",
    "sur_court": "is any lower court mentioned overturn reversed vacated",
}


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


class Timer:
    """Mean device time of one call, from CUDA events around each call;
    a 64 MiB write between calls evicts the 50 MB L2, as the serving
    path finds each layer's KV cold.  A ~2 ms device-side spin is queued
    before the start event, so the host has enqueued the whole call
    before the device reaches it: the events time the device work, not
    the host's launch overhead (which dominates calls shorter than
    ~50 us)."""

    SPIN_CYCLES = 4_000_000

    def __init__(self, dev):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def ms(self, fn, reps: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.start.record()
            fn()
            self.end.record()
            self.end.synchronize()
            total += self.start.elapsed_time(self.end)
        return total / reps


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def sdpa_mask(kv_len, Sq, Skv, q_offset, causal, dev):
    kpos = torch.arange(Skv, device=dev)
    qpos = q_offset + torch.arange(Sq, device=dev)
    m = kpos[None, None, None, :] < kv_len.long()[:, None, None, None]
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])[None, None]
    return m


def kernel_phase(dev, timer, Hq: int, Hkv: int, Dh: int, label: str):
    """The four attention entry points at one model's head shapes."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    B = 8
    N = 17                                   # 16 slots + scratch row 16
    slots = torch.tensor([5, 2, 9, 0, 14, 7, 16, 16], dtype=torch.int32,
                         device=dev)
    rows = []

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    # ---- decode: bucket 1024 arena (S_alloc = 1024 + 64 op reserve)
    S = 1088
    ka, va, q = rand(N, S, Hkv, Dh), rand(N, S, Hkv, Dh), rand(B, Hq, Dh)
    kv_len = torch.tensor([1024, 900, 512, 700, 300, 256, 1, 1],
                          dtype=torch.int32, device=dev)
    out = ops.arena_decode_attention(q, ka, va, slots, kv_len)
    plain = dec.paged_decode_attention_plain(q, ka, va, slots, kv_len)
    torch.testing.assert_close(out.float(), plain.float(), **DECODE_TOL)
    kg, vg = ka[slots.long()], va[slots.long()]
    dense = ops.decode_attention(q, kg, vg, kv_len)
    assert torch.equal(out, dense), "paged decode != dense decode"
    torch.testing.assert_close(
        dense.float(), dec.decode_attention_plain(q, kg, vg, kv_len).float(),
        **DECODE_TOL)
    # block tables at 64-key granularity: a shared leading block per doc
    bt = slots[:, None].repeat(1, S // 64)
    bt[:6, 0] = 16
    bt_out = ops.arena_decode_attention(q, ka, va, slots, kv_len,
                                        block_tables=bt)
    bt_plain = dec.paged_decode_attention_plain(
        q, ka, va, slots, kv_len, block_tables=bt, table_block=64)
    torch.testing.assert_close(bt_out.float(), bt_plain.float(), **DECODE_TOL)
    bt_dense = ops.decode_attention(q, ops._gather_block_rows(ka, bt, 64),
                                    ops._gather_block_rows(va, bt, 64),
                                    kv_len)
    assert torch.equal(bt_out, bt_dense), "block-table decode != dense"

    keys = float(kv_len.sum())
    d_bytes = keys * Hkv * Dh * 2 * 2 + 2 * q.numel() * 2 + 2 * B * 4
    d_flops = 4.0 * Hq * Dh * keys
    qt = q[:, :, None]                                   # [B, Hq, 1, Dh]
    kt, vt = kg.transpose(1, 2), vg.transpose(1, 2)
    mask = sdpa_mask(kv_len, 1, S, 0, False, dev)
    lib = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    b_ms, b_by = bound(d_bytes, d_flops)
    rows.append(dict(
        name="paged_decode_attention", source="src/repro_torch/kernels/"
        "csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:161",
        max_abs_err=max_err(out, plain),
        ms=timer.ms(lambda: ops.arena_decode_attention(q, ka, va, slots,
                                                       kv_len)),
        plain_ms=timer.ms(lambda: dec.paged_decode_attention_plain(
            q, ka, va, slots, kv_len)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    rows.append(dict(
        name="decode_attention", source="src/repro_torch/kernels/"
        "csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:107",
        max_abs_err=max_err(dense, plain),
        ms=timer.ms(lambda: ops.decode_attention(q, kg, vg, kv_len)),
        plain_ms=timer.ms(lambda: dec.decode_attention_plain(q, kg, vg,
                                                             kv_len)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib))

    # ---- extend: bucket 512, fraction 0.25 -> 1.0 (keys 0..512, 384 new)
    S_alloc, Sq, q_off, kv_valid = 576, 384, 128, 512
    ka, va = rand(N, S_alloc, Hkv, Dh), rand(N, S_alloc, Hkv, Dh)
    q = rand(B, Sq, Hq, Dh)
    kv_len = torch.tensor([512, 480, 400, 300, 200, 129, 1, 1],
                          dtype=torch.int32, device=dev)
    kw = dict(kv_valid=kv_valid, q_offset=q_off, kv_len=kv_len)
    out = ops.attention_paged(q, ka, va, slots, **kw)
    plain = fla.paged_flash_attention_plain(q, ka, va, slots, **kw)
    torch.testing.assert_close(out.float(), plain.float(), **EXTEND_TOL)
    kg = ka[slots.long()][:, :kv_valid]
    vg = va[slots.long()][:, :kv_valid]
    dkw = dict(causal=True, q_offset=q_off, kv_len=kv_len)
    dense = ops.attention(q, kg, vg, **dkw)
    assert torch.equal(out, dense), "paged extend != dense extend"
    bt = slots[:, None].repeat(1, S_alloc // 64)
    bt[:6, :2] = 16
    bt_out = ops.attention_paged(q, ka, va, slots, block_tables=bt, **kw)
    bt_dense = ops.attention(
        q, ops._gather_block_rows(ka, bt, 64)[:, :kv_valid],
        ops._gather_block_rows(va, bt, 64)[:, :kv_valid], **dkw)
    assert torch.equal(bt_out, bt_dense), "block-table extend != dense"
    # prefill into the arena (q_offset 0) and a ragged chunk
    for sq, off, kvv in ((256, 0, 256), (77, 300, 377)):
        qq = rand(B, sq, Hq, Dh)
        kl = torch.clamp(kv_len, max=kvv)
        o1 = ops.attention_paged(qq, ka, va, slots, kv_valid=kvv,
                                 q_offset=off, kv_len=kl)
        p1 = fla.paged_flash_attention_plain(qq, ka, va, slots, kv_valid=kvv,
                                             q_offset=off, kv_len=kl)
        torch.testing.assert_close(o1.float(), p1.float(), **EXTEND_TOL)

    kl = np.minimum(kv_len.cpu().numpy(), kv_valid)
    qpos = q_off + np.arange(Sq)
    pairs = float(sum(np.minimum(qpos + 1, k).sum() for k in kl))
    e_bytes = (float(kl.sum()) * Hkv * Dh * 2 * 2 + 2 * q.numel() * 2
               + 2 * B * 4)
    e_flops = 4.0 * Hq * Dh * pairs
    qt = q.transpose(1, 2)
    kt, vt = kg.transpose(1, 2), vg.transpose(1, 2)
    mask = sdpa_mask(kv_len, Sq, kv_valid, q_off, True, dev)
    lib = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    b_ms, b_by = bound(e_bytes, e_flops)
    rows.append(dict(
        name="paged_flash_attention", source="src/repro_torch/kernels/"
        "csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:198",
        max_abs_err=max_err(out, plain),
        ms=timer.ms(lambda: ops.attention_paged(q, ka, va, slots, **kw)),
        plain_ms=timer.ms(lambda: fla.paged_flash_attention_plain(
            q, ka, va, slots, **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    rows.append(dict(
        name="flash_attention", source="src/repro_torch/kernels/"
        "csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:129",
        max_abs_err=max_err(dense, plain),
        ms=timer.ms(lambda: ops.attention(q, kg, vg, **dkw)),
        plain_ms=timer.ms(lambda: fla.flash_attention_plain(q, kg, vg,
                                                            **dkw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    for r in rows:
        r["route"] = "cuda"
        tol = DECODE_TOL if "decode" in r["name"] else EXTEND_TOL
        print(f"kernel {r['name']} [{label}]: max_abs_err "
              f"{r['max_abs_err']:.3g} (tol atol={tol['atol']:g} "
              f"rtol={tol['rtol']:g}), kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(f"kernels [{label}]: paged == dense bitwise (slots and block "
          "tables)")
    return rows


def tenant_cascades():
    from repro_torch.core.tasks import Cascade, Task, TaskConfig
    return [
        Cascade([Task(TaskConfig("proxy", "sur_court", 0.25),
                      {0: 0.6, 1: 0.6}),
                 Task(TaskConfig("proxy", "o_orig", 1.0),
                      {0: 0.65, 1: 0.65})]),
        Cascade([Task(TaskConfig("proxy", "sur_court", 0.25),
                      {0: 0.6, 1: 0.6}),
                 Task(TaskConfig("proxy", "sur_court", 1.0),
                      {0: 0.7, 1: 0.7})]),
    ]


def _zero_counts():
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import relevance_score as rel
    for mod in (dec, fla, rel):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def _counts():
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import relevance_score as rel
    return {**dec.LAUNCHES, **fla.LAUNCHES, **rel.LAUNCHES}


def serve_once(models, params, docs, *, paged: bool, inflight: int):
    from repro_torch.data.tokenizer import HashWordTokenizer
    from repro_torch.serving.engine import CascadeServer, LMBackend
    from repro_torch.serving.scheduler import RESOLVED

    tokz = HashWordTokenizer(vocab_size=128256)
    rates = {"proxy": 0.15e-6, "oracle": 2.50e-6}
    backends = {n: LMBackend(name=n, model=models[n], params=params[n],
                             tokenizer=tokz, rate_per_token=rates[n],
                             paged=paged, device="cuda")
                for n in ("proxy", "oracle")}
    srv = CascadeServer(backends, OPS, n_classes=2, batch_size=8,
                        inflight=inflight, device="cuda")
    handles = [srv.register(c) for c in tenant_cascades()]
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, d in enumerate(sorted(docs)):
        for h in handles:
            h.submit(d, docs[d], arrival=float(i))
    srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    results = {h.query_id: h.result() for h in handles}
    for qid, r in results.items():
        assert set(r.status) == set(docs), f"query {qid}: docs missing"
        bad = {d: s for d, s in r.status.items() if s != RESOLVED}
        assert not bad, f"query {qid}: not resolved {bad}"
    # every stage launch runs one flash extend per layer when it has new
    # tokens and one decode per layer per operation token
    n_layers = models["proxy"].num_layers
    want_flash = want_decode = 0
    for rec in srv.telemetry.launches.items():
        assert rec.ok, rec
        if rec.f_len > rec.cached_len:
            want_flash += n_layers
        want_decode += n_layers * len(tokz.encode(OPS[rec.op_id]))
    fl_key = "paged_flash_attention" if paged else "flash_attention"
    de_key = "paged_decode_attention" if paged else "decode_attention"
    assert counts[fl_key] == want_flash, (counts, want_flash)
    assert counts[de_key] == want_decode, (counts, want_decode)
    n = sum(len(r.status) for r in results.values())
    lat = [x for r in results.values() for x in r.stats.latencies]
    label = f"{'paged' if paged else 'gather'} inflight={inflight}"
    print(f"serve [{label}]: {n} docs terminal and RESOLVED in "
          f"{wall:.3f} s ({n / wall:.2f} docs/s), {srv.stats().batches} "
          f"launches, latency p50 {1e3 * np.quantile(lat, 0.5):.1f} ms "
          f"p99 {1e3 * np.quantile(lat, 0.99):.1f} ms, kernel launches "
          f"{json.dumps(counts)}")
    for qid, r in results.items():
        preds = "".join(str(r.pred[d]) for d in sorted(docs))
        exits = [list(r.exit_stage.values()).count(s) for s in range(3)]
        # per-query $ as an exact sum of the per-document $: the running
        # total's float additions follow completion order, which
        # ahead-of-time dispatch legally changes
        print(f"  query {qid}: ${math.fsum(r.doc_cost.values()):.12g} "
              f"preds {preds} exits {exits[0]}/{exits[1]}/{exits[2]} "
              f"(stage 0/1/2)")
    sig = {qid: (r.pred, r.conf, r.doc_cost) for qid, r in results.items()}
    return sig, counts


def serving_phase():
    from repro_torch.config import resolve
    from repro_torch.configs import get_config
    from repro_torch.data.documents import generate_corpus
    from repro_torch.models.model import LM

    rcfg = resolve(get_config("llama3_2_1b"), tp=1)
    model = LM(rcfg, device="cuda")
    assert model.dtype == torch.bfloat16 and rcfg.base.d_model == 2048
    models = {"proxy": model, "oracle": model}
    params = {"proxy": model.init(seed=1), "oracle": model.init(seed=2)}
    docs = {d.doc_id: d.text for d in generate_corpus(32, seed=0)}
    words = [len(t.split()) for t in docs.values()]
    print(f"serve: llama3.2-1b full width ({rcfg.base.num_layers} layers, "
          f"d_model {rcfg.base.d_model}, vocab {rcfg.padded_vocab}, bf16), "
          f"2 queries x {len(docs)} docs of {min(words)}-{max(words)} words")
    serve_once(models, params, docs, paged=True, inflight=1)   # warm-up
    runs = {}
    for paged, inflight in ((True, 1), (True, 3), (False, 1)):
        runs[(paged, inflight)] = serve_once(models, params, docs,
                                             paged=paged, inflight=inflight)
    base = runs[(True, 1)][0]
    for key, (sig, _) in runs.items():
        assert sig == base, f"run {key} differs from paged inflight=1"
    print("serve: preds, confs and per-document $ bitwise equal across "
          "paged inflight=1, paged inflight=3 and the gather plane")
    launches = {**runs[(True, 1)][1],
                "decode_attention": runs[(False, 1)][1]["decode_attention"],
                "flash_attention": runs[(False, 1)][1]["flash_attention"]}
    return launches, models, params, docs


def build_phase():
    """Construct a cascade from engine scores and serve it (paper Figure
    2, steps 1-5) at full width: llama3.2-1b proxy (seed 1) and
    qwen3-1.7b oracle (seed 2), bf16, batch 8, paged plane.  The launch
    counters are zeroed before step 1 and read after step 5."""
    from repro_torch.core.tasks import Cascade
    from repro_torch.data.documents import generate_corpus
    from repro_torch.kernels import relevance_score as rel
    from repro_torch.kernels.relevance_score import relevance_score_plain
    from repro_torch.launch import construct
    from repro_torch.launch.serve import build_engine, warm_arena
    from repro_torch.serving.scheduler import RESOLVED

    batch = 8
    docs = generate_corpus(28, n_classes=2, avg_lines=16, seed=11)
    dev_ids = [d.doc_id for d in docs[:12]]
    test_ids = [d.doc_id for d in docs[12:]]
    engine = build_engine(batch, None, 64, device="cuda", full_width=True,
                          operations=construct.OPS)
    for name, be in engine.backends.items():
        b = be.model.rcfg.base
        assert be.uses_paged_kv() and be.model.dtype == torch.bfloat16
        print(f"build: {name} {b.name} full width ({b.num_layers} layers, "
              f"d_model {b.d_model}, {b.num_heads}/{b.num_kv_heads} heads, "
              f"head_dim {b.head_dim}, qk_norm {b.qk_norm}, vocab "
              f"{be.model.rcfg.padded_vocab}, bf16)")
    tokz = engine.backends["proxy"].tokenizer

    _zero_counts()
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    # 1. restructure: fit on the dev split, reorder every document
    restr, reordered = construct.restructure(docs, 12, device="cuda")
    torch.cuda.synchronize()
    t_restr = time.perf_counter() - t_path
    n_rel = rel.LAUNCHES["relevance_score"]
    # 3. candidates on the dev split, against the oracle's predictions
    dev_docs = {i: reordered[i] for i in dev_ids}
    oracle_ref = engine.run(Cascade([]), dev_docs)
    assert set(oracle_ref.status.values()) == {RESOLVED}, oracle_ref.status
    oracle_pred = np.asarray([oracle_ref.pred[i] for i in dev_ids])
    scores = construct.score_candidates(
        engine, dev_docs, construct.candidate_configs(), batch)
    cm = construct.doc_cost_model(tokz, list(dev_docs.values()))
    # 4. Algorithm 2 + Algorithm 4
    eligible, cascade, _ = construct.assemble(scores, oracle_pred, cm)
    # 5. two registered queries over the test split, then the oracle
    test_docs = {i: reordered[i] for i in test_ids}
    warm_arena(engine, cascade, test_docs, batch)
    before = _counts()
    served = construct.serve_two_queries(engine, cascade, test_docs)
    torch.cuda.synchronize()
    serve_counts = {k: v - before[k] for k, v in _counts().items()}
    want = {"paged_flash_attention": 0, "paged_decode_attention": 0}
    for rec in engine.telemetry.launches.items():
        assert rec.ok, rec
        n_layers = engine.backends[rec.model].model.num_layers
        if rec.f_len > rec.cached_len:
            want["paged_flash_attention"] += n_layers
        want["paged_decode_attention"] += n_layers * len(
            tokz.encode(construct.OPS[rec.op_id]))
    for k, v in want.items():
        assert serve_counts[k] == v, (k, serve_counts, want)
    oracle_only = engine.run(Cascade([]), test_docs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_path
    counts = _counts()

    assert n_rel == len(docs), (n_rel, len(docs))
    for name, r in (("main", served.main), ("strict", served.strict),
                    ("oracle-only", oracle_only)):
        assert set(r.status) == set(test_ids), name
        bad = {d: st for d, st in r.status.items() if st != RESOLVED}
        assert not bad, f"{name}: not resolved {bad}"
    # the kernel's line orders against the plain version's, same w and b
    w, b = restr.head()
    lens, n_chunks = [], 0
    for d in docs:
        x, lengths = restr.chunk_inputs(d)
        plain = relevance_score_plain(x, lengths, w, b).cpu().numpy()
        assert d.reordered(restr.order_lines(d, plain)).text \
            == reordered[d.doc_id], f"doc {d.doc_id}: kernel order differs"
        lens.append(lengths.cpu().numpy())
        n_chunks += len(lengths)
    lens = np.concatenate(lens)
    T = restr.embedder.tokens("")[0].shape[0]
    fill = float(np.minimum(lens, T).mean() / T)

    res = served.main
    agree = float(np.mean([res.pred[i] == oracle_only.pred[i]
                           for i in test_ids]))
    lat = res.stats.latencies + served.strict.stats.latencies
    print(f"build: granularity {restr.granularity} lines, classifier F1 "
          f"{restr.f1:.4f}")
    print(f"build: {n_chunks} chunks scored over {len(docs)} documents "
          f"({n_rel} relevance_score launches), mean fill "
          f"{fill:.4f} of T={T} token rows, restructure wall "
          f"{t_restr:.3f} s")
    print(f"build: kernel-ordered reorder == plain-ordered reorder for all "
          f"{len(docs)} documents")
    print(f"build: eligible {[t.config.key() for t in eligible]}")
    print(f"build: assembled {[t.config.key() for t in cascade.tasks]}")
    print(f"build: cost ${res.cost:.9g} vs oracle-only "
          f"${oracle_only.cost:.9g} ({res.cost / oracle_only.cost:.4f}x), "
          f"strict ${served.strict.cost:.9g}; agreement with the oracle "
          f"{agree:.4f}")
    print(f"build: served 2 queries x {len(test_ids)} docs, all RESOLVED: "
          f"latency p50 {1e3 * np.quantile(lat, 0.5):.1f} ms p99 "
          f"{1e3 * np.quantile(lat, 0.99):.1f} ms, {served.launches} "
          f"launches, wall {served.wall_s:.3f} s; attention launches "
          f"match the server's")
    print(f"build: path wall {wall:.3f} s, kernel launches "
          f"{json.dumps(counts)}")
    return counts, restr, docs, engine


def relevance_phase(dev, timer, restr, docs):
    """``relevance_score`` against its plain version on the card: every
    document of the path, a ragged chunk count with ``len = 0`` and
    ``len > T`` chunks, and one corpus-scale call (C = 4096); timed at
    the path's shape (the first test document) and at C = 4096."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.relevance_score import relevance_score_plain

    w, b = restr.head()
    err = 0.0
    path_lens = []
    for d in docs:
        x, lengths = restr.chunk_inputs(d)
        k = ops.relevance_score(x, lengths, w, b)
        p = relevance_score_plain(x, lengths, w, b)
        torch.testing.assert_close(k, p, **REL_TOL)
        err = max(err, max_err(k, p))
        path_lens.append(lengths)
    g = torch.Generator(device=dev).manual_seed(3)
    _, T, D = restr.chunk_inputs(docs[0])[0].shape
    all_lens = torch.cat(path_lens)
    cases = {}
    # ragged C, an empty chunk and two overlong ones
    lens = all_lens[:13].clone()
    lens[0], lens[5], lens[9] = 0, T + 7, 3 * T
    cases["ragged"] = lens
    # corpus scale: the path's chunk lengths tiled to 4096 chunks
    cases["corpus"] = all_lens.repeat(4096 // len(all_lens) + 1)[:4096]
    xs = {}
    for name, lens in cases.items():
        x = torch.randn((len(lens), T, D), generator=g, device=dev)
        k = ops.relevance_score(x, lens.contiguous(), w, b)
        p = relevance_score_plain(x, lens, w, b)
        torch.testing.assert_close(k, p, **REL_TOL)
        err = max(err, max_err(k, p))
        xs[name] = (x, lens.contiguous())
    torch.testing.assert_close(      # len 0 scores sigmoid(b)
        ops.relevance_score(*xs["ragged"], w, b)[:1], torch.sigmoid(b),
        **REL_TOL)

    def row(x, lengths):
        C = x.shape[0]
        n = float(torch.clamp(lengths, 0, T).sum())
        nbytes = n * D * 4 + 12 * C + 4 * D
        b_ms, b_by = bound(nbytes, 2.0 * n * D, PEAK_F32_FLOPS)
        return dict(
            ms=timer.ms(lambda: ops.relevance_score(x, lengths, w, b)),
            plain_ms=timer.ms(lambda: relevance_score_plain(x, lengths, w,
                                                            b)),
            bound_ms=b_ms, bound_by=b_by, C=C)

    path = row(*restr.chunk_inputs(docs[12]))
    corpus = row(*xs["corpus"])
    for label, r in (("path, one document", path), ("corpus", corpus)):
        print(f"kernel relevance_score [{label}, C={r['C']}]: max_abs_err "
              f"{err:.3g} (tol atol={REL_TOL['atol']:g} "
              f"rtol={REL_TOL['rtol']:g}), kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})")
    return dict(
        name="relevance_score", route="cuda",
        source="src/repro_torch/kernels/csrc/relevance_score.cu",
        replaces="src/repro/kernels/relevance_score.py:41",
        max_abs_err=err, ms=path["ms"], plain_ms=path["plain_ms"],
        bound_ms=path["bound_ms"], bound_by=path["bound_by"],
        library_ms=None)


def _device_kernels(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _kernel_class(name: str) -> str:
    if "decode_attention_kernel" in name:
        return "decode attention (ours)"
    if "flash_attention_kernel" in name:
        return "flash attention (ours)"
    if any(t in name.lower() for t in ("gemm", "gemv", "nvjet", "xmma",
                                        "cutlass", "splitk")):
        return "matrix products (cuBLAS)"
    return "other (elementwise, norms, copies, indexing)"


def _report(label: str, kernels, wall_ms: float) -> None:
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"profile [{label}]: {len(kernels)} kernel launches, device busy "
          f"{busy:.3f} ms of {wall_ms:.3f} ms wall (idle share "
          f"{max(1.0 - busy / wall_ms, 0.0):.3f})")
    by: dict = {}
    for e in kernels:
        c = by.setdefault(_kernel_class(e.name), [0, 0.0])
        c[0] += 1
        c[1] += e.time_range.elapsed_us() / 1e3
    for cls, (n, ms) in sorted(by.items(), key=lambda kv: -kv[1][1]):
        print(f"profile [{label}]:   {cls}: {n} launches, {ms:.3f} ms "
              f"({ms / busy:.1%} of busy)")
    names: dict = {}
    for e in kernels:
        c = names.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += e.time_range.elapsed_us() / 1e3
    for name, (n, ms) in sorted(names.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"profile [{label}]:     {n:6d} x {ms:9.3f} ms  {name[:100]}")


def _profile_decode_step(model, p, label: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    arena = model.init_states(9, 576)
    slots = torch.arange(8, dtype=torch.int32, device="cuda")
    pos = torch.full((8,), 512, dtype=torch.int32, device="cuda")
    tok = torch.full((8,), 100, device="cuda")

    def step():
        with torch.no_grad():
            model.decode_step(p, tok, arena, pos, slots=slots)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 10 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    _report(f"paged decode step, {label}, B=8, 512 cached keys, "
            f"{model.num_layers} layers", _device_kernels(prof), wall)


def profile_phase(models, params, docs, oracle) -> None:
    """Where the time goes (``--profile``): ``torch.profiler`` device
    kernels of one paged decode step of each model (the llama3.2-1b of
    the serving phase, the qwen3-1.7b oracle of the build phase) and of
    one paged serving run; wall clocks come from runs without the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    _profile_decode_step(models["proxy"], params["proxy"], "llama3.2-1b")
    _profile_decode_step(oracle.model, oracle.params, "qwen3-1.7b")

    sub = {d: docs[d] for d in sorted(docs)[:8]}
    t0 = time.perf_counter()
    serve_once(models, params, sub, paged=True, inflight=1)
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=acts) as prof:
        serve_once(models, params, sub, paged=True, inflight=1)
    _report("paged serving run, 2 queries x 8 docs, inflight=1",
            _device_kernels(prof), wall)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    print(device_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {len(_build.SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        regs = sorted({ln.split("Used ")[1].split(",")[0]
                       for ln in _build.log_path(name).read_text().splitlines()
                       if "Used " in ln})
        print(f"build: {name}: {', '.join(regs)}")
    timer = Timer(dev)
    rows = kernel_phase(dev, timer, 32, 8, 64, "llama3.2-1b shapes")
    kernel_phase(dev, timer, 16, 8, 128, "qwen3-1.7b shapes")
    launches, models, params, docs = serving_phase()
    build_launches, restr, build_docs, engine = build_phase()
    rows.append(relevance_phase(dev, timer, restr, build_docs))
    if "--profile" in sys.argv[1:]:
        profile_phase(models, params, docs, engine.backends["oracle"])
    for r in rows:
        # each path's run, counted from zero: serving, then build
        r["launches"] = launches[r["name"]] + build_launches[r["name"]]
        assert r["launches"] > 0, r["name"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
