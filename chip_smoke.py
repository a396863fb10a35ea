#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printed as it runs; any failure raises and the script exits
non-zero without printing a result:

1. device   the card's name and power limit as ``nvidia-smi`` reports them;
            the hand-written kernels are built from ``csrc/`` (one ``nvcc``
            per source, all at once) and their register use is printed.
2. kernels  every CUDA entry point at main-path shapes (B=8, 32 query and
            8 KV heads, head_dim 64, bf16 arena, buckets 256..1024, slots
            with the scratch sentinel repeated, block tables) against its
            plain PyTorch version on the card, paged == dense bitwise, and
            CUDA-event times of kernel, plain version and
            ``F.scaled_dot_product_attention`` over the gathered rows (a
            yardstick only; the port never calls it), beside the bound.
3. serving  a ``CascadeServer`` with proxy and oracle backends, both
            full-width llama3.2-1b in bf16 (random weights, seeds 1 and 2),
            serving two registered queries over a 32-document corpus, three
            times: paged plane at inflight 1, paged at inflight 3, gather
            plane.  Launch counters are zeroed before each run and read
            after it; every document must resolve, the kernel launch counts
            must match the launches the server made, and preds, confs and
            per-document $ must be bitwise equal across the three runs.
   With ``--profile``: ``torch.profiler`` counts of device kernels, their
   busy time against the wall clock, and the split between our attention
   kernels, cuBLAS products and everything else, for one decode step and
   one serving run.
4. a ``{"kernels": [...]}`` JSON line, then the result line
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
# Kernel against plain version, bf16 outputs.  rtol 2**-7 is one bf16 ulp
# of the output (both sides round f32 to bf16, so a value near a rounding
# edge may land one ulp apart).  Decode accumulates in f32 exactly as its
# plain version does (measured max error 2.4e-7 on the H100), so atol is
# 1e-4; extend rounds the softmax weights to bf16 for the P.V product
# (measured 2.0e-3), so atol is 4e-3, two bf16 ulps at 0.25-0.5.  A mask
# off by a few keys moves an output by ~|v|/400 per key and fails both.
DECODE_TOL = dict(atol=1e-4, rtol=2 ** -7)
EXTEND_TOL = dict(atol=4e-3, rtol=2 ** -7)

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
    path finds each layer's KV cold."""

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
            self.start.record()
            fn()
            self.end.record()
            self.end.synchronize()
            total += self.start.elapsed_time(self.end)
        return total / reps


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
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


def kernel_phase(dev, timer):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    B, Hq, Hkv, Dh = 8, 32, 8, 64
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
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g} "
              f"(tol atol={tol['atol']:g} rtol={tol['rtol']:g}), kernel "
              f"{r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print("kernels: paged == dense bitwise (slots and block tables)")
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


def serve_once(models, params, docs, *, paged: bool, inflight: int):
    from repro_torch.data.tokenizer import HashWordTokenizer
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
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
    for mod in (dec, fla):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, d in enumerate(sorted(docs)):
        for h in handles:
            h.submit(d, docs[d], arrival=float(i))
    srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**dec.LAUNCHES, **fla.LAUNCHES}
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


def profile_phase(models, params, docs) -> None:
    """Where the time goes (``--profile``): ``torch.profiler`` device
    kernels of one paged decode step and of one paged serving run; wall
    clocks come from runs without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    model, p = models["proxy"], params["proxy"]
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
    with profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    _report("paged decode step, B=8, 512 cached keys, 16 layers",
            _device_kernels(prof), wall)

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
    rows = kernel_phase(dev, Timer(dev))
    launches, models, params, docs = serving_phase()
    if "--profile" in sys.argv[1:]:
        profile_phase(models, params, docs)
    for r in rows:
        r["launches"] = launches[r["name"]]
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
