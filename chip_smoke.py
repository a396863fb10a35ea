#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --distributed-only    # phase 6's distributed
                                                # part alone, every card

Phases, each printed as it runs; any failure raises and the script exits
non-zero without printing a result:

1. device   the card's name and power limit as ``nvidia-smi`` reports them;
            the hand-written kernels are built from ``csrc/`` (one ``nvcc``
            per source, all at once) and their registers and spills are
            printed (decode and flash attention per kernel and head_dim;
            the decode kernels and the extend tensor-core body must not
            spill at head_dim 64, 128 and 256;
            ``relevance_score`` must not spill at any width); then the
            timer's floor, an empty launch timed per call and back to
            back.  Each phase's wall is printed as ``phase <name>: wall``.
2. kernels  every attention entry point at main-path shapes (B=8, bf16
            arena, buckets 256..1024, slots with the scratch sentinel
            repeated, block tables) twice: at llama3.2-1b's heads (32 query
            / 8 KV, head_dim 64) and at qwen3-1.7b's (16 / 8, head_dim
            128); each against its plain PyTorch version on the card,
            paged == dense bitwise, and CUDA-event times of kernel, plain
            version and ``F.scaled_dot_product_attention`` over the
            gathered rows (a yardstick only; the port never calls it),
            beside the bound.  Decode also at the split-KV chunk edges
            (kv_len 0, 1, C-1, C, C+1, 2C, S, S+5), and bitwise: two calls
            agree, and each sequence alone (the other rows the scratch
            sentinel) equals its row of the batch; extend likewise, for
            the paged and the dense entry.  Then ``kernels [prefix
            tables]``: decode and extend through block tables that mix a
            pinned prefix row with private rows (table block 16: two whole
            shared columns; 512: a copy-on-write remainder), bitwise equal
            to the same kernels over materialized slot rows and within the
            tolerances of the plain versions, at both models' heads.
            ``kernels [gemma3-27b shapes, window 1024]``: the dense flash
            and decode entries at gemma3's heads (32 query / 16 KV,
            head_dim 128): flash as a 2048-token prefill (the window bites)
            and a 512-query extend at ``q_offset`` 1536, decode over a full
            and a partly filled 1024-slot ring; against the plain
            versions, two calls and each sequence alone bitwise, timed
            beside SDPA with a boolean window mask and the bound.
            ``kernels [recurrentgemma-2b shapes, head_dim 256, window
            2048]``: the same at 10 query / 1 KV heads, head_dim 256: flash
            as a 4096-token prefill (B=2) and a 512-query extend at
            ``q_offset`` 3584, decode over a full and a partly filled
            2048-slot ring.  ``kernels [recurrentgemma f32]``: the
            decode kernel over an f32 cache at those heads (a full ring
            and the chunk-edge ``kv_len``; dense, slots, block tables and
            the log-sum-exp mode; ``f32_decode_kernel_phase``).  Then the
            four entry points again at qwen2-vl-2b's heads (12 / 2,
            head_dim 128), phi3.5-moe's (32 / 8, head_dim 128) and
            dbrx-132b's (48 / 8, head_dim 128: a group of 6, two query
            heads a decode block).  ``kernels [whisper-base]``: the dense
            flash kernel at whisper's heads (8 / 8, head_dim 64,
            bidirectional): the encoder's 1536 frames, cross-attention of
            1 and of 64 queries over 1536 keys; against the plain version,
            two calls bitwise, timed beside SDPA and the bound.
            ``grad [attention]``: ``FlashAttentionFn`` (the kernel's
            forward, the PyTorch backward ``flash_attention_grad``)
            against autograd through the plain version within
            ``GRAD_REL_TOL`` of each gradient's peak, two calls bitwise
            equal, at llama3.2-1b's training shapes (B 2, 2048, causal,
            ragged ``kv_len``), whisper's encoder and cross shapes and
            gemma3's window 1024; the backward's time beside the kernel's
            forward and SDPA's forward plus backward.
3. serving  a ``CascadeServer`` with proxy and oracle backends, both
            full-width llama3.2-1b in bf16 (random weights, seeds 1 and 2),
            serving two registered queries over a 32-document corpus, three
            times: paged plane at inflight 1, paged at inflight 3, gather
            plane.  Launch counters are zeroed before each run and read
            after it; every document must resolve, the kernel launch counts
            must match the launches the server made, and preds, confs and
            per-document $ must be bitwise equal across the three runs.
            ``serve [seed engine]``: the same models and corpus through
            the port's ``SeedCascadeEngine`` (per-document dict cache,
            every prefill and extend through the flash kernel) and its
            arena ``CascadeEngine.run`` on the forced ladder of
            ``benchmarks/serve_engine.py`` (thresholds 2.0, batch 8):
            every document resolved in both, new and cached tokens,
            batches and $ the same; the preds' agreement, docs/s and
            ``host_overhead_s`` of each.
            ``serve [prefix]``: the same queries over longer operations on
            the doc-before-op plane and on the prefix plane at layout
            blocks 16 and 512, inflight 1 and 3: all resolved, kernel
            launches matching the server's (op-prefix prefills included),
            inflight=3 == inflight=1 bitwise, every pinned row bitwise as
            prefilled after the drain, and a same-op ladder whose
            per-document $ equals the doc-before-op plane's exactly.
            ``serve [chaos]``: a seeded chaos drain (launch failures, NaN
            confidences, latency spikes, one arena loss, two tenants, one
            expired deadline), then a crash after four steps and a warm
            restart from the journal; every check printed as a boolean and
            required true.
            ``gemma3``: full-width gemma3-27b (random bf16 weights, seed 2)
            cut to 8 layers (``reduced: num_layers 62 -> 8``): ring decode
            after a 1536-token prefill, and after a 1024 prefill plus a
            512 extend, against the cacheless forward's logits at the same
            positions (bound ``GEMMA3_LOGIT_TOL``).  ``serve [gemma3
            oracle]``: the llama3.2-1b proxy (paged plane) beside that
            gemma3 oracle (gather plane), two queries over 32 documents,
            8 of them 990-1024 tokens (bucket 1024, so the op-suffix
            decode wraps the rings; no bucket longer than the window), a
            warm-up, then inflight 1 and 3: all resolved, launches
            matching the server's per plane, inflight=3 == inflight=1
            bitwise.
            ``models [families]``: qwen2-vl-2b (28 layers), phi3.5-moe cut
            to 16 layers (``reduced: num_layers 32 -> 16``), xlstm-350m
            (24) and recurrentgemma-2b (26), full width, random bf16
            weights: the serve path's logits against the cacheless
            forward (``family_model_phase``).  ``serve [moe oracle]``:
            the qwen2-vl proxy and the phi3.5-moe oracle on the paged
            plane, the two tenant cascades over the serving corpus, a
            warm-up, inflight 1 and 3: all resolved, launches matching,
            inflight=3 == inflight=1 bitwise.  ``serve [recurrent]``: the
            xlstm proxy and the recurrentgemma oracle on the gather plane,
            the tenants' first stage at fraction 0.5 (at 0.25 a bucket-512
            document would extend the mLSTM by 384 tokens, which the
            reference's chunking refuses): all resolved, launches
            matching, two inflight=1 runs bitwise equal, and the count of
            results that differ at inflight 3 printed (a recycled row
            hands its recurrent state to the next document, as in the
            reference).  ``models [recurrentgemma-2b f32]``: the model
            built in f32 (every ring f32): prefill 1024 and 32 decode
            steps through the f32 head_dim-256 decode kernel against the
            cacheless forward within ``RG_F32_TOL``.  ``models
            [dbrx-132b]``: full width cut to 4 of 40 layers (``reduced:
            num_layers 40 -> 4``), the family check with 32 decode steps
            after each prefill at the published capacity factor 1.25
            (held where both sides made the same drop decisions) and at
            ``DBRX_CHECK_CF`` (no drops, every position held); ``serve
            [dbrx oracle]``: the llama3.2-1b proxy and the cut dbrx
            oracle on the paged plane, a warm-up and a drain at inflight
            1, every document resolved.
4. build    the paper's construct-and-serve path (Figure 2, steps 1-5) at
            full width: llama3.2-1b proxy, qwen3-1.7b oracle (per-head q/k
            norm), bf16, batch 8, paged plane.  Restructure 28 documents
            (classifier fit on 12, every document's chunks scored by one
            ``relevance_score`` launch per feed of up to 4096 chunks, one
            here; each document's order equal to that of the plain
            version's scores), score the six proxy candidates through the
            engine, Algorithm 2 + 4, serve 16 test documents under the
            assembled cascade and its strict variant (attention launches
            must match the server's), then the oracle alone.  Every
            document must resolve; an empty assembled cascade is a legal
            outcome with random weights.
5. relevance ``relevance_score`` against its plain version on every
            document of the path, on the path's corpus in one launch, on a
            ragged chunk count with ``len = 0`` and ``len > T`` chunks, and
            on 4096 chunks; bitwise batch invariance and two calls; timed
            at one document, at the path's corpus and at 4096 chunks, per
            call (``ms``) and back to back (``stream_ms``), beside its
            bound.  Then the build path's restructure step rerun in its
            parts (fit, head, host embedding, enqueue, wait, reorder; copy
            and kernel on the device).
   With ``--profile``: ``torch.profiler`` counts of device kernels, their
   busy time against the wall clock, and the split between our attention
   kernels, cuBLAS products and everything else, for one decode step of
   each model, one serving run, the same-op ladder of ``serve [prefix]``
   on each layout, a gemma3-oracle serving run, and a drain of 4
   documents in each of the moe-oracle and recurrent cells.
6. training (after the earlier phases' models are freed)
            ``train [llama3.2-1b]``: full width and depth, bf16
            parameters, f32 moments (~16 GB of state): every leaf a
            finite nonzero gradient; one step timed in its parts
            (forward, backward, optimizer; the attention backward and
            forward by CUDA events); 20 steps of ``make_train_step`` on
            ``SyntheticLMTask(vocab 128256, seq 2048)``, batch 2, every
            loss finite and the mean of the last five below that of the
            first five, the trajectory,
            step wall and peak memory printed; a ``Checkpointer``
            checkpoint restored bitwise, 2 resumed steps held against 2
            straight ones within twice the spread of two resumed runs.
            ``train [dbrx-132b]``: two steps of ``launch/specs
            .build_case("dbrx_132b", "train_4k", mesh)``'s sharded step
            on a world-1 NCCL mesh, full width cut to 1 layer, batch 1 x
            4096, ZeRO-1 moments; then the mesh-less optimizer's steps
            from the same init: losses and every parameter bitwise equal.
            ``distributed``: (a) ``decode_attention_lse`` over four
            32768-key shards of a bf16 cache of 131072 keys at
            llama3.2-1b's heads, merged by the rule of
            ``sp_decode_attention`` and held within ``DECODE_TOL`` of the
            decode kernel over the whole cache and of the plain version
            at kv_len 0, 1, 32767, 32768, 32769, 98304, 131072; one
            shard's (acc, l, m) against ``decode_attention_lse_plain``;
            two calls bitwise; per-shard kernel, plain, SDPA and bound
            times.  (b) ``distributed: world <n>``, one NCCL rank per
            visible card (spawned, TCP rendezvous on 127.0.0.1, timeouts
            on the join and the collectives) on an (n, 1) ``data`` x
            ``model`` mesh; at n = 1 the checks that need two ranks are
            named as not run; at n >= 2 they run (``_dist_multi``: the
            rings bitwise against their hops simulated, the MoE's ep/tp
            against ``tp_dense``, from n = 4 the int8 pod hop within
            amax / 127).  Each rank: ``sp_decode_attention`` over
            its slice of (a)'s cache against (a)'s merged output;
            ``compressed_psum`` of a tensor of llama3.2-1b's parameter
            count (error <= amax / 127); 3 data-parallel steps of
            full-width llama3.2-1b at batch 2 x 2048 a rank through each
            of the port's two data-parallel steps: the replicated one of
            ``make_train_step(model, mesh)`` (the launcher's; the
            gradients all-reduced by ``dp_reduce_grads``) and
            ``build_case``'s train step with ZeRO-1 moments (each at
            n = 1 bitwise equal to the mesh-less step; step wall and the
            gradient reduction's share); at n = 1 the bf16 control of
            the tensor-parallel check (``_tp_control``); at n >= 2 also
            ep_a2a's gradients against tp_dense's and the tensor-parallel
            step on a (1, n) mesh against the mesh-less one (loss and
            every gathered gradient); a ``sp_decode=True`` LM
            (prefill 8192, 32 decode steps) against the mesh-less LM
            within ``FAMILY_LOGIT_TOL``, ``decode_attention_lse``
            launches counted.
            ``models [whisper-base]``: full width and depth (6 + 6
            layers, 1536 frames, vocab 51865), bf16: encode, prefill 64
            tokens into caches of 128, 32 decode steps; the logits against
            the cacheless forward within ``FAMILY_LOGIT_TOL``, launches of
            the flash and decode kernels counted.  ``train
            [whisper-base]``: 5 steps of ``make_train_step`` on 448-token
            sequences with seeded ``frame_emb``.
            ``dryrun [cells]``: ``python -m repro_torch.launch.dryrun
            --all --mesh single`` (a subprocess; every supported (arch x
            shape) cell on the 16 x 16 mesh of a fake world, each in a
            process of its own), its roofline table at this card's peaks
            (``launch.roofline.card_peaks``), FAILED rows with their
            exceptions; every attention decoder's cell but gemma3's
            ``long_500k`` must run.  Then the world-1 cells: each
            attention decoder's ``decode_32k`` and ``prefill_32k`` cut to
            one repetition of its block pattern, counted by the dry-run
            on a 1 x 1 mesh; a ``prefill_32k`` cell whose estimate
            exceeds ``WORLD1_FIT`` of the card is counted again with its
            batch cut (halved from 32 until the estimate fits); those
            that fit run on it over an NCCL world of one.  Each cell's
            first step records the arguments and result of its kernel's
            first launch at each distinct shape: a second call must give
            the same bits, and the result must lie within ``DECODE_TOL``
            (decode, also at a ragged ``kv_len``) or ``EXTEND_TOL``
            (prefill, on ``WORLD1_PLAIN_QROWS`` query rows at the start,
            middle and end of the first and last sequence) of the plain
            version on the same tensors.  Then FLOPs, bytes, memory, the
            roofline bound, the median step, the share of the roofline
            and the measured peak over the estimate (within
            ``WORLD1_MEM_BAND``), finite logits, the kernel's launches.
7. the script's wall time, a ``{"kernels": [...]}`` JSON line (launches:
   the serving, the seed and arena engines' timed runs, prefix (block
   16, inflight 1), chaos, gemma3-oracle
   (inflight 1), the families' model checks, moe-oracle and recurrent
   serving (inflight 1), the f32 recurrentgemma check, dbrx's model check
   and serving, build, llama3.2-1b and dbrx training, the distributed
   phase's data-parallel steps and sp-decode LM, whisper's model check
   and training runs, and the world-1 dry-run cells, each counted from
   zero; bounds from each kernel module's ``work`` at the card's peaks;
   ``relevance_score`` also carries ``stream_ms``), then the result line
   ``{"ok": true, "device": {...}}``.

It imports only ``repro_torch`` (from ``src/`` beside this file).
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
# Kernel against plain version, bf16 outputs.  rtol 2**-7 is one bf16 ulp
# of the output (both sides round f32 to bf16, so a value near a rounding
# edge may land one ulp apart).  Decode accumulates in f32 exactly as its
# plain version does (measured max error 2.4e-7 on the H100), so atol is
# 1e-4.  Extend's tensor-core body multiplies bf16 scores and rounds the
# softmax weights to bf16 for the P.V product, where the plain version
# keeps them in f32: measured max error 3.9e-3 at llama3.2-1b's heads and
# 7.8e-3 at qwen3-1.7b's on the H100, one bf16 ulp of outputs in [0.5, 1)
# and [1, 2), inside atol 4e-3 (two bf16 ulps at 0.25-0.5) plus the rtol
# term.  A mask off by a few keys moves an output by ~|v|/400 per key and
# fails both.
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
# The prefix plane's operations: longer than a 16-token layout block, so
# at block 16 each shares through whole block-table columns (padded to 32
# positions) and at the default 512 through a copy-on-write remainder.
PREFIX_OPS = {
    "o_orig": "does this opinion overturn reverse or vacate a lower court "
              "decision and send the case back to the trial court",
    "sur_court": "is any lower court or trial court mentioned together with "
                 "words such as overturn reversed vacated remanded or "
                 "affirmed",
}
PREFIX_BLOCKS = (16, 512)
# gemma3-27b: its sliding window, and the depth the model check and the
# oracle are cut to.  The model check holds ring decode against the
# cacheless forward: both run bf16 weights and activations, and the two
# paths round in other places (decode kernel over the ring vs the flash
# kernel over the sequence), so the logits differ by bf16 rounding
# carried through 8 layers: measured max 0.029 at a logit std of 1.48 on
# the H100.  0.1 keeps a 3x margin.  The CPU tests hold the ring paths
# to the JAX package at f32 1e-5 (tests/test_torch_local_attention.py).
GEMMA3_WINDOW = 1024
GEMMA3_LAYERS = 8
GEMMA3_LOGIT_TOL = 0.1
# The other decoder families' model checks hold serve-path logits against
# the cacheless forward in bf16 as gemma3's do, with the same bound.
FAMILY_LOGIT_TOL = 0.1
# xlstm's cacheless forward takes only a multiple of its 256-token mLSTM
# chunk (the reference's assertion), so its decode is held after 256 steps
# from 1536 tokens in f32 (the same weights), where decode and the chunked
# forward agree to ~6e-5 at a logit std of 0.64 on the H100; in bf16 the
# rounding of 256 one-token passes moves the logits by 0.1-0.2 (printed
# by the model check, not held).  1e-3 keeps a 17x margin over f32.
XLSTM_F32_TOL = 1e-3
# phi3.5-moe's depth on one card: a layer holds ~2.60 GB of bf16 weights
# (2.52 GB of them experts), so 16 layers are ~41.9 GB with the embedding,
# beside the other phases' models; all 32 (~83 GB) do not fit 80 GB.
PHI_LAYERS = 16
FAMILY_CUT_WHY = {
    "phi3_5_moe": "a layer is ~2.60 GB of bf16 weights; the published 32 "
                  "(~83 GB) do not fit the card's 80 GB",
}
RECURRENTGEMMA_WINDOW = 2048
# dbrx-132b's depth on one card: a layer holds ~3.26 B parameters (3.17 B
# of them experts), ~6.5 GB in bf16, so 40 layers are ~263 GB; 4 layers
# and the 0.62 B-parameter embedding are ~27.3 GB.  Its training step
# takes one layer: 3.88 B parameters are 7.8 GB of bf16 weights, 7.8 GB
# of gradients and 31.0 GB of f32 moments.
DBRX_LAYERS = 4
DBRX_TRAIN_LAYERS = 1
DBRX_TRAIN_SEQ = 4096           # train_4k's sequence, batch 1
DBRX_DECODE = 32
# dbrx's model check runs twice.  At the published capacity factor 1.25
# the serve path and the cacheless forward size their expert buffers by
# their own chunk lengths (the reference's design), so with drops they
# compute the same function only where they drop the same assignments: a
# decode step (capacity 1, nothing dropped) never does against a forward
# that drops the new token's assignments, and only the positions where
# both sides made the same drop decisions are held (as for phi3.5-moe).
# At 2.5 a row's expert buffer holds every token (S * top_k * cf * 1.6 /
# E = S), nothing drops, and every position is held.  The serving cell
# runs the published 1.25.
DBRX_CHECK_CF = 2.5
FAMILY_CUT_WHY["dbrx_132b"] = (
    "a layer holds ~3.26 B parameters, ~6.5 GB of bf16 weights; the "
    "published 40 (~263 GB) do not fit the card's 80 GB, 4 and the "
    "embedding (~27.3 GB) do beside the serving models")
# recurrentgemma-2b built in f32: its local layers' ring decode runs the
# decode kernel over an f32 cache at head_dim 256.  Prefill and 32 decode
# steps against the cacheless forward, both in f32: the RG-LRU step and
# the scan, and the decode kernel and the flash kernel, sum in other
# orders, which f32 rounding carries through 26 layers; xlstm's f32
# decode agrees to ~6e-5 at a logit std of 0.64 after 256 steps, and
# 1e-3 keeps a margin of more than 10x over that.
RG_F32_TOL = 1e-3
RG_F32_PREFILL = 1024
# ``serve [seed engine]``: the static comparison of
# benchmarks/serve_engine.py (its operations, its rates, thresholds 2.0 so
# every document walks the whole ladder) at full width, batch 8.  Both
# engines size caches for the 1024-token bucket plus 64 positions of
# operation suffix (the arena's ``op_reserve``).
SEED_OPS = {"o_orig": "does this opinion overturn a lower court decision",
            "sur_1": "is any lower court mentioned"}
SEED_RATES = {"proxy": 0.06, "oracle": 1.0}
SEED_S_ALLOC = 1024 + 64
# ``dryrun [cells]``: processes at once, each cell's limit, and the whole
# ``--all`` call's
DRYRUN_JOBS = 8
DRYRUN_CELL_TIMEOUT_S = 120
DRYRUN_ALL_TIMEOUT_S = 300
# World-1 cells run on the card where the dry-run's own estimate (its
# arguments plus its peak of temporaries) fits this share of the card;
# their measured peak over that estimate must lie in this band, set in
# PERF.md before the first reading (measured 1.0008-1.0154 on the H100):
# the dry-run tracks every storage the step allocates, so only the
# allocator's rounding and library workspaces separate the two.
WORLD1_FIT = 0.7
WORLD1_MEM_BAND = (0.9, 1.15)
WORLD1_ARCHS = ("llama3_2_1b", "qwen3_1_7b", "minitron_4b", "qwen2_vl_2b",
                "gemma3_27b", "phi3_5_moe", "dbrx_132b")
WORLD1_REPS = {"decode_32k": 10, "prefill_32k": 3}
# the plain versions run on slices of a world-1 cell's kernel inputs: this
# many sequences at once for decode (the f32 GQA-expanded cache of 4
# sequences is 2.1 GB at gemma3's heads), this many query rows of one
# sequence for prefill (scores of 256 x 32768 keys x 32 heads: 1 GB f32)
WORLD1_PLAIN_SEQS = 4
WORLD1_PLAIN_QROWS = 256
# the seeded chaos drain of tests/test_torch_faults.py
CHAOS_SEED = 23
CHAOS_PLAN = dict(launch_failure_p=0.25, nan_p=0.15, latency_spike_p=0.1,
                  spike_s=1e-4, arena_loss_at=4)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


class Timer:
    """Device time of a call, two ways.

    ``ms``: mean over calls timed one at a time by CUDA events around each
    call; a 64 MiB write between calls evicts the 50 MB L2, as the serving
    path finds each layer's KV cold.  A ~2 ms device-side spin is queued
    before the start event, so the host has enqueued the whole call
    before the device reaches it: the events time the device work, not
    the host's launch overhead (which dominates calls shorter than
    ~50 us).  Its floor is what an empty launch measures (``main``
    prints it once, beside the back-to-back floor).

    ``stream_ms``: many launches back to back between one pair of events,
    divided by their count.  The calls rotate over copies of their inputs
    whose bytes together exceed the L2, so each call finds its inputs
    cold; the spin before the start event doubles until the host has
    enqueued every launch before the device starts them."""

    SPIN_CYCLES = 4_000_000
    L2_BYTES = 50e6

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

    def stream_ms(self, fns, reps: int = 256) -> float:
        """``fns`` are the same call on different input copies; ``reps``
        is rounded up to a multiple of their count."""
        reps = -(-reps // len(fns)) * len(fns)
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        spin = self.SPIN_CYCLES
        for _ in range(8):
            self.flush.zero_()
            torch.cuda._sleep(spin)
            self.start.record()
            for i in range(reps):
                fns[i % len(fns)]()
            self.end.record()
            ahead = not self.start.query()     # device still spinning
            self.end.synchronize()
            if ahead:
                return self.start.elapsed_time(self.end) / reps
            spin *= 2
        raise RuntimeError("stream_ms: the host never got ahead of the card")

    def copies(self, nbytes: float) -> int:
        """Input copies whose ``nbytes`` each together exceed the L2."""
        return max(2, math.ceil(1.25 * self.L2_BYTES / nbytes))


def head_dim_resources(source: str, res, kinds: dict,
                       no_spill: tuple, dims=(64, 128)) -> None:
    """Print a source's registers and spills per kernel (``kinds`` maps a
    symbol fragment to its label) and head_dim; the kernels labelled in
    ``no_spill`` must not spill at the head_dims ``dims``."""
    by: dict = {}
    for r in res:
        kind = next(k for sym, k in kinds.items() if sym in r["kernel"])
        dh = int(re.search(r"Li(\d+)E", r["kernel"]).group(1))
        by.setdefault((dh, kind), []).append(r)
    for (dh, kind), rs in sorted(by.items()):
        spill = max(r["spill_stores"] + r["spill_loads"] for r in rs)
        print(f"build: {source} {kind} Dh {dh}: registers "
              f"{sorted(r['registers'] for r in rs)} over {len(rs)} "
              f"instantiations, spill bytes max {spill}")
        assert kind not in no_spill or dh not in dims or spill == 0, \
            (source, dh, kind, rs)


def bound(work, f32: bool = False):
    """(ms, "bytes" or "operations") of a kernel call's ``work`` (its
    module's (bytes, operations)) at this card's peaks
    (``launch.roofline.card_peaks``: the memory rate read from the card,
    the bf16 or f32 rate from its table)."""
    from repro_torch.launch.roofline import bound_ms, card_peaks
    return bound_ms(*work, card_peaks(), f32)


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
    d_err = max(max_err(out, plain), max_err(bt_out, bt_plain))
    # split-KV chunk edges (S = 1088 is not a chunk multiple), then for
    # both kv_len sets: a second call bitwise equal, and each sequence
    # alone (the other rows the scratch sentinel) bitwise equal to the batch
    C = dec.KV_CHUNK
    edges = torch.tensor([0, 1, C - 1, C, C + 1, 2 * C, S, S + 5],
                         dtype=torch.int32, device=dev)
    e_out = ops.arena_decode_attention(q, ka, va, slots, edges)
    e_plain = dec.paged_decode_attention_plain(q, ka, va, slots, edges)
    torch.testing.assert_close(e_out.float(), e_plain.float(), **DECODE_TOL)
    e_bt = ops.arena_decode_attention(q, ka, va, slots, edges,
                                      block_tables=bt)
    e_bt_plain = dec.paged_decode_attention_plain(
        q, ka, va, slots, edges, block_tables=bt, table_block=64)
    torch.testing.assert_close(e_bt.float(), e_bt_plain.float(), **DECODE_TOL)
    assert torch.equal(e_out, ops.decode_attention(q, kg, vg, edges)), \
        "paged decode != dense decode at the chunk edges"
    assert torch.equal(e_out[0], torch.zeros_like(e_out[0])), "kv_len 0"
    d_err = max(d_err, max_err(e_out, e_plain), max_err(e_bt, e_bt_plain))
    for kl, full in ((kv_len, out), (edges, e_out)):
        again = ops.arena_decode_attention(q, ka, va, slots, kl)
        assert torch.equal(again, full), "decode: two calls differ"
        for b in range(B):
            alone = torch.full_like(slots, N - 1)
            alone[b] = slots[b]
            o_b = ops.arena_decode_attention(q, ka, va, alone, kl)
            assert torch.equal(o_b[b], full[b]), f"decode: sequence {b} " \
                "alone differs from the batch"
    print(f"kernels [{label}]: decode at chunk-edge kv_len "
          f"{edges.tolist()} within tol; two calls and each sequence alone "
          f"bitwise equal to the batch (KV_CHUNK {C})")

    d_work = dec.work(B, Hq, Hkv, Dh, S, kv_len=kv_len.tolist(), rows=True)
    qt = q[:, :, None]                                   # [B, Hq, 1, Dh]
    kt, vt = kg.transpose(1, 2), vg.transpose(1, 2)
    mask = sdpa_mask(kv_len, 1, S, 0, False, dev)
    lib = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    b_ms, b_by = bound(d_work)
    rows.append(dict(
        name="paged_decode_attention", source="src/repro_torch/kernels/"
        "csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:161",
        max_abs_err=d_err,
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
    # a second call bitwise equal, and each sequence alone (the other rows
    # the scratch sentinel, or zeroed caches for the dense entry) bitwise
    # equal to its row of the batch
    assert torch.equal(ops.attention_paged(q, ka, va, slots, **kw), out), \
        "extend: two calls differ"
    assert torch.equal(ops.attention(q, kg, vg, **dkw), dense), \
        "dense extend: two calls differ"
    for b in range(B):
        alone = torch.full_like(slots, N - 1)
        alone[b] = slots[b]
        o_b = ops.attention_paged(q, ka, va, alone, **kw)
        assert torch.equal(o_b[b], out[b]), f"extend: sequence {b} alone " \
            "differs from the batch"
        kz, vz = torch.zeros_like(kg), torch.zeros_like(vg)
        kz[b], vz[b] = kg[b], vg[b]
        assert torch.equal(ops.attention(q, kz, vz, **dkw)[b], out[b]), \
            f"dense extend: sequence {b} alone differs from the batch"
    print(f"kernels [{label}]: extend two calls and each sequence alone "
          "bitwise equal to the batch (paged and dense)")
    # prefill into the arena (q_offset 0) and a ragged chunk
    for sq, off, kvv in ((256, 0, 256), (77, 300, 377)):
        qq = rand(B, sq, Hq, Dh)
        kl = torch.clamp(kv_len, max=kvv)
        o1 = ops.attention_paged(qq, ka, va, slots, kv_valid=kvv,
                                 q_offset=off, kv_len=kl)
        p1 = fla.paged_flash_attention_plain(qq, ka, va, slots, kv_valid=kvv,
                                             q_offset=off, kv_len=kl)
        torch.testing.assert_close(o1.float(), p1.float(), **EXTEND_TOL)

    e_work = fla.work(B, Sq, Hq, Hkv, Dh, kv_valid, q_offset=q_off,
                      kv_len=kv_len.tolist(), rows=True)
    qt = q.transpose(1, 2)
    kt, vt = kg.transpose(1, 2), vg.transpose(1, 2)
    mask = sdpa_mask(kv_len, Sq, kv_valid, q_off, True, dev)
    lib = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    b_ms, b_by = bound(e_work)
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


def window_mask(kv_len, Sq, Skv, q_offset, window, dev):
    """The boolean mask of causal + sliding-window + ``kv_len`` attention
    (True = visible), [B, 1, Sq, Skv], for SDPA."""
    m = sdpa_mask(kv_len, Sq, Skv, q_offset, True, dev)
    kpos = torch.arange(Skv, device=dev)
    qpos = q_offset + torch.arange(Sq, device=dev)
    return m & (kpos[None, :] > qpos[:, None] - window)[None, None]


def windowed_kernel_phase(dev, timer, Hq: int, Hkv: int, Dh: int, W: int,
                          label: str, flash_cases, B_flash: int, seed: int):
    """The dense entry points at one sliding-window model's heads (bf16)
    with its window ``W``: ``flash_attention`` at each of ``flash_cases``
    ((case, Sq, q_offset, kv_len per row) over ``2 W`` keys, batch
    ``B_flash``), ``decode_attention`` over a full ring (every row
    ``kv_valid`` W) and a partly filled one (batch 8).  Each against its
    plain version, two calls bitwise equal, each sequence alone (the other
    rows' K/V zeroed) bitwise equal to its row of the batch; timed beside
    SDPA with an explicit boolean window mask and the bound.  Returns the
    rows."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    def alone_equal(fn, full, k, v):
        for b in range(k.shape[0]):
            kz, vz = torch.zeros_like(k), torch.zeros_like(v)
            kz[b], vz[b] = k[b], v[b]
            assert torch.equal(fn(kz, vz)[b], full[b]), \
                f"{label}: sequence {b} alone differs from the batch"

    rows = []
    B, Skv = B_flash, 2 * W
    for case, Sq, q_off, kl in flash_cases:
        q, k, v = rand(B, Sq, Hq, Dh), rand(B, Skv, Hkv, Dh), \
            rand(B, Skv, Hkv, Dh)
        kv_len = torch.tensor(kl, dtype=torch.int32, device=dev)
        kw = dict(causal=True, window=W, q_offset=q_off, kv_len=kv_len)
        out = ops.attention(q, k, v, **kw)
        plain = fla.flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(out.float(), plain.float(), **EXTEND_TOL)
        assert torch.equal(ops.attention(q, k, v, **kw), out), \
            f"{label}: flash two calls differ"
        alone_equal(lambda kk, vv: ops.attention(q, kk, vv, **kw), out, k, v)
        f_work = fla.work(B, Sq, Hq, Hkv, Dh, Skv, window=W, q_offset=q_off,
                          kv_len=kl)
        b_ms, b_by = bound(f_work)
        pairs = f_work[1] / (4.0 * Hq * Dh)
        mask = window_mask(kv_len, Sq, Skv, q_off, W, dev)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        rows.append(dict(
            name="flash_attention", case=case, max_abs_err=max_err(out, plain),
            ms=timer.ms(lambda: ops.attention(q, k, v, **kw)),
            plain_ms=timer.ms(lambda: fla.flash_attention_plain(q, k, v,
                                                                **kw)),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by))
        del plain, mask
        # the same call without the window: does the mask cost more than
        # the pairs it removes?  (visible pairs per microsecond, both ways)
        nw = dict(kw, window=None)
        nw_pairs = fla.work(B, Sq, Hq, Hkv, Dh, Skv, q_offset=q_off,
                            kv_len=kl)[1] / (4.0 * Hq * Dh)
        nw_ms = timer.ms(lambda: ops.attention(q, k, v, **nw))
        r = rows[-1]
        print(f"kernel flash_attention [{label}, {case}]: windowed "
              f"{pairs / r['ms'] / 1e3:.4g} visible pairs per us "
              f"({pairs:.4g} pairs), unwindowed {nw_ms:.4f} ms = "
              f"{nw_pairs / nw_ms / 1e3:.4g} per us ({nw_pairs:.4g} pairs)")
    B = 8
    k, v, q = rand(B, W, Hkv, Dh), rand(B, W, Hkv, Dh), rand(B, Hq, Dh)
    for case, kl in ((f"full ring, kv_valid {W}", [W] * B),
                     ("partly filled ring", [W, 1, 300, W - 1, 512, 777, 64,
                                             1000])):
        kv_len = torch.tensor(kl, dtype=torch.int32, device=dev)
        out = ops.decode_attention(q, k, v, kv_len)
        plain = dec.decode_attention_plain(q, k, v, kv_len)
        torch.testing.assert_close(out.float(), plain.float(), **DECODE_TOL)
        assert torch.equal(ops.decode_attention(q, k, v, kv_len), out), \
            f"{label}: decode two calls differ"
        alone_equal(lambda kk, vv: ops.decode_attention(q, kk, vv, kv_len),
                    out, k, v)
        b_ms, b_by = bound(dec.work(B, Hq, Hkv, Dh, W, kv_len=kl))
        mask = sdpa_mask(kv_len, 1, W, 0, False, dev)
        qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        rows.append(dict(
            name="decode_attention", case=case,
            max_abs_err=max_err(out, plain),
            ms=timer.ms(lambda: ops.decode_attention(q, k, v, kv_len)),
            plain_ms=timer.ms(lambda: dec.decode_attention_plain(q, k, v,
                                                                 kv_len)),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by))
    for r in rows:
        tol = DECODE_TOL if r["name"] == "decode_attention" else EXTEND_TOL
        print(f"kernel {r['name']} [{label}, {r['case']}]: max_abs_err "
              f"{r['max_abs_err']:.3g} (tol atol={tol['atol']:g} "
              f"rtol={tol['rtol']:g}), kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, sdpa (window mask) "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    print(f"kernels [{label}]: flash (prefill, extend) and decode (full "
          f"and partly filled ring): two calls and each sequence alone "
          f"bitwise equal to the batch")
    return rows


def gemma3_model_phase():
    """Full-width gemma3-27b (d_model 5376, 32/16 heads, head_dim 128,
    d_ff 21504, vocab 262144, window 1024, qk-norm, embedding scale) cut
    to 8 layers: one superblock of five local layers and one global, and
    the two local layers that end the published 62.  Random bf16 weights
    (seed 2).  Two sequences of 1538 tokens: (a) prefill of 1536 into
    rings of 1024 and global caches of 2048, (b) prefill of 1024 and an
    extend of 512 at ``q_offset`` 1024 (the masked ring path), each then
    two decode steps (the rings wrapped); each decode's logits against
    the cacheless forward of the sequence up to that token.  Returns the
    model, its parameters and the kernel launches of the phase."""
    import dataclasses

    from repro_torch.config import ATTN_FULL, ATTN_LOCAL, resolve
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    full = get_config("gemma3_27b")
    cfg = dataclasses.replace(full, num_layers=GEMMA3_LAYERS)
    model = LM(resolve(cfg, tp=1), device="cuda")
    assert model.kinds == (ATTN_LOCAL,) * 5 + (ATTN_FULL,) + (ATTN_LOCAL,) * 2
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.sliding_window) == (
        5376, 32, 16, 128, 21504, 262144, GEMMA3_WINDOW)
    assert cfg.qk_norm and cfg.embed_scale and model.dtype == torch.bfloat16
    params = model.init(seed=2)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in _leaves(params))
    print(f"gemma3: full width (d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads, head_dim {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {model.rcfg.padded_vocab}, window "
          f"{cfg.sliding_window}, qk_norm, embed scale), bf16, "
          f"{n_bytes / 1e9:.2f} GB of random weights")
    print(f"reduced: num_layers {full.num_layers} -> {cfg.num_layers} "
          f"(one 5 local + 1 global superblock and the 2-local tail)")
    g = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(16, 128256, (2, 1538), generator=g, device="cuda")

    def pos(n):
        return torch.full((2,), n, dtype=torch.int32, device="cuda")

    _zero_counts()
    errs, stds = [], []
    with torch.no_grad():
        for case in ("prefill 1536", "prefill 1024 + extend 512"):
            if case == "prefill 1536":
                _, st = model.prefill(params, {"tokens": toks[:, :1536]},
                                      s_alloc=2048)
            else:
                _, st = model.prefill(params, {"tokens": toks[:, :1024]},
                                      s_alloc=2048)
                _, st = model.extend(params, {"tokens": toks[:, 1024:1536]},
                                     st, 1024)
            assert [layer["k"].shape[1] for layer in st] == \
                [1024] * 5 + [2048] + [1024] * 2
            for n in (1536, 1537):
                dl, st = model.decode_step(params, toks[:, n], st, pos(n))
                fl, _ = model.prefill(params, {"tokens": toks[:, :n + 1]})
                assert torch.isfinite(dl).all() and dl.shape == fl.shape
                err = max_err(dl, fl)
                errs.append(err)
                stds.append(float(fl.float().std()))
                print(f"gemma3 [{case}, decode at position {n}]: max "
                      f"|logit - full forward| {err:.4g} (logit std "
                      f"{stds[-1]:.4g}; tol {GEMMA3_LOGIT_TOL:g}), argmax "
                      f"equal {bool((dl.argmax(-1) == fl.argmax(-1)).all())}")
                assert err <= GEMMA3_LOGIT_TOL, (case, n, err)
    torch.cuda.synchronize()
    counts = _counts()
    assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0
    print(f"gemma3: ring decode == full forward within tol at 4 positions "
          f"(max error {max(errs):.4g}); kernel launches "
          f"{json.dumps(counts)}")
    return model, params, counts


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in _leaves(v)]


def gemma3_docs(tokz):
    """32 documents: 24 of the serving corpus (190-716 tokens) and 8 of
    990-1024 tokens (bucket 1024), whose op-suffix decode steps run past
    position 1024 and so wrap the oracle's rings."""
    from repro_torch.data.documents import generate_corpus

    docs = {d.doc_id: d.text for d in generate_corpus(24, seed=0)}
    words = " ".join(d.text for d in generate_corpus(
        24, avg_lines=60, seed=9)).split()
    for i, n in enumerate(np.linspace(990, 1024, 8).astype(int)):
        text = " ".join(words[i * 1100: i * 1100 + n])
        assert len(tokz.encode(text)) == n
        docs[100 + i] = text
    assert len(docs) == 32
    return docs


def gemma3_serving_phase(models, params, g_model, g_params):
    """``serve [gemma3 oracle]``: the serving phase's full-width
    llama3.2-1b proxy (paged plane) beside the 8-layer full-width gemma3
    oracle (gather plane: ring caches are not paged), two queries over
    ``gemma3_docs``: the first tenant cascade, and a proxy screen with
    impossible thresholds, so every document reaches the oracle.  A
    warm-up drain, then inflight 1 and 3, launch counters zeroed before
    each drain and read after; every bucket served is at most the
    window.  Returns the inflight=1 counts."""
    from repro_torch.core.tasks import Cascade, Task, TaskConfig

    ms = {"proxy": models["proxy"], "oracle": g_model}
    ps = {"proxy": params["proxy"], "oracle": g_params}
    cascades = [tenant_cascades()[0],
                Cascade([Task(TaskConfig("proxy", "sur_court", 0.25),
                              {0: 2.0, 1: 2.0})])]
    docs = None
    runs = {}
    for label, inflight in (("warm-up", 1), ("inflight=1", 1),
                            ("inflight=3", 3)):
        srv = make_server(ms, ps, inflight=inflight)
        if docs is None:
            docs = gemma3_docs(srv.backends["proxy"].tokenizer)
            n_long = sum(990 <= len(t.split()) <= 1024
                         for t in docs.values())
            assert n_long >= 8
        assert srv.backends["proxy"].uses_paged_kv()
        assert not srv.backends["oracle"].uses_paged_kv()
        results, counts, wall = drive(srv, cascades, docs)
        assert_resolved(results, docs)
        check_launches(srv, counts)
        oracle_buckets = sorted({rec.bucket
                                 for rec in srv.telemetry.launches.items()
                                 if rec.model == "oracle"})
        assert oracle_buckets and max(oracle_buckets) == GEMMA3_WINDOW
        n = sum(len(r.status) for r in results.values())
        p50, p99 = latency_ms(results)
        at_oracle = sum(s == len(c.tasks) for r, c in zip(
            results.values(), cascades) for s in r.exit_stage.values())
        print(f"serve [gemma3 oracle, {label}]: {n} docs terminal and "
              f"RESOLVED in {wall:.3f} s ({n / wall:.2f} docs/s), "
              f"{srv.stats().batches} launches, latency p50 {p50:.1f} ms "
              f"p99 {p99:.1f} ms, {at_oracle} resolved by the oracle in "
              f"buckets {oracle_buckets}, kernel launches "
              f"{json.dumps(counts)}")
        runs[label] = ({q: (r.pred, r.conf, r.doc_cost)
                        for q, r in results.items()}, counts)
    assert runs["inflight=3"][0] == runs["inflight=1"][0], \
        "gemma3 oracle: inflight 3 != 1"
    print(f"serve [gemma3 oracle]: inflight=3 == inflight=1 bitwise (preds, "
          f"confs, per-document $) over {len(docs)} docs, "
          f"{n_long} of 990-1024 tokens")
    return runs["inflight=1"][1], cascades, docs


def tenant_cascades(first: float = 0.25):
    """The two tenant cascades of ``launch/serve.py``, the shared screen at
    document fraction ``first``."""
    from repro_torch.core.tasks import Cascade, Task, TaskConfig
    return [
        Cascade([Task(TaskConfig("proxy", "sur_court", first),
                      {0: 0.6, 1: 0.6}),
                 Task(TaskConfig("proxy", "o_orig", 1.0),
                      {0: 0.65, 1: 0.65})]),
        Cascade([Task(TaskConfig("proxy", "sur_court", first),
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


def make_server(models, params, *, inflight: int, ops=OPS,
                server_kw=None, vocab: int = 128256, **be_kw):
    """Proxy and oracle backends over ``models`` and a batch-8 server on
    the card; ``be_kw`` goes to both backends, ``server_kw`` to the
    server.  ``vocab`` sizes the tokenizer (at most the smaller model's
    vocabulary)."""
    from repro_torch.data.tokenizer import HashWordTokenizer
    from repro_torch.serving.engine import CascadeServer, LMBackend

    tokz = HashWordTokenizer(vocab_size=vocab)
    rates = {"proxy": 0.15e-6, "oracle": 2.50e-6}
    backends = {n: LMBackend(name=n, model=models[n], params=params[n],
                             tokenizer=tokz, rate_per_token=rates[n],
                             device="cuda", **be_kw)
                for n in ("proxy", "oracle")}
    return CascadeServer(backends, ops, n_classes=2, batch_size=8,
                         inflight=inflight, device="cuda",
                         **(server_kw or {}))


def drive(srv, cascades, docs):
    """Register ``cascades``, submit every document to each (arrival
    order = document order) and drain, with the launch counters zeroed
    just before and read just after.  Returns (results, counts, wall s)."""
    handles = [srv.register(c) for c in cascades]
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, d in enumerate(sorted(docs)):
        for h in handles:
            h.submit(d, docs[d], arrival=float(i))
    srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {h.query_id: h.result() for h in handles}, _counts(), wall


def check_launches(srv, counts, *, prefills: int = 0):
    """The kernel counters against the server's launches, per backend
    plane (paged entry points on the paged plane, dense ones on the
    gather plane).  A standard stage launch runs one flash extend per
    attention layer when it has new tokens (a sliding-window layer only
    at cached length 0: its extend past a cached prefix is the plain
    masked ring path) and one decode per attention layer per operation
    token; recurrent layers launch no kernel.  A prefix-plane launch runs
    one decode per layer (the readout), and each op-prefix prefill one
    flash extend per layer (``prefills`` counts those, on the paged
    plane).  Launches that failed ran no step."""
    from repro_torch.config import ATTN_FULL, ATTN_LOCAL

    want = {"paged_flash_attention": 0, "paged_decode_attention": 0,
            "flash_attention": 0, "decode_attention": 0}
    planes = set()
    for rec in srv.telemetry.launches.items():
        if not rec.ok:
            continue
        be = srv.backends[rec.model]
        pre = "paged_" if be.uses_paged_kv() else ""
        full = be.model.kinds.count(ATTN_FULL)
        local = be.model.kinds.count(ATTN_LOCAL)
        n_layers = full + local
        if n_layers:
            planes.add(pre)
        if rec.f_len > rec.cached_len:
            want[pre + "flash_attention"] += full + (
                local if rec.cached_len == 0 else 0)
        want[pre + "decode_attention"] += n_layers * (
            1 if be.prefix_sharing else len(
                be.tokenizer.encode(srv.operations[rec.op_id])))
    want["paged_flash_attention"] += prefills
    for k, n in want.items():
        assert counts[k] == n, (k, counts, want)
    assert planes and all(want[p + "decode_attention"] > 0 for p in planes)
    assert want["flash_attention"] + want["paged_flash_attention"] > 0


def assert_resolved(results, docs):
    from repro_torch.serving.scheduler import RESOLVED
    for qid, r in results.items():
        assert set(r.status) == set(docs), f"query {qid}: docs missing"
        bad = {d: s for d, s in r.status.items() if s != RESOLVED}
        assert not bad, f"query {qid}: not resolved {bad}"


def latency_ms(results):
    lat = [x for r in results.values() for x in r.stats.latencies]
    return 1e3 * np.quantile(lat, 0.5), 1e3 * np.quantile(lat, 0.99)


def serve_once(models, params, docs, *, paged: bool, inflight: int):
    srv = make_server(models, params, inflight=inflight, paged=paged)
    results, counts, wall = drive(srv, tenant_cascades(), docs)
    assert_resolved(results, docs)
    assert all(be.uses_paged_kv() == paged for be in srv.backends.values())
    check_launches(srv, counts)
    n = sum(len(r.status) for r in results.values())
    p50, p99 = latency_ms(results)
    label = f"{'paged' if paged else 'gather'} inflight={inflight}"
    print(f"serve [{label}]: {n} docs terminal and RESOLVED in "
          f"{wall:.3f} s ({n / wall:.2f} docs/s), {srv.stats().batches} "
          f"launches, latency p50 {p50:.1f} ms "
          f"p99 {p99:.1f} ms, kernel launches "
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


def seed_engine_phase(models, params, docs):
    """``serve [seed engine]``: the port's ``SeedCascadeEngine`` (per-doc
    dict cache, every prefill and extend through the flash kernel) and
    its arena ``CascadeEngine.run`` over the serving phase's models and
    corpus on the forced ladder of ``benchmarks/serve_engine.py``, each
    once to warm up and once timed with the counters zeroed.  Every
    document resolves in both; new and cached tokens (per stage),
    batches and $ are the same.  Prints the preds' agreement (bf16 and
    another batch composition may flip a pred), docs/s and
    ``host_overhead_s`` of each.  Returns the two runs' launch counts."""
    from repro_torch.core.tasks import Cascade, Task, TaskConfig
    from repro_torch.data.tokenizer import HashWordTokenizer
    from repro_torch.serving.engine import CascadeEngine, LMBackend
    from repro_torch.serving.legacy_engine import (DictCacheLMBackend,
                                                   SeedCascadeEngine)
    from repro_torch.serving.scheduler import RESOLVED

    thr = {0: 2.0, 1: 2.0}
    ladder = Cascade([Task(TaskConfig("proxy", "sur_1", 0.25), thr),
                      Task(TaskConfig("proxy", "o_orig", 1.0), thr)])
    tokz = HashWordTokenizer(vocab_size=128256)
    kw = {n: dict(name=n, model=models[n], params=params[n], tokenizer=tokz,
                  rate_per_token=SEED_RATES[n], s_alloc=SEED_S_ALLOC)
          for n in ("proxy", "oracle")}
    seed_be = {n: DictCacheLMBackend(**k) for n, k in kw.items()}
    arena_be = {n: LMBackend(device="cuda", **k) for n, k in kw.items()}
    seed = SeedCascadeEngine(seed_be, SEED_OPS, n_classes=2, batch_size=8)
    arena = CascadeEngine(arena_be, SEED_OPS, n_classes=2, batch_size=8,
                          device="cuda")

    def timed(fn):
        fn()                                              # warm-up
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, _counts(), time.perf_counter() - t0

    (s_pred, s_cost, s_stats), s_counts, s_wall = timed(
        lambda: seed.run(ladder, docs))
    res, a_counts, a_wall = timed(lambda: arena.run(ladder, docs))
    assert set(s_pred) == set(docs), "seed engine: documents missing"
    assert set(res.status) == set(docs) and all(
        st == RESOLVED for st in res.status.values()), res.status
    st, at = s_stats, res.stats
    assert (st.stage_new_tokens, st.stage_cached_tokens, st.batches) == \
        (at.stage_new_tokens, at.stage_cached_tokens, at.batches), \
        (st, at)
    # $ from the same token counts, summed per batch and per document
    assert math.isclose(s_cost, res.cost, rel_tol=1e-12), (s_cost, res.cost)
    assert s_counts["flash_attention"] > 0 and not any(
        v for k, v in s_counts.items() if k != "flash_attention"), s_counts
    agree = sum(s_pred[d] == res.pred[d] for d in docs)
    hosts = [sum(be.host_overhead_s for be in b.values())
             for b in (seed_be, arena_be)]
    print(f"serve [seed engine, llama3.2-1b proxy and oracle, forced "
          f"ladder, {len(docs)} docs, batch 8]: every document resolved in "
          f"both engines; new tokens {st.total_new_tokens()}, cached "
          f"{st.total_cached_tokens()} (per stage {st.stage_new_tokens} / "
          f"{st.stage_cached_tokens}), {st.batches} batches and "
          f"${s_cost:.6f} (arena ${res.cost:.6f}) the same in both")
    for name, wall, host, counts in (("seed", s_wall, hosts[0], s_counts),
                                     ("arena", a_wall, hosts[1], a_counts)):
        print(f"serve [seed engine, {name}]: {wall:.3f} s "
              f"({len(docs) / wall:.2f} docs/s), host_overhead_s "
              f"{host:.4f}, kernel launches "
              f"{ {k: v for k, v in counts.items() if v} }")
    print(f"serve [seed engine]: preds agree on {agree} of {len(docs)} "
          f"documents")
    return s_counts, a_counts


def prefix_kernel_phase(dev, Hq: int, Hkv: int, Dh: int, label: str):
    """The decode and extend kernels through block tables that mix a
    pinned prefix row with private rows, as the prefix plane builds them:
    at table block 16 the 32-position prefix fills two whole shared
    columns, at the default block 512 the 20-token prefix is a
    copy-on-write remainder in each private row.  Each must equal, bitwise,
    the same kernel over slot rows holding a materialized copy of the
    prefix, and stay within the tolerances of its plain version."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(1)
    bf16 = torch.bfloat16
    B, N, row = 8, 17, 15                    # 16 slots + scratch row 16
    slots = torch.tensor([5, 2, 9, 0, 14, 7, 16, 16], dtype=torch.int32,
                         device=dev)
    attached = slots[:6].long()
    errs = []
    for tb, P in ((16, 32), (512, 20)):
        S = 576 if tb == 16 else 1024        # bucket 512 + 64, rounded
        ka = torch.randn((N, S, Hkv, Dh), generator=g, device=dev).to(bf16)
        va = torch.randn((N, S, Hkv, Dh), generator=g, device=dev).to(bf16)
        shared = (P // tb) * tb              # positions in shared columns
        if P > shared:                       # the copy-on-write remainder
            ka[attached, shared:P] = ka[row, shared:P]
            va[attached, shared:P] = va[row, shared:P]
        bt = slots[:, None].repeat(1, S // tb)
        bt[:6, : P // tb] = row
        mk, mv = ka.clone(), va.clone()      # the prefix materialized
        mk[attached, :shared] = ka[row, :shared]
        mv[attached, :shared] = va[row, :shared]
        # decode: the readout of documents of 1..480 tokens behind P
        kv_len = torch.tensor([P + 480, P + 300, P + 1, P + 77, P + 200,
                               P + 9, 1, 1], dtype=torch.int32, device=dev)
        q = torch.randn((B, Hq, Dh), generator=g, device=dev).to(bf16)
        d_bt = ops.arena_decode_attention(q, ka, va, slots, kv_len,
                                          block_tables=bt)
        d_mat = ops.arena_decode_attention(q, mk, mv, slots, kv_len)
        assert torch.equal(d_bt, d_mat), ("prefix-table decode", tb)
        d_plain = dec.paged_decode_attention_plain(
            q, ka, va, slots, kv_len, block_tables=bt, table_block=tb)
        torch.testing.assert_close(d_bt.float(), d_plain.float(),
                                   **DECODE_TOL)
        # extend: a document's fraction 0.25 -> 1.0 behind the prefix
        Sq, off = 384, P + 128
        qe = torch.randn((B, Sq, Hq, Dh), generator=g, device=dev).to(bf16)
        kw = dict(kv_valid=off + Sq, q_offset=off,
                  kv_len=torch.clamp(kv_len + 128, max=off + Sq))
        e_bt = ops.attention_paged(qe, ka, va, slots, block_tables=bt, **kw)
        e_mat = ops.attention_paged(qe, mk, mv, slots, **kw)
        assert torch.equal(e_bt, e_mat), ("prefix-table extend", tb)
        e_plain = fla.paged_flash_attention_plain(
            qe, ka, va, slots, block_tables=bt, table_block=tb, **kw)
        torch.testing.assert_close(e_bt.float(), e_plain.float(),
                                   **EXTEND_TOL)
        errs.append(f"block {tb}: {P // tb} shared column(s), remainder "
                    f"{P - shared}, decode err {max_err(d_bt, d_plain):.3g}, "
                    f"extend err {max_err(e_bt, e_plain):.3g}")
    print(f"kernels [prefix tables, {label}]: decode and extend through "
          f"tables naming pinned row {row} == over materialized slot rows "
          f"bitwise, within tol of the plain versions; " + "; ".join(errs))


def watch_prefix_rows(srv):
    """Record every op-prefix prefill of the server's backends with the
    row's KV window just after it; returns the list of
    ``(backend, arena, op, row, window)``."""
    seen = []
    for be in srv.backends.values():
        orig = be._ensure_prefix_row

        def ensure(arena, bucket, op_key, op_tokens, be=be, orig=orig):
            fresh = op_key not in arena.prefix_row
            row = orig(arena, bucket, op_key, op_tokens)
            if fresh:
                seen.append((be, arena, op_key, row,
                             _prefix_window(be, arena, row, len(op_tokens))))
            return row

        be._ensure_prefix_row = ensure
    return seen


def _prefix_window(be, arena, row, P):
    idx = torch.tensor([row], dtype=torch.int32, device="cuda")
    win = be.model.take_kv_window(arena.states, idx, idx * 0,
                                  be._prefix_eff_len(P))
    return [t.clone() for layer in win for t in layer.values()]


def pinned_rows_unchanged(seen) -> int:
    """Compare every prefix row still pinned after a drain with its window
    at prefill; returns how many were compared."""
    n = 0
    for be, arena, op, row, base in seen:
        if be._arenas.get(arena.bucket) is not arena \
                or arena.prefix_row.get(op) != row:
            continue                         # memo dropped since (retired)
        now = _prefix_window(be, arena, row, arena.prefix_len[row])
        assert all(torch.equal(a, b) for a, b in zip(base, now)), \
            ("pinned row changed", be.name, arena.bucket, op)
        n += 1
    return n


def same_op_ladder():
    """Both stages run ``o_orig`` with no early exit: every layout makes
    the same launches over the same tokens, and the op-first plane bills
    exactly what the doc-before-op plane bills."""
    from repro_torch.core.tasks import Cascade, Task, TaskConfig
    thr = {0: 2.0, 1: 2.0}
    return Cascade([Task(TaskConfig("proxy", "o_orig", 0.25), thr),
                    Task(TaskConfig("proxy", "o_orig", 1.0), thr)])


def prefix_serving_phase(models, params, docs):
    """The two tenant cascades on the prefix plane at layout blocks 16
    and 512, inflight 1 and 3, against the doc-before-op plane on the same
    operations; then a same-op ladder on both planes, whose per-document
    $ must agree exactly.  Launch counters are zeroed before each drain
    and read after it (the block-16 inflight=1 drain is the path's
    count)."""
    def report(label, srv, results, counts, wall):
        n = sum(len(r.status) for r in results.values())
        p50, p99 = latency_ms(results)
        agg = srv.stats()
        print(f"serve [{label}]: {n} docs terminal and RESOLVED in "
              f"{wall:.3f} s ({n / wall:.2f} docs/s), {agg.batches} "
              f"launches, latency p50 {p50:.1f} ms p99 {p99:.1f} ms, "
              f"prefix_hits {agg.prefix_hits}, cow_copies {agg.cow_copies}, "
              f"arena bytes peak {agg.arena_bytes_peak}, kernel launches "
              f"{json.dumps(counts)}")

    srv = make_server(models, params, inflight=1, ops=PREFIX_OPS)
    results, counts, wall = drive(srv, tenant_cascades(), docs)
    assert_resolved(results, docs)
    check_launches(srv, counts)
    report("prefix ops, doc-before-op inflight=1", srv, results, counts,
           wall)
    path_counts = None
    for block in PREFIX_BLOCKS:
        sigs = {}
        for inflight in (1, 3):
            srv = make_server(models, params, inflight=inflight,
                              ops=PREFIX_OPS, prefix_sharing=True,
                              layout_block=block)
            seen = watch_prefix_rows(srv)
            results, counts, wall = drive(srv, tenant_cascades(), docs)
            assert_resolved(results, docs)
            check_launches(srv, counts, prefills=sum(
                be.model.num_layers for be, *_ in seen))
            report(f"prefix block={block} inflight={inflight}", srv,
                   results, counts, wall)
            assert srv.stats().prefix_hits > 0
            assert (srv.stats().cow_copies > 0) == (block == 512)
            assert (srv._max_inflight_seen == 1) == (inflight == 1)
            pinned = pinned_rows_unchanged(seen)
            assert pinned > 0
            sigs[inflight] = {q: (r.pred, r.conf, r.doc_cost)
                              for q, r in results.items()}
            if block == 16 and inflight == 1:
                path_counts = counts
        assert sigs[3] == sigs[1], f"prefix block {block}: inflight 3 != 1"
        print(f"serve [prefix block={block}]: inflight=3 == inflight=1 "
              f"bitwise (preds, confs, per-document $); {len(seen)} prefix "
              f"prefills, {pinned} rows still pinned after the drain "
              f"bitwise unchanged")
    ladder = [same_op_ladder()]
    costs, launches = {}, {}
    for block in (None,) + PREFIX_BLOCKS:
        kw = {} if block is None else dict(prefix_sharing=True,
                                           layout_block=block)
        srv = make_server(models, params, inflight=1, ops=PREFIX_OPS, **kw)
        results, counts, wall = drive(srv, ladder, docs)
        assert_resolved(results, docs)
        costs[block] = results[0].doc_cost
        launches[block] = srv.stats().batches
        report("same-op ladder, " + ("doc-before-op" if block is None
                                     else f"prefix block={block}"),
               srv, results, counts, wall)
    for block in PREFIX_BLOCKS:
        assert costs[block] == costs[None], f"same-op $ at block {block}"
        assert launches[block] == launches[None], "same-op launches"
    print(f"serve [prefix]: same-op ladder per-document $ and launches "
          f"== doc-before-op plane exactly at blocks {list(PREFIX_BLOCKS)} "
          f"(${math.fsum(costs[None].values()):.12g} over {len(docs)} "
          f"docs)")
    return path_counts


def chaos_phase(models, params):
    """The seeded chaos drain (launch failures, NaN confidences, latency
    spikes, one arena loss; two tenants; one expired deadline) and a warm
    restart from the journal after four steps, at full width on the
    paged plane.  Counters are zeroed before the drain and read after."""
    from repro_torch.data.documents import generate_corpus
    from repro_torch.serving.engine import RequestJournal
    from repro_torch.serving.faults import FaultInjector, FaultPlan
    from repro_torch.serving.scheduler import (TERMINAL_STATES, TIMED_OUT,
                                               RetryPolicy)

    docs = {d.doc_id: d.text
            for d in generate_corpus(12, avg_lines=12, seed=7)}
    plan = FaultPlan(seed=CHAOS_SEED, **CHAOS_PLAN)

    def server(journal=False):
        return make_server(models, params, inflight=1, server_kw=dict(
            retry=RetryPolicy(max_retries=2, backoff_base=0.0),
            journal=RequestJournal() if journal else None))

    def submit(srv):
        ids = sorted(docs)
        futs = {}
        for k, h in enumerate(srv.register(c) for c in tenant_cascades()):
            for j, d in enumerate(ids[k::2]):
                futs[(h.query_id, d)] = h.submit(
                    d, docs[d], arrival=float(j),
                    deadline_s=0.0 if (k == 0 and j == 0) else None)
        return futs

    def ledger_exact(srv):
        per_q = {qid: 0.0 for qid in srv._handles}
        per_doc = {}
        for _, qid, rid, cost in srv.ledger():
            per_q[qid] += cost
            per_doc[rid] = per_doc.get(rid, 0.0) + cost
        return (all(t == srv.cost(q) for q, t in per_q.items())
                and all(per_doc.get(rid, 0.0) == req.cost
                        for rid, req in srv._requests.items()))

    srv = server()
    inj = FaultInjector(plan).install(srv)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = submit(srv)
    srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    check_launches(srv, counts)
    agg = srv.stats()
    statuses = [f.status for f in futs.values()]
    checks = {
        "all_terminal": all(f.done and f.status in TERMINAL_STATES
                            for f in futs.values()),
        "accounting_exact": ledger_exact(srv),
        "deadline_timed_out": futs[(0, sorted(docs)[0])].status == TIMED_OUT,
        "one_arena_loss": inj.counts["arena_losses"] == 1,
    }
    terminal = {s: statuses.count(s) for s in sorted(set(statuses))}
    print(f"serve [chaos]: {len(futs)} docs in {wall:.3f} s, injected "
          f"{json.dumps(inj.counts)}; terminal {json.dumps(terminal)}; "
          f"retries {agg.retries} quarantines {agg.quarantines} timeouts "
          f"{agg.timeouts} failures {agg.failures} breaker trips "
          f"{agg.breaker_trips} recovered_docs {agg.recovered_docs}; "
          f"kernel launches {json.dumps(counts)}")

    crashed = server(journal=True)
    FaultInjector(plan).install(crashed)
    submit(crashed)
    for _ in range(4):                      # partial progress, then "crash"
        crashed.step()
    journal = crashed.journal
    pre = dict(journal.resolutions)
    fresh = server(journal=True)
    for c in tenant_cascades():             # same cascades, same order
        fresh.register(c)
    rec = fresh.recover(journal)
    checks["recovery_restored_exact"] = bool(pre) and all(
        rec[k].done and rec[k].status == r["status"]
        and rec[k].pred == r["pred"] and rec[k].cost == r["cost"]
        for k, r in pre.items())
    fresh.drain()
    checks["recovery_all_terminal"] = all(
        f.done and f.status in TERMINAL_STATES for f in rec.values())
    checks["recovery_accounting_exact"] = ledger_exact(fresh)
    print(f"serve [chaos]: journal after 4 steps: {len(pre)} of "
          f"{len(journal.submits)} terminal, {len(journal.submits) - len(pre)}"
          f" resubmitted, recovered_docs {fresh.stats().recovered_docs}")
    print(f"serve [chaos]: checks {json.dumps(checks)}")
    failed = [k for k, v in checks.items() if v is not True]
    assert not failed, f"chaos checks failed: {failed}"
    return counts


def describe_model(arch, model, params, seed, full_layers=None):
    """Print a family model's widths and weight bytes, and a cut depth as
    a ``reduced:`` line."""
    cfg = model.rcfg.base
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    moe = (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k}"
           if cfg.moe else "")
    print(f"models [families]: {cfg.name} full width ({cfg.num_layers} "
          f"layers {'/'.join(sorted(set(model.kinds)))}, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"head_dim {model.rcfg.head_dim}, d_ff {cfg.d_ff}{moe}, vocab "
          f"{model.rcfg.padded_vocab}), bf16, {n_bytes / 1e9:.2f} GB of "
          f"random weights (seed {seed})")
    if full_layers is not None:
        print(f"reduced: num_layers {full_layers} -> {cfg.num_layers} "
              f"({cfg.name}: {FAMILY_CUT_WHY.get(arch, '')})")


def family_models(archs):
    """Full-width models (random bf16 weights) of ``archs``: (arch, seed,
    layers or None for the published depth).  Returns {arch: (model,
    params)}."""
    import dataclasses

    from repro_torch.config import resolve
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    out = {}
    for arch, seed, layers in archs:
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, num_layers=layers)
        model = LM(resolve(cfg, tp=1), device="cuda")
        params = model.init(seed=seed)
        describe_model(arch, model, params, seed,
                       None if layers is None else full.num_layers)
        out[arch] = (model, params)
    return out


def _patch_inputs(model, n_img: int, grid: int, text, gen):
    """qwen2-vl's stubbed vision input: ``n_img`` random patch embeddings
    on a ``grid`` x ``grid`` (h, w) grid at t = 0, then ``text`` at its
    absolute position on all three channels."""
    B, n_txt = text.shape
    d = model.rcfg.base.d_model
    patches = (torch.randn((B, n_img, d), generator=gen, device="cuda")
               * 0.02).to(torch.bfloat16)
    i = torch.arange(n_img, device="cuda")
    img = torch.stack([torch.zeros_like(i), i // grid, i % grid], -1)
    txt = torch.arange(n_img, n_img + n_txt, device="cuda")[:, None].expand(
        n_txt, 3)
    pos3 = torch.cat([img, txt])[None].expand(B, n_img + n_txt, 3)
    return {"tokens": text, "patch_emb": patches, "positions3": pos3}


def family_model_phase(arch, model, params, decode_at=(1536, 1537)):
    """``models [families]``: serve-path logits against the cacheless
    forward.  Each case builds caches to position ``n0`` ((a) a prefill
    of 1536 tokens into caches of 2048 positions, (b) a prefill of 1024
    and an extend of 512 at ``q_offset`` 1024, and for qwen2-vl (c) 1024
    patch embeddings on a 32 x 32 grid and 512 text tokens), then decodes
    up to the last position of ``decode_at``; the path's last logits
    (position ``n0 - 1``) and the decode steps' logits at the positions
    of ``decode_at`` (1536 and 1537 unless the caller names others) are
    held against the cacheless prefill of the sequence up to the same
    position, within ``FAMILY_LOGIT_TOL``.

    xlstm's cacheless forward takes only a multiple of the 256-token mLSTM
    chunk (the reference's assertion), so its bf16 decode is held after a
    prefill of 255 tokens (one step, against the forward of 256), its
    1536-token caches at position 1535, and its decode after 256 steps
    from 1536 tokens in f32 (the same weights, ``XLSTM_F32_TOL``); its
    128 -> 512 extend must raise as the reference's does.

    phi3.5-moe logs every MoE layer's keep mask: the two sides compute the
    same function only where they made the same drop decisions for every
    token (capacity depends on the chunk length: 384 an expert for 1536
    or 1537 tokens, 256 for 1024, 128 for 512, 1 for a decode step, which
    drops nothing), so the bound is held there and the rest is printed
    with its count of differing decisions.  Returns the kernel launches."""
    import dataclasses

    from repro_torch.config import resolve
    from repro_torch.models import moe
    from repro_torch.models.model import LM

    name = model.rcfg.base.name
    vocab = model.rcfg.base.vocab_size
    is_moe = model.rcfg.base.moe is not None
    xlstm = arch == "xlstm_350m"
    g = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(16, vocab, (2, 1794), generator=g, device="cuda")

    def pos(n):
        return torch.full((2,), n, dtype=torch.int32, device="cuda")

    def logged(fn):
        """(result, every MoE layer's keep mask [B, S, k] of the call)."""
        if not is_moe:
            return fn(), []
        moe.DROP_LOG = []
        try:
            return fn(), list(moe.DROP_LOG)
        finally:
            moe.DROP_LOG = None

    def pgen():
        return torch.Generator(device="cuda").manual_seed(7)

    def batch_upto(patches, n):
        """The inputs of positions [0, n)."""
        if patches:
            return _patch_inputs(model, 1024, 32, toks[:, :n - 1024], pgen())
        return {"tokens": toks[:, :n]}

    if xlstm:
        decode_at = ()
    cases = [("prefill 1536", False, ((0, 1536),), decode_at, model, params,
              FAMILY_LOGIT_TOL),
             ("prefill 1024 + extend 512", False, ((0, 1024), (1024, 1536)),
              decode_at, model, params, FAMILY_LOGIT_TOL)]
    if model.rcfg.base.frontend_stub == "vision_patches":
        cases.append(("1024 patches + 512 text", True, ((0, 1536),),
                      decode_at, model, params, FAMILY_LOGIT_TOL))
    if xlstm:
        cases.append(("prefill 255", False, ((0, 255),), (255,), model,
                      params, FAMILY_LOGIT_TOL))
        cases.append(("bf16, prefill 1536 + 256 decode steps", False,
                      ((0, 1536),), (1791,), model, params, None))
        m32 = LM(resolve(dataclasses.replace(model.rcfg.base,
                                             dtype="float32"), tp=1),
                 device="cuda")
        p32 = _map_tensors(params, lambda t: t.float())
        cases.append(("f32, prefill 1536 + 256 decode steps", False,
                      ((0, 1536),), (1791,), m32, p32, XLSTM_F32_TOL))
    _zero_counts()
    errs, held, n_checks, ref_cache = [], 0, 0, {}
    with torch.no_grad():
        for case, patches, pieces, at, m, p, tol in cases:
            def reference(n):
                """The cacheless prefill's logits at position n - 1, and
                its keep masks."""
                key = (patches, n, m.dtype)
                if key not in ref_cache:
                    ref_cache[key] = logged(
                        lambda: m.prefill(p, batch_upto(patches, n))[0])
                return ref_cache[key]

            side = []                      # the cached side's keep masks
            for a, b in pieces:
                if a == 0:
                    (last, st), masks = logged(lambda: m.prefill(
                        p, batch_upto(patches, b), s_alloc=2048))
                else:
                    (last, st), masks = logged(lambda: m.extend(
                        p, {"tokens": toks[:, a:b]}, st, a))
                side.append(masks)
            n = pieces[-1][1]
            checks = [(n, last)]
            while at and n <= max(at):
                tok = toks[:, n - 1024] if patches else toks[:, n]
                (dl, st), masks = logged(lambda: m.decode_step(
                    p, tok, st, pos(n)))
                side.append(masks)
                n += 1
                if n - 1 in at:
                    checks.append((n, dl))
            for n, lg in checks:
                ref, ref_masks = reference(n)
                assert torch.isfinite(lg).all() and lg.shape == ref.shape
                err = max_err(lg, ref)
                std = float(ref.float().std())
                note, same = "", True
                if is_moe:
                    # per layer, the cached passes' masks over tokens [0, n)
                    mine = [torch.cat([q[i] for q in side], 1)[:, :n]
                            for i in range(len(ref_masks))]
                    differ = sum(int((x != y).sum())
                                 for x, y in zip(mine, ref_masks))
                    same = differ == 0
                    note = (f"; dropped assignments: cached passes "
                            f"{sum(int((~x).sum()) for x in mine)}, full "
                            f"forward {sum(int((~y).sum()) for y in ref_masks)}"
                            f", drop decisions differing {differ}")
                if tol is None and n > pieces[-1][1]:
                    print(f"models [families, {name}, {case}, logits at "
                          f"position {n - 1}]: max |logit - full forward| "
                          f"{err:.4g} (logit std {std:.4g}; printed, not "
                          f"held: bf16 rounding through {n - pieces[-1][1]} "
                          f"one-token passes; the f32 case holds the same "
                          f"decode)")
                    continue
                bound = FAMILY_LOGIT_TOL if tol is None else tol
                n_checks += 1
                print(f"models [families, {name}, {case}, logits at "
                      f"position {n - 1}]: max |logit - full forward| "
                      f"{err:.4g} (logit std {std:.4g}; tol {bound:g}{note}), "
                      f"argmax equal "
                      f"{bool((lg.argmax(-1) == ref.argmax(-1)).all())}"
                      + ("" if same else "; not held: the two sides "
                         "dropped different assignments"))
                if same:
                    assert err <= bound, (name, case, n, err)
                    errs.append(err)
                    held += 1
        if xlstm:
            # the reference's chunking refuses an extend of 384 tokens
            # (128 -> 512, a bucket-512 document at fractions 0.25 -> 1.0)
            _, st = model.prefill(params, {"tokens": toks[:, :128]},
                                  s_alloc=512)
            try:
                model.extend(params, {"tokens": toks[:, 128:512]}, st, 128)
                raise RuntimeError("an mLSTM extend of 384 tokens ran")
            except AssertionError as e:
                print(f"models [families, {name}]: extend 128 -> 512 raises "
                      f"AssertionError {e} (the reference's mlstm_chunk "
                      f"assertion T % min(256, T) == 0), as the reference "
                      f"does")
    assert held > 0, name
    torch.cuda.synchronize()
    counts = _counts()
    print(f"models [families, {name}]: {held} of {n_checks} positions held "
          f"within tol (max error {max(errs):.4g}); kernel launches "
          f"{json.dumps(counts)}")
    return counts


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return [_map_tensors(v, fn) for v in tree]


def family_serving_phase(label, models, params, cascades, docs, vocab, *,
                         recurrent: bool):
    """``serve [<label>]``: two queries over ``docs`` with the proxy and
    oracle of ``models``: a warm-up drain, then inflight 1 and 3 (and, for
    recurrent models, inflight 1 again), launch counters zeroed before each
    drain and read after.  Every document must resolve and the kernel
    launches match the server's.  Paged models: inflight=3 == inflight=1
    bitwise.  Recurrent models (gather plane): the two inflight=1 runs
    bitwise equal; the documents whose result differs between inflight 1
    and 3 are counted (a recycled arena row hands its recurrent state to
    the next document, in the reference too, and which row a document
    gets depends on the schedule).  Returns the inflight=1 counts."""
    runs = {}
    for run, inflight in (("warm-up", 1), ("inflight=1", 1),
                          ("inflight=3", 3)) + (
            (("inflight=1 again", 1),) if recurrent else ()):
        srv = make_server(models, params, inflight=inflight, vocab=vocab)
        for be in srv.backends.values():
            assert be.uses_paged_kv() == (not recurrent)
        results, counts, wall = drive(srv, cascades, docs)
        assert_resolved(results, docs)
        check_launches(srv, counts)
        n = sum(len(r.status) for r in results.values())
        p50, p99 = latency_ms(results)
        exits = [list(r.exit_stage.values()) for r in results.values()]
        print(f"serve [{label}, {run}]: {n} docs terminal and RESOLVED in "
              f"{wall:.3f} s ({n / wall:.2f} docs/s), {srv.stats().batches} "
              f"launches, latency p50 {p50:.1f} ms p99 {p99:.1f} ms, exit "
              f"stages {[[e.count(s) for s in range(3)] for e in exits]}, "
              f"kernel launches {json.dumps(counts)}")
        runs[run] = ({q: (r.pred, r.conf, r.doc_cost)
                      for q, r in results.items()}, counts)
    one, three = runs["inflight=1"][0], runs["inflight=3"][0]
    if not recurrent:
        assert three == one, f"{label}: inflight 3 != 1"
        print(f"serve [{label}]: inflight=3 == inflight=1 bitwise (preds, "
              f"confs, per-document $) over {len(docs)} docs x "
              f"{len(cascades)} queries")
    else:
        assert runs["inflight=1 again"][0] == one, \
            f"{label}: two inflight=1 runs differ"
        differ = sum(one[q][0][d] != three[q][0][d]
                     or one[q][1][d] != three[q][1][d]
                     or one[q][2][d] != three[q][2][d]
                     for q in one for d in one[q][0])
        preds = sum(one[q][0][d] != three[q][0][d]
                    for q in one for d in one[q][0])
        print(f"serve [{label}]: two inflight=1 runs bitwise equal; "
              f"inflight=3 differs from inflight=1 on {differ} of "
              f"{sum(len(v[0]) for v in one.values())} (query, document) "
              f"results ({preds} preds differ): a recycled gather-plane "
              f"row starts the next "
              f"document from the previous one's recurrent state, as in the "
              f"reference, and which row a document gets depends on the "
              f"schedule")
    if "--profile" in sys.argv[1:]:
        profile_serving(label, models, params, cascades, docs, vocab)
    return runs["inflight=1"][1]


def profile_serving(label, models, params, cascades, docs, vocab) -> None:
    """``--profile``: device kernels of one drain of 4 documents at
    inflight 1 with ``models`` (CUDA activity only: the recurrent cell
    launches hundreds of thousands of kernels); the wall clock comes from
    a run without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    sub = {d: docs[d] for d in sorted(docs)[:4]}

    def run():
        drive(make_server(models, params, inflight=1, vocab=vocab),
              cascades, sub)

    t0 = time.perf_counter()
    run()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    _report(f"{label} serving run, 2 queries x 4 docs, inflight=1",
            _device_kernels(prof), wall)


def moe_families_phase(docs):
    """qwen2-vl-2b (proxy) and phi3.5-moe cut to ``PHI_LAYERS`` layers
    (oracle): the model checks, then ``serve [moe oracle]``."""
    ms = family_models((("qwen2_vl_2b", 1, None),
                        ("phi3_5_moe", 2, PHI_LAYERS)))
    counts = [family_model_phase(a, *ms[a]) for a in ms]
    models = {"proxy": ms["qwen2_vl_2b"][0], "oracle": ms["phi3_5_moe"][0]}
    params = {"proxy": ms["qwen2_vl_2b"][1], "oracle": ms["phi3_5_moe"][1]}
    vocab = min(m.rcfg.base.vocab_size for m in models.values())
    serve_counts = family_serving_phase("moe oracle", models, params,
                                        tenant_cascades(), docs, vocab,
                                        recurrent=False)
    return counts, serve_counts


def recurrent_families_phase(docs):
    """xlstm-350m (proxy) and recurrentgemma-2b (oracle), full depth, as
    ``launch/serve.py``'s ``build_engine(full_width=True)`` builds them
    (seeds 1 and 2, a tokenizer of the smaller vocabulary): the model
    checks, then ``serve [recurrent]`` with the tenants' first stage at
    fraction 0.5."""
    from repro_torch.launch.serve import build_engine

    eng = build_engine(8, None, 64, proxy_arch="xlstm_350m",
                       oracle_arch="recurrentgemma_2b", device="cuda",
                       full_width=True)
    models = {n: be.model for n, be in eng.backends.items()}
    params = {n: be.params for n, be in eng.backends.items()}
    vocab = eng.backends["proxy"].tokenizer.vocab_size
    assert vocab == min(m.rcfg.base.vocab_size for m in models.values())
    counts = []
    for arch, name, seed in (("xlstm_350m", "proxy", 1),
                             ("recurrentgemma_2b", "oracle", 2)):
        assert models[name].rcfg.base.name == arch.replace("_", "-")
        describe_model(arch, models[name], params[name], seed)
        counts.append(family_model_phase(arch, models[name], params[name]))
    print(f"models [families]: built by build_engine(full_width=True), "
          f"tokenizer vocabulary {vocab}")
    print("serve [recurrent]: tenants' first stage at fraction 0.5: at 0.25 "
          "a bucket-512 document extends the xlstm proxy by 384 tokens "
          "(128 -> 512), which the reference's mLSTM chunking refuses")
    serve_counts = family_serving_phase("recurrent", models, params,
                                        tenant_cascades(0.5), docs, vocab,
                                        recurrent=True)
    return counts, serve_counts


def build_phase():
    """Construct a cascade from engine scores and serve it (paper Figure
    2, steps 1-5) at full width: llama3.2-1b proxy (seed 1) and
    qwen3-1.7b oracle (seed 2), bf16, batch 8, paged plane.  The launch
    counters are zeroed before step 1 and read after step 5."""
    from repro_torch.core.restructure import FEED_CHUNKS
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
    feeds = -(-n_chunks // FEED_CHUNKS)
    assert n_rel == feeds, (n_rel, n_chunks)
    T = restr.embedder.tokens("")[0].shape[0]
    fill = float(np.minimum(lens, T).mean() / T)

    res = served.main
    agree = float(np.mean([res.pred[i] == oracle_only.pred[i]
                           for i in test_ids]))
    lat = res.stats.latencies + served.strict.stats.latencies
    print(f"build: granularity {restr.granularity} lines, classifier F1 "
          f"{restr.f1:.4f}")
    print(f"build: {n_chunks} chunks scored over {len(docs)} documents "
          f"({n_rel} relevance_score launch{'es' if n_rel > 1 else ''}, one "
          f"per feed of up to {FEED_CHUNKS} chunks), mean fill "
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
    return counts, restr, docs, engine, reordered


def relevance_phase(dev, timer, restr, docs):
    """``relevance_score`` on the card: against its plain version on every
    document of the path, on the path's whole corpus in one launch, on a
    ragged chunk count with ``len = 0`` and ``len > T`` chunks, and on 4096
    chunks; bitwise: two calls, every document's own launch against its
    slice of the corpus launch, and chunks of the 4096 alone or in a slice
    against the full launch.  Timed at the path's first test document, at
    the path's corpus and at 4096 chunks, per call and back to back,
    beside the bound."""
    from repro_torch.kernels import relevance_score as rel
    from repro_torch.kernels.relevance_score import relevance_score_plain

    w, b = restr.head()
    err = 0.0
    own = []
    for d in docs:
        x, lengths = restr.chunk_inputs(d)
        k = rel.relevance_score(x, lengths, w, b)
        p = relevance_score_plain(x, lengths, w, b)
        torch.testing.assert_close(k, p, **REL_TOL)
        err = max(err, max_err(k, p))
        own.append(k)
    xh, lh, counts = restr.embed_corpus(docs)
    cases = {"path corpus": (xh.to(dev), lh.to(dev))}
    _, T, D = xh.shape
    all_lens = cases["path corpus"][1]
    g = torch.Generator(device=dev).manual_seed(3)
    # ragged C, an empty chunk and two overlong ones
    lens = all_lens[:13].clone()
    lens[0], lens[5], lens[9] = 0, T + 7, 3 * T
    cases["ragged"] = (torch.randn((13, T, D), generator=g, device=dev), lens)
    # corpus scale: the path's chunk lengths tiled to 4096 chunks
    lens = all_lens.repeat(4096 // len(all_lens) + 1)[:4096].contiguous()
    cases["corpus"] = (torch.randn((4096, T, D), generator=g, device=dev),
                       lens)
    outs = {}
    for name, (x, lens) in cases.items():
        k = rel.relevance_score(x, lens, w, b)
        p = relevance_score_plain(x, lens, w, b)
        torch.testing.assert_close(k, p, **REL_TOL)
        err = max(err, max_err(k, p))
        assert torch.equal(rel.relevance_score(x, lens, w, b), k), \
            f"relevance {name}: two calls differ"
        outs[name] = k
    torch.testing.assert_close(      # len 0 scores sigmoid(b)
        outs["ragged"][:1], torch.sigmoid(b), **REL_TOL)
    for k, e, c in zip(own, np.cumsum(counts), counts):
        assert torch.equal(k, outs["path corpus"][e - c: e]), \
            "a document's own launch differs from the corpus launch"
    x, lens = cases["corpus"]
    for lo, hi in ((0, 1), (1, 2), (777, 778), (4095, 4096), (1000, 1430)):
        assert torch.equal(rel.relevance_score(x[lo:hi], lens[lo:hi], w, b),
                           outs["corpus"][lo:hi]), (lo, hi)
    print(f"kernels [relevance_score]: two calls bitwise equal; each of "
          f"the {len(docs)} documents' own "
          f"launch bitwise equal to its slice of the corpus launch; chunks "
          f"of the 4096 alone and in slices bitwise equal to the full launch")

    def row(label, x, lengths):
        C = x.shape[0]
        n = float(torch.clamp(lengths, 0, T).sum())
        b_ms, b_by = bound(rel.work(C, T, D, lengths.tolist()), f32=True)
        xs = [x] + [x.clone() for _ in range(timer.copies(n * D * 4) - 1)]
        fns = [functools.partial(rel.relevance_score, xi, lengths, w, b)
               for xi in xs]
        r = dict(C=C, bound_ms=b_ms, bound_by=b_by, ms=timer.ms(fns[0]),
                 stream_ms=timer.stream_ms(fns),
                 plain_ms=timer.ms(lambda: relevance_score_plain(
                     x, lengths, w, b)))
        print(f"kernel relevance_score [{label}, C={C}]: max_abs_err "
              f"{err:.3g} (tol atol={REL_TOL['atol']:g} "
              f"rtol={REL_TOL['rtol']:g}), kernel {r['ms']:.4f} ms per call, "
              f"stream {r['stream_ms']:.4f} ms back to back over "
              f"{len(xs)} input copies; plain {r['plain_ms']:.4f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})")
        return r

    row("path, one document", *restr.chunk_inputs(docs[12]))
    path = row("path, corpus", *cases["path corpus"])
    row("corpus", *cases["corpus"])
    return dict(
        name="relevance_score", route="cuda",
        source="src/repro_torch/kernels/csrc/relevance_score.cu",
        replaces="src/repro/kernels/relevance_score.py:41",
        max_abs_err=err, ms=path["ms"], stream_ms=path["stream_ms"],
        plain_ms=path["plain_ms"], bound_ms=path["bound_ms"],
        bound_by=path["bound_by"], library_ms=None)


def restructure_breakdown(dev, docs, reordered) -> None:
    """The build path's restructure step once more from a fresh
    restructurer (cold word cache), in its parts, as ``score_corpus`` runs
    them: classifier fit, the head placed on the device, host embedding of
    every chunk, the enqueue of the copies and launches, the wait for the
    scores, the reorder; on the device, the copies and the kernel by CUDA
    events."""
    from repro_torch.core.restructure import (DocumentRestructurer,
                                              SyntheticOracle)
    from repro_torch.launch import construct

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    r = DocumentRestructurer(construct.OPS["o_orig"], device=dev).fit(
        docs[:12], SyntheticOracle(noise=construct.ORACLE_NOISE))
    t.append(time.perf_counter())
    w, b = r.head()
    t.append(time.perf_counter())
    x, lengths, counts = r.embed_corpus(docs)
    t.append(time.perf_counter())
    ev[0].record()
    scores = r.score_inputs(x, lengths, w, b)
    ev[1].record()
    t.append(time.perf_counter())
    scores = scores.cpu().numpy()
    t.append(time.perf_counter())
    texts = [d.reordered(r.order_lines(d, scores[e - c: e])).text
             for d, e, c in zip(docs, np.cumsum(counts), counts)]
    t.append(time.perf_counter())
    assert texts == [reordered[d.doc_id] for d in docs], "breakdown rerun"
    parts = np.diff(t) * 1e3
    print(f"build: restructure breakdown (rerun, cold word cache): wall "
          f"{(t[-1] - t[0]) * 1e3:.3f} ms = fit {parts[0]:.3f} + head to "
          f"the device {parts[1]:.3f} + embed on the host {parts[2]:.3f} + "
          f"enqueue copies and launches {parts[3]:.3f} + wait for the "
          f"scores {parts[4]:.3f} + reorder {parts[5]:.3f} ms; on the "
          f"device: copy of {x.numel() * 4 / 1e6:.1f} MB and kernel "
          f"{ev[0].elapsed_time(ev[1]):.4f} ms")


def _device_kernels(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _kernel_class(name: str) -> str:
    if "decode_partial_kernel" in name or "decode_combine_kernel" in name:
        return "decode attention (ours)"
    if "flash_attention_tc_kernel" in name \
            or "flash_attention_kernel" in name:
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


def profile_phase(models, params, docs, oracle, gemma3) -> None:
    """Where the time goes (``--profile``): ``torch.profiler`` device
    kernels of one paged decode step of each model (the llama3.2-1b of
    the serving phase, the qwen3-1.7b oracle of the build phase), of one
    paged serving run, of the same-op ladder over the prefix phase's
    operations on the doc-before-op plane and on the prefix plane at both
    layout blocks, and of a gemma3-oracle serving run over 8 of its
    documents (two of them in bucket 1024); wall clocks come from runs
    without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    g_model, g_params, g_cascades, g_docs = gemma3
    ms = {"proxy": models["proxy"], "oracle": g_model}
    ps = {"proxy": params["proxy"], "oracle": g_params}
    keep = sorted(g_docs)[:6] + sorted(g_docs)[-2:]
    g_sub = {d: g_docs[d] for d in keep}

    def g_run():
        drive(make_server(ms, ps, inflight=1), g_cascades, g_sub)

    t0 = time.perf_counter()
    g_run()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=acts) as prof:
        g_run()
    _report("gemma3-oracle serving run, 2 queries x 8 docs, inflight=1",
            _device_kernels(prof), wall)
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

    ladder = [same_op_ladder()]
    for block in (None,) + PREFIX_BLOCKS:
        kw = {} if block is None else dict(prefix_sharing=True,
                                           layout_block=block)

        def run():
            srv = make_server(models, params, inflight=1, ops=PREFIX_OPS,
                              **kw)
            drive(srv, ladder, sub)

        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=acts) as prof:
            run()
        layout = ("doc-before-op" if block is None
                  else f"prefix block={block}")
        _report(f"same-op ladder, {layout}, 8 docs", _device_kernels(prof),
                wall)


# ---------------------------------------------------------------------------
# whisper-base and training
# ---------------------------------------------------------------------------

# The attention gradient on the card (``FlashAttentionFn``: the flash
# kernel's forward, ``flash_attention_grad``'s f32 backward, gradients
# rounded to bf16) against autograd through the plain version on the same
# bf16 inputs (f32 throughout, rounded to bf16 at the end).  The two
# differ where the backward reads the kernel's bf16 output in
# ``rowsum(dout * out)`` (the plain version's own output is f32 before
# its rounding) and by the final bf16 rounding: a few bf16 ulps of the
# largest gradient.  The bound is 2**-6 of each gradient's largest
# magnitude (4 ulps there); a mask off by one key moves a gradient by
# the order of the gradient itself.
GRAD_REL_TOL = 2 ** -6
# (case, B, Sq, Skv, Hq, Hkv, Dh, mask, kv_len per row)
GRAD_CASES = (
    ("llama3.2-1b training, causal, kv_len [2048, 1500]", 2, 2048, 2048,
     32, 8, 64, dict(causal=True), [2048, 1500]),
    ("whisper encoder, bidirectional", 2, 1536, 1536, 8, 8, 64,
     dict(causal=False), None),
    ("whisper cross, 64 over 1536", 8, 64, 1536, 8, 8, 64,
     dict(causal=False), None),
    ("gemma3-27b, window 1024", 1, 2048, 2048, 32, 16, 128,
     dict(causal=True, window=1024), None),
)
TRAIN_STEPS = 20
TRAIN_SEQ = 2048
TRAIN_BATCH = 2
WHISPER_PROMPT = 64
WHISPER_ALLOC = 128
WHISPER_DECODE = 32
WHISPER_TRAIN_STEPS = 5
WHISPER_TRAIN_SEQ = 448       # whisper's decoder context (n_text_ctx)


def whisper_kernel_phase(dev, timer):
    """``kernels [whisper-base]``: the dense flash kernel at whisper's
    attention shapes (8 query / 8 KV heads, head_dim 64, bf16) against
    its plain version: the encoder's bidirectional self-attention over
    1536 frames, cross-attention of one decode token and of a 64-token
    prompt over 1536 keys.  Two calls bitwise equal; kernel, plain and
    SDPA (no mask) times beside the bound.  Returns the rows."""
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(19)
    H, Dh, Skv = 8, 64, 1536

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    rows = []
    for case, B, Sq in (("encoder Sq=Skv=1536", 2, Skv),
                        ("cross Sq=1 over 1536", 8, 1),
                        ("cross Sq=64 over 1536", 8, 64)):
        q, k, v = rand(B, Sq, H, Dh), rand(B, Skv, H, Dh), rand(B, Skv, H, Dh)
        kw = dict(causal=False)
        out = ops.attention(q, k, v, **kw)
        plain = fla.flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(out.float(), plain.float(), **EXTEND_TOL)
        assert torch.equal(ops.attention(q, k, v, **kw), out), \
            f"whisper {case}: two calls differ"
        b_ms, b_by = bound(fla.work(B, Sq, H, H, Dh, Skv, causal=False))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        rows.append(dict(
            name="flash_attention", case=case,
            max_abs_err=max_err(out, plain),
            ms=timer.ms(lambda: ops.attention(q, k, v, **kw)),
            plain_ms=timer.ms(lambda: fla.flash_attention_plain(q, k, v,
                                                                **kw)),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt)),
            bound_ms=b_ms, bound_by=b_by))
    for r in rows:
        print(f"kernel flash_attention [whisper-base shapes, {r['case']}]: "
              f"max_abs_err {r['max_abs_err']:.3g} (tol "
              f"atol={EXTEND_TOL['atol']:g} rtol={EXTEND_TOL['rtol']:g}), "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    print("kernels [whisper-base]: encoder and cross-attention: two calls "
          "bitwise equal")
    return rows


def grad_phase(dev, timer):
    """``grad [attention]``: ``FlashAttentionFn``'s dq/dk/dv (kernel
    forward, PyTorch backward) against ``torch.autograd.grad`` through
    the plain version on the same bf16 inputs, within ``GRAD_REL_TOL`` of
    each gradient's largest magnitude; two calls bitwise equal.  Shapes:
    llama3.2-1b training (B 2, 2048, 32/8, causal, ragged ``kv_len``),
    whisper's encoder (1536, bidirectional) and cross-attention (64 over
    1536), gemma3's window 1024 (2048, 32/16, head_dim 128).  Times the
    backward alone (``flash_attention_grad`` on the saved tensors) beside
    the kernel's forward and SDPA's forward plus backward (with the same
    mask; a yardstick only).  Returns the llama row's times."""
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(21)
    out_row = None
    for case, B, Sq, Skv, Hq, Hkv, Dh, kw, kl in GRAD_CASES:
        def rand(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)
        q, k, v = rand(B, Sq, Hq, Dh), rand(B, Skv, Hkv, Dh), \
            rand(B, Skv, Hkv, Dh)
        dout = rand(B, Sq, Hq, Dh)
        kv_len = None if kl is None else torch.tensor(
            kl, dtype=torch.int32, device=dev)
        kw = dict(kw, kv_len=kv_len)

        def kernel_grads():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = ops.attention(*leaves, **kw)
            assert out.grad_fn is not None and \
                type(out.grad_fn).__name__.startswith("FlashAttentionFn")
            return out, torch.autograd.grad(out, leaves, dout)

        out, grads = kernel_grads()
        assert all(torch.equal(a, b) for a, b in zip(grads,
                                                     kernel_grads()[1])), \
            f"grad [{case}]: two calls differ"
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        ref = torch.autograd.grad(fla.flash_attention_plain(*leaves, **kw),
                                  leaves, dout)
        errs = []
        for name, a, b in zip("qkv", grads, ref):
            peak = float(b.float().abs().max())
            err = max_err(a, b)
            errs.append(f"d{name} {err:.3g} of peak {peak:.3g}")
            assert torch.isfinite(a.float()).all() and \
                err <= GRAD_REL_TOL * peak, (case, name, err, peak)
        del ref, leaves
        saved = (q, k, v, out.detach(), dout)
        bwd = timer.ms(lambda: fla.flash_attention_grad(*saved, **kw),
                       reps=5)
        fwd = timer.ms(lambda: ops.attention(q, k, v, **kw), reps=5)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        mask = None
        if kl is not None or kw.get("window") or kw["causal"]:
            lens = kv_len if kv_len is not None else torch.full(
                (B,), Skv, dtype=torch.int32, device=dev)
            mask = (window_mask(lens, Sq, Skv, 0, kw["window"], dev)
                    if kw.get("window") else
                    sdpa_mask(lens, Sq, Skv, 0, kw["causal"], dev))
        dt = dout.transpose(1, 2)

        def sdpa_fb():
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=True)
            torch.autograd.grad(o, (qt, kt, vt), dt)

        lib = timer.ms(sdpa_fb, reps=5)
        print(f"grad [attention, {case}]: {', '.join(errs)} (bound "
              f"{GRAD_REL_TOL:g} x peak); two calls bitwise equal; "
              f"backward {bwd:.4f} ms, kernel forward {fwd:.4f} ms, sdpa "
              f"forward + backward {lib:.4f} ms")
        if out_row is None:
            out_row = dict(bwd_ms=bwd, fwd_ms=fwd, sdpa_fb_ms=lib)
        del saved, out, grads
    return out_row


def _nonzero_finite_grads(model, params, batch) -> float:
    """One loss and gradient outside the step: every leaf's gradient
    finite and nonzero.  Returns the loss."""
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = model.loss(live, batch)
    grads = torch.autograd.grad(loss, leaves(live))
    for (name, _), gr in zip(leaves_with_paths(params), grads):
        assert torch.isfinite(gr.float()).all(), f"{name}: non-finite grad"
        assert float(gr.float().abs().max()) > 0, f"{name}: zero gradient"
    loss = float(loss.detach())
    print(f"train [{model.rcfg.base.name}]: every one of {len(grads)} "
          f"leaves has a finite nonzero gradient (loss {loss:.4f})")
    return loss


def _timed_step_parts(model, params, opt, batch, tc) -> dict:
    """One training step cut into its parts on the host clock around
    synchronised work: forward (the loss), backward, optimizer; the
    attention backward's device time inside the backward from CUDA events
    around every ``flash_attention_grad`` call, the attention forward's
    from events around every kernel launch."""
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.train_loop import batch_to_device
    from repro_torch.models.convert import jax_ndims
    from repro_torch.tree import leaves, tree_map

    spans = {"attn_bwd": [], "attn_fwd": []}
    orig_grad, orig_fwd = fla.flash_attention_grad, fla.flash_attention

    def timed(fn, key):
        def wrapped(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            spans[key].append((e0, e1))
            return out
        return wrapped

    fla.flash_attention_grad = timed(orig_grad, "attn_bwd")
    fla.flash_attention = timed(orig_fwd, "attn_fwd")
    try:
        batch = batch_to_device(batch, model.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = model.loss(live, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves(live))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        it = iter(grads)
        adamw_update(tc.opt, params, tree_map(lambda _: next(it), params),
                     opt, jax_ndims(params, model.rcfg))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        fla.flash_attention_grad, fla.flash_attention = orig_grad, orig_fwd
    dev_ms = {k: sum(a.elapsed_time(b) for a, b in v)
              for k, v in spans.items()}
    return dict(fwd_ms=(t1 - t0) * 1e3, bwd_ms=(t2 - t1) * 1e3,
                opt_ms=(t3 - t2) * 1e3, step_ms=(t3 - t0) * 1e3,
                attn_bwd_ms=dev_ms["attn_bwd"],
                attn_fwd_ms=dev_ms["attn_fwd"],
                attn_bwd_calls=len(spans["attn_bwd"]))


def train_llama_phase():
    """``train [llama3.2-1b]``: full width and depth (16 layers), bf16
    parameters, f32 moments; ``TRAIN_STEPS`` steps of ``make_train_step``
    on ``SyntheticLMTask(vocab 128256, seq 2048)``, batch 2, from a
    ``DataPipeline``.  Every loss finite, every leaf a finite nonzero
    gradient, the mean loss of the last five steps below the first five;
    then a ``Checkpointer``
    checkpoint, restored bitwise, resumed 2 steps and held against 2
    straight steps within the spread of two resumed runs.  Returns the
    launch counts of the 20 steps."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.config import resolve
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataPipeline, ShardPlan,
                                           SyntheticLMTask)
    from repro_torch.models.model import LM
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.train_loop import (TrainConfig, batch_to_device,
                                              make_train_step)
    from repro_torch.tree import leaves, tree_map

    cfg = get_config("llama3_2_1b")
    model = LM(resolve(cfg, tp=1), device="cuda")
    params = model.init(seed=3)
    opt = init_opt_state(params)
    n_params = sum(t.numel() for t in leaves(params))
    state_gb = sum(t.numel() * t.element_size()
                   for t in leaves((params, opt))) / 1e9
    print(f"train [llama3.2-1b]: full width and depth ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, vocab {model.rcfg.padded_vocab}), "
          f"{n_params / 1e9:.3f} B params bf16, moments f32: "
          f"{state_gb:.2f} GB of state; batch {TRAIN_BATCH} x {TRAIN_SEQ}")
    tc = TrainConfig(opt=OptimizerConfig(lr=3e-4, warmup_steps=5,
                                         total_steps=TRAIN_STEPS + 2))
    step = make_train_step(model, None, tc)
    task = SyntheticLMTask(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ)
    plan = ShardPlan(n_shards=2, n_hosts=1)

    def pipe_at(n):
        p = DataPipeline(task, plan, host=0,
                         batch_per_shard=TRAIN_BATCH // 2)
        p.step = n
        return p

    _nonzero_finite_grads(model, params,
                          batch_to_device(next(pipe_at(0)), model.device))
    # one step (on a batch of its own) cut into its parts, then the run
    parts = _timed_step_parts(model, params, opt, next(pipe_at(99)), tc)
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    pipe, losses, walls = pipe_at(0), [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, next(pipe))
        loss = float(m["loss"])
        walls.append(time.perf_counter() - t0)
        assert math.isfinite(loss), (i, loss)
        losses.append(loss)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"train [llama3.2-1b]: losses {[round(l, 4) for l in losses]}")
    # each step's batch holds new random sequences, so single losses
    # scatter by ~0.2: the check compares the first five with the last five
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first, ("the loss did not fall", first, last)
    steady = sorted(walls[2:])[len(walls[2:]) // 2]
    tok_s = TRAIN_BATCH * TRAIN_SEQ / steady
    print(f"train [llama3.2-1b]: mean loss of the first five steps "
          f"{first:.4f} -> the last five {last:.4f}; step wall median "
          f"{steady * 1e3:.1f} "
          f"ms (first {walls[0] * 1e3:.1f} ms), {tok_s:.0f} tokens/s; peak "
          f"memory {peak:.2f} GB; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    print(f"train [llama3.2-1b]: one step in parts: forward "
          f"{parts['fwd_ms']:.1f} ms, backward {parts['bwd_ms']:.1f} ms, "
          f"optimizer {parts['opt_ms']:.1f} ms, step {parts['step_ms']:.1f} "
          f"ms; attention backward {parts['attn_bwd_ms']:.1f} ms device "
          f"over {parts['attn_bwd_calls']} layers "
          f"({100 * parts['attn_bwd_ms'] / parts['step_ms']:.1f}% of the "
          f"step), attention forward kernels {parts['attn_fwd_ms']:.1f} ms "
          f"({100 * parts['attn_fwd_ms'] / parts['step_ms']:.1f}%), "
          f"optimizer {100 * parts['opt_ms'] / parts['step_ms']:.1f}%")
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ck = Checkpointer(d, keep=1)
        at = int(opt.step)
        t0 = time.perf_counter()
        ck.save(at, {"params": params, "opt": opt})
        ck.wait()
        t_save = time.perf_counter() - t0
        # restore reads only each leaf's path, device and dtype
        like = tree_map(lambda t: t.new_empty(0),
                        {"params": params, "opt": opt})
        t0 = time.perf_counter()
        restored = ck.restore(at, like)
        t_restore = time.perf_counter() - t0
        for a, b in zip(leaves((params, opt)), leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b), \
                "restore is not bitwise"
        print(f"train [llama3.2-1b]: checkpoint of {state_gb:.2f} GB saved "
              f"in {t_save:.1f} s, restored bitwise in {t_restore:.1f} s")

        def two_steps(p, o):
            it = pipe_at(TRAIN_STEPS)
            for _ in range(2):
                p, o, _ = step(p, o, next(it))
            return p

        straight = two_steps(params, opt)          # in place
        del opt
        resumed = two_steps(restored["params"], restored["opt"])
        del restored
        again = ck.restore(at, like)
        resumed2 = two_steps(again["params"], again["opt"])
        del again
        diff = lambda a, b: max(max_err(x, y) for x, y in  # noqa: E731
                                zip(leaves(a), leaves(b)))
        spread = diff(resumed, resumed2)
        err = diff(straight, resumed)
        print(f"train [llama3.2-1b]: resumed 2 steps vs 2 straight steps: "
              f"max |param diff| {err:.3g}; two resumed runs differ by "
              f"{spread:.3g} (bound: 2 x that spread)")
        assert err <= 2 * spread, (err, spread)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return counts, dict(parts, peak_gb=peak, step_wall_ms=steady * 1e3,
                        losses=losses)


def whisper_phase():
    """``models [whisper-base]`` + ``train [whisper-base]``: full width
    and depth (6 + 6 layers, d_model 512, 1536 frames, vocab 51865), bf16,
    random weights (seed 4), frame embeddings from a seed.  Encode,
    prefill a 64-token prompt into self caches of 128 positions, run 32
    decode steps (teacher-forced tokens); the prefill's last logits and
    every decode step's are held against the cacheless forward of the
    same 96 tokens within ``FAMILY_LOGIT_TOL``.  Then 5 steps of
    ``make_train_step`` on 448-token sequences with seeded
    ``frame_emb``: finite losses, every leaf a finite nonzero gradient.
    Returns (model-check launches, training launches)."""
    from repro_torch.config import resolve
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMTask
    from repro_torch.models.whisper import WhisperModel
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.train_loop import (TrainConfig, batch_to_device,
                                              make_train_step)
    from repro_torch.tree import leaves

    cfg = get_config("whisper_base")
    model = WhisperModel(resolve(cfg, tp=1), device="cuda")
    params = model.init(seed=4)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    print(f"models [whisper-base]: full width and depth ({cfg.encoder_layers}"
          f" encoder + {cfg.num_layers} decoder layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"{cfg.encoder_seq_len} frames, vocab {model.rcfg.padded_vocab}), "
          f"bf16, {n_bytes / 1e6:.1f} MB of random weights (seed 4)")
    g = torch.Generator(device="cuda").manual_seed(8)
    B, n = 2, WHISPER_PROMPT + WHISPER_DECODE + 1
    frames = (torch.randn((B, cfg.encoder_seq_len, cfg.d_model),
                          generator=g, device="cuda") * 0.02)
    toks = torch.randint(9, cfg.vocab_size, (B, n), generator=g,
                         device="cuda")
    _zero_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, st = model.prefill(
            params, {"frame_emb": frames,
                     "tokens": toks[:, :WHISPER_PROMPT]},
            s_alloc=WHISPER_ALLOC)
        got = [logits]
        for i in range(WHISPER_PROMPT, n - 1):        # 32 decode steps
            logits, st = model.decode_step(
                params, toks[:, i], st,
                torch.full((B,), i, dtype=torch.int32, device="cuda"))
            got.append(logits)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        full, _ = model.forward(params, {"frame_emb": frames,
                                         "tokens": toks[:, :n - 1]})
    ref = full[:, WHISPER_PROMPT - 1:]
    got = torch.stack(got, 1)
    err = max_err(got, ref)
    print(f"models [whisper-base]: prefill {WHISPER_PROMPT} (s_alloc "
          f"{WHISPER_ALLOC}) + {WHISPER_DECODE} decode steps in "
          f"{wall:.2f} s: max |logit - cacheless forward| {err:.4f} over "
          f"{WHISPER_DECODE + 1} positions (tol {FAMILY_LOGIT_TOL}, logit std "
          f"{float(ref.std()):.3f}); launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    assert torch.isfinite(got).all() and err <= FAMILY_LOGIT_TOL, err
    assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0
    del st, full, got, ref

    task = SyntheticLMTask(vocab_size=cfg.vocab_size,
                           seq_len=WHISPER_TRAIN_SEQ)
    rng = np.random.default_rng(9)

    def batch(i):
        b = task.batch(9, 0, i, B)
        b["frame_emb"] = (0.02 * rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
        return b

    _nonzero_finite_grads(model, params,
                          batch_to_device(batch(0), model.device))
    opt = init_opt_state(params)
    step = make_train_step(model, None, TrainConfig(opt=OptimizerConfig(
        lr=3e-4, warmup_steps=2, total_steps=WHISPER_TRAIN_STEPS)))
    _zero_counts()
    losses, walls = [], []
    for i in range(WHISPER_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch(i))
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
        assert math.isfinite(losses[-1]), losses
    train_counts = _counts()
    print(f"train [whisper-base]: {WHISPER_TRAIN_STEPS} steps of "
          f"make_train_step, batch {B} x {WHISPER_TRAIN_SEQ} tokens over "
          f"{cfg.encoder_seq_len} frames: losses "
          f"{[round(l, 4) for l in losses]}, step wall "
          f"{[round(w * 1e3, 1) for w in walls]} ms; launches "
          f"{ {k: v for k, v in train_counts.items() if v} }")
    assert train_counts["flash_attention"] > 0
    return counts, train_counts


# ---------------------------------------------------------------------------
# distributed: the LSE kernel over seq shards, and the NCCL world
# ---------------------------------------------------------------------------

DIST_SEED = 11
DIST_HEADS = (32, 8, 64)           # llama3.2-1b's query / KV heads, head_dim
DIST_S = 131072                    # keys of the bf16 cache (268 MB of K/V)
DIST_SHARDS = 4
DIST_LENS = (0, 1, 32767, 32768, 32769, 98304, 131072)
DIST_TRAIN_STEPS = 3
DIST_PREFILL = 8192
DIST_DECODE = 32
DIST_TIMEOUT_S = 600.0


def _dist_cache(dev):
    """(q, k, v) of the distributed phase, the same on every device."""
    Hq, Hkv, Dh = DIST_HEADS
    g = torch.Generator(device=dev).manual_seed(DIST_SEED)
    rand = lambda *s: torch.randn(s, generator=g,  # noqa: E731
                                  device=dev).to(torch.bfloat16)
    return rand(1, Hq, Dh), rand(1, DIST_S, Hkv, Dh), rand(1, DIST_S, Hkv, Dh)


def lse_shards_phase(dev, timer):
    """``distributed [lse]``: ``decode_attention_lse`` over each of four
    seq shards of a 131072-key bf16 cache at llama3.2-1b's heads, merged
    by ``collectives.merge_lse`` (the rule ``sp_decode_attention`` applies
    after its all-reduces), against the decode kernel over the whole
    cache and the plain version within ``DECODE_TOL`` at every
    ``DIST_LENS``; one shard's LSE triple against
    ``decode_attention_lse_plain``; two calls bitwise; per-shard times
    beside the bound and SDPA.  Returns (the kernels row, {kv_len: merged
    output on the host})."""
    from repro_torch.distributed.collectives import merge_lse
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops

    Hq, Hkv, Dh = DIST_HEADS
    q, k, v = _dist_cache(dev)
    s = DIST_S // DIST_SHARDS
    shard = lambda t, i: t[:, i * s:(i + 1) * s]  # noqa: E731

    def sharded(kl):
        return [ops.decode_attention_lse(
            q, shard(k, i), shard(v, i), torch.clamp(kl - i * s, 0, s))
            for i in range(DIST_SHARDS)]

    merged, err_whole, err_plain = {}, 0.0, 0.0
    for n in DIST_LENS:
        kl = torch.tensor([n], dtype=torch.int32, device=dev)
        parts = sharded(kl)
        out = merge_lse(parts, q.dtype)
        again = sharded(kl)
        assert all(torch.equal(a, b) for a, b in zip(parts, again)), \
            "decode_attention_lse: two calls differ"
        assert torch.equal(merge_lse(again, q.dtype), out)
        whole = ops.decode_attention(q, k, v, kl)
        plain = dec.decode_attention_plain(q, k, v, kl)
        torch.testing.assert_close(out.float(), whole.float(), **DECODE_TOL)
        torch.testing.assert_close(out.float(), plain.float(), **DECODE_TOL)
        err_whole = max(err_whole, max_err(out, whole))
        err_plain = max(err_plain, max_err(out, plain))
        merged[n] = out.cpu()
    print(f"distributed [lse, llama3.2-1b shapes, {DIST_S} keys in "
          f"{DIST_SHARDS} shards of {s}]: merged output at kv_len "
          f"{list(DIST_LENS)} within tol of the decode kernel over the whole "
          f"cache (max_abs_err {err_whole:.3g}) and of the plain version "
          f"({err_plain:.3g}; tol atol={DECODE_TOL['atol']:g} "
          f"rtol={DECODE_TOL['rtol']:g}); two calls bitwise equal")
    # one shard's triple against the plain version: m exact where no key
    # is seen, l and acc relative to l (acc / l mixes values of size ~1)
    kl = torch.tensor([3 * s // 2], dtype=torch.int32, device=dev)
    got = ops.decode_attention_lse(q, shard(k, 1), shard(v, 1), kl - s)
    want = dec.decode_attention_lse_plain(q, shard(k, 1), shard(v, 1), kl - s)
    l = want[..., -2]
    m_err = max_err(got[..., -1], want[..., -1])
    l_err = float(((got[..., -2] - l).abs() / l).max())
    a_err = float(((got[..., :Dh] - want[..., :Dh]).abs() / l[..., None])
                  .max())
    print(f"distributed [lse]: shard 1 at local kv_len {s // 2}: |m - plain| "
          f"{m_err:.3g}, |l - plain| / l {l_err:.3g}, |acc - plain| / l "
          f"{a_err:.3g} (bound 1e-5 each)")
    assert max(m_err, l_err, a_err) <= 1e-5, (m_err, l_err, a_err)
    empty = ops.decode_attention_lse(q, shard(k, 2), shard(v, 2),
                                     torch.zeros_like(kl))
    assert torch.isneginf(empty[..., -1]).all() and \
        not empty[..., :-1].any(), "a shard with no key: m -inf, l acc 0"

    full = torch.tensor([s], dtype=torch.int32, device=dev)
    k0, v0 = shard(k, 0), shard(v, 0)
    b_ms, b_by = bound(dec.work(1, Hq, Hkv, Dh, s, kv_len=[s], lse=True))
    row = dict(
        name="decode_attention_lse", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:107",
        max_abs_err=err_plain,
        ms=timer.ms(lambda: ops.decode_attention_lse(q, k0, v0, full)),
        plain_ms=timer.ms(lambda: dec.decode_attention_lse_plain(
            q, k0, v0, full)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k0.transpose(1, 2), v0.transpose(1, 2),
            enable_gqa=True)))
    print(f"kernel decode_attention_lse [llama3.2-1b shapes, one shard of "
          f"{s} keys]: kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); the whole cache's "
          f"bound {row['bound_ms'] * DIST_SHARDS:.4f} ms")
    # the same body in its normal mode, over the shard and the whole cache
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    whole = torch.tensor([DIST_S], dtype=torch.int32, device=dev)
    n_ms = timer.ms(lambda: ops.decode_attention(q, k0, v0, full))
    w_ms = timer.ms(lambda: ops.decode_attention(q, k, v, whole))
    w_sdpa = timer.ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kt, vt, enable_gqa=True))
    print(f"kernel decode_attention [B=1, llama3.2-1b shapes]: over the "
          f"shard {n_ms:.4f} ms; over all {DIST_S} keys {w_ms:.4f} ms, sdpa "
          f"{w_sdpa:.4f} ms")
    return row, merged


def _dist_train(model, mesh, dev, world):
    """Full-width llama3.2-1b through the port's two data-parallel steps,
    ``DIST_TRAIN_STEPS`` steps each on the same batches, each beside the
    mesh-less step from the same init with the same configuration:

    * ``dp``: the replicated step of ``make_train_step(model, mesh)`` (the
      launcher's, ``launch/train.py``): every rank cuts its shard of the
      global batch (``local_batch``), its gradients all-reduced over
      ``data`` by ``dp_reduce_grads``, moments replicated; lr 3e-4 from
      the first step (``warmup_steps=1``), so the parameters move;
    * ``zero``: the sharded step ``launch/specs.build_case("llama3_2_1b",
      "train_4k", mesh)`` builds (each rank its own batch shard,
      ``zero_reduce_grads``, ZeRO-1 moments; AdamW's defaults).

    For each: the losses, at world 1 bitwise equality with the mesh-less
    step (losses and every updated parameter), from world 2 every rank
    holding rank 0's parameters, the step walls and the gradient
    reduction's device time (CUDA events around the reduction)."""
    from repro_torch.data.pipeline import SyntheticLMTask
    from repro_torch.distributed.sharding import tree_pspecs
    from repro_torch.launch.specs import build_case, make_model
    from repro_torch.models.convert import shard_params
    from repro_torch.train import train_loop
    from repro_torch.train.optimizer import OptimizerConfig, \
        init_opt_state, zero_layout
    from repro_torch.tree import leaves

    task = SyntheticLMTask(vocab_size=model.rcfg.base.vocab_size,
                           seq_len=TRAIN_SEQ)
    batches = [task.batch(0, 0, i, TRAIN_BATCH * world)
               for i in range(DIST_TRAIN_STEPS)]

    def run(step, params, opt, shard=lambda b: b):
        losses, walls = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, shard(b))
            losses.append(float(met["loss"]))
            walls.append(time.perf_counter() - t0)
        del opt
        return params, losses, walls

    def timed_run(reduction, *args):
        """``run`` with CUDA events around ``train_loop.<reduction>``;
        (params, losses, walls, reduction ms, launches)."""
        spans, orig = [], getattr(train_loop, reduction)

        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig(*a, **kw)
            e1.record()
            spans.append((e0, e1))
            return out

        setattr(train_loop, reduction, timed)
        try:
            _zero_counts()
            out = run(*args)
            counts = _counts()
        finally:
            setattr(train_loop, reduction, orig)
        torch.cuda.synchronize()
        return (*out, [a.elapsed_time(b) for a, b in spans], counts)

    def summary(tc, got, start):
        params, losses, walls, red_ms, counts = got
        res = dict(losses=losses, wall_ms=[w * 1e3 for w in walls],
                   reduce_ms=red_ms, counts=counts,
                   n_params=sum(t.numel() for t in leaves(params)))
        if world > 1:
            # every rank must hold rank 0's parameters bit for bit
            import torch.distributed as dist
            same = True
            for t in leaves(params):
                rank0 = t.clone()
                dist.broadcast(rank0, src=0)
                same &= torch.equal(rank0, t)
            res["replicated"] = same
        else:
            p = start()
            ref, ref_losses, _ = run(train_loop.make_train_step(
                model, None, tc), p, init_opt_state(p))
            res["bitwise"] = ref_losses == losses and all(
                torch.equal(a, b) for a, b in zip(leaves(ref),
                                                  leaves(params)))
            res["ref_losses"] = ref_losses
        return res

    # (1) the replicated data-parallel step
    tc = train_loop.TrainConfig(opt=OptimizerConfig(
        lr=3e-4, warmup_steps=1, total_steps=DIST_TRAIN_STEPS))
    p = model.init(seed=3)
    got = timed_run("dp_reduce_grads",
                    train_loop.make_train_step(model, mesh, tc), p,
                    init_opt_state(p))
    del p
    dp = summary(tc, got, lambda: model.init(seed=3))
    del got
    gc.collect()
    torch.cuda.empty_cache()
    # (2) build_case's sharded step, ZeRO-1 moments
    case = build_case("llama3_2_1b", "train_4k", mesh, device=dev)
    sharded, _ = make_model("llama3_2_1b", mesh, "train_4k", device=dev)
    p = shard_params(model.init(seed=3), sharded, mesh)
    opt = init_opt_state(p, zero_layout(
        p, tree_pspecs(sharded.param_specs(), mesh), mesh))
    assert [tuple(t.shape) for t in leaves((p, opt))] == \
        [tuple(t.shape) for t in leaves(case.args[:2])], "meta shapes"
    got = timed_run("zero_reduce_grads", case.fn, p, opt,
                    lambda b: train_loop.local_batch(
                        train_loop.batch_to_device(b, dev), mesh))
    del p, opt
    zero = summary(train_loop.TrainConfig(compress_pod_grads=False), got,
                   lambda: model.init(seed=3))
    del got
    gc.collect()
    torch.cuda.empty_cache()
    return dict(dp=dp, zero=zero, n_params=dp["n_params"])


def _dist_multi(rank, world, dev, mesh):
    """The checks that need two ranks or more, on the cards: the rings
    (bitwise against the same sums computed locally in the reference's
    order), ``matmul_ag_overlap``, the MoE's ``ep_a2a`` over ``data`` and
    ``tp_smap`` over a (1, world) mesh against ``tp_dense`` at capacity 8
    (nothing dropped), and from 4 ranks the int8 pod hop on a (2, world
    / 2, 1) mesh within amax / 127 of the full-precision one."""
    import torch.distributed as dist
    from repro_torch.distributed.collectives import (matmul_ag_overlap,
                                                     ring_all_gather,
                                                     ring_reduce_scatter)
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.models import moe
    from repro_torch.train.train_loop import dp_reduce_grads

    def per_rank(r, *shape):
        g = torch.Generator(device=dev).manual_seed(DIST_SEED + 100 + r)
        return torch.randn(shape, generator=g, device=dev)

    res = {}
    xs = [per_rank(r, 64, 256) for r in range(world)]
    res["all_gather"] = torch.equal(
        ring_all_gather(xs[rank], mesh, "data", axis=0), torch.cat(xs))
    n = 64 // world * world
    ys = [x[:n] for x in xs]
    # every rank's partial through the reference's hops and adds, locally
    # (for world > 2 the result is not a true reduce-scatter: a fault of
    # the reference kept for parity, ROADMAP Queue 3)
    chunk = n // world
    part = lambda y, j: y[(j % world) * chunk:(j % world + 1) * chunk]  # noqa: E731
    accs = [part(ys[r], r + 1) for r in range(world)]
    for step in range(1, world):
        accs = [accs[(r - 1) % world] + part(ys[r], r + 1 + step)
                for r in range(world)]
    res["reduce_scatter"] = torch.equal(
        ring_reduce_scatter(ys[rank], mesh, "data", axis=0), accs[rank])
    x3 = [per_rank(r, 2, 128, 256) for r in range(world)]
    w = per_rank(world, 256, 512)
    res["matmul_ag_err"] = max_err(matmul_ag_overlap(x3[rank], w, mesh, "data"),
                                   torch.cat(x3, dim=1) @ w)
    assert res["all_gather"] and res["reduce_scatter"], res
    assert res["matmul_ag_err"] <= 1e-3, res
    # the MoE strategies, f32 (d 256, f 512, 16 experts, top-2)
    E = 16
    params = {"router": per_rank(world + 1, 256, E) / 16,
              "w1": per_rank(world + 2, E, 256, 512) / 16,
              "w3": per_rank(world + 3, E, 256, 512) / 16,
              "w2": per_rank(world + 4, E, 512, 256) / 23}
    kw = dict(top_k=2, capacity_factor=8.0)
    # ep: each data rank routes its own rows
    x = 0.5 * per_rank(world + 5 + rank, 2, 64, 256)
    dense, aux_d = moe.moe_apply_tp_dense(params, x, **kw)
    ep, aux_e = moe.moe_apply_ep_a2a(params, x, mesh=mesh, **kw)
    # tp: the model ranks share their rows and split d_ff
    x = 0.5 * per_rank(world + 5, 2, 64, 256)
    dense_t, aux_dt = moe.moe_apply_tp_dense(params, x, **kw)
    tp_mesh = make_mesh((1, world), ("data", "model"), "cuda")
    tp, aux_t = moe.moe_apply_tp_smap(params, x, mesh=tp_mesh, **kw)
    res["ep_err"] = max_err(ep, dense)
    res["tp_err"] = max_err(tp, dense_t)
    res["aux_err"] = max(abs(float(aux_e - aux_d)),
                         abs(float(aux_t - aux_dt)))
    assert max(res["ep_err"], res["tp_err"], res["aux_err"]) <= 1e-4, res
    res.update(_dist_moe_grads(rank, world, dev, mesh, params, per_rank))
    res.update(_dist_tp_step(rank, world, dev))
    # the pod hop
    if world >= 4 and world % 2 == 0:
        pod = make_mesh((2, world // 2, 1), ("pod", "data", "model"), "cuda")
        grads = {"a": per_rank(rank, 1 << 20), "b": per_rank(rank, 4096, 64)}
        full = dp_reduce_grads(dict(grads), pod, False)
        comp = dp_reduce_grads(dict(grads), pod, True)
        ratio = 0.0
        for k in grads:
            amax = grads[k].abs().max().reshape(1)
            dist.all_reduce(amax, op=dist.ReduceOp.MAX)
            ratio = max(ratio, max_err(full[k], comp[k]) / float(amax))
        res["pod_ratio"] = ratio
        assert ratio <= 1 / 127, res
    return res


# The tensor-parallel check (world >= 2): one step of the tensor-parallel
# step against the mesh-less step from the same init, both bf16.  The
# sharded layers sum bf16 partial products over the model ranks where the
# mesh-less products accumulate in f32 and round once, so the two differ
# by bf16 rounding through the layers.  Held: the loss, and every
# gradient the step hands to AdamW (gathered), relative to the leaf's
# peak; a zero or wrong gradient is off by ~1 of its peak.  Each bound
# lies between the tensor-parallel step's reading and that of the bf16
# control, the same mesh-less step built in f32 from the same
# (bf16-valued) weights against the bf16 one (``_tp_control``, printed
# at every world).  On four H100s at these shapes: loss 4.0e-5 (control
# 5.5e-4), gradients 0.042 of the peak (control 0.105), both worst at the
# tied embedding's table, which sums bf16 products over every token.
DIST_TP_LAYERS = 2
DIST_TP_LOSS_TOL = 2 ** -12
DIST_TP_GRAD_REL = 2 ** -4


def _dist_moe_grads(rank, world, dev, mesh, params, per_rank):
    """``ep_a2a``'s input and weight gradients (each rank its experts'
    slices, ``sharded=True``) against ``tp_dense``'s on the full weights,
    summed over the ranks and cut to the same slices, f32."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import local_shard, \
        logical_to_pspec
    from repro_torch.models import moe

    kw = dict(top_k=2, capacity_factor=8.0)
    x = 0.5 * per_rank(world + 5 + rank, 2, 64, 256)
    ct = per_rank(world + 20 + rank, 2, 64, 256)
    spec = moe.spec_moe("ep_a2a")
    pspecs = {k: logical_to_pspec(spec[k], mesh) for k in params}
    full = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xf = x.clone().requires_grad_(True)
    y, _ = moe.moe_apply_tp_dense(full, xf, **kw)
    g_full = torch.autograd.grad((y * ct).sum(), [*full.values(), xf])
    loc = {k: local_shard(v, pspecs[k], mesh).requires_grad_(True)
           for k, v in params.items()}
    xl = x.clone().requires_grad_(True)
    y, _ = moe.moe_apply_ep_a2a(loc, xl, mesh=mesh, sharded=True, **kw)
    g_ep = torch.autograd.grad((y * ct).sum(), [*loc.values(), xl])
    err = max_err(g_ep[-1], g_full[-1])
    for k, ge, gf in zip(params, g_ep, g_full):
        dist.all_reduce(gf)                  # every rank's tokens
        if k == "router":
            dist.all_reduce(ge)              # replicated over data
        err = max(err, max_err(ge, local_shard(gf, pspecs[k], mesh)) /
                  max(float(gf.abs().max()), 1e-30))
    assert err <= 1e-4, err
    return {"ep_grad_err": err}


def _step_grads(step, params, opt, batch):
    """One ``step``: (loss, the gradients it hands to ``adamw_update``,
    cloned, as the rank holds them)."""
    from repro_torch.train import train_loop
    from repro_torch.tree import tree_map

    seen, orig = [], train_loop.adamw_update

    def spy(cfg, params, grads, *a, **kw):
        seen.append(tree_map(torch.clone, grads))
        return orig(cfg, params, grads, *a, **kw)

    train_loop.adamw_update = spy
    try:
        _, _, met = step(params, opt, batch)
    finally:
        train_loop.adamw_update = orig
    return float(met["loss"]), seen[0]


def _leaf_rel(got, want):
    """(the largest error over leaves, each relative to want's peak, the
    path of that leaf in ``want``)."""
    from repro_torch.tree import leaves, leaves_with_paths
    return max((max_err(a, b) / max(float(b.float().abs().max()), 1e-30), k)
               for a, (k, b) in zip(leaves(got), leaves_with_paths(want)))


def _tp_control(dev, world):
    """The tensor-parallel check's inputs and its bf16 control: full-width
    llama3.2-1b resolved at ``tp`` = ``world`` and cut to
    ``DIST_TP_LAYERS`` layers, batch ``TRAIN_BATCH`` x ``TRAIN_SEQ``; the
    mesh-less bf16 step's loss and gradients, and the same step built in
    f32 from the same weights.  Returns (rcfg, init, batch, (loss,
    grads) of bf16, control: {loss: |bf16 - f32|, grad_rel: the largest
    gradient error of a leaf over its f32 peak})."""
    import dataclasses

    from repro_torch.config import resolve
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMTask
    from repro_torch.models.model import LM
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    cfg = get_config("llama3_2_1b")
    cfg = dataclasses.replace(cfg, num_layers=DIST_TP_LAYERS)
    rcfg = resolve(cfg, tp=world)
    batch = SyntheticLMTask(cfg.vocab_size, TRAIN_SEQ).batch(
        0, 0, 0, TRAIN_BATCH)
    tc = TrainConfig(compress_pod_grads=False)
    plain = LM(rcfg, device=dev)
    init = lambda: plain.init(seed=9)                        # noqa: E731
    p = init()
    bf16 = _step_grads(make_train_step(plain, None, tc), p,
                       init_opt_state(p), batch)
    m32 = LM(resolve(dataclasses.replace(cfg, dtype="float32"), tp=world),
             device=dev)
    p = _map_tensors(init(), lambda t: t.float())
    f32 = _step_grads(make_train_step(m32, None, tc), p, init_opt_state(p),
                      batch)
    del p
    rel, worst = _leaf_rel(bf16[1], f32[1])
    control = {"loss": abs(bf16[0] - f32[0]), "grad_rel": rel,
               "grad_worst": worst}
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    return rcfg, init, batch, bf16, control


def _dist_tp_step(rank, world, dev):
    """One step of the tensor-parallel step ``build_case`` gives on a (1,
    world) mesh (``_tp_control``'s model and batch) against the mesh-less
    bf16 step from the same init: the loss within ``DIST_TP_LOSS_TOL``,
    every gradient handed to AdamW, gathered, within ``DIST_TP_GRAD_REL``
    of its peak; the bf16 control's readings beside them."""
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.sharding import gather_full, tree_pspecs
    from repro_torch.launch.specs import build_case, make_model
    from repro_torch.models.convert import shard_params
    from repro_torch.train.optimizer import init_opt_state, zero_layout
    from repro_torch.tree import leaves

    rcfg, init, batch, (loss0, grads0), control = _tp_control(dev, world)
    mesh = make_mesh((1, world), ("data", "model"), dev.type)
    case = build_case("llama3_2_1b", "train_4k", mesh, DIST_TP_LAYERS,
                      device=dev)
    model, rcfg_tp = make_model("llama3_2_1b", mesh, "train_4k",
                                DIST_TP_LAYERS, device=dev)
    assert rcfg_tp == rcfg, "the two sides resolve alike"
    p = shard_params(init(), model, mesh)
    layout = zero_layout(p, tree_pspecs(model.param_specs(), mesh), mesh)
    loss, grads = _step_grads(case.fn, p, init_opt_state(p, layout), batch)
    gathered = [gather_full(g, zl.zspec if zl.dim is not None else zl.spec,
                            mesh) for g, zl in zip(leaves(grads),
                                                   layout.leaves)]
    rel, worst = _leaf_rel(gathered, grads0)
    res = {"tp_loss": loss, "tp_loss_err": abs(loss - loss0),
           "tp_grad_rel": rel, "tp_grad_worst": worst,
           "tp_control_loss": control["loss"],
           "tp_control_grad_rel": control["grad_rel"],
           "tp_control_grad_worst": control["grad_worst"]}
    assert res["tp_loss_err"] <= DIST_TP_LOSS_TOL and \
        res["tp_grad_rel"] <= DIST_TP_GRAD_REL, res
    return res


def _dist_rank(rank, world, out_dir, merged_path):
    """One rank of ``distributed [world]`` on its card (NCCL)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.config import resolve
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     sp_decode_attention)
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh((world, 1), ("data", "model"), "cuda")
    res = {}
    # (1) sequence-parallel decode over (a)'s cache, a shard a rank
    merged = torch.load(merged_path)
    q, k, v = _dist_cache(dev)
    s = DIST_S // world
    kl_, vl_ = k[:, rank * s:(rank + 1) * s], v[:, rank * s:(rank + 1) * s]
    scale = DIST_HEADS[2] ** -0.5
    same_a, same_whole, err_a = True, True, 0.0
    for n in DIST_LENS:
        kl = torch.tensor([n], dtype=torch.int32, device=dev)
        out = sp_decode_attention(q, kl_, vl_, kl, mesh, scale)
        ref = merged[n].to(dev)
        torch.testing.assert_close(out.float(), ref.float(), **DECODE_TOL)
        same_a &= torch.equal(out, ref)
        err_a = max(err_a, max_err(out, ref))
        same_whole &= torch.equal(out, ops.decode_attention(q, k, v, kl,
                                                            sm_scale=scale))
    kl = torch.tensor([DIST_S], dtype=torch.int32, device=dev)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    sp_decode_attention(q, kl_, vl_, kl, mesh, scale)
    e0.record()
    for _ in range(20):
        sp_decode_attention(q, kl_, vl_, kl, mesh, scale)
    e1.record()
    torch.cuda.synchronize()
    res["sp"] = dict(bitwise_a=same_a, bitwise_whole=same_whole, err_a=err_a,
                     ms=e0.elapsed_time(e1) / 20)
    del q, k, v, kl_, vl_
    if world >= 2:
        res["multi"] = _dist_multi(rank, world, dev, mesh)
    else:
        res["tp_control"] = _tp_control(dev, 1)[-1]
        gc.collect()
        torch.cuda.empty_cache()
    # (2) data-parallel training of full-width llama3.2-1b
    model = LM(resolve(get_config("llama3_2_1b"), tp=1), device=dev)
    res["train"] = _dist_train(model, mesh, dev, world)
    gc.collect()
    torch.cuda.empty_cache()
    # (3) compressed_psum of a tensor of the model's parameter count
    n_el = res["train"]["n_params"]
    g = torch.Generator(device=dev).manual_seed(DIST_SEED)
    x = torch.randn((n_el,), generator=g, device=dev)
    compressed_psum(x[:1 << 20], mesh, "data")          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    red, err = compressed_psum(x, mesh, "data")
    torch.cuda.synchronize()
    cp_ms = (time.perf_counter() - t0) * 1e3
    amax = float(x.abs().max())
    q_err = float((red - x).abs().max())
    # the error feedback is this rank's residual x - dequantized(x): half
    # a quantization step amax / 127, plus the f32 rounding of x / scale
    # (up to 127 * 2^-24 of a step: 1e-4 relative keeps a margin)
    fb = float(err.abs().max())
    res["cpsum"] = dict(n=n_el, ms=cp_ms, amax=amax, q_err=q_err, feedback=fb)
    assert q_err <= amax / 127, (q_err, amax)
    assert fb <= amax / 254 * (1 + 1e-4), (fb, amax)
    del x, red, err
    gc.collect()
    torch.cuda.empty_cache()
    # (4) sequence-parallel LM decode against the mesh-less LM
    params = model.init(seed=5)
    sp_model = LM(model.rcfg, device=dev, mesh=mesh, sp_decode=True)
    r = np.random.default_rng(DIST_SEED)
    vocab = model.rcfg.base.vocab_size
    prompt = torch.from_numpy(r.integers(9, vocab, (1, DIST_PREFILL))
                              ).to(dev)
    toks = torch.from_numpy(r.integers(9, vocab, (DIST_DECODE, 1))).to(dev)
    s_alloc = DIST_PREFILL + 64

    def decode(m):
        logits, st = m.prefill(params, {"tokens": prompt}, s_alloc=s_alloc)
        seen = [logits]
        for i in range(DIST_DECODE):
            pos = torch.full((1,), DIST_PREFILL + i, dtype=torch.int32,
                             device=dev)
            logits, st = m.decode_step(params, toks[i], st, pos)
            seen.append(logits)
        return torch.stack(seen).float()

    want = decode(model)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = decode(sp_model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    err = max_err(got, want)
    assert torch.isfinite(got).all() and err <= FAMILY_LOGIT_TOL, err
    res["lm"] = dict(err=err, bitwise=bool(torch.equal(got, want)),
                     std=float(want.std()), wall_s=wall, counts=counts,
                     cache=int(sp_model.init_states(1, s_alloc)[0]["k"]
                               .shape[1]))
    if rank == 0:
        with open(Path(out_dir) / "rank0.json", "w") as f:
            json.dump(res, f)


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def distributed_phase(dev, timer):
    """``distributed``: (a) ``lse_shards_phase``; (b) one NCCL rank per
    visible card on a (world, 1) data x model mesh, each running
    ``_dist_rank``: sequence-parallel decode over (a)'s cache against
    (a)'s merged output, ``compressed_psum`` of a tensor of llama3.2-1b's
    parameter count, ``DIST_TRAIN_STEPS`` steps of full-width llama3.2-1b
    through each of the two data-parallel steps (``_dist_train``; batch 2
    x 2048 a rank; at world 1 bitwise equal to the mesh-less step), and
    a ``sp_decode=True`` LM (prefill 8192 tokens, 32 decode steps)
    against the mesh-less LM within ``FAMILY_LOGIT_TOL``.  Returns (the
    LSE row, [launch counts of the two data-parallel runs and of the
    sp-decode LM])."""
    import shutil
    import tempfile

    from repro_torch.distributed.compat import run_world

    row, merged = lse_shards_phase(dev, timer)
    world = torch.cuda.device_count()
    print(f"distributed: world {world} (one NCCL rank per visible card)")
    if world < 2:
        print("distributed: not run at this world (they need 2 ranks or "
              "more): ring_all_gather, ring_reduce_scatter, "
              "matmul_ag_overlap, MoE ep_a2a and tp_smap and ep_a2a's "
              "gradients, the tensor-parallel step (model > 1), the pod "
              "hop of compressed_psum; the CPU tests hold them on 8 gloo "
              "ranks")
    elif world < 4 or world % 2:
        print("distributed: not run at this world (it needs an even world "
              "of 4 ranks or more): the pod hop of compressed_psum")
    d = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        torch.save(merged, Path(d) / "merged.pt")
        gc.collect()
        torch.cuda.empty_cache()
        sys.stdout.flush()
        run_world(_dist_rank, world, d, str(Path(d) / "merged.pt"),
                  init_method=f"tcp://127.0.0.1:{_free_port()}",
                  device_type="cuda", timeout_s=DIST_TIMEOUT_S)
        with open(Path(d) / "rank0.json") as f:
            res = json.load(f)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if "multi" in res:
        mu = res["multi"]
        print(f"distributed [multi-rank, NCCL world {world}]: "
              f"ring_all_gather bitwise {mu['all_gather']}, "
              f"ring_reduce_scatter bitwise {mu['reduce_scatter']} (the "
              f"reference's hops and adds, simulated); matmul_ag_overlap "
              f"max_abs_err "
              f"{mu['matmul_ag_err']:.3g} (tol 1e-3); MoE ep_a2a / tp_smap "
              f"against tp_dense at capacity 8: {mu['ep_err']:.3g} / "
              f"{mu['tp_err']:.3g}, aux {mu['aux_err']:.3g} (tol 1e-4); "
              f"ep_a2a gradients against tp_dense's {mu['ep_grad_err']:.3g} "
              f"of their peaks (tol 1e-4); the tensor-parallel step "
              f"(model = {world}, llama3.2-1b cut to {DIST_TP_LAYERS} "
              f"layers, bf16) against the mesh-less step: loss "
              f"{mu['tp_loss']:.4f} within {mu['tp_loss_err']:.3g} (tol "
              f"{DIST_TP_LOSS_TOL:.3g}; the bf16 control "
              f"{mu['tp_control_loss']:.3g}), gradients within "
              f"{mu['tp_grad_rel']:.3g} of their peaks (at "
              f"{mu['tp_grad_worst']}; tol {DIST_TP_GRAD_REL:.3g}; the bf16 "
              f"control {mu['tp_control_grad_rel']:.3g}, at "
              f"{mu['tp_control_grad_worst']})"
              + (f"; int8 pod hop within {mu['pod_ratio']:.4g} x amax of "
                 f"full precision (bound 1/127)" if "pod_ratio" in mu
                 else ""))
    if "tp_control" in res:
        c = res["tp_control"]
        print(f"distributed [tp control, llama3.2-1b cut to "
              f"{DIST_TP_LAYERS} layers, batch {TRAIN_BATCH} x {TRAIN_SEQ}]: "
              f"the mesh-less bf16 step against the same step in f32: loss "
              f"{c['loss']:.3g} apart, gradients {c['grad_rel']:.3g} of their "
              f"peaks (at {c['grad_worst']}; the tensor-parallel check's "
              f"bounds, loss {DIST_TP_LOSS_TOL:.3g} and gradients "
              f"{DIST_TP_GRAD_REL:.3g}, lie below these; the check itself "
              f"needs 2 cards)")
    sp = res["sp"]
    print(f"distributed [sp decode, NCCL world {world}, {DIST_S} keys]: "
          f"against (a)'s merged output at kv_len {list(DIST_LENS)}: "
          + ("bitwise equal" if sp["bitwise_a"] else
             f"within tol (max_abs_err {sp['err_a']:.3g}; the world's "
             f"{DIST_S // world}-key shards merge chunks in another order "
             f"than (a)'s {DIST_SHARDS})")
          + "; bitwise equal to the decode kernel over the whole cache: "
          f"{sp['bitwise_whole']}; {sp['ms']:.4f} ms a call (the kernel "
          f"and two all-reduces)")
    tr = res["train"]
    for key, what, reduction in (
            ("dp", "replicated moments, make_train_step(model, mesh)",
             "dp_reduce_grads"),
            ("zero", "build_case's step, ZeRO-1 moments",
             "zero_reduce_grads")):
        t = tr[key]
        red = t["reduce_ms"]
        share = [100 * a / b for a, b in zip(red, t["wall_ms"])]
        print(f"distributed [train, llama3.2-1b, {DIST_TRAIN_STEPS} "
              f"data-parallel steps ({what}), batch {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} a rank]: losses "
              f"{[round(x, 4) for x in t['losses']]}"
              + (f", bitwise equal to the mesh-less step (losses and every "
                 f"updated param): {t['bitwise']}" if "bitwise" in t else "")
              + f"; step wall {[round(w, 1) for w in t['wall_ms']]} ms, "
              f"gradient reduction ({reduction}) "
              f"{[round(r, 2) for r in red]} ms device "
              f"({[round(x, 2) for x in share]}% of the step); launches "
              f"{ {k: v for k, v in t['counts'].items() if v} }")
        if "bitwise" in t:
            assert t["bitwise"], f"{key} step at world 1 != mesh-less"
        if "replicated" in t:
            print(f"distributed [train, {key}]: parameters after the steps "
                  f"bitwise equal on every rank: {t['replicated']}")
            assert t["replicated"], f"{key}: data-parallel ranks diverged"
        assert t["counts"]["flash_attention"] > 0, (key, t["counts"])
    cp = res["cpsum"]
    print(f"distributed [compressed_psum, {cp['n'] / 1e9:.3f} B f32 "
          f"elements]: {cp['ms']:.1f} ms; max |value - input| "
          f"{cp['q_err']:.4g} <= amax / 127 = {cp['amax'] / 127:.4g}; the "
          f"error feedback {cp['feedback']:.6g} (half a step: amax / 254 = "
          f"{cp['amax'] / 254:.6g})")
    lm = res["lm"]
    print(f"distributed [sp-decode LM, llama3.2-1b, prefill {DIST_PREFILL} + "
          f"{DIST_DECODE} decode steps, caches of {lm['cache']} positions a "
          f"rank]: max |logit - mesh-less LM| {lm['err']:.3g} (tol "
          f"{FAMILY_LOGIT_TOL}, logit std {lm['std']:.3g}, bitwise "
          f"{lm['bitwise']}), wall {lm['wall_s']:.2f} s, launches "
          f"{ {k: v for k, v in lm['counts'].items() if v} }")
    assert lm["counts"]["decode_attention_lse"] > 0
    return row, [tr["dp"]["counts"], tr["zero"]["counts"], lm["counts"]]


def f32_decode_kernel_phase(dev, timer):
    """``kernels [recurrentgemma f32]``: the decode kernel over an f32
    cache at recurrentgemma-2b's heads (10 query / 1 KV, head_dim 256: a
    key's row is 64 16-byte pieces, two a lane).  A 2048-slot ring at
    B = 8 held in an arena: the full ring and the chunk-edge ``kv_len``
    set, through the dense entry, slots and block tables (normal mode)
    and the dense log-sum-exp mode; each against its plain version within
    ``DECODE_TOL``, two calls bitwise, paged == dense bitwise and the LSE
    mode's ``acc / l`` bitwise the normal mode's output.  The full ring
    timed beside SDPA over the same masked f32 cache, the plain version
    and the bound (bytes over 3.35 TB/s; its f32 operations over 67
    TFLOP/s).  Returns the rows (dense and LSE over the full ring)."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops

    Hq, Hkv, Dh, S, B = 10, 1, 256, RECURRENTGEMMA_WINDOW, 8
    N, tb = B + 3, 256
    g = torch.Generator(device=dev).manual_seed(17)
    ka = torch.randn((N, S, Hkv, Dh), generator=g, device=dev)
    va = torch.randn((N, S, Hkv, Dh), generator=g, device=dev)
    q = torch.randn((B, Hq, Dh), generator=g, device=dev)
    slots = torch.tensor([3, 0, 7, 9, 1, 5, 8, 2], dtype=torch.int32,
                         device=dev)
    bt = slots[:, None].repeat(1, S // tb)
    bt[:5, 0] = N - 2                   # a shared leading block
    kg, vg = ka[slots.long()], va[slots.long()]
    kt, vt = (ops._gather_block_rows(a, bt, tb) for a in (ka, va))
    C = dec.KV_CHUNK
    rows, label = [], "recurrentgemma-2b shapes, f32 cache, head_dim 256"
    for case, kl in ((f"full ring, kv_valid {S}", [S] * B),
                     ("chunk-edge kv_len", [0, 1, C - 1, C, C + 1, 2 * C, S,
                                            S + 5])):
        kv_len = torch.tensor(kl, dtype=torch.int32, device=dev)
        dense = ops.decode_attention(q, kg, vg, kv_len)
        plain = dec.decode_attention_plain(q, kg, vg, kv_len)
        torch.testing.assert_close(dense, plain, **DECODE_TOL)
        paged = ops.arena_decode_attention(q, ka, va, slots, kv_len)
        p_plain = dec.paged_decode_attention_plain(q, ka, va, slots, kv_len)
        torch.testing.assert_close(paged, p_plain, **DECODE_TOL)
        tabled = ops.arena_decode_attention(q, ka, va, slots, kv_len,
                                            block_tables=bt)
        t_plain = dec.paged_decode_attention_plain(
            q, ka, va, slots, kv_len, block_tables=bt, table_block=tb)
        torch.testing.assert_close(tabled, t_plain, **DECODE_TOL)
        lse = ops.decode_attention_lse(q, kg, vg, kv_len)
        l_plain = dec.decode_attention_lse_plain(q, kg, vg, kv_len)
        live = ~torch.isneginf(l_plain[..., -1])
        assert torch.equal(torch.isneginf(lse[..., -1]), ~live), case
        l_ref = l_plain[..., -2].clamp_min(1e-30)
        torch.testing.assert_close(lse[..., :Dh] / l_ref[..., None],
                                   l_plain[..., :Dh] / l_ref[..., None],
                                   **DECODE_TOL)
        lse_err = max(float((lse[..., -1] - l_plain[..., -1])[live].abs()
                            .max()) if live.any() else 0.0,
                      float(((lse[..., -2] - l_plain[..., -2]).abs()
                             / l_ref).max()))
        assert lse_err <= 1e-5, (case, lse_err)
        assert torch.equal(paged, dense) and torch.equal(
            tabled, ops.decode_attention(q, kt, vt, kv_len)), \
            f"{case}: paged != dense"
        assert torch.equal(ops.decode_attention(q, kg, vg, kv_len), dense) \
            and torch.equal(ops.arena_decode_attention(
                q, ka, va, slots, kv_len, block_tables=bt), tabled) \
            and torch.equal(ops.decode_attention_lse(q, kg, vg, kv_len),
                            lse), f"{case}: two calls differ"
        norm = lse[..., :Dh] / lse[..., Dh:Dh + 1].clamp_min(1e-30)
        assert torch.equal(norm, dense), f"{case}: LSE acc / l != normal"
        err = max(max_err(dense, plain), max_err(paged, p_plain),
                  max_err(tabled, t_plain))
        print(f"kernels [{label}, {case}]: dense, slots and block tables "
              f"within DECODE_TOL of the plain versions (max_abs_err "
              f"{err:.3g}); LSE m and l within {lse_err:.3g}; two calls, "
              f"paged == dense and the LSE mode's acc / l == normal "
              f"bitwise")
        if case.startswith("full"):
            b_ms, b_by = bound(dec.work(B, Hq, Hkv, Dh, S, kv_len=kl,
                                        q_itemsize=4, kv_itemsize=4),
                               f32=True)
            mask = sdpa_mask(kv_len, 1, S, 0, False, dev)
            qs, ks, vs = q[:, :, None], kg.transpose(1, 2), vg.transpose(1, 2)
            sdpa_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True))
            for name, fn, pfn, e in (
                    ("decode_attention",
                     lambda: ops.decode_attention(q, kg, vg, kv_len),
                     lambda: dec.decode_attention_plain(q, kg, vg, kv_len),
                     max_err(dense, plain)),
                    ("decode_attention_lse",
                     lambda: ops.decode_attention_lse(q, kg, vg, kv_len),
                     lambda: dec.decode_attention_lse_plain(q, kg, vg,
                                                            kv_len),
                     lse_err)):
                r = dict(name=name, case=case, max_abs_err=e,
                         ms=timer.ms(fn), plain_ms=timer.ms(pfn),
                         library_ms=sdpa_ms, bound_ms=b_ms, bound_by=b_by)
                rows.append(r)
                print(f"kernel {name} [{label}, {case}]: kernel "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
                      f"(mask) {sdpa_ms:.4f} ms, bound {b_ms:.4f} ms "
                      f"({b_by})")
    return rows


def recurrentgemma_f32_phase():
    """``models [recurrentgemma-2b f32]``: full width and depth built at
    ``dtype="float32"`` (random weights, seed 2), so every attention cache
    is f32: a prefill of ``RG_F32_PREFILL`` tokens into rings of 2048
    slots, then ``DBRX_DECODE`` decode steps through the f32 head_dim-256
    decode kernel; the prefill's last logits, the first and the last
    step's held against the cacheless forward within ``RG_F32_TOL``.
    Returns the kernel launches."""
    import dataclasses

    from repro_torch.config import resolve
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    cfg = dataclasses.replace(get_config("recurrentgemma_2b"),
                              dtype="float32")
    model = LM(resolve(cfg, tp=1), device="cuda")
    params = model.init(seed=2)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"models [recurrentgemma-2b f32]: full width ({cfg.num_layers} "
          f"layers), f32, {n_bytes / 1e9:.2f} GB of random weights (seed 2)")
    g = torch.Generator(device="cuda").manual_seed(8)
    n0, steps = RG_F32_PREFILL, DBRX_DECODE
    toks = torch.randint(16, cfg.vocab_size, (2, n0 + steps), generator=g,
                         device="cuda")
    errs = []
    _zero_counts()
    with torch.no_grad():
        last, st = model.prefill(params, {"tokens": toks[:, :n0]},
                                 s_alloc=2 * RECURRENTGEMMA_WINDOW)
        assert st[2]["k"].dtype == torch.float32, "the ring is not f32"
        checks = [(n0, last)]
        for i in range(steps):
            pos = torch.full((2,), n0 + i, dtype=torch.int32, device="cuda")
            lg, st = model.decode_step(params, toks[:, n0 + i], st, pos)
            if i in (0, steps - 1):
                checks.append((n0 + i + 1, lg))
        counts = _counts()
        for n, lg in checks:
            ref = model.prefill(params, {"tokens": toks[:, :n]})[0]
            err = max_err(lg, ref)
            errs.append(err)
            print(f"models [recurrentgemma-2b f32, logits at position "
                  f"{n - 1}]: max |logit - full forward| {err:.4g} (logit "
                  f"std {float(ref.std()):.4g}; tol {RG_F32_TOL:g})")
            assert torch.isfinite(lg).all() and err <= RG_F32_TOL, (n, err)
    assert counts["decode_attention"] > 0, counts
    print(f"models [recurrentgemma-2b f32]: prefill {n0} + {steps} decode "
          f"steps within {max(errs):.4g} of the cacheless forward; kernel "
          f"launches {json.dumps(counts)}")
    return counts


def dbrx_phase(models, params, docs):
    """``models [dbrx-132b]`` and ``serve [dbrx oracle]``: full width
    (d_model 6144, 48 / 8 heads, head_dim 128, 16 experts top-4 at d_ff
    10752, vocab 100352) cut to ``DBRX_LAYERS`` layers (random bf16
    weights, seed 3): ``family_model_phase`` with ``DBRX_DECODE`` decode
    steps after each prefill, at the published capacity factor (held
    where the drop decisions agree) and at ``DBRX_CHECK_CF`` (every
    position held); then a two-stage cascade (the two tenant
    queries) over the serving corpus with the full-width llama3.2-1b
    proxy and the cut dbrx as the oracle, paged plane, a warm-up and a
    drain at inflight 1.  Returns the launches of both."""
    import dataclasses

    from repro_torch.models.model import LM

    ms = family_models((("dbrx_132b", 3, DBRX_LAYERS),))
    model, p = ms["dbrx_132b"]
    b = model.rcfg.base
    decode_at = (1536, 1536 + DBRX_DECODE - 1)
    print(f"models [families, dbrx-132b]: the model check at the published "
          f"capacity factor {b.moe.capacity_factor}: held where both sides "
          f"made the same drop decisions")
    published = family_model_phase("dbrx_132b", model, p, decode_at)
    check = LM(dataclasses.replace(model.rcfg, base=dataclasses.replace(
        b, moe=dataclasses.replace(b.moe, capacity_factor=DBRX_CHECK_CF))),
               device="cuda")
    print(f"models [families, dbrx-132b]: the model check at capacity "
          f"factor {DBRX_CHECK_CF} (published {b.moe.capacity_factor}): "
          f"every row's expert buffer holds every token, nothing drops")
    counts = family_model_phase("dbrx_132b", check, p, decode_at)
    counts = {k: v + published[k] for k, v in counts.items()}
    assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0
    pair = {"proxy": models["proxy"], "oracle": model}
    weights = {"proxy": params["proxy"], "oracle": p}
    vocab = min(m.rcfg.base.vocab_size for m in pair.values())
    for run in ("warm-up", "inflight=1"):
        srv = make_server(pair, weights, inflight=1, vocab=vocab)
        assert all(be.uses_paged_kv() for be in srv.backends.values())
        results, serve_counts, wall = drive(srv, tenant_cascades(), docs)
        assert_resolved(results, docs)
        check_launches(srv, serve_counts)
        n = sum(len(r.status) for r in results.values())
        p50, p99 = latency_ms(results)
        exits = [list(r.exit_stage.values()) for r in results.values()]
        print(f"serve [dbrx oracle, {run}]: llama3.2-1b proxy, dbrx-132b "
              f"({DBRX_LAYERS} layers) oracle: {n} docs terminal and "
              f"RESOLVED (every document resolved: True) in {wall:.3f} s "
              f"({n / wall:.2f} docs/s), {srv.stats().batches} launches, "
              f"latency p50 {p50:.1f} ms p99 {p99:.1f} ms, exit stages "
              f"{[[e.count(s) for s in range(3)] for e in exits]}, kernel "
              f"launches {json.dumps(serve_counts)}")
    return counts, serve_counts


def train_dbrx_phase():
    """``train [dbrx-132b]``: two steps of the sharded train step that
    ``launch/specs.build_case("dbrx_132b", "train_4k", mesh,
    n_rep_override=1)`` builds, on a world-1 NCCL mesh (data 1, model 1),
    at full width cut to ``DBRX_TRAIN_LAYERS`` layer, batch 1 x
    ``DBRX_TRAIN_SEQ`` of ``SyntheticLMTask`` (the MoE runs ``tp_dense``,
    the reference's dispatch at data 1), ZeRO-1 moments; then the same
    steps with the mesh-less optimizer from the same init: the losses and
    every updated parameter bitwise equal (ZeRO-1 over one rank is the
    identity).  Prints the losses, the second step's wall and the peak
    memory.
    Returns the launches of the sharded step."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import SyntheticLMTask
    from repro_torch.distributed.compat import init_world, make_mesh
    from repro_torch.distributed.sharding import tree_pspecs
    from repro_torch.launch.specs import build_case, make_model
    from repro_torch.models.convert import shard_params
    from repro_torch.models.model import LM
    from repro_torch.train.optimizer import init_opt_state, zero_layout
    from repro_torch.train.train_loop import TrainConfig, make_train_step
    from repro_torch.tree import leaves

    init_world("cuda", init_method=f"tcp://127.0.0.1:{_free_port()}",
               rank=0, world_size=1, timeout_s=DIST_TIMEOUT_S)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        case = build_case("dbrx_132b", "train_4k", mesh,
                          n_rep_override=DBRX_TRAIN_LAYERS)
        model, rcfg = make_model("dbrx_132b", mesh, "train_4k",
                                 DBRX_TRAIN_LAYERS)
        b = rcfg.base
        batch = SyntheticLMTask(b.vocab_size, DBRX_TRAIN_SEQ).batch(0, 0, 0,
                                                                    1)

        def two_steps(step, params, opt):
            """Two steps on the batch; the second's wall and the peak."""
            params, opt, met = step(params, opt, batch)
            loss0 = float(met["loss"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            torch.cuda.synchronize()
            return params, (loss0, float(met["loss"])), \
                time.perf_counter() - t0, torch.cuda.max_memory_allocated()

        params = shard_params(model.init(seed=4), model, mesh)
        n = sum(t.numel() for t in leaves(params))
        layout = zero_layout(params, tree_pspecs(model.param_specs(), mesh),
                             mesh)
        opt = init_opt_state(params, layout)
        assert [tuple(t.shape) for t in leaves((params, opt))] == \
            [tuple(t.shape) for t in leaves(case.args[:2])]
        print(f"train [dbrx-132b]: build_case(dbrx_132b, train_4k, NCCL mesh "
              f"(data 1, model 1), n_rep_override {DBRX_TRAIN_LAYERS}): "
              f"reduced: num_layers {DBRX_TRAIN_LAYERS} of {40}, full width "
              f"({n / 1e9:.3f} B parameters, bf16; f32 ZeRO-1 moments), "
              f"batch 1 x {DBRX_TRAIN_SEQ}, MoE {b.moe.strategy} at data 1 "
              f"runs tp_dense")
        _zero_counts()
        params, losses, wall, peak = two_steps(case.fn, params, opt)
        counts = _counts()
        assert all(math.isfinite(x) for x in losses), losses
        want = [t.cpu() for t in leaves(params)]
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        plain = LM(rcfg, device="cuda")
        p2 = plain.init(seed=4)
        p2, losses2, wall2, peak2 = two_steps(
            make_train_step(plain, None, TrainConfig(
                compress_pod_grads=False)), p2, init_opt_state(p2))
        same = losses2 == losses and all(
            torch.equal(a.to(t.device), t) for a, t in zip(want, leaves(p2)))
        print(f"train [dbrx-132b]: losses {losses[0]:.6f}, {losses[1]:.6f} "
              f"(finite), second step wall {wall * 1e3:.1f} ms, peak memory "
              f"{peak / 1e9:.2f} GB; the mesh-less optimizer's steps: losses "
              f"{losses2[0]:.6f}, {losses2[1]:.6f}, wall {wall2 * 1e3:.1f} "
              f"ms, peak {peak2 / 1e9:.2f} GB; losses and every updated "
              f"parameter bitwise equal: {same}; kernel launches "
              f"{json.dumps(counts)}")
        assert same, "ZeRO-1 step over one rank != the mesh-less step"
        del p2, want
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _world1_args(model, case, shape: str, batch):
    """Real arguments on the card of the shapes of ``case.args`` (its
    meta stand-ins): the model's parameters from a seed, random KV caches
    (decode, every row's tokens at the last cache position) or random
    tokens (prefill; for qwen2-vl, patch embeddings and their M-RoPE
    positions before them); ``batch`` is the cell's cut of the global
    batch."""
    from repro_torch.config import shape_config
    from repro_torch.tree import leaves as tree_leaves

    sh = shape_config(shape, batch)
    B, S = sh.global_batch, sh.seq_len
    g = torch.Generator(device="cuda").manual_seed(0)
    vocab = model.rcfg.base.vocab_size
    params = model.init(seed=0)
    if sh.kind == "decode":
        states = model.init_states(B, S)
        for t in tree_leaves(states):
            t.normal_(generator=g)
        tok = torch.randint(vocab, (B,), generator=g, device="cuda",
                            dtype=torch.int32)
        args = (params, tok, states,
                torch.full((B,), S - 1, dtype=torch.int32, device="cuda"))
    else:
        n_img = model.rcfg.base.frontend_len
        tok = torch.randint(vocab, (B, S - n_img), generator=g,
                            device="cuda", dtype=torch.int32)
        batch = {"tokens": tok}
        if n_img:          # qwen2-vl: patches on a square grid, then text
            batch = _patch_inputs(model, n_img, math.isqrt(n_img), tok, g)
            batch["positions3"] = batch["positions3"].to(torch.int32)
        args = (params, batch)
    got = [(tuple(t.shape), t.dtype) for t in tree_leaves(args)]
    want = [(tuple(t.shape), t.dtype) for t in tree_leaves(case.args)]
    assert got == want, "world-1 arguments differ from the case's"
    return args


@contextlib.contextmanager
def _first_launches(module, name: str):
    """While the block runs, record ``(args, kwargs, result)`` of the
    first call of ``module.name`` at each distinct set of argument shapes
    (the caller reaches it through the module, so the wrapper sees every
    launch)."""
    real = getattr(module, name)
    calls = {}

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.setdefault(tuple(tuple(t.shape) for t in a), (a, kw, out))
        return out
    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _world1_decode_check(calls) -> float:
    """Each recorded ``decode_attention`` launch (q, k, v, kv_len) of a
    world-1 step: a second call gives the same bits; the result, and one
    at a ragged ``kv_len`` (0, 1, the split-KV chunk edges, the cache's
    end, the rest random), within ``DECODE_TOL`` of the plain version on
    the same tensors, ``WORLD1_PLAIN_SEQS`` sequences at a time.  Returns
    the largest error."""
    from repro_torch.kernels import decode_attention as dec

    err = 0.0
    g = torch.Generator(device="cuda").manual_seed(5)
    for (q, k, v, kv_len), kw, out in calls.values():
        assert torch.equal(dec.decode_attention(q, k, v, kv_len, **kw),
                           out), "decode: two calls differ"
        B, S, C = q.shape[0], k.shape[1], dec.KV_CHUNK
        ragged = torch.randint(0, S + 1, (B,), generator=g, device="cuda",
                               dtype=torch.int32)
        edges = [0, 1, C - 1, C, C + 1, S - 1, S]
        ragged[:len(edges)] = torch.tensor(edges, dtype=torch.int32)
        r_out = dec.decode_attention(q, k, v, ragged, **kw)
        for kl, o in ((kv_len, out), (ragged, r_out)):
            for b0 in range(0, B, WORLD1_PLAIN_SEQS):
                sl = slice(b0, b0 + WORLD1_PLAIN_SEQS)
                plain = dec.decode_attention_plain(q[sl], k[sl], v[sl],
                                                   kl[sl], **kw)
                torch.testing.assert_close(o[sl].float(), plain.float(),
                                           **DECODE_TOL)
                err = max(err, max_err(o[sl], plain))
                del plain
    return err


def _world1_flash_check(calls) -> float:
    """Each recorded ``flash_attention`` launch (q, k, v and its keyword
    arguments) of a world-1 step: a second call gives the same bits; the
    result's ``WORLD1_PLAIN_QROWS`` query rows at the start, middle and
    end of the first and last sequence within ``EXTEND_TOL`` of the plain
    version on the same tensors (those rows at their ``q_offset``).
    Returns the largest error."""
    from repro_torch.kernels import flash_attention as fla

    err = 0.0
    for (q, k, v), kw, out in calls.values():
        assert torch.equal(fla.flash_attention(q, k, v, **kw), out), \
            "flash: two calls differ"
        B, Sq, n = q.shape[0], q.shape[1], WORLD1_PLAIN_QROWS
        kv_len = kw.get("kv_len")
        for b in sorted({0, B - 1}):
            for r0 in sorted({0, max(Sq // 2 - n // 2, 0), max(Sq - n, 0)}):
                bs, rs = slice(b, b + 1), slice(r0, r0 + n)
                plain = fla.flash_attention_plain(
                    q[bs, rs], k[bs], v[bs], causal=kw["causal"],
                    window=kw["window"], q_offset=kw["q_offset"] + r0,
                    kv_len=None if kv_len is None else kv_len[bs],
                    sm_scale=kw["sm_scale"])
                torch.testing.assert_close(out[bs, rs].float(),
                                           plain.float(), **EXTEND_TOL)
                err = max(err, max_err(out[bs, rs], plain))
                del plain
    return err


def world1_cell(r, mesh, peaks):
    """One dry-run cell at world 1, cut to one repetition of its block
    pattern (and, where the dry-run says so, to a smaller batch), run on
    the card: a first step whose kernel launches are held against the
    plain version, then ``WORLD1_REPS`` steps, the launches of its kernel
    counted; the median step wall against the roofline bound, the
    measured peak against the dry-run's estimate.  Returns the launch
    counts."""
    from repro_torch.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.launch.roofline import analyze
    from repro_torch.launch.specs import build_case

    arch, shape, batch = r["arch"], r["shape"], r.get("batch")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    case = build_case(arch, shape, mesh, n_rep_override=1, device="cuda",
                      batch_override=batch)
    model = case.model
    args = _world1_args(model, case, shape, batch)
    decode = shape.startswith("decode")
    kernel = "decode_attention" if decode else "flash_attention"
    with _first_launches(dec if decode else fla, kernel) as calls:
        out = case.fn(*args)                              # first step
    torch.cuda.synchronize()
    del out
    shapes = [tuple(tuple(t.shape) for t in a[:3]) for a, _, _ in
              calls.values()]
    err = (_world1_decode_check if decode else _world1_flash_check)(calls)
    tol = DECODE_TOL if decode else EXTEND_TOL
    print(f"dryrun [world 1, {arch} {shape}]: {kernel} at the step's "
          f"{len(shapes)} launch shape(s) (q, k, v) {shapes}: two calls "
          f"bitwise equal; against the plain version on the same tensors"
          + (" (and at a ragged kv_len)" if decode else
             f" ({WORLD1_PLAIN_QROWS} query rows at the start, middle and "
             "end of the first and last sequence)")
          + f": max_abs_err {err:.3g} (tol atol={tol['atol']:g} "
          f"rtol={tol['rtol']:g})")
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    walls = []
    for _ in range(WORLD1_REPS[shape]):
        t0 = time.perf_counter()
        out = case.fn(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        logits = out[0]
        assert torch.isfinite(logits).all(), f"{arch} {shape}: not finite"
        del out
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() - base
    calls = r["kernels"][kernel]["calls"]
    assert counts[kernel] == calls * len(walls) and sum(
        counts.values()) == counts[kernel], (counts, calls)
    mem = r["memory"]
    est = mem["argument_bytes"] + mem["temp_bytes"]
    ratio = peak / est
    row = analyze(r, peaks)
    med = float(np.median(walls))
    cut_b = "" if batch is None else \
        f", batch cut to {batch} of {SHAPES[shape].global_batch}"
    print(f"dryrun [world 1, {arch} {shape}, cut to {len(model.kinds)} of "
          f"{get_config(arch).num_layers} layers{cut_b}]: dry-run FLOPs "
          f"{r['flops']:.4g}, "
          f"bytes {r['bytes_accessed']:.4g}, memory arguments "
          f"{mem['argument_bytes'] / 1e9:.3f} GB + temporaries "
          f"{mem['temp_bytes'] / 1e9:.3f} GB = {est / 1e9:.3f} GB; roofline "
          f"bound {row.bound_step_s * 1e3:.4f} ms ({row.dominant}); measured "
          f"median {med * 1e3:.4f} ms over {len(walls)} steps "
          f"(min {min(walls) * 1e3:.4f}), share of roofline "
          f"{row.bound_step_s / med:.4f}; peak {peak / 1e9:.3f} GB, "
          f"{ratio:.4f} of the estimate (band {WORLD1_MEM_BAND}); "
          f"{counts[kernel]} {kernel} launches; logits finite")
    assert WORLD1_MEM_BAND[0] <= ratio <= WORLD1_MEM_BAND[1], ratio
    del args, case, model, logits
    return counts


def _world1_batch_cuts(est, fit: float):
    """{(shape, batch): [arch, ...]} for the ``prefill_32k`` cells of
    ``est`` whose estimate exceeds ``fit`` bytes: the batch halved from
    the shape's until the arguments plus the temporaries scaled by the
    batch fit."""
    from repro_torch.config import SHAPES

    cuts = {}
    for r in est:
        mem = r["memory"]
        B = SHAPES[r["shape"]].global_batch
        if r["shape"] != "prefill_32k" or \
                mem["argument_bytes"] + mem["temp_bytes"] <= fit:
            continue
        b = B
        while b > 1 and mem["argument_bytes"] + mem["temp_bytes"] * b / B \
                > fit:
            b //= 2
        cuts.setdefault((r["shape"], b), []).append(r["arch"])
    return cuts


def dryrun_cli(*args: str):
    """``python -m repro_torch.launch.dryrun --all <args>`` as a
    subprocess: (its results, its wall s, its exit code)."""
    import tempfile

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "cells.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             *args, "--jobs", str(DRYRUN_JOBS), "--timeout",
             str(DRYRUN_CELL_TIMEOUT_S), "--out", str(out)],
            env=env, capture_output=True, text=True,
            timeout=DRYRUN_ALL_TIMEOUT_S)
        wall = time.perf_counter() - t0
        assert out.exists(), proc.stderr[-2000:]
        return json.loads(out.read_text()), wall, proc.returncode


def dryrun_phase():
    """``dryrun [cells]``: ``python -m repro_torch.launch.dryrun --all
    --mesh single`` as a subprocess (each cell a process of its own on a
    fake world of 256), its roofline table at this card's peaks with
    the FAILED rows; then the world-1 cells: every attention decoder's
    ``decode_32k`` and ``prefill_32k`` counted by the dry-run on a 1 x 1
    mesh cut to one repetition of its block pattern, a ``prefill_32k``
    over ``WORLD1_FIT`` of the card counted again at a cut batch
    (``_world1_batch_cuts``), and those whose estimate fits run on it
    over an NCCL world of one in this process (``world1_cell``).
    Returns the world-1 cells' launch counts."""
    from concurrent.futures import ThreadPoolExecutor

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.compat import init_world, make_mesh
    from repro_torch.launch import dryrun, roofline

    peaks = roofline.card_peaks()
    print(f"dryrun: peaks of {torch.cuda.get_device_name(0)}: HBM "
          f"{peaks.hbm_bytes_per_s:.6g} B/s (read from the card), bf16 "
          f"{peaks.bf16_flops:.4g} and f32 {peaks.f32_flops:.4g} FLOP/s, "
          f"NVLink {peaks.nvlink_bytes_per_s:.4g} and inter-node "
          f"{peaks.inter_node_bytes_per_s:.4g} B/s a direction")
    results, wall, rc = dryrun_cli("--mesh", "single")
    cells = dryrun.supported_cells()
    assert [(r["arch"], r["shape"]) for r in results] == cells
    ok = [r for r in results if r["ok"]]
    for r in results:
        fam = get_config(r["arch"]).family
        if not r["ok"]:
            assert re.match(r"\w+(Error|Exception|Expired): ", r["error"]), r
        elif fam in ("ssm", "hybrid", "audio"):
            print(f"dryrun: {r['arch']} {r['shape']} ran (it raised "
                  "before)")
    attention = [r for r in results
                 if get_config(r["arch"]).family not in ("ssm", "hybrid",
                                                         "audio")
                 and (r["arch"], r["shape"]) != ("gemma3_27b", "long_500k")]
    assert all(r["ok"] for r in attention), [
        (r["arch"], r["shape"], r.get("error")) for r in attention
        if not r["ok"]]
    print(f"dryrun [cells]: {len(ok)} of {len(results)} cells ran on the "
          f"16 x 16 mesh (fake world of 256, one process a cell, "
          f"{DRYRUN_JOBS} at once) in {wall:.1f} s; exit code {rc}; the "
          f"table at this card's peaks:")
    print(roofline.report(results, peaks))

    est, wall, _ = dryrun_cli("--mesh", "one", "--n-rep", "1", "--arch",
                              ",".join(WORLD1_ARCHS), "--shape",
                              "decode_32k,prefill_32k")
    print(f"dryrun [world 1]: {len(est)} cells counted on a 1 x 1 mesh, "
          f"cut to one repetition of the block pattern, in {wall:.1f} s")
    cap = torch.cuda.get_device_properties(0).total_memory
    cuts = _world1_batch_cuts(est, WORLD1_FIT * cap)
    # one dry-run call a batch, all at once
    with ThreadPoolExecutor(max_workers=max(len(cuts), 1)) as ex:
        runs = list(ex.map(lambda c: dryrun_cli(
            "--mesh", "one", "--n-rep", "1", "--arch", ",".join(c[1]),
            "--shape", c[0][0], "--batch", str(c[0][1])), cuts.items()))
    for ((shape, b), archs), (cut, wall, _) in zip(cuts.items(), runs):
        print(f"dryrun [world 1]: {shape} of {', '.join(archs)} counted "
              f"again with the batch cut to {b}, in {wall:.1f} s")
        by_cell = {(c["arch"], c["shape"]): c for c in cut}
        est = [by_cell.get((e["arch"], e["shape"]), e) for e in est]
    init_world("cuda", init_method=f"tcp://127.0.0.1:{_free_port()}",
               rank=0, world_size=1, timeout_s=DIST_TIMEOUT_S)
    counts = []
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        for r in est:
            assert r["ok"], r
            mem = r["memory"]
            need = mem["argument_bytes"] + mem["temp_bytes"]
            if need > WORLD1_FIT * cap:
                cut_b = "" if r.get("batch") is None else \
                    f" at batch {r['batch']}"
                print(f"dryrun [world 1, {r['arch']} {r['shape']}]: "
                      f"dry-run only: its estimate{cut_b} "
                      f"{need / 1e9:.1f} GB exceeds {WORLD1_FIT} of the "
                      f"card's {cap / 1e9:.1f} GB")
                continue
            counts.append(world1_cell(r, mesh, peaks))
    finally:
        dist.destroy_process_group()
    ran = {k for c in counts for k, v in c.items() if v}
    assert {"decode_attention", "flash_attention"} <= ran, \
        f"world-1 cells ran only {sorted(ran)} on the card"
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    print(device_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {len(_build.SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        res = _build.resources(_build.log_path(name))
        print(f"build: {name}: {len(res)} kernels, registers "
              f"{sorted({r['registers'] for r in res})}, spill bytes (stores "
              f"+ loads) {sorted({r['spill_stores'] + r['spill_loads'] for r in res})}")
    head_dim_resources(
        "decode_attention",
        _build.resources(_build.log_path("decode_attention")),
        {"decode_partial_kernel": "partial",
         "decode_combine_kernel": "combine"}, ("partial", "combine"),
        dims=(64, 128, 256))
    head_dim_resources(
        "flash_attention",
        _build.resources(_build.log_path("flash_attention")),
        {"flash_attention_tc_kernel": "tensor-core",
         "flash_attention_kernel": "fma"}, ("tensor-core",),
        dims=(64, 128, 256))
    for r in _build.resources(_build.log_path("relevance_score")):
        vpl = int(re.search(r"Li(\d+)E", r["kernel"]).group(1))
        spill = r["spill_stores"] + r["spill_loads"]
        print(f"build: relevance_score D <= {128 * vpl}: registers "
              f"{r['registers']}, spill bytes {spill}")
        assert spill == 0, r
    timer = Timer(dev)
    empty = lambda: torch.cuda._sleep(0)                    # noqa: E731
    print(f"timer floor: an empty launch (torch.cuda._sleep(0)) times "
          f"{timer.ms(empty):.4f} ms per call, {timer.stream_ms([empty]):.4f} "
          f"ms back to back")
    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        print(f"phase {name}: wall {time.perf_counter() - t:.1f} s")
        return out

    if "--distributed-only" in sys.argv[1:]:
        # the distributed phase alone, for a machine of several cards: no
        # kernels line and no result line
        phase("distributed", distributed_phase, dev, timer)
        print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s")
        return 0
    rows = phase("kernels [llama3.2-1b]", kernel_phase, dev, timer, 32, 8, 64,
                 "llama3.2-1b shapes")
    phase("kernels [qwen3-1.7b]", kernel_phase, dev, timer, 16, 8, 128,
          "qwen3-1.7b shapes")
    phase("kernels [prefix tables]", lambda: (
        prefix_kernel_phase(dev, 32, 8, 64, "llama3.2-1b shapes"),
        prefix_kernel_phase(dev, 16, 8, 128, "qwen3-1.7b shapes")))
    phase("kernels [gemma3-27b]", windowed_kernel_phase,
          dev, timer, 32, 16, 128, GEMMA3_WINDOW,
          "gemma3-27b shapes, window 1024",
          (("prefill Sq=Skv=2048", 2048, 0, [2048, 1900, 1500, 1100]),
           ("extend Sq=512 at q_offset 1536", 512, 1536,
            [2048, 2000, 1800, 1537])), 4, 4)
    W = RECURRENTGEMMA_WINDOW
    phase("kernels [recurrentgemma-2b]", windowed_kernel_phase,
          dev, timer, 10, 1, 256, W,
          f"recurrentgemma-2b shapes, head_dim 256, window {W}",
          (("prefill Sq=Skv=4096", 2 * W, 0, [2 * W, 3000]),
           ("extend Sq=512 at q_offset 3584", 512, 2 * W - 512,
            [2 * W, 3700])), 2, 5)
    phase("kernels [recurrentgemma f32]", f32_decode_kernel_phase, dev,
          timer)
    phase("kernels [qwen2-vl-2b]", kernel_phase, dev, timer, 12, 2, 128,
          "qwen2-vl-2b shapes")
    phase("kernels [phi3.5-moe]", kernel_phase, dev, timer, 32, 8, 128,
          "phi3.5-moe shapes")
    phase("kernels [dbrx-132b]", kernel_phase, dev, timer, 48, 8, 128,
          "dbrx-132b shapes")
    phase("kernels [whisper-base]", whisper_kernel_phase, dev, timer)
    phase("grad [attention]", grad_phase, dev, timer)
    launches, models, params, docs = phase("serve", serving_phase)
    seed_launches = phase("serve [seed engine]", seed_engine_phase, models,
                          params, docs)
    prefix_launches = phase("serve [prefix]", prefix_serving_phase, models,
                            params, docs)
    chaos_launches = phase("serve [chaos]", chaos_phase, models, params)
    g_model, g_params, _ = phase("gemma3", gemma3_model_phase)
    gemma3_launches, g_cascades, g_docs = phase(
        "serve [gemma3 oracle]", gemma3_serving_phase, models, params,
        g_model, g_params)
    moe_model_launches, moe_launches = phase(
        "models [families] + serve [moe oracle]", moe_families_phase, docs)
    rec_model_launches, rec_launches = phase(
        "models [families] + serve [recurrent]", recurrent_families_phase,
        docs)
    # the families' models (phi3.5-moe's 41.9 GB among them) are held by
    # reference cycles until a collection: free them before the next
    # full-width models
    gc.collect()
    torch.cuda.empty_cache()
    rg32_launches = phase("models [recurrentgemma-2b f32]",
                          recurrentgemma_f32_phase)
    gc.collect()
    torch.cuda.empty_cache()
    dbrx_model_launches, dbrx_launches = phase(
        "models [dbrx-132b] + serve [dbrx oracle]", dbrx_phase, models,
        params, docs)
    build_launches, restr, build_docs, engine, reordered = phase(
        "build", build_phase)
    rows.append(phase("relevance", relevance_phase, dev, timer, restr,
                      build_docs))
    restructure_breakdown(dev, build_docs, reordered)
    if "--profile" in sys.argv[1:]:
        profile_phase(models, params, docs, engine.backends["oracle"],
                      (g_model, g_params, g_cascades, g_docs))
    # training holds ~16 GB of llama3.2-1b state besides its activations:
    # free the serving, gemma3 and build models first
    del models, params, docs, g_model, g_params, g_cascades, g_docs
    del engine, restr, build_docs, reordered
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, _ = phase("train [llama3.2-1b]", train_llama_phase)
    gc.collect()
    torch.cuda.empty_cache()
    dbrx_train_launches = phase("train [dbrx-132b]", train_dbrx_phase)
    lse_row, dist_launches = phase("distributed", distributed_phase, dev,
                                   timer)
    rows.append(lse_row)
    whisper_launches, whisper_train_launches = phase(
        "models [whisper-base] + train [whisper-base]", whisper_phase)
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_launches = phase("dryrun [cells]", dryrun_phase)
    for r in rows:
        # each path's run, counted from zero: serving, the seed and arena
        # engines' timed runs, prefix, chaos, gemma3 oracle, the families'
        # model checks and their two serving paths, the f32 recurrentgemma
        # check, dbrx's model check and serving, build, llama3.2-1b and
        # dbrx training, the data-parallel steps and the sp-decode LM of
        # the distributed phase, whisper's model check and its training,
        # the dry-run's world-1 cells
        r["launches"] = sum(c[r["name"]] for c in (
            launches, *seed_launches, prefix_launches, chaos_launches,
            gemma3_launches,
            *moe_model_launches, moe_launches, *rec_model_launches,
            rec_launches, rg32_launches, dbrx_model_launches, dbrx_launches,
            build_launches, train_launches, dbrx_train_launches,
            *dist_launches, whisper_launches, whisper_train_launches,
            *dryrun_launches))
        assert r["launches"] > 0, r["name"]
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + ("stream_ms",) if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
