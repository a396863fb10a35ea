"""The port's prefix-sharing plane held against the JAX package's, and
its internal contracts (the cases of ``tests/test_prefix_sharing.py``).

Op-first layout: each operation prefix is prefilled once per (backend,
op, bucket) into a pinned, refcounted arena row; every document's block
table points its leading columns at that row (whole-block sharing) or
copies the remainder into its private row at attach time
(copy-on-write).  ``LMBackend.layout_block`` stands in for the JAX
``Runtime``'s ``block_q``/``block_kv``: at 16 the 16-token operation
shares one whole column, at the default 512 every operation shares by
copy-on-write.

Against JAX: the same fraction ladders (same-op, and an op switch that
invalidates the cache) run in both packages on the same weights
(``from_jax_params``), the JAX side with ``Runtime(attn_impl="xla",
block_q=16, block_kv=16)`` and with the default Runtime (512), the port
with the matching ``layout_block``.  Per-document $, stage token counts,
batches, ``prefix_hits`` and ``cow_copies`` must be EXACT, preds equal,
confs within 1e-5 (f32 logits through a two-class softmax).

CUDA part (skipped without a card): the prefix plane on the card with
``inflight=3`` bitwise equal to ``inflight=1``, the pinned rows bitwise
unchanged after a drain, and the decode and extend kernels through tables
whose leading columns name a shared row bitwise equal to the same kernels
over slot rows holding a materialized copy of the prefix.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.core.tasks import Cascade, Task, TaskConfig  # noqa: E402
from repro_torch.data.documents import generate_corpus  # noqa: E402
from repro_torch.data.tokenizer import HashWordTokenizer  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.engine import (CascadeEngine,  # noqa: E402
                                        CascadeServer, LMBackend)
from repro_torch.serving.scheduler import bucket_len  # noqa: E402

VOCAB = 512
# 16 words -> P == 16 == the block at layout_block 16: one fully shared
# block-table column, zero COW remainder
OP_ALIGNED = ("alpha beta gamma delta epsilon zeta eta theta "
              "iota kappa lam mu nu xi omicron pi")
# 20 words: at layout_block 16 it pads to 32 (two shared columns); at 512
# the whole prefix shares via the copy-on-write remainder
OP_RAGGED = OP_ALIGNED + " rho sigma tau upsilon"
OPS = {"o_orig": OP_ALIGNED, "sur_1": OP_RAGGED}
IMPOSSIBLE = {0: 2.0, 1: 2.0}      # no early exit: schedule-identical runs
LADDERS = {"same_op": ("o_orig", "o_orig"), "op_switch": ("sur_1", "o_orig")}


def _ladder(ops, C=Cascade, T=Task, TC=TaskConfig):
    return C([T(TC("proxy", ops[0], 0.25), IMPOSSIBLE),
              T(TC("proxy", ops[1], 1.0), IMPOSSIBLE)])


def _rcfg():
    return t_resolve(t_get_reduced("llama3_2_1b", dtype="float32",
                                   vocab_size=VOCAB, num_layers=2), tp=1)


@pytest.fixture(scope="module")
def tokz():
    return HashWordTokenizer(vocab_size=VOCAB)


@pytest.fixture(scope="module")
def docs():
    return {d.doc_id: d.text
            for d in generate_corpus(6, avg_lines=6, seed=7)}


@pytest.fixture(scope="module")
def params():
    m = LM(_rcfg(), device="cpu")
    return {"proxy": m.init(seed=1), "oracle": m.init(seed=2)}


def _backend(name, p, tokz, block=16, device="cpu", **kw):
    return LMBackend(name=name, model=LM(_rcfg(), device=device), params=p,
                     tokenizer=tokz,
                     rate_per_token=1.0 if name == "oracle" else 0.06,
                     s_alloc=512, layout_block=block, device=device, **kw)


def _backends(params, tokz, prefix=True, block=16, proxy_kw=None, **kw):
    return {"proxy": _backend("proxy", params["proxy"], tokz, block,
                              prefix_sharing=prefix, **kw,
                              **(proxy_kw or {})),
            "oracle": _backend("oracle", params["oracle"], tokz, block,
                               prefix_sharing=prefix, **kw)}


def _run_ladder(params, tokz, docs, prefix, op="o_orig", **kw):
    backends = _backends(params, tokz, prefix, **kw)
    eng = CascadeEngine(backends, OPS, n_classes=2, batch_size=4,
                        device="cpu")
    return eng.run(_ladder((op, op)), docs), backends


def _toks(tokz, docs):
    return {d: np.asarray(tokz.encode(t), np.int32)
            for d, t in docs.items()}


def _stage_inputs(tokz, docs, op="o_orig"):
    toks = _toks(tokz, docs)
    ids = sorted(toks)
    blen = max(bucket_len(len(toks[d])) for d in ids)
    return toks, ids, blen, np.asarray(tokz.encode(OPS[op]), np.int32)


# ------------------------------------------------------- against the JAX

@pytest.fixture(scope="module")
def jax_ladders(docs):
    """JAX prefix-plane results for every (block, ladder) + the weights
    they ran with, converted for the port."""
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.core.tasks import Cascade as JC, Task as JT, TaskConfig as JTC
    from repro.data.tokenizer import HashWordTokenizer as JTok
    from repro.models.model import LM as JLM
    from repro.models.runtime import Runtime
    from repro.serving.engine import (CascadeEngine as JEngine,
                                      LMBackend as JBackend)
    from repro_torch.models.convert import from_jax_params
    rcfg = resolve(get_reduced("llama3_2_1b", dtype="float32",
                               vocab_size=VOCAB, num_layers=2), tp=1)
    jtokz = JTok(vocab_size=VOCAB)
    jparams = {n: JLM(rcfg, Runtime(remat=False)).init(
        jax.random.PRNGKey(seed)) for n, seed in (("proxy", 1),
                                                  ("oracle", 2))}
    out = {}
    for block in (16, 512):
        rt = Runtime(attn_impl="xla", block_q=block, block_kv=block,
                     remat=False) if block == 16 else \
            Runtime(attn_impl="xla", remat=False)
        backends = {n: JBackend(
            name=n, model=JLM(rcfg, rt), params=jparams[n], tokenizer=jtokz,
            rate_per_token=1.0 if n == "oracle" else 0.06, s_alloc=512,
            prefix_sharing=True) for n in ("proxy", "oracle")}
        eng = JEngine(backends, OPS, n_classes=2, batch_size=4)
        for name, ops in LADDERS.items():
            out[(block, name)] = eng.run(_ladder(ops, JC, JT, JTC), docs)
    tparams = {n: from_jax_params(jax.tree.map(np.asarray, p), _rcfg(),
                                  "cpu")
               for n, p in jparams.items()}
    return out, tparams


@pytest.mark.parametrize("block", [16, 512])
@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_prefix_plane_matches_jax(jax_ladders, tokz, docs, block, ladder):
    jres_all, tparams = jax_ladders
    jres = jres_all[(block, ladder)]
    backends = _backends(tparams, tokz, block=block)
    eng = CascadeEngine(backends, OPS, n_classes=2, batch_size=4,
                        device="cpu")
    res = eng.run(_ladder(LADDERS[ladder]), docs)
    assert backends["proxy"].uses_paged_kv()
    assert res.doc_cost == jres.doc_cost                 # exact $
    assert res.cost == jres.cost
    assert res.pred == jres.pred
    assert res.status == jres.status
    st, jst = res.stats, jres.stats
    assert st.stage_new_tokens == jst.stage_new_tokens
    assert st.stage_cached_tokens == jst.stage_cached_tokens
    assert st.batches == jst.batches
    assert st.prefix_hits == jst.prefix_hits > 0
    assert st.cow_copies == jst.cow_copies
    assert (st.cow_copies > 0) == (block == 512)
    for d in docs:
        assert abs(res.conf[d] - jres.conf[d]) <= 1e-5


# ------------------------------------------------- the reference's cases

def test_prefix_dollar_parity_and_counters(params, tokz, docs):
    """Same-op fraction ladder: the op-first plane bills EXACTLY what the
    doc-before-op plane bills, per document — billing follows the token
    accounting contract, not the physical prefill work the memo saves."""
    res_a, _ = _run_ladder(params, tokz, docs, prefix=False)
    res_b, _ = _run_ladder(params, tokz, docs, prefix=True)
    assert res_a.doc_cost == res_b.doc_cost
    assert set(res_b.pred) == set(docs)
    st = res_b.stats
    assert st.prefix_hits > 0
    assert st.arena_bytes_peak > 0
    assert res_a.stats.prefix_hits == 0


def test_whole_columns_and_copy_on_write_agree(params, tokz, docs):
    """The port's counterpart of the reference's pallas-vs-gather case:
    the same 16-token prefix shared through a whole block-table column
    (layout block 16) and through the copy-on-write remainder (512) lies
    at the same positions, so the two table geometries answer alike
    stage by stage."""
    toks, ids, blen, op = _stage_inputs(tokz, docs)
    be16 = _backend("proxy", params["proxy"], tokz, 16, prefix_sharing=True)
    be512 = _backend("proxy", params["proxy"], tokz, 512,
                     prefix_sharing=True)
    for frac in (0.25, 1.0):
        p16, c16, n16, ca16 = be16.run_stage(ids, toks, blen, frac, op, 2)
        p5, c5, n5, ca5 = be512.run_stage(ids, toks, blen, frac, op, 2)
        np.testing.assert_array_equal(p16, p5)
        np.testing.assert_allclose(c16, c5, atol=1e-5)
        assert n16 == n5 and ca16 == ca5
    assert be16.cow_copies == 0 and be512.cow_copies == len(ids)


def test_bf16_arena_parity_and_halved_bytes(params, tokz, docs):
    """bf16-compressed arenas: same $ to the cent, preds equal and confs
    within quantization tolerance of f32, and every byte-accounting
    surface bills the stored dtype (half an f32 row)."""
    res32, bes32 = _run_ladder(params, tokz, docs, prefix=True)
    res16, bes16 = _run_ladder(params, tokz, docs, prefix=True,
                               kv_dtype="bfloat16")
    assert res32.doc_cost == res16.doc_cost
    match = np.mean([res32.pred[d] == res16.pred[d] for d in docs])
    assert match >= 0.8        # random-init logits are near-uniform
    dconf = max(abs(res32.conf[d] - res16.conf[d]) for d in docs)
    assert dconf < 5e-2
    b32 = bes32["proxy"].slot_nbytes(128)
    b16 = bes16["proxy"].slot_nbytes(128)
    assert b16 == b32 // 2
    for ar in bes16["proxy"]._arenas.values():
        assert all(t.dtype == torch.bfloat16
                   for layer in ar.states for t in layer.values())


def test_shared_prefix_row_billed_once(params, tokz, docs):
    """N attached documents pin ONE prefix row: the allocator issues one
    pseudo-slot for the op however many documents share it, so the byte
    ledger counts the shared KV exactly once."""
    toks, ids, blen, op = _stage_inputs(tokz, docs)
    be = _backend("proxy", params["proxy"], tokz, prefix_sharing=True)
    be.run_stage(ids, toks, blen, 0.5, op, 2)
    assert be._alloc.live(blen) == len(ids) + 1     # docs + ONE prefix row
    ar = be._arenas[blen]
    assert len(ar.prefix_row) == 1
    row = next(iter(ar.prefix_row.values()))
    assert ar.prefix_refs[row] == len(ids)
    assert be.arena_nbytes() == (ar.capacity + 1) * be.slot_nbytes(blen)
    hits = be.prefix_hits
    be.run_stage(ids, toks, blen, 1.0, op, 2)      # idempotent refcounts
    assert be.prefix_hits == hits
    assert ar.prefix_refs[row] == len(ids)


def _row_window(be, ar, row, p_eff):
    w = be.model.take_kv_window(
        ar.states, torch.tensor([row], dtype=torch.int32),
        torch.tensor([0], dtype=torch.int32), p_eff)
    return [t.clone() for layer in w for t in layer.values()]


def test_cow_prefix_row_stays_bitwise_pristine(params, tokz, docs):
    """Through extend / readout-undo / release / re-attach interleavings,
    the pinned prefix row's KV window stays BITWISE identical to the
    moment it was prefilled; retiring the arena drops the memo and the
    re-prefilled plane answers as before."""
    toks, ids, blen, op = _stage_inputs(tokz, docs, "sur_1")   # ragged
    be = _backend("proxy", params["proxy"], tokz, 512, prefix_sharing=True)
    be.run_stage(ids[:2], toks, blen, 0.25, op, 2)
    assert be.cow_copies == 2          # big blocks: pure-COW sharing
    ar = be._arenas[blen]
    row = next(iter(ar.prefix_row.values()))
    p_eff = be._prefix_eff_len(len(op))
    baseline = _row_window(be, ar, row, p_eff)
    be.run_stage(ids[:2], toks, blen, 1.0, op, 2)        # extend + readout
    be.run_stage(ids[:2], toks, blen, 0.5, op, 2)        # decode-only
    be.run_stage(ids[2:], toks, blen, 1.0, op, 2)        # new attachments
    be.release(ids[0])                                   # detach one
    be.run_stage([ids[0]], toks, blen, 1.0, op, 2)       # fresh re-attach
    for a, b in zip(baseline, _row_window(be, ar, row, p_eff)):
        assert torch.equal(a, b)
    p_before, c_before, *_ = be.run_stage(ids, toks, blen, 1.0, op, 2)
    for d in ids:
        be.release(d)
    be.retire(blen)
    assert blen not in be._arenas
    p_after, c_after, *_ = be.run_stage(ids, toks, blen, 1.0, op, 2)
    np.testing.assert_array_equal(p_before, p_after)
    np.testing.assert_allclose(c_before, c_after, atol=1e-6)


def test_op_switch_invalidates_prefix_cache(params, tokz, docs):
    """The op-first layout bakes the op into every document's KV, so a
    stage advance that switches ops on the same backend re-prefills from
    scratch: stage 1 bills ZERO cached tokens, where the doc-before-op
    plane reuses the fraction prefix."""
    eng = CascadeEngine(_backends(params, tokz), OPS, n_classes=2,
                        batch_size=4, device="cpu")
    res = eng.run(_ladder(LADDERS["op_switch"]), docs)
    assert set(res.pred) == set(docs)
    assert res.stats.stage_cached_tokens[1] == 0
    res_base, _ = _run_ladder(params, tokz, docs, prefix=False)
    assert res_base.stats.stage_cached_tokens[1] > 0


def test_eviction_skips_pinned_prefix_rows(params, tokz, docs):
    """Under slot pressure evictions preempt documents, never the pinned
    prefix row, and every cached token an eviction loses is counted as a
    re-prefill token.  Each newcomer arrives OLDER than every cached
    veteran (arrival=-j), so its launch must steal a slot."""
    res_ref, _ = _run_ladder(params, tokz, docs, prefix=True)
    backends = _backends(params, tokz, proxy_kw={"slot_budget": 3})
    eng = CascadeEngine(backends, OPS, n_classes=2, batch_size=4,
                        device="cpu")
    eng.start(_ladder(LADDERS["same_op"]))
    for j, d in enumerate(sorted(docs)):
        eng.submit(d, docs[d], arrival=float(-j))
        eng.step()
    res = eng.drain()
    assert set(res.pred) == set(docs)
    st = res.stats
    assert st.evictions > 0 and st.re_prefill_tokens > 0
    assert st.prefix_hits > 0
    proxy = backends["proxy"]
    rows = [(ar, row) for ar in proxy._arenas.values()
            for row in ar.prefix_row.values()]
    assert rows
    assert all(ar.prefix_refs.get(row, 0) == 0 for ar, row in rows)
    assert res.pred == res_ref.pred
    np.testing.assert_allclose(
        [res.conf[d] for d in sorted(docs)],
        [res_ref.conf[d] for d in sorted(docs)], atol=1e-5)


def _serve(params, tokz, docs, cascade, *, inflight, device="cpu",
           block=16):
    backends = _backends(params, tokz, block=block, device=device)
    srv = CascadeServer(backends, OPS, n_classes=2, batch_size=4,
                        inflight=inflight, device=device)
    h = srv.register(cascade)
    for i, d in enumerate(sorted(docs)):
        h.submit(d, docs[d], arrival=float(i))
    return srv, h.drain()


def _assert_inflight_bitwise(params, tokz, device):
    docs = {d.doc_id: d.text
            for d in generate_corpus(8, avg_lines=10, seed=7)}
    out = {k: _serve(params, tokz, docs, _ladder(LADDERS["op_switch"]),
                     inflight=k, device=device) for k in (1, 3)}
    (s1, r1), (s3, r3) = out[1], out[3]
    assert s1._max_inflight_seen == 1 and s3._max_inflight_seen >= 2
    assert r3.pred == r1.pred
    assert r3.conf == r1.conf                   # float equality, bitwise
    assert r3.doc_cost == r1.doc_cost
    assert r3.status == r1.status
    assert r1.stats.prefix_hits == r3.stats.prefix_hits > 0
    return out


def test_prefix_inflight_three_equals_inflight_one_bitwise(params, tokz):
    """Ahead-of-time dispatch on the prefix plane: the scheduler's veto
    keeps a first-touch prefill away from open tickets of its bucket, and
    preds, confs and per-document $ are bitwise those of inflight=1."""
    _assert_inflight_bitwise(params, tokz, "cpu")


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_prefix_inflight_three_equals_inflight_one_bitwise(cuda, tokz):
    m = LM(_rcfg(), device=cuda)
    cparams = {"proxy": m.init(seed=1), "oracle": m.init(seed=2)}
    _assert_inflight_bitwise(cparams, tokz, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 512])
def test_cuda_pinned_rows_pristine_after_drain(cuda, tokz, block):
    """Every pinned prefix row reads back bitwise as it was prefilled
    after a whole drain (extends, readouts, attaches, releases)."""
    m = LM(_rcfg(), device=cuda)
    cparams = {"proxy": m.init(seed=1), "oracle": m.init(seed=2)}
    backends = _backends(cparams, tokz, block=block, device=cuda)
    seen = {}
    proxy = backends["proxy"]
    orig = proxy._ensure_prefix_row

    def ensure(arena, bucket, op_key, op_tokens):
        fresh = op_key not in arena.prefix_row
        row = orig(arena, bucket, op_key, op_tokens)
        if fresh:
            p_eff = proxy._prefix_eff_len(len(op_tokens))
            seen[(bucket, op_key)] = (row, p_eff,
                                      _row_window(proxy, arena, row, p_eff))
        return row

    proxy._ensure_prefix_row = ensure
    docs = {d.doc_id: d.text
            for d in generate_corpus(8, avg_lines=10, seed=7)}
    srv = CascadeServer(backends, OPS, n_classes=2, batch_size=4,
                        device=cuda)
    h = srv.register(_ladder(LADDERS["op_switch"]))
    for i, d in enumerate(sorted(docs)):
        h.submit(d, docs[d], arrival=float(i))
    res = h.drain()
    assert set(res.pred) == set(docs) and seen
    for (bucket, op_key), (row, p_eff, base) in seen.items():
        ar = proxy._arenas[bucket]
        assert ar.prefix_row[op_key] == row
        for a, b in zip(base, _row_window(proxy, ar, row, p_eff)):
            assert torch.equal(a, b), (bucket, op_key)


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Dh", [(32, 64), (16, 128)])
@pytest.mark.parametrize("tb,P", [(16, 32), (512, 20)])
def test_cuda_kernels_through_shared_tables_equal_materialized(cuda, Hq, Dh,
                                                               tb, P):
    """Decode and extend through tables whose leading columns name a
    pinned prefix row equal, bitwise, the same kernels over slot rows
    that hold a materialized copy of the prefix (at table block 16 the
    prefix spans whole columns; at 512 a copy-on-write remainder)."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=cuda).manual_seed(0)
    B, Hkv, N, S = 4, 8, 9, 1024
    bf = torch.bfloat16
    ka = torch.randn((N, S, Hkv, Dh), generator=g, device=cuda).to(bf)
    va = torch.randn((N, S, Hkv, Dh), generator=g, device=cuda).to(bf)
    row, slots = 6, torch.tensor([0, 3, 5, 8], dtype=torch.int32,
                                 device=cuda)
    shared = (P // tb) * tb                      # positions in whole columns
    rem = P - shared
    if rem:                                      # copy-on-write remainder
        ka[slots[:3].long(), shared:P] = ka[row, shared:P]
        va[slots[:3].long(), shared:P] = va[row, shared:P]
    bt = slots[:, None].repeat(1, S // tb)
    bt[:3, : P // tb] = row                      # row 3 is padding
    mk, mv = ka.clone(), va.clone()              # materialized prefix
    mk[slots[:3].long(), :shared] = ka[row, :shared]
    mv[slots[:3].long(), :shared] = va[row, :shared]
    kv_len = torch.tensor([P + 300, P + 1, P + 77, 1], dtype=torch.int32,
                          device=cuda)
    q = torch.randn((B, Hq, Dh), generator=g, device=cuda).to(bf)
    d_bt = ops.arena_decode_attention(q, ka, va, slots, kv_len,
                                      block_tables=bt)
    d_mat = ops.arena_decode_attention(q, mk, mv, slots, kv_len)
    assert torch.equal(d_bt, d_mat)
    Sq, off = 64, P + 40
    qe = torch.randn((B, Sq, Hq, Dh), generator=g, device=cuda).to(bf)
    kw = dict(kv_valid=off + Sq, q_offset=off,
              kv_len=torch.clamp(kv_len + Sq, max=off + Sq))
    e_bt = ops.attention_paged(qe, ka, va, slots, block_tables=bt, **kw)
    e_mat = ops.attention_paged(qe, mk, mv, slots, **kw)
    assert torch.equal(e_bt, e_mat)
