"""Cascades over the other decoder families, served by the port and held
against the JAX engine on the same weights.

Two proxy/oracle pairs, reduced (f32, vocab 512):

- ``moe``: a qwen2-vl-2b proxy (M-RoPE, 2 layers) and a phi3.5-moe oracle
  (4 experts, top-2, 2 layers); both all full attention, so paged-capable
  (the CPU runs the gather plane, as the JAX engine does there);
- ``recurrent``: an xlstm-350m proxy (mLSTM/sLSTM, 4 layers) and a
  recurrentgemma-2b oracle (RG-LRU and local attention, 6 layers, window
  16); gather plane in both packages.

Each pair serves a two-stage proxy ladder with impossible thresholds, so
every document walks every stage and reaches the oracle (the moe pair at
fractions 0.25 -> 1.0; the recurrent pair at 0.5 -> 1.0, as on the card,
since an mLSTM extend from 0.25 to 1.0 of a bucket-512 document fails the
reference's chunking assertion), and a two-query drain whose thresholds
route documents out at proxy stages.  ``CascadeEngine.run`` and the drain
must give the JAX engine's preds, exit stages, statuses, token counts and
per-document $ EXACTLY, and confs within f32 1e-5.  Inside the port, the
moe pair's ``inflight=3`` equals ``inflight=1`` bitwise; a recurrent arena
bills ``slot_nbytes`` exactly as it allocates its f32 state leaves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.core.tasks import Cascade, Task, TaskConfig  # noqa: E402
from repro_torch.data.tokenizer import HashWordTokenizer  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.engine import (CascadeEngine,  # noqa: E402
                                        CascadeServer, LMBackend)

OPS = {"o_orig": "overturned", "sur_1": "court mentioned"}
THR = {0: 2.0, 1: 2.0}          # impossible: every doc reaches the oracle
DOCS = {i: " ".join(f"w{i}x{j}" for j in range(n))
        for i, n in enumerate([20, 30, 18, 26])}
PAIRS = {
    "moe": {"proxy": ("qwen2_vl_2b", dict(num_layers=2)),
            "oracle": ("phi3_5_moe", dict(num_layers=2)),
            "first": 0.25},
    "recurrent": {"proxy": ("xlstm_350m", {}),
                  "oracle": ("recurrentgemma_2b", dict(sliding_window=16)),
                  "first": 0.5},
}
RATE = {"proxy": 0.06, "oracle": 1.0}


def _cfg(get_reduced, pair, name):
    arch, kw = PAIRS[pair][name]
    return get_reduced(arch, dtype="float32", vocab_size=512, **kw)


def _ladder(pair, C=Cascade, T=Task, TC=TaskConfig):
    f = PAIRS[pair]["first"]
    return C([T(TC("proxy", "sur_1", f), THR),
              T(TC("proxy", "o_orig", 1.0), THR)])


def _tenants(pair, C=Cascade, T=Task, TC=TaskConfig):
    f = PAIRS[pair]["first"]
    return [C([T(TC("proxy", "sur_1", f), {0: 0.56, 1: 0.56}),
               T(TC("proxy", "o_orig", 1.0), {0: 0.6, 1: 0.6})]),
            C([T(TC("proxy", "o_orig", 1.0), {0: 0.6, 1: 0.6})])]


def _backends(pair, params, **kw):
    out = {}
    for name in ("proxy", "oracle"):
        m = LM(t_resolve(_cfg(t_get_reduced, pair, name), tp=1),
               device="cpu")
        out[name] = LMBackend(name=name, model=m, params=params[name],
                              tokenizer=HashWordTokenizer(vocab_size=512),
                              rate_per_token=RATE[name], s_alloc=512,
                              device="cpu", **kw)
    return out


def _drain(srv, cascades):
    handles = [srv.register(c) for c in cascades]
    for i, d in enumerate(sorted(DOCS)):
        for h in handles:
            h.submit(d, DOCS[d], arrival=float(i))
    srv.drain()
    return [h.result() for h in handles]


@pytest.fixture(scope="module", params=sorted(PAIRS))
def jax_runs(request):
    """The JAX engine's ladder run and two-query drain for one pair, and
    the port's converted parameters."""
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.core.tasks import Cascade as JC, Task as JT, TaskConfig as JTC
    from repro.data.tokenizer import HashWordTokenizer as JTok
    from repro.models.model import LM as JLM
    from repro.models.runtime import CPU_TEST
    from repro.serving.engine import (CascadeEngine as JEngine,
                                      CascadeServer as JServer,
                                      LMBackend as JBackend)
    from repro_torch.models.convert import from_jax_params
    pair = request.param
    jparams, jmodels = {}, {}
    for name, seed in (("proxy", 1), ("oracle", 2)):
        jmodels[name] = JLM(resolve(_cfg(get_reduced, pair, name), tp=1),
                            CPU_TEST)
        jparams[name] = jax.jit(jmodels[name].init)(jax.random.PRNGKey(seed))
    backends = {n: JBackend(name=n, model=jmodels[n], params=jparams[n],
                            tokenizer=JTok(vocab_size=512),
                            rate_per_token=RATE[n], s_alloc=512)
                for n in ("proxy", "oracle")}
    ladder = JEngine(dict(backends), OPS, n_classes=2, batch_size=4).run(
        _ladder(pair, JC, JT, JTC), DOCS)
    for be in backends.values():
        be.reset()
    srv = JServer(dict(backends), OPS, n_classes=2, batch_size=4)
    drained = _drain(srv, _tenants(pair, JC, JT, JTC))
    tparams = {n: from_jax_params(
        jax.tree.map(np.asarray, p),
        t_resolve(_cfg(t_get_reduced, pair, n), tp=1), "cpu")
        for n, p in jparams.items()}
    return pair, ladder, drained, tparams


def _same(res, jres):
    assert res.pred == jres.pred
    assert res.exit_stage == jres.exit_stage
    assert res.status == jres.status
    assert res.doc_cost == jres.doc_cost               # exact $
    assert res.stats.stage_new_tokens == jres.stats.stage_new_tokens
    assert res.stats.stage_cached_tokens == jres.stats.stage_cached_tokens
    assert res.stats.stage_docs == jres.stats.stage_docs
    for d in res.conf:
        assert abs(res.conf[d] - jres.conf[d]) <= 1e-5


def test_engine_run_matches_jax(jax_runs):
    pair, jladder, _, tparams = jax_runs
    eng = CascadeEngine(_backends(pair, tparams), OPS, n_classes=2,
                        batch_size=4, device="cpu")
    paged = pair == "moe"
    for be in eng.backends.values():
        assert be.model.supports_paged_kv == paged
        assert not be.uses_paged_kv()                  # CPU: gather plane
    res = eng.run(_ladder(pair), DOCS)
    _same(res, jladder)
    assert res.cost == jladder.cost
    assert res.stats.batches == jladder.stats.batches
    assert set(res.exit_stage.values()) == {2}         # all at the oracle


@pytest.mark.parametrize("jax_runs", ["moe"], indirect=True)
def test_moe_pair_on_the_paged_plane_matches_jax(jax_runs):
    """The moe pair is all full attention: forced onto the paged plane
    (the card's default), the ladder gives the JAX engine's results too."""
    pair, jladder, _, tparams = jax_runs
    eng = CascadeEngine(_backends(pair, tparams, paged=True), OPS,
                        n_classes=2, batch_size=4, device="cpu")
    assert all(be.uses_paged_kv() for be in eng.backends.values())
    res = eng.run(_ladder(pair), DOCS)
    _same(res, jladder)
    assert res.cost == jladder.cost


def test_two_query_drain_matches_jax(jax_runs):
    pair, _, jdrained, tparams = jax_runs
    srv = CascadeServer(_backends(pair, tparams), OPS, n_classes=2,
                        batch_size=4, device="cpu")
    drained = _drain(srv, _tenants(pair))
    for res, jres in zip(drained, jdrained, strict=True):
        _same(res, jres)


def test_moe_pair_inflight_three_equals_inflight_one_bitwise():
    m = {n: LM(t_resolve(_cfg(t_get_reduced, "moe", n), tp=1), device="cpu")
         for n in ("proxy", "oracle")}
    params = {"proxy": m["proxy"].init(seed=1),
              "oracle": m["oracle"].init(seed=2)}
    out = {}
    for inflight in (1, 3):
        srv = CascadeServer(_backends("moe", params), OPS, n_classes=2,
                            batch_size=4, inflight=inflight, device="cpu")
        out[inflight] = (srv, _drain(srv, _tenants("moe")))
    (s1, r1), (s3, r3) = out[1], out[3]
    assert s1._max_inflight_seen == 1 and s3._max_inflight_seen >= 2
    for a, b in zip(r1, r3):
        assert (a.pred, a.conf, a.doc_cost, a.status) == \
            (b.pred, b.conf, b.doc_cost, b.status)


def test_recurrent_arena_bills_every_state_leaf():
    """An xlstm arena (f32 mLSTM/sLSTM states, no KV cache) and a
    recurrentgemma arena (RG-LRU states beside 16-slot rings, the rings in
    a bf16 ``kv_dtype``): ``slot_nbytes`` (from ``state_shapes``) bills
    exactly what the arena allocates, before and after a doubling, and
    growth keeps every row and zero-fills the new ones."""
    from repro_torch.serving.arena import BucketArena
    for name, kinds in (("proxy", {"C", "n", "m", "c", "h"}),
                        ("oracle", {"h", "conv", "k", "v"})):
        be = _backends("recurrent", {"proxy": None, "oracle": None},
                       kv_dtype="bfloat16")[name]
        bucket = 32
        ar = BucketArena(be.model, bucket, be._s_alloc_for(bucket),
                         capacity=2, kv_dtype=torch.bfloat16, device="cpu")
        assert {n for layer in ar.states for n in layer} == kinds
        for layer in ar.states:
            for n, t in layer.items():
                want = torch.bfloat16 if n in ("k", "v") else torch.float32
                assert t.dtype == want, (name, n)
        assert ar.nbytes() == 3 * be.slot_nbytes(bucket)
        for layer in ar.states:
            for t in layer.values():
                t.copy_(torch.randn(t.shape, generator=torch.Generator()
                                    .manual_seed(t.numel())))
        before = [{n: t.clone() for n, t in layer.items()}
                  for layer in ar.states]
        ar.ensure_capacity(5)
        assert ar.nbytes() == 9 * be.slot_nbytes(bucket)
        for a, b in zip(ar.states, before):
            for n in b:
                assert torch.equal(a[n][:3], b[n])
                assert not a[n][3:].any()


@pytest.mark.parametrize("proxy,oracle", [("qwen2_vl_2b", "phi3_5_moe"),
                                          ("xlstm_350m",
                                           "recurrentgemma_2b")])
def test_serve_build_engine_takes_the_new_families(proxy, oracle):
    from repro_torch.launch import serve
    from repro_torch.serving.scheduler import RESOLVED
    eng = serve.build_engine(2, None, 64, proxy_arch=proxy,
                             oracle_arch=oracle, device="cpu")
    assert eng.backends["proxy"].model.rcfg.base.name.startswith(
        proxy.split("_")[0])
    docs = {i: " ".join(f"w{i}x{j}" for j in range(n))
            for i, n in enumerate([40, 60, 20])}
    cascade = Cascade([Task(TaskConfig("proxy", "sur_court", 0.5),
                            {0: 0.6, 1: 0.6})])
    res = eng.run(cascade, docs)
    assert set(res.status.values()) == {RESOLVED}


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "phi3_5_moe", "xlstm_350m",
                                  "recurrentgemma_2b"])
def test_new_families_default_to_the_card(arch):
    """``LM``, ``LMBackend`` and ``CascadeServer`` with a new family run on
    the CUDA device unless told otherwise, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rcfg = t_resolve(t_get_reduced(arch, dtype="float32", vocab_size=512),
                     tp=1)
    with pytest.raises(RuntimeError):
        LM(rcfg)
    m = LM(rcfg, device="cpu")
    with pytest.raises(RuntimeError):
        LMBackend(name="proxy", model=m, params=None,
                  tokenizer=HashWordTokenizer(vocab_size=512),
                  rate_per_token=1.0)
    be = LMBackend(name="proxy", model=m, params=None,
                   tokenizer=HashWordTokenizer(vocab_size=512),
                   rate_per_token=1.0, device="cpu")
    with pytest.raises(RuntimeError):
        CascadeServer({"proxy": be, "oracle": be}, OPS, n_classes=2)
