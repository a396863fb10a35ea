"""A cascade with a sliding-window oracle served by the port, held against
the JAX engine on the same weights.

The proxy is the reduced llama3.2-1b of ``tests/test_torch_serving.py``
(2 layers, paged-capable); the oracle is the reduced gemma3-27b of
``tests/test_torch_local_attention.py`` (8 layers: five local, one
global, a two-layer local tail; window 16).  Its ring caches keep it on
the gather plane in both packages.  The documents run 18 to 30 words,
so every bucket is longer than the window: the regime in which both
packages keep bucket PAD in the ring (see that file's padded-bucket
test).  ``CascadeEngine.run`` and a two-query ``CascadeServer`` drain
must give the JAX engine's preds, exit stages, statuses, token counts
and per-document $ EXACTLY, and confs within 1e-5; inside the port,
``inflight=3`` equals ``inflight=1`` bitwise.
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

# short operations: the JAX engine compiles each stage step with its
# op-suffix decode steps unrolled, so each token costs compile time
OPS = {"o_orig": "overturned", "sur_1": "court mentioned"}
THR = {0: 2.0, 1: 2.0}          # impossible: every doc reaches the oracle
DOCS = {i: " ".join(f"w{i}x{j}" for j in range(n))
        for i, n in enumerate([20, 30, 18, 26])}
ARCH = {"proxy": ("llama3_2_1b", dict(num_layers=2)),
        "oracle": ("gemma3_27b", dict(num_layers=8, sliding_window=16))}
RATE = {"proxy": 0.06, "oracle": 1.0}


def _cfg(get_reduced, name):
    arch, kw = ARCH[name]
    return get_reduced(arch, dtype="float32", vocab_size=512, **kw)


def _ladder(C=Cascade, T=Task, TC=TaskConfig):
    return C([T(TC("proxy", "sur_1", 0.25), THR),
              T(TC("proxy", "o_orig", 1.0), THR)])


def _tenants(C=Cascade, T=Task, TC=TaskConfig):
    """Two queries routing on confidence: documents exit at the proxy
    stages or fall through to the gemma3 oracle."""
    return [C([T(TC("proxy", "sur_1", 0.25), {0: 0.56, 1: 0.56}),
               T(TC("proxy", "o_orig", 1.0), {0: 0.6, 1: 0.6})]),
            C([T(TC("proxy", "o_orig", 1.0), {0: 0.6, 1: 0.6})])]


def _backends(params, **kw):
    out = {}
    for name in ("proxy", "oracle"):
        m = LM(t_resolve(_cfg(t_get_reduced, name), tp=1), device="cpu")
        out[name] = LMBackend(name=name, model=m, params=params[name],
                              tokenizer=HashWordTokenizer(vocab_size=512),
                              rate_per_token=RATE[name], s_alloc=512,
                              device="cpu", **kw)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's ladder run and two-query drain, and the port's
    converted parameters."""
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
    jparams, jmodels = {}, {}
    for name, seed in (("proxy", 1), ("oracle", 2)):
        jmodels[name] = JLM(resolve(_cfg(get_reduced, name), tp=1), CPU_TEST)
        jparams[name] = jax.jit(jmodels[name].init)(jax.random.PRNGKey(seed))

    # one set of backends for both runs: their compiled stage steps are
    # reused where the launch signatures repeat
    backends = {n: JBackend(name=n, model=jmodels[n], params=jparams[n],
                            tokenizer=JTok(vocab_size=512),
                            rate_per_token=RATE[n], s_alloc=512)
                for n in ("proxy", "oracle")}
    ladder = JEngine(dict(backends), OPS, n_classes=2, batch_size=4).run(
        _ladder(JC, JT, JTC), DOCS)
    for be in backends.values():
        be.reset()
    srv = JServer(dict(backends), OPS, n_classes=2, batch_size=4)
    assert not srv.backends["oracle"].model.supports_paged_kv
    drained = _drain(srv, _tenants(JC, JT, JTC))
    tparams = {n: from_jax_params(
        jax.tree.map(np.asarray, p),
        t_resolve(_cfg(t_get_reduced, n), tp=1), "cpu")
        for n, p in jparams.items()}
    return ladder, drained, tparams


def _drain(srv, cascades):
    handles = [srv.register(c) for c in cascades]
    for i, d in enumerate(sorted(DOCS)):
        for h in handles:
            h.submit(d, DOCS[d], arrival=float(i))
    srv.drain()
    return [h.result() for h in handles]


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
    jladder, _, tparams = jax_runs
    eng = CascadeEngine(_backends(tparams), OPS, n_classes=2, batch_size=4,
                        device="cpu")
    assert eng.backends["proxy"].model.supports_paged_kv
    assert not eng.backends["oracle"].uses_paged_kv()
    res = eng.run(_ladder(), DOCS)
    _same(res, jladder)
    assert res.cost == jladder.cost
    assert res.stats.batches == jladder.stats.batches
    assert set(res.exit_stage.values()) == {2}         # all at the oracle


def test_two_query_drain_matches_jax(jax_runs):
    _, jdrained, tparams = jax_runs
    srv = CascadeServer(_backends(tparams), OPS, n_classes=2, batch_size=4,
                        device="cpu")
    cascades = _tenants()
    drained = _drain(srv, cascades)
    for res, jres in zip(drained, jdrained):
        _same(res, jres)
    # the queries route: some documents exit at a proxy stage, others
    # fall through to the gemma3 oracle (the stage after the last task)
    exits = [(s == len(c.tasks)) for c, r in zip(cascades, drained)
             for s in r.exit_stage.values()]
    assert any(exits) and not all(exits)


def test_inflight_three_equals_inflight_one_bitwise():
    m = {n: LM(t_resolve(_cfg(t_get_reduced, n), tp=1), device="cpu")
         for n in ("proxy", "oracle")}
    params = {"proxy": m["proxy"].init(seed=1),
              "oracle": m["oracle"].init(seed=2)}
    out = {}
    for inflight in (1, 3):
        srv = CascadeServer(_backends(params), OPS, n_classes=2,
                            batch_size=4, inflight=inflight, device="cpu")
        out[inflight] = (srv, _drain(srv, _tenants()))
    (s1, r1), (s3, r3) = out[1], out[3]
    assert s1._max_inflight_seen == 1 and s3._max_inflight_seen >= 2
    for a, b in zip(r1, r3):
        assert (a.pred, a.conf, a.doc_cost, a.status) == \
            (b.pred, b.conf, b.doc_cost, b.status)


def test_mixed_length_arena_allocates_grows_and_counts_bytes():
    """A gemma3 arena holds 16-slot rings beside full-length global
    caches: ``slot_nbytes`` (from ``state_shapes``) bills exactly what
    the arena allocates, before and after a capacity doubling, and growth
    keeps every row's contents."""
    from repro_torch.serving.arena import BucketArena
    params = {"proxy": None, "oracle": None}
    be = _backends(params)["oracle"]
    bucket = 32
    s_alloc = be._s_alloc_for(bucket)
    ar = BucketArena(be.model, bucket, s_alloc, capacity=2, device="cpu")
    lens = [layer["k"].shape[1] for layer in ar.states]
    assert lens == [16] * 5 + [s_alloc] + [16] * 2
    assert ar.nbytes() == 3 * be.slot_nbytes(bucket)
    for layer in ar.states:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=torch.Generator()
                                .manual_seed(t.shape[1])))
    before = [{n: t.clone() for n, t in layer.items()} for layer in ar.states]
    ar.ensure_capacity(5)
    assert ar.capacity == 8 and ar.nbytes() == 9 * be.slot_nbytes(bucket)
    for a, b in zip(ar.states, before):
        for n in ("k", "v"):
            assert a[n].shape[1] == b[n].shape[1]
            assert torch.equal(a[n][:3], b[n])
    ar.clear_slot(1)
    assert ar.cached_len[1] == 0


def test_serve_build_engine_takes_a_gemma3_oracle():
    from repro_torch.launch import serve
    from repro_torch.serving.scheduler import RESOLVED
    eng = serve.build_engine(2, None, 64, oracle_arch="gemma3_27b",
                             device="cpu")
    oracle = eng.backends["oracle"]
    assert oracle.model.rcfg.base.name == "gemma3-27b"
    assert not oracle.uses_paged_kv()
    docs = {i: " ".join(f"w{i}x{j}" for j in range(n))
            for i, n in enumerate([70, 90, 40])}        # past window 64
    res = eng.run(Cascade([]), docs)
    assert set(res.status.values()) == {RESOLVED}
