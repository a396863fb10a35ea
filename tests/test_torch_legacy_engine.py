"""The port's seed serving engine (``serving/legacy_engine.py``) held
against the JAX package's, and against the port's arena engine.

Against JAX, on the reduced f32 llama of ``benchmarks/serve_engine.py``
(vocab 512, 2 layers) with converted weights: a ladder whose stages run
every branch of ``run_stage`` (prefill without a cache, extend of a
uniform cache, reuse of a cache longer than the fraction, and the
zero-token extend at an equal length), then the oracle.  Preds, $,
``batches`` and per-stage new/cached tokens and cost are EXACT; the
re-prefill of a bucket that mixes cached lengths is held call by call.
Against the arena engine (``CascadeEngine.run``) on the benchmark's
forced ladder: the same token counts, batches and $.  And the op
extension leaves every cached snapshot bitwise unchanged, for llama and
for recurrentgemma's recurrent and ring states.
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
from repro_torch.serving.engine import CascadeEngine, LMBackend  # noqa: E402
from repro_torch.serving.legacy_engine import (  # noqa: E402
    DictCacheLMBackend, SeedCascadeEngine)

OPS = {"o_orig": "does this opinion overturn a lower court decision",
       "sur_1": "is any lower court mentioned"}
RATES = {"proxy": 0.06, "oracle": 1.0}
THR = {0: 2.0, 1: 2.0}              # impossible: every doc walks every stage
# one bucket (128), two batches a stage at batch size 4
DOCS = {d.doc_id: d.text
        for d in generate_corpus(8, avg_lines=8, seed=0)}
# buckets 128 (nine docs) and 256 (one): four batches a stage
LADDER_DOCS = {d.doc_id: d.text
               for d in generate_corpus(10, avg_lines=8, seed=3)}
S_ALLOC = 512


def _branch_ladder(C=Cascade, T=Task, TC=TaskConfig):
    return C([
        T(TC("proxy", "sur_1", 0.25), THR),    # prefill, no cache
        T(TC("proxy", "o_orig", 0.5), THR),    # extend 0.25 -> 0.5
        T(TC("proxy", "sur_1", 0.25), THR),    # reuse: cache 0.5 > 0.25
        T(TC("proxy", "o_orig", 0.5), THR),    # extend of zero new tokens
    ])


def _forced_ladder():
    return Cascade([Task(TaskConfig("proxy", "sur_1", 0.25), THR),
                    Task(TaskConfig("proxy", "o_orig", 1.0), THR)])


def _rcfg(arch="llama3_2_1b", **kw):
    kw = {"num_layers": 2, **kw}
    return t_resolve(t_get_reduced(arch, dtype="float32", vocab_size=512,
                                   **kw), tp=1)


def _seed_backends(params, rcfg=None):
    tokz = HashWordTokenizer(vocab_size=512)
    return {n: DictCacheLMBackend(
        name=n, model=LM(rcfg or _rcfg(), device="cpu"), params=p,
        tokenizer=tokz, rate_per_token=RATES[n], s_alloc=S_ALLOC)
        for n, p in params.items()}


class _JittedLM:
    """The JAX ``LM``'s ``prefill``/``extend`` under ``jax.jit`` (eager
    dispatch of the same functions takes ~15 s a run on the CPU)."""

    def __init__(self, jax, m):
        self.prefill = jax.jit(m.prefill, static_argnames=("s_alloc",))
        self.extend = jax.jit(m.extend, static_argnames=("q_offset",))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX seed engine's results on ``_branch_ladder``, its mixed-
    length ``run_stage`` calls, and the weights both sides run."""
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.core.tasks import Cascade as JC, Task as JT, TaskConfig as JTC
    from repro.data.tokenizer import HashWordTokenizer as JTok
    from repro.models.model import LM as JLM
    from repro.models.runtime import CPU_TEST
    from repro.serving.legacy_engine import (
        DictCacheLMBackend as JBackend, SeedCascadeEngine as JEngine)
    from repro_torch.models.convert import from_jax_params
    rcfg = resolve(get_reduced("llama3_2_1b", dtype="float32",
                               vocab_size=512, num_layers=2), tp=1)
    tokz = JTok(vocab_size=512)
    jparams, backends = {}, {}
    for name, seed in (("proxy", 1), ("oracle", 2)):
        m = JLM(rcfg, CPU_TEST)
        jparams[name] = m.init(jax.random.PRNGKey(seed))
        backends[name] = JBackend(
            name=name, model=_JittedLM(jax, m), params=jparams[name],
            tokenizer=tokz,
            rate_per_token=RATES[name], s_alloc=S_ALLOC)
    eng = JEngine(backends, OPS, n_classes=2, batch_size=4)
    run = eng.run(_branch_ladder(JC, JT, JTC), DOCS)
    mixed = _mixed_calls(backends["proxy"], tokz)
    tparams = {n: from_jax_params(jax.tree.map(np.asarray, p), _rcfg(),
                                  "cpu")
               for n, p in jparams.items()}
    return run, mixed, tparams


def _mixed_calls(be, tokz):
    """``run_stage`` on buckets whose cached lengths differ: docs 0-1
    cached at 0.25, docs 2-3 at 0.5, doc 4 not at all; then buckets of
    all of them at 0.75 (a full re-prefill each)."""
    be.reset()
    toks = {d: np.asarray(tokz.encode(DOCS[d]), np.int32) for d in DOCS}
    op = np.asarray(tokz.encode(OPS["o_orig"]), np.int32)
    out = []
    for ids, frac in (([0, 1], 0.25), ([2, 3], 0.5), ([0, 1, 2, 3], 0.75),
                      ([0, 4], 0.75), ([0, 1, 2, 3], 0.75)):
        p, c, new_t, cached_t = be.run_stage(ids, toks, 128, frac, op, 2)
        out.append((np.asarray(p).tolist(), np.asarray(c), new_t, cached_t,
                    [be.cached_len(d) for d in ids]))
    return out


def test_seed_engine_matches_jax_exactly(jax_side):
    (jpred, jcost, jstats), _, tparams = jax_side
    eng = SeedCascadeEngine(_seed_backends(tparams), OPS, n_classes=2,
                            batch_size=4)
    pred, cost, stats = eng.run(_branch_ladder(), DOCS)
    assert pred == jpred
    assert cost == jcost                                   # exact $
    assert stats.batches == jstats.batches
    assert stats.stage_docs == jstats.stage_docs
    assert stats.stage_new_tokens == jstats.stage_new_tokens
    assert stats.stage_cached_tokens == jstats.stage_cached_tokens
    assert stats.stage_cost == jstats.stage_cost
    # the branches ran: stage 2 reuses (only op tokens are new), stage 3
    # extends by zero document tokens, both over cached prefixes
    n_op = {k: len(HashWordTokenizer(512).encode(v)) for k, v in OPS.items()}
    assert stats.stage_new_tokens[2] == len(DOCS) * n_op["sur_1"]
    assert stats.stage_new_tokens[3] == len(DOCS) * n_op["o_orig"]
    assert min(stats.stage_cached_tokens[1:4]) > 0
    assert stats.stage_cached_tokens[0] == 0


def test_mixed_cached_lengths_reprefill_matches_jax(jax_side):
    _, jmixed, tparams = jax_side
    be = _seed_backends(tparams)["proxy"]
    mixed = _mixed_calls(be, be.tokenizer)
    assert len(mixed) == len(jmixed)
    for (p, c, n, ca, lens), (jp, jc, jn, jca, jlens) in zip(mixed, jmixed):
        assert p == jp and n == jn and ca == jca and lens == jlens
        np.testing.assert_allclose(c, jc, atol=1e-5, rtol=0)
    # the third call mixes lengths 32 and 64: a full prefill, nothing
    # billed as cached
    assert mixed[2][3] == 0 and mixed[2][4] == [96] * 4


def test_seed_engine_matches_arena_engine_on_forced_ladder():
    m = LM(_rcfg(), device="cpu")
    params = {"proxy": m.init(seed=1), "oracle": m.init(seed=2)}
    seed = SeedCascadeEngine(_seed_backends(params), OPS, n_classes=2,
                             batch_size=4)
    pred, cost, stats = seed.run(_forced_ladder(), LADDER_DOCS)
    tokz = HashWordTokenizer(vocab_size=512)
    arena = CascadeEngine(
        {n: LMBackend(name=n, model=LM(_rcfg(), device="cpu"), params=p,
                      tokenizer=tokz, rate_per_token=RATES[n],
                      s_alloc=S_ALLOC, device="cpu")
         for n, p in params.items()},
        OPS, n_classes=2, batch_size=4, device="cpu")
    res = arena.run(_forced_ladder(), LADDER_DOCS)
    assert set(pred) == set(res.pred) == set(LADDER_DOCS)
    assert stats.total_new_tokens() == res.stats.total_new_tokens()
    assert stats.total_cached_tokens() == res.stats.total_cached_tokens()
    assert stats.stage_new_tokens == res.stats.stage_new_tokens
    assert stats.stage_cached_tokens == res.stats.stage_cached_tokens
    assert stats.batches == res.stats.batches
    # the same batch costs, summed per batch here and per document there
    assert cost == pytest.approx(res.cost, rel=1e-12, abs=0)
    assert stats.stage_cost == pytest.approx(res.stats.stage_cost,
                                             rel=1e-12, abs=0)


def _snapshot(be):
    return {d: [{n: t.clone() for n, t in layer.items()} for layer in e[2]]
            for d, e in be._cache.items()}


@pytest.mark.parametrize("arch,kw", [
    ("llama3_2_1b", {}),
    ("recurrentgemma_2b", dict(num_layers=3, sliding_window=16)),
])
def test_op_extension_leaves_cached_snapshot_bitwise(arch, kw):
    rcfg = _rcfg(arch, **kw)
    m = LM(rcfg, device="cpu")
    be = _seed_backends({"proxy": m.init(seed=4)}, rcfg)["proxy"]
    toks = {d: np.asarray(be.tokenizer.encode(DOCS[d]), np.int32)
            for d in DOCS}
    op = np.asarray(be.tokenizer.encode(OPS["o_orig"]), np.int32)
    ids = [0, 1, 2]
    be.run_stage(ids, toks, 256, 0.5, op, 2)           # prefill + op ext.
    snap = _snapshot(be)
    # the prefill branch's op extension wrote the batch at [128, 128 +
    # op), never the snapshots: their attention caches are zero there
    for d in ids:
        for layer in snap[d]:
            if "k" in layer and layer["k"].shape[0] > 128:
                assert not layer["k"][128:128 + len(op)].any()
    be.run_stage(ids, toks, 256, 0.25, op, 2)          # reuse + op ext.
    after = _snapshot(be)
    for d in ids:
        for old, new in zip(snap[d], after[d]):
            for n in old:
                assert torch.equal(old[n], new[n]), (arch, d, n)
