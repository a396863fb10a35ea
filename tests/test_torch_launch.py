"""The construct-and-serve slice (paper Figure 2, steps 1-5 of
``examples/serve_cascade.py``) run by both packages on one corpus.

Reduced models (2 layers, vocab 512, f32, CPU): a llama3.2-1b proxy and a
qwen3-1.7b oracle (per-head q/k norm), with the JAX package's weights from
seeds 1 and 2 converted by ``from_jax_params``.  Both packages restructure
``generate_corpus(28, avg_lines=16, seed=11)`` (dev split 12), score the
six proxy candidates through the serving engine, filter and assemble at
alpha 0.85, and serve the 16 test documents under the assembled cascade
and its strict variant, then the oracle alone.

Held to the JAX package: reordered texts equal; candidate preds equal and
confs within 1e-5 (f32 logits through a two-class softmax); eligible and
assembled task keys equal; served preds, statuses, exit stages and
per-document $ EXACTLY equal (billing is token-denominated).  Also here:
the port's ``launch.serve`` entry point on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.core.tasks import Cascade, Task, TaskConfig  # noqa: E402
from repro_torch.data.documents import generate_corpus  # noqa: E402
from repro_torch.data.tokenizer import HashWordTokenizer  # noqa: E402
from repro_torch.launch import construct, serve  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.engine import CascadeEngine, LMBackend  # noqa: E402
from repro_torch.serving.scheduler import RESOLVED  # noqa: E402

N_DOCS, N_DEV, BATCH = 28, 12, 4
ARCHS = {"proxy": ("llama3_2_1b", 1), "oracle": ("qwen3_1_7b", 2)}
CONF_TOL = 1e-5


def _corpus(gen):
    return gen(N_DOCS, n_classes=2, avg_lines=16, seed=11)


def _summary(served, oracle_only):
    """What a user is billed and told, per query."""
    out = {}
    for name, r in (("main", served[0]), ("strict", served[1]),
                    ("oracle", oracle_only)):
        out[name] = dict(pred=r.pred, status=r.status, doc_cost=r.doc_cost,
                         exit_stage=r.exit_stage, cost=r.cost)
    return out


@pytest.fixture(scope="module")
def jax_run():
    """Steps 1-5 of ``examples/serve_cascade.py`` in the JAX package."""
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.core.assembly import greedy_assembly
    from repro.core.cost_model import CascadeCostModel
    from repro.core.restructure import DocumentRestructurer, SyntheticOracle
    from repro.core.tasks import Cascade as JCascade
    from repro.core.tasks import TaskConfig as JTaskConfig
    from repro.core.tasks import TaskScores
    from repro.core.thresholds import filter_tasks
    from repro.data.documents import generate_corpus as jgen
    from repro.data.tokenizer import HashWordTokenizer as JTok
    from repro.launch.serve import poisson_arrivals
    from repro.models.model import LM as JLM
    from repro.models.runtime import CPU_TEST
    from repro.serving.engine import (CascadeEngine as JEngine,
                                      CascadeServer as JServer,
                                      LMBackend as JBackend)
    from repro.serving.scheduler import make_buckets

    docs = _corpus(jgen)
    restr = DocumentRestructurer(construct.OPS["o_orig"]).fit(
        docs[:N_DEV], SyntheticOracle(noise=0.1))
    reordered = {d.doc_id: restr.reorder(d).text for d in docs}
    dev_ids = [d.doc_id for d in docs[:N_DEV]]
    test_ids = [d.doc_id for d in docs[N_DEV:]]

    tokz = JTok(vocab_size=512)
    params, backends = {}, {}
    for name, (arch, seed) in ARCHS.items():
        m = JLM(resolve(get_reduced(arch, dtype="float32", vocab_size=512,
                                    num_layers=2), tp=1), CPU_TEST)
        params[name] = m.init(jax.random.PRNGKey(seed))
        backends[name] = JBackend(
            name=name, model=m, params=params[name], tokenizer=tokz,
            rate_per_token=construct.RATES[name], s_alloc=1024)
    engine = JEngine(backends, construct.OPS, n_classes=2,
                     batch_size=BATCH)

    dev_docs = {i: reordered[i] for i in dev_ids}
    oracle_ref = engine.run(JCascade([]), dev_docs)
    oracle_pred = np.asarray([oracle_ref.pred[i] for i in dev_ids])
    scores = {}
    pos = {i: k for k, i in enumerate(dev_ids)}
    for o in construct.OPS:
        for f in construct.FRACTIONS:
            cfg = JTaskConfig("proxy", o, f)
            be = engine.backends["proxy"]
            be.reset()
            toks = {i: np.asarray(tokz.encode(dev_docs[i]), np.int32)
                    for i in dev_ids}
            lens = {i: len(toks[i]) for i in dev_ids}
            pred = np.zeros(len(dev_ids), np.int64)
            conf = np.zeros(len(dev_ids))
            for blen, ids in make_buckets(dev_ids, lens, BATCH):
                p, c, *_ = be.run_stage(
                    ids, toks, blen, f,
                    np.asarray(tokz.encode(construct.OPS[o]), np.int32), 2)
                for j, d in enumerate(ids):
                    pred[pos[d]], conf[pos[d]] = p[j], c[j]
            scores[cfg] = TaskScores(cfg, pred, conf)
    cm = CascadeCostModel(
        np.asarray([len(tokz.encode(reordered[i])) for i in dev_ids]),
        {o: len(tokz.encode(t)) for o, t in construct.OPS.items()},
        rates=dict(construct.RATES))
    eligible = filter_tasks(list(scores.values()), oracle_pred, 2,
                            alpha=0.85, g=0.10)
    cascade, _ = greedy_assembly(eligible, scores, oracle_pred, cm, 2,
                                 alpha=0.85)

    test_docs = {i: reordered[i] for i in test_ids}
    strict = cascade.with_thresholds([
        {c: min(v + 0.10, 1.0) for c, v in t.thresholds.items()}
        for t in cascade.tasks])
    engine.reset()
    h_main = engine.register(cascade, accuracy_target=0.85)
    h_strict = engine.register(strict, accuracy_target=0.95)
    arrivals = poisson_arrivals(sorted(test_docs), rate=8.0, seed=3)
    for d in sorted(test_docs):
        h_main.submit(d, test_docs[d], arrival=arrivals[d])
        h_strict.submit(d, test_docs[d], arrival=arrivals[d])
    while engine.pending():
        JServer.step(engine)
    served = (h_main.result(), h_strict.result())
    oracle_only = engine.run(JCascade([]), test_docs)
    return dict(
        params={n: jax.tree.map(np.asarray, p) for n, p in params.items()},
        reordered=reordered, granularity=restr.granularity, f1=restr.f1,
        oracle_pred=oracle_pred,
        scores={c.key(): (s.pred, s.conf) for c, s in scores.items()},
        eligible=[t.config.key() for t in eligible],
        assembled=[t.config.key() for t in cascade.tasks],
        thresholds=[t.thresholds for t in cascade.tasks],
        summary=_summary(served, oracle_only))


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The same steps through ``repro_torch.launch.construct`` on the CPU,
    with the JAX weights."""
    from repro_torch.models.convert import from_jax_params
    docs = _corpus(generate_corpus)
    restr, reordered = construct.restructure(docs, N_DEV, device="cpu")
    dev_ids = [d.doc_id for d in docs[:N_DEV]]
    test_ids = [d.doc_id for d in docs[N_DEV:]]
    tokz = HashWordTokenizer(vocab_size=512)
    backends = {}
    for name, (arch, _) in ARCHS.items():
        m = LM(t_resolve(t_get_reduced(arch, dtype="float32", vocab_size=512,
                                       num_layers=2), tp=1), device="cpu")
        backends[name] = LMBackend(
            name=name, model=m, tokenizer=tokz,
            params=from_jax_params(jax_run["params"][name], m.rcfg, "cpu"),
            rate_per_token=construct.RATES[name], s_alloc=1024,
            device="cpu")
    engine = CascadeEngine(backends, construct.OPS, n_classes=2,
                           batch_size=BATCH, device="cpu")
    dev_docs = {i: reordered[i] for i in dev_ids}
    oracle_ref = engine.run(Cascade([]), dev_docs)
    oracle_pred = np.asarray([oracle_ref.pred[i] for i in dev_ids])
    scores = construct.score_candidates(
        engine, dev_docs, construct.candidate_configs(), BATCH)
    cm = construct.doc_cost_model(tokz, list(dev_docs.values()))
    eligible, cascade, _ = construct.assemble(scores, oracle_pred, cm)
    test_docs = {i: reordered[i] for i in test_ids}
    serve.warm_arena(engine, cascade, test_docs, BATCH)
    served = construct.serve_two_queries(engine, cascade, test_docs)
    oracle_only = engine.run(Cascade([]), test_docs)
    return dict(
        reordered=reordered, granularity=restr.granularity, f1=restr.f1,
        oracle_pred=oracle_pred,
        scores={c.key(): (s.pred, s.conf) for c, s in scores.items()},
        eligible=[t.config.key() for t in eligible],
        assembled=[t.config.key() for t in cascade.tasks],
        thresholds=[t.thresholds for t in cascade.tasks],
        summary=_summary((served.main, served.strict), oracle_only),
        launches=served.launches)


def test_restructured_texts_equal(jax_run, port_run):
    assert port_run["granularity"] == jax_run["granularity"]
    assert port_run["f1"] == jax_run["f1"]
    assert port_run["reordered"] == jax_run["reordered"]


def test_candidate_scores_match(jax_run, port_run):
    np.testing.assert_array_equal(port_run["oracle_pred"],
                                  jax_run["oracle_pred"])
    assert port_run["scores"].keys() == jax_run["scores"].keys()
    for key, (jp, jc) in jax_run["scores"].items():
        tp, tc = port_run["scores"][key]
        np.testing.assert_array_equal(tp, jp, err_msg=str(key))
        np.testing.assert_allclose(tc, jc, atol=CONF_TOL, rtol=0,
                                   err_msg=str(key))


def test_eligible_and_assembled_tasks_equal(jax_run, port_run):
    assert port_run["eligible"] == jax_run["eligible"]
    assert port_run["assembled"] == jax_run["assembled"]
    for tt, jt in zip(port_run["thresholds"], jax_run["thresholds"]):
        assert tt.keys() == jt.keys()
        for c in jt:
            assert abs(tt[c] - jt[c]) <= CONF_TOL


@pytest.mark.parametrize("query", ["main", "strict", "oracle"])
def test_served_results_exact(jax_run, port_run, query):
    js, ts = jax_run["summary"][query], port_run["summary"][query]
    assert set(ts["status"].values()) == {RESOLVED}
    assert ts["status"] == js["status"]
    assert ts["pred"] == js["pred"]
    assert ts["exit_stage"] == js["exit_stage"]
    assert ts["doc_cost"] == js["doc_cost"]            # exact $


def test_serve_entry_point_on_cpu(capsys):
    serve.main(["--docs", "4", "--rate", "50", "--batch", "4",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "streamed 8 docs (2 tenants x 4) on cpu" in out
    assert "query 1: p50" in out


def test_warm_arena_rejects_a_wider_batch():
    eng = serve.build_engine(2, None, 64, device="cpu")
    cascade = Cascade([Task(TaskConfig("proxy", "sur_court", 0.25),
                            {0: 0.6, 1: 0.6})])
    with pytest.raises(ValueError):
        serve.warm_arena(eng, cascade, {0: "a b c"}, 4)
    serve.warm_arena(eng, cascade, {0: "a b c", 1: "d e"}, 2)
    assert eng.stats().batches >= 2          # both stages ran


def test_build_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        serve.build_engine(2, None, 64)
