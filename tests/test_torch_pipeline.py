"""The port's copies of the rest of ``core/`` held against the JAX package:
the WSR certificate (§A.2, ``estimator``), Algorithms 3 and 5
(``adjust``), the calibrated workloads (``simulation``), Algorithm 6's
synthetic agent (``surrogate``), and Algorithm 1 with its guarantee pass
and the baselines (``pipeline``).  They are numpy on both sides, so every
result must be IDENTICAL (floats compared with ``==``), as in
``tests/test_torch_core.py``.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core import adjust as TA  # noqa: E402
from repro_torch.core import estimator as TE  # noqa: E402
from repro_torch.core import pipeline as TP  # noqa: E402
from repro_torch.core import simulation as TS  # noqa: E402
from repro_torch.core import surrogate as TSU  # noqa: E402
from repro_torch.core import tasks as TT  # noqa: E402

N_DOCS = 300          # per workload; dev/test split 150 / 150
WORKLOAD = "court"


@pytest.fixture(scope="module")
def J():
    """The JAX package's core modules (imported lazily)."""
    pytest.importorskip("jax")
    from repro.core import (adjust, estimator, pipeline, simulation,
                            surrogate, tasks)
    return dict(adjust=adjust, estimator=estimator, pipeline=pipeline,
                simulation=simulation, surrogate=surrogate, tasks=tasks)


def _split(sim_mod, name=WORKLOAD, n=N_DOCS):
    w = sim_mod.make_workload(name, n)
    perm = np.random.default_rng(0).permutation(n)
    return w.subset(perm[: n // 2]), w.subset(perm[n // 2:])


@pytest.fixture(scope="module")
def splits(J):
    """(dev, test) of the same workload in each package."""
    return {"torch": _split(TS), "jax": _split(J["simulation"])}


def _bernoulli(seed):
    rng = np.random.default_rng(seed)
    return [(rng.random(n) < p).astype(np.float64)
            for n, p in ((0, 0.9), (1, 1.0), (40, 0.97), (120, 0.92),
                         (300, 0.88), (500, 0.95))]


def _task_key(t):
    return (t.config.key(), t.thresholds)


def _cascade_key(c):
    return [_task_key(t) for t in c.tasks]


def _scores_equal(a, b):
    assert {c.key() for c in a} == {c.key() for c in b}
    bk = {c.key(): s for c, s in b.items()}
    for c, s in a.items():
        np.testing.assert_array_equal(s.pred, bk[c.key()].pred)
        np.testing.assert_array_equal(s.conf, bk[c.key()].conf)


def _output_equal(t, j):
    assert _cascade_key(t.cascade) == _cascade_key(j.cascade)
    assert [c.key() for c in t.candidate_configs] == \
        [c.key() for c in j.candidate_configs]
    assert t.reverted_to_oracle == j.reverted_to_oracle
    assert t.rounds_run == j.rounds_run
    _scores_equal(t.scores, j.scores)
    assert (t.adjust is None) == (j.adjust is None)
    if t.adjust is not None:
        assert (t.adjust.shift, t.adjust.certified, t.adjust.history) == \
            (j.adjust.shift, j.adjust.certified, j.adjust.history)
        assert (t.adjust.cascade is None) == (j.adjust.cascade is None)


# ---------------------------------------------------------------- estimator

@pytest.mark.parametrize("lam_rule", ["paper", "kelly"])
def test_wsr_wealth_and_certify_identical(J, lam_rule):
    je = J["estimator"]
    for x in _bernoulli(1):
        for target, delta in ((0.9, 0.25), (0.85, 0.1), (0.95, 0.05)):
            np.testing.assert_array_equal(
                TE.wsr_wealth(x, target, delta, lam_rule),
                je.wsr_wealth(x, target, delta, lam_rule))
            assert TE.wsr_certify(x, target, delta, lam_rule) == \
                je.wsr_certify(x, target, delta, lam_rule)


def test_hoeffding_and_lower_bound_identical(J):
    je = J["estimator"]
    for x in _bernoulli(2):
        for target, delta in ((0.9, 0.25), (0.8, 0.05)):
            assert TE.hoeffding_certify(x, target, delta) == \
                je.hoeffding_certify(x, target, delta)
        assert TE.wsr_lower_bound(x, 0.25, grid=60) == \
            je.wsr_lower_bound(x, 0.25, grid=60)


# ------------------------------------------------------------------- adjust

def _adjust_inputs(tasks_mod, sim_mod):
    """A two-task cascade with train and validation scores from the
    simulator (its thresholds mid-range, so every shift list is long)."""
    dev, test = _split(sim_mod)
    cfgs = [tasks_mod.TaskConfig("proxy", "o_orig", 0.25),
            tasks_mod.TaskConfig("proxy", "o_orig", 1.0)]
    cascade = tasks_mod.Cascade([
        tasks_mod.Task(cfgs[0], {0: 0.6, 1: 0.62}),
        tasks_mod.Task(cfgs[1], {0: 0.55, 1: 0.58})])
    train = {c: dev.eval_config(c) for c in cfgs}
    val = {c: test.eval_config(c) for c in cfgs}
    return cascade, train, val, test


def test_shift_lists_identical(J):
    tc, ttr, _, _ = _adjust_inputs(TT, TS)
    jc, jtr, _, _ = _adjust_inputs(J["tasks"], J["simulation"])
    for s_max in (1, 3, 5):
        tl = TA.build_shift_lists(tc, ttr, 2, s_max)
        jl = J["adjust"].build_shift_lists(jc, jtr, 2, s_max)
        assert tl == jl
        for s in range(s_max + 2):
            assert TA.thresholds_at_shift(tl, s) == \
                J["adjust"].thresholds_at_shift(jl, s)


@pytest.mark.parametrize("alpha,delta", [(0.9, 0.25), (0.95, 0.1),
                                         (0.999, 0.05)])
def test_adjust_thresholds_identical(J, alpha, delta):
    tc, ttr, tval, ttest = _adjust_inputs(TT, TS)
    jc, jtr, jval, jtest = _adjust_inputs(J["tasks"], J["simulation"])
    t = TA.adjust_thresholds(tc, ttr, tval, ttest.oracle_pred,
                             ttest.cost_model(), 2, alpha, delta,
                             rng=np.random.default_rng(5))
    j = J["adjust"].adjust_thresholds(jc, jtr, jval, jtest.oracle_pred,
                                      jtest.cost_model(), 2, alpha, delta,
                                      rng=np.random.default_rng(5))
    assert (t.shift, t.certified, t.history) == \
        (j.shift, j.certified, j.history)
    assert (t.cascade is None) == (j.cascade is None)
    if t.cascade is not None:
        assert _cascade_key(t.cascade) == _cascade_key(j.cascade)


# --------------------------------------------------------------- simulation

@pytest.mark.parametrize("name", sorted(TS.WORKLOADS))
def test_make_workload_identical(J, name):
    js = J["simulation"]
    assert dataclasses.asdict(TS.WORKLOADS[name]) == \
        dataclasses.asdict(js.WORKLOADS[name])
    t, j = TS.make_workload(name, 200), js.make_workload(name, 200)
    np.testing.assert_array_equal(t.oracle_pred, j.oracle_pred)
    assert t.n_classes == j.n_classes
    for f in TS.FRACTIONS:
        np.testing.assert_array_equal(t.coverage(f), j.coverage(f))
        for m in (TS.PROXY, TS.ORACLE):
            ts = t.eval_config(TT.TaskConfig(m, TS.O_ORIG, f))
            jsc = j.eval_config(J["tasks"].TaskConfig(m, js.O_ORIG, f))
            np.testing.assert_array_equal(ts.pred, jsc.pred)
            np.testing.assert_array_equal(ts.conf, jsc.conf)
    tcm, jcm = t.cost_model(), j.cost_model()
    assert tcm.oracle_only_cost() == jcm.oracle_only_cost()
    # a registered surrogate, on a subset
    spec = dict(op_id="sur_x", kind="keyword", target_classes=(0,),
                coverage=0.5, strength=0.8, false_fire=0.05, family=3)
    sub = np.arange(0, 200, 3)
    ts_, js_ = t.subset(sub), j.subset(sub)
    ts_.register_surrogate(TS.SurrogateSpec(**spec))
    js_.register_surrogate(js.SurrogateSpec(**spec))
    for f in (0.1, 1.0):
        a = ts_.eval_config(TT.TaskConfig(TS.PROXY, "sur_x", f))
        b = js_.eval_config(J["tasks"].TaskConfig(js.PROXY, "sur_x", f))
        np.testing.assert_array_equal(a.pred, b.pred)
        np.testing.assert_array_equal(a.conf, b.conf)
    assert ts_.cost_model().oracle_only_cost() == \
        js_.cost_model().oracle_only_cost()


# ---------------------------------------------------------------- surrogate

def test_synthetic_agent_propose_identical(J):
    ju = J["surrogate"]
    ta = TSU.SyntheticAgent(pattern_coverage=0.6, seed=4)
    ja = ju.SyntheticAgent(pattern_coverage=0.6, seed=4)
    labels = np.random.default_rng(3).integers(0, 4, 37)
    stats = [{"config": None, "selected": True, "family": 2},
             {"config": None, "selected": False, "family": 5},
             {"config": None, "selected": False}]
    for r in range(4):
        kw = dict(round=r, failure_labels=labels if r % 2 else labels[:0],
                  task_stats=stats, previous_ops=[], n_classes=4)
        t = ta.propose(TSU.AgentContext(**kw), 5)
        j = ja.propose(ju.AgentContext(**kw), 5)
        assert [dataclasses.asdict(s) for s in t] == \
            [dataclasses.asdict(s) for s in j]


# ----------------------------------------------------------------- pipeline

BUILDS = {
    "default": {},
    "guarantee": dict(guarantee=True),
    "lite": dict(lite=True),
    "no_surrogates": dict(use_surrogates=False),
    "single_iteration": dict(single_iteration=True),
    "selectivity": dict(ordering="selectivity"),
}


@pytest.mark.parametrize("build", list(BUILDS))
def test_build_task_cascade_identical(J, build):
    jp = J["pipeline"]
    dev_t, test_t = _split(TS)
    dev_j, test_j = _split(J["simulation"])
    kw = dict(alpha=0.9, seed=0, **BUILDS[build])
    t = TP.build_task_cascade(dev_t, TP.BuildConfig(**kw))
    j = jp.build_task_cascade(dev_j, jp.BuildConfig(**kw))
    _output_equal(t, j)
    if build == "guarantee":
        assert t.adjust is not None
    assert TP.evaluate_on(test_t, t) == jp.evaluate_on(test_j, j)


@pytest.mark.parametrize("guarantee", [False, True])
def test_model_cascade_identical(J, splits, guarantee):
    jp = J["pipeline"]
    (dev_t, test_t), (dev_j, test_j) = splits["torch"], splits["jax"]
    for alpha in (0.85, 0.9, 0.95):
        t = TP.model_cascade(dev_t, alpha, guarantee=guarantee, seed=2)
        j = jp.model_cascade(dev_j, alpha, guarantee=guarantee, seed=2)
        _output_equal(t, j)
        assert TP.evaluate_on(test_t, t) == jp.evaluate_on(test_j, j)


def test_restructure_top25_identical(J, splits):
    jp = J["pipeline"]
    (dev_t, test_t), (dev_j, test_j) = splits["torch"], splits["jax"]
    for alpha in (0.8, 0.9):
        t = TP.restructure_top25(dev_t, alpha)
        j = jp.restructure_top25(dev_j, alpha)
        _output_equal(t, j)
        et, ej = TP.evaluate_on(test_t, t), jp.evaluate_on(test_j, j)
        assert et == ej and set(et) == {
            "accuracy", "total_cost", "cost_per_doc", "oracle_cost",
            "oracle_frac", "n_tasks"}
