"""The port's copies of the cascade-construction algorithms held against
the JAX package on the same scores: the cost model (§2.1, §6),
Algorithm 2 thresholds and filtering, Algorithm 4 greedy assembly, the
selectivity-ordering baseline and the §3.1 MSSC reduction.  They are
numpy on both sides, so every result must be IDENTICAL (costs compared
with ``==``), and greedy MSSC stays within 4x of the brute-force optimum.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core import assembly as TA  # noqa: E402
from repro_torch.core import cost_model as TCM  # noqa: E402
from repro_torch.core import tasks as TT  # noqa: E402
from repro_torch.core import thresholds as TH  # noqa: E402

N_DOCS = 120
OPS = ("o_orig", "sur_1", "sur_2")
FRACS = (0.25, 0.5, 1.0)


@pytest.fixture(scope="module")
def J():
    """The JAX package's core modules (imported lazily)."""
    pytest.importorskip("jax")
    from repro.core import assembly, cost_model, tasks, thresholds
    return dict(assembly=assembly, cost_model=cost_model, tasks=tasks,
                thresholds=thresholds)


def _scores(tasks_mod, seed):
    """Seeded candidate scores: better-calibrated at larger fractions."""
    rng = np.random.default_rng(seed)
    oracle = rng.integers(0, 2, N_DOCS)
    scores = {}
    for op in OPS:
        for f in FRACS:
            cfg = tasks_mod.TaskConfig("proxy", op, f)
            conf = 0.5 + 0.5 * rng.random(N_DOCS)
            right = rng.random(N_DOCS) < conf * (0.6 + 0.4 * f)
            pred = np.where(right, oracle, 1 - oracle)
            scores[cfg] = tasks_mod.TaskScores(cfg, pred, conf)
    return oracle, scores


def _cost_model(cm_mod, seed):
    rng = np.random.default_rng(seed + 100)
    return cm_mod.CascadeCostModel(
        rng.integers(100, 2000, N_DOCS),
        {"o_orig": 9, "sur_1": 7, "sur_2": 6},
        rates={"proxy": 0.15e-6, "oracle": 2.50e-6})


def _task_key(t):
    return (t.config.key(), t.thresholds)


def test_cost_model_identical(J):
    tcm, jcm = _cost_model(TCM, 0), _cost_model(J["cost_model"], 0)
    assert tcm.oracle_only_cost() == jcm.oracle_only_cost()
    cached = np.random.default_rng(1).integers(0, 800, N_DOCS)
    for f in FRACS:
        tc, tn = tcm.task_cost(TT.TaskConfig("proxy", "sur_1", f), cached)
        jc, jn = jcm.task_cost(J["tasks"].TaskConfig("proxy", "sur_1", f),
                               cached)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tn, jn)
    exit_stage = np.random.default_rng(2).integers(0, 4, N_DOCS)
    tcfg = [TT.TaskConfig("proxy", o, f) for o, f in
            (("sur_1", 0.25), ("sur_2", 0.5), ("o_orig", 1.0))]
    jcfg = [J["tasks"].TaskConfig(*c.key()) for c in tcfg]
    np.testing.assert_array_equal(tcm.cascade_cost(tcfg, exit_stage),
                                  jcm.cascade_cost(jcfg, exit_stage))
    kw = dict(n_dev=200, avg_doc_tokens=900.0, prompt_tokens=40.0,
              fractions=FRACS)
    for lite in (False, True):
        to = TCM.OptimizationCost(lite=lite, **kw)
        jo = J["cost_model"].OptimizationCost(lite=lite, **kw)
        assert (to.total(), to.model_cascade_cost()) == \
            (jo.total(), jo.model_cascade_cost())
    assert TCM.break_even_docs(3.0, 0.1, 0.4) == \
        J["cost_model"].break_even_docs(3.0, 0.1, 0.4)


@pytest.mark.parametrize("alpha", [0.6, 0.75, 0.9])
def test_thresholds_identical(J, alpha):
    rng = np.random.default_rng(int(alpha * 100))
    for _ in range(20):
        n = int(rng.integers(5, 200))
        conf = np.round(rng.random(n), 2)          # ties in the scan
        correct = rng.random(n) < conf
        assert TH.select_class_threshold(conf, correct, alpha) == \
            J["thresholds"].select_class_threshold(conf, correct, alpha)
    oracle, tscores = _scores(TT, 3)
    _, jscores = _scores(J["tasks"], 3)
    for g in (0.0, 0.1, 0.5):
        t = TH.filter_tasks(list(tscores.values()), oracle, 2, alpha, g)
        j = J["thresholds"].filter_tasks(list(jscores.values()), oracle, 2,
                                         alpha, g)
        assert [_task_key(x) for x in t] == [_task_key(x) for x in j]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_assembly_identical(J, seed):
    oracle, tscores = _scores(TT, seed)
    _, jscores = _scores(J["tasks"], seed)
    tcm, jcm = _cost_model(TCM, seed), _cost_model(J["cost_model"], seed)
    alpha = 0.7
    tel = TH.filter_tasks(list(tscores.values()), oracle, 2, alpha, 0.05)
    jel = J["thresholds"].filter_tasks(list(jscores.values()), oracle, 2,
                                       alpha, 0.05)
    tc, ttrace = TA.greedy_assembly(tel, tscores, oracle, tcm, 2, alpha)
    jc, jtrace = J["assembly"].greedy_assembly(jel, jscores, oracle, jcm, 2,
                                               alpha)
    assert [_task_key(t) for t in tc.tasks] == \
        [_task_key(t) for t in jc.tasks]
    assert ttrace.steps == jtrace.steps
    assert ttrace.considered == jtrace.considered
    tres = TT.run_cascade(tc, tscores, oracle, tcm, 2)
    jres = J["tasks"].run_cascade(jc, jscores, oracle, jcm, 2)
    assert tres.total_cost() == jres.total_cost()
    assert tres.total_cost() <= tcm.oracle_only_cost()
    ts = TA.selectivity_ordering(tel, tscores, oracle, tcm, 2, alpha)
    js = J["assembly"].selectivity_ordering(jel, jscores, oracle, jcm, 2,
                                            alpha)
    assert [_task_key(t) for t in ts.tasks] == \
        [_task_key(t) for t in js.tasks]


def test_mssc_reduction_identical(J):
    universe = list(range(6))
    sets = [{0, 1, 2}, {2, 3}, {3, 4, 5}, {0, 5}]
    t_tasks, t_scores, t_oracle, t_cm = TA.mssc_instance_to_scores(
        universe, sets)
    j_tasks, j_scores, j_oracle, j_cm = \
        J["assembly"].mssc_instance_to_scores(universe, sets)
    np.testing.assert_array_equal(t_oracle, j_oracle)
    for tt, jt in zip(t_tasks, j_tasks):
        np.testing.assert_array_equal(t_scores[tt.config].pred,
                                      j_scores[jt.config].pred)
    order = [0, 2, 1, 3]
    tres = TT.run_cascade(TT.Cascade([t_tasks[i] for i in order]), t_scores,
                          t_oracle, t_cm, 2)
    jres = J["tasks"].run_cascade(
        J["tasks"].Cascade([j_tasks[i] for i in order]), j_scores, j_oracle,
        j_cm, 2)
    # sets 0 then 2 cover everything: 3 items at position 1, 3 at 2
    assert tres.total_cost() == jres.total_cost() == 9.0


def test_greedy_mssc_identical_and_within_4x_of_brute_force(J):
    rng = np.random.default_rng(3)
    for _ in range(10):
        universe = set(range(8))
        sets = [set(rng.choice(8, size=rng.integers(1, 5), replace=False))
                for _ in range(5)]
        if set().union(*sets) != universe:
            sets.append(universe - set().union(*sets) or {0})
        t_order, t_cost = TA.greedy_mssc(universe, sets)
        assert (t_order, t_cost) == J["assembly"].greedy_mssc(universe, sets)
        opt = TA.brute_force_mssc(universe, sets)
        assert opt == J["assembly"].brute_force_mssc(universe, sets)
        assert 0 < opt <= t_cost <= 4 * opt
