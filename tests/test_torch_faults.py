"""The port's fault-tolerant serving plane held against the JAX package's
(the cases of ``tests/test_faults.py``), and commit-on-success of its
stage steps.

Commit on success: the port's stage steps update the arena in place, so a
step that raises must leave every row as it was.  A decode-only launch
whose op-suffix window lies below ``cached_len`` (the 50-word document of
``tests/test_torch_serving.py``) raises inside the op-suffix loop, and on
the prefix plane inside the readout; every arena row must be bitwise
equal to the rows before the launch, and a drain whose decode-only launch
fails once must answer, bill and leave its rows bitwise as a clean drain.

Against JAX: a seeded chaos drain (launch failures, NaN confidences,
latency spikes, one arena loss; two tenants; one expired deadline) and a
warm restart from the journal after four steps run in both packages on
the same weights.  Fault counts, statuses, retries, quarantines,
timeouts, failures, breaker trips, ``recovered_docs`` and per-document $
must be EXACT, and so must the ledger replay (per query and per
document).  The injector draws its schedule from one seeded RNG, and the
cascades carry impossible thresholds, so both packages make the same
launches in the same order.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.core.tasks import Cascade, Task, TaskConfig  # noqa: E402
from repro_torch.data.documents import generate_corpus  # noqa: E402
from repro_torch.data.tokenizer import HashWordTokenizer  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.engine import (CascadeServer,  # noqa: E402
                                        LMBackend, RequestJournal,
                                        ServerStalledError)
from repro_torch.serving.faults import (FaultInjector,  # noqa: E402
                                        FaultPlan)
from repro_torch.serving.scheduler import (FAILED, RESOLVED,  # noqa: E402
                                           TERMINAL_STATES, TIMED_OUT,
                                           RetryPolicy)

OPS = {"o_orig": "does this overturn a lower court decision",
       "sur_1": "is a lower court mentioned"}
THR = {0: 0.7, 1: 0.7}
IMPOSSIBLE = {0: 2.0, 1: 2.0}


# the cascades of tests/test_faults.py, as factories so the JAX side can
# build them from its own classes
def _cascade(C=Cascade, T=Task, TC=TaskConfig):
    return C([T(TC("proxy", "sur_1", 0.25), THR),
              T(TC("proxy", "o_orig", 1.0), THR)])


def _ladder(C=Cascade, T=Task, TC=TaskConfig):
    return C([T(TC("proxy", "o_orig", 0.25), IMPOSSIBLE),
              T(TC("proxy", "o_orig", 1.0), IMPOSSIBLE)])


def _tenant_cascades(C=Cascade, T=Task, TC=TaskConfig):
    """Two tenants with overlapping signatures (the chaos section of
    ``benchmarks/serve_engine.py``); impossible thresholds fix routing."""
    return [C([T(TC("proxy", "sur_1", 0.25), IMPOSSIBLE),
               T(TC("proxy", "o_orig", 1.0), IMPOSSIBLE)]),
            C([T(TC("proxy", "sur_1", 0.25), IMPOSSIBLE),
               T(TC("proxy", "sur_1", 1.0), IMPOSSIBLE)])]


CHAOS_PLAN = dict(launch_failure_p=0.25, nan_p=0.15, latency_spike_p=0.1,
                  spike_s=1e-4, arena_loss_at=4)
CHAOS_SEED = 23
# word counts straddle two buckets; 50 makes the true fraction undershoot
# the padded one, so a decode-only op suffix writes over live document KV
_PAGED_DOCS = {i: " ".join(f"w{i}x{j}" for j in range(n))
               for i, n in enumerate([20, 40, 28, 50, 12])}


def _rcfg():
    return t_resolve(t_get_reduced("llama3_2_1b", dtype="float32",
                                   vocab_size=512, num_layers=2), tp=1)


def _mk_backend(name, p, tokz, **kw):
    return LMBackend(name=name, model=LM(_rcfg(), device="cpu"), params=p,
                     tokenizer=tokz,
                     rate_per_token=1.0 if name == "oracle" else 0.06,
                     s_alloc=512, device="cpu", **kw)


@pytest.fixture(scope="module")
def params():
    m = LM(_rcfg(), device="cpu")
    return {"proxy": m.init(seed=1), "oracle": m.init(seed=2)}


@pytest.fixture(scope="module")
def tokz():
    return HashWordTokenizer(vocab_size=512)


@pytest.fixture(scope="module")
def backends(params, tokz):
    return {n: _mk_backend(n, params[n], tokz) for n in ("proxy", "oracle")}


@pytest.fixture(scope="module")
def docs():
    return {d.doc_id: d.text
            for d in generate_corpus(8, avg_lines=10, seed=7)}


def mk_server(backends, **kw):
    for be in backends.values():
        be.reset()
    kw.setdefault("retry", RetryPolicy(max_retries=2, backoff_base=0.0))
    return CascadeServer(dict(backends), OPS, n_classes=2, batch_size=4,
                         device="cpu", **kw)


def _ledger_exact(srv) -> bool:
    """Replaying the billing ledger (same float additions, same order)
    reproduces per-query AND per-document $ EXACTLY."""
    per_q = {qid: 0.0 for qid in srv._handles}
    per_doc = {}
    for _, qid, rid, cost in srv.ledger():
        per_q[qid] += cost
        per_doc[rid] = per_doc.get(rid, 0.0) + cost
    if any(total != srv.cost(qid) for qid, total in per_q.items()):
        return False
    return all(per_doc.get(rid, 0.0) == req.cost
               for rid, req in srv._requests.items())


# --------------------------------------------------------- commit on success

def _arena_bytes(be):
    return {b: [t.clone() for layer in ar.states for t in layer.values()]
            for b, ar in be._arenas.items()}


def _assert_same_rows(a, b):
    assert a.keys() == b.keys()
    for bucket in a:
        for x, y in zip(a[bucket], b[bucket]):
            assert torch.equal(x, y), bucket


def _raise_after(model, n_calls):
    """Make ``model.decode_step`` run for real and then raise on its
    ``n_calls``-th call (its KV write has landed when it raises)."""
    orig = model.decode_step
    calls = [0]

    def decode_step(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls[0] += 1
        if calls[0] == n_calls:
            raise RuntimeError("device fault inside the stage step")
        return out

    model.decode_step = decode_step
    return lambda: model.__dict__.pop("decode_step")


@pytest.mark.parametrize("plane", ["paged", "prefix"])
def test_failed_step_leaves_arena_rows_bitwise(params, tokz, plane):
    """A decode-only launch whose undo window lies below ``cached_len``
    raises after its first decode step wrote KV over live document KV;
    every arena row must read back bitwise as before the launch, as it
    does after the same launch run cleanly."""
    kw = ({"paged": True} if plane == "paged"
          else {"prefix_sharing": True, "layout_block": 16})
    be = _mk_backend("proxy", params["proxy"], tokz, **kw)
    toks = {d: np.asarray(tokz.encode(t), np.int32)
            for d, t in _PAGED_DOCS.items()}
    ids = [1, 3]                                   # 40 and 50 words
    bucket = 64
    op = np.asarray(tokz.encode(OPS["o_orig"]), np.int32)
    be.run_stage(ids, toks, bucket, 0.5, op, 2)    # cache f_len 32
    rid = 3
    slot = be._doc_slot[rid][1]
    # the 50-word document's true fraction (25 tokens) undershoots the
    # padded cache (32): the window [25, 25 + op_len) holds live doc KV
    assert be._true_len(toks[rid], 0.5) < be.cached_len(rid) == 32
    before = _arena_bytes(be)
    undo = _raise_after(be.model, 1)
    with pytest.raises(RuntimeError, match="device fault"):
        be.run_stage(ids, toks, bucket, 0.5, op, 2)   # decode-only
    undo()
    _assert_same_rows(before, _arena_bytes(be))
    assert int(be._arenas[bucket].cached_len[slot]) == 32
    be.run_stage(ids, toks, bucket, 0.5, op, 2)       # clean, same launch
    _assert_same_rows(before, _arena_bytes(be))


@pytest.mark.parametrize("where", ["prefill", "cow"])
def test_failed_prefix_attach_commits_nothing(params, tokz, where):
    """A first-touch op-prefix prefill that raises records no memo and
    frees its row; a copy-on-write copy that raises attaches no document.
    Healed, the next launch prefills and attaches afresh and answers as a
    backend that never failed."""
    toks = {d: np.asarray(tokz.encode(t), np.int32)
            for d, t in _PAGED_DOCS.items()}
    ids, bucket = [1, 3], 64
    op = np.asarray(tokz.encode(OPS["o_orig"]), np.int32)
    kw = dict(prefix_sharing=True, layout_block=512)   # pure copy-on-write
    clean = _mk_backend("proxy", params["proxy"], tokz, **kw)
    want = clean.run_stage(ids, toks, bucket, 0.5, op, 2)
    be = _mk_backend("proxy", params["proxy"], tokz, **kw)
    name = "extend" if where == "prefill" else "take_kv_window"

    def fail(*args, **kwargs):
        raise RuntimeError(f"device fault in {name}")

    setattr(be.model, name, fail)
    with pytest.raises(RuntimeError, match="device fault"):
        be.run_stage(ids, toks, bucket, 0.5, op, 2)
    be.model.__dict__.pop(name)
    ar = be._arenas[bucket]
    assert not ar.slot_prefix and be.prefix_hits == be.cow_copies == 0
    if where == "prefill":
        assert not ar.prefix_row and be._alloc.live(bucket) == 0
    got = be.run_stage(ids, toks, bucket, 0.5, op, 2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]
    assert be.prefix_hits == be.cow_copies == len(ids)


def _capture_releases(backends):
    """Every document's valid KV window ``[0, cached_len)`` at the moment
    its slot is released (schedule-independent)."""
    store = {}
    for nm, be in backends.items():
        orig = be.release

        def release(doc_id, be=be, orig=orig, nm=nm):
            bs = be._doc_slot.get(doc_id)
            if bs is not None:
                bucket, slot = bs
                ar = be._arenas[bucket]
                c = int(ar.cached_len[slot])
                win = be.model.take_kv_window(
                    ar.states, torch.tensor([slot], dtype=torch.int32),
                    torch.tensor([0], dtype=torch.int32), c)
                store.setdefault((nm, doc_id), []).append(
                    (c, [t.clone() for layer in win
                         for t in layer.values()]))
            orig(doc_id)

        be.release = release
    return store


def test_drain_with_failed_step_matches_clean_drain(params, tokz):
    """The first decode-only launch of the drain raises inside its
    op-suffix loop; its documents retry solo and the drain answers, bills
    and leaves each document's rows bitwise as a clean drain does."""
    ladder = Cascade([
        Task(TaskConfig("proxy", "sur_1", 0.25), IMPOSSIBLE),
        Task(TaskConfig("proxy", "o_orig", 0.25), IMPOSSIBLE),  # decode-only
        Task(TaskConfig("proxy", "o_orig", 0.5), IMPOSSIBLE)])
    out = {}
    for fail in (False, True):
        bks = {n: _mk_backend(n, params[n], tokz, paged=True)
               for n in ("proxy", "oracle")}
        rows = _capture_releases(bks)
        proxy = bks["proxy"]
        orig_step = proxy._paged_step
        fired = []

        def step(*args, c_len, op_len, **kw):
            if fail and not fired and c_len > 0 and args[2].shape[1] == 0:
                fired.append(True)
                undo = _raise_after(proxy.model, 2)
                try:
                    return orig_step(*args, c_len=c_len, op_len=op_len, **kw)
                finally:
                    undo()
            return orig_step(*args, c_len=c_len, op_len=op_len, **kw)

        proxy._paged_step = step
        srv = CascadeServer(bks, OPS, n_classes=2, batch_size=4,
                            retry=RetryPolicy(max_retries=2,
                                              backoff_base=0.0),
                            device="cpu")
        h = srv.register(ladder)
        for i, d in enumerate(sorted(_PAGED_DOCS)):
            h.submit(d, _PAGED_DOCS[d], arrival=float(i))
        out[fail] = (h.drain(), rows, srv)
        assert bool(fired) == fail
    (clean, rows_c, _), (faulty, rows_f, srv_f) = out[False], out[True]
    assert srv_f.stats().retries > 0
    assert faulty.pred == clean.pred
    assert faulty.conf == clean.conf
    assert faulty.doc_cost == clean.doc_cost
    assert _ledger_exact(srv_f)
    assert rows_c.keys() == rows_f.keys()
    for key in rows_c:
        for (c1, w1), (c2, w2) in zip(rows_c[key], rows_f[key]):
            assert c1 == c2 and all(torch.equal(a, b)
                                    for a, b in zip(w1, w2)), key


# ------------------------------------------------------- against the JAX

def _chaos_submit(srv, docs, cascades):
    """Two tenants, logical-tick arrivals; the first document of tenant 0
    carries an already-expired deadline — a deterministic TIMED_OUT."""
    ids = sorted(docs)
    handles = [srv.register(c) for c in cascades]
    futs = {}
    for k, h in enumerate(handles):
        for j, d in enumerate(ids[k::2]):
            deadline = 0.0 if (k == 0 and j == 0) else None
            futs[(h.query_id, d)] = h.submit(d, docs[d], arrival=float(j),
                                             deadline_s=deadline)
    return handles, futs


def _chaos(mk_srv, plan_cls, injector_cls, docs, cascades):
    """Part A (a chaotic drain) and part B (a crash after four steps and
    a warm restart from the journal) in one package's classes; returns
    plain data both packages can be compared on."""
    plan = plan_cls(seed=CHAOS_SEED, **CHAOS_PLAN)
    srv = mk_srv()
    inj = injector_cls(plan).install(srv)
    handles, futs = _chaos_submit(srv, docs, cascades())
    srv.drain()
    agg = srv.stats()
    a = dict(
        counts=dict(inj.counts),
        statuses={k: f.status for k, f in futs.items()},
        doc_cost={k: f.cost for k, f in futs.items()},
        counters=(agg.retries, agg.quarantines, agg.timeouts, agg.failures,
                  agg.breaker_trips, agg.recovered_docs),
        ledger_exact=_ledger_exact(srv),
        all_terminal=all(f.done and f.status in TERMINAL_STATES
                         for f in futs.values()),
        deadline=futs[(handles[0].query_id, sorted(docs)[0])].status)

    crashed = mk_srv(journal=True)
    injector_cls(plan).install(crashed)
    _chaos_submit(crashed, docs, cascades())
    for _ in range(4):                      # partial progress, then "crash"
        crashed.step()
    journal = crashed.journal
    pre = dict(journal.resolutions)
    fresh = mk_srv(journal=True)
    for c in cascades():                    # same cascades, same order
        fresh.register(c)
    rec = fresh.recover(journal)
    restored = all(rec[key].done and rec[key].status == r["status"]
                   and rec[key].pred == r["pred"]
                   and rec[key].cost == r["cost"]
                   for key, r in pre.items())
    fresh.drain()
    b = dict(
        pre={k: (r["status"], r["cost"]) for k, r in pre.items()},
        restored_exact=restored,
        statuses={k: f.status for k, f in rec.items()},
        doc_cost={k: f.cost for k, f in rec.items()},
        recovered=fresh.stats().recovered_docs,
        ledger_exact=_ledger_exact(fresh),
        all_terminal=all(f.done and f.status in TERMINAL_STATES
                         for f in rec.values()))
    return a, b


@pytest.fixture(scope="module")
def jax_chaos(docs):
    """The chaos drain and the journal recovery in the JAX package, and
    the weights they ran with, converted for the port."""
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.core.tasks import Cascade as JC, Task as JT, TaskConfig as JTC
    from repro.data.tokenizer import HashWordTokenizer as JTok
    from repro.models.model import LM as JLM
    from repro.models.runtime import CPU_TEST
    from repro.serving.engine import (CascadeServer as JServer,
                                      LMBackend as JBackend,
                                      RequestJournal as JJournal)
    from repro.serving.faults import (FaultInjector as JInjector,
                                      FaultPlan as JPlan)
    from repro.serving.scheduler import RetryPolicy as JRetry
    from repro_torch.models.convert import from_jax_params
    rcfg = resolve(get_reduced("llama3_2_1b", dtype="float32",
                               vocab_size=512, num_layers=2), tp=1)
    jtokz = JTok(vocab_size=512)
    jb = {}
    for n, seed in (("proxy", 1), ("oracle", 2)):
        m = JLM(rcfg, CPU_TEST)
        jb[n] = JBackend(name=n, model=m, params=m.init(
            jax.random.PRNGKey(seed)), tokenizer=jtokz,
            rate_per_token=1.0 if n == "oracle" else 0.06, s_alloc=512)

    def mk_srv(journal=False):
        for be in jb.values():
            be.reset()
        return JServer(dict(jb), OPS, n_classes=2, batch_size=4,
                       retry=JRetry(max_retries=2, backoff_base=0.0),
                       journal=JJournal() if journal else None, inflight=1)

    res = _chaos(mk_srv, JPlan, JInjector, docs,
                 lambda: _tenant_cascades(JC, JT, JTC))
    tparams = {n: from_jax_params(jax.tree.map(np.asarray, be.params),
                                  _rcfg(), "cpu") for n, be in jb.items()}
    return res, tparams


@pytest.fixture(scope="module")
def port_chaos(jax_chaos, tokz, docs):
    _, tparams = jax_chaos
    bks = {n: _mk_backend(n, tparams[n], tokz) for n in ("proxy", "oracle")}

    def mk_srv(journal=False):
        return mk_server(bks, journal=RequestJournal() if journal else None,
                         inflight=1)

    return _chaos(mk_srv, FaultPlan, FaultInjector, docs, _tenant_cascades)


def test_chaos_drain_matches_jax(jax_chaos, port_chaos):
    (ja, _), _ = jax_chaos
    pa, _ = port_chaos
    assert pa["all_terminal"] and pa["ledger_exact"]
    assert pa["deadline"] == TIMED_OUT
    assert pa["counts"]["arena_losses"] == 1
    assert pa["counts"]["launch_failures"] > 0
    assert pa["counts"]["nan_confidences"] > 0
    assert pa["counts"] == ja["counts"]
    assert pa["statuses"] == ja["statuses"]
    assert pa["counters"] == ja["counters"]
    assert pa["counters"][5] > 0                     # recovered_docs
    assert pa["doc_cost"] == ja["doc_cost"]          # exact $
    assert ja["ledger_exact"]


def test_journal_recovery_after_four_steps_matches_jax(jax_chaos,
                                                       port_chaos):
    (_, jb), _ = jax_chaos
    _, pb = port_chaos
    assert pb["restored_exact"] and pb["all_terminal"] and pb["ledger_exact"]
    assert 0 < len(pb["pre"]) < len(pb["statuses"])
    assert pb["pre"] == jb["pre"]
    assert pb["statuses"] == jb["statuses"]
    assert pb["doc_cost"] == jb["doc_cost"]
    assert pb["recovered"] == jb["recovered"] > 0


@pytest.mark.parametrize("prefix", [False, True])
def test_chaos_invariants_on_both_layouts(params, tokz, docs, prefix):
    """The chaos drain and its recovery keep every invariant on the
    doc-before-op plane and on the prefix plane (whose arena loss leaves
    pinned rows unreferenced and reclaimable) at inflight=3."""
    kw = {"prefix_sharing": True, "layout_block": 16} if prefix else {}
    bks = {n: _mk_backend(n, params[n], tokz, **kw)
           for n in ("proxy", "oracle")}

    def mk_srv(journal=False):
        return mk_server(bks, journal=RequestJournal() if journal else None,
                         inflight=3)

    a, b = _chaos(mk_srv, FaultPlan, FaultInjector, docs, _tenant_cascades)
    assert a["all_terminal"] and a["ledger_exact"]
    assert a["deadline"] == TIMED_OUT
    assert a["counts"]["arena_losses"] == 1
    assert b["restored_exact"] and b["all_terminal"] and b["ledger_exact"]


# -------------------------------------------- the reference's fifteen cases

def test_injector_schedule_is_seed_deterministic():
    plan = FaultPlan(seed=5, launch_failure_p=0.3, nan_p=0.2,
                     latency_spike_p=0.1)
    a, b = FaultInjector(plan), FaultInjector(plan)
    assert [a.draw() for _ in range(64)] == [b.draw() for _ in range(64)]
    assert a.calls == 64


def test_injector_draws_like_the_jax_injector():
    """Same seed, same schedule and victims as the JAX injector."""
    pytest.importorskip("jax")
    from repro.serving.faults import FaultInjector as JInjector
    from repro.serving.faults import FaultPlan as JPlan
    kw = dict(seed=CHAOS_SEED, launch_failure_p=0.3, nan_p=0.2,
              latency_spike_p=0.1)
    a, b = FaultInjector(FaultPlan(**kw)), JInjector(JPlan(**kw))
    for _ in range(32):
        assert a.draw() == b.draw()
        assert a.pick_victim(4) == b.pick_victim(4)


def test_faulty_backend_forwards_attributes(backends):
    inj = FaultInjector(FaultPlan(seed=0))
    proxy = inj.wrap(backends["proxy"])
    assert proxy.name == "proxy"
    assert proxy.rate_per_token == backends["proxy"].rate_per_token
    before = backends["proxy"].retire_after
    proxy.retire_after = before + 7        # setattr forwards to the inner
    assert backends["proxy"].retire_after == before + 7
    backends["proxy"].retire_after = before


def test_submit_validation(backends, docs):
    srv = mk_server(backends)
    h = srv.register(_cascade())
    with pytest.raises(ValueError, match="empty or"):
        h.submit(0, "")
    with pytest.raises(ValueError, match="empty or"):
        h.submit(0, "  \n\t ")
    text = next(iter(docs.values()))
    h.submit(0, text)
    with pytest.raises(ValueError, match="already submitted"):
        h.submit(0, text)
    h2 = srv.register(_cascade())
    h2.submit(0, text)              # doc ids are scoped per query
    srv.drain()


def test_failed_launch_retries_solo_and_resolves(backends, docs):
    srv = mk_server(backends)
    h = srv.register(_cascade())
    inj = FaultInjector(FaultPlan(seed=3, launch_failure_p=1.0))
    inj.install(srv)
    futs = [h.submit(d, docs[d], arrival=float(i))
            for i, d in enumerate(sorted(docs)[:3])]
    assert srv.step() == []                 # packed launch fails
    assert inj.counts["launch_failures"] == 1
    assert h.stats.retries == 3             # every member re-enqueued
    assert all(not f.done for f in futs)
    inj.plan = FaultPlan(seed=3)            # heal the backend
    launch = srv._queue.next_launch(srv._stage_of, srv.batch_size)
    assert len(launch.doc_ids) == 1         # survivors retry solo
    srv._queue.push(srv._requests[launch.doc_ids[0]])
    res = h.drain()
    assert all(f.status == RESOLVED for f in futs)
    assert set(res.pred) == set(sorted(docs)[:3])
    assert _ledger_exact(srv)
    # the poisoned launch's timeline record launched no rows
    failed = [r for r in srv.telemetry.launches.items() if not r.ok]
    assert len(failed) == 1 and failed[0].width == 0


def test_retries_exhausted_resolves_failed(backends, docs):
    srv = mk_server(backends)
    h = srv.register(_cascade())
    FaultInjector(FaultPlan(seed=1, launch_failure_p=1.0)).install(srv)
    futs = [h.submit(d, docs[d]) for d in sorted(docs)[:2]]
    res = h.drain()                         # terminates, never hangs
    assert all(f.done and f.status == FAILED for f in futs)
    assert all("launch failed" in f.error for f in futs)
    assert h.stats.failures == 2
    assert res.pred == {}
    assert set(res.status.values()) == {FAILED}
    assert srv.stats().breaker_trips >= 1   # persistent failures trip it
    with pytest.raises(RuntimeError, match="failed"):
        futs[0].result()


def test_deadline_resolves_timed_out(backends, docs):
    srv = mk_server(backends)
    h = srv.register(_cascade())
    d0, d1 = sorted(docs)[:2]
    late = h.submit(d0, docs[d0], deadline_s=0.0)     # expires immediately
    ok = h.submit(d1, docs[d1])
    res = h.drain()
    assert late.status == TIMED_OUT and late.error == "deadline exceeded"
    assert ok.status == RESOLVED
    assert h.stats.timeouts == 1
    assert res.status[d0] == TIMED_OUT and d0 not in res.pred
    with pytest.raises(RuntimeError, match="timed_out"):
        late.result()


@pytest.mark.parametrize("case", ["heal", "escalate", "fail_at_final"])
def test_nan_quarantine(backends, docs, case):
    """A non-finite confidence retries solo (then resolves once healed);
    a second one escalates to the final stage; non-finite at the final
    stage fails the document cleanly.  The NaN launches stay billed."""
    srv = mk_server(backends)
    h = srv.register(_cascade())
    inj = FaultInjector(FaultPlan(seed=2, nan_p=1.0))
    inj.install(srv)
    d0 = sorted(docs)[0]
    fut = h.submit(d0, docs[d0])
    final = len(h.stages) - 1
    if case == "fail_at_final":
        h.drain()
        assert fut.status == FAILED and "non-finite" in fut.error
        assert h.stats.quarantines == 3
        return
    srv.step()                              # quarantine 1: solo retry
    assert h.stats.quarantines == 1 and not fut.done
    if case == "escalate":
        srv.step()                          # quarantine 2: escalate
        assert srv._requests[srv._ids[(h.query_id, d0)]].stage == final
    inj.plan = FaultPlan(seed=2)            # heal
    h.drain()
    assert fut.status == RESOLVED
    if case == "escalate":
        assert fut.exit_stage == final
    assert _ledger_exact(srv)


def test_breaker_reroutes_sick_backend_to_next_stage(backends, docs):
    srv = mk_server(backends, breaker_threshold=2, breaker_cooldown=64,
                    retry=RetryPolicy(max_retries=3, backoff_base=0.0))
    h = srv.register(_cascade())
    inj = FaultInjector(FaultPlan(seed=4, launch_failure_p=1.0))
    srv.backends["proxy"] = inj.wrap(srv.backends["proxy"])   # proxy only
    futs = [h.submit(d, docs[d]) for d in sorted(docs)[:4]]
    res = h.drain()
    final = len(h.stages) - 1
    assert all(f.status == RESOLVED for f in futs)
    assert all(s == final for s in res.exit_stage.values())   # via oracle
    assert h.stats.breaker_trips >= 1
    assert srv.stats().breaker_trips == srv._breaker_trips
    assert res.stats.stage_cost[final] > 0
    assert _ledger_exact(srv)


def test_arena_loss_replays_eviction_and_rebills_prefill(backends, docs):
    sub = {d: docs[d] for d in sorted(docs)[:4]}
    srv = mk_server(backends)
    h = srv.register(_ladder())
    for i, d in enumerate(sorted(sub)):
        h.submit(d, sub[d], arrival=float(i))
    clean = h.drain()
    assert srv.stats().recovered_docs == 0
    cost_clean = srv.cost(h.query_id)
    srv2 = mk_server(backends)
    h2 = srv2.register(_ladder())
    inj = FaultInjector(FaultPlan(seed=9, arena_loss_at=1))
    inj.install(srv2)
    futs = [h2.submit(d, sub[d], arrival=float(i))
            for i, d in enumerate(sorted(sub))]
    res = h2.drain()
    assert inj.counts["arena_losses"] == 1
    assert h2.stats.recovered_docs > 0
    assert all(f.status == RESOLVED for f in futs)
    assert res.pred == clean.pred           # recovery changes $, not answers
    assert srv2.cost(h2.query_id) > cost_clean
    assert _ledger_exact(srv2)


def test_journal_recovery_restores_and_resubmits(backends, docs):
    srv = mk_server(backends, journal=RequestJournal())
    h = srv.register(_cascade())
    sub = sorted(docs)[:6]
    for i, d in enumerate(sub):
        h.submit(d, docs[d], arrival=float(i))

    def done():
        reqs = {d: srv._requests[srv._ids[(h.query_id, d)]] for d in sub}
        return {d: (r.pred, r.cost) for d, r in reqs.items() if r.done}

    while not done():                       # partial progress, then "crash"
        srv.step()
    journal = srv.journal
    done_before = done()
    assert 0 < len(done_before) < len(sub)
    srv2 = mk_server(backends, journal=RequestJournal())
    h2 = srv2.register(_cascade())
    futs = srv2.recover(journal)
    assert set(d for _, d in futs) == set(sub)
    for d, (pred, cost) in done_before.items():
        fut = futs[(h2.query_id, d)]
        assert fut.done and fut.pred == pred and fut.cost == cost
    assert h2.stats.recovered_docs == len(sub) - len(done_before)
    res = h2.drain()
    assert all(futs[(h2.query_id, d)].status in TERMINAL_STATES
               for d in sub)
    assert set(res.status) == set(sub)
    assert _ledger_exact(srv2)
    assert len(srv2.journal.unresolved()) == 0


@pytest.mark.parametrize("case", ["stall", "finite_backoff"])
def test_watchdog(backends, docs, case):
    """An infinite backoff is a stall (raised with the stuck listing);
    a finite one is slept out and is not."""
    d0 = sorted(docs)[0]
    if case == "stall":
        srv = mk_server(backends, stall_limit=5)
        h = srv.register(_cascade())
        fut = h.submit(d0, docs[d0])
        srv._requests[srv._ids[(h.query_id, d0)]].not_before = math.inf
        with pytest.raises(ServerStalledError) as ei:
            srv.drain()
        assert ei.value.stuck == [(h.query_id, d0, 0, 0, math.inf)]
        assert not fut.done
        return
    srv = mk_server(backends, stall_limit=2,
                    retry=RetryPolicy(max_retries=2, backoff_base=0.01,
                                      backoff_cap=0.01))
    h = srv.register(_cascade())
    FaultInjector(FaultPlan(seed=6, launch_failure_p=1.0)).install(srv)
    fut = h.submit(d0, docs[d0])
    h.drain()                               # sleeps out backoffs, no stall
    assert fut.status == FAILED


def test_eviction_during_backoff_rebills_prefill_once(params, tokz):
    bks = {"proxy": _mk_backend("proxy", params["proxy"], tokz,
                                slot_budget=1),
           "oracle": _mk_backend("oracle", params["oracle"], tokz)}
    srv = CascadeServer(bks, OPS, n_classes=2, batch_size=4,
                        retry=RetryPolicy(max_retries=2, backoff_base=0.0),
                        device="cpu")
    corpus = {d.doc_id: d.text
              for d in generate_corpus(2, avg_lines=10, seed=11)}
    da, db = sorted(corpus)
    ha = srv.register(_ladder())
    hb = srv.register(_ladder())
    fa = ha.submit(da, corpus[da], arrival=0.0)
    srv.step()                              # A runs stage 0, caches f=0.25
    rid = srv._ids[(ha.query_id, da)]
    assert srv._requests[rid].cached["proxy"] > 0
    inj = FaultInjector(FaultPlan(seed=8, launch_failure_p=1.0))
    inj.install(srv)
    srv.step()                              # A's stage-1 launch fails
    assert srv._requests[rid].retries == 1
    inj.plan = FaultPlan(seed=8)            # heal
    fb = hb.submit(db, corpus[db], arrival=-1.0)   # evicts A mid-retry
    srv.step()
    assert srv._requests[rid].evictions == 1
    assert srv._requests[rid].cached["proxy"] == 0
    assert srv._requests[rid].retries == 1
    srv.drain()
    assert fa.status == RESOLVED and fb.status == RESOLVED
    toks_a = len(tokz.encode(corpus[da]))
    op_len = len(tokz.encode(OPS["o_orig"]))
    assert ha.stats.stage_new_tokens[1] == toks_a + op_len
    assert ha.stats.stage_cached_tokens[1] == 0
    assert ha.stats.retries == 1 and ha.stats.evictions == 1
    assert _ledger_exact(srv)


def test_fault_free_path_matches_pre_fault_engine(backends, docs):
    """With no injector, no deadlines and default policies the fault
    machinery adds nothing; an installed injector that never fires
    answers and bills bitwise as the bare server."""
    out = {}
    for inject in (False, True):
        srv = mk_server(backends)
        h = srv.register(_cascade())
        if inject:
            FaultInjector(FaultPlan(seed=0)).install(srv)
        for i, d in enumerate(sorted(docs)):
            h.submit(d, docs[d], arrival=float(i))
        out[inject] = h.drain()
        st = h.stats
        assert st.retries == st.quarantines == st.timeouts == 0
        assert st.failures == st.breaker_trips == st.recovered_docs == 0
        assert set(out[inject].status.values()) == {RESOLVED}
        assert srv._stalled_steps == 0
        assert _ledger_exact(srv)
    assert out[True].conf == out[False].conf
    assert out[True].doc_cost == out[False].doc_cost
