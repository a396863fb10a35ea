"""The port's serving engine held against the JAX engine, and the port's
internal bitwise contracts.

``CascadeEngine.run`` on the ``_PAGED_DOCS`` ladder of
``tests/test_serving.py`` (impossible thresholds, so every document walks
every stage and routing is fixed) runs in both packages on the same
weights (``from_jax_params``): per-document $, new and cached token
counts and ``stats.batches`` must be EXACT (billing is
token-denominated), preds equal, confs within 1e-5 (f32 logits through a
two-class softmax).  Inside the port, the paged plane equals the gather
plane bitwise — confs and the arena rows each document leaves behind —
and ``inflight=3`` equals ``inflight=1`` bitwise, as
``tests/test_overlap.py`` pins for the JAX engine.  Also here: the import
boundary of the port (no JAX, no ``repro``) and the CUDA-by-default rule.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.core.tasks import Cascade, Task, TaskConfig  # noqa: E402
from repro_torch.data.documents import generate_corpus  # noqa: E402
from repro_torch.data.tokenizer import HashWordTokenizer  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.arena import BucketArena  # noqa: E402
from repro_torch.serving.engine import (CascadeEngine,  # noqa: E402
                                        CascadeServer, LMBackend,
                                        RequestJournal)

ROOT = pathlib.Path(__file__).resolve().parents[1]

OPS = {"o_orig": "does this overturn a lower court decision",
       "sur_1": "is a lower court mentioned"}
THR = {0: 2.0, 1: 2.0}          # impossible: every doc walks every stage
# word counts straddle two buckets (32, 64); 50 makes the true fraction
# undershoot the padded one, so the op suffix decodes over positions
# holding live document KV (the undo log's hard case)
_PAGED_DOCS = {i: " ".join(f"w{i}x{j}" for j in range(n))
               for i, n in enumerate([20, 40, 28, 50, 12])}


def _ladder(C=Cascade, T=Task, TC=TaskConfig):
    return C([
        T(TC("proxy", "sur_1", 0.25), THR),
        T(TC("proxy", "o_orig", 0.25), THR),   # decode-only op switch
        T(TC("proxy", "o_orig", 0.5), THR),    # re-entry extend
    ])


def _rcfg():
    return t_resolve(t_get_reduced("llama3_2_1b", dtype="float32",
                                   vocab_size=512, num_layers=2), tp=1)


def _backend(name, params, **kw):
    m = LM(_rcfg(), device="cpu")
    return LMBackend(name=name, model=m, params=params,
                     tokenizer=HashWordTokenizer(vocab_size=512),
                     rate_per_token=1.0 if name == "oracle" else 0.06,
                     s_alloc=512, device="cpu", **kw)


def _seeded_params():
    m = LM(_rcfg(), device="cpu")
    return {"proxy": m.init(seed=1), "oracle": m.init(seed=2)}


def _capture_releases(backends):
    """Fingerprint every document's valid KV window ``[0, cached_len)``
    at the moment its slot is released (schedule-independent, unlike
    post-drain arena bytes)."""
    store = {}
    for nm, be in backends.items():
        orig = be.release

        def release(doc_id, be=be, orig=orig, nm=nm):
            bs = be._doc_slot.get(doc_id)
            if bs is not None:
                bucket, slot = bs
                ar = be._arenas[bucket]
                c = int(ar.cached_len[slot])
                body = b""
                if c:
                    win = be.model.take_kv_window(
                        ar.states, torch.tensor([slot], dtype=torch.int32),
                        torch.tensor([0], dtype=torch.int32), c)
                    body = b"".join(t.numpy().tobytes() for layer in win
                                    for t in layer.values())
                store.setdefault((nm, bucket, doc_id), []).append(
                    (c, int(ar.true_len[slot]), body))
            orig(doc_id)

        be.release = release
    return store


def _run(params, docs, cascade, *, paged, inflight=1, batch_size=4, **kw):
    backends = {n: _backend(n, params[n], paged=paged, **kw)
                for n in ("proxy", "oracle")}
    rows = _capture_releases(backends)
    srv = CascadeServer(dict(backends), OPS, n_classes=2,
                        batch_size=batch_size, inflight=inflight,
                        device="cpu")
    h = srv.register(cascade)
    for i, d in enumerate(sorted(docs)):
        h.submit(d, docs[d], arrival=float(i))
    return srv, h.drain(), rows


@pytest.fixture(scope="module")
def jax_pair():
    """JAX engine result on the ladder + the params it ran with."""
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.core.tasks import Cascade as JC, Task as JT, TaskConfig as JTC
    from repro.data.tokenizer import HashWordTokenizer as JTok
    from repro.models.model import LM as JLM
    from repro.models.runtime import CPU_TEST
    from repro.serving.engine import (CascadeEngine as JEngine,
                                      LMBackend as JBackend)
    from repro_torch.models.convert import from_jax_params
    rcfg = resolve(get_reduced("llama3_2_1b", dtype="float32",
                               vocab_size=512, num_layers=2), tp=1)
    tokz = JTok(vocab_size=512)
    jparams, backends = {}, {}
    for name, seed in (("proxy", 1), ("oracle", 2)):
        m = JLM(rcfg, CPU_TEST)
        jparams[name] = m.init(jax.random.PRNGKey(seed))
        backends[name] = JBackend(
            name=name, model=m, params=jparams[name], tokenizer=tokz,
            rate_per_token=1.0 if name == "oracle" else 0.06, s_alloc=512)
    eng = JEngine(backends, OPS, n_classes=2, batch_size=4)
    res = eng.run(_ladder(JC, JT, JTC), _PAGED_DOCS)
    tparams = {n: from_jax_params(jax.tree.map(np.asarray, p), _rcfg(),
                               "cpu")
               for n, p in jparams.items()}
    return res, tparams


@pytest.mark.parametrize("paged", [True, False])
def test_engine_matches_jax_engine(jax_pair, paged):
    jres, tparams = jax_pair
    eng = CascadeEngine({n: _backend(n, tparams[n], paged=paged)
                         for n in ("proxy", "oracle")},
                        OPS, n_classes=2, batch_size=4, device="cpu")
    assert eng.backends["proxy"].uses_paged_kv() == paged
    res = eng.run(_ladder(), _PAGED_DOCS)
    assert res.pred == jres.pred
    assert res.doc_cost == jres.doc_cost               # exact $
    assert res.cost == jres.cost
    assert res.exit_stage == jres.exit_stage
    assert res.status == jres.status
    assert res.stats.batches == jres.stats.batches
    assert res.stats.stage_new_tokens == jres.stats.stage_new_tokens
    assert res.stats.stage_cached_tokens == jres.stats.stage_cached_tokens
    assert res.stats.stage_docs == jres.stats.stage_docs
    for d in _PAGED_DOCS:
        assert abs(res.conf[d] - jres.conf[d]) <= 1e-5


def test_paged_equals_gather_bitwise_with_arena_rows():
    params = _seeded_params()
    out = {p: _run(params, _PAGED_DOCS, _ladder(), paged=p)
           for p in (False, True)}
    (_, g, grows), (_, p, prows) = out[False], out[True]
    assert g.pred == p.pred
    assert g.conf == p.conf                     # float equality, bitwise
    assert g.doc_cost == p.doc_cost
    assert g.stats.batches == p.stats.batches
    assert grows and set(grows) == set(prows)
    for key in grows:
        assert grows[key] == prows[key], key


def test_inflight_three_equals_inflight_one_bitwise():
    params = _seeded_params()
    docs = {d.doc_id: d.text
            for d in generate_corpus(8, avg_lines=10, seed=7)}
    ladder = Cascade([Task(TaskConfig("proxy", "sur_1", 0.25), THR),
                      Task(TaskConfig("proxy", "o_orig", 1.0), THR)])
    s1, r1, rows1 = _run(params, docs, ladder, paged=True, inflight=1)
    s3, r3, rows3 = _run(params, docs, ladder, paged=True, inflight=3)
    assert s1._max_inflight_seen == 1 and s3._max_inflight_seen >= 2
    assert r3.pred == r1.pred
    assert r3.conf == r1.conf
    assert r3.doc_cost == r1.doc_cost
    assert r3.status == r1.status
    assert sorted((q, r, c) for _, q, r, c in s3.ledger()) \
        == sorted((q, r, c) for _, q, r, c in s1.ledger())
    assert rows1 and set(rows3) == set(rows1)
    for key in rows1:
        assert rows3[key] == rows1[key], key
    tl = s3.telemetry_snapshot()["timeline"]
    assert "overlap_hidden_frac" in tl


def test_budget_eviction_re_prefills_identically_on_both_planes():
    """slot_budget=1: a newer-but-older-arrival document evicts a cached
    one (the streaming recipe of ``tests/test_serving.py``); the evicted
    document re-prefills and both planes answer and bill bitwise alike."""
    params = _seeded_params()
    ladder = Cascade([Task(TaskConfig("proxy", "o_orig", 0.25), THR),
                      Task(TaskConfig("proxy", "o_orig", 1.0), THR)])
    a, b = 1, 3
    out = {}
    for paged in (False, True):
        eng = CascadeEngine({n: _backend(n, params[n], paged=paged,
                                         slot_budget=1)
                             for n in ("proxy", "oracle")},
                            OPS, n_classes=2, batch_size=1, device="cpu")
        eng.start(ladder)
        eng.submit(a, _PAGED_DOCS[a], arrival=0.0)
        eng.step()                                  # a cached at stage 0
        rid = eng._reqs[a].doc_id                   # server request id
        assert eng.backends["proxy"].cached_len(rid) > 0
        eng.submit(b, _PAGED_DOCS[b], arrival=-1.0)  # older -> higher prio
        eng.step()                                  # launches b, evicts a
        assert eng.backends["proxy"].cached_len(rid) == 0
        out[paged] = eng.drain()
    g, p = out[False], out[True]
    assert set(p.pred) == {a, b} and p.stats.evictions >= 1
    assert g.pred == p.pred and g.conf == p.conf
    assert g.doc_cost == p.doc_cost


def test_sanitizer_brackets_every_launch():
    params = _seeded_params()
    srv, res, _ = _run(params, _PAGED_DOCS, _ladder(), paged=True,
                       inflight=2, sanitize=True)
    assert set(res.pred) == set(_PAGED_DOCS)
    san = srv.backends["proxy"]._sanitizer
    assert san.checks > 0 and san.violations == 0


def test_journal_recover_restores_results():
    params = _seeded_params()
    backends = {n: _backend(n, params[n], paged=True)
                for n in ("proxy", "oracle")}
    srv = CascadeServer(backends, OPS, n_classes=2, batch_size=4,
                        journal=RequestJournal(), device="cpu")
    h = srv.register(_ladder())
    for d, text in _PAGED_DOCS.items():
        h.submit(d, text)
    res = h.drain()
    fresh = CascadeServer({n: _backend(n, params[n], paged=True)
                           for n in ("proxy", "oracle")},
                          OPS, n_classes=2, batch_size=4, device="cpu")
    h2 = fresh.register(_ladder())
    fresh.recover(srv.journal)
    again = h2.result()
    assert again.pred == res.pred and again.doc_cost == res.doc_cost


def test_cpu_run_reports_no_device_roofline():
    from repro_torch.launch.roofline import bandwidth_utilization
    assert bandwidth_utilization(1e9, 1e-3, bw=2e12) == 0.5
    if not torch.cuda.is_available():
        assert bandwidth_utilization(1e9, 1e-3) is None


def test_entry_points_default_to_cuda():
    """Without ``device=`` every entry point targets the card: on a
    machine without one it raises instead of silently using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(_rcfg())
    cpu_lm = LM(_rcfg(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        BucketArena(cpu_lm, 32, 96, capacity=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        LMBackend(name="proxy", model=cpu_lm, params={},
                  tokenizer=HashWordTokenizer(512))
    with pytest.raises(RuntimeError, match="CUDA"):
        CascadeServer({}, OPS, n_classes=2)


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_import_boundary_no_jax_no_repro():
    """The port and chip_smoke.py import nothing of JAX or ``repro``."""
    bad = []
    files = _port_files()
    assert len(files) > 20 and files[-1].exists()
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert not bad, bad


def test_no_library_attention_in_port():
    """The port never calls a library attention or compiles the plain
    version: its kernels are the hand-written ones."""
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        assert "scaled_dot_product_attention" not in text, path
        assert "torch.compile" not in text, path


@pytest.mark.cuda
def test_cuda_engine_paged_equals_gather_bitwise():
    """On the card: the paged plane (paged kernels, the op-suffix decode
    as CUDA graphs) and the gather plane (dense kernels, same CUDA
    bodies, eager) answer bitwise alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = LM(_rcfg(), device="cuda")
    params = {"proxy": m.init(seed=1), "oracle": m.init(seed=2)}
    results = {}
    for paged in (False, True):
        backends = {n: LMBackend(name=n, model=m, params=params[n],
                                 tokenizer=HashWordTokenizer(512),
                                 s_alloc=512, paged=paged, device="cuda")
                    for n in ("proxy", "oracle")}
        eng = CascadeEngine(backends, OPS, n_classes=2, batch_size=4,
                            device="cuda")
        results[paged] = eng.run(_ladder(), _PAGED_DOCS)
        # the paged plane's op-suffix decode replays CUDA graphs
        assert (backends["proxy"]._decode_graphs.replays > 0) == paged
    assert results[True].conf == results[False].conf
    assert results[True].doc_cost == results[False].doc_cost


@pytest.mark.cuda
def test_cuda_inflight_three_equals_inflight_one_bitwise():
    """On the card, with default backends (paged plane auto-selected):
    every launch is padded to the server's batch size, so cuBLAS sees the
    same product shapes whatever the cohort, and ahead-of-time dispatch
    (inflight=3) answers and bills bitwise as inflight=1 does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = LM(_rcfg(), device="cuda")
    params = {"proxy": m.init(seed=1), "oracle": m.init(seed=2)}
    docs = {d.doc_id: d.text
            for d in generate_corpus(8, avg_lines=10, seed=7)}
    ladder = Cascade([Task(TaskConfig("proxy", "sur_1", 0.25), THR),
                      Task(TaskConfig("proxy", "o_orig", 1.0), THR)])
    out = {}
    for inflight in (1, 3):
        backends = {n: LMBackend(name=n, model=m, params=params[n],
                                 tokenizer=HashWordTokenizer(512),
                                 s_alloc=512)
                    for n in ("proxy", "oracle")}
        assert backends["proxy"].uses_paged_kv()
        srv = CascadeServer(backends, OPS, n_classes=2, batch_size=4,
                            inflight=inflight)
        h = srv.register(ladder)
        for i, d in enumerate(sorted(docs)):
            h.submit(d, docs[d], arrival=float(i))
        out[inflight] = (srv, h.drain())
        assert backends["proxy"]._decode_graphs.replays > 0
    (s1, r1), (s3, r3) = out[1], out[3]
    assert s1._max_inflight_seen == 1 and s3._max_inflight_seen >= 2
    assert r3.pred == r1.pred
    assert r3.conf == r1.conf
    assert r3.doc_cost == r1.doc_cost
    assert r3.status == r1.status
