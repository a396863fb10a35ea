"""The paged op-suffix decode's CUDA graphs (``serving.decode_graph``).

On the CPU: the eligibility rule (the CPU, the gather and prefix planes,
the arena sanitizer and ``moe.DROP_LOG`` keep the eager loop), the graph
key and its invalidation on an arena's growth, replacement and
retirement, and a replay's bookkeeping (static inputs, the logits copied
out of the static output, the kernels' launch counters).  On the card:
graphs against the eager loop bitwise, logits and arena rows, across
launches of one signature with other slots, lengths and operation
tokens, across a growth and a retire, after a raise inside a capture,
and for the dense, M-RoPE (qwen2-vl) and MoE (phi3.5-moe) families.
"""
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import resolve  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.tasks import Cascade, Task, TaskConfig  # noqa: E402
from repro_torch.data.tokenizer import HashWordTokenizer  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import decode_graph  # noqa: E402
from repro_torch.serving.decode_graph import DecodeGraphs, _Entry  # noqa: E402
from repro_torch.serving.engine import CascadeServer, LMBackend  # noqa: E402
from repro_torch.serving.scheduler import fraction_len  # noqa: E402

# two operations of one token length (7), different tokens
OPS = {"o_orig": "does this overturn a lower court decision",
       "o_alt": "is the ruling about a contract dispute",
       "sur_1": "is a lower court mentioned"}
THR = {0: 2.0, 1: 2.0}          # impossible: every doc walks every stage
DOCS = {i: " ".join(f"w{i}x{j}" for j in range(n))
        for i, n in enumerate([20, 40, 28, 50, 12, 33])}
TOKZ = HashWordTokenizer(vocab_size=512)


def _model(arch="llama3_2_1b", device="cpu"):
    return LM(resolve(get_reduced(arch, dtype="float32", vocab_size=512),
                      tp=1), device=device)


def _backend(model, params, device="cpu", **kw):
    return LMBackend(name="proxy", model=model, params=params,
                     tokenizer=TOKZ, s_alloc=512, device=device, **kw)


def _toks(ids):
    return {d: np.asarray(TOKZ.encode(DOCS[d]), np.int32) for d in ids}


def _op(name):
    return np.asarray(TOKZ.encode(OPS[name]), np.int32)


def _rows(be):
    return {b: [t.clone() for layer in ar.states for t in layer.values()]
            for b, ar in be._arenas.items()}


def _same_rows(a, b):
    return a.keys() == b.keys() and all(
        torch.equal(x, y) for k in a for x, y in zip(a[k], b[k]))


# ---------------------------------------------------------------- CPU
def test_op_lengths_match():
    assert len(_op("o_orig")) == len(_op("o_alt")) != len(_op("sur_1"))
    assert not np.array_equal(_op("o_orig"), _op("o_alt"))


@pytest.mark.parametrize("case", ["cpu", "cuda", "sanitizer", "drop_log"])
def test_eligibility_rule(case, monkeypatch):
    """A CUDA device with the arena's sanitizer off and no MoE drop log
    captures; anything else keeps the eager loop."""
    m = _model()
    be = _backend(m, m.init(seed=1), sanitize=(case == "sanitizer"))
    arena = be._arena(32)
    if case == "drop_log":
        monkeypatch.setattr(moe, "DROP_LOG", [])
    device = torch.device("cpu" if case == "cpu" else "cuda")
    assert decode_graph.eligible(device, arena) == (case == "cuda")


@pytest.mark.parametrize("plane", ["paged_cpu", "gather", "prefix"])
def test_planes_without_graphs_run_eager(plane, monkeypatch):
    """The paged plane on the CPU, and the gather and prefix planes even
    where the rule would allow a graph, run the eager loop: every launch
    record reads ``eager`` and no graph is kept."""
    if plane != "paged_cpu":
        monkeypatch.setattr(decode_graph, "eligible", lambda d, a: True)
    kw = {"paged_cpu": {"paged": True}, "gather": {"paged": False},
          "prefix": {"prefix_sharing": True, "layout_block": 16}}[plane]
    m = _model()
    params = m.init(seed=1)
    backends = {n: LMBackend(name=n, model=m, params=params, tokenizer=TOKZ,
                             s_alloc=512, device="cpu", **kw)
                for n in ("proxy", "oracle")}
    srv = CascadeServer(backends, OPS, n_classes=2, batch_size=4,
                        device="cpu")
    h = srv.register(Cascade([Task(TaskConfig("proxy", "sur_1", 0.25), THR),
                              Task(TaskConfig("proxy", "o_orig", 0.5),
                                   THR)]))
    for d in sorted(DOCS)[:4]:
        h.submit(d, DOCS[d])
    h.drain()
    recs = [r for r in srv.telemetry.launches.items() if r.ok]
    assert recs and {r.decode_graph for r in recs} == {"eager"}
    counters = srv.telemetry.snapshot()["counters"]
    assert counters["decode_graph_captures"] == 0
    assert counters["decode_graph_replays"] == 0
    assert all(len(be._decode_graphs) == 0 for be in backends.values())


class _Graph:
    def __init__(self):
        self.replayed = 0

    def replay(self):
        self.replayed += 1


def _entry(arena, width=4, vocab=8):
    return _Entry(graph=_Graph(), arena=weakref.ref(arena),
                  growths=arena.growths,
                  inputs=(torch.zeros(width, dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32),
                          torch.zeros(width, dtype=torch.int32)),
                  out=torch.arange(width * vocab, dtype=torch.float32
                                   ).reshape(width, vocab),
                  launches=[(dec.LAUNCHES, "paged_decode_attention", 6)])


def test_graph_key_and_invalidation():
    """An entry serves only the arena object and capacity it was captured
    on: a growth or a new arena for the bucket drops the bucket's
    entries; retire and reset drop them at once; other buckets stay."""
    m = _model()
    be = _backend(m, m.init(seed=1), init_slots=2)
    g = be._decode_graphs
    a32, a64 = be._arena(32), be._arena(64)
    g.store((32, 7, 4), _entry(a32))
    g.store((32, 5, 4), _entry(a32))
    g.store((64, 7, 4), _entry(a64))
    assert g.lookup(a32, (32, 7, 4)) is not None
    assert g.lookup(a32, (32, 7, 8)) is None            # width is key
    a32.ensure_capacity(3)                               # a growth
    assert a32.growths == 1
    assert g.lookup(a32, (32, 7, 4)) is None
    assert len(g) == 1 and g.lookup(a64, (64, 7, 4)) is not None
    g.store((32, 7, 4), _entry(a32))
    assert g.lookup(a32, (32, 7, 4)) is not None
    fresh = type(a32)(m, 32, a32.s_alloc, capacity=a32.capacity,
                      device="cpu")
    fresh.growths = a32.growths                          # same count
    assert g.lookup(fresh, (32, 7, 4)) is None           # another arena
    g.store((32, 7, 4), _entry(a32))
    be.retire(32)
    assert len(g) == 1 and g.lookup(a64, (64, 7, 4)) is not None
    be.reset()
    assert len(g) == 0


def test_replay_copies_inputs_and_logits_and_counts_launches():
    """A replay copies the launch's tensors into the static inputs,
    hands back a copy of the static logits (a later replay overwrites
    the static buffer) and adds the launches its capture counted."""
    m = _model()
    be = _backend(m, m.init(seed=1))
    arena = be._arena(32)
    g = DecodeGraphs()
    e = _entry(arena)
    g.store((32, 3, 4), e)
    inputs = (torch.tensor([0, 1, 2, 2], dtype=torch.int32),
              torch.tensor([7, 8, 9], dtype=torch.int32),
              torch.tensor([5, 6, 1, 1], dtype=torch.int32))
    n0 = dec.LAUNCHES["paged_decode_attention"]
    out, mode = g.run(arena, 3, None, inputs)
    assert mode == decode_graph.REPLAY and g.replays == 1
    assert e.graph.replayed == 1
    assert all(torch.equal(b, s) for b, s in zip(e.inputs, inputs))
    assert torch.equal(out, e.out)
    assert out.data_ptr() != e.out.data_ptr()
    assert dec.LAUNCHES["paged_decode_attention"] == n0 + 6
    dec.LAUNCHES["paged_decode_attention"] = n0


# --------------------------------------------------------------- card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _launch(be, ids, toks, bucket, fraction, op, width=4):
    """One launch through dispatch/complete: (logits of its rows, how its
    decode ran)."""
    f_len = fraction_len(bucket, fraction)
    cached = {min(be.cached_len(d), f_len) for d in ids}
    assert len(cached) == 1
    eff_c = cached.pop()
    t = be.dispatch_group(ids, toks, bucket, f_len, fraction, eff_c, op, 2,
                          width=width)
    logits = t.logits.clone()
    be.complete_group(t)
    return logits, t.decode_graph


def _twins(arch="llama3_2_1b", **kw):
    m = _model(arch, "cuda")
    params = m.init(seed=1)
    return _backend(m, params, "cuda", **kw), _backend(m, params, "cuda",
                                                       **kw)


def _eager(monkeypatch):
    """Run the eager loop on the card (the graph's reference)."""
    monkeypatch.setattr(decode_graph, "eligible", lambda d, a: False)


def _ladder_launches(arch="llama3_2_1b"):
    """Launches of one signature (bucket 64, op length 7, width 4) with
    other slots, true lengths and operation tokens, then a second
    signature (op length 5) and a decode-only launch."""
    ids_a, ids_b = [1, 3, 5], [0, 2]
    return [(ids_a, 64, 0.5, "o_orig"), (ids_a, 64, 0.5, "o_alt"),
            (ids_b, 64, 1.0, "o_alt"), (ids_a, 64, 1.0, "o_orig"),
            (ids_b, 64, 1.0, "sur_1"), (ids_a, 64, 1.0, "o_orig")]


def _play(be, launches):
    toks = _toks(DOCS)
    out = []
    for ids, bucket, frac, op in launches:
        logits, mode = _launch(be, ids, toks, bucket, frac, _op(op))
        out.append((logits, mode, _rows(be)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen2_vl_2b",
                                  "phi3_5_moe"])
def test_cuda_graph_replay_equals_eager_bitwise(arch, monkeypatch):
    """One signature replayed across launches with other slots, true
    lengths and operation tokens equals the eager loop bitwise, logits
    and arena rows, for the dense, M-RoPE and MoE families."""
    _cuda()
    be_g, be_e = _twins(arch)
    graph = _play(be_g, _ladder_launches())
    _eager(monkeypatch)
    eager = _play(be_e, _ladder_launches())
    assert [m for _, m, _ in graph] == ["capture", "replay", "replay",
                                        "replay", "capture", "replay"]
    assert {m for _, m, _ in eager} == {"eager"}
    for (lg, _, rg), (le, _, re) in zip(graph, eager):
        assert torch.equal(lg, le)
        assert _same_rows(rg, re)
    assert (be_g._decode_graphs.captures, be_g._decode_graphs.replays) \
        == (2, 4)


@pytest.mark.cuda
def test_cuda_growth_and_retire_recapture_bitwise(monkeypatch):
    """An arena growth and a retire between launches force a fresh
    capture, and the results stay bitwise equal to the eager loop."""
    _cuda()
    be_g, be_e = _twins(init_slots=2)
    toks = _toks(DOCS)
    op = _op("o_orig")

    def play(be):
        out = [_launch(be, [0, 1], toks, 64, 0.5, op)]
        out.append(_launch(be, [2], toks, 64, 0.5, op))         # grows
        assert be._arenas[64].growths == 1
        out.append(_launch(be, [0, 1], toks, 64, 1.0, op))
        rows = _rows(be)
        for d in (0, 1, 2):
            be.release(d)
        be.retire(64)
        out.append(_launch(be, [3, 4], toks, 64, 0.5, op))
        return out, rows, _rows(be)

    graph, rows_g, after_g = play(be_g)
    assert be_g._arenas[64].growths == 0          # a fresh arena
    _eager(monkeypatch)
    eager, rows_e, after_e = play(be_e)
    assert [m for _, m in graph] == ["capture", "capture", "replay",
                                     "capture"]
    for (lg, _), (le, _) in zip(graph, eager):
        assert torch.equal(lg, le)
    assert _same_rows(rows_g, rows_e) and _same_rows(after_g, after_e)


@pytest.mark.cuda
def test_cuda_raise_inside_capture_commits_nothing(monkeypatch):
    """A raise inside the captured phase leaves the arena bitwise as it
    was, keeps no graph and propagates; the next launch captures
    cleanly and answers as the eager loop does."""
    _cuda()
    be_g, be_e = _twins()
    toks = _toks(DOCS)
    ids = [1, 3]
    for be in (be_g, be_e):
        _launch(be, ids, toks, 64, 0.5, _op("o_orig"))   # cache f_len 32
    n = len(be_g._decode_graphs)
    before = _rows(be_g)
    model = be_g.model
    orig = model.decode_step
    calls = [0]

    def decode_step(*args, **kwargs):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("fault inside the captured phase")
        return orig(*args, **kwargs)

    model.decode_step = decode_step
    with pytest.raises(RuntimeError, match="captured phase"):
        _launch(be_g, ids, toks, 64, 0.5, _op("sur_1"))   # new signature
    del model.decode_step
    torch.cuda.synchronize()
    assert _same_rows(before, _rows(be_g))
    assert len(be_g._decode_graphs) == n
    lg, mode = _launch(be_g, ids, toks, 64, 0.5, _op("sur_1"))
    assert mode == "capture"
    _eager(monkeypatch)
    le, _ = _launch(be_e, ids, toks, 64, 0.5, _op("sur_1"))
    assert torch.equal(lg, le)
    assert _same_rows(_rows(be_g), _rows(be_e))
