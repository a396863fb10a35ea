"""The port's serving telemetry (``repro_torch.serving.telemetry``): the
launch phases, padding counts, collector pauses and step span that each
``LaunchRecord`` carries, the device clock's fields (through a stand-in
clock on the CPU, whose events are the host's stamps, and on the card
under the ``cuda`` marker), the exporter's tracks, and a data plane that
answers bitwise alike at every level."""
import gc
import pathlib
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import resolve  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.tasks import Cascade, Task, TaskConfig  # noqa: E402
from repro_torch.data.tokenizer import HashWordTokenizer  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import telemetry as tmod  # noqa: E402
from repro_torch.serving.engine import (CascadeServer,  # noqa: E402
                                        LMBackend)
from repro_torch.serving.telemetry import (Telemetry,  # noqa: E402
                                           chrome_trace)

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPS = {"o_orig": "does this overturn a lower court decision",
       "sur_1": "is a lower court mentioned"}
THR = {0: 2.0, 1: 2.0}          # impossible: every doc walks every stage
DOCS = {i: " ".join(f"w{i}x{j}" for j in range(n))
        for i, n in enumerate([20, 40, 28, 50, 12])}
LADDER = [("sur_1", 0.25), ("o_orig", 0.25),   # decode-only op switch
          ("o_orig", 0.5)]                     # re-entry extend
PLANES = {"gather": dict(paged=False), "paged": dict(paged=True),
          "prefix": dict(prefix_sharing=True, layout_block=16)}


class FakeEvent:
    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass


class FakeClock:
    """A device clock for the CPU, where each stage step runs to its end
    before the host goes on: an event is the host's stamp at its
    record."""

    def __init__(self):
        self.marks = 0
        self.syncs = 0

    def mark(self):
        self.marks += 1
        return FakeEvent()

    @staticmethod
    def seconds(a, b):
        return b.t - a.t

    def sync(self):
        self.syncs += 1


def _rcfg():
    return resolve(get_reduced("llama3_2_1b", dtype="float32",
                               vocab_size=512, num_layers=2), tp=1)


@pytest.fixture(scope="module")
def params():
    m = LM(_rcfg(), device="cpu")
    return {"proxy": m.init(seed=1), "oracle": m.init(seed=2)}


def _backends(params, device="cpu", **kw):
    return {n: LMBackend(name=n, model=LM(_rcfg(), device=device),
                         params=params[n],
                         tokenizer=HashWordTokenizer(vocab_size=512),
                         rate_per_token=1.0 if n == "oracle" else 0.06,
                         s_alloc=512, device=device, **kw)
            for n in ("proxy", "oracle")}


def _server(params, level="counters", clock=None, plane="paged",
            device="cpu", **kw):
    srv = CascadeServer(_backends(params, device, **PLANES[plane]), OPS,
                        n_classes=2, batch_size=4, device=device,
                        telemetry=Telemetry(level=level), **kw)
    if clock is not None:
        srv.telemetry.clock = clock
    srv.telemetry.clear()
    return srv


def _cascade():
    return Cascade([Task(TaskConfig("proxy", op, f), THR)
                    for op, f in LADDER])


def _drain(srv):
    h = srv.register(_cascade())
    futs = [h.submit(d, DOCS[d], arrival=float(i))
            for i, d in enumerate(sorted(DOCS))]
    return h.drain(), futs


def _records(srv):
    return [r for r in srv.telemetry.launches.items() if r.ok]


@pytest.mark.parametrize("plane", sorted(PLANES))
def test_torch_telemetry_phases_split_dispatch_exactly(params, plane):
    """On every plane, each launch's extend and decode spans on the host
    clock sum to its ``dispatch_s`` exactly, the decode-only launches of
    the op switch among them (the prefix plane re-prefills on an op
    switch instead)."""
    srv = _server(params, plane=plane)
    _drain(srv)
    recs = _records(srv)
    assert recs and any(r.decode_only for r in recs) == (plane != "prefix")
    for r in recs:
        assert r.extend_dispatch_s + r.decode_dispatch_s == r.dispatch_s
        assert r.extend_dispatch_s > 0.0 and r.decode_dispatch_s > 0.0
        spans = r.phase_spans()
        assert [(c, p) for c, p, _, _ in spans] == [("host", "extend"),
                                                    ("host", "decode")]
        assert spans[0][2] == r.ts_enqueue and spans[0][3] == spans[1][2]
        # no device clock on the CPU
        assert r.extend_device_s is None and r.dev_start is None
    tl = srv.telemetry.snapshot()["timeline"]
    assert tl["extend_dispatch_s"] + tl["decode_dispatch_s"] == \
        pytest.approx(tl["dispatch_s"])
    assert tl["mean_launch_gap_ms"] == 0.0


@pytest.mark.parametrize("plane", ["paged", "prefix"])
def test_torch_telemetry_rows_and_real_tokens_hand_count(params, plane):
    """Three documents at width 8, the last one short: the extend computes
    8 rows of the 32-token chunk, the decode 8 rows of each op token (one
    readout step on the prefix plane); real are the documents' tokens and
    3 per decode step.  The decode-only launch after it counts no extend
    tokens."""
    be = _backends(params, **PLANES[plane])["proxy"]
    be.telemetry = Telemetry()
    toks = {0: np.arange(10, 42, dtype=np.int32),
            1: np.arange(50, 82, dtype=np.int32),
            2: np.arange(90, 100, dtype=np.int32)}       # short: 10 tokens
    op = np.asarray([5, 6, 7], np.int32)
    steps = 3 if plane == "paged" else 1
    t = be.dispatch_group([0, 1, 2], toks, 32, 32, 1.0, 0, op, 2, width=8)
    assert (t.rows_computed, t.tokens_real) == \
        (8 * 32 + 8 * steps, 32 + 32 + 10 + 3 * steps)
    be.complete_group(t)
    t = be.dispatch_group([0, 1, 2], toks, 32, 32, 1.0, 32, op, 2, width=8)
    assert (t.rows_computed, t.tokens_real) == (8 * steps, 3 * steps)
    be.complete_group(t)


def test_torch_telemetry_records_and_counters_carry_padding(params):
    srv = _server(params)
    _drain(srv)
    recs = _records(srv)
    assert all(0 < r.tokens_real < r.rows_computed for r in recs)
    assert {r.model for r in recs} == {"proxy", "oracle"}
    counters = srv.telemetry.snapshot()["counters"]
    assert counters["rows_computed"] == sum(r.rows_computed for r in recs)
    assert counters["tokens_real"] == sum(r.tokens_real for r in recs)


def test_torch_telemetry_gc_pause_lands_on_the_next_record(params):
    srv = _server(params, level="trace")
    h = srv.register(_cascade())
    for i, d in enumerate(sorted(DOCS)):
        h.submit(d, DOCS[d], arrival=float(i))
    srv.step()
    first = _records(srv)[-1]
    gc.collect()
    srv.step()
    nxt = _records(srv)[-1]
    assert nxt.index == first.index + 1
    gen2 = [p for p in srv.telemetry.gc_pauses.items() if p[2] == 2]
    assert gen2, "the forced collection was not recorded"
    t0, t1, _ = gen2[-1]
    assert first.ts_ready <= t0 <= t1 <= nxt.ts_start + nxt.wall_s
    assert nxt.gc_s >= t1 - t0 > 0.0
    assert srv.telemetry.gc_total_s >= t1 - t0
    srv.drain()


def test_torch_telemetry_one_gc_callback_for_many_hubs():
    hubs = [Telemetry() for _ in range(200)]
    refs = [weakref.ref(h) for h in hubs]
    del hubs
    gc.collect()
    assert sum(isinstance(c, tmod._GcWatch) for c in gc.callbacks) == 1
    assert all(r() is None for r in refs)
    live = Telemetry()
    assert live in tmod._GC_WATCH.hubs


def test_torch_telemetry_level_off_records_nothing_and_makes_no_event(
        params):
    clock = FakeClock()
    srv = _server(params, level="off", clock=clock)
    _drain(srv)
    gc.collect()
    tm = srv.telemetry
    assert len(tm.launches) == 0 and tm.launch_total == 0
    assert tm.registry.series_count() == 0 and len(tm.gc_pauses) == 0
    assert clock.marks == 0 and clock.syncs == 0


def test_torch_telemetry_probe_budget_at_counters(params):
    """At ``counters`` a launch records three events (start, mark, the
    completion event made timing-enabled), plus the clock origin once;
    no synchronisation."""
    clock = FakeClock()
    srv = _server(params, clock=clock)
    _drain(srv)
    n = srv.telemetry.launch_total
    assert n > 0 and clock.marks == 3 * n + 1 and clock.syncs == 0
    for r in _records(srv):
        assert r.extend_device_s >= 0.0 and r.decode_device_s >= 0.0
        assert r.dev_start is None       # host stamps only at ``trace``


def test_torch_telemetry_levels_answer_bitwise_alike(params):
    out = {}
    for level in ("off", "counters", "trace"):
        srv = _server(params, level=level, clock=FakeClock(), inflight=2)
        res, _ = _drain(srv)
        out[level] = (res.pred, res.conf, res.doc_cost,
                      [(q, r, c) for _, q, r, c in srv.ledger()])
    assert out["counters"] == out["off"]
    assert out["trace"] == out["off"]


def test_torch_telemetry_anchor_maps_device_events_to_the_host_clock(
        params):
    """At ``trace`` the clear anchors the clock (one sync); each launch's
    device windows then sit on ``perf_counter`` inside its enqueue and
    completion, and the gaps between launches run from one's completion
    event to the next one's start event."""
    clock = FakeClock()
    srv = _server(params, level="trace", clock=clock, inflight=2)
    assert clock.syncs == 1
    # the anchor event is recorded just after its host stamp, so the map
    # places every event that much early
    anchor, host = srv.telemetry._origin
    early = anchor.t - host + 1e-9
    _drain(srv)
    recs = _records(srv)
    for r in recs:
        assert r.ts_enqueue - early <= r.dev_start <= r.dev_split \
            <= r.dev_end <= r.ts_ready
        assert r.extend_device_s == pytest.approx(r.dev_split - r.dev_start)
        assert r.decode_device_s == pytest.approx(r.dev_end - r.dev_split)
    gaps = [r.device_gap_s for r in recs[1:]]
    assert all(g is not None and g >= 0.0 for g in gaps)
    for a, b in zip(recs, recs[1:]):
        assert b.device_gap_s == pytest.approx(b.dev_start - a.dev_end)
    assert srv.telemetry.mean_launch_gap_s() == pytest.approx(
        sum(gaps) / len(gaps))
    assert srv.telemetry.phase_total_s["decode_device"] == pytest.approx(
        sum(r.decode_device_s for r in recs))


def test_torch_telemetry_launch_before_the_anchor_gets_no_host_stamps(
        params):
    clock = FakeClock()
    srv = _server(params, level="trace", clock=clock, inflight=2)
    h = srv.register(_cascade())
    for i, d in enumerate(sorted(DOCS)):
        h.submit(d, DOCS[d], arrival=float(i))
    srv.step()                       # two launches dispatched, one done
    srv.telemetry.clear()            # the harness's window opens here
    srv.step()
    first = _records(srv)[0]
    assert first.dev_start is None and first.device_gap_s is None
    assert first.extend_device_s is not None
    srv.drain()
    assert all(r.dev_start is not None for r in _records(srv)[1:])


def test_torch_telemetry_step_span_is_the_rest_of_the_step(params):
    """``step_host_s`` plus the dispatch spans and completion waits of
    the launches account for the time inside ``step``."""
    srv = _server(params, inflight=2)
    h = srv.register(_cascade())
    for i, d in enumerate(sorted(DOCS)):
        h.submit(d, DOCS[d], arrival=float(i))
    outside, steps = 0.0, 0
    while srv.pending():
        t = time.perf_counter()
        srv.step()
        outside += time.perf_counter() - t
        steps += 1
    recs = _records(srv)
    assert all(r.step_host_s > 0.0 for r in recs)
    inside = sum(r.step_host_s + r.dispatch_s + r.device_s for r in recs)
    assert outside - steps * 5e-3 <= inside <= outside


def test_torch_telemetry_step_span_of_a_failed_launch_is_carried(params):
    """A step whose launch failed leaves its host time to the next ok
    record, so the bookkeeping read over ok records loses none of it."""
    srv = _server(params)
    be = srv.backends["proxy"]
    orig, calls = be.dispatch_group, []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            time.sleep(0.03)
            raise RuntimeError("injected")
        return orig(*a, **kw)

    be.dispatch_group = flaky
    h = srv.register(_cascade())
    for i, d in enumerate(sorted(DOCS)):
        h.submit(d, DOCS[d], arrival=float(i))
    srv.step()
    failed = srv.telemetry.launches.items()[-1]
    assert not failed.ok and failed.step_host_s == 0.0
    while not _records(srv):
        srv.step()
    assert _records(srv)[0].step_host_s >= 0.03
    srv.drain()


def test_torch_telemetry_future_request_id_names_its_spans(params):
    srv = _server(params, level="trace")
    _, futs = _drain(srv)
    spans = srv.telemetry.spans()
    assert [f.request_id for f in futs] == list(range(len(futs)))
    for f in futs:
        evs = spans[f.request_id]
        assert evs[0][2] == "submit" and evs[-1][2] == "resolved"
        assert srv.telemetry._doc_meta[f.request_id] == \
            (f.query_id, f.doc_id)


def test_torch_telemetry_chrome_trace_tracks(params):
    srv = _server(params, level="trace", clock=FakeClock())
    h = srv.register(_cascade())
    for i, d in enumerate(sorted(DOCS)):
        h.submit(d, DOCS[d], arrival=float(i))
    srv.step()
    gc.collect()
    srv.drain()
    evs = chrome_trace(srv.telemetry)["traceEvents"]
    names = {e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert {"backend:proxy", "host:gc", "device"} <= names
    recs = _records(srv)
    for r in recs:
        mine = [e for e in evs if e.get("args", {}).get("launch") == r.index
                and e.get("cat") in ("phase", "device")]
        assert sorted((e["cat"], e["name"].split()[0]) for e in mine) == \
            [("device", "decode"), ("device", "extend"),
             ("phase", "decode"), ("phase", "extend")]
    disp = [e for e in evs if e.get("cat") == "segment"
            and e["name"] == "dispatch"]
    phases = [e for e in evs if e.get("cat") == "phase"]
    assert len(phases) == 2 * len(disp)
    for d, (ext, dec) in zip(disp, zip(phases[::2], phases[1::2])):
        assert ext["ts"] == d["ts"] and dec["ts"] >= ext["ts"]
        assert dec["ts"] + dec["dur"] <= d["ts"] + d["dur"] + 1e-3
    gcs = [e for e in evs if e.get("cat") == "gc"]
    assert any(e["args"]["generation"] == 2 for e in gcs)


def test_torch_telemetry_stays_out_of_models_and_kernels():
    """The probes live at the stage-step boundary: nothing under
    ``models/`` or ``kernels/`` reaches the hub."""
    for sub in ("models", "kernels"):
        for path in (ROOT / "src" / "repro_torch" / sub).rglob("*.py"):
            text = path.read_text()
            assert "telemetry" not in text and "PhaseMarks" not in text, \
                path


@pytest.mark.cuda
def test_torch_telemetry_cuda_phase_windows_on_the_anchor_map():
    """On the card at ``trace``: every launch's phase windows are
    non-negative and ordered, and the anchor places them inside the
    host's enqueue and completion within 1 ms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = LM(_rcfg(), device="cuda")
    cuda_params = {"proxy": m.init(seed=1), "oracle": m.init(seed=2)}
    srv = _server(cuda_params, level="trace", plane="paged", device="cuda",
                  inflight=2)
    assert isinstance(srv.telemetry.clock, tmod.CudaClock)
    _drain(srv)
    recs = _records(srv)
    assert recs
    for r in recs:
        assert r.extend_device_s >= 0.0 and r.decode_device_s >= 0.0
        assert r.dev_start <= r.dev_split <= r.dev_end
        assert r.dev_start >= r.ts_enqueue - 1e-3
        assert r.dev_end <= r.ts_ready + 1e-3
    assert all(r.device_gap_s >= -1e-6 for r in recs[1:])
