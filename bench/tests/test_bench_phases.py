"""The readers of the program's launch phases, padding counts and
collector pauses (``bench/harness/phases.py``) on synthetic records and
device operations with known answers."""
import random
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import _bench_tiny  # noqa: E402
from bench.harness.phases import (BusyIndex, end_residuals,  # noqa: E402
                                  phase_windows, window_busy_share)
from bench.harness.spec import reader  # noqa: E402
from bench.harness.trace import Op, busy_seconds  # noqa: E402

NEW = ("extend_dispatch_ms_per_launch.batch",
       "decode_dispatch_ms_per_launch.batch",
       "bookkeeping_ms_per_launch.batch",
       "extend_window_busy_share.batch", "decode_window_busy_share.batch",
       "padded_token_share.batch", "gc_pause_share.batch")


def _rec(**kw):
    base = dict(extend_dispatch_s=0.1, decode_dispatch_s=0.8,
                step_host_s=0.04, rows_computed=1000, tokens_real=200,
                gc_s=0.01, dev_start=None, dev_split=None, dev_end=None)
    base.update(kw)
    return SimpleNamespace(**base)


def _ctx(records, ops=None, launches=None, window=(0.0, 10.0)):
    return SimpleNamespace(records=records, ops=ops, launches=launches,
                           t_open=window[0], t_close=window[1],
                           window_s=window[1] - window[0])


def _read(name, ctx):
    return reader(name, _bench_tiny.ROOT / "bench")(ctx)


def test_bench_phases_span_and_counter_readers():
    recs = [_rec(), _rec(extend_dispatch_s=0.3, decode_dispatch_s=0.6,
                         step_host_s=0.06, rows_computed=3000,
                         tokens_real=600, gc_s=0.03)]
    ctx = _ctx(recs, window=(5.0, 9.0))
    assert _read(NEW[0], ctx) == pytest.approx(200.0)
    assert _read(NEW[1], ctx) == pytest.approx(700.0)
    assert _read(NEW[2], ctx) == pytest.approx(50.0)
    assert _read(NEW[5], ctx) == pytest.approx(100.0 * (1 - 800 / 4000))
    assert _read(NEW[6], ctx) == pytest.approx(100.0 * 0.04 / 4.0)


@pytest.mark.parametrize("name", NEW)
def test_bench_phases_reader_is_silent_without_the_fields(name):
    """A program that does not record a field (the parent of the change
    that added it), or a run without the profiler: the reader returns
    None, so the harness leaves the metric out."""
    bare = SimpleNamespace(batch=4, dispatch_s=1.0, device_s=0.1)
    launches = [{"rec": bare, "docs": []}]
    assert _read(name, _ctx([bare], ops=[Op("k", 0.0, 1.0)],
                            launches=launches)) is None
    assert _read(name, _ctx([], ops=None, launches=None)) is None


def test_bench_phases_window_busy_share_with_interleaved_windows():
    """Two launches whose windows interleave with each other's
    operations; the shares are busy seconds inside each phase's windows
    over the windows' seconds."""
    ops = [Op("a", 0.0, 1.0), Op("b", 1.5, 2.0), Op("c", 2.5, 3.0),
           Op("d", 3.2, 3.4), Op("e", 3.3, 4.0), Op("f", 6.0, 7.0)]
    recs = [_rec(dev_start=0.5, dev_split=2.0, dev_end=3.0),
            _rec(dev_start=1.8, dev_split=3.3, dev_end=7.0)]
    launches = [{"rec": r, "docs": []} for r in recs]
    ctx = _ctx(recs, ops=ops, launches=launches)
    # extend: [0.5, 2.0] busy 0.5 + 0.5; [1.8, 3.3] busy 0.2 + 0.5 + 0.1
    ext = (1.0 + 0.8) / (1.5 + 1.5)
    # decode: [2.0, 3.0] busy 0.5; [3.3, 7.0] busy 0.7 + 1.0
    dec = (0.5 + 1.7) / (1.0 + 3.7)
    assert window_busy_share(ctx, "extend") == pytest.approx(100 * ext)
    assert window_busy_share(ctx, "decode") == pytest.approx(100 * dec)
    assert _read(NEW[3], ctx) == pytest.approx(100 * ext)
    assert _read(NEW[4], ctx) == pytest.approx(100 * dec)


def test_bench_phases_busy_index_against_the_union():
    rng = random.Random(7)
    ops = []
    for _ in range(300):
        s = rng.uniform(0, 50)
        ops.append(Op("k", s, s + rng.uniform(0, 0.4)))
    ops.sort(key=lambda o: o.start)
    index = BusyIndex(ops)
    for _ in range(200):
        a = rng.uniform(-1, 51)
        b = a + rng.uniform(0, 5)
        assert index.busy(a, b) == pytest.approx(busy_seconds(ops, a, b),
                                                 abs=1e-9)


def test_bench_phases_end_events_pair_with_the_last_operation():
    """Each end event pairs with the last operation that ended before it;
    a copy that begins before the event and ends after it (an earlier
    launch's logits read back behind it) is passed over."""
    ops = [Op("x", 0.0, 1.0), Op("y", 2.0, 3.0),
           Op("Memcpy DtoH", 3.00005, 3.0009), Op("z", 5.0, 6.0)]
    wins = [(0.0, 0.5, 1.0002), (1.5, 2.5, 3.0001), (-2.0, -1.5, -1.0)]
    assert end_residuals(wins, ops) == [(1.0002, 1.0), (3.0001, 3.0)]


def test_bench_phases_windows_kept_unless_the_clocks_disagree():
    """Windows are used as the anchor maps them.  One end event recorded
    5 ms late (a host stall) leaves them so; stamps whose clock runs
    70 ppm fast (2.8 ms apart by the window's end, past 1 ms for most
    launches) are left out."""
    ops, recs = [], []
    for k in range(20):
        t = 1.0 + 2.0 * k
        ops += [Op("ext", t, t + 0.4), Op("dec", t + 0.6, t + 1.0)]
        # each end event 10 us after the launch's last operation
        recs.append(_rec(dev_start=t, dev_split=t + 0.5,
                         dev_end=t + 1.0 + (5e-3 if k == 7 else 1e-5)))
    launches = [{"rec": r, "docs": []} for r in recs]
    ctx = _ctx(recs, ops=ops, launches=launches, window=(0.0, 42.0))
    wins = phase_windows(ctx)
    assert wins[7] == (recs[7].dev_start, recs[7].dev_split,
                       recs[7].dev_end)
    assert window_busy_share(ctx, "extend") == pytest.approx(80.0)
    scale = 1.0 + 7e-5
    fast = [_rec(dev_start=r.dev_start * scale,
                 dev_split=r.dev_split * scale,
                 dev_end=(ops[2 * k + 1].end + 1e-5) * scale)
            for k, r in enumerate(recs)]
    ctx = _ctx(fast, ops=ops,
               launches=[{"rec": r, "docs": []} for r in fast],
               window=(0.0, 42.0))
    assert phase_windows(ctx) is None
    assert window_busy_share(ctx, "decode") is None
