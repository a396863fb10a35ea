"""The device trace's reductions: busy time, idle gaps and their host
labels, kernel classes."""
import pytest

pytest.importorskip("torch")

import time  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import _bench_tiny  # noqa: E402
from bench.harness.core import Run  # noqa: E402
from bench.harness.readers import kernel_seconds  # noqa: E402
from bench.harness.trace import (MARKER, Op, busy_seconds,  # noqa: E402
                                 gap_medians, kernel_class, labelled_gaps,
                                 place_ops)


class _Rec:
    ts_start, sched_s, ts_enqueue, dispatch_s = 0.0, 0.1, 0.2, 0.3
    ts_ready, device_s, wall_s = 1.0, 0.2, 1.2


def test_bench_trace_busy_and_gaps():
    ops = [Op("a", 0.05, 0.15), Op("b", 0.1, 0.2), Op("c", 0.6, 0.7)]
    assert busy_seconds(ops, 0.0, 1.0) == pytest.approx(0.25)
    assert busy_seconds(ops, 0.12, 0.65) == pytest.approx(0.13)
    gaps = labelled_gaps(ops, 0.0, 1.3, [_Rec()])
    assert [g[0] for g in gaps] == ["sched", "dispatch", "device_wait"]
    assert [g[1] for g in gaps] == pytest.approx([0.05, 0.4, 0.6])
    assert sum(g[1] for g in gaps) + busy_seconds(ops, 0, 1.3) == \
        pytest.approx(1.3)
    med = gap_medians(ops, 0.0, 1.3, [_Rec()])
    assert med["dispatch"] == (1, pytest.approx(0.4))
    assert labelled_gaps(ops, 0.0, 1.3, [])[0][0] == "harness"


@pytest.mark.parametrize("lost", [None, 0, -1])
def test_bench_trace_clocks_tied_by_the_markers(lost):
    # markers 50 s apart on both clocks; one operation 1 s after the open
    marks = [(MARKER, 1e6, 1e6 + 10), (MARKER, 51e6, 51e6 + 10)]
    ops = [("k", 2e6, 3e6), ("j", 4e6, 4.5e6)]
    if lost is not None:
        del marks[lost]
    placed = place_ops(marks + ops, 5.0, 55.0)
    assert [o.name for o in placed] == ["k", "j"]
    assert [(o.start, o.end) for o in placed] == [
        (pytest.approx(6.0), pytest.approx(7.0)),
        (pytest.approx(8.0), pytest.approx(8.5))]
    with pytest.raises(RuntimeError, match="0 marker kernels"):
        place_ops(ops, 5.0, 55.0)


def test_bench_trace_kernel_classes():
    assert kernel_class("void flash_attention_tc_kernel<128>(...)") == \
        "attention"
    assert kernel_class("decode_combine_kernel") == "attention"
    assert kernel_class("nvjet_tst_192x192_64x3_1x2_h_bz_coopB_NNN") == \
        "matmul"
    assert kernel_class("sm90_xmma_gemm_bf16bf16") == "matmul"
    assert kernel_class("at::native::vectorized_elementwise_kernel") == \
        "other"


def test_bench_trace_kernel_time_of_the_window_launches():
    """The rooflines' time is every named kernel from the trace's open
    marker on, whole: the work of launches dispatched before the window
    ran before it, and that of launches in flight at the close runs
    after it, inside the trace."""
    ctx = SimpleNamespace(trace_from=1.0, t_open=1.1, t_close=11.0, ops=[
        Op("flash_attention_tc_kernel", 0.5, 0.9),
        Op("flash_attention_tc_kernel", 1.2, 1.5),
        Op("vectorized_elementwise_kernel", 1.5, 1.6),
        Op("flash_attention_kernel", 10.8, 11.4)])
    assert kernel_seconds(ctx, ("flash_attention_tc_kernel",
                                "flash_attention_kernel")) == \
        pytest.approx(0.3 + 0.6)


def test_bench_trace_joins_every_launch_dispatched_in_the_window():
    with _bench_tiny.one_thread():
        cell = _bench_tiny.tiny_cell("qwen3-minitron")
        run = Run(cell, 7, 1.0, True, "cpu", time.perf_counter())
        run.check_imports = False    # the suite loads the JAX package too
        run.build()
        run.window()
    ctx = run.ctx
    recs = [r for r in run.server.telemetry.launches.items() if r.ok]
    sent = [r for r in recs if ctx.t_open <= r.ts_enqueue < ctx.t_close]
    assert ctx.unjoined == 0 and sent
    assert [l["rec"] for l in ctx.launches] == sent
    # the launches in flight at the close were completed after it
    assert any(r.ts_ready > ctx.t_close for r in sent)
    for l in ctx.launches:
        assert len(l["docs"]) == l["rec"].batch
