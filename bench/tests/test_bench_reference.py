"""The plain reference against the program's path at reduced sizes:
answers, routing and $ agree, and the control (the reference through
float8) fails the same limits."""
import pytest

torch = pytest.importorskip("torch")

import time  # noqa: E402

import _bench_tiny  # noqa: E402
from bench.harness.check import (control_path, path_numbers,  # noqa: E402
                                 sample_docs, stage_logits)
from bench.harness.core import Run, run_cell  # noqa: E402

@pytest.fixture(autouse=True)
def _one_thread():
    with _bench_tiny.one_thread():
        yield


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return request.param


@pytest.mark.parametrize("config", ["qwen2vl-phi35moe", "qwen3-minitron"])
def test_bench_reference_agrees_with_the_port(device, config):
    cell = _bench_tiny.tiny_cell(config)
    out = run_cell(cell, 2**32 + 17, 2.0, False, device,
                   time.perf_counter(), check_imports=False)
    checks = out["checks"]
    assert out["correct"], checks
    assert out["attempted"] > 0 and out["failed"] == 0
    assert checks["billing_mismatch"]["value"] == 0
    assert checks["routing_gap"]["value"] == 0.0
    # f32 on both sides: the gap is rounding
    assert checks["margin_err"]["value"] < 1e-4


def test_bench_reference_oracle_draw_agrees_with_the_port():
    cell = _bench_tiny.tiny_cell("qwen2vl-phi35moe", oracle_docs=6)
    checks = _bench_tiny.drained_checks(cell, 2**32 + 19)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    # f32 on both sides: the median over the oracle's answers is rounding
    assert checks["oracle_margin_p50"]["value"] < 1e-4


def test_bench_reference_control_fails(device):
    cell = _bench_tiny.tiny_cell("qwen2vl-phi35moe")
    run = Run(cell, 23, 1.0, False, device, time.perf_counter())
    run.build()
    # the first backlog, drained: the same documents however fast the host
    run.start_loop()
    run.drain()
    run.ctx.t_open, run.ctx.t_close = 0.0, float("inf")
    run.collect()
    sample = sample_docs(run.ctx.docs, 23, 12)
    assert {r.exit_stage for r in sample} == {0, 1, 2}
    last = [len(run.stages[r.doc.tenant]) - 1 for r in sample]
    ref = stage_logits(cell, run.params, sample, last)
    ctl = stage_logits(cell, run.params, sample, last, "fp8")
    worst = 0.0
    for i, r in enumerate(sample):
        stages = run.stages[r.doc.tenant]
        port_m, _ = path_numbers(stages, r.exit_stage, r.pred, r.conf,
                                 ref[i])
        assert port_m < cell.serve["limits"]["margin_err"]
        e, p, c = control_path(stages, ctl[i])
        worst = max(worst, path_numbers(stages, e, p, c, ref[i])[0])
    assert worst > 10 * cell.serve["limits"]["margin_err"]
