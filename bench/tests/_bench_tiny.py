"""A cell of the benchmark's shape at a size a CPU test run holds: the
configuration files' models cut to 2 layers of width 64 in float32,
documents of 16-100 tokens, windows of a second."""
import contextlib
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness.spec import Cell  # noqa: E402

TINY_MODEL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=64, vocab_size=512, dtype="float32")


@contextlib.contextmanager
def one_thread():
    """Run a tiny cell on one intra-op thread: the suite runs several
    workers on few cores, and tiny products on many threads each only
    contend."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def tiny_config(name: str) -> dict:
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                     .read_text())
    for m in cfg["models"].values():
        p = m["port"]
        p.update(TINY_MODEL)
        if p.get("mrope_sections"):
            p["mrope_sections"] = [2, 3, 3]
        if p.get("moe"):
            p["moe"] = dict(p["moe"], num_experts=4)
    cfg["tokenizer_vocab"] = 512
    return cfg


def tiny_traffic() -> dict:
    return {"backlog_per_tenant": 6, "block": 64,
            "length": {"median_tokens": 40, "sigma": 0.4, "min_tokens": 16,
                       "max_tokens": 100}}


def tiny_serve() -> dict:
    def stages(op1, t1):
        return {"stages": [
            {"model": "proxy", "op": "sur_court", "fraction": 0.25,
             "thresholds": [0.54, 0.54]},
            {"model": "proxy", "op": op1, "fraction": 1.0,
             "thresholds": [t1, t1]}]}
    return {"batch": 4, "inflight": 2, "docs": 300, "warm_seconds": 0.3,
            "init_slots": {"proxy": 8, "oracle": 8},
            "oracle_op": "o_orig",
            "policy": "largest_ready_group", "check_docs": 6,
            "limits": {"margin_err": 1e-4, "routing_gap": 1e-4},
            "tenants": [stages("o_orig", 0.53),
                        stages("sur_court", 0.53)]}


def tiny_cell(config: str = "qwen2vl-phi35moe", e2e=None,
              per_layer=(), oracle_docs: int = 0) -> Cell:
    """``oracle_docs``: the check's oracle draw (``check_oracle_docs``)
    and its ``oracle_margin_p50`` limit, as in a cell whose oracle
    answers most documents."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = [m for m in bench["end_to_end"] if e2e is None or m["name"] in e2e]
    serve = tiny_serve()
    if oracle_docs:
        serve["check_oracle_docs"] = oracle_docs
        serve["limits"]["oracle_margin_p50"] = 1e-4
    return Cell(name="tiny", entry={"name": "tiny", "chips": 1},
                config=tiny_config(config), traffic=tiny_traffic(),
                serve=serve, end_to_end=copy.deepcopy(e2e),
                per_layer=list(per_layer))


def drained_checks(cell: Cell, seed: int, n_docs: int = 60) -> dict:
    """The check's numbers over a closed loop run until ``n_docs``
    documents have resolved and then drained: a fixed amount of work, so
    the oracle draw is never short however slow the host."""
    import math
    import time

    from bench.harness.check import judge
    from bench.harness.core import Run
    run = Run(cell, seed, 1.0, False, "cpu", time.perf_counter())
    run.check_imports = False
    run.build()
    run.start_loop()
    while sum(r.t_done is not None for r in run.recs.values()) < n_docs:
        run.step()
    run.drain()
    run.ctx.t_open, run.ctx.t_close = 0.0, math.inf
    run.collect()
    return judge(run.ctx, run.params, cell)

