"""A cell, a configuration, a traffic mix and a per-layer metric are
added as files and entries only: the harness finds them by name and runs
the new cell with no edit to a file that was there."""
import pytest

pytest.importorskip("torch")

import json  # noqa: E402
import shutil  # noqa: E402
import time  # noqa: E402

import _bench_tiny  # noqa: E402
from bench.harness.core import run_cell  # noqa: E402
from bench.harness.spec import load_benchmark, load_cell  # noqa: E402

@pytest.fixture(autouse=True)
def _one_thread():
    with _bench_tiny.one_thread():
        yield


METRIC = '''"""Launches completed in the window."""


def read(ctx):
    return float(len(ctx.records)) if ctx.records else None
'''


def test_bench_added_files_are_found_and_run(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(_bench_tiny.ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    bench = json.loads((_bench_tiny.ROOT / "BENCHMARK.json").read_text())
    # the new files
    cfg = _bench_tiny.tiny_config("qwen3-minitron")
    cfg["name"] = "tiny-pair"
    (root / "bench" / "configs" / "tiny-pair.json").write_text(
        json.dumps(cfg))
    (root / "bench" / "traffic" / "tiny-mix.json").write_text(
        json.dumps(_bench_tiny.tiny_traffic()))
    (root / "bench" / "workloads" / "tiny-pair.tiny-mix.json").write_text(
        json.dumps(_bench_tiny.tiny_serve()))
    (root / "bench" / "metrics" / "launches.tiny.py").write_text(METRIC)
    # and their entries
    bench["configs"].append({"name": "tiny-pair", "source": "test",
                             "file": "bench/configs/tiny-pair.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-pair.tiny-mix",
                               "config": "tiny-pair", "traffic": "tiny-mix",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "docs_per_s":
            m["workloads"].append("tiny-pair.tiny-mix")
    bench["per_layer"].append({"name": "launches.tiny", "unit": "launches",
                               "better": "higher", "source":
                               "program_counter", "layer": "test",
                               "moves": "docs_per_s",
                               "workloads": ["tiny-pair.tiny-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell(load_benchmark(root), "tiny-pair.tiny-mix",
                     root / "bench")
    assert cell.config["name"] == "tiny-pair"
    assert [m["name"] for m in cell.end_to_end] == ["docs_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["launches.tiny"]
    e2e = run_cell(cell, 4, 2.0, False, "cpu", time.perf_counter(),
                   check_imports=False)
    assert e2e["correct"], e2e["checks"]
    assert set(e2e["metrics"]) == {"docs_per_s", "setup_s"}
    traced = run_cell(cell, 5, 2.0, True, "cpu", time.perf_counter(),
                      check_imports=False)
    assert traced["metrics"]["launches.tiny"]["value"] > 0
    # nothing that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())
