"""A model's mathematics comes from its configuration's reference family.

The default family gives the weights and reference logits that the
benchmark gave before families existed (digests recorded from that code
at tiny sizes, on one thread); a family added as a new file only is
found by the configuration's ``"reference"`` key and drives the
weights, the check and the work counts; an unknown name fails at load.
"""
import pytest

torch = pytest.importorskip("torch")

import hashlib  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import time  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

import _bench_tiny  # noqa: E402
from bench.harness import readers  # noqa: E402
from bench.harness.core import run_cell  # noqa: E402
from bench.harness.spec import (DEFAULT_FAMILY, load_benchmark,  # noqa: E402
                                load_cell, load_family)
from bench.harness.trace import Op  # noqa: E402
from bench.reference.cascade import stage_table  # noqa: E402
from bench.reference.layers import Seq  # noqa: E402
from bench.work.formulas import DocStep, launch_model_flops  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    with _bench_tiny.one_thread():
        yield


# sha256 (first 16 hex digits) of the tiny models' weights, seed 7, and of
# their class logits over two fixed sequences, from the code before the
# families (bench/harness/weights.py, bench/reference/model.py)
WEIGHTS = {
    ("qwen3-minitron", "proxy", "float32"): "d3af4b928ce17505",
    ("qwen3-minitron", "proxy", "bfloat16"): "1c3226dc90284a75",
    ("qwen3-minitron", "oracle", "float32"): "d81bec5da7126025",
    ("qwen3-minitron", "oracle", "bfloat16"): "ee207d0f1e7b547e",
    ("qwen2vl-phi35moe", "proxy", "float32"): "d81bec5da7126025",
    ("qwen2vl-phi35moe", "proxy", "bfloat16"): "ee207d0f1e7b547e",
    ("qwen2vl-phi35moe", "oracle", "float32"): "be8400557128f742",
    ("qwen2vl-phi35moe", "oracle", "bfloat16"): "2e307bf312e929ba",
}
LOGITS = {
    ("qwen3-minitron", "proxy", "f32"): "2897e41812461699",
    ("qwen3-minitron", "proxy", "fp8"): "af4d297c6dcf77dd",
    ("qwen3-minitron", "oracle", "f32"): "cf564e2890d45676",
    ("qwen3-minitron", "oracle", "fp8"): "c6aa6c7729c1e05d",
    ("qwen2vl-phi35moe", "proxy", "f32"): "ce789893e13e92f3",
    ("qwen2vl-phi35moe", "proxy", "fp8"): "87d86fdebcc226d6",
    ("qwen2vl-phi35moe", "oracle", "f32"): "1885545cee343633",
    ("qwen2vl-phi35moe", "oracle", "fp8"): "47bff30c81a9fc31",
    ("qwen2vl-phi35moe", "oracle", "router_bf16"): "bf771328177711bc",
}


def _digest_tree(t, h) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            h.update(k.encode())
            _digest_tree(t[k], h)
    elif isinstance(t, list):
        for x in t:
            _digest_tree(x, h)
    else:
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())


def _spec_and_family(config, model, dtype="float32"):
    cfg = _bench_tiny.tiny_config(config)
    entry = cfg["models"][model]
    return (dict(entry["port"], dtype=dtype),
            load_family(entry.get("reference", DEFAULT_FAMILY)))


@pytest.mark.parametrize("key", sorted(WEIGHTS), ids="-".join)
def test_bench_family_default_weights_as_before(key):
    spec, fam = _spec_and_family(*key)
    h = hashlib.sha256()
    _digest_tree(fam.make_params(spec, 7, torch.device("cpu")), h)
    assert h.hexdigest()[:16] == WEIGHTS[key]


@pytest.mark.parametrize("key", sorted(LOGITS), ids="-".join)
def test_bench_family_default_logits_as_before(key):
    config, model, precision = key
    spec, fam = _spec_and_family(config, model)
    params = fam.make_params(spec, 7, torch.device("cpu"))
    rng = np.random.default_rng(5)
    seqs = []
    for n, pad in ((37, 64), (20, 32)):
        toks = rng.integers(16, 512, size=n + 3).tolist()
        seqs.append(Seq(toks, [(0, n // 2, 32), (n // 2, n, pad)], n))
    lg = fam.class_logits(spec, params, seqs, [8, 9], precision)
    assert hashlib.sha256(lg.numpy().tobytes()).hexdigest()[:16] == \
        LOGITS[key]


TOY = '''"""A toy family: the default block with its embedding made at twice
the scale, and work counts of its own."""
from bench.reference.families import gqa

CALLS = []


def make_params(spec, seed, device):
    CALLS.append("make_params")
    params = gqa.make_params(spec, seed, device)
    params["embed"]["table"].mul_(2.0)
    return params


def class_logits(spec, params, seqs, classes, precision="f32"):
    CALLS.append("class_logits")
    return gqa.class_logits(spec, params, seqs, classes, precision)


def looks(spec):
    return ()


def active_params(spec):
    return 1000.0


def head_params(spec):
    return 10.0


def attention_layers(spec):
    return 1


def extend_call(spec, docs):
    return float(sum(n for _, n in docs)), 0.0


def decode_call(spec, kvs):
    return float(len(list(kvs))), 0.0
'''


def test_bench_family_added_as_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(_bench_tiny.ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    bench = json.loads((_bench_tiny.ROOT / "BENCHMARK.json").read_text())
    (root / "bench" / "reference" / "families" / "toy.py").write_text(TOY)
    cfg = _bench_tiny.tiny_config("qwen3-minitron")
    # the proxy answers at every document's first stage, so the check
    # reads its logits in any window that resolves a document
    cfg["models"]["proxy"]["reference"] = "toy"
    (root / "bench" / "configs" / "toy-pair.json").write_text(
        json.dumps(cfg))
    (root / "bench" / "traffic" / "tiny-mix.json").write_text(
        json.dumps(_bench_tiny.tiny_traffic()))
    (root / "bench" / "workloads" / "toy-pair.tiny-mix.json").write_text(
        json.dumps(_bench_tiny.tiny_serve()))
    bench["configs"].append({"name": "toy-pair", "source": "test",
                             "file": "bench/configs/toy-pair.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "toy-pair.tiny-mix",
                               "config": "toy-pair", "traffic": "tiny-mix",
                               "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell(load_benchmark(root), "toy-pair.tiny-mix",
                     root / "bench")
    toy = cell.family("proxy")
    assert toy.__file__ == str(
        (root / "bench/reference/families/toy.py").resolve())
    assert cell.family("oracle").__file__ == str(
        (root / "bench/reference/families/gqa.py").resolve())
    out = run_cell(cell, 9, 2.0, False, "cpu", time.perf_counter(),
                   check_imports=False)
    # the program served the toy's weights, the check read its logits
    assert out["correct"], out["checks"]
    assert toy.CALLS[0] == "make_params" and "class_logits" in toy.CALLS

    # the work counts: the whole step's and the readers', from the toy
    spec = cell.config["models"]["proxy"]["port"]
    # 7 tokens through 2 x 1000 parameters, 5 + 2 attention operations,
    # 3 head rows of 2 x 10
    assert launch_model_flops(toy, spec, [DocStep(0, 5, 5, 2)]) == \
        7 * 2000 + 7 + 3 * 20
    rec = SimpleNamespace(model="proxy", op_id="sur_court", cached_len=0,
                          f_len=16)
    ctx = SimpleNamespace(
        cell=cell, specs={m: e["port"]
                          for m, e in cell.config["models"].items()},
        stages=[stage_table(t["stages"], cell.serve["oracle_op"])
                for t in cell.serve["tenants"]],
        launches=[{"rec": rec, "docs": [(40, 0, 0)]}],
        ops=[Op("toy_kernel", 0.0, 1.0)], t_open=0.0, trace_from=0.0)
    # stage 0 reads 16 new tokens, then the 8 words of "is any lower
    # court ..." over 10 + 1.. keys
    n_op = 8
    assert readers.mfu(ctx) == pytest.approx(
        100.0 * ((16 + n_op) * 2000 + (16 + n_op) + (1 + n_op) * 20)
        / 989e12, rel=1e-12)
    assert readers.roofline(ctx, ["toy_kernel"], "extend") == \
        pytest.approx(100.0 * 16 / 989e12, rel=1e-12)
    # nothing that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())


def test_bench_family_unknown_name_fails_at_load(tmp_path):
    bench_dir = tmp_path / "bench"
    for d in ("configs", "traffic", "workloads"):
        (bench_dir / d).mkdir(parents=True)
    cfg = _bench_tiny.tiny_config("qwen3-minitron")
    cfg["models"]["proxy"]["reference"] = "no-such-block"
    (bench_dir / "configs" / "c.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "t.json").write_text(
        json.dumps(_bench_tiny.tiny_traffic()))
    (bench_dir / "workloads" / "c.t.json").write_text(
        json.dumps(_bench_tiny.tiny_serve()))
    bench = {"workloads": [{"name": "c.t", "config": "c", "traffic": "t",
                            "chips": 1}],
             "end_to_end": [], "per_layer": []}
    with pytest.raises(ValueError, match="no reference family "
                                         "'no-such-block'"):
        load_cell(bench, "c.t", bench_dir)
