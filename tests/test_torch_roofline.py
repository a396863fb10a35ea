"""The port's roofline (``launch/roofline.py``) and dry-run
(``launch/dryrun.py``) held against the JAX package and against their own
formulas.

- Parity: ``logical_param_counts``, ``model_flops`` and
  ``decode_launch_bytes`` equal JAX's for every arch and supported shape;
  ``analytic_memory_floor`` equals JAX's at ``tp=16`` with 512-row tiles.
- ``analyze``: the cases of ``tests/test_launch.py``, at peaks passed in
  (no card here), with ``memory_s <= memory_eager_s``; the collective
  term per mesh axis.
- Kernel formulas: each kernel's ``work`` equals the bytes and
  operations behind its bound in ``PERF.md`` (the expressions
  ``chip_smoke.py`` used before they moved into the kernel modules), at
  the shapes of that table; on ``meta`` tensors ``kernels.ops`` reports
  that work and returns the kernel's output shape.
- The dry-run, as subprocesses (the default process group stays out of
  this process): the collective counter over a known list of
  collectives on a fake world; whole cells (``llama3_2_1b decode_32k`` at
  ``n_rep_override`` 1 and 2 and at full depth, the R = 1, 2
  extrapolation equal to the full count); a FAILED cell with its
  exception, alone and under ``--all``.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import SHAPES  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fla  # noqa: E402
from repro_torch.kernels import meta as kmeta  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import relevance_score as rel  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
H100 = rf.peaks_for("NVIDIA H100 80GB HBM3", 3.35e12)
TIMEOUT = 120


@pytest.fixture(scope="module")
def jroof():
    pytest.importorskip("jax")
    from repro.launch import roofline
    return roofline


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_jax(jroof, arch):
    assert rf.logical_param_counts(arch) == jroof.logical_param_counts(arch)
    for shape in get_config(arch).supported_shapes:
        assert rf.model_flops(arch, shape) == jroof.model_flops(arch, shape)
        for devices in (256, 512):
            assert rf.analytic_memory_floor(
                arch, shape, devices, tp=16, block_q=512, block_kv=512) \
                == jroof.analytic_memory_floor(arch, shape, devices)


def test_decode_launch_bytes_equal_jax(jroof):
    for args in ((2.47e9, 1.3e8, 1), (1e6, 0.0, 17), (3, 5, 0)):
        assert rf.decode_launch_bytes(*args) \
            == jroof.decode_launch_bytes(*args)


def test_floor_defaults_are_the_cuda_tiles():
    """Default tiles: the tensor-core tile at the model's head_dim; the
    floor moves with them and with ``tp``."""
    assert fla.tile(64) == (64, 64) and fla.tile(128) == (128, 64) \
        and fla.tile(256) == (128, 32)
    a = rf.analytic_memory_floor("llama3_2_1b", "train_4k", 256)
    assert a == rf.analytic_memory_floor("llama3_2_1b", "train_4k", 256,
                                         tp=16, block_q=64, block_kv=64)
    assert a != rf.analytic_memory_floor("llama3_2_1b", "train_4k", 256,
                                         tp=16, block_q=512, block_kv=512)
    assert rf.analytic_memory_floor("llama3_2_1b", "decode_32k", 1, tp=1,
                                    n_rep=1) \
        < rf.analytic_memory_floor("llama3_2_1b", "decode_32k", 1, tp=1)


def test_analyze_handles_failed_and_good_cells():
    assert rf.analyze({"ok": False}, H100) is None
    cell = {"ok": True, "arch": "llama3_2_1b", "shape": "train_4k",
            "mesh": "single", "devices": 256,
            "flops": 3.3e13, "bytes_accessed": 4.1e12,
            "collective_bytes": {"all-reduce": 1e10}}
    row = rf.analyze(cell, H100)
    assert row.dominant in ("compute", "memory", "collective")
    assert 0 < row.useful_ratio < 2
    assert row.memory_s <= row.memory_eager_s
    assert row.collective_s == 1e10 / H100.nvlink_bytes_per_s
    assert row.compute_s == 3.3e13 / H100.bf16_flops
    # per mesh axis: the pod hop over the inter-node rate, f32 FLOPs over
    # the f32 rate
    row = rf.analyze({**cell, "mesh": "multi", "devices": 512,
                      "flops_f32": 1e12,
                      "collective_bytes_by_axis": {
                          "pod": {"all-reduce": 4e9},
                          "model": {"all-gather": 9e9}}}, H100)
    assert row.collective_s == 4e9 / 50e9 + 9e9 / 450e9
    assert row.compute_s == 3.2e13 / 989e12 + 1e12 / 67e12


def test_report_and_main_name_failed_cells(tmp_path):
    good = {"ok": True, "arch": "llama3_2_1b", "shape": "decode_32k",
            "mesh": "single", "devices": 256, "flops": 3.4e9,
            "bytes_accessed": 1.5e9, "collective_bytes": {}}
    bad = {"ok": False, "arch": "whisper_base", "shape": "decode_32k",
           "mesh": "single", "error": "NotImplementedError: whisper"}
    path = tmp_path / "r.json"
    path.write_text(json.dumps([good, bad]))
    text = rf.main(["--results", str(path), "--card",
                    "NVIDIA H100 80GB HBM3", "--hbm", "3.35e12",
                    "--out", str(tmp_path / "t.md")])
    assert text.startswith(rf.HEADER)
    assert "| whisper_base | decode_32k | single | FAILED: " \
        "NotImplementedError: whisper |" in text
    assert "**memory**" in text
    assert (tmp_path / "t.md").read_text() == text


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_batch_cut_reaches_the_case_and_the_roofline(shape):
    """A cell with its global batch cut (a world-1 cell on one card):
    ``build_case``'s stand-ins and the model carry the cut batch, and the
    roofline's model FLOPs and memory floor count it."""
    from repro_torch.distributed.compat import MeshShape
    from repro_torch.launch.specs import build_case

    mesh = MeshShape((1, 1), ("data", "model"))
    case = build_case("llama3_2_1b", shape, mesh, n_rep_override=1,
                      device="meta", batch_override=4)
    assert {t.shape[0] for t in _leaves(case.args[1:])} == {4}
    assert case.model.rcfg.base.num_layers == 1
    full = rf.model_flops("llama3_2_1b", shape, 1)
    assert rf.model_flops("llama3_2_1b", shape, 1, batch=4) * \
        SHAPES[shape].global_batch == full * 4
    kw = dict(tp=1, n_rep=1)
    assert rf.analytic_memory_floor("llama3_2_1b", shape, 1, batch=4, **kw) \
        < rf.analytic_memory_floor("llama3_2_1b", shape, 1, **kw)
    assert rf.analytic_memory_floor(
        "llama3_2_1b", shape, 1, batch=SHAPES[shape].global_batch, **kw) \
        == rf.analytic_memory_floor("llama3_2_1b", shape, 1, **kw)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_peaks_come_from_one_table():
    with pytest.raises(KeyError):
        rf.peaks_for("Some Other Card", 1e12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            rf.card_peaks()
    assert rf.bound_ms(3.35e9, 1.0, H100) == (1.0, "bytes")
    assert rf.bound_ms(1.0, 67e9, H100, f32=True) == (1.0, "operations")
    # the TPU's constants are gone from the port and the smoke run
    for path in [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
                 ROOT / "chip_smoke.py"]:
        text = path.read_text()
        for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
            assert name not in text, (path, name)


# ---------------------------------------------------------------------------
# kernel formulas: work() == the bound of PERF.md's kernel table
# ---------------------------------------------------------------------------

def _old_decode(B, Hq, Hkv, Dh, kl, q_item=2, kv_item=2, rows=False):
    keys = float(sum(kl))
    return (keys * Hkv * Dh * kv_item * 2 + 2 * B * Hq * Dh * q_item
            + (2 if rows else 1) * B * 4, 4.0 * Hq * Dh * keys)


def _old_extend(B, Sq, Hq, Hkv, Dh, q_off, kv_valid, kv_len):
    kl = np.minimum(np.asarray(kv_len), kv_valid)
    qpos = q_off + np.arange(Sq)
    pairs = float(sum(np.minimum(qpos + 1, k).sum() for k in kl))
    return (float(kl.sum()) * Hkv * Dh * 2 * 2 + 2 * B * Sq * Hq * Dh * 2
            + 2 * B * 4, 4.0 * Hq * Dh * pairs)


def _old_windowed(B, Sq, Hq, Hkv, Dh, q_off, W, kl):
    qpos = q_off + np.arange(Sq)
    lo = np.maximum(qpos - W + 1, 0)
    pairs = float(sum(np.clip(np.minimum(qpos + 1, n) - lo, 0, None).sum()
                      for n in kl))
    keys = float(sum(n - max(q_off - W + 1, 0) for n in kl))
    return (keys * Hkv * Dh * 2 * 2 + 2 * B * Sq * Hq * Dh * 2 + 4 * B,
            4.0 * Hq * Dh * pairs)


MAIN_DECODE = [1024, 900, 512, 700, 300, 256, 1, 1]
MAIN_EXTEND = [512, 480, 400, 300, 200, 129, 1, 1]


@pytest.mark.parametrize("Hq,Hkv,Dh", [(32, 8, 64), (16, 8, 128),
                                       (12, 2, 128), (32, 8, 128),
                                       (48, 8, 128)])
def test_main_path_work_equals_the_bounds(Hq, Hkv, Dh):
    assert dec.work(8, Hq, Hkv, Dh, 1088, kv_len=MAIN_DECODE, rows=True) \
        == _old_decode(8, Hq, Hkv, Dh, MAIN_DECODE, rows=True)
    assert fla.work(8, 384, Hq, Hkv, Dh, 512, q_offset=128,
                    kv_len=MAIN_EXTEND, rows=True) \
        == _old_extend(8, 384, Hq, Hkv, Dh, 128, 512, MAIN_EXTEND)


@pytest.mark.parametrize("Hq,Hkv,Dh,W,B,cases", [
    (32, 16, 128, 1024, 4, [(2048, 0, [2048, 1900, 1500, 1100]),
                            (512, 1536, [2048, 2000, 1800, 1537])]),
    (10, 1, 256, 2048, 2, [(4096, 0, [4096, 3000]),
                           (512, 3584, [4096, 3700])]),
])
def test_windowed_work_equals_the_bounds(Hq, Hkv, Dh, W, B, cases):
    for Sq, q_off, kl in cases:
        assert fla.work(B, Sq, Hq, Hkv, Dh, 2 * W, window=W, q_offset=q_off,
                        kv_len=kl) \
            == _old_windowed(B, Sq, Hq, Hkv, Dh, q_off, W, kl)
    for kl in ([W] * 8, [W, 1, 300, W - 1, 512, 777, 64, 1000]):
        assert dec.work(8, Hq, Hkv, Dh, W, kv_len=kl) \
            == _old_decode(8, Hq, Hkv, Dh, kl)


def test_other_work_equals_the_bounds():
    # whisper-base: bidirectional, no kv_len
    for B, Sq in ((2, 1536), (8, 1), (8, 64)):
        n = B * Sq * 8 * 64
        assert fla.work(B, Sq, 8, 8, 64, 1536, causal=False) \
            == (2 * (2 * n + 2 * B * 1536 * 8 * 64),
                4.0 * B * 8 * 64 * Sq * 1536)
    # the LSE mode over one 32768-key shard at llama3.2-1b's heads
    s = 32768
    assert dec.work(1, 32, 8, 64, s, kv_len=[s], lse=True) \
        == (s * 8 * 64 * 2 * 2 + 32 * 64 * 2 + 32 * 66 * 4 + 4,
            4.0 * 32 * 64 * s)
    # the f32 cache at recurrentgemma's heads
    assert dec.work(8, 10, 1, 256, 2048, kv_len=[2048] * 8, q_itemsize=4,
                    kv_itemsize=4) \
        == _old_decode(8, 10, 1, 256, [2048] * 8, q_item=4, kv_item=4)
    # relevance: chunks of T rows, lengths past T clamped
    lens = [3, 40, 64, 70, 0]
    n = float(sum(min(x, 64) for x in lens))
    assert rel.work(5, 64, 256, lens) == (n * 256 * 4 + 12 * 5 + 4 * 256,
                                          2.0 * n * 256)


def test_meta_tensors_report_the_kernel_work():
    seen = []

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    with kmeta.observe(lambda *a: seen.append(a)):
        q, k = meta(2, 96, 8, 64), meta(2, 160, 2, 64)
        out = ops.attention(q, k, k, q_offset=64,
                            kv_len=meta(2, dtype=torch.int32))
        assert out.shape == q.shape and out.is_meta
        d = ops.decode_attention(meta(3, 8, 128), meta(3, 500, 4, 128),
                                 meta(3, 500, 4, 128),
                                 meta(3, dtype=torch.int32))
        assert d.shape == (3, 8, 128) and d.dtype == torch.bfloat16
        lse = ops.decode_attention_lse(
            meta(3, 8, 128), meta(3, 500, 4, 128, dtype=torch.float32),
            meta(3, 500, 4, 128, dtype=torch.float32),
            meta(3, dtype=torch.int32))
        assert lse.shape == (3, 8, 130) and lse.dtype == torch.float32
        # a CPU tensor still takes the plain version, and reports nothing
        qc = torch.zeros(1, 4, 8, 64)
        ops.attention(qc, qc, qc)
    fb, ff = fla.work(2, 96, 8, 2, 64, 160, q_offset=64)
    assert seen[0] == ("flash_attention", fb + 2 * 4, ff, torch.bfloat16)
    assert seen[1] == ("decode_attention",
                       *dec.work(3, 8, 4, 128, 500), torch.bfloat16)
    assert seen[2] == ("decode_attention_lse",
                       *dec.work(3, 8, 4, 128, 500, kv_itemsize=4,
                                 lse=True), torch.float32)
    assert len(seen) == 3


def test_mrope_runs_on_meta_tensors():
    """qwen2-vl's cells failed on ``meta``: M-RoPE built its section ids
    with ``repeat_interleave`` over a tensor of counts, which needs their
    values; it now builds them from the config's tuple."""
    from repro_torch.models.layers import apply_mrope
    x = torch.empty(2, 5, 4, 128, dtype=torch.bfloat16, device="meta")
    pos = torch.empty(2, 5, 3, dtype=torch.int32, device="meta")
    out = apply_mrope(x, pos, 1e6, (16, 24, 24))
    assert out.is_meta and out.shape == x.shape and out.dtype == x.dtype


# ---------------------------------------------------------------------------
# the dry-run, in subprocesses
# ---------------------------------------------------------------------------

def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def _dryrun(tmp_path, name, *args):
    out = tmp_path / f"{name}.json"
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(out)], env=_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True), out


def _collectives_probe() -> dict:
    """Run in a subprocess: a known list of collectives on a fake world
    of 8 (a 2 x 4 ``data`` x ``model`` mesh) under a ``StepCounter``."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.compat import axis_group, make_mesh
    from repro_torch.launch import dryrun
    dryrun.join_fake_world(8)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    groups = {mesh.get_group(a).group_name: a for a in ("data", "model")}
    x = torch.empty(1024, dtype=torch.float32, device="meta")
    y = torch.empty(64, 8, dtype=torch.bfloat16, device="meta")
    counter = dryrun.StepCounter(groups, (x, y))
    with counter:
        torch.distributed.all_reduce(x, group=axis_group(mesh, "model"))
        col.all_gather(y, axis_group(mesh, "model"), 0)
        col.reduce_scatter(x, axis_group(mesh, "data"), 0)
        data = axis_group(mesh, "data")
        torch.distributed.send(y, torch.distributed.get_global_rank(data, 1),
                               group=data)
        torch.distributed.recv(y.clone(),
                               torch.distributed.get_global_rank(data, 1),
                               group=data)
    return {"kinds": counter.collective, "axes": counter.collective_by_axis}


def test_collective_counter_per_kind_and_axis():
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__)), "--collectives"],
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    x, y = 1024 * 4, 64 * 8 * 2
    want_axes = {
        # all-reduce: operand + output; the gather: 4 parts and the input;
        # the reduce-scatter's all-to-all: its 2 x 512 send and receive;
        # a hop to the next rank: one send and one receive of y
        "model": {"all-reduce": 2 * x, "all-gather": 5 * y},
        "data": {"all-to-all": 2 * x, "collective-permute": 2 * y},
    }
    assert got["axes"] == want_axes
    assert got["kinds"] == {k: v for a in want_axes.values()
                            for k, v in a.items()}


def test_dryrun_cells(tmp_path):
    """llama3.2-1b decode_32k on the 16 x 16 mesh at full depth and cut
    to one and two layers, and whisper's FAILED cell, subprocesses at
    once."""
    procs = {
        "full": _dryrun(tmp_path, "full", "--arch", "llama3_2_1b", "--shape",
                        "decode_32k", "--mesh", "single"),
        "one": _dryrun(tmp_path, "one", "--arch", "llama3_2_1b", "--shape",
                       "decode_32k", "--mesh", "single", "--n-rep", "1"),
        "two": _dryrun(tmp_path, "two", "--arch", "llama3_2_1b", "--shape",
                       "decode_32k", "--mesh", "single", "--n-rep", "2"),
        "whisper": _dryrun(tmp_path, "whisper", "--arch", "whisper_base",
                           "--shape", "decode_32k", "--mesh", "single"),
        # --all over a filter: each cell in a worker process
        "all": _dryrun(tmp_path, "all", "--all", "--arch", "whisper_base",
                       "--shape", "decode_32k,prefill_32k", "--mesh",
                       "single"),
    }
    res, rcs = {}, {}
    for name, (proc, out) in procs.items():
        try:
            _, err = proc.communicate(timeout=TIMEOUT)
        finally:
            proc.kill()
        rcs[name] = proc.returncode
        assert out.exists(), err[-2000:]
        res[name] = json.loads(out.read_text())
    assert not torch.distributed.is_initialized()
    full, one, two, bad = (res[k] for k in ("full", "one", "two",
                                             "whisper"))
    assert rcs == {"full": 0, "one": 0, "two": 0, "whisper": 1, "all": 1}
    # a FAILED cell names its exception, alone and under --all
    assert bad["ok"] is False
    assert bad["error"].startswith("NotImplementedError: whisper-base")
    assert rf.analyze(bad, H100) is None
    assert [(r["shape"], r["ok"]) for r in res["all"]] == [
        ("prefill_32k", False), ("decode_32k", False)]
    assert res["all"][1] == bad
    # the full count and the extrapolation of the R = 1, 2 counts agree
    # exactly (the JAX package's method), collectives per axis included
    cfg = get_config("llama3_2_1b")
    reps = cfg.num_layers // len(cfg.block_pattern)

    def extrapolated(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            return {k: extrapolated(a[k], b[k]) for k in a}
        return a + (reps - 1) * (b - a)
    for key in ("flops", "flops_f32", "bytes_accessed", "collective_bytes",
                "collective_bytes_by_axis"):
        assert extrapolated(one[key], two[key]) == full[key], key
    assert full["devices"] == 256 and full["tp"] == 16
    # the decode kernel once a layer, at one rank's shapes: batch 128 /
    # 16, 2 of the 32 query heads, 1 of the 16 (padded) KV heads
    kern = full["kernels"]["decode_attention"]
    assert kern["calls"] == cfg.num_layers
    nb, nf = dec.work(8, 2, 1, 64, SHAPES["decode_32k"].seq_len)
    assert (kern["bytes"], kern["flops"]) == (cfg.num_layers * nb,
                                              cfg.num_layers * nf)
    assert one["n_rep"] == 1 and one["kernels"]["decode_attention"] == {
        "calls": 1, "bytes": nb, "flops": nf}
    assert 0 < one["flops"] < full["flops"]
    # memory: this rank's 1/16 of the weights and of every KV cache
    mem = full["memory"]
    kv = cfg.num_layers * 2 * 8 * SHAPES["decode_32k"].seq_len * 64 * 2
    assert kv < mem["argument_bytes"] < kv + 2.0 * 1.3e9 / 16
    assert 0 < mem["output_bytes"] <= mem["temp_bytes"]
    assert set(full["collective_bytes_by_axis"]) == {"model"}
    row = rf.analyze(full, H100)
    assert row.dominant == "memory"
    assert row.memory_s <= row.memory_eager_s


if __name__ == "__main__" and sys.argv[1:] == ["--collectives"]:
    print(json.dumps(_collectives_probe()))
