"""The port's training path held against the JAX package on the CPU.

Reduced f32 configs (``get_reduced(arch, dtype="float32")``); weights
from the JAX package's init, turned into the port's layout by
``models.convert``; inputs from seeded numpy.  The JAX side runs
``CPU_TEST`` (naive attention) under ``jax.jit``; ``flash_attention_grad``
is held against ``jax.vjp`` of ``ops.attention(impl="xla")``, the
blocked attention the JAX package trains through.

Tolerances (f32): losses to 1e-5 relative (measured <= 1.6e-7); each
gradient leaf to ``GRAD_REL`` times its largest magnitude (measured <=
2.7e-6 over every arch: the two frameworks sum products in other
orders); the attention gradient to 1e-5 absolute on O(1) values;
optimizer steps to 1e-6 (a few f32 ulps of the unit-scale parameters).
Data batches and the schedule are equal bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.checkpoint import Checkpointer  # noqa: E402
from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.data.pipeline import (DataPipeline, ShardPlan,  # noqa: E402
                                       SyntheticLMTask)
from repro_torch.kernels import flash_attention as fla  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        jax_ndims, whisper_from_jax)
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.models.whisper import WhisperModel as TW  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         adamw_update, init_opt_state,
                                         schedule)
from repro_torch.train.train_loop import (TrainConfig,  # noqa: E402
                                          TrainDriver, make_train_step)
from repro_torch.tree import leaves, leaves_with_paths, tree_map  # noqa: E402

GRAD_REL = 2e-5
LOSS_REL = 1e-5


def _batch(cfg, B=2, S=24, seed=0):
    """tiny_batch of tests/test_models.py, from seeded numpy."""
    r = np.random.default_rng(seed)
    b = {"tokens": r.integers(9, cfg.vocab_size, (B, S)).astype(np.int32)}
    s_total = S
    if cfg.frontend_stub == "vision_patches":
        b["patch_emb"] = (0.02 * r.standard_normal(
            (B, cfg.frontend_len, cfg.d_model))).astype(np.float32)
        s_total += cfg.frontend_len
        b["positions3"] = np.broadcast_to(
            np.arange(s_total)[None, :, None], (B, s_total, 3)).astype(
                np.int32)
    if cfg.frontend_stub == "audio_frames":
        b["frame_emb"] = (0.02 * r.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    b["labels"] = r.integers(9, cfg.vocab_size, (B, s_total)).astype(
        np.int32)
    return b


def _pair(arch, **over):
    """(JAX model, port model, numpy -> port-tree converter)."""
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.models.model import LM
    from repro.models.runtime import CPU_TEST
    from repro.models.whisper import WhisperModel
    cfg = get_reduced(arch, dtype="float32", **over)
    trc = t_resolve(t_get_reduced(arch, dtype="float32", **over), tp=1)
    if cfg.family == "audio":
        jm = WhisperModel(resolve(cfg, tp=1), CPU_TEST)
        tm = TW(trc, device="cpu")
        conv = lambda t: whisper_from_jax(   # noqa: E731
            jax.tree.map(np.asarray, t), "cpu")
    else:
        jm = LM(resolve(cfg, tp=1), CPU_TEST)
        tm = TLM(trc, device="cpu")
        conv = lambda t: from_jax_params(    # noqa: E731
            jax.tree.map(np.asarray, t), trc, "cpu")
    return jm, tm, conv


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _grad_close(port_grads, jax_grads_port_layout):
    for (k, a), b in zip(leaves_with_paths(jax_grads_port_layout),
                         leaves(port_grads)):
        scale = float(a.abs().max())
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=GRAD_REL * scale + 1e-12, err_msg=k)


# ---------------------------------------------------------------------------
# loss and gradients, every ported arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    jm, tm, conv = _pair(arch)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = _batch(jm.rcfg.base)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    live = tree_map(lambda t: t.requires_grad_(True), conv(jp))
    tl = tm.loss(live, _t(batch))
    grads = torch.autograd.grad(tl, leaves(live))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_REL)
    _grad_close(grads, conv(jg))
    assert all(float(g.abs().sum()) > 0 for g in grads
               if g.dim() >= 2), "a weight matrix got no gradient"


def test_forward_logits_match_jax_with_vision_patches():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    jm, tm, conv = _pair("qwen2_vl_2b")
    jp = jm.init(jax.random.PRNGKey(2))
    batch = _batch(jm.rcfg.base, seed=3)
    jlog, _ = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tlog, aux = tm.forward(conv(jp), _t(batch))
    assert tlog.shape == jlog.shape and float(aux) == 0.0
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the attention gradient
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (B, Sq, Skv, Hq, Hkv, causal, window, q_offset, kv_len)
    "causal": (2, 16, 16, 4, 4, True, None, 0, None),
    "bidirectional": (2, 16, 16, 4, 4, False, None, 0, None),
    "window": (2, 24, 24, 4, 2, True, 5, 0, None),
    "gqa": (2, 16, 16, 8, 2, True, None, 0, None),
    "q_offset": (2, 8, 24, 4, 2, True, None, 16, None),
    "kv_len": (3, 16, 16, 4, 2, True, None, 0, [16, 9, 0]),
    "cross": (2, 4, 20, 4, 4, False, None, 0, None),
    "cross_kv_len": (2, 6, 20, 4, 1, False, None, 0, [20, 7]),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_grad_matches_jax(case):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    B, Sq, Skv, Hq, Hkv, causal, window, q_off, kl = ATTN_CASES[case]
    r = np.random.default_rng(11)
    q = r.standard_normal((B, Sq, Hq, 16)).astype(np.float32)
    k = r.standard_normal((B, Skv, Hkv, 16)).astype(np.float32)
    v = r.standard_normal((B, Skv, Hkv, 16)).astype(np.float32)
    dout = r.standard_normal((B, Sq, Hq, 16)).astype(np.float32)
    kv_len = None if kl is None else np.asarray(kl, np.int32)
    kw = dict(causal=causal, window=window, q_offset=q_off)
    jkl = None if kv_len is None else jnp.asarray(kv_len)
    jout, vjp = jax.vjp(lambda a, b, c: jops.attention(
        a, b, c, kv_len=jkl, impl="xla", **kw), q, k, v)
    jgrads = vjp(jnp.asarray(dout))
    tkl = None if kv_len is None else torch.from_numpy(kv_len)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = ops.attention(tq, tk, tv, kv_len=tkl, **kw)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    for name, a, b in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")
    # query blocks of one row give the same gradient as one block
    direct = fla.flash_attention_grad(
        tq.detach(), tk.detach(), tv.detach(), out.detach(),
        torch.from_numpy(dout), kv_len=tkl, **kw)
    old = fla.GRAD_BLOCK_ELEMS
    try:
        fla.GRAD_BLOCK_ELEMS = 1
        blocked = fla.flash_attention_grad(
            tq.detach(), tk.detach(), tv.detach(), out.detach(),
            torch.from_numpy(dout), kv_len=tkl, **kw)
    finally:
        fla.GRAD_BLOCK_ELEMS = old
    for a, b in zip(direct, blocked):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    if kl is not None and 0 in kl:
        row = kl.index(0)
        assert torch.equal(grads[0][row], torch.zeros_like(grads[0][row]))


def test_attention_without_grad_records_nothing():
    """Serving calls (no grad) take the plain call, not the Function."""
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    k = torch.randn(1, 4, 2, 8)
    with torch.no_grad():
        assert ops.attention(q, k, k).grad_fn is None
    assert ops.attention(q.detach(), k, k).grad_fn is None
    assert ops.attention(q, k, k).grad_fn is not None


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("oc", [
    OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=120),
    OptimizerConfig(lr=3e-4, warmup_steps=0, total_steps=7,
                    min_lr_frac=0.0),
    OptimizerConfig(lr=1.0, warmup_steps=200, total_steps=10_000)],
    ids=["example", "no-warmup", "default"])
def test_schedule_bitwise_matches_jax(oc):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.train.optimizer import OptimizerConfig as JOC
    from repro.train.optimizer import schedule as jschedule
    joc = JOC(**dataclasses.asdict(oc))
    for s in (0, 1, 2, 5, 9, 10, 11, 57, 119, 120, 121, 199, 200, 201,
              5000, 9999, 10_000, 20_000):
        j = np.asarray(jschedule(joc, jnp.asarray(s, jnp.int32).astype(
            jnp.float32)))
        t = schedule(oc, torch.tensor(s, dtype=torch.int32))
        assert t.dtype == torch.float32
        assert t.numpy().tobytes() == j.tobytes(), (s, float(t), float(j))


def _opt_pair(arch, seed, **over):
    jax = pytest.importorskip("jax")
    jm, tm, conv = _pair(arch, **over)
    jp = jm.init(jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)
    jg = jax.tree.map(lambda a: r.standard_normal(a.shape).astype(
        np.float32) * 0.01, jp)
    return jm, tm, conv, jp, jg


def test_adamw_update_matches_jax():
    """Two AdamW steps (the second with clipping) on the reduced llama's
    tree: params and moments equal the JAX package's."""
    jax = pytest.importorskip("jax")
    from repro.train.optimizer import OptimizerConfig as JOC
    from repro.train.optimizer import adamw_update as jadamw
    from repro.train.optimizer import init_opt_state as jinit
    jm, tm, conv, jp, jg = _opt_pair("llama3_2_1b", 4)
    oc = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                         grad_clip=0.5)
    joc = JOC(**dataclasses.asdict(oc))
    js = jinit(jp)
    tp, ts = conv(jp), init_opt_state(conv(jp))
    nd = jax_ndims(tp, tm.rcfg)
    for scale in (1.0, 100.0):
        g = jax.tree.map(lambda a: a * scale, jg)
        jp, js, jmet = jadamw(joc, jp, g, js)
        tp, ts, tmet = adamw_update(oc, tp, conv(g), ts, nd)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-6)
        assert float(tmet["lr"]) == float(jmet["lr"])
    assert int(ts.step) == int(js.step) == 2
    for mine, ref in ((tp, conv(jp)), (ts.mu, conv(js.mu)),
                      (ts.nu, conv(js.nu))):
        for (k, a), b in zip(leaves_with_paths(ref), leaves(mine)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6,
                                       rtol=1e-6, err_msg=k)


def test_weight_decay_follows_jax_stacking():
    """The reference decays leaves of ndim >= 2 in ITS layout: a stacked
    layer's norm scale [R, d] is decayed, a tail layer's and
    ``final_norm``'s [d] are not.  Reduced gemma3 cut to 8 layers: six
    stacked (R = 1), two in the tail.  With zero gradients one step moves
    exactly the decayed leaves, by ``lr * wd * p``; the port's steps
    equal the JAX package's."""
    jax = pytest.importorskip("jax")
    from repro.train.optimizer import OptimizerConfig as JOC
    from repro.train.optimizer import adamw_update as jadamw
    from repro.train.optimizer import init_opt_state as jinit
    jm, tm, conv, jp, _ = _opt_pair("gemma3_27b", 5, num_layers=8)
    oc = OptimizerConfig(lr=1e-3, warmup_steps=0, weight_decay=0.1)
    tp = conv(jp)
    nd = jax_ndims(tp, tm.rcfg)
    assert nd["final_norm"]["scale"] == 1
    assert all(nd["layers"][i]["norm1"]["scale"] == 2 for i in range(6))
    assert all(nd["layers"][i]["attn"]["q_norm"]["scale"] == 2
               for i in range(6))
    assert all(nd["layers"][i]["norm1"]["scale"] == 1 for i in (6, 7))
    zeros = jax.tree.map(np.zeros_like, jp)
    jp2, _, _ = jadamw(JOC(**dataclasses.asdict(oc)), jp, zeros, jinit(jp))
    tp2, _, _ = adamw_update(oc, tp, conv(zeros), init_opt_state(tp), nd)
    decayed = np.float32(1.0) - np.float32(1e-3) * (np.float32(0.1) * 1.0)
    assert float(tp2["layers"][0]["norm1"]["scale"][0]) == pytest.approx(
        float(decayed), abs=1e-7)
    assert torch.equal(tp2["final_norm"]["scale"],
                       torch.ones_like(tp2["final_norm"]["scale"]))
    assert torch.equal(tp2["layers"][7]["norm1"]["scale"],
                       torch.ones_like(tp2["layers"][7]["norm1"]["scale"]))
    for (k, a), b in zip(leaves_with_paths(conv(jp2)), leaves(tp2)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    # the leaf's own ndim (a plain copy of the reference rule) would
    # decay no 1-d stage leaf: 1e-4 away from the reference
    own = conv(jp)
    tp3, _, _ = adamw_update(oc, own, conv(zeros), init_opt_state(tp),
                             tree_map(lambda t: t.dim(), own))
    assert float(tp3["layers"][0]["norm1"]["scale"][0]) == 1.0


# ---------------------------------------------------------------------------
# train step and driver
# ---------------------------------------------------------------------------

def _tiny(seed=0):
    jm, tm, conv = _pair("llama3_2_1b", vocab_size=512, num_layers=2)
    jax = pytest.importorskip("jax")
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, tm, conv, jp


def test_grad_accumulation_matches_full_batch():
    _, tm, conv, jp = _tiny(0)
    task = SyntheticLMTask(vocab_size=512, seq_len=32)
    batch = task.batch(0, 0, 0, 8)
    out = {}
    for n in (1, 2):
        params = conv(jp)
        step = make_train_step(tm, None, TrainConfig(accum_steps=n))
        out[n] = step(params, init_opt_state(params), batch)
    (p1, _, m1), (p2, _, m2) = out[1], out[2]
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-4)
    for a, b in zip(leaves(p1), leaves(p2)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_train_driver_losses_match_jax():
    """Six driver steps on both packages from the same weights and data
    stream: every step's loss within 1e-5 relative."""
    jax = pytest.importorskip("jax")
    from repro.data.pipeline import DataPipeline as JDP
    from repro.data.pipeline import ShardPlan as JSP
    from repro.data.pipeline import SyntheticLMTask as JTask
    from repro.train.optimizer import OptimizerConfig as JOC
    from repro.train.optimizer import init_opt_state as jinit
    from repro.train.train_loop import TrainConfig as JTC
    from repro.train.train_loop import TrainDriver as JDriver
    from repro.train.train_loop import make_train_step as jmake
    jm, tm, conv, jp = _tiny(1)
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=6)
    jstep = jax.jit(jmake(jm, None, JTC(opt=JOC(**oc))))
    jpipe = JDP(JTask(vocab_size=512, seq_len=32), JSP(n_shards=2,
                                                        n_hosts=1),
                host=0, batch_per_shard=4)
    _, _, jh = JDriver(jstep, log_every=1, log_fn=lambda s: None).run(
        jp, jinit(jp), iter(jpipe), 6)
    tstep = make_train_step(tm, None, TrainConfig(
        opt=OptimizerConfig(**oc)))
    tpipe = DataPipeline(SyntheticLMTask(vocab_size=512, seq_len=32),
                         ShardPlan(n_shards=2, n_hosts=1), host=0,
                         batch_per_shard=4)
    params = conv(jp)
    _, _, th = TrainDriver(tstep, log_every=1, log_fn=lambda s: None).run(
        params, init_opt_state(params), iter(tpipe), 6)
    assert [s for s, _ in th] == [s for s, _ in jh] == list(range(6))
    np.testing.assert_allclose([l for _, l in th], [l for _, l in jh],
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_train_restart_from_checkpoint_is_seamless(tmp_path):
    """Train 6 steps straight == train 3, crash, restore, train 3 more."""
    _, tm, conv, jp = _tiny(2)
    step = make_train_step(tm, None, TrainConfig())
    task = SyntheticLMTask(vocab_size=512, seq_len=32)
    plan = ShardPlan(n_shards=2, n_hosts=1)

    def fresh_iter():
        return iter(DataPipeline(task, plan, host=0, batch_per_shard=4))

    quiet = dict(log_every=100, log_fn=lambda s: None)
    pA = conv(jp)
    pA, _, _ = TrainDriver(step, checkpointer=Checkpointer(
        str(tmp_path / "a"), keep=5), ckpt_every=3, **quiet).run(
            pA, init_opt_state(pA), fresh_iter(), 6)
    ck = Checkpointer(str(tmp_path / "b"), keep=5)
    drv = TrainDriver(step, checkpointer=ck, ckpt_every=3, **quiet)
    pB = conv(jp)
    drv.run(pB, init_opt_state(pB), fresh_iter(), 3)
    like = conv(jp)
    restored = ck.restore(3, {"params": like, "opt": init_opt_state(like)})
    assert int(restored["opt"].step) == 3
    it2 = fresh_iter()
    for _ in range(3):
        next(it2)
    pC, _, _ = drv.run(restored["params"], restored["opt"], it2, 6,
                       start_step=3)
    for a, b in zip(leaves(pA), leaves(pC)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    latest = drv.restore_latest(like, init_opt_state(like))
    assert latest[2] == 6


def test_checkpoint_keep_n_and_atomicity(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.arange(8.0)})
    ck.wait()
    assert ck.steps() == [3, 4]
    assert all(os.path.exists(os.path.join(d, f"step_{s:08d}.done"))
               for s in (3, 4))
    # a step directory without its commit marker is not a checkpoint
    os.makedirs(os.path.join(d, "step_00000009"))
    assert ck.latest_step() == 4


def test_checkpoint_roundtrip_bitwise_with_bf16(tmp_path):
    """bf16 leaves stored as uint16 bits, int32 and f32 as themselves;
    sharded leaves reassembled; restored bitwise into the like tree."""
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((8, 6), generator=g).to(torch.bfloat16),
            "layers": [{"s": torch.randn((5,), generator=g)}],
            "step": torch.tensor(7, dtype=torch.int32)}
    ck = Checkpointer(str(tmp_path), shards_per_leaf=4)
    ck.save(1, tree)
    ck.wait()
    import json
    with open(os.path.join(str(tmp_path), "step_00000001",
                           "MANIFEST.json")) as f:
        man = json.load(f)
    assert man["w"]["dtype"] == "bfloat16" and man["w"]["stored"] == \
        "uint16" and man["w"]["shards"] == 4
    back = ck.restore(1, tree_map(torch.zeros_like, tree))
    for a, b in zip(leaves(tree), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_data_pipeline_and_failover_match_jax():
    from repro.data.pipeline import DataPipeline as JDP
    from repro.data.pipeline import ShardPlan as JSP
    from repro.data.pipeline import SyntheticLMTask as JTask
    plan, jplan = ShardPlan(8, 4, 2, seed=3), JSP(8, 4, 2, seed=3)
    for h in range(4):
        for dead in ((), (2,), (1, 3)):
            assert plan.shards_for_host(h, dead) == \
                jplan.shards_for_host(h, dead)
    mine = DataPipeline(SyntheticLMTask(300, 20), plan, host=0,
                        batch_per_shard=3, seed=5)
    ref = JDP(JTask(300, 20), jplan, host=0, batch_per_shard=3, seed=5)
    for _ in range(3):
        a, b = next(mine), next(ref)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    mine, ref = mine.with_failures([1, 2]), ref.with_failures([1, 2])
    assert mine.step == ref.step == 3
    for _ in range(2):
        a, b = next(mine), next(ref)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_two_steps_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--steps", "2", "--batch", "4", "--seq",
            "32", "--ckpt_dir", ck]
    train.main(argv)
    out = capsys.readouterr().out
    assert "step 0 loss" in out and "checkpoints: [2]" in out
    train.main(["--steps", "3"] + argv[:2] + argv[4:])
    assert "resumed from checkpoint step 2" in capsys.readouterr().out


def test_launch_train_whisper_lacks_frame_emb(tmp_path):
    """The reference's launcher builds a WhisperModel for the audio family
    but its data pipeline yields only tokens and labels: the first step
    raises ``KeyError: 'frame_emb'`` (kept for parity, ROADMAP Queue 3)."""
    from repro_torch.launch import train
    with pytest.raises(KeyError, match="frame_emb"):
        train.main(["--arch", "whisper-base", "--device", "cpu", "--steps",
                    "1", "--batch", "2", "--seq", "8", "--ckpt_dir",
                    str(tmp_path)])
