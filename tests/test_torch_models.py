"""The port's dense LM held against the JAX ``LM`` on the same weights.

Weights come from the JAX package's own init on the serving tests' recipe
(reduced llama3.2-1b, f32, vocab 512, 2 layers, ``tp=1``) and are turned
into the port's per-layer layout by ``models.convert.from_jax_params``.
Token inputs are seeded numpy.  Logits agree to f32 ``atol=rtol=1e-5``
(the two frameworks sum matrix products in different orders); arena
contents (post-RoPE keys, values) to the same tolerance through
``states_from_jax``.  The KV-window undo log is checked bitwise inside
the port.  The JAX side runs ``CPU_TEST`` (naive attention) and
``CPU_KERNEL_TEST`` (Pallas interpret, blocks of 16).  The reduced qwen3
(per-head q/k RMS norm before RoPE) is held to the same tolerance on
prefill, extend and decode, dense and paged.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        states_from_jax)
from repro_torch.models.model import LM as TLM  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _rcfg():
    return t_resolve(t_get_reduced("llama3_2_1b", dtype="float32",
                                   vocab_size=512, num_layers=2), tp=1)


@pytest.fixture(scope="module")
def pair():
    """(jax LMs by runtime, jax params, port LM, port params)."""
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.models.model import LM
    from repro.models.runtime import CPU_KERNEL_TEST, CPU_TEST
    rcfg = resolve(get_reduced("llama3_2_1b", dtype="float32",
                               vocab_size=512, num_layers=2), tp=1)
    jms = {"naive": LM(rcfg, CPU_TEST),
           "pallas_interpret": LM(rcfg, CPU_KERNEL_TEST)}
    jp = jms["naive"].init(jax.random.PRNGKey(1))
    tm = TLM(_rcfg(), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.rcfg, "cpu")
    return jms, jp, tm, tp


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tok(seed, shape):
    return np.random.default_rng(seed).integers(16, 512, shape).astype(
        np.int32)


def _states_close(jstates, tstates, rcfg):
    import jax
    conv = states_from_jax(jax.tree.map(np.asarray, jstates), rcfg, "cpu")
    assert len(conv) == len(tstates)
    for a, b in zip(conv, tstates):
        for n in ("k", "v"):
            np.testing.assert_allclose(b[n].numpy(), a[n].numpy(), **TOL)


def test_from_jax_params_unstacks_layers(pair):
    jms, jp, tm, tp = pair
    assert len(tp["layers"]) == 2
    for r in range(2):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                tp["layers"][r]["attn"][name].numpy(),
                np.asarray(jp["stages"][0]["attn"][name])[r])
        np.testing.assert_array_equal(
            tp["layers"][r]["mlp"]["w2"].numpy(),
            np.asarray(jp["stages"][0]["mlp"]["w2"])[r])
    np.testing.assert_array_equal(tp["embed"]["table"].numpy(),
                                  np.asarray(jp["embed"]["table"]))


@pytest.mark.parametrize("impl", ["naive", "pallas_interpret"])
def test_dense_prefill_extend_decode_match_jax(pair, impl):
    import jax.numpy as jnp
    jms, jp, tm, tp = pair
    jm = jms[impl]
    toks = _tok(0, (3, 32))
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, s_alloc=80)
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, s_alloc=80)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    # fraction extension with per-row true lengths (bucket PAD masked)
    more = _tok(1, (3, 16))
    kv_len = np.asarray([48, 41, 35], np.int32)
    jl, js = jm.extend(jp, {"tokens": jnp.asarray(more)}, js, q_offset=32,
                       kv_len=jnp.asarray(kv_len))
    tl, ts = tm.extend(tp, {"tokens": torch.from_numpy(more)}, ts,
                       q_offset=32, kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for step in range(3):
        pos = kv_len + step
        tok = _tok(2 + step, (3,))
        jl, js = jm.decode_step(jp, jnp.asarray(tok), js, jnp.asarray(pos))
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok), ts,
                                torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _states_close(js, ts, tm.rcfg)


def test_prefill_without_cache_matches_jax(pair):
    import jax.numpy as jnp
    jms, jp, tm, tp = pair
    toks = _tok(3, (2, 24))
    jl, _ = jms["naive"].prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert ts[0]["k"].shape == (2, 24, tm.rcfg.padded_kv_heads,
                                tm.rcfg.head_dim)


@pytest.mark.parametrize("impl", ["naive", "pallas_interpret"])
def test_paged_extend_decode_match_jax(pair, impl):
    """``slots=`` mode over a shared arena (scratch row included) against
    the JAX LM's paged mode, arena contents included."""
    import jax.numpy as jnp
    jms, jp, tm, tp = pair
    jm = jms[impl]
    n_rows, s_alloc = 6, 96
    slots = np.asarray([4, 1, 5], np.int32)          # 5 = scratch row
    js = jm.init_states(n_rows, s_alloc)
    ts = tm.init_states(n_rows, s_alloc)
    toks = _tok(4, (3, 32))
    kv_len = np.asarray([32, 27, 1], np.int32)
    jl, js = jm.extend(jp, {"tokens": jnp.asarray(toks)}, js, q_offset=0,
                       kv_len=jnp.asarray(kv_len), slots=jnp.asarray(slots))
    tl, ts = tm.extend(tp, {"tokens": torch.from_numpy(toks)}, ts,
                       q_offset=0, kv_len=torch.from_numpy(kv_len),
                       slots=torch.from_numpy(slots))
    np.testing.assert_allclose(_np(tl)[:2], _np(jl)[:2], **TOL)
    more = _tok(5, (3, 16))
    kv_len2 = np.asarray([48, 40, 1], np.int32)
    jl, js = jm.extend(jp, {"tokens": jnp.asarray(more)}, js, q_offset=32,
                       kv_len=jnp.asarray(kv_len2), slots=jnp.asarray(slots))
    tl, ts = tm.extend(tp, {"tokens": torch.from_numpy(more)}, ts,
                       q_offset=32, kv_len=torch.from_numpy(kv_len2),
                       slots=torch.from_numpy(slots))
    np.testing.assert_allclose(_np(tl)[:2], _np(jl)[:2], **TOL)
    pos = np.asarray([48, 40, 1], np.int32)
    tok = _tok(6, (3,))
    jl, js = jm.decode_step(jp, jnp.asarray(tok), js, jnp.asarray(pos),
                            slots=jnp.asarray(slots))
    tl, ts = tm.decode_step(tp, torch.from_numpy(tok), ts,
                            torch.from_numpy(pos),
                            slots=torch.from_numpy(slots))
    np.testing.assert_allclose(_np(tl)[:2], _np(jl)[:2], **TOL)
    # document rows (not scratch, whose duplicate writes are unordered)
    import jax
    conv = states_from_jax(jax.tree.map(np.asarray, js), tm.rcfg, "cpu")
    for a, b in zip(conv, ts):
        for n in ("k", "v"):
            np.testing.assert_allclose(b[n][:5].numpy(), a[n][:5].numpy(),
                                       **TOL)


def test_paged_equals_dense_bitwise_in_port():
    """slots= over an arena == dense mode over the same rows, bitwise."""
    tm = TLM(_rcfg(), device="cpu")
    tp = tm.init(seed=3)
    slots = torch.tensor([2, 0], dtype=torch.int32)
    arena = tm.init_states(4, 64)
    dense = tm.init_states(2, 64)
    toks = torch.from_numpy(_tok(7, (2, 20)))
    kv_len = torch.tensor([20, 15], dtype=torch.int32)
    pl, _ = tm.extend(tp, {"tokens": toks}, arena, 0, kv_len=kv_len,
                      slots=slots)
    dl, _ = tm.extend(tp, {"tokens": toks}, dense, 0, kv_len=kv_len)
    assert torch.equal(pl, dl)
    pos = torch.tensor([20, 15], dtype=torch.int32)
    tok = torch.tensor([30, 31])
    pl, _ = tm.decode_step(tp, tok, arena, pos, slots=slots)
    dl, _ = tm.decode_step(tp, tok, dense, pos)
    assert torch.equal(pl, dl)
    for a, d in zip(arena, dense):
        for n in ("k", "v"):
            assert torch.equal(a[n][slots.long()], d[n])


def test_kv_window_undo_log_restores_rows_bitwise():
    """take_kv_window -> in-place decode -> put_kv_window leaves every
    addressed row bitwise as it was."""
    tm = TLM(_rcfg(), device="cpu")
    tp = tm.init(seed=4)
    arena = tm.init_states(5, 64)
    slots = torch.tensor([3, 1, 4], dtype=torch.int32)
    toks = torch.from_numpy(_tok(8, (3, 32)))
    kv_true = torch.tensor([13, 32, 1], dtype=torch.int32)
    tm.extend(tp, {"tokens": toks}, arena, 0, kv_len=kv_true, slots=slots)
    before = [{n: t.clone() for n, t in layer.items()} for layer in arena]
    saved = tm.take_kv_window(arena, slots, kv_true, 5)
    for t in range(5):
        tm.decode_step(tp, torch.full((3,), 40 + t), arena, kv_true + t,
                       slots=slots)
    changed = any(not torch.equal(a[n], b[n])
                  for a, b in zip(arena, before) for n in ("k", "v"))
    assert changed                               # decode did dirty the rows
    tm.put_kv_window(arena, slots, kv_true, 5, saved)
    for a, b in zip(arena, before):
        for n in ("k", "v"):
            assert torch.equal(a[n], b[n])


def test_take_put_states_roundtrip():
    tm = TLM(_rcfg(), device="cpu")
    arena = tm.init_states(4, 16)
    for layer in arena:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=torch.Generator()
                                .manual_seed(0)))
    idx = torch.tensor([3, 0], dtype=torch.int32)
    sub = tm.take_states(arena, idx)
    assert sub[0]["k"].shape[0] == 2
    fresh = tm.init_states(4, 16)
    tm.put_states(fresh, idx, sub)
    for a, f in zip(arena, fresh):
        assert torch.equal(a["k"][idx.long()], f["k"][idx.long()])
    assert tm.state_shapes(1, 16)[0]["k"] == (
        (1, 16, tm.rcfg.padded_kv_heads, tm.rcfg.head_dim), torch.float32)


def test_lm_init_is_seeded():
    tm = TLM(_rcfg(), device="cpu")
    a, b, c = tm.init(seed=5), tm.init(seed=5), tm.init(seed=6)
    assert torch.equal(a["embed"]["table"], b["embed"]["table"])
    assert not torch.equal(a["embed"]["table"], c["embed"]["table"])
    assert a["layers"][1]["mlp"]["w1"].dtype == torch.float32


def test_unported_configs_raise():
    import dataclasses
    from repro_torch.config import ATTN_LOCAL
    cfg = t_get_reduced("llama3_2_1b", dtype="float32", vocab_size=512,
                        num_layers=2)
    with pytest.raises(NotImplementedError):
        TLM(t_resolve(dataclasses.replace(cfg, block_pattern=(ATTN_LOCAL,)),
                      tp=1), device="cpu")
    with pytest.raises(NotImplementedError):
        TLM(t_resolve(dataclasses.replace(cfg, mrope_sections=(4, 6, 6)),
                      tp=1), device="cpu")


def _qwen_rcfg():
    return t_resolve(t_get_reduced("qwen3_1_7b", dtype="float32",
                                   vocab_size=512, num_layers=2), tp=1)


@pytest.fixture(scope="module")
def qwen_pair():
    """Reduced qwen3 (per-head q/k RMS norm): JAX LMs by runtime, JAX
    params, port LM, converted port params."""
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.models.model import LM
    from repro.models.runtime import CPU_KERNEL_TEST, CPU_TEST
    rcfg = resolve(get_reduced("qwen3_1_7b", dtype="float32",
                               vocab_size=512, num_layers=2), tp=1)
    jms = {"naive": LM(rcfg, CPU_TEST),
           "pallas_interpret": LM(rcfg, CPU_KERNEL_TEST)}
    jp = jms["naive"].init(jax.random.PRNGKey(2))
    tm = TLM(_qwen_rcfg(), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.rcfg, "cpu")
    return jms, jp, tm, tp


def test_qwen3_params_carry_qk_norm(qwen_pair):
    jms, jp, tm, tp = qwen_pair
    assert tm.rcfg.base.qk_norm
    for r in range(2):
        for name in ("q_norm", "k_norm"):
            np.testing.assert_array_equal(
                tp["layers"][r]["attn"][name]["scale"].numpy(),
                np.asarray(jp["stages"][0]["attn"][name]["scale"])[r])
    own = tm.init(seed=2)["layers"][0]["attn"]
    assert own["q_norm"]["scale"].shape == (tm.rcfg.head_dim,)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("impl", ["naive", "pallas_interpret"])
def test_qwen3_qk_norm_prefill_extend_decode_match_jax(qwen_pair, impl,
                                                       paged):
    """qk-norm on every mode: prefill (dense) or a first extend into an
    arena (paged), a fraction extend, then decode steps."""
    import jax.numpy as jnp
    jms, jp, tm, tp = qwen_pair
    jm = jms[impl]
    toks = _tok(11, (3, 32))
    kv0 = np.asarray([32, 29, 17], np.int32)
    pk = {}
    if paged:
        slots = np.asarray([2, 0, 3], np.int32)
        js, ts = jm.init_states(5, 96), tm.init_states(5, 96)
        pk = dict(j=dict(slots=jnp.asarray(slots)),
                  t=dict(slots=torch.from_numpy(slots)))
        jl, js = jm.extend(jp, {"tokens": jnp.asarray(toks)}, js,
                           q_offset=0, kv_len=jnp.asarray(kv0), **pk["j"])
        tl, ts = tm.extend(tp, {"tokens": torch.from_numpy(toks)}, ts,
                           q_offset=0, kv_len=torch.from_numpy(kv0),
                           **pk["t"])
    else:
        pk = dict(j={}, t={})
        jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, s_alloc=96)
        tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                            s_alloc=96)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    more = _tok(12, (3, 16))
    kv_len = np.asarray([48, 40, 33], np.int32)
    jl, js = jm.extend(jp, {"tokens": jnp.asarray(more)}, js, q_offset=32,
                       kv_len=jnp.asarray(kv_len), **pk["j"])
    tl, ts = tm.extend(tp, {"tokens": torch.from_numpy(more)}, ts,
                       q_offset=32, kv_len=torch.from_numpy(kv_len),
                       **pk["t"])
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for step in range(2):
        pos = kv_len + step
        tok = _tok(13 + step, (3,))
        jl, js = jm.decode_step(jp, jnp.asarray(tok), js, jnp.asarray(pos),
                                **pk["j"])
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok), ts,
                                torch.from_numpy(pos), **pk["t"])
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _states_close(js, ts, tm.rcfg)


@pytest.mark.cuda
def test_cuda_lm_matches_cpu_plain():
    """The LM on the card (hand-written kernels) against the same weights
    on the CPU (plain versions): f32 logits to 1e-4 (cuBLAS and the
    kernels sum in other orders than the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cpu = TLM(_rcfg(), device="cpu")
    gpu = TLM(_rcfg(), device="cuda")
    cp = cpu.init(seed=9)
    gp = {"embed": {"table": cp["embed"]["table"].cuda()},
          "final_norm": {"scale": cp["final_norm"]["scale"].cuda()},
          "layers": [{k: {n: t.cuda() for n, t in v.items()}
                      for k, v in layer.items()} for layer in cp["layers"]]}
    toks = torch.from_numpy(_tok(10, (3, 40)))
    slots = torch.tensor([1, 3, 4], dtype=torch.int32)
    kv_len = torch.tensor([40, 33, 7], dtype=torch.int32)
    outs = []
    for m, p, dev in ((cpu, cp, "cpu"), (gpu, gp, "cuda")):
        arena = m.init_states(5, 64)
        l1, _ = m.extend(p, {"tokens": toks.to(dev)}, arena, 0,
                         kv_len=kv_len.to(dev), slots=slots.to(dev))
        l2, _ = m.decode_step(p, torch.tensor([20, 21, 22], device=dev),
                              arena, kv_len.to(dev), slots=slots.to(dev))
        outs.append((l1.cpu(), l2.cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)
