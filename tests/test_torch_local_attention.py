"""Sliding-window attention and gemma3 in the port, held against the JAX
``LM`` on the same weights.

The model is a reduced gemma3-27b (f32, vocab 512, d_model 128, 4/2
heads, head_dim 32, qk-norm, ``sqrt(d)`` embedding scale) at 8 layers:
one superblock of five local layers and one global, then the two-layer
local tail that ends the published 62-layer model.  Its window is 16, so
every sequence here is longer than the window and the ring caches wrap.
The JAX side runs ``CPU_TEST`` (naive attention) and ``CPU_KERNEL_TEST``
(Pallas interpret, blocks of 16).  Logits and the ring states (through
``states_from_jax``) agree to f32 ``atol=rtol=1e-5``, as for the dense
models in ``tests/test_torch_models.py``.  The JAX entry points run under
``jax.jit`` (one compile per shape instead of one per primitive).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import ATTN_FULL, ATTN_LOCAL  # noqa: E402
from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        states_from_jax)
from repro_torch.models.model import LM as TLM  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
WINDOW = 16
GEMMA = dict(dtype="float32", vocab_size=512, num_layers=8,
             sliding_window=WINDOW)
KINDS = (ATTN_LOCAL,) * 5 + (ATTN_FULL,) + (ATTN_LOCAL,) * 2


def _rcfg():
    return t_resolve(t_get_reduced("gemma3_27b", **GEMMA), tp=1)


@pytest.fixture(scope="module")
def pair():
    """(jax LMs by runtime, jax params, port LM, port params)."""
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.models.model import LM
    from repro.models.runtime import CPU_KERNEL_TEST, CPU_TEST
    rcfg = resolve(get_reduced("gemma3_27b", **GEMMA), tp=1)
    jms = {"naive": _Jitted(LM(rcfg, CPU_TEST)),
           "pallas_interpret": _Jitted(LM(rcfg, CPU_KERNEL_TEST))}
    jp = jax.jit(jms["naive"].lm.init)(jax.random.PRNGKey(3))
    tm = TLM(_rcfg(), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.rcfg, "cpu")
    return jms, jp, tm, tp


class _Jitted:
    """A JAX ``LM``'s entry points under ``jax.jit``."""

    def __init__(self, lm):
        import jax
        self.lm = lm
        self.init_states = lm.init_states
        self.prefill = jax.jit(lm.prefill, static_argnames=("s_alloc",))
        self.extend = jax.jit(lm.extend, static_argnames=("q_offset",))
        self.decode_step = jax.jit(lm.decode_step)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tok(seed, shape):
    return np.random.default_rng(seed).integers(16, 512, shape).astype(
        np.int32)


def _states_close(jstates, tstates, rcfg):
    import jax
    conv = states_from_jax(jax.tree.map(np.asarray, jstates), rcfg, "cpu")
    assert len(conv) == len(tstates) == len(KINDS)
    for a, b in zip(conv, tstates):
        for n in ("k", "v"):
            assert a[n].shape == b[n].shape
            np.testing.assert_allclose(b[n].numpy(), a[n].numpy(), **TOL)


def test_config_pattern_and_state_shapes():
    tm = TLM(_rcfg(), device="cpu")
    b = tm.rcfg.base
    assert tm.kinds == KINDS and b.embed_scale and b.qk_norm
    assert not tm.supports_paged_kv
    for s_alloc in (8, 16, 80):
        shapes = tm.state_shapes(3, s_alloc)
        states = tm.init_states(3, s_alloc)
        assert len(shapes) == len(states) == 8
        for kind, sh, st in zip(KINDS, shapes, states):
            want = min(WINDOW, s_alloc) if kind == ATTN_LOCAL else s_alloc
            for n in ("k", "v"):
                assert sh[n] == (tuple(st[n].shape), st[n].dtype)
                assert sh[n][0][1] == want


def test_from_jax_params_unstacks_pattern_and_tail(pair):
    """Repetition-major order: layer r*6 + p is ``stages[p][r]``, then
    the tail; every leaf carried across (qk-norm scales included)."""
    jms, jp, tm, tp = pair
    assert len(jp["stages"]) == 6 and len(jp["tail"]) == 2
    assert len(tp["layers"]) == 8
    for p in range(6):
        for name in ("wq", "wo"):
            np.testing.assert_array_equal(
                tp["layers"][p]["attn"][name].numpy(),
                np.asarray(jp["stages"][p]["attn"][name])[0])
        np.testing.assert_array_equal(
            tp["layers"][p]["attn"]["k_norm"]["scale"].numpy(),
            np.asarray(jp["stages"][p]["attn"]["k_norm"]["scale"])[0])
    for t in range(2):
        np.testing.assert_array_equal(
            tp["layers"][6 + t]["mlp"]["w1"].numpy(),
            np.asarray(jp["tail"][t]["mlp"]["w1"]))


@pytest.mark.parametrize("impl", ["naive", "pallas_interpret"])
def test_prefill_extend_decode_match_jax(pair, impl):
    """Prefill into preallocated rings (extend at ``q_offset`` 0, 48
    tokens over a 16-slot ring), a 32-token extend at ``q_offset`` 48
    (the masked ring path, with per-row true lengths), then decode steps
    that wrap the ring: logits and every layer's state against JAX.
    Lengths are multiples of the interpret runtime's 16-wide blocks."""
    import jax.numpy as jnp
    jms, jp, tm, tp = pair
    jm = jms[impl]
    toks = _tok(0, (3, 48))
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, s_alloc=96)
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, s_alloc=96)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _states_close(js, ts, tm.rcfg)
    more = _tok(1, (3, 32))
    kv_len = np.asarray([80, 71, 57], np.int32)
    jl, js = jm.extend(jp, {"tokens": jnp.asarray(more)}, js, q_offset=48,
                       kv_len=jnp.asarray(kv_len))
    tl, ts = tm.extend(tp, {"tokens": torch.from_numpy(more)}, ts,
                       q_offset=48, kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _states_close(js, ts, tm.rcfg)
    pos = np.asarray([80, 80, 80], np.int32)
    for step in range(3):
        tok = _tok(2 + step, (3,))
        jl, js = jm.decode_step(jp, jnp.asarray(tok), js,
                                jnp.asarray(pos + step))
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok), ts,
                                torch.from_numpy(pos + step))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _states_close(js, ts, tm.rcfg)


@pytest.mark.parametrize("S", [WINDOW + 1, 2 * WINDOW + 5])
def test_extend_chunk_longer_than_window_matches_jax(pair, S):
    """A chunk of ``S > window`` tokens at ``q_offset > 0``: the reference
    scatters every position onto ``pos % window``, so ring slots repeat
    (``src/repro/models/attention.py:259``; XLA on the CPU keeps the last
    write).  The port writes only the last ``min(S, window)`` positions:
    the same rings, with no duplicate index."""
    import jax.numpy as jnp
    jms, jp, tm, tp = pair
    jm = jms["naive"]
    toks = _tok(5, (2, 20))
    _, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, s_alloc=96)
    _, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, s_alloc=96)
    more = _tok(6, (2, S))
    jl, js = jm.extend(jp, {"tokens": jnp.asarray(more)}, js, q_offset=20)
    tl, ts = tm.extend(tp, {"tokens": torch.from_numpy(more)}, ts,
                       q_offset=20)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _states_close(js, ts, tm.rcfg)
    pos = np.full(2, 20 + S, np.int32)
    tok = _tok(7, (2,))
    jl, _ = jm.decode_step(jp, jnp.asarray(tok), js, jnp.asarray(pos))
    tl, _ = tm.decode_step(tp, torch.from_numpy(tok), ts,
                           torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_prefill_without_cache_matches_jax(pair):
    """``full`` mode builds a ring of ``window`` slots from the last keys
    (the JAX ``LM`` returns the caches of its unstacked tail only)."""
    import jax.numpy as jnp
    jms, jp, tm, tp = pair
    toks = _tok(8, (2, 37))
    jl, js = jms["naive"].prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for a, b in zip(js["tail"], ts[6:]):
        for n in ("k", "v"):
            np.testing.assert_allclose(b[n].numpy(), np.asarray(a[n]), **TOL)
    assert ts[0]["k"].shape[1] == WINDOW and ts[5]["k"].shape[1] == 37


def test_padded_bucket_matches_jax(pair):
    """A document of 100 true tokens padded to a bucket of 128, prefilled
    with ``kv_len`` 100, then one decode step at position 100.  Pad keys
    are masked inside the prefill, but the ring keeps the padded chunk's
    last 16 positions (101..127 are pad) and the decode reads every ring
    slot, so BOTH packages attend over pad K/V here: a defect of the
    reference that the port keeps for parity (the result differs from an
    unpadded prefill; at a window longer than the bucket it does not)."""
    import jax.numpy as jnp
    jms, jp, tm, tp = pair
    toks = _tok(9, (2, 128))
    toks[:, 100:] = 0                                    # PAD
    kv_len = np.asarray([100, 100], np.int32)
    out = {}
    for name, m, p, mk in (
            ("jax", jms["naive"], jp, jnp.asarray),
            ("torch", tm, tp, torch.from_numpy)):
        st = m.init_states(2, 160)
        _, st = m.extend(p, {"tokens": mk(toks)}, st, q_offset=0,
                         kv_len=mk(kv_len))
        tok = mk(_tok(10, (2,)))
        out[name], st = m.decode_step(p, tok, st, mk(kv_len))
        out[name + "_states"] = st
    np.testing.assert_allclose(_np(out["torch"]), _np(out["jax"]), **TOL)
    _states_close(out["jax_states"], out["torch_states"], tm.rcfg)
    # the unpadded document decodes to other logits in both packages, by
    # the same amount: the pad K/V is read
    delta = {}
    for name, m, p, mk in (
            ("jax", jms["naive"], jp, jnp.asarray),
            ("torch", tm, tp, torch.from_numpy)):
        st = m.init_states(2, 160)
        _, st = m.extend(p, {"tokens": mk(toks[:, :100])}, st, q_offset=0)
        clean, _ = m.decode_step(p, mk(_tok(10, (2,))), st, mk(kv_len))
        delta[name] = float(np.abs(_np(clean) - _np(out[name])).max())
    print(f"padded vs unpadded prefill, max |dlogit|: {delta}")
    assert delta["jax"] > 1e-3
    assert abs(delta["torch"] - delta["jax"]) <= 1e-4


def test_ring_decode_equals_full_forward_in_port():
    """Prefill into rings, then decode steps past the window, against the
    cacheless forward of the whole sequence at each next position."""
    tm = TLM(_rcfg(), device="cpu")
    tp = tm.init(seed=11)
    toks = torch.from_numpy(_tok(12, (2, 45)))
    _, st = tm.prefill(tp, {"tokens": toks[:, :40]}, s_alloc=64)
    for n in range(40, 45):
        dl, st = tm.decode_step(tp, toks[:, n], st,
                                torch.full((2,), n, dtype=torch.int32))
        full, _ = tm.prefill(tp, {"tokens": toks[:, :n + 1]})
        torch.testing.assert_close(dl, full, **TOL)


def test_embed_scale_rounds_multiplier_to_model_dtype():
    """bf16: the embedding is multiplied by ``sqrt(d)`` rounded to bf16
    first (73.5 at d_model 5376), as the JAX package does."""
    import dataclasses
    rcfg = t_resolve(dataclasses.replace(
        t_get_reduced("gemma3_27b", **GEMMA), dtype="bfloat16",
        d_model=5376, num_heads=4, num_kv_heads=2, num_layers=1), tp=1)
    tm = TLM(rcfg, device="cpu")
    table = torch.full((4, 5376), 0.5, dtype=torch.bfloat16)
    x = tm.embed_inputs({"embed": {"table": table}},
                        {"tokens": torch.tensor([[1]])})
    assert x.dtype == torch.bfloat16 and float(x[0, 0, 0]) == 0.5 * 73.5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_gemma3_matches_cpu_plain(dtype):
    """Reduced gemma3 on the card (the windowed flash kernel, the masked
    ring extend, decode over rings) against the same weights on the CPU
    (plain versions): prefill into rings, an extend at ``q_offset`` > 0,
    decode steps past the window.  f32 logits to 1e-4 (cuBLAS and the
    kernels sum in other orders); bf16 (the tensor-core body) to 5e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    rcfg = t_resolve(dataclasses.replace(
        t_get_reduced("gemma3_27b", **GEMMA), dtype=dtype), tp=1)
    cpu, gpu = TLM(rcfg, device="cpu"), TLM(rcfg, device="cuda")
    cp = cpu.init(seed=13)

    def to_cuda(tree):
        if isinstance(tree, torch.Tensor):
            return tree.cuda()
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        return [to_cuda(v) for v in tree]

    gp = to_cuda(cp)
    toks = torch.from_numpy(_tok(14, (3, 80)))
    kv_len = torch.tensor([80, 71, 57], dtype=torch.int32)
    outs = []
    for m, p, dev in ((cpu, cp, "cpu"), (gpu, gp, "cuda")):
        l1, st = m.prefill(p, {"tokens": toks[:, :48].to(dev)}, s_alloc=96)
        l2, st = m.extend(p, {"tokens": toks[:, 48:].to(dev)}, st, 48,
                          kv_len=kv_len.to(dev))
        got = [l1, l2]
        for step in range(3):
            lg, st = m.decode_step(p, toks[:, step].to(dev), st,
                                   (kv_len + step).to(dev))
            got.append(lg)
        outs.append([g.float().cpu() for g in got])
    tol = 1e-4 if dtype == "float32" else 5e-2
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=tol, rtol=tol)
