"""The port's whisper-base held against the JAX package's ``WhisperModel``.

Reduced f32 whisper (2 encoder + 2 decoder layers, d_model 128, 4 query /
2 KV heads in self-attention and 4 / 4 in cross-attention, 64 frames,
vocab 512), weights from the JAX init converted by
``models.convert.whisper_from_jax``, frame embeddings and tokens from
seeded numpy.  ``encode``, the cacheless ``forward``, ``prefill`` (self
caches of ``s_alloc`` positions and the cross K/V of every layer) and
three ``decode_step``s agree with the JAX package to f32 ``atol = rtol =
1e-5``, on both JAX attention paths (naive and the Pallas kernels in
interpret mode).  The port's decode is also held against its own
teacher-forced forward, and its encoder is shown bidirectional.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.models.convert import whisper_from_jax  # noqa: E402
from repro_torch.models.whisper import WhisperModel as TW  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
B, S, S_ALLOC = 2, 12, 20


@pytest.fixture(scope="module")
def pair():
    """(JAX models by runtime, JAX params, port model, port params)."""
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.models.runtime import CPU_KERNEL_TEST, CPU_TEST
    from repro.models.whisper import WhisperModel
    rcfg = resolve(get_reduced("whisper_base", dtype="float32"), tp=1)
    jms = {"naive": WhisperModel(rcfg, CPU_TEST),
           "pallas_interpret": WhisperModel(rcfg, CPU_KERNEL_TEST)}
    jp = jms["naive"].init(jax.random.PRNGKey(7))
    tm = TW(t_resolve(t_get_reduced("whisper_base", dtype="float32"), tp=1),
            device="cpu")
    tp = whisper_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jms, jp, tm, tp


def _inputs(tm, seed=0, n=S):
    r = np.random.default_rng(seed)
    b = tm.rcfg.base
    return {"frame_emb": (0.02 * r.standard_normal(
                (B, b.encoder_seq_len, b.d_model))).astype(np.float32),
            "tokens": r.integers(9, b.vocab_size, (B, n)).astype(np.int32)}


def _j(batch):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def test_init_layout_matches_jax(pair):
    import jax
    jms, jp, tm, tp = pair
    mine = tm.init(seed=0)
    ref = whisper_from_jax(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), jp), "cpu")
    from repro_torch.tree import leaves_with_paths
    got = [(k, tuple(t.shape), t.dtype) for k, t in leaves_with_paths(mine)]
    want = [(k, tuple(t.shape), t.dtype) for k, t in leaves_with_paths(ref)]
    assert sorted(got) == sorted(want)


def test_encode_and_forward_match_jax(pair):
    jms, jp, tm, tp = pair
    batch = _inputs(tm, 1)
    jm = jms["naive"]
    _close(tm.encode(tp, torch.from_numpy(batch["frame_emb"])),
           jm.encode(jp, _j(batch)["frame_emb"]))
    jl, _ = jm.forward(jp, _j(batch))
    tl, aux = tm.forward(tp, _t(batch))
    assert tl.shape == (B, S, tm.rcfg.padded_vocab) and float(aux) == 0.0
    _close(tl, jl)


@pytest.mark.parametrize("impl", ["naive", "pallas_interpret"])
def test_prefill_and_decode_match_jax(pair, impl):
    """Prefill into caches of ``S_ALLOC`` positions, then three greedy
    decode steps: logits, every self cache and the cross K/V."""
    import jax
    import jax.numpy as jnp
    jms, jp, tm, tp = pair
    jm = jms[impl]
    batch = _inputs(tm, 2)
    jl, js = jm.prefill(jp, _j(batch), s_alloc=S_ALLOC)
    tl, ts = tm.prefill(tp, _t(batch), s_alloc=S_ALLOC)
    _close(tl, jl)
    conv = whisper_from_jax(jax.tree.map(np.asarray, js), "cpu")
    for name in ("self", "cross"):
        assert len(ts[name]) == tm.n_dec
        for a, b in zip(conv[name], ts[name]):
            for leaf in ("k", "v"):
                assert b[leaf].shape == a[leaf].shape
                _close(b[leaf], a[leaf].numpy())
    assert ts["cross"][0]["k"].shape == (
        B, tm.rcfg.base.encoder_seq_len, tm.rcfg.padded_heads,
        tm.rcfg.head_dim)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for step in range(3):
        pos = np.full((B,), S + step, np.int32)
        jl, js = jm.decode_step(jp, jnp.asarray(tok), js, jnp.asarray(pos))
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok), ts,
                                torch.from_numpy(pos))
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    conv = whisper_from_jax(jax.tree.map(np.asarray, js), "cpu")
    for a, b in zip(conv["self"], ts["self"]):
        _close(b["k"], a["k"].numpy())
        _close(b["v"], a["v"].numpy())


def test_decode_matches_teacher_forcing(pair):
    """Prefill S tokens, decode the next two: the logits equal the
    cacheless forward's at those positions (both in the port)."""
    jms, jp, tm, tp = pair
    batch = _inputs(tm, 3, n=S + 2)
    full, _ = tm.forward(tp, _t(batch))
    pre = dict(batch, tokens=batch["tokens"][:, :S])
    tl, ts = tm.prefill(tp, _t(pre), s_alloc=S_ALLOC)
    torch.testing.assert_close(tl, full[:, S - 1], **TOL)
    for i in range(2):
        tok = torch.from_numpy(np.ascontiguousarray(
            batch["tokens"][:, S + i]))
        tl, ts = tm.decode_step(tp, tok, ts,
                                torch.full((B,), S + i, dtype=torch.int32))
        torch.testing.assert_close(tl, full[:, S + i], **TOL)


def test_encoder_is_bidirectional_and_decoder_causal(pair):
    jms, jp, tm, tp = pair
    batch = _inputs(tm, 4)
    enc = tm.encode(tp, torch.from_numpy(batch["frame_emb"]))
    later = batch["frame_emb"].copy()
    later[:, -1] += 1.0
    enc2 = tm.encode(tp, torch.from_numpy(later))
    assert not torch.allclose(enc[:, 0], enc2[:, 0])
    logits, _ = tm.forward(tp, _t(batch))
    toks = batch["tokens"].copy()
    toks[:, -1] = (toks[:, -1] + 1) % tm.rcfg.base.vocab_size
    logits2, _ = tm.forward(tp, _t(dict(batch, tokens=toks)))
    assert torch.equal(logits[:, :-1], logits2[:, :-1])
