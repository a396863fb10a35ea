"""M-RoPE (qwen2-vl) in the port, held against the JAX package.

``apply_mrope`` on the same seeded numpy inputs; then the reduced qwen2-vl
LM (f32, vocab 512, 2 layers, ``tp=1``, M-RoPE sections (4, 6, 6) at
head_dim 32) on JAX's own weights (``from_jax_params``): a prefill of 8
patch embeddings on a 2 x 4 (h, w) grid followed by text, with explicit
``positions3``, then an extend and decode steps, and the text-only path
(t = h = w = position).  Logits and every cache leaf agree to f32
``atol=rtol=1e-5`` (the two frameworks sum matrix products in different
orders).  JAX runs ``CPU_TEST`` (naive attention), as its own tests do.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        states_from_jax)
from repro_torch.models.layers import apply_mrope, apply_rope  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
KW = dict(dtype="float32", vocab_size=512)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("sections,dh", [((4, 6, 6), 32), ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, dh):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.layers import apply_mrope as j_mrope
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 3, dh)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (2, 11, 3)).astype(np.int32)
    want = j_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                      sections)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mrope_with_equal_channels_is_rope():
    """t = h = w = p rotates every frequency by p: plain RoPE."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 9, 2, 32)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 500, (2, 9)))
    got = apply_mrope(x, pos[..., None].expand(2, 9, 3), 1e4, (4, 6, 6))
    assert torch.equal(got, apply_rope(x, pos, 1e4))


@pytest.fixture(scope="module")
def pair():
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.models.model import LM
    from repro.models.runtime import CPU_TEST
    jm = LM(resolve(get_reduced("qwen2_vl_2b", **KW), tp=1), CPU_TEST)
    jp = jm.init(jax.random.PRNGKey(3))
    tm = TLM(t_resolve(t_get_reduced("qwen2_vl_2b", **KW), tp=1),
             device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.rcfg, "cpu")
    return jm, jp, tm, tp


def _grid_positions3(B, n_img, rows, cols, n_txt):
    """Patches on a rows x cols grid at t = 0, then text at its absolute
    position on all three channels."""
    i = np.arange(n_img)
    img = np.stack([np.zeros(n_img), i // cols, i % cols], -1)
    txt = np.repeat(np.arange(n_img, n_img + n_txt)[:, None], 3, 1)
    p = np.concatenate([img, txt])[None].repeat(B, 0)
    assert rows * cols == n_img
    return p.astype(np.int32)


def _states_close(jstates, tstates, rcfg):
    import jax
    conv = states_from_jax(jax.tree.map(np.asarray, jstates), rcfg, "cpu")
    for a, b in zip(conv, tstates, strict=True):
        assert set(a) == set(b) == {"k", "v"}
        for n in a:
            np.testing.assert_allclose(b[n].numpy(), a[n].numpy(), **TOL)


def test_qwen2_vl_params_convert(pair):
    jm, jp, tm, tp = pair
    assert tm.rcfg.base.mrope_sections == (4, 6, 6)
    for r in range(2):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                tp["layers"][r]["attn"][name].numpy(),
                np.asarray(jp["stages"][0]["attn"][name])[r])
        for name in ("w1", "w2", "w3"):
            np.testing.assert_array_equal(
                tp["layers"][r]["mlp"][name].numpy(),
                np.asarray(jp["stages"][0]["mlp"][name])[r])


def test_qwen2_vl_patches_positions3_extend_decode_match_jax(pair):
    import jax.numpy as jnp
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(2)
    B, n_img, n_txt = 2, 8, 12
    patches = (rng.standard_normal((B, n_img, 128)) * 0.02).astype(
        np.float32)
    toks = rng.integers(16, 512, (B, n_txt)).astype(np.int32)
    pos3 = _grid_positions3(B, n_img, 2, 4, n_txt)
    jb = {"tokens": jnp.asarray(toks), "patch_emb": jnp.asarray(patches),
          "positions3": jnp.asarray(pos3)}
    tb = {"tokens": torch.from_numpy(toks),
          "patch_emb": torch.from_numpy(patches),
          "positions3": torch.from_numpy(pos3)}
    S = n_img + n_txt
    jl, js = jm.prefill(jp, jb, s_alloc=48)
    tl, ts = tm.prefill(tp, tb, s_alloc=48)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    # cacheless prefill gives the same last logits
    jl0, _ = jm.prefill(jp, jb)
    tl0, _ = tm.prefill(tp, tb)
    np.testing.assert_allclose(_np(tl0), _np(jl0), **TOL)
    # text extend at its absolute positions (text-only: t = h = w)
    more = rng.integers(16, 512, (B, 8)).astype(np.int32)
    kv_len = np.asarray([S + 8, S + 5], np.int32)
    jl, js = jm.extend(jp, {"tokens": jnp.asarray(more)}, js, q_offset=S,
                       kv_len=jnp.asarray(kv_len))
    tl, ts = tm.extend(tp, {"tokens": torch.from_numpy(more)}, ts,
                       q_offset=S, kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for step in range(3):
        tok = rng.integers(16, 512, (B,)).astype(np.int32)
        pos = kv_len + step
        jl, js = jm.decode_step(jp, jnp.asarray(tok), js, jnp.asarray(pos))
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok), ts,
                                torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _states_close(js, ts, tm.rcfg)


def test_qwen2_vl_text_only_equals_explicit_channels(pair):
    """Text-only input (no ``positions3``) is the same as t = h = w =
    position, in both packages, and the port agrees with JAX."""
    import jax.numpy as jnp
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(4).integers(16, 512, (2, 20)).astype(
        np.int32)
    pos3 = np.repeat(np.arange(20)[None, :, None], 2, 0).repeat(3, 2)
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    tl3, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "positions3": torch.from_numpy(pos3)})
    assert torch.equal(tl, tl3)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_qwen2_vl_serves_from_a_paged_or_gathered_arena(pair, paged):
    """qwen2-vl is all full attention, so it is paged-capable: an extend
    and decode through arena slots equal the dense path bitwise."""
    jm, jp, tm, tp = pair
    assert tm.supports_paged_kv
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(16, 512, (2, 16)).astype(np.int32))
    _, dense = tm.prefill(tp, {"tokens": toks}, s_alloc=32)
    arena = tm.init_states(4, 32)
    slots = torch.tensor([2, 0], dtype=torch.int32)
    kl = torch.tensor([16, 16], dtype=torch.int32)
    if paged:
        tm.extend(tp, {"tokens": toks}, arena, 0, kv_len=kl, slots=slots)
        lg, _ = tm.decode_step(tp, toks[:, 0], arena, kl, slots=slots)
    else:
        st = tm.take_states(arena, slots)
        _, st = tm.extend(tp, {"tokens": toks}, st, 0, kv_len=kl)
        tm.put_states(arena, slots, st)
        lg, st = tm.decode_step(tp, toks[:, 0], st, kl)
    want, _ = tm.decode_step(tp, toks[:, 0], dense, kl)
    torch.testing.assert_close(lg, want, atol=0, rtol=0)
