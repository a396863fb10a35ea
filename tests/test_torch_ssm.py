"""The port's recurrent mixers (``models/ssm.py``) and the two recurrent
decoders held against the JAX package.

Function level, on seeded numpy inputs and JAX's own initializers (f32):
``mlstm_chunk`` (two chunks and one, carrying a nonzero state),
``mlstm_recurrent_ref``, ``slstm_apply``, ``_causal_conv`` and
``rglru_apply`` over a whole sequence and step by step, outputs and every
state leaf to f32 ``atol=rtol=1e-5``.  The RG-LRU's log-depth scan sums in
another order than ``jax.lax.associative_scan``; the mLSTM's chunked form
is also held to its own recurrence.  Model level: the reduced xlstm-350m
(mLSTM/sLSTM, 4 layers) and recurrentgemma-2b (RG-LRU and local
attention, 6 layers, window 16) prefill, extend and decode against the
JAX ``LM`` on the same weights: logits and every state leaf.

Two faults of the reference are pinned, not fixed (the port keeps its
semantics): a prefill into an arena row that held another document
starts from that document's recurrent state (the delta is nonzero and the
same in both packages), and an mLSTM extend of 384 tokens (128 -> 512)
fails the chunking assertion ``T % min(256, T) == 0`` in both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        states_from_jax)
from repro_torch.models.model import LM as TLM  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
KW = dict(dtype="float32", vocab_size=512)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(tree):
    """numpy / JAX leaves -> torch (a dict of arrays, or one array)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close_tree(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_allclose(_np(port[k]), _np(ref[k]), **TOL,
                                   err_msg=k)


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.fixture(scope="module")
def jssm():
    pytest.importorskip("jax")
    from repro.models import ssm
    return ssm


def _mlstm_inputs(jssm, T, seed):
    import jax
    import jax.numpy as jnp
    B, D, H = 2, 64, 4
    p = jssm.init_mlstm(jax.random.PRNGKey(seed), D, H, jnp.float32)
    x = jnp.asarray(_x(seed, (B, T, D)))
    gates = jssm._mlstm_gates(p, x)
    return p, x, gates


def test_mlstm_gates_match_jax(jssm):
    p, x, jg = _mlstm_inputs(jssm, 16, 0)
    tg = tssm._mlstm_gates(_t(p), _t(x))
    for a, b in zip(tg, jg, strict=True):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("T,chunk", [(32, 16), (16, 16), (24, 8)])
def test_mlstm_chunk_and_recurrence_match_jax(jssm, T, chunk):
    """From a nonzero state (a first chunk of 8 tokens), both cores equal
    JAX's, and the chunked form equals the recurrence."""
    p, x, (q, k, v, li, lf, _, _) = _mlstm_inputs(jssm, T + 8, 1)
    st0 = jssm.init_mlstm_state(2, 4, 16)
    _, st = jssm.mlstm_chunk(q[:, :8], k[:, :8], v[:, :8], li[:, :8],
                             lf[:, :8], st0, 8)
    sl = slice(8, None)
    args = [q[:, sl], k[:, sl], v[:, sl], li[:, sl], lf[:, sl]]
    jh, jst = jssm.mlstm_chunk(*args, st, chunk)
    th, tst = tssm.mlstm_chunk(*map(_t, args), _t(st), chunk)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    _close_tree(tst, jst)
    jr, jrst = jssm.mlstm_recurrent_ref(*args, st)
    tr, trst = tssm.mlstm_recurrent_ref(*map(_t, args), _t(st))
    np.testing.assert_allclose(_np(tr), _np(jr), **TOL)
    _close_tree(trst, jrst)
    np.testing.assert_allclose(_np(th), _np(tr), atol=1e-4, rtol=1e-4)


def test_mlstm_apply_full_and_step_match_jax(jssm):
    p, x, _ = _mlstm_inputs(jssm, 16, 2)
    jy, jst = jssm.mlstm_apply(p, x, chunk=8, heads=4)
    ty, tst = tssm.mlstm_apply(_t(p), _t(x), chunk=8, heads=4)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    _close_tree(tst, jst)
    x1 = _x(3, (2, 1, 64))
    import jax.numpy as jnp
    jy, jst = jssm.mlstm_apply(p, jnp.asarray(x1), state=jst, mode="step",
                               heads=4)
    ty, tst = tssm.mlstm_apply(_t(p), _t(x1), state=tst, mode="step",
                               heads=4)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    _close_tree(tst, jst)


def test_mlstm_chunk_assertion_is_the_references(jssm):
    """T = 384 with chunk 256: both packages refuse (finding 3)."""
    p, x, args = _mlstm_inputs(jssm, 384, 4)
    st = jssm.init_mlstm_state(2, 4, 16)
    with pytest.raises(AssertionError):
        jssm.mlstm_chunk(*args[:5], st, 256)
    with pytest.raises(AssertionError):
        tssm.mlstm_chunk(*map(_t, args[:5]), _t(st), 256)


@pytest.mark.parametrize("T", [1, 12])
def test_slstm_apply_matches_jax(jssm, T):
    import jax
    import jax.numpy as jnp
    p = jssm.init_slstm(jax.random.PRNGKey(5), 64, 4, jnp.float32)
    x = jnp.asarray(_x(6, (2, 9, 64)))
    _, st = jssm.slstm_apply(p, x, heads=4)         # a nonzero state
    x2 = jnp.asarray(_x(7, (2, T, 64)))
    jy, jst = jssm.slstm_apply(p, x2, state=st, heads=4)
    ty, tst = tssm.slstm_apply(_t(p), _t(x2), state=_t(st), heads=4)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    _close_tree(tst, jst)
    assert tst["h"].dtype == torch.float32


def test_causal_conv_matches_jax(jssm):
    import jax.numpy as jnp
    xi = _x(8, (2, 10, 32))
    w, b, st = _x(9, (4, 32)), _x(10, (32,)), _x(11, (2, 3, 32))
    jo, jst = jssm._causal_conv(jnp.asarray(xi), jnp.asarray(w),
                                jnp.asarray(b), jnp.asarray(st))
    to, tst = tssm._causal_conv(*map(_t, (xi, w, b, st)))
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_array_equal(_np(tst), _np(jst))


@pytest.mark.parametrize("T", [2, 13, 64])
def test_rglru_apply_full_and_step_match_jax(jssm, T):
    """A whole sequence (the log-depth scan) from a nonzero state, then
    single steps, against JAX's associative scan and its step."""
    import jax
    import jax.numpy as jnp
    p = jssm.init_rglru(jax.random.PRNGKey(12), 48, 48, jnp.float32)
    _, st = jssm.rglru_apply(p, jnp.asarray(_x(13, (2, 5, 48))))
    x = jnp.asarray(_x(14, (2, T, 48)))
    jy, jst = jssm.rglru_apply(p, x, state=st)
    ty, tst = tssm.rglru_apply(_t(p), _t(x), state=_t(st))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    _close_tree(tst, jst)
    for t in range(3):
        x1 = jnp.asarray(_x(15 + t, (2, 1, 48)))
        jy, jst = jssm.rglru_apply(p, x1, state=jst, mode="step")
        ty, tst = tssm.rglru_apply(_t(p), _t(x1), state=tst)
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
        _close_tree(tst, jst)


def test_linear_scan_equals_the_loop():
    a = torch.rand((2, 37, 5), generator=torch.Generator().manual_seed(0))
    b = torch.randn((2, 37, 5), generator=torch.Generator().manual_seed(1))
    h, want = torch.zeros((2, 5)), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(tssm.linear_scan(a, b), torch.stack(want, 1),
                               atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

ARCHS = {"xlstm_350m": {}, "recurrentgemma_2b": {"sliding_window": 16}}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.models.model import LM
    from repro.models.runtime import CPU_TEST
    arch = request.param
    kw = dict(KW, **ARCHS[arch])
    jm = LM(resolve(get_reduced(arch, **kw), tp=1), CPU_TEST)
    jp = jm.init(jax.random.PRNGKey(7))
    tm = TLM(t_resolve(t_get_reduced(arch, **kw), tp=1), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.rcfg, "cpu")
    return jm, jp, tm, tp


def _leaves_close(jstates, tstates, rcfg):
    import jax
    conv = states_from_jax(jax.tree.map(np.asarray, jstates), rcfg, "cpu")
    assert len(conv) == len(tstates)
    for a, b in zip(conv, tstates):
        assert set(a) == set(b)
        for n in a:
            assert b[n].dtype == a[n].dtype, n
            np.testing.assert_allclose(b[n].numpy(), a[n].numpy(), **TOL,
                                       err_msg=n)


def test_params_and_states_convert_every_leaf(pair):
    """``from_jax_params`` carries every leaf of every layer (the stacked
    ``stages`` and the tail), ``states_from_jax`` every state leaf, and
    the port's own ``init_states`` has JAX's leaves, shapes, dtypes and
    initial values."""
    import jax
    jm, jp, tm, tp = pair
    n_rep = tm.num_layers // len(tm.rcfg.base.block_pattern)
    want = [jax.tree.map(lambda a, r=r: np.asarray(a)[r], stage)
            for r in range(n_rep) for stage in jp["stages"]]
    want += [jax.tree.map(np.asarray, layer) for layer in jp["tail"]]
    assert len(want) == len(tp["layers"]) == tm.num_layers
    for w, got in zip(want, tp["layers"]):
        for path, leaf in jax.tree_util.tree_flatten_with_path(w)[0]:
            t = got
            for k in path:
                t = t[k.key]
            np.testing.assert_array_equal(t.numpy(), leaf)
        assert len(_flat(got)) == len(jax.tree.leaves(w))
    js = jm.init_states(3, 40)
    _leaves_close(js, tm.init_states(3, 40), tm.rcfg)
    shapes = tm.state_shapes(3, 40)
    for layer, want in zip(tm.init_states(3, 40), shapes, strict=True):
        assert {n: (tuple(t.shape), t.dtype) for n, t in layer.items()} == \
            want
    assert not tm.supports_paged_kv


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    return [tree]


def test_prefill_extend_decode_match_jax(pair):
    import jax.numpy as jnp
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(8)
    toks = rng.integers(16, 512, (2, 32)).astype(np.int32)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, s_alloc=80)
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, s_alloc=80)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _leaves_close(js, ts, tm.rcfg)
    more = rng.integers(16, 512, (2, 32)).astype(np.int32)
    kv_len = np.asarray([64, 50], np.int32)
    jl, js = jm.extend(jp, {"tokens": jnp.asarray(more)}, js, q_offset=32,
                       kv_len=jnp.asarray(kv_len))
    tl, ts = tm.extend(tp, {"tokens": torch.from_numpy(more)}, ts,
                       q_offset=32, kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for step in range(3):
        tok = rng.integers(16, 512, (2,)).astype(np.int32)
        pos = kv_len + step
        jl, js = jm.decode_step(jp, jnp.asarray(tok), js, jnp.asarray(pos))
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok), ts,
                                torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _leaves_close(js, ts, tm.rcfg)
    # the cacheless prefill agrees too
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_recycled_row_keeps_stale_state_as_the_reference(pair):
    """Finding 2, pinned: the gather plane prefills a new document by
    extending the arena row it was given, so a row that held another
    document hands its recurrent state on.  Prefill of document B from a
    row that held A, against one from a fresh row: the logits move by the
    same nonzero delta in both packages, and the port equals JAX on the
    recycled row."""
    import jax.numpy as jnp
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(9)
    a = rng.integers(16, 512, (1, 32)).astype(np.int32)
    b = rng.integers(16, 512, (1, 32)).astype(np.int32)
    kl = np.asarray([32], np.int32)

    def run(model, params, conv, tok, st):
        return model.extend(params, {"tokens": conv(tok)}, st, q_offset=0,
                            kv_len=conv(kl))

    jt = jnp.asarray
    _, jsa = run(jm, jp, jt, a, jm.init_states(1, 64))
    jstale, _ = run(jm, jp, jt, b, jsa)
    jfresh, _ = run(jm, jp, jt, b, jm.init_states(1, 64))
    tt = torch.from_numpy
    _, tsa = run(tm, tp, tt, a, tm.init_states(1, 64))
    tstale, _ = run(tm, tp, tt, b, tsa)
    tfresh, _ = run(tm, tp, tt, b, tm.init_states(1, 64))
    jdelta = np.abs(_np(jstale) - _np(jfresh)).max()
    tdelta = np.abs(_np(tstale) - _np(tfresh)).max()
    assert jdelta > 1e-3 and tdelta > 1e-3
    np.testing.assert_allclose(tdelta, jdelta, rtol=1e-3)
    np.testing.assert_allclose(_np(tstale), _np(jstale), **TOL)
    np.testing.assert_allclose(_np(tfresh), _np(jfresh), **TOL)


def test_extend_384_raises_where_the_reference_raises():
    """Finding 3, pinned: the reduced xlstm prefilled to 128 tokens and
    extended by 384 (a bucket-512 document at fractions 0.25 -> 1.0)
    fails ``mlstm_chunk``'s assertion in both packages; 128 + 128 and a
    256-token extend do not."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.models.model import LM
    from repro.models.runtime import CPU_TEST
    kw = dict(KW, num_layers=2)
    jm = LM(resolve(get_reduced("xlstm_350m", **kw), tp=1), CPU_TEST)
    jp = jm.init(jax.random.PRNGKey(10))
    tm = TLM(t_resolve(t_get_reduced("xlstm_350m", **kw), tp=1),
             device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.rcfg, "cpu")
    toks = np.random.default_rng(11).integers(16, 512, (1, 512)).astype(
        np.int32)
    _, js = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :128])},
                       s_alloc=512)
    _, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :128])},
                       s_alloc=512)
    with pytest.raises(AssertionError, match="384, 256"):
        jm.extend(jp, {"tokens": jnp.asarray(toks[:, 128:])}, js, 128)
    with pytest.raises(AssertionError, match="384, 256"):
        tm.extend(tp, {"tokens": torch.from_numpy(toks[:, 128:])}, ts, 128)
    jl, _ = jm.extend(jp, {"tokens": jnp.asarray(toks[:, 128:384])}, js, 128)
    tl, _ = tm.extend(tp, {"tokens": torch.from_numpy(toks[:, 128:384])},
                      ts, 128)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
