"""The port's MoE FFN (``models/moe.py``) held against the JAX package.

Function level, on seeded numpy inputs and JAX's own ``init_moe`` weights
(f32, d 64, d_ff 96, 4 experts, top-2): the router's expert ids and the
dispatch positions and keep mask EXACTLY (as integers), in a case that
drops assignments (a capacity below the load) and one that drops none;
combine weights, the per-row ``_moe_tokens`` output and
``moe_apply_tp_dense``'s output and aux loss to f32 ``atol=rtol=1e-5``.
Model level: the reduced phi3.5-moe (f32, vocab 512, 2 layers, 4
experts) prefill, extend and decode against the JAX ``LM`` on the same
weights, logits and every cache leaf to the same tolerance.  JAX runs
``CPU_TEST``.

CUDA (``@pytest.mark.cuda``): a batch row's MoE output is bitwise the
same alone (the other rows zeroed) as in its batch, at phi3.5-moe's
widths in bf16, and two calls agree bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        states_from_jax)
from repro_torch.models.model import LM as TLM  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
KW = dict(dtype="float32", vocab_size=512)
D, F, E, K = 64, 96, 4, 2


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def weights():
    """JAX ``init_moe`` params, as numpy and as port tensors."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.moe import init_moe
    jp = init_moe(jax.random.PRNGKey(0), D, F, E, jnp.float32)
    npp = jax.tree.map(np.asarray, jp)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in npp.items()}


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_route_matches_jax_exactly(weights):
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    jp, tp = weights
    x = _x(0, (40, D))
    jids, jw, jlog = jmoe._route(jp["router"], jnp.asarray(x), K)
    tids, tw, tlog = tmoe._route(tp["router"], torch.from_numpy(x), K)
    np.testing.assert_array_equal(_np(tids), _np(jids))
    np.testing.assert_allclose(_np(tw), _np(jw), **TOL)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)


@pytest.mark.parametrize("capacity", [3, 7, 40])
def test_dispatch_indices_and_keep_exact(capacity):
    """Positions count in token-major order per expert; capacity 3 and 7
    drop assignments, 40 drops none.  Integers, so exact."""
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    ids = np.random.default_rng(1).integers(0, E, (40, K))
    ids[:, 1] = (ids[:, 0] + 1 + ids[:, 1] % (E - 1)) % E   # distinct top-k
    jpos, jkeep = jmoe._dispatch_indices(jnp.asarray(ids), E, capacity)
    tpos, tkeep = tmoe._dispatch_indices(torch.from_numpy(ids), E, capacity)
    np.testing.assert_array_equal(_np(tpos), _np(jpos))
    np.testing.assert_array_equal(_np(tkeep), _np(jkeep))
    dropped = int((~_np(tkeep)).sum())
    assert (dropped > 0) == (capacity < 40)
    # a batch of rows dispatches each row on its own
    both = np.stack([ids, ids[::-1]])
    bpos, bkeep = tmoe._dispatch_indices(torch.from_numpy(both), E, capacity)
    assert torch.equal(bpos[0], tpos)
    r1, k1 = jmoe._dispatch_indices(jnp.asarray(ids[::-1]), E, capacity)
    np.testing.assert_array_equal(_np(bpos[1]), _np(r1))
    np.testing.assert_array_equal(_np(bkeep[1]), _np(k1))


@pytest.mark.parametrize("S,cf", [(40, 1.25), (40, 0.3), (1, 1.25)])
def test_moe_tokens_matches_jax_per_row(weights, S, cf):
    """Each row of the port's batched dispatch against the JAX function
    on that row alone; cf 0.3 drops assignments, S = 1 is a decode."""
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    jp, tp = weights
    x = _x(2, (3, S, D))
    cap = tmoe.row_capacity(S, K, cf, E)
    tout, tlog, tids = tmoe._moe_tokens(tp, torch.from_numpy(x), top_k=K,
                                        capacity=cap, act="silu")
    drops = 0
    for b in range(3):
        jout, jlog = jmoe._moe_tokens(jp, jnp.asarray(x[b]), top_k=K,
                                      capacity_factor=cf * 1.6,
                                      num_experts=E, act="silu")
        np.testing.assert_allclose(_np(tout[b]), _np(jout), **TOL)
        np.testing.assert_allclose(_np(tlog[b]), _np(jlog), **TOL)
        ids, _, _ = jmoe._route(jp["router"], jnp.asarray(x[b]), K)
        _, keep = jmoe._dispatch_indices(ids, E, cap)
        drops += int((~np.asarray(keep)).sum())
    assert (drops > 0) == (cf < 1.0)


@pytest.mark.parametrize("cf", [1.25, 0.3])
def test_moe_apply_tp_dense_output_and_aux_match_jax(weights, cf):
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    jp, tp = weights
    x = _x(3, (2, 24, D))
    jout, jaux = jmoe.moe_apply_tp_dense(jp, jnp.asarray(x), top_k=K,
                                         capacity_factor=cf)
    tout, taux = tmoe.moe_apply_tp_dense(tp, torch.from_numpy(x), top_k=K,
                                         capacity_factor=cf)
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
    np.testing.assert_allclose(_np(taux), _np(jaux), **TOL)
    # every strategy runs tp_dense without a mesh, as in JAX
    for strategy in tmoe.STRATEGIES:
        sout, _ = tmoe.moe_apply(tp, torch.from_numpy(x), top_k=K,
                                 capacity_factor=cf, strategy=strategy)
        assert torch.equal(sout, tout)
    with pytest.raises(ValueError):
        tmoe.moe_apply(tp, torch.from_numpy(x), top_k=K, capacity_factor=cf,
                       strategy="nope")


def test_drop_log_records_keep_masks(weights):
    _, tp = weights
    x = torch.from_numpy(_x(4, (2, 40, D)))
    tmoe.DROP_LOG = []
    try:
        tmoe.moe_apply_tp_dense(tp, x, top_k=K, capacity_factor=0.3)
        tmoe.moe_apply_tp_dense(tp, x, top_k=K, capacity_factor=4.0)
        low, high = (int((~keep).sum()) for keep in tmoe.DROP_LOG)
    finally:
        tmoe.DROP_LOG = None
    ids, _, _ = tmoe._route(tp["router"], x, K)
    _, keep = tmoe._dispatch_indices(ids, E, tmoe.row_capacity(40, K, 0.3, E))
    assert low == int((~keep).sum()) > 0 and high == 0


@pytest.fixture(scope="module")
def phi_pair():
    jax = pytest.importorskip("jax")
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.models.model import LM
    from repro.models.runtime import CPU_TEST
    jm = LM(resolve(get_reduced("phi3_5_moe", **KW), tp=1), CPU_TEST)
    jp = jm.init(jax.random.PRNGKey(4))
    tm = TLM(t_resolve(t_get_reduced("phi3_5_moe", **KW), tp=1),
             device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.rcfg, "cpu")
    return jm, jp, tm, tp


def test_phi35_params_carry_every_moe_leaf(phi_pair):
    jm, jp, tm, tp = phi_pair
    assert tm.rcfg.base.moe.num_experts == 4 and tm.supports_paged_kv
    for r in range(2):
        assert "mlp" not in tp["layers"][r]
        for name in ("router", "w1", "w3", "w2"):
            np.testing.assert_array_equal(
                tp["layers"][r]["moe"][name].numpy(),
                np.asarray(jp["stages"][0]["moe"][name])[r])
    own = tm.init(seed=1)["layers"][0]["moe"]
    assert own["w1"].shape == (4, 128, 256) and own["router"].dtype == \
        torch.float32


def test_phi35_prefill_extend_decode_match_jax(phi_pair):
    import jax
    import jax.numpy as jnp
    jm, jp, tm, tp = phi_pair
    rng = np.random.default_rng(5)
    toks = rng.integers(16, 512, (3, 32)).astype(np.int32)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, s_alloc=80)
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, s_alloc=80)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    more = rng.integers(16, 512, (3, 16)).astype(np.int32)
    kv_len = np.asarray([48, 41, 35], np.int32)
    jl, js = jm.extend(jp, {"tokens": jnp.asarray(more)}, js, q_offset=32,
                       kv_len=jnp.asarray(kv_len))
    tl, ts = tm.extend(tp, {"tokens": torch.from_numpy(more)}, ts,
                       q_offset=32, kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for step in range(3):
        tok = rng.integers(16, 512, (3,)).astype(np.int32)
        pos = kv_len + step
        jl, js = jm.decode_step(jp, jnp.asarray(tok), js, jnp.asarray(pos))
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok), ts,
                                torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    conv = states_from_jax(jax.tree.map(np.asarray, js), tm.rcfg, "cpu")
    for a, b in zip(conv, ts, strict=True):
        for n in ("k", "v"):
            np.testing.assert_allclose(b[n].numpy(), a[n].numpy(), **TOL)


@pytest.mark.cuda
def test_cuda_moe_rows_are_batch_invariant():
    """At phi3.5-moe's widths in bf16 (d 4096, d_ff 6400, 16 experts,
    top-2), a row's output alone (the other rows zeroed, the launch shape
    unchanged) is bitwise its output in the batch, and two calls agree:
    the per-row dispatch and the unique-position writes keep rows
    independent and the result deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = tmoe.init_moe(gen, 4096, 6400, 16, torch.bfloat16)
    x = (torch.randn((4, 64, 4096), generator=gen, device="cuda")
         .to(torch.bfloat16))
    full, _ = tmoe.moe_apply_tp_dense(p, x, top_k=2, capacity_factor=1.25)
    again, _ = tmoe.moe_apply_tp_dense(p, x, top_k=2, capacity_factor=1.25)
    assert torch.equal(full, again)
    assert torch.isfinite(full.float()).all()
    for b in range(4):
        alone = torch.zeros_like(x)
        alone[b] = x[b]
        out, _ = tmoe.moe_apply_tp_dense(p, alone, top_k=2,
                                         capacity_factor=1.25)
        assert torch.equal(out[b], full[b]), b
