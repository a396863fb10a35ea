"""Attention kernels of the PyTorch port held against the JAX package.

CPU part: the same numpy inputs (seeded) go through the JAX ``ops`` entry
points — ``impl="pallas_interpret"`` with blocks of 16, as the JAX kernel
tests run them, and ``impl="naive"`` — and through ``repro_torch``'s
``ops`` on CPU tensors (the plain versions).  Every case of
``tests/test_kernels.py`` for the four attention entry points is mirrored.
Tolerances: f32 ``atol=rtol=1e-5``; bf16 inputs ``atol=rtol=2e-2`` (both
sides round their output to bf16, one ulp is ~4e-3 relative and the two
frameworks sum in different orders before rounding).  Paged == gather is
asserted BITWISE inside the port.

CUDA part (``@pytest.mark.cuda``, skipped without a card): each
hand-written kernel against its plain version on the card, the paged ==
dense bitwise contract on the card, and the launch counters.  JAX is
imported lazily so the CUDA part runs where JAX is not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tfla  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, repro.kernels.ops) — imported only by the CPU tests."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    return jnp, jops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(seed, B, Sq, Skv, Hq, Hkv, Dh):
    return (_normal(seed, (B, Sq, Hq, Dh)), _normal(seed + 1, (B, Skv, Hkv, Dh)),
            _normal(seed + 2, (B, Skv, Hkv, Dh)))


def _arena(seed, N, S, Hkv, Dh):
    return _normal(seed, (N, S, Hkv, Dh)), _normal(seed + 1, (N, S, Hkv, Dh))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _i(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(port, ref, tol=F32):
    np.testing.assert_allclose(_np(port), _np(ref), **tol)


# ---------------------------------------------------------------------------
# Flash attention (entry point 4: dense) against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Sq,Skv,Hq,Hkv,Dh,causal,window,q_off",
    [
        (1, 32, 32, 4, 2, 16, True, None, 0),
        (2, 32, 32, 4, 4, 16, False, None, 0),
        (1, 64, 64, 2, 1, 32, True, 16, 0),      # sliding window
        (1, 16, 64, 4, 2, 16, True, None, 48),   # prefix-extend
        (2, 32, 64, 8, 2, 16, True, 24, 32),     # extend + window
    ],
)
def test_flash_attention_matches_jax(jx, dtype, B, Sq, Skv, Hq, Hkv, Dh,
                                     causal, window, q_off):
    jnp, jops = jx
    q, k, v = _qkv(0, B, Sq, Skv, Hq, Hkv, Dh)
    kw = dict(causal=causal, window=window, q_offset=q_off)
    jd = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    tdt = getattr(torch, dtype)
    out = tops.attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), **kw)
    assert out.dtype == tdt
    tol = F32 if dtype == "float32" else BF16
    for impl in ("pallas_interpret", "naive"):
        ref = jops.attention(jq, jk, jv, impl=impl, block_q=16, block_kv=16,
                             **kw)
        _close(out, ref, tol)


@pytest.mark.parametrize("q_off,causal", [(0, True), (32, True), (0, False)])
def test_flash_attention_per_row_kv_len(jx, q_off, causal):
    """Per-row kv_len masks bucket PAD keys for every query."""
    jnp, jops = jx
    B, Sq, Skv, Hq, Hkv, Dh = 3, 16, 64, 4, 2, 16
    q, k, v = _qkv(3, B, Sq, Skv, Hq, Hkv, Dh)
    kv_len = np.asarray([Skv, q_off + 5, 3], np.int32)
    out = tops.attention(_t(q), _t(k), _t(v), causal=causal, q_offset=q_off,
                         kv_len=_i(kv_len))
    for impl in ("pallas_interpret", "naive"):
        ref = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, q_offset=q_off,
                             kv_len=jnp.asarray(kv_len), impl=impl,
                             block_q=16, block_kv=16)
        _close(out, ref)
    # row 0 masks nothing: equals the kv_len=None path bit for bit
    full = tops.attention(_t(q), _t(k), _t(v), causal=causal, q_offset=q_off)
    assert torch.equal(full[0], out[0])


@pytest.mark.parametrize("b,nq,nkv,hkv,g,causal,window", [
    (1, 1, 1, 1, 1, True, None), (2, 3, 3, 2, 4, True, 24),
    (1, 2, 3, 1, 2, False, 24), (2, 1, 2, 2, 1, False, None),
    (1, 3, 1, 2, 2, True, None), (2, 2, 2, 1, 4, False, 24),
])
def test_flash_attention_shape_sweep(jx, b, nq, nkv, hkv, g, causal, window):
    """The property sweep of the JAX tests, as fixed cases."""
    jnp, jops = jx
    Sq, Skv, Dh = nq * 16, nkv * 16, 8
    q_off = max(Skv - Sq, 0)
    q, k, v = _qkv(b * 7 + nq, b, Sq, Skv, hkv * g, hkv, Dh)
    kw = dict(causal=causal, window=window, q_offset=q_off)
    out = tops.attention(_t(q), _t(k), _t(v), **kw)
    ref = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         impl="pallas_interpret", block_q=16, block_kv=16,
                         **kw)
    _close(out, ref)


def test_flash_attention_fully_masked_rows_are_zero(jx):
    """Rows with no visible keys (window slid past) give 0, not NaN."""
    jnp, jops = jx
    q, k, v = _qkv(5, 1, 32, 32, 2, 1, 16)
    kw = dict(causal=False, window=4, q_offset=64)
    out = tops.attention(_t(q), _t(k), _t(v), **kw)
    assert torch.isfinite(out).all()
    assert torch.equal(out, torch.zeros_like(out))
    ref = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         impl="pallas_interpret", block_q=16, block_kv=16,
                         **kw)
    _close(out, ref)


# ---------------------------------------------------------------------------
# Decode attention (entry points 1 and 2) against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,Dh", [
    (2, 64, 4, 2, 16), (1, 128, 8, 1, 32), (3, 32, 4, 4, 16)])
def test_decode_attention_matches_jax(jx, dtype, B, S, Hq, Hkv, Dh):
    jnp, jops = jx
    q = _normal(1, (B, Hq, Dh))
    _, k, v = _qkv(2, B, 1, S, Hq, Hkv, Dh)
    kv_len = np.random.default_rng(0).integers(1, S + 1, B).astype(np.int32)
    jd, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    out = tops.decode_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                                _i(kv_len))
    tol = F32 if dtype == "float32" else BF16
    for impl in ("pallas_interpret", "naive"):
        ref = jops.decode_attention(
            jnp.asarray(q).astype(jd), jnp.asarray(k).astype(jd),
            jnp.asarray(v).astype(jd), jnp.asarray(kv_len), impl=impl,
            block_kv=16)
        _close(out, ref, tol)


def test_decode_attention_ragged_cache_len(jx):
    """S not a block multiple: the port needs no padding copy."""
    jnp, jops = jx
    B, S, Hq, Hkv, Dh = 2, 72, 4, 2, 16
    q = _normal(6, (B, Hq, Dh))
    _, k, v = _qkv(7, B, 1, S, Hq, Hkv, Dh)
    kv_len = np.asarray([40, 72], np.int32)
    out = tops.decode_attention(_t(q), _t(k), _t(v), _i(kv_len))
    ref = jops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(kv_len),
                                impl="pallas_interpret", block_kv=16)
    _close(out, ref)


def test_arena_decode_attention_gathers_slots(jx):
    jnp, jops = jx
    N, B, S, Hq, Hkv, Dh = 5, 3, 32, 4, 2, 16
    q = _normal(8, (B, Hq, Dh))
    ka, va = _arena(9, N, S, Hkv, Dh)
    slots, kv_len = [4, 0, 2], [10, 32, 7]
    out = tops.arena_decode_attention(_t(q), _t(ka), _t(va), _i(slots),
                                      _i(kv_len))
    ref = jops.arena_decode_attention(
        jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va),
        jnp.asarray(slots, jnp.int32), jnp.asarray(kv_len, jnp.int32),
        impl="naive")
    _close(out, ref)


@pytest.mark.parametrize("slots,kv_len", [
    ([4, 0, 2], [10, 64, 7]),     # permuted slots, ragged kv_len
    ([4, 4, 4], [1, 1, 64]),      # scratch row N-1 as repeated sentinel
    ([3, 1, 0], [64, 33, 16]),
])
def test_paged_decode_bitwise_equals_gather(jx, slots, kv_len):
    """Paged decode == dense decode over the gathered rows, BITWISE inside
    the port, and within tolerance of the JAX paged kernel."""
    jnp, jops = jx
    N, B, S, Hq, Hkv, Dh = 5, 3, 64, 4, 2, 16
    q = _normal(9, (B, Hq, Dh))
    ka, va = _arena(10, N, S, Hkv, Dh)
    paged = tops.arena_decode_attention(_t(q), _t(ka), _t(va), _i(slots),
                                        _i(kv_len))
    idx = np.asarray(slots)
    dense = tops.decode_attention(_t(q), _t(ka[idx]), _t(va[idx]),
                                  _i(kv_len))
    assert torch.equal(paged, dense)
    ref = jops.arena_decode_attention(
        jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va),
        jnp.asarray(slots, jnp.int32), jnp.asarray(kv_len, jnp.int32),
        impl="pallas_interpret", block_kv=16)
    _close(paged, ref)


def test_paged_decode_ragged_arena(jx):
    """S not a kv-block multiple: JAX falls back to a gather; the port's
    kernels mask the ragged edge themselves."""
    jnp, jops = jx
    N, B, S, Hq, Hkv, Dh = 4, 2, 72, 4, 2, 16
    q = _normal(11, (B, Hq, Dh))
    ka, va = _arena(12, N, S, Hkv, Dh)
    slots, kv_len = [3, 1], [40, 72]
    out = tops.arena_decode_attention(_t(q), _t(ka), _t(va), _i(slots),
                                      _i(kv_len))
    ref = jops.arena_decode_attention(
        jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va),
        jnp.asarray(slots, jnp.int32), jnp.asarray(kv_len, jnp.int32),
        impl="pallas_interpret", block_kv=16)
    _close(out, ref)


@pytest.mark.parametrize("bad", [[-1, 0, 1], [5, 0, 1], [0, 99, 1]])
def test_paged_decode_rejects_out_of_range_slots(bad):
    """Out-of-range slot ids on CPU tensors raise instead of reading an
    unrelated row (same message contract as the JAX package)."""
    N, B, S, Hq, Hkv, Dh = 5, 3, 32, 4, 2, 16
    q = _normal(13, (B, Hq, Dh))
    ka, va = _arena(14, N, S, Hkv, Dh)
    with pytest.raises(ValueError, match="scratch row"):
        tops.arena_decode_attention(_t(q), _t(ka), _t(va), _i(bad),
                                    _i([4, 8, 2]))
    with pytest.raises(ValueError, match="scratch row"):
        tops.attention_paged(_t(_normal(15, (B, 16, Hq, Dh))), _t(ka),
                             _t(va), _i(bad), kv_valid=16)


def test_paged_decode_bf16_arena_tolerance(jx):
    """A bf16 arena decodes within quantization tolerance of the f32 arena
    it was cast from, as the JAX kernel does."""
    jnp, jops = jx
    N, B, S, Hq, Hkv, Dh = 5, 3, 64, 4, 2, 16
    q = _normal(23, (B, Hq, Dh))
    ka, va = _arena(24, N, S, Hkv, Dh)
    slots, kv_len = [0, 2, 4], [64, 33, 16]
    out32 = tops.arena_decode_attention(_t(q), _t(ka), _t(va), _i(slots),
                                        _i(kv_len))
    out16 = tops.arena_decode_attention(
        _t(q), _t(ka, torch.bfloat16), _t(va, torch.bfloat16), _i(slots),
        _i(kv_len))
    _close(out16, out32, dict(atol=3e-2, rtol=3e-2))
    ref16 = jops.arena_decode_attention(
        jnp.asarray(q), jnp.asarray(ka).astype(jnp.bfloat16),
        jnp.asarray(va).astype(jnp.bfloat16), jnp.asarray(slots, jnp.int32),
        jnp.asarray(kv_len, jnp.int32), impl="pallas_interpret",
        block_kv=16)
    # same bf16 cache bits on both sides, f32 math after the upcast
    _close(out16, ref16)


# ---------------------------------------------------------------------------
# Paged flash extend (entry point 3) against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_off,Sq,kv_valid", [
    (0, 16, 16),       # prefill-into-arena (cached_len == 0)
    (16, 16, 32),      # mid-cascade fraction extension
    (48, 16, 64),      # extension reaching the end of the bucket
    (40, 13, 53),      # ragged chunk and cache (JAX gathers; port masks)
])
def test_paged_extend_bitwise_equals_gather(jx, q_off, Sq, kv_valid):
    jnp, jops = jx
    N, B, S_alloc, Hq, Hkv, Dh = 6, 3, 64, 4, 2, 16
    q = _normal(12, (B, Sq, Hq, Dh))
    ka, va = _arena(13, N, S_alloc, Hkv, Dh)
    slots = [5, 0, 3]                              # scratch row 5 included
    kv_len = [kv_valid, max(q_off - 3, 1), q_off + 5]
    paged = tops.attention_paged(_t(q), _t(ka), _t(va), _i(slots),
                                 kv_valid=kv_valid, q_offset=q_off,
                                 kv_len=_i(kv_len))
    idx = np.asarray(slots)
    dense = tops.attention(_t(q), _t(ka[idx][:, :kv_valid]),
                           _t(va[idx][:, :kv_valid]), causal=True,
                           q_offset=q_off, kv_len=_i(kv_len))
    assert torch.equal(paged, dense)
    # the Pallas kernel asserts block-multiple shapes; JAX runs the ragged
    # case through its naive path only
    ragged = Sq % 16 or kv_valid % 16
    for impl in ("naive",) if ragged else ("pallas_interpret", "naive"):
        ref = jops.attention_paged(
            jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va),
            jnp.asarray(slots, jnp.int32), kv_valid=kv_valid,
            q_offset=q_off, kv_len=jnp.asarray(kv_len, jnp.int32),
            impl=impl, block_q=16, block_kv=16)
        _close(paged, ref)


# ---------------------------------------------------------------------------
# Block tables: per-block row indirection (prefix-sharing read geometry)
# ---------------------------------------------------------------------------

def _materialize(arena, bt, tb):
    return np.stack([
        np.concatenate([arena[bt[b, j], j * tb:(j + 1) * tb]
                        for j in range(bt.shape[1])], axis=0)
        for b in range(bt.shape[0])])


def _tables(slots, n_cols, shared):
    bt = np.repeat(np.asarray(slots, np.int32)[:, None], n_cols, axis=1)
    bt[:, 0] = shared
    return bt


def test_paged_decode_block_tables_bitwise(jx):
    """Block-tabled decode == decode over the materialized caches,
    bitwise in the port and within tolerance of JAX."""
    jnp, jops = jx
    N, B, S, Hq, Hkv, Dh, tb = 6, 3, 64, 4, 2, 16, 16
    q = _normal(21, (B, Hq, Dh))
    ka, va = _arena(22, N, S, Hkv, Dh)
    slots, kv_len = [0, 2, 3], [40, 64, 17]
    bt = _tables(slots, S // tb, shared=4)
    out = tops.arena_decode_attention(_t(q), _t(ka), _t(va), _i(slots),
                                      _i(kv_len), block_tables=_i(bt))
    km, vm = _materialize(ka, bt, tb), _materialize(va, bt, tb)
    mat = tops.arena_decode_attention(_t(q), _t(km), _t(vm),
                                      _i(np.arange(B)), _i(kv_len))
    assert torch.equal(out, mat)
    ref = jops.arena_decode_attention(
        jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va),
        jnp.asarray(slots, jnp.int32), jnp.asarray(kv_len, jnp.int32),
        block_tables=jnp.asarray(bt), impl="pallas_interpret", block_kv=tb)
    _close(out, ref)


def test_paged_extend_block_tables_bitwise(jx):
    jnp, jops = jx
    N, B, S_alloc, Hq, Hkv, Dh, tb = 6, 2, 64, 4, 2, 16, 16
    Sq, q_off, kv_valid = 16, 16, 32
    q = _normal(31, (B, Sq, Hq, Dh))
    ka, va = _arena(32, N, S_alloc, Hkv, Dh)
    slots, kv_len = [1, 3], [kv_valid, q_off + 7]
    bt = _tables(slots, S_alloc // tb, shared=5)
    kw = dict(kv_valid=kv_valid, q_offset=q_off)
    out = tops.attention_paged(_t(q), _t(ka), _t(va), _i(slots),
                               kv_len=_i(kv_len), block_tables=_i(bt), **kw)
    km, vm = _materialize(ka, bt, tb), _materialize(va, bt, tb)
    mat = tops.attention_paged(_t(q), _t(km), _t(vm), _i(np.arange(B)),
                               kv_len=_i(kv_len), **kw)
    assert torch.equal(out, mat)
    ref = jops.attention_paged(
        jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va),
        jnp.asarray(slots, jnp.int32), kv_len=jnp.asarray(kv_len, jnp.int32),
        block_tables=jnp.asarray(bt), impl="pallas_interpret", block_q=tb,
        block_kv=tb, **kw)
    _close(out, ref)


def test_row_hooks_see_slots_and_block_tables():
    """Registered sanitizer hooks receive the row ids (as host arrays)
    of every paged call; the arena sanitizer's hook rejects rows outside
    the arena."""
    from repro_torch.analysis.sanitizer import ArenaRaceError, ArenaSanitizer
    from repro_torch.kernels import sanitize
    seen = []
    hid = sanitize.add_row_hook(
        lambda where, rows, n: seen.append((where, rows.tolist(), n)))
    try:
        q = _t(_normal(42, (2, 4, 16)))
        ka, va = (_t(a) for a in _arena(43, 4, 32, 2, 16))
        tops.arena_decode_attention(q, ka, va, _i([3, 1]), _i([5, 9]))
        bt = _i(np.asarray([[2, 1], [0, 3]]))
        tops.attention_paged(_t(_normal(44, (2, 16, 4, 16))), ka, va,
                             _i([2, 0]), kv_valid=32, block_tables=bt)
    finally:
        sanitize.remove_row_hook(hid)
    assert seen == [("arena_decode_attention", [3, 1], 3),
                    ("attention_paged block_tables", [[2, 1], [0, 3]], 3)]
    hid = sanitize.add_row_hook(ArenaSanitizer(backend="t").kernel_hook())
    try:
        with pytest.raises(ArenaRaceError):
            sanitize.notify_rows("probe", torch.tensor([0, 7]), 3)
    finally:
        sanitize.remove_row_hook(hid)


def test_cuda_wrappers_reject_cpu_tensors():
    """The kernel wrappers never run the plain version: CPU tensors raise
    (only ``ops`` routes CPU tensors to the plain path)."""
    q = _t(_normal(40, (1, 4, 16)))
    k = _t(_normal(41, (1, 8, 2, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention(q, k, k, _i([8]))
    with pytest.raises(ValueError, match="CUDA"):
        tfla.flash_attention(q[:, None], k, k)


# ---------------------------------------------------------------------------
# CUDA: each hand-written kernel against its plain version on the card
# ---------------------------------------------------------------------------

def _tol(dtype):
    # f32: the kernel sums in another order than cuBLAS; bf16: one output
    # ulp (~4e-3 relative) plus that reordering before the rounding
    return (dict(atol=2e-5, rtol=1e-4) if dtype == torch.float32
            else dict(atol=1.6e-2, rtol=1.6e-2))


def _dev(a, dtype, dev):
    return torch.from_numpy(np.asarray(a)).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,Dh,tb", [
    (8, 1088, 32, 8, 64, None),     # main path: bucket 1024 + op reserve
    (3, 72, 4, 2, 16, 8),           # ragged cache, table block 8
    (5, 200, 8, 1, 128, 40),        # Dh 128, table block 40
    (2, 96, 6, 3, 32, 96),          # one table block per row
])
def test_cuda_decode_kernels_match_plain(cuda, dtype, B, S, Hq, Hkv, Dh, tb):
    N = B + 3
    q = _dev(_normal(50, (B, Hq, Dh)), dtype, cuda)
    ka, va = (_dev(a, dtype, cuda) for a in _arena(51, N, S, Hkv, Dh))
    rng = np.random.default_rng(52)
    slots = rng.permutation(N)[:B].astype(np.int32)
    slots[-1] = N - 1                                  # scratch sentinel
    kv_len = rng.integers(0, S + 1, B).astype(np.int32)
    kv_len[0] = S
    s, kl = _dev(slots, torch.int32, cuda), _dev(kv_len, torch.int32, cuda)
    bt = None
    if tb is not None:
        bt = _dev(rng.integers(0, N, (B, S // tb)).astype(np.int32),
                  torch.int32, cuda)
    before = dict(tdec.LAUNCHES)
    out = tops.arena_decode_attention(q, ka, va, s, kl, block_tables=bt)
    plain = tdec.paged_decode_attention_plain(
        q, ka, va, s, kl, block_tables=bt, table_block=tb)
    torch.testing.assert_close(out.float(), plain.float(), **_tol(dtype))
    gathered = [tops._gather_block_rows(a, bt, tb) if bt is not None
                else a[s.long()] for a in (ka, va)]
    dense = tops.decode_attention(q, *gathered, kl)
    assert torch.equal(out, dense)                     # one body, bitwise
    assert tdec.LAUNCHES["paged_decode_attention"] == \
        before["paged_decode_attention"] + 1
    assert tdec.LAUNCHES["decode_attention"] == before["decode_attention"] + 1
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,q_off,kv_valid,S_alloc,Hq,Hkv,Dh,causal,"
                         "window,tb", [
    (8, 256, 0, 256, 320, 32, 8, 64, True, None, None),   # main path
    (8, 128, 128, 256, 320, 32, 8, 64, True, None, 64),   # extension
    (2, 37, 50, 87, 116, 4, 2, 16, True, None, 29),       # ragged
    (3, 64, 0, 64, 64, 8, 2, 32, False, 24, None),        # window, bidir
    (1, 70, 130, 200, 200, 4, 4, 128, True, 33, 100),     # window + Dh 128
])
def test_cuda_flash_kernels_match_plain(cuda, dtype, B, Sq, q_off, kv_valid,
                                        S_alloc, Hq, Hkv, Dh, causal, window,
                                        tb):
    N = B + 2
    q = _dev(_normal(60, (B, Sq, Hq, Dh)), dtype, cuda)
    ka, va = (_dev(a, dtype, cuda) for a in _arena(61, N, S_alloc, Hkv, Dh))
    rng = np.random.default_rng(62)
    slots = rng.permutation(N)[:B].astype(np.int32)
    kv_len = rng.integers(1, kv_valid + 1, B).astype(np.int32)
    kv_len[0] = kv_valid
    s, kl = _dev(slots, torch.int32, cuda), _dev(kv_len, torch.int32, cuda)
    bt = None
    if tb is not None:
        bt = _dev(rng.integers(0, N, (B, S_alloc // tb)).astype(np.int32),
                  torch.int32, cuda)
    kw = dict(causal=causal, window=window, q_offset=q_off, kv_len=kl)
    out = tops.attention_paged(q, ka, va, s, kv_valid=kv_valid,
                               block_tables=bt, **kw)
    plain = tfla.paged_flash_attention_plain(
        q, ka, va, s, kv_valid=kv_valid, block_tables=bt, table_block=tb,
        **kw)
    torch.testing.assert_close(out.float(), plain.float(), **_tol(dtype))
    gathered = [(tops._gather_block_rows(a, bt, tb) if bt is not None
                 else a[s.long()])[:, :kv_valid] for a in (ka, va)]
    dense = tops.attention(q, *gathered, **kw)
    assert torch.equal(out, dense)                     # one body, bitwise
    assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_cuda_fully_masked_rows_are_zero(cuda):
    q, k, v = (_dev(a, torch.float32, cuda) for a in _qkv(5, 1, 32, 32, 2,
                                                          1, 16))
    out = tops.attention(q, k, v, causal=False, window=4, q_offset=64)
    assert torch.equal(out, torch.zeros_like(out))
    kl = _dev(np.zeros(1, np.int32), torch.int32, cuda)
    dec = tops.decode_attention(q[:, 0], k, v, kl)
    assert torch.equal(dec, torch.zeros_like(dec))
