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

The rounding of the extend kernel's tensor-core body (bf16 scores and
softmax weights, 64-key online softmax) is emulated on the CPU and held
against the JAX reference within ``EXTEND_TOL``, the tolerance that
``chip_smoke.py`` holds the kernel to.

CUDA part (``@pytest.mark.cuda``, skipped without a card): each
hand-written kernel against its plain version on the card (decode also at
the split-KV chunk edges, extend at ragged shapes, every head_dim and
group size, and block tables that cross a key tile), the paged == dense
bitwise contract on the card, determinism and batch invariance of both
kernel pairs, and the launch counters.  JAX is imported lazily so the
CUDA part runs where JAX is not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tfla  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
# bf16 extend outputs: two bf16 ulps at 0.25-0.5 plus one output ulp
# relative (the tolerance of chip_smoke.py's extend rows)
EXTEND_TOL = dict(atol=4e-3, rtol=2 ** -7)


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


def _tc_body_emulation(q, k, v, *, causal, window, q_offset, kv_len):
    """The extend kernel's tensor-core body, in PyTorch on the CPU: bf16
    q/k/v, S = Q K^T in f32 scaled by scale * log2(e), an online softmax
    over 64-key tiles with exp2, the weights rounded to bf16 before P.V,
    the row sums from the f32 weights, and one rounding of
    acc / max(l, 1e-30) to bf16."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = Dh ** -0.5 * np.log2(np.e)
    qf = q.float().transpose(1, 2)                        # [B, Hq, Sq, Dh]
    kf = k.float().repeat_interleave(g, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, 2).transpose(1, 2)
    qpos = q_offset + torch.arange(Sq)[:, None]
    neg = torch.tensor(-1e30)
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, Dh))
    for k0 in range(0, Skv, 64):
        kpos = torch.arange(k0, min(k0 + 64, Skv))[None]
        ok = kpos < kv_len.long()[:, None, None, None]
        if causal:
            ok = ok & (kpos <= qpos)
        if window:
            ok = ok & (kpos > qpos - window)
        s = torch.where(ok, qf @ kf[:, :, k0:k0 + 64].transpose(-1, -2)
                        * scale, neg)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - torch.where(mx == neg, 0.0, mx))
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, k0:k0 + 64]
        m = mx
    return (acc * (1.0 / l.clamp_min(1e-30))).transpose(1, 2).bfloat16()


@pytest.mark.parametrize("B,Sq,q_off,Skv,Hq,Hkv,Dh,causal,window", [
    (3, 77, 63, 140, 4, 2, 64, True, None),     # ragged, 3 key tiles
    (2, 15, 300, 315, 8, 2, 128, True, None),   # deep offset, Dh 128, g 4
    (2, 130, 0, 130, 8, 4, 32, False, 24),      # bidirectional window
    (2, 1, 0, 1, 4, 4, 16, True, None),         # one query, one key
])
def test_tc_body_rounding_within_extend_tol(jx, B, Sq, q_off, Skv, Hq, Hkv,
                                            Dh, causal, window):
    """The tensor-core body's rounding reaches EXTEND_TOL against the JAX
    reference in f32 on the same bf16 inputs."""
    jnp, jops = jx
    q, k, v = (_t(a).bfloat16() for a in _qkv(90, B, Sq, Skv, Hq, Hkv, Dh))
    kv_len = np.random.default_rng(91).integers(1, Skv + 1, B).astype(
        np.int32)
    kv_len[0] = Skv
    kw = dict(causal=causal, window=window, q_offset=q_off)
    out = _tc_body_emulation(q, k, v, kv_len=_i(kv_len), **kw)
    ref = jops.attention(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
                         kv_len=jnp.asarray(kv_len), impl="naive", **kw)
    _close(out, ref, EXTEND_TOL)


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


def _chunked_decode(q, k, v, kv_len, chunk):
    """The CUDA kernel's split-KV schedule in plain torch (f32): per chunk
    of ``chunk`` keys below n = min(kv_len, S), the chunk's max m, sum l
    and unnormalized acc; then chunks 0 .. ceil(n / chunk) - 1 merged in
    order by the log-sum-exp rule and divided by max(l, 1e-30)."""
    B, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qs = q.float() / Dh ** 0.5
    out = torch.zeros(B, Hq, Dh)
    for b in range(B):
        n = min(int(kv_len[b]), S)
        parts = []
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            kc = k[b, c0:c1].float().repeat_interleave(g, dim=1)
            vc = v[b, c0:c1].float().repeat_interleave(g, dim=1)
            s = torch.einsum("hd,khd->hk", qs[b], kc)
            m = s.amax(dim=1)
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(dim=1), torch.einsum("hk,khd->hd", p, vc)))
        if not parts:
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l = torch.zeros(Hq)
        acc = torch.zeros(Hq, Dh)
        for m, lc, ac in parts:
            f = torch.exp(m - mx)
            l = l + lc * f
            acc = acc + ac * f[:, None]
        out[b] = acc / l.clamp_min(1e-30)[:, None]
    return out


@pytest.mark.parametrize("S,Hq,Hkv,Dh", [
    (264, 4, 2, 16),      # S not a chunk multiple
    (256, 8, 2, 32),      # S a chunk multiple: S + 5 and S coincide
])
def test_decode_chunk_merge_matches_jax(jx, S, Hq, Hkv, Dh):
    """The split-KV merge rule at the chunk-edge kv_lens (0, 1, C-1, C,
    C+1, 2C, S, S+5) against the JAX package's decode, f32."""
    jnp, jops = jx
    kv_len = _edge_lens(S)
    B = len(kv_len)
    q = _normal(80, (B, Hq, Dh))
    _, k, v = _qkv(81, B, 1, S, Hq, Hkv, Dh)
    out = _chunked_decode(_t(q), _t(k), _t(v), kv_len, tdec.KV_CHUNK)
    assert torch.equal(out[0], torch.zeros_like(out[0]))      # kv_len 0
    _close(out, tops.decode_attention(_t(q), _t(k), _t(v), _i(kv_len)))
    for impl in ("pallas_interpret", "naive"):
        # kv_len clamped to S for JAX: its Pallas path pads S to a block
        # multiple, and a kv_len past S would unmask the padding
        ref = jops.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(np.minimum(kv_len, S)), impl=impl, block_kv=64)
        _close(out, ref)


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


def test_ptxas_report_parsing(tmp_path):
    """The build's ``-Xptxas -v`` report is read per kernel (registers and
    spill bytes), as ``chip_smoke.py`` prints and checks them."""
    from repro_torch.kernels import _build
    log = tmp_path / "k.log"
    log.write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1aILi64EEv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aILi64EEv\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
        "loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1bv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 32 registers\n")
    assert _build.resources(log) == [
        dict(kernel="_Z1aILi64EEv", registers=96, spill_stores=8,
             spill_loads=4),
        dict(kernel="_Z1bv", registers=32, spill_stores=0, spill_loads=0)]


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


def _edge_lens(S):
    """kv_len at the split-KV chunk edges, past S included."""
    C = tdec.KV_CHUNK
    return np.asarray([0, 1, C - 1, C, C + 1, 2 * C, S, S + 5], np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,Dh,tb,edges", [
    (8, 1088, 32, 8, 64, None, False),  # main path: bucket 1024 + reserve
    (3, 72, 4, 2, 16, 8, False),        # ragged cache, table block 8
    (5, 200, 8, 1, 128, 40, False),     # Dh 128, table block 40
    (2, 96, 6, 3, 32, 96, False),       # one table block per row
    # kv_len at the chunk edges: S not a chunk multiple (llama heads),
    # Dh 128 with table block 40, S a chunk multiple (qwen3 heads)
    (8, 1088, 32, 8, 64, None, True),
    (8, 1000, 8, 1, 128, 40, True),
    (8, 512, 16, 8, 128, None, True),
])
def test_cuda_decode_kernels_match_plain(cuda, dtype, B, S, Hq, Hkv, Dh, tb,
                                         edges):
    N = B + 3
    q = _dev(_normal(50, (B, Hq, Dh)), dtype, cuda)
    ka, va = (_dev(a, dtype, cuda) for a in _arena(51, N, S, Hkv, Dh))
    rng = np.random.default_rng(52)
    slots = rng.permutation(N)[:B].astype(np.int32)
    slots[-1] = N - 1                                  # scratch sentinel
    kv_len = rng.integers(0, S + 1, B).astype(np.int32)
    kv_len[0] = S
    if edges:
        kv_len = _edge_lens(S)
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
@pytest.mark.parametrize("Hq,Hkv,Dh", [(32, 8, 64), (16, 8, 128)])
def test_cuda_decode_deterministic_and_batch_invariant(cuda, Hq, Hkv, Dh):
    """Two calls give bitwise equal outputs, and sequence b's output is
    bitwise the same alone (the other rows the scratch sentinel) as in the
    full batch, at the chunk-edge kv_lens and for both entry points."""
    B, S = 8, 1088
    N = B + 3
    q = _dev(_normal(70, (B, Hq, Dh)), torch.bfloat16, cuda)
    ka, va = (_dev(a, torch.bfloat16, cuda)
              for a in _arena(71, N, S, Hkv, Dh))
    slots = _dev(np.random.default_rng(72).permutation(N - 1)[:B]
                 .astype(np.int32), torch.int32, cuda)
    kl = _dev(_edge_lens(S), torch.int32, cuda)
    full = tops.arena_decode_attention(q, ka, va, slots, kl)
    assert torch.equal(tops.arena_decode_attention(q, ka, va, slots, kl),
                       full)
    kg, vg = ka[slots.long()], va[slots.long()]
    dense = tops.decode_attention(q, kg, vg, kl)
    assert torch.equal(tops.decode_attention(q, kg, vg, kl), dense)
    assert torch.equal(dense, full)
    for b in range(B):
        alone = torch.full_like(slots, N - 1)
        alone[b] = slots[b]
        assert torch.equal(
            tops.arena_decode_attention(q, ka, va, alone, kl)[b], full[b])
        # the dense entry, the other rows' caches zeroed
        kz, vz = torch.zeros_like(kg), torch.zeros_like(vg)
        kz[b], vz[b] = kg[b], vg[b]
        assert torch.equal(tops.decode_attention(q, kz, vz, kl)[b], full[b])


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,Dh", [(32, 8, 64), (16, 8, 128)])
def test_cuda_extend_deterministic_and_batch_invariant(cuda, Hq, Hkv, Dh):
    """Extend: two calls give bitwise equal outputs, and sequence b's
    output is bitwise the same alone (the other rows the scratch sentinel,
    or zeroed caches for the dense entry) as in the full batch, for both
    entry points at the serving shape (384 queries at offset 128)."""
    B, Sq, q_off, kv_valid, S_alloc = 8, 384, 128, 512, 576
    N = B + 3
    q = _dev(_normal(73, (B, Sq, Hq, Dh)), torch.bfloat16, cuda)
    ka, va = (_dev(a, torch.bfloat16, cuda)
              for a in _arena(74, N, S_alloc, Hkv, Dh))
    slots = _dev(np.random.default_rng(75).permutation(N - 1)[:B]
                 .astype(np.int32), torch.int32, cuda)
    kl = _dev(np.asarray([512, 480, 400, 300, 200, 129, 1, 0], np.int32),
              torch.int32, cuda)
    kw = dict(q_offset=q_off, kv_len=kl)
    full = tops.attention_paged(q, ka, va, slots, kv_valid=kv_valid, **kw)
    assert torch.equal(
        tops.attention_paged(q, ka, va, slots, kv_valid=kv_valid, **kw), full)
    kg = ka[slots.long()][:, :kv_valid]
    vg = va[slots.long()][:, :kv_valid]
    dense = tops.attention(q, kg, vg, **kw)
    assert torch.equal(tops.attention(q, kg, vg, **kw), dense)
    assert torch.equal(dense, full)
    assert torch.equal(full[-1], torch.zeros_like(full[-1]))   # kv_len 0
    for b in range(B):
        alone = torch.full_like(slots, N - 1)
        alone[b] = slots[b]
        assert torch.equal(tops.attention_paged(
            q, ka, va, alone, kv_valid=kv_valid, **kw)[b], full[b])
        kz, vz = torch.zeros_like(kg), torch.zeros_like(vg)
        kz[b], vz[b] = kg[b], vg[b]
        assert torch.equal(tops.attention(q, kz, vz, **kw)[b], full[b])


def _extend_case(cuda, dtype, B, Sq, q_off, kv_valid, S_alloc, Hq, Hkv, Dh,
                 causal, window, tb, seed):
    """Paged extend against its plain version; returns (out, plain) after
    asserting paged == dense bitwise."""
    N = B + 2
    q = _dev(_normal(seed, (B, Sq, Hq, Dh)), dtype, cuda)
    ka, va = (_dev(a, dtype, cuda)
              for a in _arena(seed + 1, N, S_alloc, Hkv, Dh))
    rng = np.random.default_rng(seed + 2)
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
    gathered = [(tops._gather_block_rows(a, bt, tb) if bt is not None
                 else a[s.long()])[:, :kv_valid] for a in (ka, va)]
    assert torch.equal(out, tops.attention(q, *gathered, **kw))
    assert torch.isfinite(out).all()
    return out, plain


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
    out, plain = _extend_case(cuda, dtype, B, Sq, q_off, kv_valid, S_alloc,
                              Hq, Hkv, Dh, causal, window, tb, 60)
    torch.testing.assert_close(out.float(), plain.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,q_off,kv_valid,S_alloc,Hq,Hkv,Dh,causal,"
                         "window,tb", [
    (3, 1, 0, 1, 64, 4, 4, 16, True, None, None),       # one query, one key
    (3, 15, 63, 78, 116, 8, 4, 32, True, None, 29),     # table block 29
    (2, 77, 300, 377, 400, 16, 4, 64, True, None, 40),  # deep offset, tb 40
    (2, 130, 0, 130, 160, 8, 2, 128, True, None, 40),   # prefill, Dh 128
    (2, 77, 63, 140, 160, 4, 2, 64, False, None, None),  # bidirectional
    (2, 130, 63, 193, 203, 4, 1, 128, True, 50, 29),    # window, tb 29
    (1, 64, 300, 364, 400, 2, 1, 16, False, 33, 40),    # window, bidir
])
def test_cuda_flash_tc_ragged_edges(cuda, B, Sq, q_off, kv_valid, S_alloc,
                                    Hq, Hkv, Dh, causal, window, tb):
    """The tensor-core body off the 64-tile grid (Sq, kv_valid, q_offset),
    with block tables that cross key tiles mid-way, windows and
    bidirectional masks, within EXTEND_TOL of the plain version."""
    out, plain = _extend_case(cuda, torch.bfloat16, B, Sq, q_off, kv_valid,
                              S_alloc, Hq, Hkv, Dh, causal, window, tb, 100)
    torch.testing.assert_close(out.float(), plain.float(), **EXTEND_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_cuda_flash_tc_head_dims_and_groups(cuda, Dh, g):
    """Every head_dim and GQA group size of the tensor-core body, at a
    ragged shape (77 queries at offset 63, 140 keys, table block 29)."""
    out, plain = _extend_case(cuda, torch.bfloat16, 3, 77, 63, 140, 145,
                              2 * g, 2, Dh, True, None, 29, 110 + Dh + g)
    torch.testing.assert_close(out.float(), plain.float(), **EXTEND_TOL)


@pytest.mark.cuda
def test_cuda_flash_tc_fully_masked_rows_are_zero(cuda):
    """bf16: rows with no visible key (window slid past, kv_len 0) are 0."""
    q, k, v = (_dev(a, torch.bfloat16, cuda)
               for a in _qkv(5, 2, 32, 32, 2, 1, 16))
    out = tops.attention(q, k, v, causal=False, window=4, q_offset=64)
    assert torch.equal(out, torch.zeros_like(out))
    kl = _dev(np.asarray([0, 32], np.int32), torch.int32, cuda)
    out = tops.attention(q, k, v, kv_len=kl)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out).all() and out[1].abs().sum() > 0


@pytest.mark.cuda
def test_cuda_flash_tc_rejects_misaligned_rows(cuda):
    """The tensor-core body copies 16-byte pieces: a bf16 q/k/v whose data
    or strides break 16-byte alignment raises; f32 takes the FMA body."""
    q, k, v = (_dev(a, torch.bfloat16, cuda)
               for a in _qkv(6, 1, 16, 16, 2, 1, 20))
    with pytest.raises(ValueError, match="aligned"):
        tops.attention(q[..., 4:20], k[..., 4:20], v[..., 4:20])
    with pytest.raises(ValueError, match="aligned"):
        tops.attention(q[..., :16], k[..., :16], v[..., :16])
    f = [x.float()[..., :16] for x in (q, k, v)]
    torch.testing.assert_close(
        tops.attention(*f), tfla.flash_attention_plain(*f),
        **_tol(torch.float32))


@pytest.mark.cuda
def test_cuda_fully_masked_rows_are_zero(cuda):
    q, k, v = (_dev(a, torch.float32, cuda) for a in _qkv(5, 1, 32, 32, 2,
                                                          1, 16))
    out = tops.attention(q, k, v, causal=False, window=4, q_offset=64)
    assert torch.equal(out, torch.zeros_like(out))
    kl = _dev(np.zeros(1, np.int32), torch.int32, cuda)
    dec = tops.decode_attention(q[:, 0], k, v, kl)
    assert torch.equal(dec, torch.zeros_like(dec))


# ---------------------------------------------------------------------------
# CUDA: head_dim 256 (recurrentgemma-2b's local layers: 10 query heads over
# one KV head, window 2048)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,q_off,kv_valid,S_alloc,window,tb", [
    (2, 200, 0, 200, 256, 64, None),    # windowed prefill
    (2, 77, 130, 207, 240, None, 40),   # ragged extend, table block 40
    (3, 64, 0, 64, 64, None, None),     # one tile
])
def test_cuda_flash_head_dim_256_matches_plain(cuda, dtype, B, Sq, q_off,
                                               kv_valid, S_alloc, window, tb):
    """Both flash bodies at head_dim 256 (the bf16 one with a two-stage K/V
    ring and Q reloaded from shared memory) against the plain version,
    paged == dense bitwise."""
    out, plain = _extend_case(cuda, dtype, B, Sq, q_off, kv_valid, S_alloc,
                              10, 1, 256, True, window, tb, 200 + Sq)
    tol = EXTEND_TOL if dtype == torch.bfloat16 else _tol(dtype)
    torch.testing.assert_close(out.float(), plain.float(), **tol)


@pytest.mark.cuda
def test_cuda_decode_head_dim_256_matches_plain_and_is_batch_invariant(cuda):
    """bf16 decode at head_dim 256 over a ring of 2048 slots at the chunk
    edges: against the plain version, paged == dense bitwise, two calls
    equal and each sequence alone equal to its row of the batch."""
    B, S, Hq, Hkv, Dh = 8, 2048, 10, 1, 256
    N = B + 3
    q = _dev(_normal(210, (B, Hq, Dh)), torch.bfloat16, cuda)
    ka, va = (_dev(a, torch.bfloat16, cuda)
              for a in _arena(211, N, S, Hkv, Dh))
    slots = _dev(np.random.default_rng(212).permutation(N - 1)[:B]
                 .astype(np.int32), torch.int32, cuda)
    kl = _dev(_edge_lens(S), torch.int32, cuda)
    full = tops.arena_decode_attention(q, ka, va, slots, kl)
    plain = tdec.paged_decode_attention_plain(q, ka, va, slots, kl)
    torch.testing.assert_close(full.float(), plain.float(),
                               **_tol(torch.bfloat16))
    assert torch.equal(tops.arena_decode_attention(q, ka, va, slots, kl),
                       full)
    kg, vg = ka[slots.long()], va[slots.long()]
    assert torch.equal(tops.decode_attention(q, kg, vg, kl), full)
    for b in range(B):
        alone = torch.full_like(slots, N - 1)
        alone[b] = slots[b]
        assert torch.equal(
            tops.arena_decode_attention(q, ka, va, alone, kl)[b], full[b])


def _f32_dh256_case(cuda, seed):
    """recurrentgemma-2b's local heads (10 / 1, head_dim 256) over an f32
    ring of 2048 slots held in an arena, kv_len at the chunk edges."""
    B, S, Hq, Hkv, Dh = 8, 2048, 10, 1, 256
    N = B + 3
    q = _dev(_normal(seed, (B, Hq, Dh)), torch.float32, cuda)
    ka, va = (_dev(a, torch.float32, cuda)
              for a in _arena(seed + 1, N, S, Hkv, Dh))
    slots = _dev(np.random.default_rng(seed + 2).permutation(N - 1)[:B]
                 .astype(np.int32), torch.int32, cuda)
    kl = _dev(_edge_lens(S), torch.int32, cuda)
    return q, ka, va, slots, kl


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["dense", "paged", "paged_tables"])
def test_cuda_decode_f32_cache_head_dim_256_matches_plain(cuda, entry):
    """An f32 cache at head_dim 256 (a key's row is 64 16-byte pieces, two
    a lane): dense, by slots and by block tables against the plain
    version; two calls bitwise; paged == dense bitwise."""
    q, ka, va, slots, kl = _f32_dh256_case(cuda, 220)
    bt, tb = None, None
    if entry == "paged_tables":          # block 0 of every row shared
        tb = 256
        bt = _dev(_tables(slots.cpu().numpy(), ka.shape[1] // tb,
                          shared=ka.shape[0] - 2), torch.int32, cuda)
    kg, vg = (tref.gather_rows(a, slots, bt, tb) for a in (ka, va))
    dense = tops.decode_attention(q, kg, vg, kl)
    if entry == "dense":
        out = dense
        plain = tdec.decode_attention_plain(q, kg, vg, kl)
        again = tops.decode_attention(q, kg, vg, kl)
    else:
        out = tops.arena_decode_attention(q, ka, va, slots, kl,
                                          block_tables=bt)
        plain = tdec.paged_decode_attention_plain(
            q, ka, va, slots, kl, block_tables=bt, table_block=tb)
        again = tops.arena_decode_attention(q, ka, va, slots, kl,
                                            block_tables=bt)
    torch.testing.assert_close(out, plain, **_tol(torch.float32))
    assert torch.equal(again, out)
    assert torch.equal(out, dense)


@pytest.mark.cuda
def test_cuda_decode_lse_f32_cache_head_dim_256_matches_plain(cuda):
    """The log-sum-exp mode over the same f32 cache at head_dim 256: m
    exact where no key is seen and within 1e-5 elsewhere, l within 1e-5
    relative, acc within 1e-5 of l; two calls bitwise; acc / l bitwise
    the normal mode's output."""
    q, ka, va, slots, kl = _f32_dh256_case(cuda, 230)
    k, v = ka[slots.long()], va[slots.long()]
    got = tops.decode_attention_lse(q, k, v, kl)
    want = tdec.decode_attention_lse_plain(q, k, v, kl)
    assert torch.equal(torch.isneginf(got[..., -1]),
                       torch.isneginf(want[..., -1]))
    live = ~torch.isneginf(want[..., -1])
    torch.testing.assert_close(got[..., -1][live], want[..., -1][live],
                               atol=1e-5, rtol=0)
    l = want[..., -2]
    l_rel = ((got[..., -2] - l).abs() / l.clamp_min(1e-30))[live]
    assert float(l_rel.max()) <= 1e-5
    assert float(((got[..., :-2] - want[..., :-2]).abs()
                  / l.clamp_min(1e-30)[..., None]).max()) <= 1e-5
    assert torch.equal(tops.decode_attention_lse(q, k, v, kl), got)
    norm = got[..., :-2] / got[..., -2:-1].clamp_min(1e-30)
    assert torch.equal(norm, tops.decode_attention(q, k, v, kl))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dh,causal,window,q_off,kv_len", [
    (2, 128, 128, 8, 2, 64, True, None, 0, [128, 77]),
    (2, 96, 96, 4, 4, 64, False, None, 0, None),
    (3, 1, 200, 4, 4, 64, False, None, 0, [200, 3, 150]),
    (1, 64, 256, 4, 2, 128, True, 48, 192, None),
])
def test_cuda_flash_attention_fn_grads_match_plain(cuda, dtype, B, Sq, Skv,
                                                   Hq, Hkv, Dh, causal,
                                                   window, q_off, kv_len):
    """``FlashAttentionFn`` on the card (the kernel's forward, PyTorch
    backward) against autograd through the plain version: f32 to 1e-4
    (the FMA body sums in another order), bf16 within 2**-6 of each
    gradient's peak (the backward reads the kernel's bf16 output, see
    ``chip_smoke.GRAD_REL_TOL``); two calls bitwise equal; the forward
    counted as a ``flash_attention`` launch."""
    q, k, v = (_t(a, dtype).to(cuda) for a in _qkv(91, B, Sq, Skv, Hq, Hkv,
                                                   Dh))
    dout = _t(_normal(94, (B, Sq, Hq, Dh)), dtype).to(cuda)
    kl = None if kv_len is None else _i(kv_len).to(cuda)
    kw = dict(causal=causal, window=window, q_offset=q_off, kv_len=kl)

    def grads(fn):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(fn(*leaves, **kw), leaves, dout)

    before = tfla.LAUNCHES["flash_attention"]
    got = grads(tops.attention)
    assert tfla.LAUNCHES["flash_attention"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, grads(tops.attention)))
    ref = grads(tfla.flash_attention_plain)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        else:
            peak = float(b.float().abs().max())
            assert float((a.float() - b.float()).abs().max()) <= \
                2 ** -6 * peak
