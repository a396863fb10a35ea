"""The port's restructuring pre-pass and relevance-score kernel held
against the JAX package.

Inputs come from numpy seeds and go to both packages.  The relevance
score's plain version matches the JAX reference and the Pallas kernel
(interpret mode) to f32 ``atol=2e-5, rtol=1e-5``, the JAX package's own
Pallas-vs-reference bound (the two sum in other orders).  The numpy
helpers (ranges, granularity, hashed embeddings) are exactly equal.  The
classifier trains in torch with the JAX package's Adam: held-out F1 is
exactly equal and ``w``/``b`` agree to ``atol=5e-5`` (f32 products summed
in other orders drift by ulps over hundreds of Adam steps).  The fitted
restructurer gives the same granularity and F1 and the same line order for
every document, also when the corpus is scored in one batch.  The CUDA
kernel's order of sums is emulated on the CPU and held to JAX's scores;
``cuda``-marked tests hold the kernel against its plain version and pin
its bitwise batch invariance (they skip without a card).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import restructure as R  # noqa: E402
from repro_torch.data.documents import generate_corpus  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import relevance_score as rel  # noqa: E402

OP = ("does this opinion overturn a lower court decision overturn reversed "
      "vacated remanded affirmed upheld")
REL_TOL = dict(atol=2e-5, rtol=1e-5)
W_TOL = dict(atol=5e-5, rtol=0)


@pytest.fixture(scope="module")
def J():
    """The JAX package's restructure module (imported lazily)."""
    pytest.importorskip("jax")
    from repro.core import restructure
    return restructure


def _rel_inputs(C, T, D, seed, lengths=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, T, D)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, T + 1, C)
    w = rng.standard_normal(D).astype(np.float32)
    return x, np.asarray(lengths, np.int32), w, np.float32(0.3)


def _jax_scores(x, lengths, w, b, impl):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    return np.asarray(jops.relevance_score(
        jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(w),
        jnp.asarray(b), impl=impl, block_c=8))


def _port_scores(x, lengths, w, b):
    return ops.relevance_score(
        torch.from_numpy(x), torch.from_numpy(lengths),
        torch.from_numpy(w), torch.tensor([b])).numpy()


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("C,T,D", [(8, 16, 32), (16, 8, 64), (24, 4, 16),
                                   (130, 4, 16)])
def test_relevance_plain_matches_jax(J, impl, C, T, D):
    x, lengths, w, b = _rel_inputs(C, T, D, seed=C + T)
    out = _port_scores(x, lengths, w, b)
    assert out.shape == (C,) and out.dtype == np.float32
    np.testing.assert_allclose(out, _jax_scores(x, lengths, w, b, impl),
                               **REL_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_relevance_empty_and_overlong_chunks(J, impl):
    """len 0 scores sigmoid(b); len > T pools all T rows but divides by
    the raw length."""
    T = 4
    x, lengths, w, b = _rel_inputs(8, T, 16, seed=7,
                                   lengths=[0, 1, T, T + 3, 2 * T, 0, 3, 9])
    out = _port_scores(x, lengths, w, b)
    np.testing.assert_allclose(out, _jax_scores(x, lengths, w, b, impl),
                               **REL_TOL)
    np.testing.assert_allclose(out[[0, 5]], 1 / (1 + np.exp(-b)), rtol=1e-6)
    full = x[3].sum(0) @ w
    np.testing.assert_allclose(out[3], 1 / (1 + np.exp(-(full / 7 + b))),
                               rtol=1e-5)


def test_relevance_wrapper_rejects_cpu_tensors():
    x, lengths, w, b = _rel_inputs(4, 4, 16, seed=1)
    with pytest.raises(ValueError):
        rel.relevance_score(torch.from_numpy(x), torch.from_numpy(lengths),
                            torch.from_numpy(w), torch.tensor([b]))


@pytest.mark.cuda
@pytest.mark.parametrize("C,T,D", [(13, 64, 256), (130, 4, 16),
                                   (4096, 64, 256)])
def test_cuda_relevance_kernel_matches_plain(C, T, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lengths = np.random.default_rng(C).integers(0, T + 9, C)
    x, lengths, w, b = _rel_inputs(C, T, D, seed=C, lengths=lengths)
    args = (torch.from_numpy(x).cuda(), torch.from_numpy(lengths).cuda(),
            torch.from_numpy(w).cuda(), torch.tensor([b]).cuda())
    before = rel.LAUNCHES["relevance_score"]
    out = ops.relevance_score(*args)
    assert rel.LAUNCHES["relevance_score"] == before + 1
    plain = ref.relevance_reference(*args)
    torch.testing.assert_close(out, plain, **REL_TOL)
    # rows at or past a chunk's length are never read
    short = int(np.argmin(lengths))
    x2 = args[0].clone()
    x2[short, max(int(lengths[short]), 0):] = float("nan")
    torch.testing.assert_close(ops.relevance_score(x2, *args[1:]), out,
                               atol=0, rtol=0)


def _kernel_order(x, lengths, w, b, warps=4):
    """The CUDA body's order of sums, emulated in f32 on the CPU: warp k
    sums the rows t = k mod ``warps`` (t < min(len, T)) in increasing t,
    the warps' column sums merge as ((s0 + s1) + s2) + s3, lane l dots the
    16-byte column groups l, l + 32, ... with w by fused multiply-adds
    (x, y, z, w of each group in turn) and a xor-shuffle tree (16, 8, 4,
    2, 1) reduces the 32 lanes."""
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    C, T, D = x.shape
    n = torch.from_numpy(np.clip(lengths, 0, T))
    part = torch.zeros((warps, C, D))
    for t in range(T):
        k = t % warps
        part[k] = torch.where((t < n)[:, None], part[k] + x[:, t], part[k])
    merged = part[0]
    for k in range(1, warps):
        merged = merged + part[k]
    D4, lane = D // 4, torch.arange(32)
    s = torch.zeros((C, 32))
    for j in range((D4 + 31) // 32):
        col = lane + 32 * j
        live = col < D4
        for e in range(4):
            d = (4 * col + e).clamp_max(D - 1)
            fma = (merged[:, d].double() * w[d].double() + s.double()).float()
            s = torch.where(live[None], fma, s)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ off]
    logit = s[:, 0] / torch.from_numpy(lengths).float().clamp_min(1) + b
    return torch.sigmoid(logit).numpy()


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("C,T,D", [(8, 16, 32), (24, 4, 16), (130, 4, 16),
                                   (13, 64, 256), (5, 8, 1024)])
def test_kernel_sum_order_matches_jax(J, impl, C, T, D):
    """The redesigned kernel's order of sums (four row groups, a fixed
    merge, FMA dot, shuffle tree) stays within REL_TOL of JAX's scores,
    with empty and overlong chunks among the lengths."""
    lengths = np.random.default_rng(C).integers(0, T + 5, C)
    lengths[0] = 0
    x, lengths, w, b = _rel_inputs(C, T, D, seed=C + D, lengths=lengths)
    np.testing.assert_allclose(_kernel_order(x, lengths, w, b),
                               _jax_scores(x, lengths, w, b, impl), **REL_TOL)


def _cuda_inputs(C, T, D, seed, lengths=None):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, lengths, w, b = _rel_inputs(C, T, D, seed=seed, lengths=lengths)
    return (torch.from_numpy(x).cuda(), torch.from_numpy(lengths).cuda(),
            torch.from_numpy(w).cuda(), torch.tensor([b]).cuda())


@pytest.mark.cuda
def test_cuda_relevance_batch_invariant():
    """A chunk scores the same bits alone and at any offset of a 4096-chunk
    launch, and two calls agree."""
    C, T, D = 4096, 64, 256
    lengths = np.random.default_rng(1).integers(0, T + 9, C)
    x, lengths, w, b = _cuda_inputs(C, T, D, seed=2, lengths=lengths)
    full = rel.relevance_score(x, lengths, w, b)
    assert torch.equal(rel.relevance_score(x, lengths, w, b), full)
    for i in (0, 1, 77, 2048, C - 1):
        alone = rel.relevance_score(x[i:i + 1], lengths[i:i + 1], w, b)
        assert torch.equal(alone, full[i:i + 1]), i
    for lo, hi in ((5, 9), (1000, 1430), (C - 3, C)):
        part = rel.relevance_score(x[lo:hi], lengths[lo:hi], w, b)
        assert torch.equal(part, full[lo:hi]), (lo, hi)


@pytest.mark.cuda
@pytest.mark.parametrize("C,D", [(1, 256), (3, 4), (3, 16), (4097, 256),
                                 (9, 252), (9, 1024), (0, 256)])
def test_cuda_relevance_edges(C, D):
    """len 0, len == T and len > T chunks, ragged C and D, against the
    plain version; C = 0 gives an empty result without a launch."""
    T = 16
    lengths = np.resize([0, T, T + 5, 1, 3 * T, 7], C)
    x, lengths, w, b = _cuda_inputs(C, T, D, seed=C + D, lengths=lengths)
    before = rel.LAUNCHES["relevance_score"]
    out = rel.relevance_score(x, lengths, w, b)
    assert out.shape == (C,)
    assert rel.LAUNCHES["relevance_score"] == before + (C > 0)
    torch.testing.assert_close(out, ref.relevance_reference(x, lengths, w, b),
                               **REL_TOL)


@pytest.mark.cuda
def test_cuda_relevance_rejects_misaligned_x():
    x, lengths, w, b = _cuda_inputs(4, 4, 16, seed=1)
    flat = torch.zeros(x.numel() + 1, device=x.device)
    shifted = flat[1:].view(x.shape)
    with pytest.raises(ValueError, match="aligned"):
        rel.relevance_score(shifted, lengths, w, b)


# ------------------------------------------------------------ numpy helpers

def test_range_helpers_equal(J):
    rng = np.random.default_rng(0)
    for _ in range(50):
        rs = [tuple(sorted(rng.integers(0, 40, 2))) for _ in range(6)]
        assert R.merge_ranges(rs) == J.merge_ranges(rs)
        assert R.expand_ranges(rs, 40) == J.expand_ranges(rs, 40)
    text = "x" * 170 + "\nshort\n" + "y" * 80
    assert R.split_lines(text) == J.split_lines(text)


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_granularity_and_oracle_equal(J, noise):
    from repro.data.documents import generate_corpus as jgen
    docs = generate_corpus(20, avg_lines=30, seed=0)
    jdocs = jgen(20, avg_lines=30, seed=0)
    t = R.determine_granularity(docs, R.SyntheticOracle(noise=noise), 0.9)
    j = J.determine_granularity(jdocs, J.SyntheticOracle(noise=noise), 0.9)
    assert t == j


def test_hash_embedder_equal(J):
    te, je = R.HashEmbedder(), J.HashEmbedder()
    text = "The Court REVERSED the judgment below and remanded " * 12
    for n in (1, 7, 64, 100):
        tt, tn = te.tokens(" ".join(text.split()[:n]))
        jt, jn = je.tokens(" ".join(text.split()[:n]))
        assert tn == jn
        np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(te.pooled(OP), je.pooled(OP))
    assert te.tokens("")[1] == 1


# --------------------------------------------------------------- classifier

def test_classifier_matches_jax(J):
    docs = generate_corpus(30, avg_lines=20, seed=1)
    emb = R.HashEmbedder()
    xs, ys = [], []
    for d in docs:
        for li, line in enumerate(d.lines):
            xs.append(emb.pooled(line))
            ys.append(1 if li in d.relevant_lines else 0)
    x, y = np.stack(xs), np.asarray(ys)
    n = len(y) // 2
    args = (x[:n], y[:n], x[n:], y[n:])
    tw, tb, tf1 = R.train_relevance_classifier(
        *args, init_w=emb.pooled(OP), device="cpu")
    jw, jb, jf1 = J.train_relevance_classifier(*args, init_w=emb.pooled(OP))
    assert tf1 == jf1
    np.testing.assert_allclose(tw, jw, **W_TOL)
    assert abs(tb - jb) <= W_TOL["atol"]


@pytest.fixture(scope="module")
def fitted(J):
    from repro.data.documents import generate_corpus as jgen
    docs = generate_corpus(8, avg_lines=24, seed=5)
    jdocs = jgen(8, avg_lines=24, seed=5)
    t = R.DocumentRestructurer(OP, device="cpu").fit(docs, R.SyntheticOracle())
    j = J.DocumentRestructurer(OP).fit(jdocs, J.SyntheticOracle())
    return t, j, docs, jdocs


def test_fitted_restructurer_matches_jax(fitted):
    t, j, _, _ = fitted
    assert t.granularity == j.granularity
    assert t.f1 == j.f1
    np.testing.assert_allclose(t.w, j.w, **W_TOL)
    assert abs(t.b - j.b) <= W_TOL["atol"]


def test_reorder_equals_jax_for_every_document(fitted):
    t, j, docs, jdocs = fitted
    for d, jd in zip(docs, jdocs):
        np.testing.assert_allclose(t.score_chunks(d), j.score_chunks(jd),
                                   **REL_TOL)
        rd, jrd = t.reorder(d), j.reorder(jd)
        assert rd.lines == jrd.lines
        assert rd.relevant_lines == jrd.relevant_lines


def test_score_chunks_is_unpadded(fitted):
    t, _, docs, _ = fitted
    x, lengths = t.chunk_inputs(docs[0])
    n_chunks = len(t.chunks_of(docs[0]))
    assert x.shape == (n_chunks, R.MAX_CHUNK_WORDS, R.EMBED_DIM)
    assert lengths.dtype == torch.int32
    assert t.score_chunks(docs[0]).shape == (n_chunks,)


def test_embed_corpus_rows_are_chunk_inputs(fitted):
    """The batched input is every document's chunk_inputs, concatenated
    bit for bit."""
    t, _, docs, _ = fitted
    x, lengths, counts = t.embed_corpus(docs)
    per = [t.chunk_inputs(d) for d in docs]
    assert counts == [len(p[1]) for p in per]
    assert torch.equal(x, torch.cat([p[0] for p in per]))
    assert torch.equal(lengths, torch.cat([p[1] for p in per]))


@pytest.mark.parametrize("feed", [1, 7, R.FEED_CHUNKS])
def test_score_corpus_matches_per_document(fitted, feed, monkeypatch):
    """Batched scores, in one feed or several, give every document the
    line order of its own score_chunks.  The plain version's ``pooled @ w``
    is a BLAS product whose order of sums depends on the row count on the
    CPU, so scores are held to REL_TOL here; the kernel's bitwise batch
    invariance is held on the card."""
    t, _, docs, _ = fitted
    monkeypatch.setattr(R, "FEED_CHUNKS", feed)
    batched = t.score_corpus(docs)
    assert len(batched) == len(docs)
    for d, s in zip(docs, batched):
        per = t.score_chunks(d)
        assert s.shape == per.shape and s.dtype == np.float32
        np.testing.assert_allclose(s, per, **REL_TOL)
        assert t.order_lines(d, s) == t.order_lines(d, per)


def test_score_inputs_copies_and_launches_per_feed(fitted, monkeypatch):
    """score_inputs hands the kernel consecutive feeds of at most
    FEED_CHUNKS chunks, each copied on its own, and joins their scores in
    order."""
    t, _, docs, _ = fitted
    x, lengths, _ = t.embed_corpus(docs)
    w, b = t.head()
    calls, score = [], R.ops.relevance_score

    def spy(xf, lf, wf, bf):
        calls.append((xf, lf))
        return score(xf, lf, wf, bf)

    monkeypatch.setattr(R, "FEED_CHUNKS", 7)
    monkeypatch.setattr(R.ops, "relevance_score", spy)
    scores = t.score_inputs(x, lengths, w, b)
    monkeypatch.undo()
    C = x.shape[0]
    assert [len(lf) for _, lf in calls] == [min(7, C - i)
                                            for i in range(0, C, 7)]
    assert torch.equal(torch.cat([xf for xf, _ in calls]), x)
    assert torch.equal(torch.cat([lf for _, lf in calls]), lengths)
    assert torch.equal(scores, torch.cat(
        [score(xf, lf, w, b) for xf, lf in calls]))


def test_reorder_corpus_equals_jax_for_every_document(fitted):
    t, j, docs, jdocs = fitted
    for rd, jd in zip(t.reorder_corpus(docs), jdocs):
        jrd = j.reorder(jd)
        assert rd.lines == jrd.lines
        assert rd.relevant_lines == jrd.relevant_lines


def test_score_corpus_of_no_documents(fitted):
    t, _, docs, _ = fitted
    assert t.score_corpus([]) == []
    assert t.reorder_corpus([]) == []


@pytest.mark.cuda
def test_cuda_score_corpus_equals_per_document(monkeypatch):
    """On the card the corpus's one launch gives every document the bits
    of its own launch, in one feed or several."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    docs = generate_corpus(8, avg_lines=24, seed=5)
    t = dataclasses.replace(
        R.DocumentRestructurer(OP, device="cpu").fit(docs, R.SyntheticOracle()),
        device="cuda")
    per = [t.score_chunks(d) for d in docs]
    for feed in (R.FEED_CHUNKS, 5):
        monkeypatch.setattr(R, "FEED_CHUNKS", feed)
        before = rel.LAUNCHES["relevance_score"]
        batched = t.score_corpus(docs)
        n = sum(len(p) for p in per)
        assert rel.LAUNCHES["relevance_score"] - before == -(-n // feed)
        for s, p in zip(batched, per):
            np.testing.assert_array_equal(s, p)


def test_restructurer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        R.DocumentRestructurer(OP)


# ------------------------------------------ behaviour (tests/test_restructure)

def test_reorder_front_loads_relevance():
    docs = generate_corpus(50, avg_lines=40, seed=3)
    r = R.DocumentRestructurer(OP, device="cpu").fit(
        docs[:35], R.SyntheticOracle(noise=0.1))
    hits = tot = 0
    for d in docs[35:]:
        rd = r.reorder(d)
        top = set(range(max(len(rd.lines) // 4, 1)))
        hits += sum(1 for rl in rd.relevant_lines if rl in top)
        tot += len(rd.relevant_lines)
    assert hits / tot > 0.5            # >> random 0.25


def test_reorder_preserves_content():
    docs = generate_corpus(5, avg_lines=20, seed=4)
    r = R.DocumentRestructurer(OP, device="cpu").fit(docs, R.SyntheticOracle())
    rd = r.reorder(docs[0])
    assert sorted(rd.lines) == sorted(docs[0].lines)
    assert len(rd.relevant_lines) == len(docs[0].relevant_lines)
