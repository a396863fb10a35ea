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
every document.  One ``cuda``-marked test holds the CUDA kernel against
its plain version (it skips without a card).
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
