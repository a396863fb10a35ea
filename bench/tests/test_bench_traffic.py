"""The traffic generator: deterministic per seed, fresh documents of the
same sizes and classes for every seed, and the distributions its mix
files state."""
import pytest

pytest.importorskip("torch")

import math  # noqa: E402
import statistics  # noqa: E402

import numpy as np  # noqa: E402

import _bench_tiny  # noqa: E402,F401  (puts the repo on the path)
from bench.traffic.generator import (CLASS_SIGNALS,  # noqa: E402
                                     DISTRACTOR_SIGNALS, length_grid,
                                     make_text, make_traffic)

MIX = {"block": 64, "length": {"median_tokens": 1000, "sigma": 0.45,
                               "min_tokens": 512, "max_tokens": 2048}}


def _texts(t):
    return [d.text for ds in t.docs for d in ds]


def _label(text):
    words = set(text.split())
    hits = [c for c, sig in enumerate(CLASS_SIGNALS) if words & set(sig)]
    assert len(hits) == 1
    return hits[0]


def test_bench_traffic_deterministic_per_seed():
    a = make_traffic(MIX, 2**33 + 7, 64, 2)
    b = make_traffic(MIX, 2**33 + 7, 64, 2)
    c = make_traffic(MIX, 2**33 + 8, 64, 2)
    assert _texts(a) == _texts(b)
    assert _texts(a) != _texts(c)
    assert _texts(make_traffic(MIX, -5, 64, 2)) != \
        _texts(make_traffic(MIX, 5, 64, 2))


def test_bench_traffic_same_sizes_fresh_documents_every_seed():
    lens, texts = [], []
    for seed in (1, 99, 2**31 + 5):
        t = make_traffic(MIX, seed, 3 * MIX["block"], 2)
        docs = sorted((d for ds in t.docs for d in ds),
                      key=lambda d: d.doc_id)
        for k in range(3):
            block = docs[k * MIX["block"]:(k + 1) * MIX["block"]]
            assert sorted(d.n_tokens for d in block) == \
                length_grid(MIX["length"], MIX["block"]).tolist()
            labels = [_label(d.text) for d in block]
            assert labels.count(0) == labels.count(1)
        lens.append([d.n_tokens for d in docs])
        texts.append(_texts(t))
        assert len(set(texts[-1])) == len(texts[-1])     # none repeats
    assert sorted(lens[0]) == sorted(lens[1]) == sorted(lens[2])
    assert lens[0] != lens[1]                  # dealt in another order
    assert not set(texts[0]) & set(texts[1])


def test_bench_traffic_lengths_and_tenants():
    t = make_traffic(MIX, 5, 200, 2)
    docs = [d for ds in t.docs for d in ds]
    assert len(docs) == 256                    # whole blocks
    for d in docs:
        assert len(d.text.split()) == d.n_tokens
        assert 512 <= d.n_tokens <= 2048
        assert d.tenant == d.doc_id % 2


def test_bench_traffic_distributions():
    lens = length_grid(MIX["length"], 4096)
    assert abs(statistics.median(lens) - 1000) <= 1
    logs = np.log(lens[(lens > 512) & (lens < 2048)])
    inner = np.log(length_grid(dict(MIX["length"], min_tokens=1,
                                    max_tokens=10**9), 4096))
    assert abs(np.std(inner) - 0.45) < 0.01
    assert logs.min() >= math.log(512)
    # a document's signal and distractor lines
    rng = np.random.default_rng(3)
    n_dis = n_other = 0
    for label in (0, 1):
        for n in (1, 7, 10, 95, 1000):
            text = make_text(rng, n, label, 3, 0.3)
            lines = text.split("\n")
            assert [len(li.split()) for li in lines] == \
                [10] * (n // 10) + ([n % 10] if n % 10 else [])
            sig = [li for li in lines
                   if set(li.split()) & set(CLASS_SIGNALS[label])]
            assert len(sig) == min(3, len(lines))
            assert not set(text.split()) & set(CLASS_SIGNALS[1 - label])
            other = [li for li in lines if li not in sig]
            n_other += len(other)
            n_dis += sum(bool(set(li.split()) & set(DISTRACTOR_SIGNALS))
                         for li in other)
    assert 0.2 < n_dis / n_other < 0.4


def test_bench_traffic_more_documents_from_the_same_stream():
    a = make_traffic(MIX, 41, 10, 2)
    b = make_traffic(MIX, 41, 10, 2)
    a.more(30)
    b.more(100)
    assert a.made == 128 and len(a.docs[1]) == 64
    ids_a = sorted(d.doc_id for ds in a.docs for d in ds)
    assert ids_a == list(range(128))
    by_id = {d.doc_id: d.text for ds in b.docs for d in ds}
    assert all(by_id[d.doc_id] == d.text for ds in a.docs for d in ds)
