"""The reader of the program's decode-graph record
(``bench/metrics/decode_graph_share.batch.py``) on synthetic records."""
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import _bench_tiny  # noqa: E402
from bench.harness.spec import reader  # noqa: E402

NAME = "decode_graph_share.batch"


def _read(records):
    return reader(NAME, _bench_tiny.ROOT / "bench")(
        SimpleNamespace(records=records))


def test_bench_decode_graph_share_counts_replays():
    recs = [SimpleNamespace(decode_graph=m)
            for m in ("replay", "replay", "capture", "eager")]
    assert _read(recs) == pytest.approx(50.0)
    assert _read(recs[:2]) == pytest.approx(100.0)


def test_bench_decode_graph_share_is_silent_without_the_field():
    """A program that does not record how the decode ran (the parent of
    the change that added it), or a window without launches: None, so
    the harness leaves the metric out."""
    assert _read([SimpleNamespace(batch=4)]) is None
    assert _read([]) is None
