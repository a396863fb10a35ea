"""A run whose timed path is broken underneath reads ``correct`` false,
once for each fault a serving cell can have."""
import pytest

torch = pytest.importorskip("torch")

import time  # noqa: E402

import numpy as np  # noqa: E402

import _bench_tiny  # noqa: E402
from bench.harness.core import run_cell  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.engine import CascadeServer, LMBackend  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    with _bench_tiny.one_thread():
        yield


def _answer_altered(monkeypatch):
    orig = LMBackend.class_confidences

    def flipped(self, logits, n_classes):
        pred, conf = orig(self, logits, n_classes)
        return (n_classes - 1) - pred, conf
    monkeypatch.setattr(LMBackend, "class_confidences", flipped)


def _token_altered(monkeypatch):
    orig = CascadeServer._op_tokens

    def shifted(self, backend, op_id):
        toks = orig(self, backend, op_id).copy()
        toks[-1] = toks[-1] + 1 if toks[-1] + 1 < 512 else 17
        return toks
    monkeypatch.setattr(CascadeServer, "_op_tokens", shifted)


def _half_batch_left_out(monkeypatch):
    orig = LMBackend.complete_group

    def half(self, ticket):
        pred, conf, new, cached = orig(self, ticket)
        k = len(conf) // 2
        if k:
            conf = conf.copy()
            conf[k:] = float(np.mean(conf[:k]))
        return pred, conf, new, cached
    monkeypatch.setattr(LMBackend, "complete_group", half)


def _state_unchanged(monkeypatch):
    orig = LM.extend

    def no_write(self, params, batch, states, *a, **kw):
        saved = [{n: t.clone() for n, t in layer.items()}
                 for layer in states]
        logits, _ = orig(self, params, batch, states, *a, **kw)
        for layer, old in zip(states, saved):
            for n, t in layer.items():
                t.copy_(old[n])
        return logits, states
    monkeypatch.setattr(LM, "extend", no_write)


@pytest.mark.parametrize("fault", [_answer_altered, _token_altered,
                                   _half_batch_left_out, _state_unchanged])
def test_bench_fault_reads_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    cell = _bench_tiny.tiny_cell("qwen3-minitron")
    out = run_cell(cell, 31, 1.0, False, "cpu", time.perf_counter(),
                   check_imports=False)
    assert not out["correct"], out["checks"]
