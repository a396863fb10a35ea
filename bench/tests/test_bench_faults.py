"""A run whose timed path is broken underneath reads ``correct`` false,
once for each fault a serving cell can have, and once for a fault of the
experts alone, which the oracle draw's median catches."""
import pytest

torch = pytest.importorskip("torch")

import time  # noqa: E402

import numpy as np  # noqa: E402

import _bench_tiny  # noqa: E402
from bench.harness.core import run_cell  # noqa: E402
from repro_torch.models import moe  # noqa: E402
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


def _experts_second_best(monkeypatch):
    """The router takes the top-k experts ranked after its best k."""
    def second_best(router_w, x, top_k):
        logits = x.float() @ router_w
        w, ids = torch.topk(torch.softmax(logits, dim=-1), 2 * top_k,
                            dim=-1)
        w, ids = w[..., top_k:], ids[..., top_k:]
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return ids, w, logits
    monkeypatch.setattr(moe, "_route", second_best)


# faults of the MoE oracle's layers: run on the MoE pair with its oracle
# draw, and the number that has to catch them
ORACLE_FAULTS = {_experts_second_best: "oracle_margin_p50"}


@pytest.mark.parametrize("fault", [_answer_altered, _token_altered,
                                   _half_batch_left_out, _state_unchanged,
                                   _experts_second_best])
def test_bench_fault_reads_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    number = ORACLE_FAULTS.get(fault)
    if number is None:
        cell = _bench_tiny.tiny_cell("qwen3-minitron")
        out = run_cell(cell, 31, 1.0, False, "cpu", time.perf_counter(),
                       check_imports=False)
        assert not out["correct"], out["checks"]
        return
    # a fixed amount of work, so that the oracle draw is never short
    cell = _bench_tiny.tiny_cell("qwen2vl-phi35moe", oracle_docs=6)
    checks = _bench_tiny.drained_checks(cell, 31)
    c = checks[number]
    assert c["limit"] < c["value"] < 1e30, checks
