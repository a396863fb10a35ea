"""Readers shared by the metric files of ``bench/metrics``.

Each takes the run's ``Ctx`` and returns a number, or None where the run
holds nothing to read (the harness then leaves the metric out).  Shares
are in percent.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from ..reference.cascade import frac_len
from ..reference.tokenizer import Tokenizer
from ..work.formulas import (PEAK_BF16_FLOPS, DocStep, launch_model_flops,
                             least_seconds)
from .trace import busy_seconds, kernel_class


# ------------------------------------------------------------ end to end
def setup_s(ctx) -> float:
    return ctx.t_open - ctx.t_start


def docs_per_s(ctx) -> Optional[float]:
    if ctx.window_s <= 0:
        return None
    return sum(r.status == "resolved" for r in ctx.docs) / ctx.window_s


# --------------------------------------------------- server and scheduler
def host_ms_per_launch(ctx) -> Optional[float]:
    """Host time inside ``server.step`` that is not the wait on a
    launch's completion, per launch of the window."""
    if not ctx.records:
        return None
    wait = sum(r.device_s for r in ctx.records)
    return (ctx.step_s - wait) / len(ctx.records) * 1e3


def docs_per_launch(ctx) -> Optional[float]:
    if not ctx.records:
        return None
    return sum(r.batch for r in ctx.records) / len(ctx.records)


def dispatch_ms_per_launch(ctx) -> Optional[float]:
    if not ctx.records:
        return None
    return sum(r.dispatch_s for r in ctx.records) / len(ctx.records) * 1e3


def cached_token_share(ctx) -> Optional[float]:
    total = ctx.new_tokens + ctx.cached_tokens
    return 100.0 * ctx.cached_tokens / total if total else None


# ---------------------------------------------------------------- device
def _window_ops(ctx):
    return [o for o in ctx.ops if o.end > ctx.t_open
            and o.start < ctx.t_close]


def device_idle_share(ctx) -> Optional[float]:
    if ctx.ops is None or ctx.window_s <= 0:
        return None
    busy = busy_seconds(ctx.ops, ctx.t_open, ctx.t_close)
    return 100.0 * (1.0 - busy / ctx.window_s)


def busy_share_of(ctx, cls: str) -> Optional[float]:
    if ctx.ops is None:
        return None
    tot = by = 0.0
    for o in _window_ops(ctx):
        dt = min(o.end, ctx.t_close) - max(o.start, ctx.t_open)
        tot += dt
        if kernel_class(o.name) == cls:
            by += dt
    return 100.0 * by / tot if tot else None


def _launch_ops(ctx):
    """The device operations of the launches dispatched in the window:
    every operation from the trace's open marker on.  The trace opens on
    an idle device and closes once the device has finished the last of
    them, and nothing else is enqueued meanwhile."""
    return [o for o in ctx.ops if o.start >= ctx.trace_from]


def kernel_seconds(ctx, names: Iterable[str]) -> float:
    names = tuple(names)
    return sum(o.end - o.start for o in _launch_ops(ctx)
               if any(n in o.name for n in names))


# ------------------------------------------------------------ launch work
def _doc_steps(ctx, launch) -> List[DocStep]:
    """Each real document of a launch as the formulas take it."""
    rec = launch["rec"]
    tok = Tokenizer(ctx.cell.config["tokenizer_vocab"])
    op_len = len(tok.encode(ctx.cell.config["operations"][rec.op_id]))
    out = []
    for n_tokens, tenant, stage in launch["docs"]:
        frac = ctx.stages[tenant][stage].fraction
        c = min(rec.cached_len, n_tokens)
        new = max(0, min(rec.f_len, n_tokens) - c) \
            if rec.f_len > rec.cached_len else 0
        out.append(DocStep(c, new, frac_len(n_tokens, frac), op_len))
    return out


def roofline(ctx, kernels: Sequence[str], part: str) -> Optional[float]:
    """Least time of the attention work (``extend`` or ``decode``) of the
    launches dispatched in the window over the device time of
    ``kernels`` in the same launches, in percent."""
    if not ctx.launches or ctx.ops is None:
        return None
    least = 0.0
    for launch in ctx.launches:
        model = launch["rec"].model
        fam, spec = ctx.cell.family(model), ctx.specs[model]
        layers = fam.attention_layers(spec)
        steps = _doc_steps(ctx, launch)
        if part == "extend":
            f, b = fam.extend_call(spec, [(d.cached, d.new) for d in steps])
            if f > 0:
                least += layers * least_seconds(f, b)
        else:
            for t in range(steps[0].op_len if steps else 0):
                f, b = fam.decode_call(spec, [d.kv + t + 1 for d in steps])
                least += layers * least_seconds(f, b)
    spent = kernel_seconds(ctx, kernels)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent


def mfu(ctx) -> Optional[float]:
    """Useful model operations of the launches dispatched in the window
    over the seconds from the window's open until the device finished
    them, at the card's published bf16 peak, in percent."""
    if not ctx.launches or ctx.ops is None:
        return None
    ops = _launch_ops(ctx)
    if not ops:
        return None
    span = max(o.end for o in ops) - ctx.t_open
    flops = sum(launch_model_flops(ctx.cell.family(l["rec"].model),
                                   ctx.specs[l["rec"].model],
                                   _doc_steps(ctx, l))
                for l in ctx.launches)
    return 100.0 * flops / (span * PEAK_BF16_FLOPS)
