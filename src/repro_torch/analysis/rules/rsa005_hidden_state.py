"""RSA005 — no hidden random or clock state.

The port's counterpart of the reference's wall-clock/RNG rule
(``repro/analysis/rules/rsa005_wallclock.py``).  The reference threads
``jax.random`` keys, so every draw is a function of a seed it is given;
the port's convention is the same with explicit generators: weights come
from a ``torch.Generator`` made from the seed (``generator=gen``), data
from ``np.random.default_rng(seed)``.  A draw from a global stream
instead depends on every draw made before it in the process, so a
result changes with the order of tests, phases or ranks.  Three checks:

  * **(a) torch draws without ``generator=``**: ``torch.rand``,
    ``randn``, ``randint``, ``randperm``, ``normal``, ``bernoulli``,
    ``multinomial``, ``poisson``, the ``*_like`` variants, and the
    in-place ``.uniform_``, ``.normal_``, ``.random_``, ``.bernoulli_``,
    ``.exponential_`` (and the other in-place samplers).
  * **(b) global-state ``np.random.<fn>`` and ``random.<fn>`` calls**.
    Constructors of a stream of one's own are allowed:
    ``default_rng``, ``Generator``, ``SeedSequence`` and the bit
    generators, and ``RandomState(<seed>)`` / ``random.Random(<seed>)``
    with a seed.
  * **(c) ``time.*``/``datetime.*`` reads inside the ``forward`` or
    ``backward`` of a ``torch.autograd.Function`` or an ``nn.Module``**:
    under a CUDA-graph capture of the step (the serving remedy for its
    launch overhead) such a read runs once at capture and freezes into
    every replay, exactly as under ``jit``.  Host loops that time a step
    from outside are not in scope.

Names resolve through the module's imports (``import numpy as np``,
``from time import perf_counter``), so a local variable that happens to
be called ``random`` is not matched.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Tuple

from . import _common as c

RULE_ID = "RSA005"
SUMMARY = ("random draws take an explicit generator (torch generator=, "
           "np.random.default_rng); no time.*/datetime.* reads inside "
           "autograd.Function or nn.Module forward/backward")

_TORCH_DRAWS = {f"torch.{n}" for n in (
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like")}
_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_",
                  "exponential_", "cauchy_", "log_normal_", "geometric_"}
_OWN_STREAMS = {f"numpy.random.{n}" for n in (
    "default_rng", "Generator", "SeedSequence", "BitGenerator", "PCG64",
    "PCG64DXSM", "Philox", "MT19937", "SFC64")}
_SEEDED_STREAMS = {"numpy.random.RandomState", "random.Random"}
_CLOCK_READS = {
    "time.time", "time.perf_counter", "time.monotonic", "time.time_ns",
    "time.perf_counter_ns", "time.monotonic_ns", "time.process_time",
    "time.process_time_ns", "time.thread_time", "time.thread_time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today"}


def _draws(tree: ast.Module, aliases: Dict[str, str]
           ) -> Iterator[Tuple[int, int, str]]:
    for node in c.nodes(tree):
        if not isinstance(node, ast.Call):
            continue
        # only names that come from an import: a local called ``random``
        # is not the module
        head = (c.dotted(node.func) or "").split(".")[0]
        name = c.qualified(node.func, aliases) if head in aliases else ""
        seeded = c.keyword(node, "generator") is not None
        if name in _TORCH_DRAWS and not seeded:
            yield (node.lineno, node.col_offset,
                   f"{name}() without generator= draws from the global "
                   f"torch stream (pass a torch.Generator made from the "
                   f"seed)")
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _INPLACE_DRAWS and not seeded:
            yield (node.lineno, node.col_offset,
                   f".{node.func.attr}() without generator= draws from the "
                   f"global torch stream (pass a torch.Generator made from "
                   f"the seed)")
        elif name.startswith(("numpy.random.", "random.")) and \
                name not in _OWN_STREAMS and not (
                    name in _SEEDED_STREAMS and (node.args or node.keywords)):
            yield (node.lineno, node.col_offset,
                   f"{name}() draws from a stream no seed of the caller "
                   f"fixes (the process-global state or fresh entropy); use "
                   f"np.random.default_rng(seed) or a generator passed in")


def _clock_reads(tree: ast.Module, aliases: Dict[str, str]
                 ) -> Iterator[Tuple[int, int, str]]:
    classes = list(c.subclasses(tree, aliases, "torch.autograd.Function"))
    classes += c.subclasses(tree, aliases, "torch.nn.Module")
    for cls in classes:
        for mname, fn in c.methods(cls).items():
            if mname not in ("forward", "backward"):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and \
                        c.qualified(node.func, aliases) in _CLOCK_READS:
                    yield (node.lineno, node.col_offset,
                           f"{c.dotted(node.func)}() inside "
                           f"{cls.name}.{mname}: a CUDA-graph capture runs "
                           f"it once and replays the frozen value (time "
                           f"the step from the host loop instead)")


def check(tree: ast.Module, lines: List[str], path: str, pkg: c.Package
          ) -> Iterator[Tuple[int, int, str]]:
    aliases = c.import_aliases(tree)
    yield from _draws(tree, aliases)
    yield from _clock_reads(tree, aliases)
