"""Rule registry for the port's RSA linter (see
``repro_torch.analysis.__doc__`` for the full catalogue with violating
examples).

A rule is a module exposing ``RULE_ID``, ``SUMMARY``, and
``check(tree, lines, path, pkg) -> Iterator[(line, col, message)]``:
``tree`` is the parsed module, ``lines`` its source lines, ``path`` its
path relative to the linted root, and ``pkg`` the
:class:`~repro_torch.analysis.rules._common.Package` the driver built in
a first pass over that root (every parsed module and the text of every
CUDA source), for the facts one file does not hold (RSA002 compares
``kernels/_build.py``'s ``SIGNATURES`` with ``kernels/csrc/*.cu``).  A
finding is always a line of the ``.py`` file being checked, so the
baseline's ``(rule, file, line text)`` keys stay valid.  The driver
(:mod:`repro_torch.analysis.lint`) owns baseline matching and inline
suppression; rules just report.

Each rule keeps the number of its counterpart in ``repro.analysis``,
redesigned for the port's own hazards; RSA004 is the same rule.
"""
from __future__ import annotations

from . import (rsa001_autograd_function, rsa002_cuda_binding,
               rsa003_arena_commit, rsa004_merge_metadata,
               rsa005_hidden_state)

ALL_RULES = (
    rsa001_autograd_function,
    rsa002_cuda_binding,
    rsa003_arena_commit,
    rsa004_merge_metadata,
    rsa005_hidden_state,
)

RULE_IDS = tuple(r.RULE_ID for r in ALL_RULES)
