"""RSA003 — in-place arena writes commit on success.

The port's counterpart of the reference's donation safety
(``repro/analysis/rules/rsa003_donation.py``).  The reference donates
the arena to a jitted step and rebinds it only after the step returns,
so a step that raises leaves the old arena in place.  The port writes
the arena IN PLACE: a paged ``model.decode_step(..., slots=...)`` lands
its key/value at positions ``[kv_true, kv_true + op_len)`` of each
addressed row, below the committed length, where live document KV may
lie.  A step that raises half way through would leave them written.

So a ``decode_step(..., slots=...)`` call must lie lexically inside the
body of a ``try`` whose ``finally`` calls ``put_kv_window(...)`` with
the value that a ``take_kv_window(...)`` earlier in the same function
returned — the undo log of the engine's ``_paged_step`` and
``_prefix_step``.  Minimal violation::

    saved = model.take_kv_window(arena, slots, pos, n)
    logits, _ = model.decode_step(params, tok, arena, pos, slots=slots)
    model.put_kv_window(arena, slots, pos, n, saved)   # skipped on raise

Exempt by design: ``model.extend(..., slots=...)`` writes only at or
above each row's committed ``cached_len``, which the server advances
only after the step returns, so no later read sees a failed extend's
writes.  A ``take_kv_window``/``put_kv_window`` pair used as a copy (the
copy-on-write of a prefix's rows) involves no ``decode_step`` and is not
matched.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from . import _common as c

RULE_ID = "RSA003"
SUMMARY = ("decode_step(..., slots=...) writes the arena in place: it must "
           "run inside try/finally that restores a take_kv_window snapshot "
           "with put_kv_window")


def _snapshots(scope: ast.AST, before: int) -> Set[str]:
    """Names bound to a ``take_kv_window(...)`` result in ``scope`` on a
    line before ``before``."""
    out = set()
    for node in (c.own_nodes(scope) if isinstance(scope, c.FuncDef)
                 else ast.walk(scope)):
        if isinstance(node, ast.Assign) and node.lineno < before and \
                isinstance(node.value, ast.Call) and \
                c.last_name(node.value) == "take_kv_window":
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return out


def _restores(try_: ast.AST, snapshots: Set[str]) -> bool:
    for stmt in try_.finalbody:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and \
                    c.last_name(node) == "put_kv_window" and any(
                        isinstance(a, ast.Name) and a.id in snapshots
                        for a in node.args + [k.value
                                              for k in node.keywords]):
                return True
    return False


def _guarded(call: ast.Call) -> bool:
    scope: Optional[ast.AST] = c.enclosing_function(call)
    child, node = call, c.parent(call)
    while node is not None and node is not scope:
        if isinstance(node, (ast.Try, ast.TryStar)) and any(
                child is s for s in node.body):
            top = scope or c.module_of(node)
            if _restores(node, _snapshots(top, node.lineno)):
                return True
        child, node = node, c.parent(node)
    return False


def check(tree: ast.Module, lines: List[str], path: str, pkg: c.Package
          ) -> Iterator[Tuple[int, int, str]]:
    c.annotate_parents(tree)
    for call in c.nodes(tree):
        if not isinstance(call, ast.Call) or \
                c.last_name(call) != "decode_step":
            continue
        slots = c.keyword(call, "slots")
        if slots is None or (isinstance(slots, ast.Constant)
                             and slots.value is None):
            continue
        if not _guarded(call):
            yield (call.lineno, call.col_offset,
                   "decode_step(..., slots=...) writes arena rows in place "
                   "outside a try whose finally restores a take_kv_window "
                   "snapshot with put_kv_window: a step that raises leaves "
                   "the rows written (commit on success is lost)")
