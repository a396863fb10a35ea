"""Shared AST helpers for the port's RSA rules.

Everything here is pure AST and text (no imports of the linted code, no
torch): rules must run on any checkout without executing it.  Resolution
is heuristic by design — a name is resolved through the module's own
imports, a local alias through the assignments of the same function —
and rules should prefer false negatives over false positives (the
baseline absorbs judgement calls, it should not absorb noise).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclass
class Package:
    """What a rule may know beyond the file it checks.

    The driver builds one per linted root in a first pass: ``modules``
    holds every ``.py`` file that parsed, ``cuda`` the text of every
    ``.cu``/``.cuh`` source, both keyed by the path relative to the root.
    Facts derived from the whole package (the ``SIGNATURES`` table, the
    ``extern "C"`` declarations) are computed once through ``memo``.
    """
    modules: Dict[str, ast.Module] = field(default_factory=dict)
    cuda: Dict[str, str] = field(default_factory=dict)
    _memo: Dict[str, Any] = field(default_factory=dict, repr=False)

    def memo(self, key: str, build: Callable[["Package"], Any]) -> Any:
        if key not in self._memo:
            self._memo[key] = build(self)
        return self._memo[key]


def dotted(node: ast.AST) -> Optional[str]:
    """``torch.nn.functional.pad`` for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def nodes(tree: ast.AST) -> List[ast.AST]:
    """Every node of ``tree`` (``ast.walk`` order), listed once per tree
    and shared by the rules."""
    cached = getattr(tree, "_rsa_nodes", None)
    if cached is None:
        cached = tree._rsa_nodes = list(ast.walk(tree))  # type: ignore
    return cached


def import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local name -> the module path it stands for, from every absolute
    import of the module (``import torch.nn as nn`` gives ``nn ->
    torch.nn``, ``from time import perf_counter`` gives ``perf_counter ->
    time.perf_counter``)."""
    out: Dict[str, str] = {}
    for node in nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    top = a.name.split(".")[0]
                    out[top] = top
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def qualified(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """``dotted(node)`` with its first segment resolved through
    ``aliases`` (``np.random.rand`` -> ``numpy.random.rand``)."""
    name = dotted(node)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{rest}" if rest else head


def subclasses(tree: ast.AST, aliases: Dict[str, str],
               base: str) -> Iterator[ast.ClassDef]:
    """Classes of the module with a base that resolves to ``base``
    (``torch.autograd.Function``, ``torch.nn.Module``)."""
    for node in nodes(tree):
        if isinstance(node, ast.ClassDef) and any(
                qualified(b, aliases) == base for b in node.bases):
            yield node


def methods(cls: ast.ClassDef) -> Dict[str, ast.AST]:
    return {n.name: n for n in cls.body if isinstance(n, FuncDef)}


def own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Nodes of ``fn``'s body, not descending into nested functions,
    lambdas or classes (their returns and bindings are their own)."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (*FuncDef, ast.Lambda, ast.ClassDef)):
            todo.extend(ast.iter_child_nodes(node))


def annotate_parents(tree: ast.AST) -> None:
    if getattr(tree, "_rsa_annotated", False):
        return
    for node in nodes(tree):
        for child in ast.iter_child_nodes(node):
            child._rsa_parent = node            # type: ignore[attr-defined]
    tree._rsa_annotated = True                  # type: ignore[attr-defined]


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_rsa_parent", None)


def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    """The innermost FunctionDef around ``node`` (requires
    ``annotate_parents``), or None at module level."""
    cur = parent(node)
    while cur is not None and not isinstance(cur, FuncDef):
        cur = parent(cur)
    return cur


def module_of(node: ast.AST) -> ast.AST:
    """The root of ``node``'s tree (requires ``annotate_parents``)."""
    while parent(node) is not None:
        node = parent(node)
    return node


def keyword(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def last_name(call: ast.Call) -> str:
    """The called name's last segment: ``check`` for ``_build.check``."""
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    return func.id if isinstance(func, ast.Name) else ""


MUTABLE_DISPLAYS = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                    ast.SetComp)
MUTABLE_FACTORIES = ("list", "dict", "set", "collections.defaultdict",
                     "defaultdict", "collections.OrderedDict",
                     "OrderedDict", "collections.deque", "deque",
                     "bytearray")


def is_mutable_value(node: ast.AST) -> bool:
    if isinstance(node, MUTABLE_DISPLAYS):
        return True
    if isinstance(node, ast.Call):
        return dotted(node.func) in MUTABLE_FACTORIES
    return False
