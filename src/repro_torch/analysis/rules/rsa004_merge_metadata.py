"""RSA004 — stats dataclasses must carry per-field merge metadata.

``ServeStats.merge_from`` dispatches on each field's declared merge
strategy (``scheduler._stat``: sum / max / concat / stage / shared).  A
field added without metadata would silently fall through to the default
strategy and corrupt multi-tenant aggregation — per-query stats are
merged into the server aggregate and into ``_departed`` on unregister.

The rule applies to every ``@dataclass`` that defines ``merge_from`` or
whose name ends in ``Stats``: each annotated field must be assigned a
``_stat(...)`` (the repo helper) or a ``field(...)`` whose ``metadata``
dict carries a ``"merge"`` key.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Tuple

from . import _common as c

RULE_ID = "RSA004"
SUMMARY = ("dataclasses with merge_from (or *Stats names) must declare a "
           "merge strategy on every field")


def _is_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        name = c.dotted(dec if not isinstance(dec, ast.Call) else dec.func)
        if name in ("dataclass", "dataclasses.dataclass"):
            return True
    return False


def _has_merge_metadata(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    name = (c.dotted(value.func) or "").split(".")[-1]
    if name == "_stat":                     # scheduler helper: _stat(merge)
        return True
    if name == "field":
        meta = c.keyword(value, "metadata")
        if isinstance(meta, ast.Dict):
            return any(isinstance(k, ast.Constant) and k.value == "merge"
                       for k in meta.keys)
        return meta is not None             # dynamic metadata: trust it
    return False


def check(tree: ast.Module, lines: List[str], path: str, pkg: c.Package
          ) -> Iterator[Tuple[int, int, str]]:
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef) or not _is_dataclass(cls):
            continue
        has_merge = any(isinstance(n, c.FuncDef) and n.name == "merge_from"
                        for n in cls.body)
        if not (has_merge or cls.name.endswith("Stats")):
            continue
        for node in cls.body:
            if not isinstance(node, ast.AnnAssign) or \
                    not isinstance(node.target, ast.Name):
                continue
            fname = node.target.id
            if fname.startswith("_"):
                continue
            ann = c.dotted(node.annotation) or ""
            if ann.endswith("ClassVar"):
                continue
            if node.value is None or not _has_merge_metadata(node.value):
                yield (node.lineno, node.col_offset,
                       f"field {cls.name}.{fname} lacks merge metadata "
                       f"(use _stat(<strategy>) or field(metadata="
                       f"{{'merge': ...}}) so merge_from knows how to "
                       f"aggregate it)")
