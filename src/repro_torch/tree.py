"""Nested parameter trees: dicts, lists, tuples and NamedTuples whose
leaves are tensors (or None).

The port keeps parameters, optimizer moments and serve states as plain
nested containers, as the JAX package keeps pytrees; these helpers are
the few pytree operations the training path needs.  Leaves are visited
in container order (dict insertion order), which is the order of
``leaves`` and of every ``tree_map`` result.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` with paths like ``params/layers/0/attn/wq``
    (dict keys, list and tuple indices, NamedTuple field names)."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out.extend(leaves_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]
