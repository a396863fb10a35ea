"""RSA001 — ``torch.autograd.Function`` hygiene.

The port's counterpart of the reference's jit-signature hygiene
(``repro/analysis/rules/rsa001_jit_signature.py``): where the reference
hands JAX a traced function and lets it derive the backward, the port
writes backwards by hand (the attention gradient, the f32 head, the
sLSTM scan through time, the collectives of tensor parallelism), and
PyTorch checks little of what such a class does.  For every class that
derives from ``torch.autograd.Function``:

  * **(a) a tensor reaches ``backward`` only through
    ``ctx.save_for_backward``.**  ``ctx.<attr> = <expr>`` in ``forward``
    fires where ``<expr>`` is a ``torch.*`` tensor op, a tensor method
    (``.detach()``, ``.clone()``, ``.to(...)``, ...) of a tensor, or a
    parameter or local of ``forward`` that the body shows to be a
    tensor: annotated ``torch.Tensor``, passed to ``save_for_backward``,
    assigned only from tensor ops, or used with a tensor attribute or
    method (``.shape``, ``.dtype``, ``.is_cuda``, ``.view_as(``, ...).
    A value that is only passed on (a process group, a layout object)
    shows nothing and is fine.  A tensor stored as a plain attribute
    escapes the version counter: an in-place change between forward and
    backward gives wrong gradients without a word.
  * **(b) ``backward`` returns one gradient per input of ``forward``.**
    A literal tuple must have exactly as many items as ``forward`` takes
    after ``ctx``.  PyTorch checks this only when that backward runs, and
    on the CPU several of the port's backwards run only across ranks.  A
    return with a starred item, and a ``forward`` with ``*args``, are
    skipped: their length is not static.
  * **(c) no mutable default argument** on ``forward`` or ``backward``:
    one object shared by every call.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from . import _common as c

RULE_ID = "RSA001"
SUMMARY = ("autograd.Function: tensors reach backward only through "
           "save_for_backward, backward returns one gradient per forward "
           "input, no mutable default arguments")

# attributes and methods only a tensor has among the values a forward
# takes: a parameter used with one of them is a tensor
_TENSOR_ATTRS = {
    "shape", "dtype", "is_cuda", "is_meta", "ndim", "data_ptr", "stride",
    "dim", "numel", "element_size", "is_contiguous", "contiguous", "view",
    "view_as", "reshape", "to", "float", "half", "bfloat16", "detach",
    "clone", "transpose", "permute", "unsqueeze", "squeeze", "expand",
    "expand_as", "requires_grad", "requires_grad_", "new_zeros",
    "new_empty", "new_ones", "new_full", "masked_fill", "narrow", "flatten",
    "type_as", "storage_offset"}
# tensor methods whose result is a tensor
_TENSOR_RESULTS = {
    "contiguous", "view", "view_as", "reshape", "to", "float", "half",
    "bfloat16", "detach", "clone", "transpose", "permute", "unsqueeze",
    "squeeze", "expand", "expand_as", "new_zeros", "new_empty", "new_ones",
    "new_full", "masked_fill", "narrow", "flatten", "type_as"}
# ``torch.*`` calls whose result is no tensor
_NOT_TENSOR = {
    "torch.device", "torch.Size", "torch.dtype", "torch.finfo",
    "torch.iinfo", "torch.Generator", "torch.no_grad", "torch.enable_grad",
    "torch.inference_mode", "torch.autocast", "torch.manual_seed",
    "torch.promote_types", "torch.result_type", "torch.can_cast",
    "torch.equal", "torch.allclose", "torch.numel", "torch.typename"}
_TENSOR_NAMESPACES = ("torch.nn.functional.", "torch.linalg.", "torch.fft.",
                      "torch.special.")


def _torch_op(call: ast.Call, aliases: Dict[str, str]) -> bool:
    name = c.qualified(call.func, aliases) or ""
    if name.startswith(_TENSOR_NAMESPACES):
        return True
    parts = name.split(".")
    return (len(parts) == 2 and parts[0] == "torch"
            and name not in _NOT_TENSOR
            and not parts[1].startswith(("is_", "get_", "set_", "use_"))
            and not parts[1][:1].isupper())


class _Forward:
    """What ``forward``'s body shows about its names."""

    def __init__(self, fn: ast.AST, ctx: str, inputs: List[str],
                 aliases: Dict[str, str]):
        self.fn, self.ctx, self.aliases = fn, ctx, aliases
        nodes = list(c.own_nodes(fn))
        self.tensors: Set[str] = set()
        args = fn.args.posonlyargs + fn.args.args
        for a in args:
            if a.arg in inputs and a.annotation is not None and \
                    c.qualified(a.annotation, aliases) == "torch.Tensor":
                self.tensors.add(a.arg)
        for node in nodes:
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in inputs and node.attr in _TENSOR_ATTRS:
                self.tensors.add(node.value.id)
            elif isinstance(node, ast.Call) and \
                    c.dotted(node.func) == f"{ctx}.save_for_backward":
                self.tensors |= {a.id for a in node.args
                                 if isinstance(a, ast.Name)}
        # locals bound only to tensor expressions
        bound: Dict[str, bool] = {}
        for node in nodes:
            targets, ok = [], False
            if isinstance(node, ast.Assign):
                targets = node.targets
                ok = isinstance(node.value, ast.Call) and \
                    _torch_op(node.value, aliases)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For,
                                   ast.NamedExpr)):
                targets = [node.target]
            elif isinstance(node, ast.withitem) and node.optional_vars:
                targets = [node.optional_vars]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and \
                            isinstance(n.ctx, ast.Store):
                        # only a bare name bound to a tensor op counts
                        bound[n.id] = bound.get(n.id, True) and ok \
                            and n is t
        self.tensors |= {n for n, ok in bound.items()
                         if ok and n not in inputs}
        self.nodes = nodes

    def is_tensor(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.tensors
        if isinstance(expr, ast.Subscript):
            return self.is_tensor(expr.value)
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Attribute) and f.attr in _TENSOR_RESULTS \
                    and self.is_tensor(f.value):
                return True
            return _torch_op(expr, self.aliases)
        return False

    def ctx_stores(self) -> Iterator[Tuple[ast.Attribute, ast.AST]]:
        """(``ctx.<attr>`` target, value) of every store onto ctx."""
        for node in self.nodes:
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                pairs = [(t, node.value)]
                if isinstance(t, ast.Tuple) and \
                        isinstance(node.value, ast.Tuple) and \
                        len(t.elts) == len(node.value.elts):
                    pairs = list(zip(t.elts, node.value.elts))
                for tgt, val in pairs:
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == self.ctx:
                        yield tgt, val


def check(tree: ast.Module, lines: List[str], path: str, pkg: c.Package
          ) -> Iterator[Tuple[int, int, str]]:
    aliases = c.import_aliases(tree)
    for cls in c.subclasses(tree, aliases, "torch.autograd.Function"):
        meths = c.methods(cls)
        fwd, bwd = meths.get("forward"), meths.get("backward")
        # (c) mutable defaults
        for fn in (fwd, bwd):
            if fn is None:
                continue
            for d in fn.args.defaults + [d for d in fn.args.kw_defaults
                                         if d is not None]:
                if c.is_mutable_value(d):
                    yield (d.lineno, d.col_offset,
                           f"{cls.name}.{fn.name} has a mutable default "
                           f"argument (one object shared by every call)")
        if fwd is None:
            continue
        params = [a.arg for a in fwd.args.posonlyargs + fwd.args.args]
        if "setup_context" in meths:        # forward(*inputs), no ctx
            ctx, inputs = None, params
        elif params:
            ctx, inputs = params[0], params[1:]
        else:
            continue
        # (a) tensors stored as plain ctx attributes
        if ctx is not None:
            body = _Forward(fwd, ctx, inputs, aliases)
            for tgt, val in body.ctx_stores():
                if body.is_tensor(val):
                    yield (tgt.lineno, tgt.col_offset,
                           f"{cls.name}.forward stores a tensor as "
                           f"{ctx}.{tgt.attr}: it escapes the version "
                           f"counter, so an in-place change before "
                           f"backward gives wrong gradients silently (use "
                           f"{ctx}.save_for_backward)")
        # (b) one gradient per forward input
        if bwd is None or fwd.args.vararg is not None:
            continue
        for node in c.own_nodes(bwd):
            if isinstance(node, ast.Return) and \
                    isinstance(node.value, ast.Tuple) and not any(
                        isinstance(e, ast.Starred) for e in node.value.elts):
                n = len(node.value.elts)
                if n != len(inputs):
                    yield (node.lineno, node.col_offset,
                           f"{cls.name}.backward returns {n} gradient(s) "
                           f"but forward takes {len(inputs)} input(s) "
                           f"({', '.join(inputs)}); PyTorch raises only "
                           f"when this backward runs")
