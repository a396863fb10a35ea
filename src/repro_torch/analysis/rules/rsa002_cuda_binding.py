"""RSA002 — CUDA kernel binding conventions.

The port's counterpart of the reference's Pallas conventions
(``repro/analysis/rules/rsa002_pallas_conventions.py``).  The reference's
kernels are traced by Pallas, which checks every operand; the port's are
``extern "C"`` entry points in ``kernels/csrc/*.cu`` loaded with
``ctypes``, whose argument lists are typed by hand in
``kernels/_build.py``'s ``SIGNATURES``.  ``ctypes`` converts by those
types and passes on extra arguments beyond them without a word, so a
``long long`` stride bound as ``c_int``, or a call with one argument
too many, is a silently wrong answer, not an error.  Three checks:

  * **(a) ``SIGNATURES`` agrees with the declarations**, in argument
    count and type, symbol by symbol: ``void*`` (any pointer) is
    ``c_void_p``, ``int`` is ``c_int``, ``long long``/``int64_t`` is
    ``c_longlong``, ``float`` is ``c_float``.  A symbol on one side and
    missing on the other fires too.  Object-like ``#define`` macros in
    the argument list (with line continuations) are expanded, and an
    entry assigned after the dict (``SIGNATURES["b"] =
    SIGNATURES["a"]``) is followed.  Reported on the ``SIGNATURES``
    lines, so baseline keys stay on a ``.py`` line.
  * **(b) every call of an entry point passes ``len(SIGNATURES[sym])``
    arguments**: ``lib.repro_x(...)``, or a local alias of one
    (``entry = lib.repro_a if lse else lib.repro_b``).
  * **(c) every such call's return code reaches ``check(...)``** in the
    same function: a discarded result, or a name bound to it that no
    ``check(err, ...)`` reads, fires.  A result used in an expression
    (``lib.repro_kv_chunk() != KV_CHUNK``) is consumed and passes.

The declarations come from the ``Package`` context (every ``.cu``/``.cuh``
under the linted root); with none (linting one file alone) (a) is silent.
Only ``extern "C" <type> name(...)`` declarations are read, not
``extern "C" { ... }`` blocks.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Set, Tuple

from . import _common as c

RULE_ID = "RSA002"
SUMMARY = ("ctypes SIGNATURES match the extern \"C\" declarations; entry "
           "points are called with that many arguments and their return "
           "code reaches check()")

# ABI classes: ctypes names and C types that pass the same way
_CTYPES = {
    "c_void_p": "ptr", "c_char_p": "ptr", "c_int": "i32", "c_int32": "i32",
    "c_uint": "u32", "c_uint32": "u32", "c_longlong": "i64",
    "c_int64": "i64", "c_long": "i64", "c_ssize_t": "i64",
    "c_ulonglong": "u64", "c_uint64": "u64", "c_ulong": "u64",
    "c_size_t": "u64", "c_float": "f32", "c_double": "f64", "c_bool": "bool"}
_C_TYPES = {
    "int": "i32", "signed int": "i32", "int32_t": "i32", "unsigned": "u32",
    "unsigned int": "u32", "uint32_t": "u32", "long long": "i64",
    "long long int": "i64", "int64_t": "i64", "long": "i64",
    "ptrdiff_t": "i64", "ssize_t": "i64", "unsigned long long": "u64",
    "uint64_t": "u64", "unsigned long": "u64", "size_t": "u64",
    "float": "f32", "double": "f64", "bool": "bool", "cudaStream_t": "ptr"}
_C_WORDS = {"int", "long", "short", "unsigned", "signed", "char", "float",
            "double", "bool", "void"}
_QUALIFIERS = re.compile(r"\b(const|volatile|restrict|__restrict__|"
                         r"__restrict|struct)\b")


@dataclass
class _Entry:
    """One ``SIGNATURES`` entry: ABI class (None if unknown) and anchor
    node of each argument, and the anchor of the entry itself."""
    types: List[Optional[str]]
    texts: List[str]
    arg_nodes: List[ast.AST]
    node: ast.AST


@dataclass
class _Decl:
    types: List[Optional[str]]
    texts: List[str]
    where: str                      # "csrc/x.cu:12"


# ------------------------------------------------------------ SIGNATURES
def _signatures(tree: ast.Module
                ) -> Optional[Tuple[ast.stmt, Dict[str, _Entry]]]:
    """The module's ``SIGNATURES`` table: (its assignment, entries)."""
    ctypes_names: Dict[str, str] = {}
    table: Optional[ast.stmt] = None
    entries: Dict[str, _Entry] = {}

    def entry(value: ast.AST, anchor: ast.AST) -> Optional[_Entry]:
        if isinstance(value, (ast.List, ast.Tuple)):
            types, texts = [], []
            for e in value.elts:
                name = ctypes_names.get(e.id) if isinstance(e, ast.Name) \
                    else (c.dotted(e) or "").split(".")[-1]
                types.append(_CTYPES.get(name or ""))
                texts.append(ast.unparse(e))
            return _Entry(types, texts, list(value.elts), anchor)
        if isinstance(value, ast.Subscript) and _is_table(value.value) and \
                isinstance(value.slice, ast.Constant) and \
                value.slice.value in entries:
            src = entries[value.slice.value]
            return _Entry(src.types, src.texts, [anchor] * len(src.types),
                          anchor)
        return None

    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target = stmt.targets[0]
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            target = stmt.target
        else:
            continue
        value = stmt.value
        if isinstance(target, ast.Name):
            name = (c.dotted(value) or "").split(".")[-1]
            if name in _CTYPES:
                ctypes_names[target.id] = name
            elif target.id == "SIGNATURES" and isinstance(value, ast.Dict):
                table = stmt
                for k, v in zip(value.keys, value.values):
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str):
                        e = entry(v, k)
                        if e is not None:
                            entries[k.value] = e
        elif table is not None and isinstance(target, ast.Subscript) and \
                _is_table(target.value) and \
                isinstance(target.slice, ast.Constant) and \
                isinstance(target.slice.value, str):
            e = entry(value, stmt)
            if e is not None:
                entries[target.slice.value] = e
    return (table, entries) if table is not None else None


def _is_table(node: ast.AST) -> bool:
    return isinstance(node, ast.Name) and node.id == "SIGNATURES"


def _arg_counts(pkg: c.Package) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for tree in pkg.modules.values():
        found = _signatures(tree)
        if found:
            for sym, e in found[1].items():
                out.setdefault(sym, len(e.types))
    return out


# ------------------------------------------------- extern "C" declarations
def _blank(m: re.Match) -> str:
    return re.sub(r"[^\n]", " ", m.group())


def _c_type(param: str) -> Tuple[Optional[str], str]:
    """(ABI class or None, the type as written) of one C parameter."""
    text = " ".join(param.split("=")[0].split())
    if "*" in text or "[" in text:
        return "ptr", text
    words = re.findall(r"\w+", _QUALIFIERS.sub(" ", text))
    if len(words) > 1 and words[-1] not in _C_WORDS:
        words = words[:-1]                  # drop the parameter's name
    return _C_TYPES.get(" ".join(words)), text


def _uncomment(text: str) -> str:
    """``text`` with its comments blanked, lines kept."""
    return re.sub(r"//[^\n]*|/\*.*?\*/", _blank, text, flags=re.S)


def _parse_cuda(text: str, where: str, macros: Dict[str, str]
                ) -> Iterator[Tuple[str, _Decl]]:
    code = re.sub(r"(?m)^[ \t]*#(?:\\\n|[^\n])*", _blank,
                  _uncomment(text))
    for m in re.finditer(r'\bextern\s+"C"\s+([^;{}()]*?)\b(\w+)\s*\(', code):
        if "__global__" in m.group(1):
            continue
        depth, i = 1, m.end()
        while i < len(code) and depth:
            depth += {"(": 1, ")": -1}.get(code[i], 0)
            i += 1
        args = code[m.end():i - 1]
        for _ in range(8):                  # expand object-like macros
            expanded = re.sub(r"\b\w+\b",
                              lambda t: macros.get(t.group(), t.group()),
                              args)
            if expanded == args:
                break
            args = expanded
        params = _split_params(args)
        if params in ([], ["void"]):
            params = []
        types, texts = zip(*map(_c_type, params)) if params else ((), ())
        line = code.count("\n", 0, m.start(2)) + 1
        yield m.group(2), _Decl(list(types), list(texts), f"{where}:{line}")


def _split_params(args: str) -> List[str]:
    out, depth, cur = [], 0, ""
    for ch in args:
        if ch in "(<[":
            depth += 1
        elif ch in ")>]":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


def _declarations(pkg: c.Package) -> Dict[str, _Decl]:
    macros: Dict[str, str] = {}
    for text in pkg.cuda.values():
        joined = _uncomment(text).replace("\\\n", " ")
        for m in re.finditer(r"(?m)^[ \t]*#[ \t]*define[ \t]+(\w+)(\(?)(.*)$",
                             joined):
            if not m.group(2):
                macros[m.group(1)] = m.group(3).strip()
    out: Dict[str, _Decl] = {}
    for where, text in sorted(pkg.cuda.items()):
        for sym, decl in _parse_cuda(text, where, macros):
            out.setdefault(sym, decl)
    return out


# ------------------------------------------------------------------ checks
def _check_table(table: ast.stmt, entries: Dict[str, _Entry],
                 decls: Dict[str, _Decl]
                 ) -> Iterator[Tuple[int, int, str]]:
    for sym, e in entries.items():
        d = decls.get(sym)
        if d is None:
            yield (e.node.lineno, e.node.col_offset,
                   f"SIGNATURES lists {sym}, which no extern \"C\" "
                   f"declaration of the CUDA sources defines")
        elif len(d.types) != len(e.types):
            yield (e.node.lineno, e.node.col_offset,
                   f"SIGNATURES[{sym!r}] has {len(e.types)} argument "
                   f"type(s), the declaration at {d.where} takes "
                   f"{len(d.types)}")
        else:
            for i, (py, cc) in enumerate(zip(e.types, d.types)):
                if py is not None and cc is not None and py != cc:
                    node = e.arg_nodes[i]
                    yield (node.lineno, node.col_offset,
                           f"argument {i} of {sym}: SIGNATURES has "
                           f"{e.texts[i]}, the declaration at {d.where} "
                           f"has `{d.texts[i]}`")
    for sym, d in decls.items():
        if sym not in entries:
            yield (table.lineno, table.col_offset,
                   f"extern \"C\" {sym} ({d.where}) has no SIGNATURES "
                   f"entry, so it would load without argtypes")


def _aliases(tree: ast.Module, counts: Dict[str, int]
             ) -> Dict[Tuple[Optional[ast.AST], str], Set[str]]:
    """(enclosing function or None, name) -> the entry points a
    local alias may hold: every assignment of the name in that scope is
    made of entry-point attributes (``entry = lib.repro_a if lse else
    lib.repro_b``)."""
    out: Dict[Tuple[Optional[ast.AST], str], Set[str]] = {}
    other = set()
    for node in c.nodes(tree):
        if not isinstance(node, ast.Assign):
            continue
        scope = c.enclosing_function(node)
        attrs = _entry_attrs(node.value)
        entry = bool(attrs) and all(a in counts for a in attrs)
        for t in node.targets:
            if isinstance(t, ast.Name):
                if entry:
                    out.setdefault((scope, t.id), set()).update(attrs)
                else:
                    other.add((scope, t.id))
    return {k: v for k, v in out.items() if k not in other}


def _callee(call: ast.Call, counts: Dict[str, int],
            aliases: Dict[Tuple[Optional[ast.AST], str], Set[str]]
            ) -> Set[str]:
    """Entry points a call may reach: ``lib.repro_x(...)`` or an alias."""
    func = call.func
    if isinstance(func, ast.Attribute):
        return {func.attr} if func.attr in counts else set()
    if isinstance(func, ast.Name):
        return aliases.get((c.enclosing_function(call), func.id), set())
    return set()


def _entry_attrs(expr: ast.AST) -> List[str]:
    """Attribute names an alias may take: ``a.x``, ``a.x if t else
    a.y``, ``a.x or a.y``; [] for anything else."""
    if isinstance(expr, ast.Attribute):
        return [expr.attr]
    parts = [expr.body, expr.orelse] if isinstance(expr, ast.IfExp) else \
        expr.values if isinstance(expr, ast.BoolOp) else []
    out = [_entry_attrs(p) for p in parts]
    return [] if not out or not all(out) else sum(out, [])


def _reaches_check(call: ast.Call) -> Optional[str]:
    """None when the call's return code is consumed, else why not."""
    up = c.parent(call)
    if isinstance(up, ast.Expr):
        return "its return code is discarded"
    if isinstance(up, ast.Assign) and len(up.targets) == 1 and \
            isinstance(up.targets[0], ast.Name):
        name = up.targets[0].id
        scope = c.enclosing_function(call) or c.module_of(call)
        for node in ast.walk(scope):
            if isinstance(node, ast.Call) and c.last_name(node) == "check" \
                    and any(isinstance(a, ast.Name) and a.id == name
                            for a in node.args):
                return None
        return f"its return code {name!r} never reaches check(...)"
    return None


def check(tree: ast.Module, lines: List[str], path: str, pkg: c.Package
          ) -> Iterator[Tuple[int, int, str]]:
    found = _signatures(tree)
    if found is not None:
        decls = pkg.memo("rsa002.declarations", _declarations)
        if decls:
            yield from _check_table(found[0], found[1], decls)
    counts = pkg.memo("rsa002.counts", _arg_counts)
    if not counts:
        return
    c.annotate_parents(tree)
    aliases = _aliases(tree, counts)
    for call in c.nodes(tree):
        if not isinstance(call, ast.Call):
            continue
        syms = _callee(call, counts, aliases)
        if not syms:
            continue
        if not any(isinstance(a, ast.Starred) for a in call.args) and \
                not call.keywords:
            for sym in sorted(syms):
                n = len(call.args)
                if n != counts[sym]:
                    yield (call.lineno, call.col_offset,
                           f"{sym} takes {counts[sym]} argument(s) "
                           f"(SIGNATURES) but is called with {n}" +
                           ("; ctypes passes the extra ones on without a "
                            "word" if n > counts[sym] else ""))
        why = _reaches_check(call)
        if why is not None:
            yield (call.lineno, call.col_offset,
                   f"call of {'/'.join(sorted(syms))}: {why} (a CUDA "
                   f"error at launch would pass silently)")
