"""AST linter driver for the port's RSA rules.

``python -m repro_torch.analysis [paths...]`` lints each path (default:
the ``repro_torch`` package itself) as one package: a first pass parses
every ``*.py`` file under it and reads every ``*.cu``/``*.cuh`` source
into a :class:`~repro_torch.analysis.rules._common.Package`; then each
rule in :mod:`repro_torch.analysis.rules` runs over each module with
that package as context, and the findings are diffed against the
committed suppression baseline (``analysis/baseline.json``):

  * a finding **not** in the baseline is NEW -> printed, exit 1;
  * a baseline entry matching no finding is STALE (the violation was
    fixed — shrink the baseline) -> printed, exit 1;
  * otherwise exit 0.

Baseline entries are keyed by ``(rule, file, stripped line text)`` — not
line numbers — so unrelated edits that shift code do not invalidate the
baseline, while editing the flagged line itself surfaces the finding
again.  Every entry carries a one-line ``reason``.  Inline suppression:
a ``# lint: disable=RSA00X`` comment on the flagged line (``--list``
shows suppressed findings too).

Pure AST and text: nothing here imports torch or the linted code.

Exit codes: 0 clean, 1 findings/stale baseline, 2 usage error.
"""
from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .rules import ALL_RULES
from .rules._common import Package

_DISABLE_RE = re.compile(r"#\s*lint:\s*disable=([A-Z0-9,\s]+)")
_PKG_ROOT = Path(__file__).resolve().parents[1]          # src/repro_torch
_DEFAULT_BASELINE = Path(__file__).with_name("baseline.json")
_CUDA_SUFFIXES = (".cu", ".cuh")


@dataclass(frozen=True)
class Finding:
    rule: str
    file: str            # posix path relative to the scanned root
    line: int            # 1-indexed
    col: int
    message: str
    line_text: str       # stripped source of the flagged line (baseline key)

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.line_text)

    def format(self) -> str:
        return f"{self.file}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


def _inline_suppressed(line_text: str, rule: str) -> bool:
    m = _DISABLE_RE.search(line_text)
    if not m:
        return False
    ids = {tok.strip() for tok in m.group(1).split(",")}
    return rule in ids or "ALL" in ids


def _run_rules(tree: ast.Module, src: str, rel_path: str,
               pkg: Package) -> List[Finding]:
    lines = src.splitlines()
    findings: List[Finding] = []
    for rule in ALL_RULES:
        for line, col, message in rule.check(tree, lines, rel_path, pkg):
            text = lines[line - 1].strip() if 0 < line <= len(lines) else ""
            if _inline_suppressed(text, rule.RULE_ID):
                continue
            findings.append(Finding(rule.RULE_ID, rel_path, line, col,
                                    message, text))
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings


def lint_source(src: str, rel_path: str) -> List[Finding]:
    """Run every rule over one file's source, the file its own package
    (no CUDA sources); returns findings with inline-suppressed ones
    already removed."""
    return lint_sources([(rel_path, src)])


def lint_sources(sources: Sequence[Tuple[str, str]]) -> List[Finding]:
    """Lint one package given as ``(relative path, text)`` pairs: every
    Python source in the order given; ``.cu``/``.cuh`` texts are context
    only."""
    pkg = Package()
    texts: Dict[str, str] = {}
    broken: Dict[str, Finding] = {}
    for rel, text in sources:
        if rel.endswith(_CUDA_SUFFIXES):
            pkg.cuda[rel] = text
        else:
            texts[rel] = text
            try:
                pkg.modules[rel] = ast.parse(text)
            except SyntaxError as exc:
                broken[rel] = Finding("RSA000", rel, exc.lineno or 0, 0,
                                      f"syntax error: {exc.msg}", "")
    out: List[Finding] = []
    for rel, text in texts.items():
        out.extend([broken[rel]] if rel in broken else
                   _run_rules(pkg.modules[rel], text, rel, pkg))
    return out


def iter_py_files(paths: Sequence[Path]) -> List[Tuple[Path, str]]:
    """Expand paths to (file, rel_name) pairs.  rel_name is relative to
    the directory argument the file came from (stable across checkouts),
    or the bare file name for file arguments."""
    out: List[Tuple[Path, str]] = []
    for p in paths:
        p = p.resolve()
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                out.append((f, f.relative_to(p).as_posix()))
        else:
            out.append((p, p.name))
    return out


def lint_paths(paths: Sequence[Path]) -> List[Finding]:
    """Each path is one package: a directory with its CUDA sources, or a
    single file."""
    findings: List[Finding] = []
    for p in paths:
        p = p.resolve()
        files = iter_py_files([p])
        if p.is_dir():
            files += [(f, f.relative_to(p).as_posix())
                      for f in sorted(p.rglob("*"))
                      if f.suffix in _CUDA_SUFFIXES]
        findings.extend(lint_sources([(rel, f.read_text())
                                      for f, rel in files]))
    return findings


# ---------------------------------------------------------------- baseline
def load_baseline(path: Path) -> List[Dict[str, str]]:
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    assert isinstance(data, dict) and "suppressions" in data, \
        f"{path}: baseline must be {{'suppressions': [...]}}"
    return data["suppressions"]


def save_baseline(path: Path, findings: Sequence[Finding],
                  reasons: Optional[Dict[Tuple[str, str, str], str]] = None
                  ) -> None:
    entries = []
    for f in findings:
        reason = (reasons or {}).get(f.key, "TODO: document this suppression")
        entries.append({"rule": f.rule, "file": f.file,
                        "line_text": f.line_text, "reason": reason})
    path.write_text(json.dumps(
        {"version": 1,
         "comment": "suppression baseline for `python -m "
                    "repro_torch.analysis`; keys are (rule, file, stripped "
                    "line text) so line drift does not invalidate entries",
         "suppressions": entries}, indent=2) + "\n")


def diff_baseline(findings: Sequence[Finding],
                  baseline: Sequence[Dict[str, str]]
                  ) -> Tuple[List[Finding], List[Dict[str, str]], int]:
    """Returns (new findings, stale baseline entries, suppressed count)."""
    keys = {(e["rule"], e["file"], e["line_text"]): False for e in baseline}
    new: List[Finding] = []
    suppressed = 0
    for f in findings:
        if f.key in keys:
            keys[f.key] = True
            suppressed += 1
        else:
            new.append(f)
    stale = [e for e in baseline
             if not keys[(e["rule"], e["file"], e["line_text"])]]
    return new, stale, suppressed


# --------------------------------------------------------------------- CLI
def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's AST linter (rules RSA001-RSA005; see "
                    "repro_torch.analysis.__doc__ for the catalogue)")
    ap.add_argument("paths", nargs="*", type=Path,
                    help=f"files/directories to lint, each one package "
                         f"(default: {_PKG_ROOT})")
    ap.add_argument("--baseline", type=Path, default=_DEFAULT_BASELINE,
                    help="suppression baseline JSON (default: the "
                         "committed analysis/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report everything)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "(preserves reasons of surviving entries)")
    ap.add_argument("--list", action="store_true", dest="list_all",
                    help="also list baseline-suppressed findings")
    args = ap.parse_args(argv)

    paths = args.paths or [_PKG_ROOT]
    for p in paths:
        if not p.exists():
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    findings = lint_paths(paths)
    baseline = [] if args.no_baseline else load_baseline(args.baseline)
    new, stale, suppressed = diff_baseline(findings, baseline)

    if args.write_baseline:
        old_reasons = {(e["rule"], e["file"], e["line_text"]): e["reason"]
                       for e in baseline}
        save_baseline(args.baseline, findings, old_reasons)
        print(f"wrote {args.baseline} ({len(findings)} suppression(s))")
        return 0

    if args.list_all and suppressed:
        print(f"{suppressed} baseline-suppressed finding(s):")
        keys = {(e["rule"], e["file"], e["line_text"]) for e in baseline}
        for f in findings:
            if f.key in keys:
                print(f"  [baseline] {f.format()}")
    for f in new:
        print(f.format())
    for e in stale:
        print(f"stale baseline entry (violation fixed — remove it): "
              f"{e['rule']} {e['file']}: {e['line_text']!r}")
    if new or stale:
        print(f"\n{len(new)} new finding(s), {len(stale)} stale baseline "
              f"entr(ies); {suppressed} suppressed by "
              f"{args.baseline.name}")
        return 1
    print(f"analysis clean: {len(findings)} finding(s), all covered by "
          f"{args.baseline.name}" if findings else
          "analysis clean: no findings")
    return 0
