"""repro lint — the analyzer framework.

The serving tier's three load-bearing guarantees (bit-identical totals,
replay-exact chaos drills, one-executable-per-architecture compile
caching) are conventions: fields that must only be touched under a lock,
config fields that must ride the compile-cache key, modules that must
stay wall-clock- and unseeded-randomness-free. Tests catch violations
*after* they bite; this package turns the conventions themselves into
machine-checked rules over the AST.

Framework pieces:

- `Finding` — one violation: file / line / rule id / severity / message.
- `Rule` + `register` — the rule registry; every rule module registers
  its rules at import (see `locks`, `cachekey`, `determinism`,
  `hygiene`).
- `ModuleInfo` / `ProjectIndex` — parsed modules with their comment map
  (comments carry the annotation language: ``# guarded-by: _lock``,
  ``# cache-key: irrelevant``, ``# repro-lint: scan-reachable``,
  ``# repro-lint: deterministic``, ``# repro-lint: compiled-path``).
- Inline suppression — ``# repro-lint: disable=<rule>[,<rule>...]`` on
  the finding's line or alone on the line above silences that rule
  there; suppressions are how a justified broad catch or benign race is
  recorded *in the code it excuses*.
- Baseline — a committed JSON file of grandfathered finding
  fingerprints; ``lint`` exits nonzero only on findings NOT in it, so
  new debt cannot ship while old debt is visibly parked.

Everything here is stdlib-only (ast + tokenize): the lint gate must run
before / without the JAX stack.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import hashlib
import io
import json
import re
import tokenize
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SEVERITIES = ("error", "warning")

_DISABLE_RE = re.compile(r"repro-lint:\s*disable=([\w\-, ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str  # repo-relative posix path
    line: int
    message: str
    severity: str = "error"
    symbol: str = ""  # enclosing class.method / function, when known

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        where = f" (in {self.symbol})" if self.symbol else ""
        return (f"{self.path}:{self.line}: [{self.rule}] "
                f"{self.severity}: {self.message}{where}")


class Rule:
    """Base class: subclasses set the id/family/description and yield
    `Finding`s from ``check``. One instance is registered per rule."""

    rule_id: str = ""
    family: str = ""
    description: str = ""

    def check(self, module: "ModuleInfo",
              index: "ProjectIndex") -> Iterable[Finding]:
        raise NotImplementedError


ALL_RULES: List[Rule] = []


def register(cls):
    """Class decorator: instantiate and add to the registry."""
    ALL_RULES.append(cls())
    return cls


def rules_by_id() -> Dict[str, Rule]:
    return {r.rule_id: r for r in ALL_RULES}


class ModuleInfo:
    """One parsed source file: AST + raw lines + per-line comments."""

    def __init__(self, path: Path, root: Path):
        self.path = path
        self.relpath = path.resolve().relative_to(root.resolve()).as_posix()
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(self.source, filename=str(path))
        except SyntaxError as e:
            self.parse_error = e
        # line -> (comment text, True when the line is comment-only)
        self.comments: Dict[int, Tuple[str, bool]] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(self.source).readline):
                if tok.type == tokenize.COMMENT:
                    line_no = tok.start[0]
                    only = self.lines[line_no - 1].lstrip().startswith("#")
                    self.comments[line_no] = (tok.string, only)
        except tokenize.TokenError:
            pass  # parse_error already carries the diagnosis

    def comment(self, line: int) -> str:
        return self.comments.get(line, ("", False))[0]

    def has_file_marker(self, marker: str) -> bool:
        return any(marker in text for text, _ in self.comments.values())

    def matches(self, globs: Sequence[str]) -> bool:
        return any(fnmatch.fnmatch(self.relpath, g)
                   or fnmatch.fnmatch("/" + self.relpath, g) for g in globs)

    def is_suppressed(self, line: int, rule_id: str) -> bool:
        """True when the finding's line (or a comment-only line directly
        above it) carries ``# repro-lint: disable=<rule>``."""
        for cand, need_only in ((line, False), (line - 1, True)):
            text, only = self.comments.get(cand, ("", False))
            if need_only and not only:
                continue
            m = _DISABLE_RE.search(text)
            if m and rule_id in {p.strip() for p in m.group(1).split(",")}:
                return True
        return False


class ProjectIndex:
    """All modules of one lint run. Rules needing cross-file facts (the
    cache-key rule reads config classes, the key class and the compiled
    path from *different* files) memoize them here via ``fact()``."""

    def __init__(self, modules: Sequence[ModuleInfo]):
        self.modules = list(modules)
        self._facts: Dict[str, object] = {}

    def fact(self, key: str, build):
        if key not in self._facts:
            self._facts[key] = build(self)
        return self._facts[key]


# --------------------------------------------------------------- running

def collect_files(paths: Sequence[Path]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(
                f for f in sorted(p.rglob("*.py")) if "__pycache__" not in f.parts
            )
        elif p.suffix == ".py":
            files.append(p)
    seen, out = set(), []
    for f in files:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            out.append(f)
    return out


def lint_paths(
    paths: Sequence[Path],
    root: Optional[Path] = None,
    rule_ids: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Run the (selected) rules over every .py file under ``paths``.
    Returns findings with inline suppressions already applied, sorted by
    location. Unparseable files yield a ``parse-error`` finding."""
    return run_lint(paths, root=root, rule_ids=rule_ids)[0]


def run_lint(
    paths: Sequence[Path],
    root: Optional[Path] = None,
    rule_ids: Optional[Sequence[str]] = None,
) -> Tuple[List[Finding], Dict[str, ModuleInfo]]:
    """`lint_paths` plus the relpath->ModuleInfo map (fingerprints need
    the flagged line's text)."""
    root = (root or Path.cwd()).resolve()
    modules = [ModuleInfo(f, root) for f in collect_files(paths)]
    index = ProjectIndex(modules)
    selected = ALL_RULES
    if rule_ids is not None:
        wanted = set(rule_ids)
        unknown = wanted - set(rules_by_id())
        if unknown:
            raise ValueError(
                f"unknown rule id(s) {sorted(unknown)}; "
                f"known: {sorted(rules_by_id())}"
            )
        selected = [r for r in ALL_RULES if r.rule_id in wanted]
    findings: List[Finding] = []
    for mod in modules:
        if mod.parse_error is not None:
            findings.append(Finding(
                rule="parse-error", path=mod.relpath,
                line=mod.parse_error.lineno or 1,
                message=f"file does not parse: {mod.parse_error.msg}",
            ))
            continue
        for rule in selected:
            for f in rule.check(mod, index):
                if not mod.is_suppressed(f.line, f.rule):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, {m.relpath: m for m in modules}


# --------------------------------------------------------------- baseline

def fingerprint(f: Finding, modules_by_path: Dict[str, ModuleInfo]) -> str:
    """Line-number-independent identity of a finding: rule + file + the
    stripped text of the flagged line, so unrelated edits above it do not
    churn the baseline. Duplicate fingerprints are counted (Counter
    semantics) — two identical lines need two baseline entries."""
    mod = modules_by_path.get(f.path)
    text = ""
    if mod is not None and 0 < f.line <= len(mod.lines):
        text = mod.lines[f.line - 1].strip()
    h = hashlib.sha1(f"{f.rule}::{f.path}::{text}".encode()).hexdigest()[:16]
    return f"{f.rule}:{f.path}:{h}"


def load_baseline(path: Path) -> Counter:
    """The committed baseline: a Counter of grandfathered fingerprints.
    A missing file is an empty baseline."""
    if not path.exists():
        return Counter()
    data = json.loads(path.read_text())
    return Counter(e["fingerprint"] for e in data.get("findings", []))


def write_baseline(path: Path, findings: Sequence[Finding],
                   modules_by_path: Dict[str, ModuleInfo]) -> None:
    entries = [
        {
            "fingerprint": fingerprint(f, modules_by_path),
            "rule": f.rule,
            "path": f.path,
            "line": f.line,  # informational; identity is the fingerprint
            "message": f.message,
        }
        for f in findings
    ]
    path.write_text(json.dumps(
        {"comment": "grandfathered repro-lint findings; regenerate with "
                    "`python -m repro lint --update-baseline`",
         "findings": entries}, indent=2) + "\n")


def split_by_baseline(
    findings: Sequence[Finding],
    baseline: Counter,
    modules_by_path: Dict[str, ModuleInfo],
) -> Tuple[List[Finding], List[Finding], int]:
    """Partition into (new, grandfathered) and count stale baseline
    entries (parked debt that no longer exists — time to shrink the
    file)."""
    budget = Counter(baseline)
    new, old = [], []
    for f in findings:
        fp = fingerprint(f, modules_by_path)
        if budget[fp] > 0:
            budget[fp] -= 1
            old.append(f)
        else:
            new.append(f)
    stale = sum(budget.values())
    return new, old, stale


# --------------------------------------------------------------- reporting

def render_text(new: Sequence[Finding], old: Sequence[Finding],
                stale: int) -> str:
    out = [f.render() for f in new]
    if old:
        out.append(f"... plus {len(old)} baselined finding(s) "
                   "(grandfathered; see the baseline file)")
    if stale:
        out.append(f"note: {stale} stale baseline entr(y/ies) no longer "
                   "match any finding — regenerate with --update-baseline")
    out.append(
        f"repro lint: {len(new)} new finding(s), {len(old)} baselined"
        + (" — FAIL" if new else " — ok")
    )
    return "\n".join(out)


def render_json(new: Sequence[Finding], old: Sequence[Finding],
                stale: int) -> Dict[str, object]:
    return {
        "new": [f.to_dict() for f in new],
        "baselined": [f.to_dict() for f in old],
        "counts": {"new": len(new), "baselined": len(old),
                   "stale_baseline": stale},
        "ok": not new,
    }


# ------------------------------------------------------ shared AST helpers

def self_attr(node: ast.AST) -> Optional[str]:
    """``self.<name>`` -> name, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self"):
        return node.attr
    return None


def dotted_chain(node: ast.AST) -> Tuple[str, ...]:
    """``a.b.c`` -> ("a", "b", "c"); empty tuple when the base is not a
    plain name (calls, subscripts...)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()
