"""Lock-discipline rules (family: locks).

A field whose ``__init__`` assignment carries ``# guarded-by: <lock>``
may only be touched

- lexically inside ``with self.<lock>:``, or
- in a private method the analyzer *proves* is only ever called with
  the lock held (every intra-class call site holds it, directly or via
  another proven-held caller — a fixpoint over the class call graph;
  ``SimServe._next_group``, only called from ``_take_batch`` under
  ``_qlock``, is the real-tree case).

This is the machine-checked version of the PR 5/6 race fixes: the
torn-stats bug shipped because ``stats()`` read counters the drain loop
mutated under ``_qlock`` — nothing tied the fields to the lock. The
annotation ties them; this rule enforces the tie.

Deliberately lexical and conservative: code inside nested functions /
lambdas is assumed to run *without* the lock (threads outlive the
enclosing block), and only ``self.<field>`` accesses inside the owning
class are checked — cross-object accesses need a different tool.
"""
from __future__ import annotations

import ast
import re
from collections import Counter
from typing import Dict, Iterable, List, Set, Tuple

from .core import Finding, ModuleInfo, ProjectIndex, Rule, register, self_attr

GUARD_RE = re.compile(r"guarded-by:\s*([A-Za-z_]\w*)")

# Construction/teardown run before/after the object is shared; locking
# there is noise, not safety.
_EXEMPT_METHODS = {"__init__", "__post_init__", "__del__"}


class _MethodScan(ast.NodeVisitor):
    """Walk one method body tracking which guard locks are lexically
    held; record every guarded-field access and every ``self.m()`` call
    with the held-set at that point."""

    def __init__(self, guarded: Dict[str, str], lock_names: Set[str]):
        self.guarded = guarded
        self.lock_names = lock_names
        self._held: Counter = Counter()
        # (field, line, frozenset of held locks)
        self.accesses: List[Tuple[str, int, frozenset]] = []
        # method name -> list of held-sets at its call sites
        self.calls: Dict[str, List[frozenset]] = {}

    def _held_now(self) -> frozenset:
        return frozenset(k for k, v in self._held.items() if v > 0)

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            name = self_attr(item.context_expr)
            if name and name in self.lock_names:
                acquired.append(name)
            else:
                self.visit(item.context_expr)
        for name in acquired:
            self._held[name] += 1
        for stmt in node.body:
            self.visit(stmt)
        for name in acquired:
            self._held[name] -= 1

    # A nested def/lambda body may run on another thread after the lock
    # is released — treat it as holding nothing.
    def _visit_deferred(self, body) -> None:
        saved, self._held = self._held, Counter()
        for stmt in body:
            self.visit(stmt)
        self._held = saved

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_deferred(node.body)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_deferred(node.body)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._visit_deferred([node.body])

    def visit_Attribute(self, node: ast.Attribute) -> None:
        name = self_attr(node)
        if name and name in self.guarded:
            self.accesses.append((name, node.lineno, self._held_now()))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = self_attr(node.func)
        if name:
            self.calls.setdefault(name, []).append(self._held_now())
        self.generic_visit(node)


def _init_facts(cls: ast.ClassDef, module: ModuleInfo):
    """From ``__init__``: the guarded-field map (via ``# guarded-by:``
    comments on self-assignments) and every attribute assigned (to vet
    that the named lock actually exists)."""
    guarded: Dict[str, str] = {}  # field -> lock
    guard_lines: Dict[str, int] = {}
    assigned: Set[str] = set()
    for stmt in cls.body:
        if not (isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                and stmt.name in ("__init__", "__post_init__")):
            continue
        for node in ast.walk(stmt):
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                for el in elts:
                    name = self_attr(el)
                    if not name:
                        continue
                    assigned.add(name)
                    m = GUARD_RE.search(module.comment(el.lineno))
                    if m:
                        guarded[name] = m.group(1)
                        guard_lines[name] = el.lineno
    return guarded, guard_lines, assigned


@register
class GuardedFieldRule(Rule):
    rule_id = "lock-guarded-field"
    family = "locks"
    description = ("a field annotated '# guarded-by: <lock>' is accessed "
                   "outside 'with self.<lock>:' and outside any method "
                   "proven to run under it")

    def check(self, module: ModuleInfo,
              index: ProjectIndex) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(node, module)

    def _check_class(self, cls: ast.ClassDef,
                     module: ModuleInfo) -> Iterable[Finding]:
        guarded, _, _ = _init_facts(cls, module)
        if not guarded:
            return
        lock_names = set(guarded.values())
        scans: Dict[str, _MethodScan] = {}
        for stmt in cls.body:
            if (isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and stmt.name not in _EXEMPT_METHODS):
                scan = _MethodScan(guarded, lock_names)
                for b in stmt.body:
                    scan.visit(b)
                scans[stmt.name] = scan

        proven = self._prove_held(scans, lock_names)

        for meth, scan in scans.items():
            held_via_caller = proven.get(meth, frozenset())
            for field, line, held in scan.accesses:
                lock = guarded[field]
                if lock in held or lock in held_via_caller:
                    continue
                yield Finding(
                    rule=self.rule_id, path=module.relpath, line=line,
                    message=(f"'self.{field}' is guarded by '{lock}' but "
                             f"accessed without 'with self.{lock}:'"),
                    symbol=f"{cls.name}.{meth}",
                )

    @staticmethod
    def _prove_held(scans: Dict[str, _MethodScan],
                    lock_names: Set[str]) -> Dict[str, frozenset]:
        """Fixpoint: a *private* method is proven to hold lock L iff it
        has at least one intra-class call site and every call site holds
        L — lexically or because the calling method is itself proven.
        Public methods are entry points; they prove nothing."""
        # method -> list of (caller, held-at-site)
        sites: Dict[str, List[Tuple[str, frozenset]]] = {}
        for caller, scan in scans.items():
            for callee, held_list in scan.calls.items():
                if callee in scans:
                    sites.setdefault(callee, []).extend(
                        (caller, h) for h in held_list)

        proven: Dict[str, frozenset] = {}
        changed = True
        while changed:
            changed = False
            for meth in scans:
                if not (meth.startswith("_") and not meth.startswith("__")):
                    continue
                call_sites = sites.get(meth)
                if not call_sites:
                    continue
                locks = frozenset(
                    lock for lock in lock_names
                    if all(lock in held or lock in proven.get(caller, ())
                           for caller, held in call_sites))
                if locks != proven.get(meth, frozenset()):
                    proven[meth] = locks
                    changed = True
        return proven


@register
class GuardAnnotationRule(Rule):
    rule_id = "lock-annotation-unknown"
    family = "locks"
    description = ("a '# guarded-by: <lock>' annotation names a lock "
                   "never assigned in __init__")

    def check(self, module: ModuleInfo,
              index: ProjectIndex) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            guarded, guard_lines, assigned = _init_facts(node, module)
            for field, lock in sorted(guarded.items()):
                if lock not in assigned:
                    yield Finding(
                        rule=self.rule_id, path=module.relpath,
                        line=guard_lines[field],
                        message=(f"field '{field}' is guarded-by '{lock}', "
                                 f"but no 'self.{lock}' is assigned in "
                                 "__init__ — typo in the annotation?"),
                        symbol=f"{node.name}.__init__",
                    )
