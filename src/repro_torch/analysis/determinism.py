"""Determinism rules (family: determinism).

The chaos plane's contract (PR 9) is bit-for-bit replay: the DES, the
workload generators and the fault injector must produce identical output
for identical seeds, or `repro chaos` cannot tell a real corruption from
run-to-run noise. Modules declared deterministic — the default globs
below, or any file carrying ``# repro-lint: deterministic`` — may not:

- read the wall clock (``time.time``/``monotonic``/``perf_counter``,
  ``datetime.now``/``utcnow``). ``time.sleep`` is pacing, not input,
  and stays legal;
- call unseeded randomness: ``random.<fn>`` module-level functions, or
  ``np.random.<fn>`` outside seeded constructors — ``random.Random(x)``
  and ``np.random.default_rng(seed)`` are the approved idioms, and the
  *zero-argument* forms of those constructors are flagged too;
- iterate a set into output: ``for x in {...}``, comprehensions over
  set displays/``set()``/``frozenset()`` calls, or ``list``/``tuple``/
  ``enumerate``/``str.join`` over one — set order varies across
  processes (PYTHONHASHSEED), so totals built from it are not
  replayable. ``sorted(...)`` over a set is the fix and is exempt
  (membership tests are always fine).
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional, Set

from .core import (Finding, ModuleInfo, ProjectIndex, Rule, dotted_chain,
                   register)
from .cachekey import WALL_CLOCK

DETERMINISTIC_MARKER = "repro-lint: deterministic"
DEFAULT_DETERMINISTIC_GLOBS = (
    "*repro/des/*.py",
    "*repro/serving/faults.py",
)

_SEEDED_CTORS = {"Random", "default_rng", "RandomState", "Generator",
                 "SeedSequence", "PCG64", "Philox", "MT19937"}


def _in_scope(module: ModuleInfo) -> bool:
    return (module.matches(DEFAULT_DETERMINISTIC_GLOBS)
            or module.has_file_marker(DETERMINISTIC_MARKER))


@register
class WallClockRule(Rule):
    rule_id = "det-wall-clock"
    family = "determinism"
    description = ("wall-clock read in a deterministic module — replay "
                   "would diverge run to run")

    def check(self, module: ModuleInfo,
              index: ProjectIndex) -> Iterable[Finding]:
        if not _in_scope(module):
            return
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                chain = dotted_chain(node.func)
                if chain and chain[-2:] in WALL_CLOCK:
                    yield Finding(
                        rule=self.rule_id, path=module.relpath,
                        line=node.lineno,
                        message=(f"'{'.'.join(chain)}' in a deterministic "
                                 "module — derive timing from the "
                                 "simulated clock or take it as a "
                                 "parameter"),
                    )


@register
class UnseededRandomRule(Rule):
    rule_id = "det-unseeded-random"
    family = "determinism"
    description = ("unseeded random/np.random call in a deterministic "
                   "module — seeds must flow in explicitly")

    def check(self, module: ModuleInfo,
              index: ProjectIndex) -> Iterable[Finding]:
        if not _in_scope(module):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = dotted_chain(node.func)
            msg = self._violation(chain, node)
            if msg:
                yield Finding(rule=self.rule_id, path=module.relpath,
                              line=node.lineno, message=msg)

    @staticmethod
    def _violation(chain, node: ast.Call) -> Optional[str]:
        if not chain:
            return None
        seeded = bool(node.args) or bool(node.keywords)
        if chain[0] == "random" and len(chain) == 2:
            fn = chain[1]
            if fn in _SEEDED_CTORS:
                return None if seeded else (
                    f"'random.{fn}()' without a seed — pass one "
                    "(e.g. random.Random(seed))")
            return (f"'random.{fn}' uses the shared global generator — "
                    "use a random.Random(seed) instance instead")
        if chain[:2] in (("np", "random"), ("numpy", "random")):
            fn = chain[2] if len(chain) > 2 else ""
            if fn in _SEEDED_CTORS:
                return None if seeded else (
                    f"'{chain[0]}.random.{fn}()' without a seed — pass "
                    "one (e.g. np.random.default_rng(seed))")
            if fn:
                return (f"'{chain[0]}.random.{fn}' uses the global "
                        "NumPy generator — use "
                        "np.random.default_rng(seed)")
        return None


def _set_expr(node: ast.AST, setvars: Set[str]) -> bool:
    """Is this expression an (unordered) set value, syntactically?"""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    if isinstance(node, ast.Name):
        return node.id in setvars
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        # set algebra: a | b, seen - done ... only if a side is a set
        return (_set_expr(node.left, setvars)
                or _set_expr(node.right, setvars))
    return False


@register
class UnorderedIterRule(Rule):
    rule_id = "det-unordered-iter"
    family = "determinism"
    description = ("iteration over an unordered set in a deterministic "
                   "module — order varies per process; sort first")

    _CONSUMERS = {"list", "tuple", "enumerate"}

    def check(self, module: ModuleInfo,
              index: ProjectIndex) -> Iterable[Finding]:
        if not _in_scope(module):
            return
        # track names assigned set-valued expressions, per enclosing
        # scope walk (module-wide is fine: names are rarely reused with
        # different types in this codebase)
        setvars: Set[str] = set()
        for node in ast.walk(module.tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                if _set_expr(node.value, setvars):
                    setvars.add(node.targets[0].id)
                else:
                    setvars.discard(node.targets[0].id)

        def flag(line: int, what: str) -> Finding:
            return Finding(
                rule=self.rule_id, path=module.relpath, line=line,
                message=(f"{what} iterates an unordered set — wrap in "
                         "sorted(...) so replay order is stable"),
            )

        for node in ast.walk(module.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                if _set_expr(node.iter, setvars):
                    yield flag(node.lineno, "'for' loop")
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                                   ast.DictComp, ast.SetComp)):
                for gen in node.generators:
                    if _set_expr(gen.iter, setvars):
                        yield flag(node.lineno, "comprehension")
            elif isinstance(node, ast.Call):
                fname = (node.func.id
                         if isinstance(node.func, ast.Name) else
                         node.func.attr
                         if isinstance(node.func, ast.Attribute) else "")
                if (fname in self._CONSUMERS and node.args
                        and _set_expr(node.args[0], setvars)):
                    yield flag(node.lineno, f"'{fname}(...)'")
                elif (fname == "join"
                      and isinstance(node.func, ast.Attribute)
                      and node.args
                      and _set_expr(node.args[0], setvars)):
                    yield flag(node.lineno, "'.join(...)'")
