"""Hygiene rules (family: hygiene).

One rule today: ``hygiene-broad-except`` flags ``except Exception:`` and
bare ``except:`` handlers that *swallow* — a handler whose body contains
no ``raise`` turns every bug into silence, which in a serving tier means
a wedged job, a zeroed stat, or a breaker that never trips.

Exemptions, deliberately:

- a handler that re-raises anywhere in its body (the
  cleanup-then-propagate pattern in `core/session.py`) is fine — it is
  using breadth to guarantee cleanup, not to hide failures;
- ``except BaseException`` is NOT flagged: the codebase uses it only in
  worker threads that must outlive ``KeyboardInterrupt`` and it always
  records the error, so flagging it would just breed suppressions.

Where breadth is genuinely the contract (an HTTP boundary turning any
bug into a 500, a stats hook that must not kill ``stats()``), suppress
with a justification::

    except Exception as e:  # repro-lint: disable=hygiene-broad-except — <why>
"""
from __future__ import annotations

import ast
from typing import Iterable

from .core import Finding, ModuleInfo, ProjectIndex, Rule, register


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    names = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    return "Exception" in names


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


@register
class BroadExceptRule(Rule):
    rule_id = "hygiene-broad-except"
    family = "hygiene"
    description = ("'except Exception' / bare 'except' that swallows "
                   "(no re-raise) — narrow it, or suppress with a "
                   "justification")

    def check(self, module: ModuleInfo,
              index: ProjectIndex) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if (isinstance(node, ast.ExceptHandler) and _is_broad(node)
                    and not _reraises(node)):
                yield Finding(
                    rule=self.rule_id, path=module.relpath,
                    line=node.lineno,
                    message=("broad exception handler swallows every "
                             "error — catch the specific failure, or "
                             "keep it broad with a '# repro-lint: "
                             "disable=hygiene-broad-except — <reason>' "
                             "justification"),
                    severity="warning",
                )
