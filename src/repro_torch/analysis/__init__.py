"""repro lint: domain static analysis for the SimNet repro tree.

Stdlib-only (ast + tokenize) — importable without JAX. See `core` for
the framework and `locks` / `cachekey` / `determinism` / `hygiene` for
the rule families; importing this package registers every rule.
"""
from __future__ import annotations
from . import cachekey, determinism, hygiene, locks  # noqa: F401  (rule registration)
from .core import (  # noqa: F401
    ALL_RULES,
    Finding,
    ModuleInfo,
    ProjectIndex,
    Rule,
    fingerprint,
    lint_paths,
    load_baseline,
    render_json,
    render_text,
    rules_by_id,
    run_lint,
    split_by_baseline,
    write_baseline,
)
from .cachekey import key_irrelevant_fields  # noqa: F401

__all__ = [
    "ALL_RULES", "Finding", "ModuleInfo", "ProjectIndex", "Rule",
    "fingerprint", "lint_paths", "load_baseline", "render_json",
    "render_text", "rules_by_id", "run_lint", "split_by_baseline",
    "write_baseline", "key_irrelevant_fields",
]
