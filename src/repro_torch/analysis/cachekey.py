"""Compile-cache rules (family: cachekey).

PR 4 had to remember, by hand, to thread the new ``layout`` field of
``SimConfig`` into ``ExecutableKey`` — forget that and the compile
cache serves a ring-layout executable for a roll-layout request: wrong
numbers, no crash. These rules make that bug class structural:

- ``cache-key-field``: any ``SimConfig``/``PredictorConfig`` field read
  by code in a compiled-path module must be covered by ``ExecutableKey``
  — either because the key embeds the whole config object (how the real
  key does it: ``predictor: Optional[PredictorConfig]``,
  ``sim_cfg: SimConfig``), or by a same-named scalar field, or because
  the config field's declaration carries ``# cache-key: irrelevant``.
- ``cache-tracer-hazard``: inside scan-reachable functions (the body
  that runs under ``jax.lax.scan`` / jit), ``.item()``, ``float()`` /
  ``int()`` on traced values, ``np.*`` coercions, and wall-clock reads
  force host syncs or bake tracer values into the executable.
  Arguments provably static at trace time (config fields, ``.shape``,
  constants, ALL_CAPS globals and locals derived from those) are
  exempt — ``float(cfg.n_classes - 1)`` is fine, ``float(lat_f[0])``
  is not.

Compiled-path modules are the default globs below, or any file carrying
``# repro-lint: compiled-path``. Scan roots are functions marked
``# repro-lint: scan-reachable`` plus any local function passed as the
first argument to ``lax.scan``; reachability closes over module-local
calls.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional, Set, Tuple

from .core import (Finding, ModuleInfo, ProjectIndex, Rule, dotted_chain,
                   register)

CONFIG_CLASSES = ("SimConfig", "PredictorConfig")
KEY_CLASS = "ExecutableKey"
IRRELEVANT_MARKER = "cache-key: irrelevant"
COMPILED_PATH_MARKER = "repro-lint: compiled-path"
SCAN_MARKER = "repro-lint: scan-reachable"

DEFAULT_COMPILED_GLOBS = (
    "*core/simulator.py",
    "*core/predictor.py",
    "*serving/simnet_engine.py",
    "*kernels/*.py",
)

# Conventional receiver names -> config class, for unannotated params
# and self-attributes (self.sim_cfg, pcfg, ...).
RECEIVER_NAMES = {
    "cfg": "SimConfig",
    "sim_cfg": "SimConfig",
    "sim_config": "SimConfig",
    "scfg": "SimConfig",
    "pcfg": "PredictorConfig",
    "predictor_cfg": "PredictorConfig",
    "predictor_config": "PredictorConfig",
    "predictor": "PredictorConfig",
}

WALL_CLOCK = {
    ("time", "time"), ("time", "monotonic"), ("time", "perf_counter"),
    ("time", "perf_counter_ns"), ("time", "time_ns"),
    ("time", "process_time"), ("datetime", "now"), ("datetime", "utcnow"),
}


def _ann_names(node: Optional[ast.AST]) -> Set[str]:
    """Every plain Name inside an annotation (handles Optional[X],
    ``X | None``, quoted forward refs)."""
    if node is None:
        return set()
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return set()
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _config_facts(index: ProjectIndex) -> Dict[str, Dict]:
    """{config class name: {"fields": {name: line}, "irrelevant": set,
    "module": relpath}} for SimConfig / PredictorConfig definitions in
    this run's module set."""
    out: Dict[str, Dict] = {}
    for mod in index.modules:
        if mod.tree is None:
            continue
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.ClassDef)
                    and node.name in CONFIG_CLASSES):
                fields: Dict[str, int] = {}
                irrelevant: Set[str] = set()
                for stmt in node.body:
                    if (isinstance(stmt, ast.AnnAssign)
                            and isinstance(stmt.target, ast.Name)):
                        fields[stmt.target.id] = stmt.lineno
                        if IRRELEVANT_MARKER in mod.comment(stmt.lineno):
                            irrelevant.add(stmt.target.id)
                out[node.name] = {"fields": fields, "irrelevant": irrelevant,
                                  "module": mod.relpath}
    return out


def _key_facts(index: ProjectIndex) -> Optional[Dict]:
    """Facts about ExecutableKey: which config classes it embeds whole
    and which scalar field names it carries."""
    for mod in index.modules:
        if mod.tree is None:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name == KEY_CLASS:
                covers: Set[str] = set()
                scalars: Set[str] = set()
                for stmt in node.body:
                    if (isinstance(stmt, ast.AnnAssign)
                            and isinstance(stmt.target, ast.Name)):
                        names = _ann_names(stmt.annotation)
                        embedded = names & set(CONFIG_CLASSES)
                        if embedded:
                            covers |= embedded
                        else:
                            scalars.add(stmt.target.id)
                return {"covers": covers, "scalars": scalars,
                        "module": mod.relpath, "line": node.lineno}
    return None


def key_irrelevant_fields(cls) -> Set[str]:
    """Fields of a (runtime) config class whose declarations carry
    ``# cache-key: irrelevant``. The dynamic completeness test uses this
    so the static marker and the runtime test exempt the *same* fields —
    one annotation, two enforcers."""
    import inspect
    from pathlib import Path

    path = Path(inspect.getsourcefile(cls))
    mod = ModuleInfo(path, path.parent)
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and node.name == cls.__name__:
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)
                        and IRRELEVANT_MARKER in mod.comment(stmt.lineno)):
                    out.add(stmt.target.id)
    return out


def _receiver_class(node: ast.AST,
                    param_types: Dict[str, str]) -> Optional[str]:
    """Resolve ``<recv>.field`` receivers to a config class: annotated
    params first, then the conventional-name map (incl. ``self.cfg``)."""
    if isinstance(node, ast.Name):
        return param_types.get(node.id) or RECEIVER_NAMES.get(node.id)
    if isinstance(node, ast.Attribute):  # self.sim_cfg.layout etc.
        return RECEIVER_NAMES.get(node.attr)
    return None


@register
class CacheKeyFieldRule(Rule):
    rule_id = "cache-key-field"
    family = "cachekey"
    description = ("a SimConfig/PredictorConfig field read on the "
                   "compiled path is not covered by ExecutableKey")

    def check(self, module: ModuleInfo,
              index: ProjectIndex) -> Iterable[Finding]:
        if not (module.matches(DEFAULT_COMPILED_GLOBS)
                or module.has_file_marker(COMPILED_PATH_MARKER)):
            return
        configs = index.fact("configs", _config_facts)
        key = index.fact("key", _key_facts)
        if not configs or key is None:
            return  # nothing to check against in this run

        # param name -> config class, from annotations anywhere in file
        param_types: Dict[str, str] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                for a in (args.posonlyargs + args.args + args.kwonlyargs):
                    cls = _ann_names(a.annotation) & set(configs)
                    if cls:
                        param_types[a.arg] = next(iter(cls))

        seen: Set[Tuple[str, str]] = set()
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Attribute):
                continue
            cls = _receiver_class(node.value, param_types)
            if cls is None or cls not in configs:
                continue
            info = configs[cls]
            field = node.attr
            if field not in info["fields"] or field in info["irrelevant"]:
                continue
            if cls in key["covers"] or field in key["scalars"]:
                continue
            if (cls, field) in seen:
                continue
            seen.add((cls, field))
            yield Finding(
                rule=self.rule_id, path=module.relpath, line=node.lineno,
                message=(f"compiled path reads {cls}.{field}, but "
                         f"{KEY_CLASS} ({key['module']}) carries neither "
                         f"the whole {cls} nor a '{field}' field — a "
                         "cached executable can be reused across "
                         f"different '{field}' values; add it to the key "
                         f"or mark the field '# {IRRELEVANT_MARKER}'"),
            )


# --------------------------------------------------------- tracer hazards

_STATIC_CALLS = {"len", "max", "min", "sum", "abs", "sorted", "tuple",
                 "list", "range", "round"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size"}


class _StaticEnv:
    """Names provably trace-time-static inside one function: params /
    receivers of config type, ALL_CAPS globals, and locals assigned
    purely from static expressions."""

    def __init__(self, fn: ast.AST, param_types: Dict[str, str]):
        self.param_types = dict(param_types)
        self.static_names: Set[str] = set()
        args = getattr(fn, "args", None)
        if args is not None:
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                cls = _ann_names(a.annotation) & set(CONFIG_CLASSES)
                if cls or a.arg in RECEIVER_NAMES:
                    self.static_names.add(a.arg)
        # one forward pass over simple assignments
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                if self.is_static(node.value):
                    self.static_names.add(node.targets[0].id)

    def is_static(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.Name):
            return (node.id in self.static_names
                    or node.id in RECEIVER_NAMES
                    or (node.id.isupper() and len(node.id) > 1))
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return True
            cls = _receiver_class(node.value, self.param_types)
            if cls is not None:
                return True
            return self.is_static(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_static(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_static(node.left) and self.is_static(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_static(node.operand)
        if isinstance(node, (ast.Tuple, ast.List)):
            return all(self.is_static(e) for e in node.elts)
        if isinstance(node, ast.Compare):
            return (self.is_static(node.left)
                    and all(self.is_static(c) for c in node.comparators))
        if isinstance(node, ast.Call):
            args_static = (all(self.is_static(a) for a in node.args)
                           and all(self.is_static(k.value)
                                   for k in node.keywords))
            if (isinstance(node.func, ast.Name)
                    and node.func.id in _STATIC_CALLS):
                return args_static
            if isinstance(node.func, ast.Attribute):  # kind.startswith(...)
                return self.is_static(node.func.value) and args_static
        return False


def _local_functions(tree: ast.AST) -> Dict[str, ast.AST]:
    """name -> def, for every (nested) function in the module. Later
    defs win; scan roots resolve by name, which matches how the code
    passes ``step`` to ``lax.scan``."""
    out: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
    return out


def _scan_roots(module: ModuleInfo, fns: Dict[str, ast.AST]) -> Set[str]:
    roots: Set[str] = set()
    for name, fn in fns.items():
        for line in (fn.lineno, fn.lineno - 1):
            if SCAN_MARKER in module.comment(line):
                roots.add(name)
        for deco in getattr(fn, "decorator_list", ()):
            if SCAN_MARKER in module.comment(deco.lineno - 1):
                roots.add(name)
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call) and node.args:
            chain = dotted_chain(node.func)
            if chain[-2:] == ("lax", "scan") or chain == ("scan",):
                first = node.args[0]
                if isinstance(first, ast.Name) and first.id in fns:
                    roots.add(first.id)
    return roots


def _reachable(roots: Set[str], fns: Dict[str, ast.AST]) -> Set[str]:
    seen: Set[str] = set()
    todo = list(roots)
    while todo:
        name = todo.pop()
        if name in seen or name not in fns:
            continue
        seen.add(name)
        for node in ast.walk(fns[name]):
            if isinstance(node, ast.Call):
                chain = dotted_chain(node.func)
                if len(chain) == 1 and chain[0] in fns:
                    todo.append(chain[0])
    return seen


@register
class TracerHazardRule(Rule):
    rule_id = "cache-tracer-hazard"
    family = "cachekey"
    description = (".item()/float()/np.*/wall-clock inside scan-reachable "
                   "code — forces a host sync or bakes a tracer into the "
                   "compiled executable")

    def check(self, module: ModuleInfo,
              index: ProjectIndex) -> Iterable[Finding]:
        if not (module.matches(DEFAULT_COMPILED_GLOBS)
                or module.has_file_marker(COMPILED_PATH_MARKER)):
            return
        fns = _local_functions(module.tree)
        roots = _scan_roots(module, fns)
        if not roots:
            return
        reach = _reachable(roots, fns)
        # module-level param typing for receiver resolution
        param_types: Dict[str, str] = {}
        for fn in fns.values():
            args = fn.args
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                cls = _ann_names(a.annotation) & set(CONFIG_CLASSES)
                if cls:
                    param_types[a.arg] = next(iter(cls))

        reported: Set[int] = set()
        for name in sorted(reach):
            fn = fns[name]
            env = _StaticEnv(fn, param_types)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if node.lineno in reported:
                    continue
                msg = self._hazard(node, env)
                if msg:
                    reported.add(node.lineno)
                    yield Finding(
                        rule=self.rule_id, path=module.relpath,
                        line=node.lineno, message=msg, symbol=name,
                    )

    @staticmethod
    def _hazard(node: ast.Call, env: _StaticEnv) -> Optional[str]:
        chain = dotted_chain(node.func)
        if chain and chain[-2:] in WALL_CLOCK:
            return ("wall-clock call in scan-reachable code — the value "
                    "is frozen at trace time (and differs per compile)")
        if chain and chain[0] in ("np", "numpy") and len(chain) > 1:
            if all(env.is_static(a) for a in node.args):
                return None
            return (f"'{'.'.join(chain)}' on a traced value in "
                    "scan-reachable code — use jnp, or hoist to trace "
                    "time")
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "item" and not node.args):
            return (".item() in scan-reachable code — forces a "
                    "device-to-host sync inside the compiled step")
        if (isinstance(node.func, ast.Name)
                and node.func.id in ("float", "int")):
            if all(env.is_static(a) for a in node.args):
                return None
            return (f"{node.func.id}() on a traced value in "
                    "scan-reachable code — concretizes a tracer; keep it "
                    "as an array or derive it from config/shape")
        return None
